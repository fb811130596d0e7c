"""``kda_roofline.<suffix>``: the share of its roofline the KDA decode
kernel reaches.  The least time of one call on an H100
(``roofline_kda.py``: every slot's states read once and written once in
float32, beside q, k, v, g, beta and the output), times the calls of the
traced steps (a KDA layer a step), over the device time of the kernel
(``kda_decode_kernel``) in them.  Nothing where that kernel did not
run."""
from dcoc_bench import roofline_kda

KERNEL = "kda_decode_kernel"


def read(run):
    t, n = run.devtrace, run.obs.get("traced_steps")
    if t is None or not n:
        return None
    busy = t.device_seconds(lambda name: KERNEL in name)
    if busy <= 0:
        return None
    calls = n * roofline_kda.kda_layers(run.config)
    bound = roofline_kda.kda_kernel_bound_s(run.config, run.mix["slots"])
    return 100.0 * calls * bound / busy
