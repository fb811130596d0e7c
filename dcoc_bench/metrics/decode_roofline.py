"""``decode_roofline.<suffix>``: the share of its roofline a decode step
reaches.  Each traced step's least time on an H100 (``roofline_lm.py``:
its bytes, the routed experts counted by ``moe.experts_touched``, the
latent cache at each slot's context), summed over the traced steps, over
the device's busy time in them.  Nothing without the counter."""
from dcoc_bench import roofline_lm


def read(run):
    t = run.devtrace
    contexts = run.obs.get("traced_contexts")
    touched = run.obs.get("experts_touched")
    if t is None or not contexts or touched is None or t.busy_s <= 0:
        return None
    per_layer = float(touched) / (len(contexts)
                                  * roofline_lm.moe_layers(run.config))
    bound = sum(roofline_lm.decode_step_bound_s(run.config, c, per_layer)
                for c in contexts)
    return 100.0 * bound / t.busy_s
