"""``gemm_roofline.<suffix>``: the share of its roofline the port's
GEMM reaches over a forward.  The least time of each conv's GEMM on an
H100 (the larger of 2MNK over the peak of the configured dtype and its
bytes, A, B and C once each, over HBM's bandwidth; ``roofline.py``),
summed over the traced forwards, over the device time of the GEMM's
kernels (``gemm_bf16_kernel``/``gemm_f32_kernel`` and split-K's
``splitk_sum_kernel``).  Nothing where those kernels did not run."""
from dcoc_bench import roofline

KERNELS = ("gemm_bf16_kernel", "gemm_f32_kernel", "splitk_sum_kernel")


def read(run):
    t, n = run.devtrace, run.obs.get("traced_requests")
    if t is None or not n:
        return None
    busy = t.device_seconds(lambda name: any(k in name for k in KERNELS))
    if busy <= 0:
        return None
    bound = roofline.forward_gemm_bound_s(run.config, run.mix["batch"])
    return 100.0 * n * bound / busy
