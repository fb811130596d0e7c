"""``elementwise_ms.<suffix>``: device milliseconds a forward of every
kernel but the port's GEMM (``gemm_bf16_kernel``, ``gemm_f32_kernel``,
``splitk_sum_kernel``): im2col's pad and copy, bias, ReLU, pooling, the
head.  Copies between host and card are not kernels and are left out."""

GEMM_KERNELS = ("gemm_bf16_kernel", "gemm_f32_kernel", "splitk_sum_kernel")
NOT_KERNELS = ("Memcpy", "Memset")


def keep(name: str) -> bool:
    return not name.startswith(NOT_KERNELS) and \
        not any(g in name for g in GEMM_KERNELS)


def read(run):
    t, n = run.devtrace, run.obs.get("traced_requests")
    if t is None or not n:
        return None
    return 1e3 * t.device_seconds(keep) / n
