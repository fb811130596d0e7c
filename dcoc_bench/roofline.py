"""The H100's peaks, and the operations and bytes a GEMM or a forward needs.

Peaks are NVIDIA's published dense rates for one H100 SXM (80 GB HBM3) at
its 700 W limit; a card run below that limit reaches less (the run records
the card's limit beside its numbers).  Work is counted from shapes, never
from what a kernel does: each input byte read once, each output byte
written once, 2 operations a multiply-add, so a change of kernel cannot
change the work counted.
"""
from __future__ import annotations

from dcoc_bench.reference.networks import conv_layers, network_flops

PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}   # float32: no TF32
HBM_BYTES_PER_S = 3.35e12
ITEMSIZE = {"bfloat16": 2, "float32": 4}


def gemm_flops(m: int, n: int, k: int) -> float:
    return 2.0 * m * n * k


def gemm_bytes(m: int, n: int, k: int, dtype: str) -> float:
    """A (m, k) and B (k, n) read once, C (m, n) written once."""
    return float(m * k + k * n + m * n) * ITEMSIZE[dtype]


def gemm_bound_s(m: int, n: int, k: int, dtype: str) -> float:
    """The least time an H100 could take: the larger of the operations
    over the peak and the bytes over HBM's bandwidth."""
    return max(gemm_flops(m, n, k) / PEAK_FLOPS[dtype],
               gemm_bytes(m, n, k, dtype) / HBM_BYTES_PER_S)


def forward_gemm_bound_s(cfg: dict, batch: int) -> float:
    """Sum of the bounds of one forward's conv GEMMs (im2col's (M, N, K)),
    in the configured dtype."""
    return sum(gemm_bound_s(*layer.gemm_dims(batch), cfg["dtype"])
               for layer in conv_layers(cfg))


def forward_flops(cfg: dict, batch: int) -> float:
    """Operations of one forward: the convs and the head."""
    return network_flops(cfg, batch)
