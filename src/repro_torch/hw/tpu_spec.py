"""TPU hardware constants used by every roofline / cost computation.

Target: TPU v5e, the hardware the tuner's analytical oracle *models*
(the port itself runs on an NVIDIA GPU; nothing here describes it).
All values are public datasheet numbers; VMEM is the per-core vector memory
budget a Pallas kernel's working set must fit in.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class TpuSpec:
    name: str
    # Compute
    peak_bf16_flops: float  # FLOP/s per chip
    peak_int8_ops: float
    mxu_dim: int            # systolic array is mxu_dim x mxu_dim
    num_mxu: int            # MXUs per core
    vpu_lanes: int          # (8, 128) vregs -> 8*128 lanes
    # Memory hierarchy
    hbm_bytes: int
    hbm_bw: float           # bytes/s
    vmem_bytes: int
    # Interconnect
    ici_links: int          # links per chip
    ici_bw_per_link: float  # bytes/s per link, per direction
    dcn_bw: float           # bytes/s per host, pod-to-pod
    # Misc timing model knobs (derived from public microbenchmarks, coarse)
    dma_latency_s: float    # fixed cost to issue an HBM->VMEM DMA
    grid_step_overhead_s: float  # per-grid-step sequencer overhead


V5E = TpuSpec(
    name="tpu_v5e",
    peak_bf16_flops=197e12,
    peak_int8_ops=394e12,
    mxu_dim=128,
    num_mxu=1,
    vpu_lanes=8 * 128,
    hbm_bytes=16 * 1024**3,
    hbm_bw=819e9,
    vmem_bytes=128 * 1024**2,
    ici_links=4,
    ici_bw_per_link=50e9,
    dcn_bw=25e9,
    dma_latency_s=1e-6,
    grid_step_overhead_s=2e-7,
)

# The spec used everywhere unless a config overrides it.
DEFAULT = V5E


def matmul_flops(m: int, n: int, k: int) -> float:
    return 2.0 * m * n * k


def mxu_efficiency(dim: int, mxu: int = 128) -> float:
    """Fraction of the systolic array utilized for a tile dimension ``dim``.

    A dim that is not a multiple of the MXU edge wastes the remainder lanes on
    the final pass: eff = dim / (ceil(dim/mxu) * mxu).
    """
    if dim <= 0:
        return 0.0
    import math

    return dim / (math.ceil(dim / mxu) * mxu)
