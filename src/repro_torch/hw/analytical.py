"""Analytical TPU latency oracle — the VTA++-simulator analog, in torch.

The tuner measures candidates against a deterministic roofline model of a
blocked GEMM on a TPU v5e core (``tpu_spec.DEFAULT``), as the reference
does, so tuning results match it.  This models the tuner's target; it
says nothing about the H100 the port runs on.

Every function takes python ints or tensors (broadcastable, any device)
and computes in float32, as the reference does in jnp; a batch dimension
on the knob tensors takes the place of ``vmap``.

Model (classic blocked-GEMM cost with TPU specifics):

  padded compute   ceil-padded tile dims -> MXU passes (128-aligned)
  HBM traffic      A: M*K * n_blocks_N  (A reloaded per N block)
                   B: K*N * n_blocks_M  (B reloaded per M block)
                   C: M*N write (+ k-split accumulation read-modify-write)
  overlap          "threading" overlaps DMA with compute:
                   latency = max(comp, mem) when threaded, comp + mem when
                   single-threaded; serial grid overhead is divided by the
                   thread count.
  VMEM             working set = threads * (A_tile + B_tile) + C_tile(fp32);
                   configurations that overflow VMEM are INFEASIBLE.
"""
from __future__ import annotations

import torch

from repro_torch.hw.tpu_spec import DEFAULT, TpuSpec

BF16 = 2.0
F32 = 4.0
_INF = 1e12  # "measurement failed" latency sentinel (seconds)


def _f32(x, like=None) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(torch.float32)
    device = like.device if isinstance(like, torch.Tensor) else None
    return torch.tensor(x, dtype=torch.float32, device=device)


def gemm_latency(m, n, k, tile_m, tile_n, tile_k, threads_m, threads_n,
                 spec: TpuSpec = DEFAULT, extra_in_bytes=0.0):
    """(latency_s, vmem_bytes) of an (m,k)x(k,n) bf16 GEMM blocked as
    (tile_m, tile_n, tile_k); ``extra_in_bytes`` charges extra input
    traffic (e.g. im2col overlap)."""
    like = next((t for t in (tile_m, tile_n, tile_k, threads_m, threads_n,
                             m, n, k) if isinstance(t, torch.Tensor)), None)
    m, n, k = _f32(m, like), _f32(n, like), _f32(k, like)
    tm = torch.minimum(_f32(tile_m, like), m)
    tn = torch.minimum(_f32(tile_n, like), n)
    tk = torch.minimum(_f32(tile_k, like), k)
    thm, thn = _f32(threads_m, like), _f32(threads_n, like)

    gm = torch.ceil(m / tm)
    gn = torch.ceil(n / tn)
    gk = torch.ceil(k / tk)

    # --- compute: MXU passes run on 128-padded tile dims (8-sublane minor-2) ---
    tm_pad = torch.ceil(tm / 8.0) * 8.0
    tn_pad = torch.ceil(tn / 128.0) * 128.0
    tk_pad = torch.ceil(tk / 128.0) * 128.0
    flops_padded = 2.0 * (gm * tm_pad) * (gn * tn_pad) * (gk * tk_pad)
    t_comp = flops_padded / spec.peak_bf16_flops

    # --- HBM traffic of the blocked loop nest ---
    bytes_a = m * k * BF16 * gn          # A streamed once per N block column
    bytes_b = k * n * BF16 * gm          # B streamed once per M block row
    bytes_c = m * n * BF16               # final write
    traffic = bytes_a + bytes_b + bytes_c + _f32(extra_in_bytes, like)
    t_mem = traffic / spec.hbm_bw

    # --- serial overheads: grid sequencing + DMA issue, amortized by threading ---
    grid_steps = gm * gn * gk
    threads = torch.clamp(thm * thn, min=1.0)
    t_overhead = (grid_steps * spec.grid_step_overhead_s
                  + grid_steps * 3.0 * spec.dma_latency_s) / threads

    # --- overlap: threaded => double-buffered DMA hides behind compute ---
    overlapped = torch.maximum(t_comp, t_mem)
    serial = t_comp + t_mem
    t_core = torch.where(threads >= 2.0, overlapped, serial)

    latency = t_core + t_overhead

    # --- VMEM feasibility: threads x (A+B tiles, bf16) + accumulator (fp32) ---
    vmem = (threads * (tm_pad * tk_pad + tk_pad * tn_pad) * BF16
            + tm_pad * tn_pad * F32)
    feasible = vmem <= spec.vmem_bytes
    return torch.where(feasible, latency, _f32(_INF, latency)), vmem


def conv2d_im2col_dims(b, h, w, ci, co, kh, kw, stride, pad):
    """Output dims + GEMM dims for a conv lowered via im2col (python ints)."""
    oh = (h + 2 * pad - kh) // stride + 1
    ow = (w + 2 * pad - kw) // stride + 1
    m = b * oh * ow
    k = ci * kh * kw
    n = co
    return oh, ow, m, n, k


def _dims(workload):
    return conv2d_im2col_dims(
        workload["b"], workload["h"], workload["w"], workload["ci"],
        workload["co"], workload["kh"], workload["kw"], workload["stride"],
        workload["pad"])


def conv2d_latency(workload, tile_b, tile_h, tile_w, tile_ci, tile_co,
                   h_threading, oc_threading, spec: TpuSpec = DEFAULT):
    """Latency of a conv2d executed as a blocked im2col GEMM.

    The mapping-agent knobs (tile_h, tile_w) + hardware tile_b compose the
    GEMM M-tile; tile_ci (x kh*kw) is the K-tile; tile_co the N-tile.
    """
    kh, kw, stride = workload["kh"], workload["kw"], workload["stride"]
    _, _, m, n, k = _dims(workload)
    like = next((t for t in (tile_b, tile_h, tile_w, tile_ci, tile_co)
                 if isinstance(t, torch.Tensor)), None)
    tile_m = _f32(tile_b, like) * _f32(tile_h, like) * _f32(tile_w, like)
    tile_k = _f32(tile_ci, like) * float(kh * kw)
    tile_n = _f32(tile_co, like)

    # im2col re-reads overlapping input windows: charge the expansion ratio
    # (kh*kw / stride^2 capped at kh*kw) on the input tensor once.
    expand = min(float(kh * kw) / float(stride * stride), float(kh * kw))
    extra = (float(workload["b"] * workload["h"] * workload["w"]
                   * workload["ci"]) * BF16 * max(expand - 1.0, 0.0))
    return gemm_latency(m, n, k, tile_m, tile_n, tile_k,
                        h_threading, oc_threading, spec=spec,
                        extra_in_bytes=extra)


def conv2d_gflops(workload, latency_s):
    """Achieved GFLOP/s of a conv at a given latency (Fig. 7 metric)."""
    _, _, m, n, k = _dims(workload)
    return 2.0 * m * n * k / latency_s / 1e9


def activation_out_bytes(kind: str, workload) -> float:
    """Output-activation footprint (bytes, bf16) of one task — the tensor
    that crosses chips when a pipeline partition cuts right after it.
    Conv outputs are ``b*oh*ow*co``, matmuls ``m*n``; other kinds (pod
    shard cells) transfer nothing."""
    if kind == "conv2d":
        oh, ow, _, _, _ = _dims(workload)
        return float(workload["b"] * oh * ow * workload["co"]) * BF16
    if kind == "matmul":
        return float(workload["m"] * workload["n"]) * BF16
    return 0.0


def interchip_transfer_s(n_bytes: float, spec: TpuSpec = DEFAULT) -> float:
    """Time to move one boundary activation between pipeline stages over
    the full ICI bisection (all links striped), plus one DMA issue."""
    return float(n_bytes) / (spec.ici_links * spec.ici_bw_per_link) \
        + spec.dma_latency_s


# Area proxy constants (7nm-class, Accelergy-style orders of magnitude).
# Absolute calibration does not matter: the multi-objective Pareto only
# compares candidate chips built from the same constants.
MAC_AREA_MM2 = 6e-4           # one bf16 MAC + pipeline registers
SRAM_AREA_MM2_PER_MB = 0.45   # tile buffers


def chip_area_mm2(tile_b, tile_ci, tile_co) -> float:
    """Silicon-area proxy of one accelerator config: the GEMM-core MAC
    array (``tile_b * tile_ci * tile_co``) plus double-buffered bf16 tile
    SRAM (a K-chip partition pays the sum of its chips)."""
    b, ci, co = float(tile_b), float(tile_ci), float(tile_co)
    macs = b * ci * co
    tiles_mb = (b * ci + ci * co + b * co) * 2.0 * BF16 / 2.0 ** 20
    return macs * MAC_AREA_MM2 + tiles_mb * SRAM_AREA_MM2_PER_MB


def conv2d_min_latency(workload, spec: TpuSpec = DEFAULT) -> float:
    """Roofline lower bound for a conv (perfect tiling): max(comp, mem)."""
    _, _, m, n, k = _dims(workload)
    flops = 2.0 * m * n * k
    bytes_min = (m * k + k * n + m * n) * BF16
    return max(flops / spec.peak_bf16_flops, bytes_min / spec.hbm_bw)
