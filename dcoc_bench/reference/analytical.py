"""A frozen copy of the tuner's analytical TPU v5e model: the tune cells'
reference.

The tuner measures each candidate configuration of a conv layer against a
roofline model of a blocked GEMM on a TPU v5e core (the paper's measured
accelerator is modelled, not run).  This file restates that model and the
knob tables from the model's own definition, as plain PyTorch on the CPU
in a dtype of the caller's choice: float64 for the reference, bfloat16
for the control (one precision below the float32 the model states).  It
imports nothing of the program, and reads only a layer's workload and the
configurations' choice indices.

Knobs, in order: tile_b, tile_ci, tile_co (hardware), h_threading,
oc_threading (scheduling), tile_h, tile_w (mapping); each a power of two
up to its dimension, at most 12 choices (the largest kept), the
threadings 1, 2 or 4.
"""
from __future__ import annotations

from typing import Dict, List, Sequence

import torch

# TPU v5e, as the model states it
PEAK_BF16_FLOPS = 197e12
HBM_BYTES_PER_S = 819e9
VMEM_BYTES = 128 * 1024 ** 2
DMA_LATENCY_S = 1e-6
GRID_STEP_S = 2e-7
BF16_BYTES = 2.0
F32_BYTES = 4.0
INFEASIBLE_S = 1e12
MAX_CHOICES = 12


def _pow2(limit: int) -> List[int]:
    limit = max(int(limit), 1)
    return [2 ** e for e in range(limit.bit_length())][-MAX_CHOICES:]


def out_hw(wl: Dict[str, int]) -> tuple:
    oh = (wl["h"] + 2 * wl["pad"] - wl["kh"]) // wl["stride"] + 1
    ow = (wl["w"] + 2 * wl["pad"] - wl["kw"]) // wl["stride"] + 1
    return oh, ow


def choices(wl: Dict[str, int]) -> List[List[int]]:
    """Each knob's values for the conv workload ``wl``."""
    oh, ow = out_hw(wl)
    return [_pow2(wl["b"]), _pow2(wl["ci"]), _pow2(wl["co"]), [1, 2, 4],
            [1, 2, 4], _pow2(oh), _pow2(ow)]


def decode(wl: Dict[str, int], configs: Sequence[Sequence[int]]
           ) -> torch.Tensor:
    """Choice indices (n, 7) -> knob values (n, 7), int64."""
    tab = choices(wl)
    return torch.tensor([[tab[k][int(i)] for k, i in enumerate(c)]
                         for c in configs], dtype=torch.int64)


def latency(wl: Dict[str, int], values: torch.Tensor,
            dtype: torch.dtype = torch.float64) -> torch.Tensor:
    """Modelled seconds of the conv ``wl`` at knob ``values`` (n, 7),
    every quantity held in ``dtype``; INFEASIBLE_S where the tiles
    overflow VMEM."""
    c = lambda x: torch.as_tensor(x, dtype=dtype)
    v = values.to(dtype)
    oh, ow = out_hw(wl)
    kk = wl["kh"] * wl["kw"]
    m, n, k = c(wl["b"] * oh * ow), c(wl["co"]), c(wl["ci"] * kk)
    tm = torch.minimum(v[:, 0] * v[:, 5] * v[:, 6], m)
    tk = torch.minimum(v[:, 1] * c(kk), k)
    tn = torch.minimum(v[:, 2], n)
    gm, gn, gk = torch.ceil(m / tm), torch.ceil(n / tn), torch.ceil(k / tk)
    tm_pad = torch.ceil(tm / c(8.0)) * c(8.0)
    tn_pad = torch.ceil(tn / c(128.0)) * c(128.0)
    tk_pad = torch.ceil(tk / c(128.0)) * c(128.0)
    t_comp = (c(2.0) * (gm * tm_pad) * (gn * tn_pad) * (gk * tk_pad)
              / c(PEAK_BF16_FLOPS))
    # im2col re-reads overlapping windows: the expansion, charged once
    expand = min(kk / float(wl["stride"] ** 2), float(kk))
    extra = c(float(wl["b"] * wl["h"] * wl["w"] * wl["ci"]) * BF16_BYTES
              * max(expand - 1.0, 0.0))
    traffic = (m * k * c(BF16_BYTES) * gn + k * n * c(BF16_BYTES) * gm
               + m * n * c(BF16_BYTES) + extra)
    t_mem = traffic / c(HBM_BYTES_PER_S)
    steps = gm * gn * gk
    threads = torch.clamp(v[:, 3] * v[:, 4], min=1.0)
    t_over = (steps * c(GRID_STEP_S) + steps * c(3.0) * c(DMA_LATENCY_S)) \
        / threads
    t_core = torch.where(threads >= 2.0, torch.maximum(t_comp, t_mem),
                         t_comp + t_mem)
    vmem = (threads * (tm_pad * tk_pad + tk_pad * tn_pad) * c(BF16_BYTES)
            + tm_pad * tn_pad * c(F32_BYTES))
    return torch.where(vmem <= c(VMEM_BYTES), t_core + t_over,
                       c(INFEASIBLE_S))
