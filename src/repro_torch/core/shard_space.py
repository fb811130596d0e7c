"""Beyond-paper: ARCO over the *pod-level* execution configuration.

The paper co-optimizes a single accelerator core's geometry.  Here the same
three agents tune the pod-level execution configuration of an LM cell:

    hardware agent   : model-axis size (TP degree), FSDP on/off,
                       optimizer-moment dtype
    scheduling agent : gradient-accumulation microbatches, remat on/off
    mapping agent    : attention KV-chunk, sequence parallelism

Fitness = 1 / step time from a python ``measure_fn(settings)`` per config
(the reference's compile oracle, or the zoo's analytical proxy).  The knob
tables and cell descriptor are the reference's.  ``measure`` takes the
port's config tensors (any device) and calls ``measure_fn`` once per row on
the host, as the reference does.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.design_space import AGENT_KNOBS, DesignSpace, KNOB_NAMES

# knob value tables (reusing the 7-slot agent partition of Table 2)
MODEL_AXIS = (4, 8, 16, 32, 64, 128, 256)   # "tile_b" — TP degree
MOMENT_DTYPE = (1, 2)                # "tile_ci"  — 1=bf16 moments, 2=f32
FSDP = (1, 2)                        # "tile_co"  — 1=off, 2=on
GRAD_ACCUM = (1, 2, 4, 8)            # "h_threading"
REMAT = (1, 2)                       # "oc_threading" — 1=off, 2=nested
ATTN_CHUNK = (256, 512, 1024, 2048, 4096)   # "tile_h"
SEQ_PAR = (1, 2)                     # "tile_w"   — Megatron-SP on/off


def knob_values_to_settings(vals) -> Dict[str, object]:
    return {
        "model_axis": int(vals[0]),
        "moment_dtype": "float32" if int(vals[1]) == 2 else "bfloat16",
        "fsdp": int(vals[2]) == 2,
        "grad_accum": int(vals[3]),
        "remat": int(vals[4]) == 2,
        "attn_chunk": int(vals[5]),
        "sequence_parallel": int(vals[6]) == 2,
    }


@dataclasses.dataclass(frozen=True)
class ShardSpace(DesignSpace):
    """Pod-level configuration space; its oracle is a python callable over
    decoded settings, plugged into the unchanged ARCO tuner."""

    measure_fn: Optional[Callable[[Dict[str, object]], float]] = None
    cell_features: Tuple[float, ...] = ()

    @staticmethod
    def for_cell(arch: str, shape: str,
                 measure_fn: Callable[[Dict[str, object]], float],
                 n_devices: int = 256) -> "ShardSpace":
        from repro_torch.configs import get_config
        from repro_torch.configs.shapes import SHAPES
        cfg = get_config(arch)
        cell = SHAPES[shape]
        grad_accum = GRAD_ACCUM if cell.kind == "train" else (1,)
        choices = (
            tuple(m for m in MODEL_AXIS if m <= n_devices),
            MOMENT_DTYPE, FSDP, grad_accum, REMAT, ATTN_CHUNK, SEQ_PAR,
        )
        feats = (cfg.n_layers, cfg.d_model, cfg.n_heads,
                 max(cfg.d_ff, 1), cfg.vocab, max(cfg.n_experts, 1),
                 cell.seq, cell.global_batch, n_devices,
                 1.0 + (cell.kind == "train"), 1.0)
        return ShardSpace(
            knob_names=KNOB_NAMES, choices=choices,
            agent_knobs=dict(AGENT_KNOBS),
            workload={"m": cell.seq * cell.global_batch,
                      "n": cfg.d_model, "k": cfg.d_model},
            kind="matmul",  # only used for unreached base-class paths
            measure_fn=measure_fn, cell_features=tuple(feats))

    # -------- overrides: python oracle + cell-descriptor features ---------
    def measure(self, configs: torch.Tensor) -> torch.Tensor:
        """(n, n_knobs) choice indices -> step times (n,) float64 on the
        configs' device, one ``measure_fn`` call a row."""
        configs = torch.as_tensor(configs)
        out = np.empty(configs.numel() // self.n_knobs, np.float64)
        for i, c in enumerate(configs.cpu().reshape(-1, self.n_knobs)):
            vals = [self.choices[k][int(c[k])] for k in range(self.n_knobs)]
            out[i] = self.measure_fn(knob_values_to_settings(vals))
        return torch.as_tensor(out, device=configs.device)

    def workload_features(self) -> np.ndarray:
        return (np.log2(np.maximum(
            np.asarray(self.cell_features, np.float32), 1.0)) / 16.0)
