"""Roofline terms per (arch x shape x mesh) cell, for the TPU v5e target.

The port of the reference's ``repro.hw.roofline``: arithmetic over an
``ArchConfig``, the same formulas and the same ``TpuSpec``.  It models the
pod the shard-space tuner targets, not the H100 the port runs on; nothing
here is a speed of the port.  Three terms (seconds a step):

  compute    = dot_FLOPs_per_device / peak_FLOP/s
               (``weighted.dot_flops_per_device`` of a dry-run artifact:
                ``repro_torch.hw.step_analysis``)
  memory     = HBM_bytes_per_device / HBM_bw
               (analytic traffic model: weight streaming per pass,
                activation saves, KV-cache reads)
  collective = wire_bytes_per_device / ICI_link_bw
               (collective bytes with ring multipliers)

Plus MODEL_FLOPS = 6*N_active*D (train) / 2*N_active*tokens (inference) and
the usefulness ratio MODEL_FLOPS / counted FLOPs.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Dict, Optional

import numpy as np

from repro_torch.hw.tpu_spec import DEFAULT, TpuSpec
from repro_torch.models.transformer import (ArchConfig, abstract_params,
                                            param_count)

_MOE_LEAVES = ("w_gate", "w_up", "w_down")


def _repeats(cfg: ArchConfig) -> int:
    return cfg.n_layers // len(cfg.pattern)


@functools.lru_cache(maxsize=64)
def _counts(cfg: ArchConfig):
    ab = abstract_params(cfg)
    total = float(param_count(ab))
    moe = 0.0
    for p, (_, ffn) in zip(ab["layers"], cfg.layer_kinds()):
        if ffn == "moe":
            moe += float(sum(p["ffn"][name].numel() for name in _MOE_LEAVES))
    return total, moe


def _param_counts(cfg: ArchConfig) -> Dict[str, float]:
    """(total, active) parameter counts; active scales MoE experts to top_k."""
    total, moe = _counts(cfg)
    active = total
    if cfg.n_experts and cfg.moe_top_k:
        active = total - moe * (1.0 - cfg.moe_top_k / cfg.n_experts)
    return {"total": total, "active": active}


def _attn_layers(cfg: ArchConfig) -> int:
    per_period = sum(1 for m, _ in cfg.pattern if m in ("attn", "swa"))
    return per_period * _repeats(cfg)


def model_flops(cfg: ArchConfig, kind: str, seq: int, batch: int,
                counts: Optional[Dict[str, float]] = None) -> float:
    """Useful model FLOPs for the whole step (all devices)."""
    c = counts or _param_counts(cfg)
    na = c["active"]
    la = _attn_layers(cfg)
    hd = cfg.head_dim * cfg.n_heads
    if kind == "train":
        tokens = batch * seq
        attn = 2.0 * 2.0 * batch * seq * seq * hd * la / 2.0  # causal half
        if cfg.swa_window:
            attn = 2.0 * 2.0 * batch * seq * min(seq, cfg.swa_window) \
                * hd * la
        return 6.0 * na * tokens + 3.0 * attn
    if kind == "prefill":
        tokens = batch * seq
        attn = 2.0 * 2.0 * batch * seq * seq * hd * la / 2.0
        if cfg.swa_window:
            attn = 2.0 * 2.0 * batch * seq * min(seq, cfg.swa_window) \
                * hd * la
        return 2.0 * na * tokens + attn
    # decode: one token per sequence; attends over the whole cache
    ctx = min(seq, cfg.swa_window) if cfg.swa_window else seq
    attn = 2.0 * 2.0 * batch * ctx * hd * la
    return 2.0 * na * batch + attn


def kv_cache_bytes(cfg: ArchConfig, seq: int, batch: int) -> float:
    """Global decode-state bytes (KV caches + recurrent states)."""
    dt = 2.0  # bf16
    total = 0.0
    for mixer, _ in cfg.pattern:
        n = _repeats(cfg)
        if mixer in ("attn", "swa"):
            s = min(seq, cfg.swa_window) if (mixer == "swa"
                                             and cfg.swa_window) else seq
            total += n * 2 * batch * s * cfg.n_kv_heads * cfg.head_dim * dt
        elif mixer == "mamba":
            di = 2 * cfg.d_model
            total += n * batch * di * (cfg.d_state + 3) * 4.0
        elif mixer in ("mlstm",):
            dh = cfg.head_dim
            total += n * batch * cfg.n_heads * (dh * dh + dh + 1) * 4.0
        elif mixer == "slstm":
            total += n * batch * 4 * cfg.d_model * 4.0
    return total


def memory_traffic(cfg: ArchConfig, kind: str, seq: int, batch: int,
                   mesh: Dict[str, int],
                   counts: Optional[Dict[str, float]] = None) -> float:
    """Per-device HBM bytes per step (analytic TPU model)."""
    c = counts or _param_counts(cfg)
    model_par = mesh.get("model", 1)
    n_dev = int(np.prod(list(mesh.values())))
    dp = n_dev // model_par
    p_use = c["total"] * 2.0 / model_par     # bf16 weights streamed per pass
    b_loc = max(batch // dp, 1)
    act = b_loc * seq * cfg.d_model * 2.0    # one residual-stream tensor
    if kind == "train":
        # fwd read + bwd read + remat re-read of weights; grads write+read;
        # opt m/v read+write (bf16) + param write
        weights = 3.0 * p_use + 4.0 * (c["total"] * 2.0 / n_dev) * 2.0
        # activation saves: one per layer boundary, written + read
        acts = 2.0 * act * cfg.n_layers
        return weights + acts
    if kind == "prefill":
        return p_use + act * 2.0
    # decode: weights once + full cache read, sharded across all devices
    return p_use + kv_cache_bytes(cfg, seq, batch) / n_dev + \
        2.0 * b_loc * cfg.d_model * 2.0 * cfg.n_layers


def hbm_residency(cfg: ArchConfig, kind: str, seq: int, batch: int,
                  mesh: Dict[str, int], *, fsdp: bool = True,
                  moment_dtype: str = "bfloat16", remat: bool = True,
                  grad_accum: int = 1, sequence_parallel: bool = False,
                  counts: Optional[Dict[str, float]] = None) -> float:
    """Modelled steady-state HBM bytes per device (TPU target): params +
    grads + optimizer moments (sharding-dependent) + activation saves
    (remat-policy-dependent) + a 2 GiB transient allowance."""
    c = counts or _param_counts(cfg)
    n_dev = int(np.prod(list(mesh.values())))
    tp = mesh.get("model", 1)
    dp = max(n_dev // tp, 1)
    if kind != "train":
        weights = c["total"] * 2.0 / (tp if not fsdp else n_dev)
        cache = kv_cache_bytes(cfg, seq, batch) / n_dev \
            if kind == "decode" else 0.0
        b_loc = max(batch // dp, 1)
        act = b_loc * seq * cfg.d_model * 2.0 if kind == "prefill" else 0.0
        return weights + cache + 2.0 * act + 2 * 2.0 ** 30
    shards = n_dev if fsdp else tp
    params = c["total"] * 2.0 / shards
    grads = params
    mom = c["total"] * (8.0 if moment_dtype == "float32" else 4.0) / shards
    b_loc = max(batch // dp, 1) / max(grad_accum, 1)
    act = b_loc * seq * cfg.d_model * 2.0
    if sequence_parallel:
        act /= tp   # SP shards the saved residual stream over the TP axis
    acts = (_repeats(cfg) * act) if remat else (cfg.n_layers * 2.5 * act)
    return params + grads + mom + acts + 2 * 2.0 ** 30


@dataclasses.dataclass
class Roofline:
    compute_s: float
    memory_s: float
    collective_s: float
    dominant: str
    model_flops: float
    hlo_flops: float
    usefulness: float
    step_s: float

    def as_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)


def analyze_cell(cfg: ArchConfig, kind: str, seq: int, batch: int,
                 mesh: Dict[str, int], artifact: Dict[str, Any],
                 spec: TpuSpec = DEFAULT) -> Roofline:
    """Combine a dry-run artifact with the analytic model.  ``hlo_flops``
    keeps the reference's name: the counted dot FLOPs of all devices."""
    counts = _param_counts(cfg)
    n_dev = int(np.prod(list(mesh.values())))
    flops_dev = float(artifact["weighted"]["dot_flops_per_device"])
    compute_s = flops_dev / spec.peak_bf16_flops
    mem_bytes = memory_traffic(cfg, kind, seq, batch, mesh, counts)
    memory_s = mem_bytes / spec.hbm_bw
    wire = float(artifact["weighted"]["wire_bytes_per_device"])
    collective_s = wire / spec.ici_bw_per_link
    mf = model_flops(cfg, kind, seq, batch, counts)
    hlo_total = flops_dev * n_dev
    terms = {"compute": compute_s, "memory": memory_s,
             "collective": collective_s}
    dominant = max(terms, key=terms.get)
    return Roofline(
        compute_s=compute_s, memory_s=memory_s, collective_s=collective_s,
        dominant=dominant, model_flops=mf, hlo_flops=hlo_total,
        usefulness=mf / hlo_total if hlo_total else 0.0,
        step_s=max(terms.values()))


def roofline_fraction(r: Roofline, spec: TpuSpec = DEFAULT,
                      n_dev: int = 256) -> float:
    """Achieved fraction of the hardware roofline: useful FLOPs at the
    modelled step time vs peak."""
    if r.step_s <= 0:
        return 0.0
    return (r.model_flops / n_dev / r.step_s) / spec.peak_bf16_flops
