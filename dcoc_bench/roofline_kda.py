"""The operations and bytes of the KDA decode kernel's call and of one
decode step of a Kimi Linear LM (KDA and NoPE MLA layers, MoE with a
shared expert and this chip's share of the routed experts), and the
least time an H100 could take for each.

Work is counted from the configuration's ``config.json`` keys and the
step's shapes, never from what a kernel does.  The KDA decode kernel, a
call (every slot's heads of one layer): each state (head_dim x head_dim,
float32) read once and written once, q, k, v and g read and the output
written in float32, beta read; operations, per state element, the decay
(1), k^T S (2), the rank-1 update (2) and S^T q (2), bound by its bytes.
The step: every weight it needs read once in the configured dtype (the
routed experts: only those with a token, ``experts_touched`` a layer, of
the ones held here; the router, its correction bias and KDA's ``A_log``
and ``dt_bias`` in float32), each KDA layer's state and conv tails read
and written, each MLA layer's latent cache (c_kv and k_pe) at each slot's
context read once and its new position written once, the tokens'
embedding rows read and the logits written.  Operations: 2 a
multiply-add of every product (the routed experts': ``held_pairs``
token-expert pairs a layer), the absorbed attention's at each slot's
context, and the KDA kernel's.  Peaks are ``roofline.py``'s.
"""
from __future__ import annotations

from typing import Sequence

from dcoc_bench.roofline import HBM_BYTES_PER_S, ITEMSIZE, PEAK_FLOPS
from dcoc_bench.roofline_lm import _mla_weights

F32 = 4
KERNEL_OPS_PER_ELEMENT = 7


def mixers(cfg: dict) -> list:
    full = set(cfg["linear_attn_config"]["full_attn_layers"])
    return ["mla" if i + 1 in full else "kda"
            for i in range(cfg["num_hidden_layers"])]


def kda_layers(cfg: dict) -> int:
    return mixers(cfg).count("kda")


def moe_layers(cfg: dict) -> int:
    return cfg["num_hidden_layers"] - cfg["first_k_dense_replace"]


def _kda_dims(cfg: dict):
    la = cfg["linear_attn_config"]
    return la["num_heads"], la["head_dim"], la["short_conv_kernel_size"]


def kda_kernel_bytes(cfg: dict, slots: int) -> float:
    h, d, _ = _kda_dims(cfg)
    rows = slots * h
    return float(rows * (2 * d * d + 5 * d + 1)) * F32


def kda_kernel_flops(cfg: dict, slots: int) -> float:
    h, d, _ = _kda_dims(cfg)
    return float(slots * h * KERNEL_OPS_PER_ELEMENT * d * d)


def kda_kernel_bound_s(cfg: dict, slots: int) -> float:
    """The least time of one call of the KDA decode kernel on ``slots``
    slots: the larger of its operations over the float32 peak and its
    bytes over HBM's bandwidth (the bytes, by far)."""
    return max(kda_kernel_flops(cfg, slots) / PEAK_FLOPS["float32"],
               kda_kernel_bytes(cfg, slots) / HBM_BYTES_PER_S)


def _kda_weights(cfg: dict) -> int:
    """A KDA layer's weights in the model's dtype (A_log and dt_bias
    aside)."""
    h, d, taps = _kda_dims(cfg)
    dm, c, r = cfg["hidden_size"], h * d, cfg["assumed"]["kda_gate_rank"]
    return (dm + 3 * dm * c + 3 * c * taps + 2 * (dm * r + r * c)
            + dm * h + d + c * dm)


def _kda_macs(cfg: dict) -> int:
    """A KDA layer's multiply-adds of its products, a token."""
    h, d, taps = _kda_dims(cfg)
    dm, c, r = cfg["hidden_size"], h * d, cfg["assumed"]["kda_gate_rank"]
    return 3 * dm * c + 3 * c * taps + 2 * (dm * r + r * c) + dm * h + c * dm


def step_bytes(cfg: dict, contexts: Sequence[int],
               experts_touched: float) -> float:
    """Bytes of one step of ``len(contexts)`` slots, slot b attending over
    ``contexts[b]`` positions in the MLA layers; ``experts_touched``:
    held routed experts with a token, a MoE layer (mean)."""
    it = ITEMSIZE[cfg["dtype"]]
    dm, b = cfg["hidden_size"], len(contexts)
    f, e = cfg["moe_intermediate_size"], \
        cfg["deployment"]["num_experts_published"]
    h, d, taps = _kda_dims(cfg)
    kinds = mixers(cfg)
    n_kda, n_mla = kinds.count("kda"), kinds.count("mla")
    moe = moe_layers(cfg)
    dense = cfg["num_hidden_layers"] - moe
    shared = cfg["num_shared_experts"] * f
    weights = (n_kda * _kda_weights(cfg) + n_mla * _mla_weights(cfg)
               + dense * (dm + 3 * dm * cfg["intermediate_size"])
               + moe * (dm + experts_touched * 3 * dm * f + 3 * dm * shared))
    latent = cfg["kv_lora_rank"] + cfg["qk_rope_head_dim"]
    cache = n_mla * latent * (sum(contexts) + b)
    tails = n_kda * 2 * b * 3 * (taps - 1) * h * d   # read and written
    head = dm + dm * cfg["vocab_size"]
    io = b * dm + b * cfg["vocab_size"]
    fp32 = (moe * (dm * e + e) + n_kda * (h + h * d)) * F32
    state = n_kda * (kda_kernel_bytes(cfg, b))
    return float(weights + cache + tails + head + io) * it + fp32 + state


def step_flops(cfg: dict, contexts: Sequence[int],
               held_pairs: float) -> float:
    """Operations of the same step; ``held_pairs``: token-expert pairs a
    MoE layer that a held expert computed (mean)."""
    dm, b = cfg["hidden_size"], len(contexts)
    hn, r = cfg["num_attention_heads"], cfg["kv_lora_rank"]
    nope, rope, v = (cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"],
                     cfg["v_head_dim"])
    f = cfg["moe_intermediate_size"]
    e = cfg["deployment"]["num_experts_published"]
    kinds = mixers(cfg)
    n_kda, n_mla = kinds.count("kda"), kinds.count("mla")
    moe = moe_layers(cfg)
    dense = cfg["num_hidden_layers"] - moe
    per_token = (n_kda * _kda_macs(cfg)
                 + n_mla * (_mla_weights(cfg) + hn * (nope * r + r * v))
                 + dense * 3 * dm * cfg["intermediate_size"]
                 + moe * (dm * e + 3 * dm * cfg["num_shared_experts"] * f)
                 + dm * cfg["vocab_size"])
    experts = moe * held_pairs * 3 * dm * f
    attention = n_mla * hn * (2 * r + rope) * sum(contexts)
    return (2.0 * (b * per_token + experts + attention)
            + n_kda * kda_kernel_flops(cfg, b))


def step_bound_s(cfg: dict, contexts: Sequence[int], experts_touched: float,
                 held_pairs: float) -> float:
    """The least time an H100 could take for the step: the larger of its
    operations over the dtype's peak and its bytes over HBM's
    bandwidth."""
    return max(step_flops(cfg, contexts, held_pairs)
               / PEAK_FLOPS[cfg["dtype"]],
               step_bytes(cfg, contexts, experts_touched) / HBM_BYTES_PER_S)
