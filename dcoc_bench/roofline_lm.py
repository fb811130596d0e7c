"""The operations and bytes of one decode step of a DeepSeek-V3-block LM
(MLA with a latent cache, MoE with shared experts), and the least time an
H100 could take for it.

Work is counted from the configuration's ``config.json`` keys and the
step's shapes, never from what a kernel does.  Bytes: every weight the
step needs read once in the configured dtype (the routed experts: only
those a token chose, ``experts_touched`` a layer; the router and the
correction bias in float32), each slot's latent cache (c_kv and k_pe) at
its context read once and its new position written once, the tokens'
embedding rows read and the logits written.  Operations: 2 a
multiply-add of every product, the absorbed attention's at each slot's
context.  Peaks are ``roofline.py``'s.
"""
from __future__ import annotations

from typing import Sequence

from dcoc_bench.roofline import HBM_BYTES_PER_S, ITEMSIZE, PEAK_FLOPS


def moe_layers(cfg: dict) -> int:
    return cfg["num_hidden_layers"] - cfg["first_k_dense_replace"]


def _mla_weights(cfg: dict) -> int:
    d, h, r = (cfg["hidden_size"], cfg["num_attention_heads"],
               cfg["kv_lora_rank"])
    nope, rope, v = (cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"],
                     cfg["v_head_dim"])
    return (d + d * h * (nope + rope) + d * (r + rope) + r
            + r * h * (nope + v) + h * v * d)


def decode_step_bytes(cfg: dict, contexts: Sequence[int],
                      experts_touched: float) -> float:
    """Bytes of one step of ``len(contexts)`` slots, slot b attending over
    ``contexts[b]`` positions; ``experts_touched``: routed experts with a
    token, a MoE layer (mean)."""
    it = ITEMSIZE[cfg["dtype"]]
    d, b = cfg["hidden_size"], len(contexts)
    f, e = cfg["moe_intermediate_size"], cfg["n_routed_experts"]
    latent = cfg["kv_lora_rank"] + cfg["qk_rope_head_dim"]
    layers, moe = cfg["num_hidden_layers"], moe_layers(cfg)
    weights = (layers * _mla_weights(cfg)
               + (layers - moe) * (d + 3 * d * cfg["intermediate_size"])
               + moe * (d + experts_touched * 3 * d * f
                        + 3 * d * cfg["n_shared_experts"] * f))
    cache = layers * latent * (sum(contexts) + b)
    head = d + d * cfg["vocab_size"]
    io = b * d + b * cfg["vocab_size"]              # embedding rows, logits
    router = moe * (d * e + e) * 4                  # float32
    return float(weights + cache + head + io) * it + router


def decode_step_flops(cfg: dict, contexts: Sequence[int],
                      experts_touched: float) -> float:
    """Operations of the same step (``experts_touched`` does not enter:
    each token runs its own top-k)."""
    d, b = cfg["hidden_size"], len(contexts)
    h, r = cfg["num_attention_heads"], cfg["kv_lora_rank"]
    nope, rope, v = (cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"],
                     cfg["v_head_dim"])
    f, k = cfg["moe_intermediate_size"], cfg["num_experts_per_tok"]
    layers, moe = cfg["num_hidden_layers"], moe_layers(cfg)
    per_token = (layers * (_mla_weights(cfg) + h * (nope * r + r * v))
                 + (layers - moe) * 3 * d * cfg["intermediate_size"]
                 + moe * (d * cfg["n_routed_experts"] + 3 * d * f * k
                          + 3 * d * cfg["n_shared_experts"] * f)
                 + d * cfg["vocab_size"])
    attention = layers * h * (2 * r + rope) * sum(contexts)
    return 2.0 * (b * per_token + attention)


def decode_step_bound_s(cfg: dict, contexts: Sequence[int],
                        experts_touched: float) -> float:
    """The least time an H100 could take for the step: the larger of its
    operations over the dtype's peak and its bytes over HBM's
    bandwidth."""
    return max(decode_step_flops(cfg, contexts, experts_touched)
               / PEAK_FLOPS[cfg["dtype"]],
               decode_step_bytes(cfg, contexts, experts_touched)
               / HBM_BYTES_PER_S)
