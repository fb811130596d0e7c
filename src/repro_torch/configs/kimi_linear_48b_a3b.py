"""kimi-linear-48b-a3b — Kimi-Linear-48B-A3B-Instruct as published, on one
chip of its 8-way expert-parallel deployment.

27L d_model=2304; mixers 3 KDA : 1 MLA by the config's explicit lists
(1-indexed ``full_attn_layers`` [4, 8, 12, 16, 20, 24, 27], the other 20
``kda_layers``; 27 is no multiple of 4, so the last period is KDA, KDA,
MLA): KDA (Kimi Delta Attention) of 32 heads of 128 with a short conv of
4 taps on q, k, v; MLA of 32 heads (kv_lora_rank 512, qk_nope 128 +
qk_rope 64, v 128, no q_lora_rank) under ``mla_use_nope``: the 64 rope
columns unrotated.  Layer 0 a dense SwiGLU of 9216, layers 1-26 MoE: 256
routed experts of 1024, top-8 by sigmoid score + correction bias (one
group), weights renormalised and x 2.446, one shared expert of 1024;
rms eps 1e-5; vocab 163840, untied.  [hf:moonshotai/Kimi-Linear-48B-A3B-
Instruct config.json; arXiv:2510.26692]

The deployment: one 8-chip node, expert parallel 8.  Every chip holds the
whole depth, the KDA and MLA layers, the dense layer, the shared experts
and the full vocabulary (data-parallel attention), and 32 of each MoE
layer's 256 routed experts: this chip experts 0-31 (``n_experts_held``
32 from ``experts_held_from`` 0), 7.90B parameters.  The router scores
all 256 and picks 8; the layer computes what its 32 experts give.  The
port's own config (an :class:`MLAConfig`, which the reference package has
no counterpart of); it serves through the dropless ``grouped`` MoE.
"""
from repro_torch.models.transformer import MLAConfig

FULL_ATTN_LAYERS = (4, 8, 12, 16, 20, 24, 27)        # 1-indexed, published
KDA_LAYERS = tuple(i for i in range(1, 28) if i not in FULL_ATTN_LAYERS)

CONFIG = MLAConfig(
    name="kimi-linear-48b-a3b",
    family="hybrid",
    n_layers=27,
    d_model=2304,
    n_heads=32,
    n_kv_heads=32,
    d_ff=1024,
    vocab=163840,
    pattern=(("kda", "moe"),),      # the FFNs; the mixers listed below
    layer_mixers=tuple("mla" if i in FULL_ATTN_LAYERS else "kda"
                       for i in range(1, 28)),
    rope_theta=10000.0,
    n_experts=256,
    moe_top_k=8,
    moe_impl="grouped",
    kv_lora_rank=512,
    qk_nope_head_dim=128,
    qk_rope_head_dim=64,
    v_head_dim=128,
    n_shared_experts=1,
    first_k_dense=1,
    dense_d_ff=9216,
    moe_scoring="sigmoid",
    routed_scaling=2.446,
    route_bias_std=0.05,
    rms_norm_eps=1e-5,
    mla_nope=True,
    kda_heads=32,
    kda_head_dim=128,
    kda_conv=4,
    kda_gate_rank=128,
    n_experts_held=32,
    experts_held_from=0,
)


def reduced() -> MLAConfig:
    """The published block at CPU widths: the first period and the last
    (KDA, KDA, KDA, MLA, KDA, KDA, MLA), a dense layer 0, 8 experts of
    which 4 held."""
    return CONFIG.with_(
        n_layers=7, layer_mixers=("kda",) * 3 + ("mla",) + ("kda",) * 2
        + ("mla",), d_model=64, n_heads=4, n_kv_heads=4, d_ff=32,
        vocab=512, n_experts=8, moe_top_k=2, n_experts_held=4,
        kv_lora_rank=32, qk_nope_head_dim=16, qk_rope_head_dim=8,
        v_head_dim=16, dense_d_ff=96, kda_heads=4, kda_head_dim=16,
        kda_gate_rank=8, attn_chunk=32, loss_chunk=32)
