"""moonlight-16b-a3b — Moonlight-16B-A3B as published, a DeepSeek-V3 block.

27L d_model=2048 16H, MLA (kv_lora_rank 512, qk_nope 128 + qk_rope 64,
v 128, no q_lora_rank), rope theta 50000, rms eps 1e-5; layer 0 a dense
SwiGLU of 11264, layers 1-26 MoE: 64 routed experts of 1408, top-6 by
sigmoid score + correction bias (noaux_tc, one group), weights normalised
and x 2.446, 2 shared experts (one SwiGLU of 2816); vocab 163840,
untied.  [hf:moonshotai/Moonlight-16B-A3B config.json; arXiv:2412.19437]

15.96B parameters.  The port's own config (an :class:`MLAConfig`, which
the reference package has no counterpart of); it serves through the
dropless ``grouped`` MoE.  ``moonshot-v1-16b-a3b`` is the reference's
guess at the same model and stays as the reference has it.
"""
from repro_torch.models.transformer import MLAConfig

CONFIG = MLAConfig(
    name="moonlight-16b-a3b",
    family="moe",
    n_layers=27,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1408,
    vocab=163840,
    pattern=(("mla", "moe"),),
    rope_theta=50000.0,
    n_experts=64,
    moe_top_k=6,
    moe_impl="grouped",
    kv_lora_rank=512,
    qk_nope_head_dim=128,
    qk_rope_head_dim=64,
    v_head_dim=128,
    n_shared_experts=2,
    first_k_dense=1,
    dense_d_ff=11264,
    moe_scoring="sigmoid",
    routed_scaling=2.446,
    route_bias_std=0.05,
    rms_norm_eps=1e-5,
)


def reduced() -> MLAConfig:
    return CONFIG.with_(
        n_layers=3, d_model=64, n_heads=4, n_kv_heads=4, d_ff=32,
        vocab=512, n_experts=8, moe_top_k=2, kv_lora_rank=32,
        qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=16,
        dense_d_ff=96, attn_chunk=32, loss_chunk=32)
