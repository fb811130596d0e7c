"""moonshot-v1-16b-a3b — Moonlight-style MoE LM.

48L d_model=2048 16H (GQA kv=16) d_ff=1408/expert vocab=163840,
MoE 64 experts top-6.  [hf:moonshotai/Moonlight-16B-A3B; hf]
Pure full attention => long_500k cell is skipped (see DESIGN.md).
"""
from repro_torch.models.transformer import ArchConfig

CONFIG = ArchConfig(
    name="moonshot-v1-16b-a3b",
    family="moe",
    n_layers=48,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1408,
    vocab=163840,
    pattern=(("attn", "moe"),),
    n_experts=64,
    moe_top_k=6,
)


def reduced() -> ArchConfig:
    return CONFIG.with_(
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_ff=96,
        vocab=512, n_experts=4, moe_top_k=2, moe_impl="dense",
        attn_chunk=32, loss_chunk=32)
