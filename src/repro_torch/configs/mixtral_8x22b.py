"""mixtral-8x22b — 56L d_model=6144 48H (GQA kv=8) d_ff=16384 vocab=32768,
MoE 8 experts top-2, sliding-window attention.  [arXiv:2401.04088; hf]

SWA (window 4096) makes decode state O(window) => long_500k cell runs with a
ring-buffer KV cache.
"""
from repro_torch.models.transformer import ArchConfig

CONFIG = ArchConfig(
    name="mixtral-8x22b",
    family="moe",
    n_layers=56,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=16384,
    vocab=32768,
    pattern=(("swa", "moe"),),
    swa_window=4096,
    n_experts=8,
    moe_top_k=2,
)


def reduced() -> ArchConfig:
    return CONFIG.with_(
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
        vocab=512, n_experts=4, moe_top_k=2, moe_impl="dense",
        swa_window=16, attn_chunk=32, loss_chunk=32)
