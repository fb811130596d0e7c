"""qwen2-1.5b — 28L d_model=1536 12H (GQA kv=2) d_ff=8960 vocab=151936,
GQA + QKV bias.  [arXiv:2407.10671; hf]
Pure full attention => long_500k cell is skipped.
"""
from repro_torch.models.transformer import ArchConfig

CONFIG = ArchConfig(
    name="qwen2-1.5b",
    family="dense",
    n_layers=28,
    d_model=1536,
    n_heads=12,
    n_kv_heads=2,
    d_ff=8960,
    vocab=151936,
    qkv_bias=True,
)


def reduced() -> ArchConfig:
    return CONFIG.with_(
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
        vocab=512, attn_chunk=32, loss_chunk=32)
