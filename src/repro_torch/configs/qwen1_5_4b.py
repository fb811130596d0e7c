"""qwen1.5-4b — 40L d_model=2560 20H (MHA kv=20) d_ff=6912 vocab=151936,
QKV bias.  [hf:Qwen/Qwen1.5 family; hf]
Pure full attention => long_500k cell is skipped.
"""
from repro_torch.models.transformer import ArchConfig

CONFIG = ArchConfig(
    name="qwen1.5-4b",
    family="dense",
    n_layers=40,
    d_model=2560,
    n_heads=20,
    n_kv_heads=20,
    d_ff=6912,
    vocab=151936,
    qkv_bias=True,
)


def reduced() -> ArchConfig:
    return CONFIG.with_(
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_ff=128,
        vocab=512, attn_chunk=32, loss_chunk=32)
