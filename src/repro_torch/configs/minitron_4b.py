"""minitron-4b — 32L d_model=3072 24H (GQA kv=8) d_ff=9216 vocab=256000,
pruned nemotron.  [arXiv:2407.14679; hf]
Pure full attention => long_500k cell is skipped.
"""
from repro_torch.models.transformer import ArchConfig

CONFIG = ArchConfig(
    name="minitron-4b",
    family="dense",
    n_layers=32,
    d_model=3072,
    n_heads=24,
    n_kv_heads=8,
    d_ff=9216,
    vocab=256000,
)


def reduced() -> ArchConfig:
    return CONFIG.with_(
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
        vocab=512, attn_chunk=32, loss_chunk=32)
