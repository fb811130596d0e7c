"""smollm-360m — 32L d_model=960 15H (GQA kv=5) d_ff=2560 vocab=49152,
llama-arch small.  [hf:HuggingFaceTB/SmolLM family; hf]

15 heads do NOT divide the 16-way model axis — this arch exercises the
sharding rule system's divisibility fallback (heads replicated, d_ff/vocab
sharded).  Pure full attention => long_500k cell is skipped.
"""
from repro_torch.models.transformer import ArchConfig

CONFIG = ArchConfig(
    name="smollm-360m",
    family="dense",
    n_layers=32,
    d_model=960,
    n_heads=15,
    n_kv_heads=5,
    d_ff=2560,
    vocab=49152,
)


def reduced() -> ArchConfig:
    return CONFIG.with_(
        n_layers=2, d_model=60, n_heads=3, n_kv_heads=1, d_ff=128,
        vocab=512, attn_chunk=32, loss_chunk=32)
