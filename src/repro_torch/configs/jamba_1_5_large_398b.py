"""jamba-1.5-large-398b — 72L d_model=8192 64H (GQA kv=8) d_ff=24576
vocab=65536, MoE 16e top-2, Mamba+attention 7:1 interleave.
[arXiv:2403.19887; hf]

Period-8 pattern: one attention layer per 8, MoE on every other FFN.
Hybrid (mamba state is O(1)) => long_500k cell runs.
"""
from repro_torch.models.transformer import ArchConfig

_PATTERN = (
    ("mamba", "mlp"), ("mamba", "moe"), ("mamba", "mlp"), ("mamba", "moe"),
    ("attn", "mlp"), ("mamba", "moe"), ("mamba", "mlp"), ("mamba", "moe"),
)

CONFIG = ArchConfig(
    name="jamba-1.5-large-398b",
    family="hybrid",
    n_layers=72,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=24576,
    vocab=65536,
    pattern=_PATTERN,
    n_experts=16,
    moe_top_k=2,
    use_rope=False,  # Jamba uses no positional encoding in attention
)


def reduced() -> ArchConfig:
    return CONFIG.with_(
        n_layers=8, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
        vocab=512, n_experts=4, moe_top_k=2, moe_impl="dense",
        ssm_chunk=8, attn_chunk=32, loss_chunk=32)
