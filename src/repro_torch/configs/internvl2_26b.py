"""internvl2-26b — 48L d_model=6144 48H (GQA kv=8) d_ff=16384 vocab=92553.
InternViT + InternLM2.  [arXiv:2404.16821; hf]

VLM: this config is the InternLM2 transformer BACKBONE only — the InternViT
frontend is a STUB; ``input_specs()`` supplies precomputed patch embeddings
(B, vision_prefix, d_model) which the model concatenates ahead of the text
tokens.  Pure full attention => long_500k cell is skipped.
"""
from repro_torch.models.transformer import ArchConfig

CONFIG = ArchConfig(
    name="internvl2-26b",
    family="vlm",
    n_layers=48,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=16384,
    vocab=92553,
    vision_prefix=1024,
)


def reduced() -> ArchConfig:
    return CONFIG.with_(
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
        vocab=512, vision_prefix=8, attn_chunk=32, loss_chunk=32)
