"""whisper-base — 6L d_model=512 8H d_ff=2048 vocab=51865, encoder-decoder,
conv frontend (stub).  [arXiv:2212.04356; unverified]

Audio: the conv frontend is a STUB; ``input_specs()`` supplies precomputed
frame embeddings (B, 1500, d_model) to the 6-layer bidirectional encoder.
The 6-layer decoder has causal self-attention + cross-attention.  GELU MLPs,
sinusoidal positions (no rope).  Pure full attention => long_500k skipped.
"""
from repro_torch.models.transformer import ArchConfig

CONFIG = ArchConfig(
    name="whisper-base",
    family="audio",
    n_layers=6,
    d_model=512,
    n_heads=8,
    n_kv_heads=8,
    d_ff=2048,
    vocab=51865,
    pattern=(("attn", "gelu"),),
    use_rope=False,
    enc_dec=True,
    n_enc_layers=6,
    enc_seq=1500,
    mlp_variant="gelu",
)


def reduced() -> ArchConfig:
    return CONFIG.with_(
        n_layers=2, n_enc_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
        d_ff=128, vocab=512, enc_seq=32, attn_chunk=32, loss_chunk=32)
