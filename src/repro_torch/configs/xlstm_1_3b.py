"""xlstm-1.3b — 48L d_model=2048 4H vocab=50304, sLSTM + mLSTM blocks.
[arXiv:2405.04517; unverified]

Period-8 pattern: seven mLSTM (matrix-memory) blocks then one sLSTM
(scalar-memory, truly recurrent) block; d_ff=0 — the xLSTM blocks carry
their own internal projections.  Fully recurrent => O(1) decode state,
long_500k cell runs.
"""
from repro_torch.models.transformer import ArchConfig

_PATTERN = tuple([("mlstm", "none")] * 7 + [("slstm", "none")])

CONFIG = ArchConfig(
    name="xlstm-1.3b",
    family="ssm",
    n_layers=48,
    d_model=2048,
    n_heads=4,
    n_kv_heads=4,
    d_ff=0,
    vocab=50304,
    pattern=_PATTERN,
    use_rope=False,
)


def reduced() -> ArchConfig:
    return CONFIG.with_(
        n_layers=8, d_model=64, n_heads=2, n_kv_heads=2, vocab=512,
        ssm_chunk=8, loss_chunk=32)
