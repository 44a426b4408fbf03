"""xlstm-350m [ssm] — 24L d_model=1024 4H d_ff=0 (no FFN) vocab=50304 —
sLSTM + mLSTM blocks [arXiv:2405.04517]. Layout: 4 super-blocks of
5 mLSTM + 1 sLSTM (the paper's ~7:1 mLSTM-heavy mix)."""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="xlstm-350m",
    family="ssm",
    citation="arXiv:2405.04517 (xLSTM)",
    n_layers=24,
    d_model=1024,
    n_heads=4,
    n_kv_heads=4,
    d_ff=0,
    vocab_size=50304,
    slstm_every=6,
    rope_theta=0.0,         # recurrent; no RoPE
))
