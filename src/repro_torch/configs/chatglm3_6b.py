"""chatglm3-6b [dense] — 28L d_model=4096 32H (GQA kv=2) d_ff=13696
vocab=65024 — 2D/partial RoPE (applied to half the head dim), GQA
[arXiv:2406.12793]."""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="chatglm3-6b",
    family="dense",
    citation="arXiv:2406.12793 (ChatGLM)",
    n_layers=28,
    d_model=4096,
    n_heads=32,
    n_kv_heads=2,
    d_ff=13696,
    vocab_size=65024,
    qkv_bias=True,
    rope_fraction=0.5,
))
