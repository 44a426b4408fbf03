"""zamba2-1.2b [hybrid] — 38L d_model=2048 32H (kv=32, MHA) d_ff=8192
vocab=32000, ssm_state=64 — Mamba2 backbone + SHARED attention+MLP block
applied every 6 SSM blocks (single parameter copy) [arXiv:2411.15242]."""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="zamba2-1.2b",
    family="hybrid",
    citation="arXiv:2411.15242 (Zamba2)",
    n_layers=38,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    d_ff=8192,
    vocab_size=32000,
    ssm_state=64,
    ssm_head_dim=64,
    ssm_expand=2,
    attn_every=6,           # 6 super-blocks of 6 + 2 tail SSM blocks
))
