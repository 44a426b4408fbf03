"""command-r-plus-104b [dense] — 64L d_model=12288 96H (GQA kv=8)
d_ff=33792 vocab=256000 — GQA, no-bias, parallel attn+MLP block.
[hf:CohereForAI/c4ai-command-r-v01]"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="command-r-plus-104b",
    family="dense",
    citation="hf:CohereForAI/c4ai-command-r-v01 (Command R+ 104B)",
    n_layers=64,
    d_model=12288,
    n_heads=96,
    n_kv_heads=8,
    d_ff=33792,
    vocab_size=256000,
    qkv_bias=False,
    norm="layernorm",
    parallel_block=True,
    rope_theta=75_000_000.0,
))
