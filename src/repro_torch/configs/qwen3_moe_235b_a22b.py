"""qwen3-moe-235b-a22b [moe] — 94L d_model=4096 64H (GQA kv=4) per-expert
d_ff=1536, MoE 128 experts top-8, vocab=151936
[hf:Qwen/Qwen3-30B-A3B family / Qwen3-235B-A22B]."""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="qwen3-moe-235b-a22b",
    family="moe",
    citation="hf:Qwen/Qwen3-30B-A3B (Qwen3 MoE family, 235B-A22B)",
    n_layers=94,
    d_model=4096,
    n_heads=64,
    n_kv_heads=4,
    d_ff=1536,
    moe_d_ff=1536,
    vocab_size=151936,
    n_experts=128,
    top_k=8,
    rope_theta=1000000.0,
))
