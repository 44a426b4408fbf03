"""llama4-scout-17b-a16e [moe] — 48L d_model=5120 40H (GQA kv=8) expert
d_ff=8192, MoE 16 experts top-1 + shared expert, vocab=202048 — early
fusion [hf:meta-llama/Llama-4-Scout-17B-16E]."""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="llama4-scout-17b-a16e",
    family="moe",
    citation="hf:meta-llama/Llama-4-Scout-17B-16E",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    d_ff=8192,
    moe_d_ff=8192,
    vocab_size=202048,
    n_experts=16,
    top_k=1,
    shared_expert=True,
    rope_theta=500000.0,
))
