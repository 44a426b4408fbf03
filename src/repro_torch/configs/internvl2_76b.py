"""internvl2-76b [vlm] — 80L d_model=8192 64H (GQA kv=8) d_ff=28672
vocab=128256 — InternViT + (Llama-3-70B-class) LM backbone
[arXiv:2404.16821]. The InternViT vision tower + MLP projector is a stub,
as in the JAX package: `input_specs` provides precomputed patch
embeddings [B, 512, d_model] that the model projects and prepends to the
token sequence (512 = 2 tiles x 256 pixel-shuffled patches)."""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="internvl2-76b",
    family="vlm",
    citation="arXiv:2404.16821 (InternVL2; LM backbone Llama-3-70B class)",
    n_layers=80,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=28672,
    vocab_size=128256,
    frontend="vision",
    n_frontend_tokens=512,
    rope_theta=500000.0,
))
