"""seamless-m4t-medium [audio] — enc-dec, 12L+12L d_model=1024 16H (kv=16)
d_ff=4096 vocab=256206 [arXiv:2308.11596]. The speech frontend
(mel-spectrogram + conv feature extractor) is a STUB, as in the JAX
package: `input_specs` provides frame embeddings [B, S_src, d_model].

vocab is padded 256206 -> 256256 (a multiple of 128, as the JAX package
pads it for its 16-way model axis); the 50 pad rows are never
addressed."""
from repro_torch.configs.base import ArchConfig, register

TRUE_VOCAB = 256206

CONFIG = register(ArchConfig(
    name="seamless-m4t-medium",
    family="audio",
    citation="arXiv:2308.11596 (SeamlessM4T medium; vocab 256206 padded to 256256)",
    n_layers=12,
    enc_layers=12,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_ff=4096,
    vocab_size=256256,
    norm="layernorm",
))
