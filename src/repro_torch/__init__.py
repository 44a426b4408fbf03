"""repro_torch — the PyTorch / CUDA port of `repro` for one NVIDIA H100.

Mirrors the JAX package's module paths (`repro/serve/engine.py` ↔
`repro_torch/serve/engine.py`, ...). It imports torch, numpy and the
standard library only; the attention kernels on the serving path are
CUDA C++ for sm_90a under `kernels/*/csrc/`, built at first use.
Every entry point takes an explicit `device` (default "cuda", which
raises when no GPU is present); the CPU runs the kernels' plain
versions and is what the tests use.
"""
