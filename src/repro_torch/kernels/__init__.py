"""Hand-written CUDA kernels for the H100, each beside its plain PyTorch
version (``ref.py``) and a wrapper (``ops.py``) that launches the kernel
for CUDA tensors and runs the plain version for CPU tensors."""
