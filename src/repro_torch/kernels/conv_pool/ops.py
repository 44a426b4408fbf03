"""Conv+pool wrapper: a CUDA tensor launches the sm_90a kernel in
``csrc/conv_pool.cu`` (which replaces the Pallas `conv_pool`), a CPU
tensor runs the plain version in ``ref.py``. There is no fallback: a
CUDA call builds and launches the kernel or raises. `user_conv_pool`
counts its launches in its ``launches`` attribute (and nowhere else).
The kernel has no backward, as the Pallas kernel has none: the model
calls it only where no gradient is taken (models/lstm_tiny.py)."""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build
from repro_torch.kernels.conv_pool.ref import conv_pool_ref

# rows of the batch per CTA, and the shared memory a CTA may take
# without opting in (w, bias and the rows' x live there)
ROWS = 4
SMEM_BYTES = 48 * 1024

_P, _I = ctypes.c_void_p, ctypes.c_int


@functools.lru_cache(maxsize=None)
def _lib():
    lib = build.load("conv_pool")
    lib.conv_pool.argtypes = [_P] * 4 + [_I] * 6 + [_P]
    lib.conv_pool.restype = _I
    return lib


def rows_per_cta(T: int, E: int, K: int, F: int) -> int:
    """Batch rows one CTA takes: ROWS, fewer where the rows' x, w and
    the bias would not fit in SMEM_BYTES; 0 where one row does not."""
    fixed = K * E * F + F
    fit = (SMEM_BYTES // 4 - fixed) // (T * E)
    return max(0, min(ROWS, fit))


def user_conv_pool(x: torch.Tensor, w: torch.Tensor,
                   b: torch.Tensor) -> torch.Tensor:
    """K3. x [B, T, E], w [K, E, F], b [F], f32 -> [B, (T-K+1)//2, F]
    f32: Conv1D(valid) + bias + ReLU + MaxPool1D(2)."""
    if not x.is_cuda:
        return conv_pool_ref(x, w, b)
    if x.ndim != 3 or w.ndim != 3 or b.ndim != 1 or w.shape[1] != x.shape[2] \
            or b.shape[0] != w.shape[2]:
        raise ValueError(f"user_conv_pool: x [B, T, E], w [K, E, F], b [F]; "
                         f"got {tuple(x.shape)}, {tuple(w.shape)}, "
                         f"{tuple(b.shape)}")
    for name, t in (("x", x), ("w", w), ("b", b)):
        if t.dtype != torch.float32:
            raise ValueError(f"user_conv_pool: {name} is {t.dtype}, the "
                             f"kernel takes float32")
        if t.device != x.device or not t.is_contiguous():
            raise ValueError(f"user_conv_pool: {name} must be contiguous "
                             f"on {x.device}")
    B, T, E = x.shape
    K, _, F = w.shape
    P = (T - K + 1) // 2
    if B < 1 or K < 1 or E < 1 or F < 1 or P < 1:
        raise ValueError(f"user_conv_pool: no output for x {tuple(x.shape)}"
                         f" and w {tuple(w.shape)}")
    rows = rows_per_cta(T, E, K, F)
    if rows < 1:
        raise ValueError(f"user_conv_pool: w {tuple(w.shape)} and one row "
                         f"of x {tuple(x.shape[1:])} exceed the kernel's "
                         f"{SMEM_BYTES} bytes of shared memory")
    out = torch.empty((B, P, F), dtype=torch.float32, device=x.device)
    st = _lib().conv_pool(x.data_ptr(), w.data_ptr(), b.data_ptr(),
                          out.data_ptr(), B, T, E, K, F, rows,
                          torch.cuda.current_stream(x.device).cuda_stream)
    build.check(st, "conv_pool")
    user_conv_pool.launches += 1
    return out


user_conv_pool.launches = 0
