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

# the kernel's instances: E and K are template parameters, so that each
# lane's K x E weight column and its x words live in registers
E_SIZES = (4, 8, 16)
K_MAX = 5
WARPS = 4                       # warps per CTA (csrc/conv_pool.cu)
# warps the launch aims for on each SM: enough that the loads of one
# warp hide behind the FMAs of the others (4 CTAs of WARPS)
WARPS_PER_SM = 16
# shared memory a warp may stage its span's x positions in, so that a CTA
# stays within the 48 KB a launch takes without opting in
SMEM_PER_WARP = 48 * 1024 // WARPS

_P, _I = ctypes.c_void_p, ctypes.c_int


@functools.lru_cache(maxsize=None)
def _lib():
    lib = build.load("conv_pool")
    lib.conv_pool.argtypes = [_P] * 4 + [_I] * 9 + [_P]
    lib.conv_pool.restype = _I
    return lib


def conv_geometry(B: int, T: int, E: int, K: int, F: int,
                  sms: int) -> dict:
    """The kernel's launch for x [B, T, E] and w [K, E, F] on a card of
    `sms` SMs. A warp takes one (row, group of 32 filters, span of
    pooled positions); rows are split into the fewest spans that give
    WARPS_PER_SM warps per SM, or into single positions where even that
    is too few, and into more where a span's 2 * span + K - 1 staged x
    positions would exceed SMEM_PER_WARP. Returns {span, n_spans,
    n_groups, ctas}. Raises ValueError for a shape without output or
    outside the instances."""
    P = (T - K + 1) // 2
    if B < 1 or K < 1 or E < 1 or F < 1 or P < 1:
        raise ValueError(f"user_conv_pool: no output for x [{B}, {T}, {E}]"
                         f" and w [{K}, {E}, {F}]")
    if E not in E_SIZES or K > K_MAX:
        raise ValueError(f"user_conv_pool: the kernel holds w's K x E "
                         f"column in registers and has instances for E in "
                         f"{E_SIZES} and K <= {K_MAX}; got E {E}, K {K}")
    n_groups = -(-F // 32)
    rows = B * n_groups
    n_spans = min(P, max(1, -(-sms * WARPS_PER_SM // rows)))
    max_span = (SMEM_PER_WARP // (4 * E) - K + 1) // 2
    span = min(-(-P // n_spans), max_span)
    n_spans = -(-P // span)
    units = rows * n_spans
    if units >= 2 ** 31:
        raise ValueError(f"user_conv_pool: {units} warps exceed the "
                         f"kernel's 32-bit unit index")
    return dict(span=span, n_spans=n_spans, n_groups=n_groups,
                ctas=-(-units // WARPS))


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
    if x.data_ptr() % 16:
        raise ValueError("user_conv_pool: x must be 16-byte aligned (the "
                         "kernel reads it in 16-byte vectors)")
    B, T, E = x.shape
    K, _, F = w.shape
    g = conv_geometry(B, T, E, K, F, build.sm_count(x.device.index))
    out = torch.empty((B, (T - K + 1) // 2, F), dtype=torch.float32,
                      device=x.device)
    st = _lib().conv_pool(x.data_ptr(), w.data_ptr(), b.data_ptr(),
                          out.data_ptr(), B, T, E, K, F, g["span"],
                          g["n_spans"], g["n_groups"], g["ctas"],
                          torch.cuda.current_stream(x.device).cuda_stream)
    build.check(st, "conv_pool")
    user_conv_pool.launches += 1
    return out


user_conv_pool.launches = 0
