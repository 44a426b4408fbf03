"""LSTM wrappers: a CUDA tensor launches the sm_90a kernel in
``csrc/lstm_cell.cu`` (which replaces the Pallas `lstm_final_state`), a
CPU tensor runs the plain version in ``ref.py``. There is no fallback: a
CUDA call builds and launches the kernel or raises. `lstm_final_state`
counts its launches in its ``launches`` attribute (and nowhere else).
The kernel has no backward, as the Pallas kernel has none: the model
calls it only where no gradient is taken (models/lstm_tiny.py).

The kernel has two bodies, picked from the shape before launch: for
H <= 32 a warp per row group with Wh in registers (`lstm_geometry`), for
32 < H <= 54 one thread per (row, unit) with Wh in shared memory
(`rows_per_cta`)."""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build
from repro_torch.kernels.lstm_cell.ref import lstm_final_state_ref

# the register body: the widest H its lanes take, its warps per CTA at
# most, and the rows each lane runs (two rows share one copy of Wh's
# registers, so the eval slice's 2,048 rows run in one wave)
H_REG = 32
MAX_WARPS = 4
ROWS_PER_LANE = 2
# the shared-memory body: threads a CTA aims at (rows x H), and the
# shared memory it may take without opting in (Wh and the double-buffered
# h live there)
THREADS = 128
SMEM_BYTES = 48 * 1024

_P, _I = ctypes.c_void_p, ctypes.c_int


@functools.lru_cache(maxsize=None)
def _lib():
    lib = build.load("lstm_cell")
    lib.lstm_final_state.argtypes = [_P] * 4 + [_I] * 6 + [_P]
    lib.lstm_final_state_smem.argtypes = [_P] * 4 + [_I] * 4 + [_P]
    for f in (lib.lstm_final_state, lib.lstm_final_state_smem):
        f.restype = _I
    return lib


def lstm_geometry(B: int, H: int, sms: int) -> tuple:
    """The register body's launch for B rows of H units on a card of
    `sms` SMs: (rows_per_warp, warps_per_cta, grid). A warp takes
    32 // H row slots of H lanes, each lane ROWS_PER_LANE rows. Warps per
    CTA halve from MAX_WARPS while the grid would leave an SM without a
    CTA. Raises ValueError for H > 32 (the body keeps 4 x H Wh words a
    lane in registers) or an empty batch."""
    if not 1 <= H <= H_REG:
        raise ValueError(f"lstm_final_state: the register body holds 4 x H "
                         f"Wh words a lane in registers, H <= {H_REG}; "
                         f"got H {H}")
    if B < 1:
        raise ValueError("lstm_final_state: empty batch")
    rpw = H_REG // H * ROWS_PER_LANE
    n_warps = -(-B // rpw)
    warps = MAX_WARPS
    while warps > 1 and -(-n_warps // warps) < sms:
        warps //= 2
    return rpw, warps, -(-n_warps // warps)


def rows_per_cta(H: int) -> int:
    """Batch rows one CTA of the shared-memory body takes (one thread
    per (row, unit)); 0 where Wh [H, 4H] and h do not fit in SMEM_BYTES
    or a row exceeds 1024 threads."""
    rows = max(1, THREADS // H)
    if H > 1024 or 4 * (4 * H * H + 2 * rows * H) > SMEM_BYTES:
        return 0
    return rows


def lstm_final_state(xw: torch.Tensor, wh: torch.Tensor):
    """K4. xw [B, T, 4H] (x @ Wx + b precomputed), wh [H, 4H], f32 ->
    (h_T, c_T), each [B, H] f32."""
    if not xw.is_cuda:
        return lstm_final_state_ref(xw, wh)
    if xw.ndim != 3 or wh.ndim != 2 or xw.shape[2] != wh.shape[1] \
            or wh.shape[1] != 4 * wh.shape[0]:
        raise ValueError(f"lstm_final_state: xw [B, T, 4H] and wh [H, 4H]; "
                         f"got {tuple(xw.shape)}, {tuple(wh.shape)}")
    for name, t in (("xw", xw), ("wh", wh)):
        if t.dtype != torch.float32:
            raise ValueError(f"lstm_final_state: {name} is {t.dtype}, the "
                             f"kernel takes float32")
        if t.device != xw.device or not t.is_contiguous():
            raise ValueError(f"lstm_final_state: {name} must be contiguous "
                             f"on {xw.device}")
    B, T, _ = xw.shape
    H = wh.shape[0]
    if H > H_REG and rows_per_cta(H) < 1:
        raise ValueError(f"lstm_final_state: H = {H} exceeds the kernel's "
                         f"{SMEM_BYTES} bytes of shared memory")
    if B < 1:
        raise ValueError("lstm_final_state: empty batch")
    h = torch.empty((B, H), dtype=torch.float32, device=xw.device)
    c = torch.empty_like(h)
    args = (xw.data_ptr(), wh.data_ptr(), h.data_ptr(), c.data_ptr(), B, T,
            H)
    stream = torch.cuda.current_stream(xw.device).cuda_stream
    if H <= H_REG:
        geo = lstm_geometry(B, H, build.sm_count(xw.device.index))
        st = _lib().lstm_final_state(*args, *geo, stream)
    else:
        st = _lib().lstm_final_state_smem(*args, rows_per_cta(H), stream)
    build.check(st, "lstm_final_state")
    lstm_final_state.launches += 1
    return h, c


def lstm_layer(x: torch.Tensor, wx: torch.Tensor, wh: torch.Tensor,
               b: torch.Tensor) -> torch.Tensor:
    """The tiny model's LSTM layer: x [B, T, F] -> final hidden [B, H];
    wx [F, 4H], wh [H, 4H], b [4H]. The input product x @ Wx + b is one
    matmul outside the kernel, as the JAX wrapper leaves it to XLA; the
    recurrence is K4."""
    xw = torch.matmul(x.float(), wx.float()) + b.float()
    h, _ = lstm_final_state(xw, wh.float().contiguous())
    return h


lstm_final_state.launches = 0
