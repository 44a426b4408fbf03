"""Build and load the port's CUDA kernels.

Each kernel source (``kernels/<name>/csrc/<name>.cu``, which may include
the shared ``kernels/csrc/*.cuh``) is compiled by ``nvcc`` for sm_90a
into a shared library with a plain C interface and loaded with
``ctypes``. Libraries go to ``$REPRO_TORCH_KERNEL_CACHE_DIR``, or else
``build/kernels/`` at the repository root (listed in ``.gitignore``),
named by a digest of their sources and flags, so a changed source is
rebuilt and an unchanged one is reused: the directory is the kernel-
build cache that every process shares (launch/compile_cache.py).
Nothing is compiled at import: the first launch builds its library,
and ``build_all`` builds every library at once (one ``nvcc`` per
source, all started together).
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

KERNELS_DIR = Path(__file__).resolve().parent
INCLUDE_DIR = KERNELS_DIR / "csrc"
CACHE_ENV = "REPRO_TORCH_KERNEL_CACHE_DIR"
DEFAULT_BUILD_DIR = KERNELS_DIR.parents[2] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
              "-lineinfo")

SOURCES = {
    "conv_pool": KERNELS_DIR / "conv_pool" / "csrc" / "conv_pool.cu",
    "decode_attention":
        KERNELS_DIR / "decode_attention" / "csrc" / "decode_attention.cu",
    "prefill_attention":
        KERNELS_DIR / "prefill_attention" / "csrc" / "prefill_attention.cu",
    "lstm_cell": KERNELS_DIR / "lstm_cell" / "csrc" / "lstm_cell.cu",
    "quant_channel":
        KERNELS_DIR / "quant_channel" / "csrc" / "quant_channel.cu",
}


def _nvcc() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(found):
        raise RuntimeError("nvcc not found (PATH or /usr/local/cuda/bin)")
    return found


def build_dir() -> Path:
    """Where libraries are built and found: $REPRO_TORCH_KERNEL_CACHE_DIR,
    or build/kernels/ at the repository root."""
    return Path(os.environ.get(CACHE_ENV) or DEFAULT_BUILD_DIR).resolve()


def library_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    h.update(SOURCES[name].read_bytes())
    for hdr in sorted(INCLUDE_DIR.glob("*.cuh")):
        h.update(hdr.read_bytes())
    return build_dir() / f"lib{name}-{h.hexdigest()[:16]}.so"


def _start(name: str):
    """Start `nvcc` for `name` unless its library exists. Returns
    (process, temp path, final path, log path) or None."""
    out = library_path(name)
    if out.exists():
        return None
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    log = out.with_suffix(".log")
    cmd = [_nvcc(), *NVCC_FLAGS, "-I", str(INCLUDE_DIR), "-o", str(tmp),
           str(SOURCES[name])]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out, log


def _finish(job) -> str:
    proc, tmp, out, log = job
    text, _ = proc.communicate()
    log.write_text(text)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {out.name}:\n{text}")
    os.replace(tmp, out)           # atomic: concurrent builds agree
    return text


def build_all(names=None) -> tuple[float, dict]:
    """Build every kernel library not built yet, all `nvcc`s in
    parallel. Returns (wall seconds, {name: compiler output}); a library
    built earlier gives the output saved beside it."""
    t0 = time.perf_counter()
    jobs = {n: _start(n) for n in (names or SOURCES)}
    logs = {n: _finish(j) if j is not None
            else library_path(n).with_suffix(".log").read_text()
            for n, j in jobs.items()}
    return time.perf_counter() - t0, logs


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """The loaded library for `name`, built first if needed."""
    job = _start(name)
    if job is not None:
        _finish(job)
    return ctypes.CDLL(str(library_path(name)))


def check(status: int, what: str) -> None:
    """Raise if a C entry returned a CUDA error (launch refused)."""
    if status != 0:
        raise RuntimeError(f"{what}: CUDA error {status} at launch")


# ------------------------------------------------- launch geometry
@functools.lru_cache(maxsize=None)
def sm_count(index: int) -> int:
    """SMs of CUDA device `index`, which the launch geometries fill."""
    import torch
    return torch.cuda.get_device_properties(index).multi_processor_count


# ------------------------------------------------- wrapper-side checks
_DTYPE_CODES = {"torch.float32": 0, "torch.bfloat16": 1}
# the head dims the attention kernels (K7-K10) are instantiated for (160
# is stablelm-12b's); any other raises at the wrapper
HEAD_DIMS = (64, 128, 160)


def attention_args(what: str, q, k, v, hd: int) -> int:
    """Validate the float operands of an attention launch (all on one
    CUDA device, one dtype, contiguous, 16-byte aligned for the kernels'
    vector loads, a supported head dim; the head dim first, so that the
    message naming the missing instance shows on any device). Returns
    the kernel's dtype code."""
    if hd not in HEAD_DIMS:
        raise ValueError(
            f"{what}: head dim {hd} not in {HEAD_DIMS}: the attention "
            f"kernels have no instance for it (a `dispatch_hd` case in "
            f"decode_attention.cu and prefill_attention.cu is missing)")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_cuda or t.device != q.device:
            raise ValueError(f"{what}: {name} must be on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{what}: {name} must be 16-byte aligned")
        if t.dtype != q.dtype:
            raise ValueError(f"{what}: {name} is {t.dtype}, q is {q.dtype}")
    if v.shape != k.shape:
        raise ValueError(f"{what}: v {tuple(v.shape)} vs k {tuple(k.shape)}")
    code = _DTYPE_CODES.get(str(q.dtype))
    if code is None:
        raise ValueError(f"{what}: dtype {q.dtype} not in float32/bfloat16")
    return code


# page bases a paged attention CTA stages at a time, at most (8 bytes
# each: 16 KiB). The wrappers' `stage_pages` give each launch its number,
# which sizes the kernel's shared-memory array and cuts a longer span into
# segments of that many pages (kernels/csrc/kv_cols.cuh), so a CTA's
# shared memory does not grow with the table row
STAGE_PAGES = 2048
# the most columns one step of an attention body's column loop spans
# (kv_cols.cuh's MAX_STEP): a segment holds at least one, and the launch
# refuses a staging too small for that
MAX_STEP = 64
# columns a paged table row may address: the kernels index columns,
# positions and lengths in int32, and sum two of them at most (a column
# and a tile, a length and a split count), which stays below 2^31
MAX_COLUMNS = 1 << 30


def stage_pages(span: int, page: int, n_lp: int) -> int:
    """Page bases a paged CTA stages at a time for a range of at most
    `span` columns starting anywhere (one page more than the range fills
    when unaligned): never more than the table row of n_lp pages holds
    nor STAGE_PAGES, never fewer than a segment of one loop step needs."""
    need = max(-(-span // page) + 1, -(-MAX_STEP // page) + 1)
    return min(need, n_lp, STAGE_PAGES)


def check_table(what: str, n_lp: int, page: int) -> None:
    """Refuse, before launch, a table row of n_lp pages of `page` whose
    columns the kernels' int32 indices cannot address (MAX_COLUMNS)."""
    if n_lp * page > MAX_COLUMNS:
        raise ValueError(
            f"{what}: a table row of {n_lp} pages of {page} addresses "
            f"{n_lp * page} columns, past the {MAX_COLUMNS} (2^30) the "
            f"kernels' int32 column indices take")


def int_rows(x, B: int, device):
    """A scalar or [B] integer vector as a contiguous int32 [B] tensor on
    `device` (the per-slot lengths / starts)."""
    import torch
    t = torch.as_tensor(x, device=device).to(torch.int32).reshape(-1)
    if t.numel() == 1 and B != 1:
        t = t.expand(B)
    if t.shape != (B,):
        raise ValueError(f"expected a scalar or [{B}] vector, got "
                         f"{tuple(t.shape)}")
    return t.contiguous()


def int_table(tables, B: int, device):
    """Page tables as a contiguous int32 [B, n_lp] tensor on `device`."""
    import torch
    t = torch.as_tensor(tables, device=device).to(torch.int32)
    if t.ndim != 2 or t.shape[0] != B:
        raise ValueError(f"tables must be [{B}, n_lp], got {tuple(t.shape)}")
    return t.contiguous()
