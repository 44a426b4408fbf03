"""The kernel-build cache for the entry points — the port of
`repro/launch/compile_cache.py`.

The JAX package caches XLA executables across processes; what the port
compiles is its CUDA kernel libraries (kernels/build.py: one `nvcc` per
source, named by a digest of the sources and flags, built into
`$REPRO_TORCH_KERNEL_CACHE_DIR` or the repository's `build/kernels/`).
The first process pays `nvcc`, every later one loads the libraries it
finds, so a second `--aot-warmup` reports a near-zero wall. The
directory is kernels/build.py's `build_dir()`; this module only names
it for the entry points and gives `--no-compile-cache` a fresh one.
"""
from __future__ import annotations

import atexit
import os
import shutil
import tempfile

from repro_torch.kernels import build

ENV = build.CACHE_ENV


def cache_dir() -> str:
    """$REPRO_TORCH_KERNEL_CACHE_DIR, or the repository's build/kernels/."""
    return str(build.build_dir())


def enable_persistent_cache() -> str:
    """Make the kernel-build cache directory; returns it."""
    d = build.build_dir()
    d.mkdir(parents=True, exist_ok=True)
    return str(d)


def use_kernel_cache(no_cache: bool = False) -> str:
    """What the entry points call first: the kernel-build cache, or under
    `--no-compile-cache` a fresh temporary directory (removed at exit)
    set as $REPRO_TORCH_KERNEL_CACHE_DIR, so that the process pays
    `nvcc` for every library it has not loaded yet. Returns the
    directory."""
    if no_cache:
        d = tempfile.mkdtemp(prefix="repro_torch_kernels_")
        atexit.register(shutil.rmtree, d, ignore_errors=True)
        os.environ[ENV] = d
    return enable_persistent_cache()


def warmup(scheme) -> float:
    """Build and load the kernels `scheme`'s rounds launch (schemes with
    `warmup_compile`) and return the wall seconds; 0.0 for a scheme
    without one."""
    fn = getattr(scheme, "warmup_compile", None)
    return float(fn()) if fn is not None else 0.0
