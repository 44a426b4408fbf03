"""Shared helpers of the port's tests (tests/test_torch_*.py). Imports
no JAX, so the tests that run on the card can use it there."""
import numpy as np
import pytest
import torch


@pytest.fixture
def cuda_device():
    """The card, for tests marked `cuda`; skips on a host without one
    (decided here, at run time, never at import)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def attn_fixture(seed, b, hkv, g, s, hd, c=None):
    """Seeded f32 (q, k, v): q [b, hkv*g, hd] (decode) or
    [b, c, hkv*g, hd] (prefill chunk), caches [b, hkv, s, hd]."""
    rng = np.random.default_rng(seed)
    qshape = (b, hkv * g, hd) if c is None else (b, c, hkv * g, hd)
    q = rng.standard_normal(qshape).astype(np.float32)
    k = rng.standard_normal((b, hkv, s, hd)).astype(np.float32)
    v = rng.standard_normal((b, hkv, s, hd)).astype(np.float32)
    return q, k, v


def paged_from_dense(k, v, page, seed):
    """Scatter a dense cache into a shuffled pool with one spare
    (garbage) page. Returns (k_pool, v_pool, tables, spare page id);
    callers point table entries past a row's used pages at the spare
    page: placeholder entries that must never contribute."""
    b, hkv, s, hd = k.shape
    n_lp = s // page
    rng = np.random.default_rng(seed)
    n_pages = b * n_lp + 1
    perm = rng.permutation(n_pages)
    kp = rng.standard_normal((n_pages, hkv, page, hd)).astype(np.float32) * 50
    vp = rng.standard_normal((n_pages, hkv, page, hd)).astype(np.float32) * 50
    tables = np.zeros((b, n_lp), np.int32)
    for bi in range(b):
        for j in range(n_lp):
            pid = perm[bi * n_lp + j]
            tables[bi, j] = pid
            kp[pid] = k[bi, :, j * page:(j + 1) * page]
            vp[pid] = v[bi, :, j * page:(j + 1) * page]
    return kp, vp, tables, perm[-1]
