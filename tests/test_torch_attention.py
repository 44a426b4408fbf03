"""Port parity: the plain versions of the four serving attention kernels
(what the port's wrappers run on CPU tensors) against the JAX package's
Pallas kernels in interpret mode, on the same numpy inputs.

Rows of length 0 (idle slots) are left out: the TPU kernel averages V
over them and the CUDA kernel returns 0; the engine discards both.
Tolerance 2e-4, as the JAX suite uses for attention."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import attn_fixture as _fixture
from _torch_parity import paged_from_dense as _paged
from repro.kernels.decode_attention import ops as jax_decode
from repro.kernels.prefill_attention import ops as jax_prefill
from repro_torch.kernels.decode_attention import ops as pt_decode
from repro_torch.kernels.decode_attention.ref import paged_view
from repro_torch.kernels.prefill_attention import ops as pt_prefill

TOL = 2e-4


def _np(x):
    return np.asarray(x, np.float32)


@pytest.mark.parametrize("g,window", [(1, 0), (4, 0), (1, 24), (4, 24)])
def test_decode_plain_matches_jax_kernel(g, window):
    """K7: dense decode, per-row lengths."""
    q, k, v = _fixture(1, 4, 2, g, 64, 64)
    length = np.array([1, 17, 40, 64], np.int32)
    ref = jax_decode.gqa_decode(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), jnp.asarray(length),
                                window=window, interpret=True)
    got = pt_decode.gqa_decode(torch.from_numpy(q), torch.from_numpy(k),
                               torch.from_numpy(v), torch.from_numpy(length),
                               window=window)
    assert got.dtype == torch.float32 and got.shape == q.shape
    np.testing.assert_allclose(got.numpy(), _np(ref), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("g,window", [(1, 0), (4, 0), (4, 20)])
def test_paged_decode_plain_matches_jax_kernel(g, window):
    """K8: paged decode through shuffled tables whose unused entries
    point at a garbage page."""
    q, k, v = _fixture(2, 4, 2, g, 64, 64)
    length = np.array([3, 16, 33, 50], np.int32)
    kp, vp, tables, spare = _paged(k, v, 16, 5)
    for bi, ln in enumerate(length):
        tables[bi, -(-ln // 16):] = spare
    ref = jax_decode.gqa_decode_paged(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
        jnp.asarray(tables), jnp.asarray(length), window=window,
        interpret=True)
    got = pt_decode.gqa_decode_paged(
        torch.from_numpy(q), torch.from_numpy(kp), torch.from_numpy(vp),
        torch.from_numpy(tables), torch.from_numpy(length), window=window)
    np.testing.assert_allclose(got.numpy(), _np(ref), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("g,c,window", [(1, 4, 0), (1, 8, 0), (4, 16, 0),
                                        (1, 32, 0), (4, 8, 24)])
def test_prefill_plain_matches_jax_kernel(g, c, window):
    """K9: dense chunk prefill at the engine's buckets, staggered starts."""
    q, k, v = _fixture(3, 4, 2, g, 128, 64, c=c)
    start = np.array([0, 5, 33, 128 - c], np.int32)
    ref = jax_prefill.gqa_prefill(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), jnp.asarray(start),
                                  window=window, interpret=True)
    got = pt_prefill.gqa_prefill(torch.from_numpy(q), torch.from_numpy(k),
                                 torch.from_numpy(v),
                                 torch.from_numpy(start), window=window)
    assert got.dtype == torch.float32 and got.shape == q.shape
    np.testing.assert_allclose(got.numpy(), _np(ref), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("g,c,window", [(1, 8, 0), (4, 4, 0), (1, 16, 12)])
def test_paged_prefill_plain_matches_jax_kernel(g, c, window):
    """K10: paged chunk prefill; entries past each chunk point at a
    garbage page."""
    q, k, v = _fixture(4, 4, 2, g, 64, 64, c=c)
    start = np.array([0, 9, 24, 64 - c], np.int32)
    kp, vp, tables, spare = _paged(k, v, 16, 6)
    for bi, st in enumerate(start):
        tables[bi, -(-(st + c) // 16):] = spare
    ref = jax_prefill.gqa_prefill_paged(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
        jnp.asarray(tables), jnp.asarray(start), window=window,
        interpret=True)
    got = pt_prefill.gqa_prefill_paged(
        torch.from_numpy(q), torch.from_numpy(kp), torch.from_numpy(vp),
        torch.from_numpy(tables), torch.from_numpy(start), window=window)
    np.testing.assert_allclose(got.numpy(), _np(ref), rtol=TOL, atol=TOL)


def test_paged_view_matches_jax():
    from repro.models.layers import paged_view as jax_view
    _, k, v = _fixture(5, 2, 2, 1, 32, 64)
    kp, _, tables, _ = _paged(k, v, 8, 7)
    np.testing.assert_array_equal(
        paged_view(torch.from_numpy(kp), torch.from_numpy(tables)).numpy(),
        _np(jax_view(jnp.asarray(kp), jnp.asarray(tables))))


def test_cpu_wrappers_count_no_launches():
    """A CPU tensor takes the plain version: no kernel, no launch."""
    before = (pt_decode.gqa_decode.launches,
              pt_decode.gqa_decode_paged.launches,
              pt_prefill.gqa_prefill.launches,
              pt_prefill.gqa_prefill_paged.launches)
    q, k, v = _fixture(6, 1, 1, 1, 32, 64)
    pt_decode.gqa_decode(torch.from_numpy(q), torch.from_numpy(k),
                         torch.from_numpy(v), 5)
    assert (pt_decode.gqa_decode.launches,
            pt_decode.gqa_decode_paged.launches,
            pt_prefill.gqa_prefill.launches,
            pt_prefill.gqa_prefill_paged.launches) == before
