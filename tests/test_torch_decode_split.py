"""The decode kernels' split-KV algorithm on the CPU: its plain mirrors
(`decode_attention_split_ref`: a partial per split, then the merge in
split order; `paged_decode_attention_split_ref`: the same through the
paged kernel's addressing) against the JAX package's Pallas
`decode_attention` and `paged_decode_attention` in interpret mode, and
the wrapper's choice of the split count.

Tolerance 2e-4, as the JAX suite uses for attention. Rows of length 0
return 0 in the port and are compared with 0 (the TPU kernel averages V
over them; the engine discards both)."""
import inspect
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import attn_fixture, paged_from_dense
from repro.kernels.decode_attention import ops as jax_decode
from repro_torch.kernels.decode_attention import ops as pt_decode
from repro_torch.kernels.decode_attention.ref import (
    decode_attention_split_ref, decode_split_ranges,
    paged_decode_attention_split_ref, paged_view)

TOL = 2e-4
S = 100                          # not a multiple of any tile
LENGTHS = np.array([0, 1, 2, 31, 32, 33, 77, S], np.int32)


@pytest.mark.parametrize("n_split", [1, 2, 3, 7])
@pytest.mark.parametrize("g,window", [(1, 0), (4, 0), (1, 48), (4, 48)])
def test_split_mirror_matches_jax_kernel(n_split, g, window):
    q, k, v = attn_fixture(11 + n_split, len(LENGTHS), 2, g, S, 64)
    ref = np.asarray(jax_decode.gqa_decode(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        jnp.asarray(LENGTHS), window=window, interpret=True), np.float32)
    got = decode_attention_split_ref(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        torch.from_numpy(LENGTHS), window=window, n_split=n_split)
    assert got.dtype == torch.float32 and got.shape == q.shape
    live = LENGTHS > 0
    np.testing.assert_allclose(got.numpy()[live], ref[live], rtol=TOL,
                               atol=TOL)
    assert torch.all(got[~torch.from_numpy(live)] == 0)


def test_split_ranges_cover_the_span_once():
    """The ranges tile each row's valid span in order, some are empty
    (length 1 over 7 splits), and none leaves [0, S)."""
    for window in (0, 48):
        lo, hi = decode_split_ranges(torch.from_numpy(LENGTHS), S, window, 7)
        for b, ln in enumerate(LENGTHS.tolist()):
            want = set(range(max(ln - window, 0) if window else 0,
                             min(ln, S)))
            cols = [c for i in range(7)
                    for c in range(int(lo[b, i]), int(hi[b, i]))]
            assert cols == sorted(want)
            assert all(0 <= c < S for c in cols)
        assert (hi <= lo).any()


def test_split_mirror_rounds_p_to_v_dtype():
    """In bf16 the mirror rounds p before p . V, as the kernel and the
    Pallas kernel do: it agrees with the one-pass plain version at the
    bf16 tolerance, and every split count gives the same answer."""
    from repro_torch.kernels.decode_attention.ref import decode_attention_ref
    q, k, v = (torch.from_numpy(a).bfloat16()
               for a in attn_fixture(3, 4, 2, 1, 64, 64))
    lengths = torch.tensor([1, 20, 40, 64])
    want = decode_attention_ref(q, k, v, lengths).float()
    outs = [decode_attention_split_ref(q, k, v, lengths, n_split=n)
            for n in (1, 3)]
    for got in outs:
        torch.testing.assert_close(got, want, rtol=2e-2, atol=2e-2)
    torch.testing.assert_close(outs[0], outs[1], rtol=1e-2, atol=1e-2)


def test_split_count_depends_on_shapes_only():
    """`decode_splits` takes the batch and head shapes and nothing else
    (no lengths, so the wrapper never reads them on the host, and no
    column count, so a dense cache and its paged copy get one count),
    stays within [1, MAX_SPLITS], and puts three CTAs on each of the
    H100's 132 SMs where the cap allows: 4 at the serving shape (8
    slots x 16 KV heads)."""
    params = list(inspect.signature(pt_decode.decode_splits).parameters)
    assert params == ["B", "Hkv", "G"]
    for B in (1, 2, 8, 64):
        for Hkv, G in ((16, 1), (4, 4), (2, 8), (1, 3)):
            n = pt_decode.decode_splits(B, Hkv, G)
            assert 1 <= n <= pt_decode.MAX_SPLITS
            units = B * Hkv * math.ceil(G / pt_decode.group_rows(G))
            if n < pt_decode.MAX_SPLITS:
                assert units * n >= pt_decode.TARGET_CTAS
                assert n == 1 or units * (n - 1) < pt_decode.TARGET_CTAS
    assert pt_decode.decode_splits(8, 16, 1) == 4


# ---------------------------------------------------- the paged kernel (K8)
PAGED_S = 80                     # 10 pages of 8, 5 of 16
PAGED_LENGTHS = np.array([0, 1, 15, 16, 17, PAGED_S], np.int32)


def _paged_case(page, g, seed):
    """Seeded q and dense K/V scattered into a shuffled pool; each row's
    table entries past its used pages point at the spare garbage page."""
    q, k, v = attn_fixture(seed, len(PAGED_LENGTHS), 2, g, PAGED_S, 64)
    kp, vp, tables, spare = paged_from_dense(k, v, page, seed + 1)
    for b, ln in enumerate(PAGED_LENGTHS.tolist()):
        tables[b, -(-ln // page):] = spare
    return q, kp, vp, tables


@pytest.mark.parametrize("n_split", [1, 3])
@pytest.mark.parametrize("g,window", [(1, 0), (4, 0), (1, 48), (4, 48)])
@pytest.mark.parametrize("page", [8, 16])
def test_paged_split_mirror_matches_jax_kernel(page, g, window, n_split):
    """The paged split mirror (the kernel's addressing: S = n_lp * page,
    clamped page ids, a partial per split merged in split order) against
    the Pallas `paged_decode_attention` in interpret mode; the garbage
    page behind each row's last used page never contributes."""
    q, kp, vp, tables = _paged_case(page, g, 21 + page + n_split)
    ref = np.asarray(jax_decode.gqa_decode_paged(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
        jnp.asarray(tables), jnp.asarray(PAGED_LENGTHS), window=window,
        interpret=True), np.float32)
    got = paged_decode_attention_split_ref(
        *(torch.from_numpy(a) for a in (q, kp, vp, tables, PAGED_LENGTHS)),
        window=window, n_split=n_split)
    assert got.dtype == torch.float32 and got.shape == q.shape
    live = PAGED_LENGTHS > 0
    np.testing.assert_allclose(got.numpy()[live], ref[live], rtol=TOL,
                               atol=TOL)
    assert torch.all(got[~torch.from_numpy(live)] == 0)


@pytest.mark.parametrize("page", [8, 16])
def test_paged_split_mirror_clamps_page_ids(page):
    """Page ids outside the pool are clamped, as the kernel clamps them:
    out-of-range entries past a row's pages change nothing, and the
    mirror equals the dense split mirror on the data it maps."""
    q, kp, vp, tables = _paged_case(page, 1, 5)
    t = torch.from_numpy
    want = paged_decode_attention_split_ref(
        t(q), t(kp), t(vp), t(tables), t(PAGED_LENGTHS), n_split=3)
    wild = tables.copy()
    for b, ln in enumerate(PAGED_LENGTHS.tolist()):
        used = -(-ln // page)
        wild[b, used:] = np.where(np.arange(wild.shape[1] - used) % 2,
                                  -7, len(kp) + 100)
    got = paged_decode_attention_split_ref(
        t(q), t(kp), t(vp), t(wild), t(PAGED_LENGTHS), n_split=3)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    ids = t(tables).long().clamp(0, len(kp) - 1)
    dense = decode_attention_split_ref(
        t(q), paged_view(t(kp), ids), paged_view(t(vp), ids),
        t(PAGED_LENGTHS), n_split=3)
    torch.testing.assert_close(got, dense, rtol=0, atol=0)
