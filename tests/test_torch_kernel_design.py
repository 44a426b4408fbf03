"""The Hopper designs of K1 (packed wire) and K3 (conv + pool) on the CPU,
where no CUDA kernel runs: the launch geometry each wrapper computes in
Python, the identity behind K1's element body, and a mirror of K3's
walk. Each is held to the JAX package: K1's flip planes to its
`bit_flip_mask` bit for bit, K3's walk to its Pallas `conv_pool` in
interpret mode within 2e-5 (the JAX suite's conv tolerance,
tests/test_kernels.py)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import wire as JW
from repro.kernels.conv_pool.ops import user_conv_pool as j_conv_pool
from repro_torch.kernels.conv_pool import ops as cp
from repro_torch.kernels.quant_channel import ops as qc

CONV_TOL = 2e-5
GOLDEN = 0x9E3779B9
H100_SMS = 132


# ----------------------------------------------------- K1's element body
def _pre(v):
    return v ^ (v >> np.uint32(16))


def _fmix32_rest(x):
    with np.errstate(over="ignore"):
        x = x * np.uint32(0x7FEB352D)
        x = x ^ (x >> np.uint32(15))
        x = x * np.uint32(0x846CA68B)
    return x ^ (x >> np.uint32(16))


def _kernel_flip_masks(rand, bits, thresh):
    """The CUDA body's flip masks (quant_channel.cu: flip_masks): pre()
    once per word, each plane's folded salt pre((b+1) * GOLDEN)."""
    r = _pre(rand)
    m = np.zeros_like(rand)
    for b in range(bits):
        salt = _pre(np.uint32((b + 1) * GOLDEN & 0xFFFFFFFF))
        m |= (_fmix32_rest(r ^ salt) < thresh).astype(np.uint32) \
            << np.uint32(b)
    return m


def test_folded_plane_salts_give_fmix32_bit_for_bit():
    """fmix32(r ^ c_b) = rest(pre(r) ^ pre(c_b)) for every plane b the
    wire takes (0..30), c_b = (b+1) * GOLDEN, over 2^17 random words;
    the left side is the JAX package's fmix32."""
    rand = np.random.default_rng(0).integers(
        0, 2 ** 32, 2 ** 17, dtype=np.uint64).astype(np.uint32)
    r = _pre(rand)
    for b in range(31):
        c = np.uint32((b + 1) * GOLDEN & 0xFFFFFFFF)
        want = np.asarray(JW.fmix32(jnp.asarray(rand ^ c)))
        np.testing.assert_array_equal(_fmix32_rest(r ^ _pre(c)), want)


@pytest.mark.parametrize("bits", [1, 4, 8, 16, 31])
def test_kernel_flip_masks_equal_jax_bit_flip_mask(bits):
    """The body's plane loop gives JAX's flip mask bit for bit, at
    thresholds from 0 to 1 (p * 2^32 truncated, as both take it)."""
    rng = np.random.default_rng(bits)
    rand = rng.integers(0, 2 ** 32, 2 ** 15, dtype=np.uint64) \
        .astype(np.uint32)
    for p in (0.0, 1e-3, 0.07, 0.5, 1.0):
        thresh = np.uint64(np.float32(p) * np.float32(2 ** 32))
        got = _kernel_flip_masks(rand, bits, thresh)
        want = np.asarray(JW.bit_flip_mask(jnp.asarray(rand), bits,
                                           np.float32(p)))
        np.testing.assert_array_equal(got.astype(np.uint32), want)


# ------------------------------------------------------ K1's geometry
@pytest.mark.parametrize("rows,cols", [(224, 256), (1080, 256), (1, 4),
                                       (3, 260), (225, 256), (1081, 260),
                                       (360, 256)])
def test_wire_geometry_covers_each_vector_once(rows, cols):
    """The grid (ceil(rows / ry), ceil(cols / 4 / tx)) of (tx, ry)
    threads gives every 16-byte vector exactly one thread, at most 256
    threads a CTA, and every SM a CTA where the buffer has that many
    vectors."""
    tx, ry = qc.wire_geometry(rows, cols, H100_SMS)
    vc = cols // 4
    assert 1 <= tx * ry <= qc.MAX_THREADS
    gx, gy = -(-rows // ry), -(-vc // tx)
    hits = np.zeros((rows, vc), np.int64)
    for bx in range(gx):
        for by in range(gy):
            r = bx * ry + np.arange(ry)[:, None]
            c = by * tx + np.arange(tx)[None, :]
            r, c = np.broadcast_arrays(r, c)
            ok = (r < rows) & (c < vc)
            np.add.at(hits, (r[ok], c[ok]), 1)
    assert (hits == 1).all()
    if rows * vc >= H100_SMS * tx:
        assert gx * gy >= H100_SMS


def test_wire_geometry_fills_the_card_at_the_sl_leg():
    """The SL leg's [224, 256] spreads over 224 CTAs (one per row), the
    FL upload's [1080, 256] over 270 of 256 threads."""
    assert qc.wire_geometry(224, 256, H100_SMS) == (64, 1)
    assert qc.wire_geometry(1080, 256, H100_SMS) == (64, 4)


def test_wire_geometry_raises_outside_the_grid():
    with pytest.raises(ValueError, match="grid"):
        qc.wire_geometry(2 ** 31, 256, H100_SMS)
    with pytest.raises(ValueError, match="grid"):
        qc.wire_geometry(4, 4 * (qc.MAX_TX * 65535 + 1), H100_SMS)


# ------------------------------------------------------ K3's geometry
def test_conv_geometry_fills_the_card_at_the_uplink_batch():
    """At the two-party uplink [512, 30, 8] x [3, 8, 32] the launch puts
    at least WARPS_PER_SM warps on each of the 132 SMs (old kernel: 128
    CTAs of one row quartet); the eval slice keeps whole rows per warp
    as far as that allows."""
    g = cp.conv_geometry(512, 30, 8, 3, 32, H100_SMS)
    assert g["ctas"] >= H100_SMS
    assert g["ctas"] * cp.WARPS >= H100_SMS * cp.WARPS_PER_SM
    assert g == dict(span=3, n_spans=5, n_groups=1, ctas=640)
    assert cp.conv_geometry(2048, 30, 8, 3, 32, H100_SMS) == dict(
        span=7, n_spans=2, n_groups=1, ctas=1024)


@pytest.mark.parametrize("E", [1, 2, 3, 4, 5, 8, 12, 16, 32])
@pytest.mark.parametrize("K", [0, 1, 3, 5, 6])
def test_conv_geometry_raises_exactly_outside_the_instances(E, K):
    """The kernel has instances for E in (4, 8, 16) and 1 <= K <= 5 (the
    weight column lives in registers): every other (E, K) raises a
    ValueError naming the limit, and K = 0 has no output."""
    if E in cp.E_SIZES and 1 <= K <= cp.K_MAX:
        g = cp.conv_geometry(7, 30, E, K, 32, H100_SMS)
        assert g["ctas"] >= 1
    else:
        with pytest.raises(ValueError,
                           match="registers" if K else "no output"):
            cp.conv_geometry(7, 30, E, K, 32, H100_SMS)


def test_conv_geometry_keeps_each_span_in_shared_memory():
    """A long row is split so that each warp's staged x positions (2 *
    span + K - 1 of E floats) fit SMEM_PER_WARP, and the spans still
    cover its pooled positions."""
    for B, T, E, K in ((1, 30, 8, 3), (4, 4000, 16, 5), (3000, 2001, 16, 5)):
        g = cp.conv_geometry(B, T, E, K, 32, H100_SMS)
        P = (T - K + 1) // 2
        assert (2 * g["span"] + K - 1) * E * 4 <= cp.SMEM_PER_WARP
        assert (g["n_spans"] - 1) * g["span"] < P <= g["n_spans"] * g["span"]


def test_conv_geometry_raises_without_output():
    with pytest.raises(ValueError, match="no output"):
        cp.conv_geometry(4, 3, 8, 3, 32, H100_SMS)  # T - K + 1 = 1: P = 0
    with pytest.raises(ValueError, match="no output"):
        cp.conv_geometry(0, 30, 8, 3, 32, H100_SMS)


def _walk(x, w, b, g):
    """A float32 mirror of conv_pool.cu's walk for the geometry `g`: per
    (row, group, span) unit, K running sums fed in order by each x
    position, the pool in registers; also counts the writes of each
    output."""
    B, T, E = x.shape
    K, _, F = w.shape
    P = (T - K + 1) // 2
    out = np.zeros((B, P, F), np.float32)
    writes = np.zeros((B, P, F), np.int64)
    for j in range(g["n_spans"]):
        p0 = j * g["span"]
        p1 = min(P, p0 + g["span"])
        for gi in range(g["n_groups"]):
            f = np.arange(32 * gi, min(F, 32 * gi + 32))
            wg, bg = w[:, :, f], b[f]
            acc = np.zeros((K, B, len(f)), np.float32)
            done = {}
            for i in range(2 * p0, 2 * p1 + K - 1):
                for jj in range(K):
                    s = np.zeros((B, len(f)), np.float32)
                    for e in range(E):
                        s = s + x[:, i, e, None] * wg[K - 1 - jj, e]
                    acc[jj] = acc[jj] + s
                done[i - K + 1] = acc[0].copy()
                acc = np.concatenate([acc[1:], np.zeros_like(acc[:1])])
            for p in range(p0, p1):
                v0 = np.maximum(done[2 * p] + bg, 0)
                v1 = np.maximum(done[2 * p + 1] + bg, 0)
                out[:, p, f] = np.maximum(v0, v1)
                writes[:, p, f] += 1
    return out, writes


@pytest.mark.parametrize("B,T,E,K,F", [(8, 30, 8, 3, 32), (1, 30, 8, 3, 32),
                                       (3, 29, 4, 1, 16), (8, 11, 16, 5, 48),
                                       (16, 30, 8, 5, 96), (2, 8, 4, 3, 64),
                                       (4, 31, 16, 1, 32)])
def test_conv_walk_matches_jax_kernel(B, T, E, K, F):
    """The kernel's walk at its own geometry and at one span per row
    writes every output once and agrees with the Pallas `conv_pool`
    (interpret mode) and with the plain version within 2e-5."""
    rng = np.random.default_rng(B * T + E + K + F)
    x = rng.standard_normal((B, T, E)).astype(np.float32)
    w = (rng.standard_normal((K, E, F)) / np.sqrt(E)).astype(np.float32)
    b = (rng.standard_normal(F) * 0.1).astype(np.float32)
    want = np.asarray(j_conv_pool(jnp.asarray(x), jnp.asarray(w),
                                  jnp.asarray(b), interpret=True))
    plain = cp.user_conv_pool(torch.from_numpy(x), torch.from_numpy(w),
                              torch.from_numpy(b)).numpy()
    P = (T - K + 1) // 2
    g = cp.conv_geometry(B, T, E, K, F, H100_SMS)
    for geo in (g, dict(g, span=P, n_spans=1)):
        got, writes = _walk(x, w, b, geo)
        assert (writes == 1).all()
        np.testing.assert_allclose(got, want, rtol=CONV_TOL, atol=CONV_TOL)
        np.testing.assert_allclose(got, plain, rtol=CONV_TOL, atol=CONV_TOL)
