"""The Hopper designs of K1 (packed wire), K3 (conv + pool), K4 (LSTM
recurrence) and K5 (tiled quantize-channel) on the CPU, where no CUDA
kernel runs: the launch geometry each wrapper computes in Python, the
identity behind K1's element body, and mirrors of K3's walk, K4's lane
walk and K5's slice-then-cluster amax. Each is held to the JAX package:
K1's flip planes to its `bit_flip_mask` and K5's mirror to its Pallas
`quant_channel_2d` (interpret mode) bit for bit, K3's walk to its Pallas
`conv_pool` and K4's to its Pallas `lstm_final_state` (interpret mode)
within 2e-5 (the JAX suite's conv and LSTM tolerance,
tests/test_kernels.py)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import wire as JW
from repro.kernels.conv_pool.ops import user_conv_pool as j_conv_pool
from repro.kernels.lstm_cell.kernel import lstm_final_state as j_lstm
from repro.kernels.quant_channel.kernel import quant_channel_2d as j_qc
from repro_torch.kernels.conv_pool import ops as cp
from repro_torch.kernels.lstm_cell import ops as lc
from repro_torch.kernels.quant_channel import ops as qc

CONV_TOL = 2e-5
LSTM_TOL = 2e-5
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



# ------------------------------------------------------ K4's geometry
def _lstm_lanes(B, H, geo):
    """(warp, lane, r) -> the (row, unit) the register body gives it:
    arrays over every lane of the launch, and which of them write."""
    rpw, warps, grid = geo
    per = 32 // H
    w = np.arange(grid * warps)[:, None, None]
    lane = np.arange(32)[None, :, None]
    r = np.arange(rpw // per)[None, None, :]
    slot, j = lane // H, lane % H
    row = w * rpw + r * per + slot
    live = (slot < per) & (row < B)
    return np.broadcast_arrays(row, j, live)


@pytest.mark.parametrize("B,H", [(2048, 32), (512, 32), (1, 32), (7, 32),
                                 (7, 8), (16, 8), (5, 24), (9, 16), (3, 5),
                                 (1000, 13), (33, 1), (2, 32), (3, 32),
                                 (64, 32), (65, 32), (264, 32), (528, 32),
                                 (1056, 32), (4096, 32), (300, 8),
                                 (300, 16), (300, 24), (31, 7), (17, 31),
                                 (1, 1), (2047, 32), (1023, 12), (129, 11),
                                 (263, 32), (527, 32), (1055, 32),
                                 (2112, 32), (4224, 32)])
def test_lstm_geometry_covers_each_row_unit_once(B, H):
    """Every (row, unit) of [B, H] belongs to exactly one live lane, CTAs
    have 1 to MAX_WARPS warps, and a warp takes 32 // H row slots of
    ROWS_PER_LANE rows each."""
    rpw, warps, grid = lc.lstm_geometry(B, H, H100_SMS)
    assert 1 <= warps <= lc.MAX_WARPS
    assert rpw == 32 // H * lc.ROWS_PER_LANE
    row, j, live = _lstm_lanes(B, H, (rpw, warps, grid))
    hits = np.zeros((B, H), np.int64)
    np.add.at(hits, (row[live], j[live]), 1)
    assert (hits == 1).all()
    assert grid == -(-(-(-B // rpw)) // warps)


def test_lstm_geometry_fills_the_card_at_the_path_shapes():
    """The eval slice [2048, 14, 128] runs its 1,024 row warps (two rows
    a lane) in 256 CTAs of 4 warps, 8 warps a SM; the uplink batch
    [512, 14, 128] its 256 in 256 CTAs of 1, so both cover every SM."""
    assert lc.lstm_geometry(2048, 32, H100_SMS) == (2, 4, 256)
    assert lc.lstm_geometry(512, 32, H100_SMS) == (2, 1, 256)
    for B in (2048, 512):
        rpw, warps, grid = lc.lstm_geometry(B, 32, H100_SMS)
        assert grid >= H100_SMS


def test_lstm_geometry_raises_outside_the_register_body():
    for H in (0, 33, 48):
        with pytest.raises(ValueError, match="registers"):
            lc.lstm_geometry(4, H, H100_SMS)
    with pytest.raises(ValueError, match="empty"):
        lc.lstm_geometry(0, 32, H100_SMS)
    # the shared-memory body takes 32 < H <= 54, nothing beyond
    assert lc.rows_per_cta(48) >= 1 and lc.rows_per_cta(54) >= 1
    assert lc.rows_per_cta(55) == 0


def _fmaf(a, b, c):
    """float32 fmaf: the product is exact in float64, the sum rounds
    once there and once to float32 (off by at most an ulp in rare
    ties, far inside the tolerance)."""
    return (a.double() * b.double() + c.double()).float()


def _sigmoid(x):
    return 1.0 / (1.0 + torch.exp(-x))


def _lstm_walk(xw, wh, geo):
    """A torch mirror of lstm_cell.cu's register body for the geometry
    `geo`: each lane its (row, unit) and its 4 x H Wh column, each gate's
    dot one fmaf chain over k ascending from 0 then added to xw, h read
    from its warp's double buffer and written to the other. Returns
    (h, c, writes per output)."""
    B, T, H4 = xw.shape
    H = H4 // 4
    rpw, warps, _ = geo
    per = 32 // H
    row, j, live = (torch.from_numpy(a.copy())
                    for a in _lstm_lanes(B, H, geo))
    n_w, _, rpl = row.shape
    lane_live = torch.from_numpy((np.arange(32) // H < per))[None, :, None]
    slot_row = (torch.arange(rpl)[None, None, :] * per
                + torch.where(lane_live, torch.arange(32)[None, :, None]
                              // H, 0)).expand(n_w, 32, rpl)
    xt, wt = torch.from_numpy(xw), torch.from_numpy(wh)
    rows = torch.where(live, row, 0)
    hs = torch.zeros((n_w, 2, rpw, H), dtype=torch.float32)
    c = torch.zeros((n_w, 32, rpl), dtype=torch.float32)
    h = torch.zeros_like(c)
    wi = torch.arange(n_w)[:, None, None].expand(n_w, 32, rpl)
    for t in range(T):
        hrow = hs[wi, t & 1, slot_row]                 # [n_w, 32, rpl, H]
        gates = []
        for g in range(4):
            d = torch.zeros_like(c)
            for k in range(H):
                d = _fmaf(hrow[..., k], wt[k, g * H + j], d)
            gates.append(torch.where(live, xt[rows, t, g * H + j], 0.0) + d)
        gi, gf, gg, go = gates
        c = _sigmoid(gf) * c + _sigmoid(gi) * torch.tanh(gg)
        h = _sigmoid(go) * torch.tanh(c)
        w_ok = lane_live.expand(n_w, 32, rpl)
        hs[wi[w_ok], (t + 1) & 1, slot_row[w_ok], j[w_ok]] = h[w_ok]
    out_h = torch.zeros((B, H), dtype=torch.float32)
    out_c = torch.zeros_like(out_h)
    writes = torch.zeros((B, H), dtype=torch.int64)
    out_h[row[live], j[live]] = h[live]
    out_c[row[live], j[live]] = c[live]
    writes.index_put_((row[live], j[live]), torch.ones_like(row[live]),
                      accumulate=True)
    return out_h, out_c, writes


@pytest.mark.parametrize("B,T,H", [(8, 14, 32), (7, 30, 32), (5, 1, 8),
                                   (9, 7, 16), (3, 14, 24), (16, 5, 8),
                                   (4, 6, 5), (1, 14, 32), (3, 1, 32),
                                   (17, 9, 8), (6, 12, 16), (2, 3, 31),
                                   (11, 4, 12), (65, 2, 32)])
def test_lstm_lane_walk_matches_jax_kernel(B, T, H):
    """K4's lane walk writes every output once and agrees with the Pallas
    `lstm_final_state` (interpret mode) and with the plain version
    within 2e-5."""
    rng = np.random.default_rng(B * T + H)
    xw = rng.standard_normal((B, T, 4 * H)).astype(np.float32)
    wh = (rng.standard_normal((H, 4 * H)) / np.sqrt(H)).astype(np.float32)
    geo = lc.lstm_geometry(B, H, H100_SMS)
    h, c, writes = _lstm_walk(xw, wh, geo)
    assert (writes == 1).all()
    jh, jc = j_lstm(jnp.asarray(xw), jnp.asarray(wh), interpret=True)
    np.testing.assert_allclose(h.numpy(), np.asarray(jh), rtol=LSTM_TOL,
                               atol=LSTM_TOL)
    np.testing.assert_allclose(c.numpy(), np.asarray(jc), rtol=LSTM_TOL,
                               atol=LSTM_TOL)
    ph, pc = lc.lstm_final_state(torch.from_numpy(xw), torch.from_numpy(wh))
    torch.testing.assert_close(h, ph, rtol=LSTM_TOL, atol=LSTM_TOL)
    torch.testing.assert_close(c, pc, rtol=LSTM_TOL, atol=LSTM_TOL)


# ------------------------------------------------------ K5's geometry
# the card test's ragged tiles, the model's padded [256, 512], many tiles,
# and widths that are no multiple of 4 (one word a load)
QC_SHAPES = [(1, 4), (3, 260), (128, 512), (256, 1024), (256, 512),
             (1024, 2048), (5, 259), (128, 37), (16, 512), (64, 512),
             (512, 512), (8, 12), (20, 1024), (384, 1536), (127, 4),
             (9, 16)]


def _qc_walk(M, N, geo, vec):
    """K5's walk (quant_channel.cu): for each cluster (tile) and CTA
    (rank), the flat indices of x each thread loads, item by item.
    Yields (tile, rank, indices of one item step, valid mask)."""
    cluster, rows, threads = geo
    bm, bn = min(128, M), min(512, N)
    vc = bn // vec
    tx = min(vc, qc.QC_TX)
    ry = threads // tx
    t = np.arange(threads)
    ty, cx = t // tx, t % tx
    for tile in range((M // bm) * (N // bn)):
        ti, tj = divmod(tile, N // bn)
        for rank in range(cluster):
            r = rank * rows + ty
            row1 = min(bm, (rank + 1) * rows)
            cv = cx.copy()
            for _ in range(qc.QC_WORDS // vec):
                ok = (ty < ry) & (r < row1)
                base = (ti * bm + r) * N + tj * bn + cv * vec
                idx = base[:, None] + np.arange(vec)[None, :]
                yield tile, rank, idx, np.broadcast_to(ok[:, None],
                                                       idx.shape)
                cv = cv + tx
                wrap = cv >= vc
                cv = np.where(wrap, cx, cv)
                r = np.where(wrap, r + ry, r)


@pytest.mark.parametrize("M,N", QC_SHAPES)
def test_qc_geometry_covers_each_element_once(M, N):
    """Every element of x lies in exactly one thread's registers (within
    QC_WORDS elements a thread), in a CTA of its own tile, and no CTA of
    a cluster is empty."""
    for vec in {1, 4 if min(512, N) % 4 == 0 else 1}:
        geo = qc.qc_geometry(M, N, H100_SMS, vec)
        cluster, rows, threads = geo
        assert 1 <= cluster <= qc.CLUSTER_MAX
        assert threads % 32 == 0 and 32 <= threads <= qc.QC_MAX_THREADS
        assert (cluster - 1) * rows < min(128, M) <= cluster * rows
        hits = np.zeros(M * N, np.int64)
        owner = np.full(M * N, -1)
        for tile, _, idx, ok in _qc_walk(M, N, geo, vec):
            np.add.at(hits, idx[ok], 1)
            owner[idx[ok]] = tile
        assert (hits == 1).all()
        bm, bn = min(128, M), min(512, N)
        want = (np.arange(M)[:, None] // bm * (N // bn)
                + np.arange(N)[None, :] // bn)
        np.testing.assert_array_equal(owner.reshape(M, N), want)


def test_qc_geometry_spreads_the_model_over_clusters():
    """The model's [256, 512] (2 tiles) runs as 2 clusters of 16 CTAs (the
    one-CTA kernel: 2 CTAs); many tiles take the smallest cluster that
    holds a tile in registers (8 at [1024, 2048]), and a tile with fewer
    rows than that a CTA a row."""
    assert qc.qc_geometry(256, 512, H100_SMS) == (16, 8, 512)
    assert qc.qc_geometry(1024, 2048, H100_SMS) == (8, 16, 512)
    assert qc.qc_geometry(3, 260, H100_SMS) == (3, 1, 96)
    assert qc.qc_geometry(1, 4, H100_SMS) == (1, 1, 32)


def test_qc_geometry_raises_outside_the_kernel():
    with pytest.raises(ValueError, match="whole"):
        qc.qc_geometry(200, 512, H100_SMS)
    with pytest.raises(ValueError, match="whole"):
        qc.qc_geometry(128, 700, H100_SMS)
    with pytest.raises(ValueError, match="width"):
        qc.qc_geometry(128, 258, H100_SMS, vec=4)
    with pytest.raises(ValueError, match="width"):
        qc.qc_geometry(128, 512, H100_SMS, vec=2)
    with pytest.raises(ValueError, match="empty"):
        qc.qc_geometry(0, 512, H100_SMS)


def _wire_np(x, rand, scale, thresh, bits):
    """quant_channel.cu's wire_elem with the scalar scale and threshold,
    in numpy (uint32 codewords, the int32 wrap as the kernel takes it)."""
    qm = (1 << (bits - 1)) - 1
    fqm = np.float32(qm)
    with np.errstate(divide="ignore", invalid="ignore"):
        r = np.rint(x / scale)
    r = np.minimum(np.maximum(r, -fqm), fqm)
    code = ((r.astype(np.int64) + qm) & 0xFFFFFFFF).astype(np.uint32)
    code ^= _kernel_flip_masks(rand, bits, thresh)
    q_hat = ((code.astype(np.int64) - qm) & 0xFFFFFFFF).astype(np.uint32) \
        .view(np.int32)
    q_hat = np.clip(q_hat, -qm, qm)
    with np.errstate(invalid="ignore"):
        return q_hat.astype(np.float32) * scale


@pytest.mark.parametrize("bits", [1, 8, 16, 31])
@pytest.mark.parametrize("M,N", [(1, 4), (3, 260), (128, 512), (256, 1024)])
def test_qc_cluster_amax_matches_jax_kernel(M, N, bits):
    """K5's mirror: each CTA's amax over the elements it loads, the
    tile's as the max over its cluster's CTAs, then the wire math with
    the scalar p, bit for bit against the Pallas `quant_channel_2d`
    (interpret mode). At 1 bit qm = 0 and every output is NaN on both
    sides (NaNs compare equal)."""
    rng = np.random.default_rng(M + N + bits)
    x = (rng.standard_normal((M, N))
         * rng.uniform(0.1, 9.0, (M, 1))).astype(np.float32)
    rand = rng.integers(0, 2 ** 32, (M, N), dtype=np.uint64) \
        .astype(np.uint32)
    p = np.float32(0.08)
    want = np.asarray(j_qc(jnp.asarray(x), jnp.asarray(rand),
                           jnp.asarray([p]), bits, interpret=True))
    geo = qc.qc_geometry(M, N, H100_SMS)
    flat_x = np.abs(x).reshape(-1)
    cta_max = {}
    for tile, rank, idx, ok in _qc_walk(M, N, geo, 4):
        m = flat_x[idx[ok]].max(initial=np.float32(0))
        cta_max[tile, rank] = max(cta_max.get((tile, rank), np.float32(0)),
                                  m)
    qm = (1 << (bits - 1)) - 1
    with np.errstate(divide="ignore"):
        recip = np.float32(1.0) / np.float32(qm)
    thresh = np.uint64(p * np.float32(2 ** 32))
    got = np.zeros(M * N, np.float32)
    bm, bn = min(128, M), min(512, N)
    tiles = {}
    for tile, rank, idx, ok in _qc_walk(M, N, geo, 4):
        tiles.setdefault(tile, []).append(idx[ok])
    for tile, parts in tiles.items():
        amax = max(cta_max[tile, r] for r in range(geo[0]))
        with np.errstate(invalid="ignore", over="ignore"):
            scale = np.float32(max(amax, np.float32(1e-12))) * recip
        idx = np.concatenate(parts)
        got[idx] = _wire_np(x.reshape(-1)[idx], rand.reshape(-1)[idx],
                            scale, thresh, bits)
    np.testing.assert_array_equal(got.reshape(M, N), want)
