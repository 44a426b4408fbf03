"""The port's CUDA kernels on the card, each against its plain version,
and the engine through them. Every test here is marked `cuda` and skips
without a card; the file imports no JAX, so on the card it runs as

    python -m pytest -m cuda tests/test_torch_cuda.py

f32 tolerance 2e-4 (the JAX suite's attention tolerance); bf16 2e-2,
because the plain version rounds its logits and its output to bf16
(each ~2^-8 relative) where the kernel keeps them in f32."""
import numpy as np
import pytest
import torch

from _torch_parity import attn_fixture, cuda_device  # noqa: F401
from _torch_parity import check_adamw_in_place, paged_from_dense
from repro_torch.kernels.decode_attention import ops as dec
from repro_torch.kernels.decode_attention import ref as dec_ref
from repro_torch.kernels.prefill_attention import ops as pre
from repro_torch.kernels.prefill_attention import ref as pre_ref

pytestmark = pytest.mark.cuda
TOL = {torch.float32: 2e-4, torch.bfloat16: 2e-2}
KINDS = ["decode", "paged_decode", "prefill", "paged_prefill"]


def _case(kind, g, window, dtype, dev):
    """(kernel call, plain call) for one kernel on seeded inputs."""
    c = None if "decode" in kind else 8
    q, k, v = attn_fixture(7, 4, 2, g, 64, 64, c=c)
    lens = np.array([1, 17, 40, 64 - (c or 0)], np.int32)
    kp, vp, tables, spare = paged_from_dense(k, v, 16, 8)
    for bi, ln in enumerate(lens):
        tables[bi, -(-(ln + (c or 0)) // 16):] = spare
    t = {n: torch.from_numpy(a).to(dev) for n, a in dict(
        q=q, k=k, v=v, kp=kp, vp=vp, tables=tables, lens=lens).items()}
    for n in ("q", "k", "v", "kp", "vp"):
        t[n] = t[n].to(dtype)
    args = {"decode": (dec.gqa_decode, dec_ref.decode_attention_ref,
                       ("q", "k", "v", "lens")),
            "paged_decode": (dec.gqa_decode_paged,
                             dec_ref.paged_decode_attention_ref,
                             ("q", "kp", "vp", "tables", "lens")),
            "prefill": (pre.gqa_prefill, pre_ref.prefill_attention_ref,
                        ("q", "k", "v", "lens")),
            "paged_prefill": (pre.gqa_prefill_paged,
                              pre_ref.paged_prefill_attention_ref,
                              ("q", "kp", "vp", "tables", "lens"))}[kind]
    fn, plain, names = args
    xs = [t[n] for n in names]
    return (lambda: fn(*xs, window=window),
            lambda: plain(*xs, window=window).float())


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("g,window,dtype", [
    (1, 0, torch.float32), (4, 24, torch.float32), (1, 0, torch.bfloat16),
    (4, 24, torch.bfloat16)])
def test_kernel_matches_plain(kind, g, window, dtype, cuda_device):
    fn = {"decode": dec.gqa_decode, "paged_decode": dec.gqa_decode_paged,
          "prefill": pre.gqa_prefill,
          "paged_prefill": pre.gqa_prefill_paged}[kind]
    run, plain = _case(kind, g, window, dtype, cuda_device)
    before = fn.launches
    got = run()
    torch.cuda.synchronize()
    assert got.dtype == torch.float32 and got.is_cuda
    assert fn.launches == before + 1
    torch.testing.assert_close(got, plain(), rtol=TOL[dtype],
                               atol=TOL[dtype])


# ragged rows of the redesigned dense kernels (K7 split-KV decode, K9
# tensor-core prefill): lengths / chunk starts 0, 1, 31, 32, 33 and the
# last; S not a multiple of the 64-column tile
RAGGED_S = 100


def _dense_case(kind, g, c, window, dtype, dev, seed=0):
    b, hkv = 6, 2
    q, k, v = attn_fixture(seed, b, hkv, g, RAGGED_S, 64,
                           c=None if kind == "decode" else c)
    last = RAGGED_S if kind == "decode" else RAGGED_S - c
    rows = torch.tensor([0, 1, 31, 32, 33, last], dtype=torch.int32,
                        device=dev)
    q, k, v = (torch.from_numpy(a).to(dev, dtype) for a in (q, k, v))
    fn, plain = ((dec.gqa_decode, dec_ref.decode_attention_ref)
                 if kind == "decode"
                 else (pre.gqa_prefill, pre_ref.prefill_attention_ref))
    return (lambda: fn(q, k, v, rows, window=window),
            lambda: plain(q, k, v, rows, window=window).float(), rows)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("window", [0, 48])
@pytest.mark.parametrize("g", [1, 2, 4, 8])
def test_split_decode_matches_plain_at_ragged_lengths(g, window, dtype,
                                                      cuda_device):
    """K7 against its plain version at lengths 0/1/31/32/33/S; a row of
    length 0 is 0 (the plain version averages V there)."""
    run, plain, rows = _dense_case("decode", g, None, window, dtype,
                                   cuda_device)
    before = dec.gqa_decode.launches
    got = run()
    torch.cuda.synchronize()
    assert dec.gqa_decode.launches == before + 1
    live = rows > 0
    assert torch.all(got[~live] == 0)
    torch.testing.assert_close(got[live], plain()[live], rtol=TOL[dtype],
                               atol=TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("window", [0, 48])
@pytest.mark.parametrize("g", [1, 4, 8])
@pytest.mark.parametrize("c", [1, 4, 17, 32])
def test_mma_prefill_matches_plain_at_ragged_starts(c, g, window, dtype,
                                                    cuda_device):
    """K9 against its plain version with chunks starting at 0/1/31/32/33
    and ending at S."""
    run, plain, _ = _dense_case("prefill", g, c, window, dtype, cuda_device)
    before = pre.gqa_prefill.launches
    got = run()
    torch.cuda.synchronize()
    assert pre.gqa_prefill.launches == before + 1
    torch.testing.assert_close(got, plain(), rtol=TOL[dtype],
                               atol=TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("kind", ["decode", "prefill"])
def test_dense_kernels_are_bitwise_deterministic(kind, dtype, cuda_device):
    """Two calls on the same inputs give the same bits (no float atomics;
    the split partials merge in a fixed order). The serving shape: 8
    slots, 16 KV heads, S 272, chunk 32."""
    rng = np.random.default_rng(5)
    c = None if kind == "decode" else 32
    qshape = (8, 16, 64) if c is None else (8, c, 16, 64)
    q, k, v = (torch.from_numpy(rng.standard_normal(sh).astype(
        np.float32)).to(cuda_device, dtype)
        for sh in (qshape, (8, 16, 272, 64), (8, 16, 272, 64)))
    if c is None:
        rows = torch.from_numpy(rng.integers(1, 273, 8).astype(np.int32))
        fn = dec.gqa_decode
    else:
        rows = torch.from_numpy(rng.integers(0, 241, 8).astype(np.int32))
        fn = pre.gqa_prefill
    rows = rows.to(cuda_device)
    a, b = fn(q, k, v, rows), fn(q, k, v, rows)
    torch.cuda.synchronize()
    assert torch.equal(a, b)


# the paged kernels (K8 on K7's split-KV body, K10 on K9's tensor-core
# body, f32 prefill on flash_tile.cuh) against their dense twins on the
# same data: S = n_lp * page, lengths / chunk starts 0, 1, 15, 16, 17 and
# the last
PAGED_S = 96                     # 12 pages of 8, 6 of 16, 3 of 32


def _paged_dense_case(c, page, g, window, dtype, dev, seed=3, hd=64):
    """(paged call, dense call, paged plain call, rows, pool, tables) on
    one seeded dense cache and its shuffled pool; table entries past each
    row's pages point at the spare garbage page."""
    b, hkv = 6, 2
    q, k, v = attn_fixture(seed, b, hkv, g, PAGED_S, hd, c=c)
    last = PAGED_S if c is None else PAGED_S - c
    rows = np.array([0, 1, 15, 16, 17, last], np.int32)
    kp, vp, tables, spare = paged_from_dense(k, v, page, seed + 1)
    for bi, r in enumerate(rows.tolist()):
        tables[bi, -(-(r + (c or 0)) // page):] = spare
    q, k, v, kp, vp = (torch.from_numpy(a).to(dev, dtype)
                       for a in (q, k, v, kp, vp))
    rows, tables = (torch.from_numpy(a).to(dev) for a in (rows, tables))
    if c is None:
        fn, dense, plain = (dec.gqa_decode_paged, dec.gqa_decode,
                            dec_ref.paged_decode_attention_ref)
    else:
        fn, dense, plain = (pre.gqa_prefill_paged, pre.gqa_prefill,
                            pre_ref.paged_prefill_attention_ref)
    return (lambda t=tables: fn(q, kp, vp, t, rows, window=window),
            lambda: dense(q, k, v, rows, window=window),
            lambda t=tables: plain(q, kp, vp, t, rows,
                                   window=window).float(),
            rows, kp, tables)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("window", [0, 48])
@pytest.mark.parametrize("g", [1, 4, 8])
@pytest.mark.parametrize("page", [8, 16, 32])
@pytest.mark.parametrize("c", [None, 1, 4, 17, 32])
def test_paged_kernel_equals_dense_twin_bitwise(c, page, g, window, dtype,
                                                cuda_device):
    """K8 (c None) gives K7's bits and K10 gives K9's on the same data,
    the same bits on a second call, one launch a call, and agrees with
    its plain version (a decode row of length 0 is 0 in both kernels;
    the plain version averages V there)."""
    paged, dense, plain, rows, _, _ = _paged_dense_case(
        c, page, g, window, dtype, cuda_device)
    fn = dec.gqa_decode_paged if c is None else pre.gqa_prefill_paged
    before = fn.launches
    got, again, twin = paged(), paged(), dense()
    torch.cuda.synchronize()
    assert fn.launches == before + 2
    assert torch.equal(got, twin)
    assert torch.equal(got, again)
    live = rows > 0 if c is None else torch.ones_like(rows, dtype=bool)
    assert torch.all(got[~live] == 0)
    torch.testing.assert_close(got[live], plain()[live], rtol=TOL[dtype],
                               atol=TOL[dtype])


# K7-K10 at the head dims and GQA groups of the served configs: hd 128 at
# G 5 (llama4-scout-17b-a16e), 12 (command-r-plus-104b), 16
# (chatglm3-6b) and 8 (internvl2-76b), hd 64 at G 16
# (qwen3-moe-235b-a22b), hd 160 at G 4 (stablelm-12b: a column of 20
# bf16 or 40 f32 16-byte chunks in decode, a padded 21-chunk row in the
# bf16 prefill, 16-column tiles in the f32 one). A G that is not a power
# of two leaves a partial head-group block in decode (G 5: blocks of 4
# and 1 rows) and a partial 16-row group in prefill (C*G = 17 * 5)
WIDE_HEADS = [(128, 5), (128, 12), (128, 16), (64, 16), (160, 4),
              (128, 8)]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("window", [0, 48])
@pytest.mark.parametrize("c", [None, 1, 17, 32])
@pytest.mark.parametrize("hd,g", WIDE_HEADS)
def test_wide_heads_match_plain_and_paged_equals_dense(hd, g, c, window,
                                                       dtype, cuda_device):
    """Each kernel at these shapes against its plain version, the paged
    kernel equal to its dense twin bit for bit, the same bits twice."""
    paged, dense, plain, rows, _, _ = _paged_dense_case(
        c, 16, g, window, dtype, cuda_device, seed=9, hd=hd)
    fn, twin_fn = ((dec.gqa_decode_paged, dec.gqa_decode) if c is None
                   else (pre.gqa_prefill_paged, pre.gqa_prefill))
    before, twin_before = fn.launches, twin_fn.launches
    got, again, twin, twin_again = paged(), paged(), dense(), dense()
    torch.cuda.synchronize()
    assert (fn.launches, twin_fn.launches) == (before + 2, twin_before + 2)
    assert got.shape[-1] == hd
    assert torch.equal(got, again) and torch.equal(twin, twin_again)
    assert torch.equal(got, twin)
    live = rows > 0 if c is None else torch.ones_like(rows, dtype=bool)
    assert torch.all(got[~live] == 0)
    torch.testing.assert_close(got[live], plain()[live], rtol=TOL[dtype],
                               atol=TOL[dtype])


# one slot whose dense cache length S is not a multiple of the page, as
# the engine lays out a short trace (dense S = the longest request, paged
# n_lp = ceil(S / page) pages): the paged kernel then sees n_lp * page > S
# columns, and where the split count's cap ceil(S / 32) binds (few slots
# x KV heads) the two layouts could sum a row in different orders
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("s,page", [(96, 24), (100, 24), (96, 48),
                                    (100, 48), (270, 16)])
@pytest.mark.parametrize("c", [None, 8])
def test_paged_equals_dense_where_the_page_does_not_divide_s(
        s, page, c, dtype, cuda_device):
    n_lp = -(-s // page)
    q, k, v = attn_fixture(5, 1, 2, 4, n_lp * page, 64, c=c)
    kp, vp, tables, _ = paged_from_dense(k, v, page, 6)
    t = {n: torch.from_numpy(np.ascontiguousarray(a)).to(cuda_device)
         for n, a in dict(q=q, k=k[:, :, :s], v=v[:, :, :s], kp=kp, vp=vp,
                          tables=tables).items()}
    for n in ("q", "k", "v", "kp", "vp"):
        t[n] = t[n].to(dtype)
    if c is None:
        fn, dense, plain = (dec.gqa_decode_paged, dec.gqa_decode,
                            dec_ref.decode_attention_ref)
    else:
        fn, dense, plain = (pre.gqa_prefill_paged, pre.gqa_prefill,
                            pre_ref.prefill_attention_ref)
    for n in (1, 33, s - (c or 0)):
        rows = torch.tensor([n], dtype=torch.int32, device=cuda_device)
        got = fn(t["q"], t["kp"], t["vp"], t["tables"], rows)
        twin = dense(t["q"], t["k"], t["v"], rows)
        assert torch.equal(got, twin), (s, page, n)
        torch.testing.assert_close(
            got, plain(t["q"], t["k"], t["v"], rows).float(),
            rtol=TOL[dtype], atol=TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("c", [None, 32])
def test_paged_kernel_clamps_page_ids(c, dtype, cuda_device):
    """Page ids outside the pool are clamped into it, never followed:
    out-of-range entries past a row's pages change no bit, and a row
    whose used pages are out of range reads the clamped pages, as the
    plain version over the clamped table does."""
    paged, _, plain, rows, kp, tables = _paged_dense_case(
        c, 16, 1, 0, dtype, cuda_device)
    want = paged()
    wild = tables.clone()
    for bi, r in enumerate(rows.tolist()):
        used = -(-(r + (c or 0)) // 16)
        wild[bi, used:] = torch.where(
            torch.arange(wild.shape[1] - used, device=cuda_device) % 2 == 0,
            -7, len(kp) + 100)
    got = paged(wild)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    wild[3, 0], wild[4, 1] = -1, 2 ** 31 - 1     # pages the rows use
    got = paged(wild)
    torch.cuda.synchronize()
    want = plain(wild.clamp(0, len(kp) - 1))
    live = rows > 0 if c is None else torch.ones_like(rows, dtype=bool)
    torch.testing.assert_close(got[live], want[live], rtol=TOL[dtype],
                               atol=TOL[dtype])


# K8 and K10 where a CTA's span holds more pages than one staging
# (build.STAGE_PAGES, kv_cols.cuh): the span is staged in segments cut on
# the loop's grid of steps. At pages of 1 and 3 a cache of a few ten
# thousand columns holds several segments a CTA (a decode split of the 8
# holds 2,500 pages, a prefill span up to 20,000), with and without a
# window that itself spans more than one staging
SEGMENT_S = {1: 20_000, 3: 60_000}


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("window", [0, 3_000])
@pytest.mark.parametrize("hd,g", [(64, 1), (64, 4), (160, 4)])
@pytest.mark.parametrize("page", sorted(SEGMENT_S))
@pytest.mark.parametrize("c", [None, 17, 64])
def test_paged_kernel_equals_dense_twin_across_staging_segments(
        c, page, hd, g, window, dtype, cuda_device):
    s, b, hkv = SEGMENT_S[page], 3, 2
    q, k, v = attn_fixture(11, b, hkv, g, s, hd, c=c)
    if c is None:
        rows = np.array([s, s - 1_234, 2 * 2048 * page + 5], np.int32)
    else:
        rows = np.array([s - c, s // 2 + 5, 0], np.int32)
    kp, vp, tables, spare = paged_from_dense(k, v, page, 12)
    for bi, r in enumerate(rows.tolist()):
        tables[bi, -(-(r + (c or 0)) // page):] = spare
    q, k, v, kp, vp = (torch.from_numpy(a).to(cuda_device, dtype)
                       for a in (q, k, v, kp, vp))
    rows, tables = (torch.from_numpy(a).to(cuda_device)
                    for a in (rows, tables))
    if c is None:
        fn, twin, plain = (dec.gqa_decode_paged, dec.gqa_decode,
                           dec_ref.paged_decode_attention_ref)
    else:
        fn, twin, plain = (pre.gqa_prefill_paged, pre.gqa_prefill,
                           pre_ref.paged_prefill_attention_ref)
    got = fn(q, kp, vp, tables, rows, window=window)
    again = fn(q, kp, vp, tables, rows, window=window)
    dense = twin(q, k, v, rows, window=window)
    torch.cuda.synchronize()
    assert torch.equal(got, dense)
    assert torch.equal(got, again)
    want = plain(*(a.float() if a.is_floating_point() else a
                   for a in (q, kp, vp, tables, rows)), window=window)
    torch.testing.assert_close(got, want.float(), rtol=TOL[dtype],
                               atol=TOL[dtype])


def test_idle_decode_row_is_zero(cuda_device):
    """A slot of length 0 attends nothing: the kernel returns 0 there
    (the engine discards the row)."""
    q, k, v = (torch.from_numpy(a).to(cuda_device)
               for a in attn_fixture(1, 2, 2, 1, 32, 64))
    out = dec.gqa_decode(q, k, v, torch.tensor([0, 5], dtype=torch.int32,
                                               device=cuda_device))
    assert torch.all(out[0] == 0)
    torch.testing.assert_close(
        out[1], dec_ref.decode_attention_ref(q, k, v, 5)[1], rtol=TOL[
            torch.float32], atol=TOL[torch.float32])


def test_wrappers_reject_what_the_kernels_do_not_take(cuda_device):
    q, k, v = (torch.from_numpy(a).to(cuda_device)
               for a in attn_fixture(2, 2, 2, 1, 32, 64))
    with pytest.raises(ValueError, match="dtype"):
        dec.gqa_decode(q.half(), k.half(), v.half(), 3)
    with pytest.raises(ValueError, match="contiguous"):
        dec.gqa_decode(q, k.transpose(2, 3).contiguous().transpose(2, 3),
                       v, 3)
    with pytest.raises(ValueError, match="head dim"):
        dec.gqa_decode(q[..., :32].contiguous(), k[..., :32].contiguous(),
                       v[..., :32].contiguous(), 3)


def test_engine_paged_equals_dense_on_card(cuda_device):
    """The reduced model serves one trace through the paged kernels and
    through the dense ones: the same tokens and bills, and each run
    launched its own pair of kernels once per layer and step."""
    from repro_torch.configs import get_arch
    from repro_torch.models import api as M
    from repro_torch.nn import init_params
    from repro_torch.schemes.radio import Radio
    from repro_torch.serve import ServeEngine, make_trace

    cfg = get_arch("qwen1.5-0.5b").reduced()
    params = init_params(M.param_specs(cfg), torch.Generator(
        device=cuda_device).manual_seed(0), cuda_device)
    trace = make_trace(2, 6, prompt_lens=(3, 40), new_tokens=(2, 6))
    fns = [dec.gqa_decode, dec.gqa_decode_paged, pre.gqa_prefill,
           pre.gqa_prefill_paged]
    reps = {}
    for kv in ("paged", "dense"):
        for f in fns:
            f.launches = 0
        reps[kv] = ServeEngine(cfg, params, n_slots=3, greedy=True, kv=kv,
                               radio=Radio(snr_db=10.0),
                               device=cuda_device).serve(trace)
        n = [f.launches for f in fns]
        on = (1, 3) if kv == "paged" else (0, 2)
        assert all(n[i] > 0 and n[i] % cfg.n_layers == 0 for i in on), n
        assert all(n[i] == 0 for i in range(4) if i not in on), n
    rows = [[(r.rid, r.tokens, r.bits, r.energy_j, r.n_tx)
             for r in rep.results] for rep in reps.values()]
    assert rows[0] == rows[1]


# ------------------------------------------------ the packed wire (K1-K6)
def _wire_case(rows, bits, seed, dev, cols=256):
    from repro_torch.kernels.quant_channel import ops as qc
    rng = np.random.default_rng(seed)
    buf = (rng.standard_normal((rows, cols))
           * rng.uniform(0.01, 3.0, (rows, 1))).astype(np.float32)
    rand = torch.from_numpy(rng.integers(0, 2 ** 32, (rows, cols),
                                         dtype=np.int64))
    amax = torch.from_numpy(np.abs(buf).max(axis=1, keepdims=True))
    from repro_torch.core import quantization as Q
    # at 1 bit qm = 0 and scale_from_amax divides by it (an infinite
    # scale, every output NaN on both sides); the scale of 2 bits keeps
    # the outputs finite (all 0: qm = 0 clips every code), so that
    # torch.equal compares values
    scale = Q.scale_from_amax(amax, max(bits, 2))
    p = torch.from_numpy(rng.uniform(0, 0.2, (rows, 1)).astype(np.float32))
    t = dict(buf=torch.from_numpy(buf), rand=rand, scale=scale, p=p)
    return {k: v.to(dev) for k, v in t.items()}, qc


@pytest.mark.parametrize("wire_dtype,bits", [("float32", 8),
                                             ("float32", 16),
                                             ("int8", 8), ("int4", 4),
                                             ("float32", 32)])
@pytest.mark.parametrize("rows", [224, 1080])
def test_packed_wire_kernel_equals_plain(wire_dtype, bits, rows,
                                         cuda_device):
    """K1 in each code width at the SL leg and FL upload shapes:
    bit-exact against its plain version on the same device."""
    from repro_torch.kernels.quant_channel import ref as qref
    t, qc = _wire_case(rows, bits, rows + bits, cuda_device)
    got = qc.packed_wire_2d(t["buf"], t["rand"], t["scale"], t["p"], bits,
                            wire_dtype=wire_dtype)
    want = qref.packed_wire_ref(t["buf"], t["rand"], t["scale"], t["p"],
                                bits, wire_dtype)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert not torch.equal(got, t["buf"])


# ragged rows and column widths around the kernels' 2-D grid (one CTA
# row of 64 vectors, rows per CTA chosen from the shape), every bit count
# at the ends of each code width
WIRE_ROWS = [1, 3, 225, 1081]
WIRE_COLS = [4, 256, 260]
WIRE_BITS = [("float32", b) for b in (1, 8, 16, 31)] + \
    [("int8", b) for b in range(1, 9)] + [("float32", 32)]


@pytest.mark.parametrize("wire_dtype,bits", WIRE_BITS)
@pytest.mark.parametrize("cols", WIRE_COLS)
@pytest.mark.parametrize("rows", WIRE_ROWS)
def test_packed_wire_kernels_equal_plain_at_ragged_shapes(rows, cols,
                                                          wire_dtype, bits,
                                                          cuda_device):
    """K1, K2 (3 users) and K6 bit for bit against their plain versions
    at ragged rows and widths, at every bits' end of both code widths."""
    from repro_torch.kernels.quant_channel import ref as qref
    t, qc = _wire_case(3 * rows, bits, rows + cols + bits, cuda_device,
                       cols)
    one = {k: v[:rows].contiguous() for k, v in t.items()}
    got = qc.packed_wire_2d(one["buf"], one["rand"], one["scale"], one["p"],
                            bits, wire_dtype=wire_dtype)
    assert torch.equal(got, qref.packed_wire_ref(
        one["buf"], one["rand"], one["scale"], one["p"], bits, wire_dtype))
    w = torch.tensor([0.25, 0.5, 0.25], device=cuda_device) \
        .repeat_interleave(rows)[:, None].contiguous()
    got = qc.packed_wire_mean_2d(t["buf"], t["rand"], t["scale"], t["p"], w,
                                 bits, 3, wire_dtype=wire_dtype)
    assert torch.equal(got, qref.packed_wire_mean_ref(
        t["buf"], t["rand"], t["scale"], t["p"], w, bits, 3, wire_dtype))
    got = qc.packed_wire_2d_philox(one["buf"], one["scale"], one["p"], bits,
                                   seed=rows + bits, wire_dtype=wire_dtype)
    assert torch.equal(got, qref.packed_wire_philox_ref(
        one["buf"], one["scale"], one["p"], bits, rows + bits, wire_dtype))


@pytest.mark.parametrize("bits", [1, 8, 16, 31, 32])
@pytest.mark.parametrize("m,n", [(1, 4), (3, 260), (128, 512), (256, 1024)])
def test_quant_channel_kernel_equals_plain_at_ragged_tiles(m, n, bits,
                                                           cuda_device):
    """K5 bit for bit against its plain version on whole and partial
    tiles (min(128, M) x min(512, N)), at each end of the bit range. At
    1 bit qm = 0: K5's tile scale amax / qm is infinite and every output
    NaN, in JAX's quant_channel as in both versions here, so NaNs count
    as equal."""
    from repro_torch.kernels.quant_channel import ops as qc
    from repro_torch.kernels.quant_channel import ref as qref
    rng = np.random.default_rng(m + n + bits)
    x = torch.from_numpy(rng.standard_normal((m, n)).astype(np.float32)) \
        .to(cuda_device)
    rand = torch.from_numpy(rng.integers(0, 2 ** 32, (m, n),
                                         dtype=np.int64)).to(cuda_device)
    p = torch.tensor([0.08], device=cuda_device)
    torch.testing.assert_close(qc.quant_channel_2d(x, rand, p, bits),
                               qref.quant_channel_ref(x, rand, p, bits),
                               rtol=0, atol=0, equal_nan=True)


# K5's cluster design, with the cluster qc_geometry picks: many tiles
# (8 CTAs), a tile with fewer rows than the cluster (a CTA a row), widths
# that are no multiple of 4 (one word a load), and an x that starts off a
# 16-byte boundary (one word a load too, 16 CTAs)
QC_CLUSTER_SHAPES = [(1024, 2048, 0, 8), (3, 260, 0, 3), (5, 259, 0, 5),
                     (128, 37, 0, 16), (256, 512, 1, 16), (64, 512, 0, 16)]


@pytest.mark.parametrize("bits", [1, 8, 16, 31, 32])
@pytest.mark.parametrize("m,n,offset,cluster", QC_CLUSTER_SHAPES)
def test_quant_channel_clusters_equal_plain(m, n, offset, cluster, bits,
                                            cuda_device):
    """K5 bit for bit against its plain version and the same bits twice,
    at clusters of 3 to 16 CTAs (NaNs equal at 1 bit, as above)."""
    from repro_torch.kernels.quant_channel import ops as qc
    from repro_torch.kernels.quant_channel import ref as qref
    rng = np.random.default_rng(m + n + bits + offset)
    x = torch.from_numpy((rng.standard_normal(m * n + offset)
                          * 3.0).astype(np.float32)).to(cuda_device)
    x = x[offset:].view(m, n)
    rand = qc.words_u32(torch.from_numpy(rng.integers(
        0, 2 ** 32, (m, n), dtype=np.int64)), cuda_device)
    p = torch.tensor([0.08], device=cuda_device)
    vec = 4 if n % 4 == 0 and offset == 0 else 1
    assert qc.qc_geometry(m, n, qc.build.sm_count(x.device.index),
                          vec)[0] == cluster
    got = qc.quant_channel_2d(x, rand, p, bits)
    again = qc.quant_channel_2d(x, rand, p, bits)
    torch.testing.assert_close(got, qref.quant_channel_ref(x, rand, p, bits),
                               rtol=0, atol=0, equal_nan=True)
    torch.testing.assert_close(got, again, rtol=0, atol=0, equal_nan=True)


def test_packed_wire_mean_kernel_equals_plain(cuda_device):
    """K2 at the FL upload's [3 x 360, 256], one user weighted out."""
    from repro_torch.kernels.quant_channel import ref as qref
    t, qc = _wire_case(1080, 8, 5, cuda_device)
    w = torch.tensor([0.5, 0.0, 0.5], device=cuda_device) \
        .repeat_interleave(360)[:, None].contiguous()
    got = qc.packed_wire_mean_2d(t["buf"], t["rand"], t["scale"], t["p"], w,
                                 8, 3)
    want = qref.packed_wire_mean_ref(t["buf"], t["rand"], t["scale"],
                                     t["p"], w, 8, 3)
    assert torch.equal(got, want)


def test_quant_channel_kernel_equals_plain(cuda_device):
    """K5 through `ops.transmit` of an 89,673-element vector."""
    from repro_torch.core.draws import Key
    from repro_torch.kernels.quant_channel import ops as qc
    from repro_torch.kernels.quant_channel import ref as qref
    x = torch.from_numpy(np.random.default_rng(6).standard_normal(
        (256, 512)).astype(np.float32)).to(cuda_device)
    rand = torch.from_numpy(np.random.default_rng(7).integers(
        0, 2 ** 32, (256, 512), dtype=np.int64)).to(cuda_device)
    p = torch.tensor([0.04], device=cuda_device)
    assert torch.equal(qc.quant_channel_2d(x, rand, p, 8),
                       qref.quant_channel_ref(x, rand, p, 8))
    v = torch.from_numpy(np.random.default_rng(8).standard_normal(
        89_673).astype(np.float32))
    on_card = qc.transmit(Key(1).draws(), v.to(cuda_device), 8, 10.0)
    on_cpu = qc.transmit(Key(1).draws(), v, 8, 10.0)
    assert torch.equal(on_card.cpu(), on_cpu)


def test_kernel_rng_flip_share(cuda_device):
    """K6: with x = 0 and p = 0.05 at Q8, the share of changed outputs is
    1 - (1 - p)^8 within 0.02; it equals its plain Philox version and
    differs from the host-word stream."""
    from repro_torch.kernels.quant_channel import ops as qc
    from repro_torch.kernels.quant_channel import ref as qref
    rows = 1080
    buf = torch.zeros((rows, 256), device=cuda_device)
    scale = torch.ones((rows, 1), device=cuda_device)
    p = torch.full((rows, 1), 0.05, device=cuda_device)
    got = qc.packed_wire_2d_philox(buf, scale, p, 8, seed=1234)
    share = float((got != 0).float().mean())
    assert abs(share - (1 - 0.95 ** 8)) < 0.02
    assert torch.equal(got, qref.packed_wire_philox_ref(buf, scale, p, 8,
                                                        1234))
    rand = torch.randint(0, 2 ** 32, (rows, 256), dtype=torch.int64,
                         generator=torch.Generator().manual_seed(0))
    host = qc.packed_wire_2d(buf, rand.to(cuda_device), scale, p, 8)
    assert not torch.equal(got, host)


def test_fl_cycle_bills_on_card_equal_cpu(cuda_device):
    """One FL cycle (reduced corpus) on the card and on the CPU: the same
    draw stream gives identical bills, one K1 launch for the sync, and
    nearly the same weights: sums in another order move a weight by
    ulps, which can move a few synced weights across a quantization
    rounding boundary (one level); all others agree within 1e-4."""
    from repro_torch.configs import WirelessConfig
    from repro_torch.kernels.quant_channel import ops as qc
    from repro_torch.schemes import Experiment, build_scheme
    runs = {}
    for dev in (cuda_device, "cpu"):
        qc.packed_wire_2d.launches = 0
        scheme = build_scheme(WirelessConfig(mode="fl", quant_bits=8),
                              device=dev)
        exp = Experiment(scheme, cycles=1, seed=0, n_train=1536,
                         n_test=256)
        res = exp.run()
        runs[str(dev)] = (exp, res, qc.packed_wire_2d.launches)
    (ec, rc, lc), (eh, rh, lh) = runs["cuda"], runs["cpu"]
    assert lc == 1 and lh == 0
    assert rc.total_bits == rh.total_bits == 717_384.0
    assert [r.n_tx for r in ec.reports] == [r.n_tx for r in eh.reports]
    wc = ec.final_state.train.trainable["model"]
    wh = eh.final_state.train.trainable["model"]
    from repro_torch.nn import tree_leaves
    far = sum(int(((a.cpu() - b).abs() > 1e-4).sum())
              for a, b in zip(tree_leaves(wc), tree_leaves(wh)))
    assert far <= 16


def test_wire_routes_to_kernel_rng_behind_its_flag(cuda_device,
                                                   monkeypatch):
    """With `DEVICE_KERNEL_RNG` on, a send on the card launches K6 (and
    not K1) and draws no host words; the bill is unchanged."""
    from repro_torch.core import wire as W
    from repro_torch.core.draws import Key
    from repro_torch.kernels.quant_channel import ops as qc
    x = torch.randn((512, 14, 8), generator=torch.Generator().manual_seed(0))
    k1, k6 = qc.packed_wire_2d.launches, qc.packed_wire_2d_philox.launches
    off, d_off = W.transmit_tree(Key(4).draws(), x.to(cuda_device), 8, 10.0,
                                 return_diag=True)
    monkeypatch.setattr(qc, "DEVICE_KERNEL_RNG", True)
    on, d_on = W.transmit_tree(Key(4).draws(), x.to(cuda_device), 8, 10.0,
                               return_diag=True)
    assert qc.packed_wire_2d.launches == k1 + 1
    assert qc.packed_wire_2d_philox.launches == k6 + 1
    assert torch.equal(d_on["n_tx"], d_off["n_tx"])
    assert torch.isfinite(on).all() and not torch.equal(on, off)


# ------------------------------------- the tiny model's kernels (K3, K4)
# 2e-5 abs/rel: the JAX suite's tolerance for both kernels
# (tests/test_kernels.py); kernel and plain version sum their float32
# products in another order.
TINY_TOL = 2e-5


@pytest.mark.parametrize("b,t,e,f", [(2048, 30, 8, 32), (512, 30, 8, 32),
                                     (1, 30, 8, 32), (7, 29, 8, 32),
                                     (5, 64, 16, 64), (3, 10, 8, 32)])
def test_conv_pool_kernel_equals_plain(b, t, e, f, cuda_device):
    from repro_torch.kernels.conv_pool import ops, ref
    rng = np.random.default_rng(b + t)
    x = torch.from_numpy(rng.standard_normal((b, t, e)).astype(np.float32))
    w = torch.from_numpy((rng.standard_normal((3, e, f)) * 0.2)
                         .astype(np.float32))
    bias = torch.from_numpy((rng.standard_normal(f) * 0.1)
                            .astype(np.float32))
    x, w, bias = (a.to(cuda_device) for a in (x, w, bias))
    n0 = ops.user_conv_pool.launches
    got = ops.user_conv_pool(x, w, bias)
    torch.cuda.synchronize()
    assert ops.user_conv_pool.launches == n0 + 1
    assert got.shape == (b, (t - 2) // 2, f)
    torch.testing.assert_close(got, ref.conv_pool_ref(x, w, bias),
                               rtol=TINY_TOL, atol=TINY_TOL)


# (B, T, E, K, F) across each edge of the kernel's launch geometry: one
# span per row (B 2048), several (B 512, 64, 7), single positions (B 1),
# spans cut to fit shared memory (T 200, E 16, K 5), several filter
# groups with idle lanes (F 16, 48, 96), every E instance, K 1 / 3 / 5,
# odd and even T (a dropped last conv position)
K3_GRID = [(2048, 30, 8, 3, 32), (512, 30, 8, 3, 32), (1, 30, 8, 3, 32),
           (2, 30, 4, 1, 16), (7, 29, 16, 5, 48), (64, 31, 8, 5, 96),
           (512, 30, 16, 3, 64), (100, 12, 4, 3, 32), (1, 6, 8, 5, 96),
           (3, 7, 16, 1, 16), (2048, 29, 4, 5, 48), (33, 64, 16, 3, 96),
           (2112, 200, 16, 5, 32)]


@pytest.mark.parametrize("b,t,e,k,f", K3_GRID)
def test_conv_pool_kernel_across_its_geometry(b, t, e, k, f, cuda_device):
    """K3 within 2e-5 of its plain version and bit-identical from one
    run to the next, at every E instance, K 1 / 3 / 5, F with idle
    lanes, odd and even T, B 1-2048."""
    from repro_torch.kernels.conv_pool import ops, ref
    rng = np.random.default_rng(b + t + e + k + f)
    x = torch.from_numpy(rng.standard_normal((b, t, e)).astype(np.float32))
    w = torch.from_numpy((rng.standard_normal((k, e, f)) / np.sqrt(e))
                         .astype(np.float32))
    bias = torch.from_numpy((rng.standard_normal(f) * 0.1)
                            .astype(np.float32))
    x, w, bias = (a.to(cuda_device) for a in (x, w, bias))
    got = ops.user_conv_pool(x, w, bias)
    again = ops.user_conv_pool(x, w, bias)
    torch.cuda.synchronize()
    assert got.shape == (b, (t - k + 1) // 2, f)
    assert torch.equal(got, again)
    torch.testing.assert_close(got, ref.conv_pool_ref(x, w, bias),
                               rtol=TINY_TOL, atol=TINY_TOL)


@pytest.mark.parametrize("b,t,h", [(2048, 14, 32), (512, 14, 32),
                                   (1, 14, 32), (7, 30, 32), (4, 1, 32),
                                   (16, 7, 8)])
def test_lstm_kernel_equals_plain(b, t, h, cuda_device):
    from repro_torch.kernels.lstm_cell import ops, ref
    rng = np.random.default_rng(b + t + h)
    xw = torch.from_numpy(rng.standard_normal((b, t, 4 * h))
                          .astype(np.float32)).to(cuda_device)
    wh = torch.from_numpy((rng.standard_normal((h, 4 * h)) * 0.1)
                          .astype(np.float32)).to(cuda_device)
    n0 = ops.lstm_final_state.launches
    h_k, c_k = ops.lstm_final_state(xw, wh)
    torch.cuda.synchronize()
    assert ops.lstm_final_state.launches == n0 + 1
    h_r, c_r = ref.lstm_final_state_ref(xw, wh)
    torch.testing.assert_close(h_k, h_r, rtol=TINY_TOL, atol=TINY_TOL)
    torch.testing.assert_close(c_k, c_r, rtol=TINY_TOL, atol=TINY_TOL)


@pytest.mark.parametrize("h", [8, 16, 24, 32, 48])
@pytest.mark.parametrize("b,t", [(1, 30), (7, 1), (33, 14), (300, 30)])
def test_lstm_kernel_bodies_at_ragged_shapes(b, t, h, cuda_device):
    """K4's register body (H <= 32, two rows a lane) and its
    shared-memory body (H 48) at ragged B and T: within 2e-5 of the
    plain version, the same bits on a second call, one launch each."""
    from repro_torch.kernels.lstm_cell import ops, ref
    rng = np.random.default_rng(b * t + h)
    xw = torch.from_numpy(rng.standard_normal((b, t, 4 * h))
                          .astype(np.float32)).to(cuda_device)
    wh = torch.from_numpy((rng.standard_normal((h, 4 * h)) / np.sqrt(h))
                          .astype(np.float32)).to(cuda_device)
    n0 = ops.lstm_final_state.launches
    h_k, c_k = ops.lstm_final_state(xw, wh)
    h_2, c_2 = ops.lstm_final_state(xw, wh)
    torch.cuda.synchronize()
    assert ops.lstm_final_state.launches == n0 + 2
    assert torch.equal(h_k, h_2) and torch.equal(c_k, c_2)
    h_r, c_r = ref.lstm_final_state_ref(xw, wh)
    torch.testing.assert_close(h_k, h_r, rtol=TINY_TOL, atol=TINY_TOL)
    torch.testing.assert_close(c_k, c_r, rtol=TINY_TOL, atol=TINY_TOL)


def test_lstm_register_body_row_bits_do_not_depend_on_its_slot(cuda_device):
    """A row's bits do not depend on its place in the warp: the eval
    slice's rows, run as a batch and each in a batch of one (the row
    alone in its warp), agree."""
    from repro_torch.kernels.lstm_cell import ops
    rng = np.random.default_rng(11)
    xw = torch.from_numpy(rng.standard_normal((2048, 14, 128))
                          .astype(np.float32)).to(cuda_device)
    wh = torch.from_numpy((rng.standard_normal((32, 128)) / np.sqrt(32))
                          .astype(np.float32)).to(cuda_device)
    h_all, c_all = ops.lstm_final_state(xw, wh)
    for r in (0, 1, 2, 3, 777, 2047):
        h_1, c_1 = ops.lstm_final_state(xw[r:r + 1].contiguous(), wh)
        assert torch.equal(h_1[0], h_all[r]) and torch.equal(c_1[0], c_all[r])


def test_tiny_wrappers_reject_what_the_kernels_do_not_take(cuda_device):
    from repro_torch.kernels.conv_pool import ops as cp
    from repro_torch.kernels.lstm_cell import ops as lc
    x = torch.zeros((4, 30, 8), device=cuda_device)
    w = torch.zeros((3, 8, 32), device=cuda_device)
    b = torch.zeros(32, device=cuda_device)
    with pytest.raises(ValueError, match="float32"):
        cp.user_conv_pool(x.double(), w.double(), b.double())
    with pytest.raises(ValueError, match="registers"):
        cp.user_conv_pool(torch.zeros((4, 30, 512), device=cuda_device),
                          torch.zeros((9, 512, 32), device=cuda_device), b)
    with pytest.raises(ValueError, match="aligned"):
        cp.user_conv_pool(torch.zeros(4 * 30 * 8 + 1, device=cuda_device)
                          [1:].reshape(4, 30, 8), w, b)
    with pytest.raises(ValueError, match="contiguous"):
        cp.user_conv_pool(x.transpose(0, 1).contiguous().transpose(0, 1),
                          w, b)
    with pytest.raises(ValueError, match="no output"):
        cp.user_conv_pool(x[:, :3].contiguous(), w, b)
    xw = torch.zeros((4, 14, 128), device=cuda_device)
    wh = torch.zeros((32, 128), device=cuda_device)
    with pytest.raises(ValueError, match="float32"):
        lc.lstm_final_state(xw.half(), wh.half())
    with pytest.raises(ValueError, match="shared memory"):
        lc.lstm_final_state(torch.zeros((4, 14, 512), device=cuda_device),
                            torch.zeros((128, 512), device=cuda_device))
    with pytest.raises(ValueError, match="4H"):
        lc.lstm_final_state(xw, torch.zeros((32, 96), device=cuda_device))


def test_tiny_forward_runs_the_kernels_only_without_grad(cuda_device):
    """A no-grad forward of the paper model on the card launches K3 once
    and K4 once and agrees with the plain forward within 2e-5; a forward
    under autograd (training) launches neither."""
    from repro_torch.configs import get_arch
    from repro_torch.kernels.conv_pool import ops as cp
    from repro_torch.kernels.lstm_cell import ops as lc
    from repro_torch.models import lstm_tiny as LT
    from repro_torch.nn import init_tree
    params = init_tree(LT.model_specs(get_arch("paper-tinylstm")),
                       torch.Generator().manual_seed(0), cuda_device)
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        1, 10_000, (64, 30)).astype(np.int32)).to(cuda_device)
    n3, n4 = cp.user_conv_pool.launches, lc.lstm_final_state.launches
    with torch.no_grad():
        fast, _ = LT.forward(params, {"tokens": tokens})
    assert (cp.user_conv_pool.launches, lc.lstm_final_state.launches) == \
        (n3 + 1, n4 + 1)
    from repro_torch.nn import tree_map
    trainable = tree_map(lambda p: p.detach().requires_grad_(), params)
    plain, _ = LT.forward(trainable, {"tokens": tokens})
    assert plain.grad_fn is not None
    assert (cp.user_conv_pool.launches, lc.lstm_final_state.launches) == \
        (n3 + 1, n4 + 1)
    torch.testing.assert_close(fast, plain.detach(), rtol=TINY_TOL,
                               atol=TINY_TOL)


# ------------------------------------------------ fleets and resume
def _mixed_population(dev, **kw):
    from repro_torch.configs import WirelessConfig
    from repro_torch.schemes import ClientSpec, PopulationScheme
    base = WirelessConfig(mode="fl", quant_bits=8)
    return PopulationScheme(None, [
        ClientSpec.fl(base, snr_db=20.0), ClientSpec.fl(base, snr_db=6.0,
                                                         quant_bits=4),
        ClientSpec.sl(base, snr_db=12.0, quant_bits=16),
        ClientSpec.sl(base, snr_db=20.0)], device=dev, **kw)


def test_population_bills_on_card_equal_cpu(cuda_device):
    """A 4-client population (2 FL groups, 2 SL clients of 1 step each)
    for one cycle: the card bills exactly as the CPU, client by client,
    and its round launches K1 once per FL group and twice per SL step."""
    from repro_torch.kernels.quant_channel import ops as qc
    from repro_torch.schemes import Experiment
    exps = {}
    for dev in ("cuda", "cpu"):
        scheme = _mixed_population(dev)
        launches = []
        round_fn = scheme.round

        def counted(*a, round_fn=round_fn, launches=launches):
            n0 = qc.packed_wire_2d.launches
            out = round_fn(*a)
            launches.append(qc.packed_wire_2d.launches - n0)
            return out
        scheme.round = counted
        exps[dev] = Experiment(scheme, cycles=1, seed=0, n_train=2048,
                               n_test=256)
        exps[dev].run()
        exps[dev].launches = launches
    card, cpu = exps["cuda"], exps["cpu"]
    (rc,), (rh,) = card.reports, cpu.reports
    assert (rc.bits, rc.n_tx, rc.energy_j) == (rh.bits, rh.n_tx, rh.energy_j)
    assert rc.bits == 717_384 + 358_692 + 1_835_008 + 917_504
    for c, h in zip(rc.clients, rh.clients):
        assert (c.status, c.bits, c.n_tx, c.energy_j, c.weight, c.steps) \
            == (h.status, h.bits, h.n_tx, h.energy_j, h.weight, h.steps)
    assert card.launches == [2 + 2 * 2] and cpu.launches == [0]


def test_fleet_training_plane_on_card_is_the_loop(cuda_device):
    """An all-FL fleet of two groups, two of three clients a round, on the
    fleet engine's training plane and under the loop engine on the card:
    equal bills and losses, `torch.equal` global weights, and K1 once per
    active group a round in both."""
    from repro_torch.configs import WirelessConfig
    from repro_torch.kernels.quant_channel import ops as qc
    from repro_torch.nn import tree_leaves
    from repro_torch.schemes import (ClientBatch, ClientSpec, Experiment,
                                     FleetScheme, ParticipationPolicy,
                                     PopulationScheme)
    base = WirelessConfig(mode="fl", quant_bits=8)
    specs = [ClientSpec.fl(base, snr_db=20.0), ClientSpec.fl(base, snr_db=20.0),
             ClientSpec.fl(base, snr_db=6.0, quant_bits=4)]
    policy = ParticipationPolicy.uniform(2)
    runs = []
    for scheme in (PopulationScheme(None, specs, policy=policy),
                   FleetScheme(None, ClientBatch.from_specs(specs),
                               policy=policy, train="on")):
        launches = []
        round_fn = scheme.round

        def counted(*a, round_fn=round_fn, launches=launches):
            n0 = qc.packed_wire_2d.launches
            out = round_fn(*a)
            launches.append(qc.packed_wire_2d.launches - n0)
            return out
        scheme.round = counted
        exp = Experiment(scheme, cycles=2, seed=0, n_train=2048, n_test=256)
        exp.run()
        runs.append((exp, launches))
    (el, kl), (ef, kf) = runs
    assert [(r.bits, r.n_tx, r.energy_j, r.loss) for r in el.reports] == \
        [(r.bits, r.n_tx, r.energy_j, r.loss) for r in ef.reports]
    # clients 0 and 1 share a radio (group 0), client 2 is group 1
    groups = [len({min(i, 2) for i, c in enumerate(r.clients)
                   if c.steps > 0}) for r in el.reports]
    assert kl == kf == groups
    for a, b in zip(tree_leaves(ef.final_state.train.glob["model"]),
                    tree_leaves(el.final_state.train.global_trainable[
                        "model"])):
        assert a.device.type == "cuda" and torch.equal(a, b)


def test_resume_on_card_is_bit_for_bit(cuda_device, tmp_path):
    """A FaultPlan population on the card for 2 cycles, straight and
    killed after 1 then resumed: every report equal and every state
    tensor `torch.equal`, back on the card."""
    import dataclasses
    from repro_torch.checkpoint import ckpt as CKPT
    from repro_torch.schemes import Experiment, FaultPlan

    def run(**kw):
        scheme = _mixed_population("cuda", fault_plan=FaultPlan(
            seed=0, p_outage=0.25, p_dropout=0.25))
        exp = Experiment(scheme, cycles=kw.pop("cycles", 2), seed=0,
                         n_train=2048, n_test=256, **kw)
        return exp, exp.run()
    e1, r1 = run()
    run(cycles=1, checkpoint_dir=str(tmp_path), checkpoint_every=1)
    e3, r3 = run(resume_from=str(tmp_path))
    assert r1.accuracy == r3.accuracy and r1.loss == r3.loss
    assert r1.total_bits == r3.total_bits
    assert [dataclasses.asdict(r) for r in e1.reports] == \
        [dataclasses.asdict(r) for r in e3.reports]
    a, b = [], []
    CKPT._map_with_path(lambda k, x: a.append(x) or x, e1.final_state.train)
    CKPT._map_with_path(lambda k, x: b.append(x) or x, e3.final_state.train)
    tensors = [(x, y) for x, y in zip(a, b) if torch.is_tensor(x)]
    assert len(a) == len(b) and tensors
    for x, y in tensors:
        assert y.device.type == "cuda" and torch.equal(x, y)


def test_token_uplink_erasures_on_card_equal_cpu(cuda_device):
    """The CL token uplink under bounded ARQ with erased rows (a CL
    member of a faulty population): the card delivers the CPU's tokens,
    erased rows as zeros, and the same bill."""
    from repro_torch.core.draws import Key
    from repro_torch.schemes.radio import Radio
    radio = Radio(quant_bits=8, snr_db=4.0, arq_max_tx=3, ge_p_gb=0.2,
                  arq_backoff_s=0.01)
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, 10_001, (64, 30)).astype(np.int32))
    labels = torch.ones(64, dtype=torch.int32)
    card = radio.send_tokens(Key(7).draws(), tokens.to(cuda_device),
                             10_001, labels=labels)
    cpu = radio.send_tokens(Key(7).draws(), tokens, 10_001, labels=labels)
    assert any(cpu.user_erased)
    assert torch.equal(card.payload.cpu(), cpu.payload)
    assert (card.bits, card.n_tx, card.erased_bits, card.outage_s) == \
        (cpu.bits, cpu.n_tx, cpu.erased_bits, cpu.outage_s)


# ----------------------------------------- the scaled schemes (dense, P15)
def _wire_mean_case(rows, n, seed, dev):
    rng = np.random.default_rng(seed)
    buf = (rng.standard_normal((n * rows, 256))
           * rng.uniform(0.01, 3.0, (n * rows, 1))).astype(np.float32)
    rand = rng.integers(0, 2 ** 32, (n * rows, 256), dtype=np.int64)
    from repro_torch.core import quantization as Q
    scale = Q.scale_from_amax(torch.from_numpy(
        np.abs(buf).max(axis=1, keepdims=True)), 8)
    p = torch.from_numpy(rng.uniform(0, 0.1, (n * rows, 1))
                         .astype(np.float32))
    w = torch.full((n * rows, 1), 1.0 / n)
    return [t.to(dev).contiguous() for t in
            (torch.from_numpy(buf), torch.from_numpy(rand), scale, p, w)]


@pytest.mark.parametrize("rows", [98_304, 1_001])
def test_packed_wire_mean_at_the_qwen_sync_leaf(rows, cuda_device):
    """K2 at one stacked [24, 1024, 1024] leaf of qwen1.5-0.5b's FL sync
    (3 x 98,304 rows) and at a ragged 3 x 1,001, bit for bit with its
    plain version."""
    from repro_torch.kernels.quant_channel import ops as qc
    from repro_torch.kernels.quant_channel import ref as qref
    buf, rand, scale, p, w = _wire_mean_case(rows, 3, rows, cuda_device)
    words = qc.words_u32(rand)
    got = qc.packed_wire_mean_2d(buf, words, scale, p, w, 8, 3)
    want = qref.packed_wire_mean_ref(buf, words, scale, p, w, 8, 3)
    assert got.shape == (rows, 256) and torch.equal(got, want)


def _scaled(mode, dev, **kw):
    import dataclasses
    from repro_torch.configs import ShapeConfig, WirelessConfig, get_arch
    from repro_torch.schemes import build_scheme
    cfg = dataclasses.replace(get_arch("qwen1.5-0.5b").reduced(),
                              remat=False)
    shape = ShapeConfig("t", 16, 4, "train", microbatch=4)
    w = None if mode == "cl" else WirelessConfig(mode=mode, **kw)
    return build_scheme(w, cfg=cfg, shape=shape, device=dev,
                        steps_per_cycle=1), cfg, shape, w


def test_scaled_cl_step_on_card_equals_cpu(cuda_device):
    """One AdamW step of the reduced qwen1.5-0.5b (scaled CL) on the card
    and on the CPU from the same weights: the same corpus bill, the
    step's gradients within 2e-5 (abs + rel), and every weight after the
    step within 2e-5 but a few: AdamW divides each gradient by its own
    magnitude, so where one is within float error of zero the two
    devices' updates (at most lr = 3e-4 each) may differ in sign — at
    most 8 such weights, each within 2 lr."""
    from repro_torch.nn import tree_leaves
    from repro_torch.runtime.train_step import value_and_grad
    out = {}
    for dev in (cuda_device, "cpu"):
        scheme, cfg, _, _ = _scaled("cl", dev)
        (xtr, ytr), _ = scheme.default_data(32, 8, 0)
        state, dlv = scheme.init(0, xtr, ytr)
        x = torch.from_numpy(state.data[0][:4]).to(dev)
        _, g = value_and_grad(state.train.trainable,
                              {"tokens": x, "labels": x}, cfg, None, None)
        batch = scheme.cycle_batches(state, np.random.default_rng(1), 0)
        state, _ = scheme.round(state, batch, scheme.round_key(0, 0), 3e-4)
        out[str(dev)] = (dlv.bits, tree_leaves(state.train.trainable),
                         tree_leaves(g))
    (bc, wc, gc), (bh, wh, gh) = out["cuda"], out["cpu"]
    assert bc == bh == 32 * 16 * 10
    for a, b in zip(gc, gh):
        torch.testing.assert_close(a.cpu(), b, rtol=2e-5, atol=2e-5)
    far = 0
    for a, b in zip(wc, wh):
        d = (a.cpu() - b).abs()
        far += int((d > 2e-5 + 2e-5 * b.abs()).sum())
        assert float(d.max()) <= 2 * 3e-4
    assert far <= 8


@pytest.mark.parametrize("use_kernel", [False, True])
def test_scaled_fl_cycle_on_card_equals_cpu(use_kernel, cuda_device):
    """One scaled FL cycle (reduced qwen1.5-0.5b, 3 users, J 2) on the
    card: the same bill as on the CPU and one K1 (or K2) launch; then the
    card's user-stacked weights sent through the cycle's sync on the
    card (K1 or K2) and on the CPU (plain versions): bit for bit."""
    from repro_torch.kernels.quant_channel import ops as qc
    from repro_torch.core.draws import Key
    from repro_torch.nn import tree_leaves, tree_map
    from repro_torch.runtime import fl_runtime as FL
    from repro_torch.schemes import Experiment
    bills = {}
    for dev in (cuda_device, "cpu"):
        qc.packed_wire_2d.launches = qc.packed_wire_mean_2d.launches = 0
        scheme, cfg, shape, w = _scaled("fl", dev, quant_bits=8,
                                        local_steps=2,
                                        use_kernel=use_kernel)
        exp = Experiment(scheme, cycles=1, seed=0, n_train=48, n_test=8)
        exp.run()
        bills[str(dev)] = [(r.bits, r.n_tx) for r in exp.reports]
        launches = (qc.packed_wire_2d.launches,
                    qc.packed_wire_mean_2d.launches)
        if dev != "cpu":
            assert launches == ((0, 1) if use_kernel else (1, 0))
            weights = exp.final_state.train.trainable["model"]
    assert bills["cuda"] == bills["cpu"]
    sync = FL.make_fl_sync(w, 3)
    key = Key(3, 7)
    on_card = sync(key, weights, weights)
    on_cpu = sync(key, tree_map(lambda a: a.cpu(), weights),
                  tree_map(lambda a: a.cpu(), weights))
    for a, b in zip(tree_leaves(on_card), tree_leaves(on_cpu)):
        assert torch.equal(a.cpu(), b)


def test_sl_crossing_bf16_on_card_equals_cpu(cuda_device):
    """The SL crossing of a bf16 [4, 16, 64] activation (K1 on the card)
    and its gradient leg equal the CPU's bit for bit."""
    from repro_torch.core import channel as CH
    from repro_torch.core.draws import Key
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((4, 16, 64)).astype(
        np.float32)).to(torch.bfloat16)
    g = torch.from_numpy(rng.standard_normal((4, 16, 64)).astype(
        np.float32) * 0.05).to(torch.bfloat16)
    out = {}
    for dev in (cuda_device, "cpu"):
        xt = x.to(dev).requires_grad_()
        y = CH.channel_crossing(xt, Key(5), 8, 5.0, True, 0.5, False, 3,
                                0.25)
        y.backward(g.to(dev))
        out[str(dev)] = (y.detach().cpu(), xt.grad.cpu())
    for a, b in zip(out["cuda"], out["cpu"]):
        assert a.dtype == torch.bfloat16 and torch.equal(a, b)


@pytest.mark.parametrize("name", ["qwen3-moe-235b-a22b",
                                  "llama4-scout-17b-a16e"])
def test_apply_moe_on_card_equals_cpu(name, cuda_device):
    """The reduced MoE layer (4 experts, top-2 / top-1 + shared expert)
    in f32 at capacity factors 1.25 and 0.25 (drops): the card routes
    every (token, choice) to the CPU's expert, or the two lie within
    1e-6 in probability; output and aux within 2e-4."""
    import dataclasses
    from repro_torch.configs import get_arch
    from repro_torch.models import moe as MOE
    from repro_torch.nn import init_tree, tree_map
    for factor in (1.25, 0.25):
        cfg = dataclasses.replace(get_arch(name).reduced(),
                                  capacity_factor=factor)
        p = init_tree(MOE.moe_specs(cfg), torch.Generator().manual_seed(0),
                      "cpu")
        x = torch.from_numpy(np.random.default_rng(1).standard_normal(
            (2, 48, cfg.d_model)).astype(np.float32))
        pc = p
        pg = tree_map(lambda a: a.to(cuda_device), p)
        probs, _, idx = MOE.route(pc, x.reshape(-1, cfg.d_model), cfg)
        _, _, gidx = MOE.route(pg, x.reshape(-1, cfg.d_model).to(
            cuda_device), cfg)
        bad = (gidx.cpu() != idx).nonzero()
        gaps = [float(probs[t, idx[t, c]] - probs[t, gidx[t, c].cpu()])
                for t, c in bad.tolist()]
        assert all(abs(g) < 1e-6 for g in gaps), gaps
        y, aux = MOE.apply_moe(pc, x, cfg)
        yg, auxg = MOE.apply_moe(pg, x.to(cuda_device), cfg)
        torch.cuda.synchronize()
        torch.testing.assert_close(yg.cpu(), y, rtol=2e-4, atol=2e-4)
        for k in ("lb_loss", "dropped_frac"):
            torch.testing.assert_close(auxg[k].cpu(), aux[k], rtol=2e-4,
                                       atol=2e-4)
        if factor < 1:
            assert float(auxg["dropped_frac"]) > 0



def _xlstm(dev):
    """The reduced xlstm-350m (one super-block of 1 mLSTM + 1 sLSTM, f32)
    with weights from one CPU generator, on `dev`."""
    from repro_torch.configs import get_arch
    from repro_torch.models import api as M
    from repro_torch.nn import init_tree
    cfg = get_arch("xlstm-350m").reduced()
    return cfg, init_tree(M.param_specs(cfg),
                          torch.Generator().manual_seed(0), dev)


def test_xlstm_forward_and_decode_on_card_equal_cpu(cuda_device):
    """The reduced xLSTM's forward and its token-by-token decode (logits
    and every state leaf) on the card against the same weights on the
    CPU, within 2e-4 (the recurrences' matmuls sum in other orders on
    the two devices: the 2e-5 of the JAX comparison holds on one)."""
    from repro_torch.models import xlstm as X
    tok = torch.from_numpy(np.random.default_rng(2).integers(
        1, 1024, (2, 10)).astype(np.int32))
    out = {}
    with torch.no_grad():
        for dev in (cuda_device, "cpu"):
            cfg, p = _xlstm(dev)
            full, _ = X.forward(p, {"tokens": tok.to(dev)}, cfg)
            cache = X.init_cache(cfg, 2, 10, dev)
            steps = [X.decode_step(p, cache, tok[:, i:i + 1].to(dev), i,
                                   cfg)[0][:, 0] for i in range(10)]
            out[str(dev)] = (full, torch.stack(steps, 1), cache)
    (fc, dc, cc), (fh, dh, ch) = out["cuda"], out["cpu"]
    torch.testing.assert_close(fc.cpu(), fh, rtol=2e-4, atol=2e-4)
    torch.testing.assert_close(dc.cpu(), dh, rtol=2e-4, atol=2e-4)
    for k in ch:
        torch.testing.assert_close(cc[k].cpu(), ch[k], rtol=2e-4,
                                   atol=2e-4)
    torch.testing.assert_close(dc, fc, rtol=3e-3, atol=3e-3)


def test_xlstm_static_serving_loop_on_card(cuda_device):
    """`legacy_loop` (launch/serve.py) on the card with the CPU's weights
    and the same draws: the same bill, the same greedy tokens where the
    top two logits are not within 2e-4, and no kernel launch (the
    recurrences are plain ops; no attention)."""
    from repro_torch.launch import serve
    from repro_torch.nn import tree_map
    from repro_torch.kernels.decode_attention import ops as dec
    from repro_torch.kernels.quant_channel import ops as qc
    argv = ["--arch", "xlstm-350m", "--reduced", "--batch", "3",
            "--prompt-len", "6", "--new-tokens", "5", "--snr-db", "8",
            "--greedy", "--seed", "4"]
    cfg, p = _xlstm("cpu")
    n0 = (dec.gqa_decode.launches, qc.packed_wire_2d.launches)
    got = serve.legacy_loop(serve.parse_args(argv), cfg,
                            tree_map(lambda a: a.to(cuda_device), p),
                            cuda_device)
    assert (dec.gqa_decode.launches, qc.packed_wire_2d.launches) == n0
    want = serve.legacy_loop(serve.parse_args(argv + ["--device", "cpu"]),
                             cfg, p, torch.device("cpu"))
    for k in ("bits", "erased_bits", "energy_j"):
        assert got[k] == want[k], k
    np.testing.assert_array_equal(got["prompt"], want["prompt"])
    torch.testing.assert_close(got["prompt_logits"].cpu(),
                               want["prompt_logits"], rtol=2e-4, atol=2e-4)
    top2 = want["prompt_logits"][:, -1].topk(2).values
    if bool(((top2[:, 0] - top2[:, 1]) > 2e-4).all()):
        np.testing.assert_array_equal(got["generated"][:, 0],
                                      want["generated"][:, 0])


# ------------------------------------- the hybrid and audio families (P15)
def _reduced(name: str, dev):
    """A reduced config (f32) with weights from one CPU generator, on
    `dev`."""
    from repro_torch.configs import get_arch
    from repro_torch.models import api as M
    from repro_torch.nn import init_tree
    cfg = get_arch(name).reduced()
    return cfg, init_tree(M.param_specs(cfg),
                          torch.Generator().manual_seed(0), dev)


def test_ssd_chunked_at_two_chunks_on_card_equals_cpu(cuda_device):
    """Mamba2's chunked SSD at S 256 (two chunks of 128: the inter-chunk
    scan runs) on the card against the CPU within 2e-4."""
    from repro_torch.models import mamba2 as MB
    rng = np.random.default_rng(3)
    B, S, nh, hd, ds = 2, 256, 4, 16, 16
    args = [rng.standard_normal(s).astype(np.float32) for s in
            ((B, S, nh, hd), (B, S, ds), (B, S, ds))]
    args.append(np.log1p(np.exp(rng.standard_normal((B, S, nh)) - 2.0))
                .astype(np.float32))
    args += [(0.5 * rng.standard_normal(nh)).astype(np.float32),
             rng.standard_normal(nh).astype(np.float32)]
    t = [torch.from_numpy(a) for a in args]
    got = MB.ssd_chunked(*(a.to(cuda_device) for a in t))
    torch.testing.assert_close(got.cpu(), MB.ssd_chunked(*t), rtol=2e-4,
                               atol=2e-4)


def test_hybrid_block_forward_and_decode_on_card_equal_cpu(cuda_device):
    """The reduced zamba2's Mamba2 block, forward and token-by-token
    decode (logits and every cache leaf; the shared attention through K7
    on the card) against the same weights on the CPU within 2e-4, and
    decode = forward at 5e-3 (tests/test_archs_smoke.py's)."""
    from repro_torch.kernels.decode_attention import ops as dec
    from repro_torch.models import hybrid as Hy
    from repro_torch.models import mamba2 as MB
    from repro_torch.nn import tree_at
    tok = torch.from_numpy(np.random.default_rng(2).integers(
        1, 1024, (2, 10)).astype(np.int32))
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (2, 10, 256)).astype(np.float32))
    out = {}
    with torch.no_grad():
        for dev in (cuda_device, "cpu"):
            cfg, p = _reduced("zamba2-1.2b", dev)
            blk = MB.apply_mamba_block(tree_at(tree_at(p["mamba"], 0), 0),
                                       x.to(dev), cfg)
            full, _ = Hy.forward(p, {"tokens": tok.to(dev)}, cfg)
            cache = Hy.init_cache(cfg, 2, 10, dev)
            n0 = dec.gqa_decode.launches
            steps = [Hy.decode_step(p, cache, tok[:, i:i + 1].to(dev), i,
                                    cfg)[0][:, 0] for i in range(10)]
            n = dec.gqa_decode.launches - n0
            out[str(dev)] = (blk, full, torch.stack(steps, 1), cache, n)
    (bc, fc, dc, cc, nc), (bh, fh, dh, ch, nh) = out["cuda"], out["cpu"]
    assert (nc, nh) == (10 * Hy.layout(cfg)[0], 0)
    for a, b in ((bc, bh), (fc, fh), (dc, dh)):
        torch.testing.assert_close(a.cpu(), b, rtol=2e-4, atol=2e-4)
    for k in ch:
        torch.testing.assert_close(cc[k].cpu(), ch[k], rtol=2e-4,
                                   atol=2e-4)
    torch.testing.assert_close(dc, fc, rtol=5e-3, atol=5e-3)


def test_encoder_prefill_cross_and_decode_on_card_equal_cpu(cuda_device):
    """The reduced seamless's encoder, `prefill_cross` and token-by-token
    decode (self- and cross-attention through K7 on the card: two
    launches a layer a step) against the same weights on the CPU within
    2e-4, and decode = forward at 3e-3."""
    from repro_torch.kernels.decode_attention import ops as dec
    from repro_torch.models import encdec as E
    tok = torch.from_numpy(np.random.default_rng(2).integers(
        1, 1024, (2, 10)).astype(np.int32))
    fr = torch.from_numpy((0.1 * np.random.default_rng(4).standard_normal(
        (2, 64, 256))).astype(np.float32))
    out = {}
    with torch.no_grad():
        for dev in (cuda_device, "cpu"):
            cfg, p = _reduced("seamless-m4t-medium", dev)
            enc = E.encode(p, fr.to(dev), cfg)
            full, _ = E.forward(p, {"tokens": tok.to(dev),
                                    "frames": fr.to(dev)}, cfg)
            cache = E.prefill_cross(p, fr.to(dev), cfg,
                                    E.init_cache(cfg, 2, 10, dev))
            n0 = dec.gqa_decode.launches
            steps = [E.decode_step(p, cache, tok[:, i:i + 1].to(dev), i,
                                   cfg)[0][:, 0] for i in range(10)]
            n = dec.gqa_decode.launches - n0
            out[str(dev)] = (enc, full, torch.stack(steps, 1), cache, n)
    (ec, fc, dc, cc, nc), (eh, fh, dh, ch, nh) = out["cuda"], out["cpu"]
    assert (nc, nh) == (10 * 2 * cfg.n_layers, 0)
    for a, b in ((ec, eh), (fc, fh), (dc, dh)):
        torch.testing.assert_close(a.cpu(), b, rtol=2e-4, atol=2e-4)
    for k in ch:
        torch.testing.assert_close(cc[k].cpu(), ch[k], rtol=2e-4,
                                   atol=2e-4)
    torch.testing.assert_close(dc, fc, rtol=3e-3, atol=3e-3)


def test_warmup_compile_cold_then_warm(cuda_device, tmp_path,
                                      monkeypatch):
    """The SL scheme's `warmup_compile` into an empty kernel-build cache
    runs `nvcc` (cold); again, it finds the library (warm): warm < 0.2 x
    cold, scripts/ci.sh's gate for the JAX package's compile cache."""
    from repro_torch.kernels import build
    from repro_torch.launch import compile_cache
    scheme, _, _, _ = _scaled("sl", cuda_device)
    monkeypatch.setenv(compile_cache.ENV, str(tmp_path))
    compile_cache.enable_persistent_cache()
    assert not build.library_path("quant_channel").exists()
    cold = scheme.warmup_compile()
    assert build.library_path("quant_channel").exists()
    warm = scheme.warmup_compile()
    assert warm < 0.2 * cold, (warm, cold)


@pytest.mark.parametrize("weight_decay", [0.0, 0.01])
def test_adamw_in_place_equals_functional_on_card(weight_decay,
                                                  cuda_device):
    """The in-place AdamW on the card over 3 steps: weights, mu and nu
    bit for bit the functional expression's on the card (each product
    and sum rounded on its own: nothing fused into an FMA), -0.0, +0.0
    and subnormal gradient entries included, in the storage they came
    in."""
    check_adamw_in_place({"w": (1024, 1024), "b": (1000,),
                          "e": (3, 257, 129)}, 1, cuda_device, weight_decay)
