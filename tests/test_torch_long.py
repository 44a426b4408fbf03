"""The port at the JAX package's long shapes (configs/base.py's
train_4k, prefill_32k, decode_32k, long_500k), on the CPU against the
live JAX package, at small widths:

* `rope_angles` / `apply_rope` at positions 0-32,767 (hd 64, theta
  10,000). torch's CPU sin / cos and XLA's differ in the last place:
  measured on this suite's CPU, 4.8 % of the angles' sines and cosines
  one float32 ulp apart (at most 5.96e-8), none more; the rotated
  values then part by at most ROPE_APPLY_TOL.
* `ServeEngine` at the reduced qwen1.5-0.5b (2 layers, d_model 256,
  f32) on prompts of 1,024-2,048 tokens over many pages (page 16, chunk
  256, 129 pages a slot), paged and dense, through the fused prefill
  (the card's path), with the JAX engine's draws: greedy tokens, cycles
  and bills equal to the JAX engine's (which runs its scan prefill), and
  each prompt's last-chunk logits within 2e-4 (the suite's attention
  tolerance) of JAX's teacher-forced `forward` on the delivered prompt.
* One CL and one SL step (Q8, 20 dB) at seq 1,024 in two micro-steps of
  one sequence, against the JAX scheme on one data shard: bills exact,
  the SL step 2 x 2 x 1,024 x 64 x 8 bits; losses as
  tests/test_torch_scaled_schemes.py gates them (1e-4, Q8 SL 1e-2).
* The one-card microbatch rule (runtime/train_step.py): the shape's
  override, then the arch's microbatch_size, then one sequence a
  micro-step; the dry run keeps its mesh's data shards.
* long_500k's steps past its window (runtime/serve_step.py's
  `make_{,paged_}{prefill,decode}_step` at `SHAPES["long_500k"]`, whose
  `window_for` is 8,192, with seq_len cut to 9,216) at the reduced
  config: a seeded cache, one 128-row chunk of 100 tokens at start
  8,960 and four decode steps, paged (a permuted table) and dense,
  fused on both sides: logits and the whole cache within LOGIT_TOL of
  JAX's, the port paged = dense bit for bit, and the window biting (the
  same steps without it differ).
* RoPE also at long_500k's positions, 0-524,351: the same ulps.
* The paged kernels' page staging (kernels/csrc/kv_cols.cuh): the
  wrappers' `stage_pages` give each launch the page bases a CTA stages at
  a time, the only part of its shared memory that grows with the table
  row; it is at most build.STAGE_PAGES, the same at a row 4x the longest
  one a CTA once staged whole (past which the ops refused) as at that
  row, and no such row is refused; the one refusal left is a row past
  the 2^30 columns the kernels' int32 indices address
  (build.MAX_COLUMNS). Under long_500k's window the prefill stages only
  the window's pages; without it K10 takes long_500k's and the engine's
  212,992-token rows. Every staging the wrappers pick holds a loop step
  when the span is cut into segments (the launch refuses one that does
  not)."""
import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _jax_keys import JaxKey, JaxServeDraws, scaled_on_init
from repro.configs import SHAPES as J_SHAPES
from repro.configs import get_arch as jax_arch
from repro.configs.base import ShapeConfig as JShape
from repro.configs.base import WirelessConfig as JW
from repro.models import api as JM
from repro.models import layers as JL
from repro.models import transformer as JT
from repro.nn import init_params as jax_init
from repro.runtime import serve_step as JSS
from repro.runtime import train_step as JTS
from repro.schemes import Experiment as JExperiment
from repro.schemes import build_scheme as j_build_scheme
from repro.schemes.radio import Radio as JRadio
from repro.serve import Request as JRequest
from repro.serve import RequestTrace as JRequestTrace
from repro.serve import ServeEngine as JServeEngine
from repro_torch.configs import SHAPES, ShapeConfig, WirelessConfig, get_arch
from repro_torch.kernels import build
from repro_torch.kernels.decode_attention import ops as dec
from repro_torch.kernels.prefill_attention import ops as pre
from repro_torch.models import layers as L
from repro_torch.nn import params_from_jax
from repro_torch.runtime import serve_step as SS
from repro_torch.runtime import train_step as TS
from repro_torch.schemes import Experiment, build_scheme
from repro_torch.schemes.radio import Radio
from repro_torch.serve import Request, RequestTrace, ServeEngine

JCFG = jax_arch("qwen1.5-0.5b").reduced()
CFG = get_arch("qwen1.5-0.5b").reduced()
LOGIT_TOL = 2e-4
ROPE_ULPS, ROPE_APPLY_TOL = 1, 1e-6
LOSS_TOL, SL_LOSS_TOL, ACC_TOL = 1e-4, 1e-2, 0.01


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ------------------------------------------------------------------ RoPE
def _ulps(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    ia, ib = (x.view(np.int32).astype(np.int64) for x in (a, b))
    ia = np.where(ia < 0, -(ia & 0x7FFFFFFF), ia)
    ib = np.where(ib < 0, -(ib & 0x7FFFFFFF), ib)
    return np.abs(ia - ib)


# the positions each case covers: decode_32k's, and long_500k's with its
# last prompt chunk's 64 padded rows
ROPE_POSITIONS = {"angles": 32_768, "apply": 32_768,
                  "angles_long_500k": 524_352}


@pytest.mark.parametrize("part", sorted(ROPE_POSITIONS))
def test_rope_at_32k_positions_matches_jax(part):
    pos = np.arange(ROPE_POSITIONS[part], dtype=np.int32)[None]
    js, jc = (np.asarray(a) for a in JL.rope_angles(jnp.asarray(pos), 64,
                                                    10_000.0))
    ts, tc = (a.numpy() for a in L.rope_angles(torch.as_tensor(pos), 64,
                                               10_000.0))
    if part.startswith("angles"):
        for j, t in ((js, ts), (jc, tc)):
            assert _ulps(j, t).max() <= ROPE_ULPS
            assert (j != t).mean() < 0.06
        return
    x = np.random.default_rng(0).standard_normal(
        (1, 32_768, 2, 64)).astype(np.float32)
    want = np.asarray(JL.apply_rope(jnp.asarray(x), jnp.asarray(js),
                                    jnp.asarray(jc)))
    got = L.apply_rope(torch.from_numpy(x), torch.from_numpy(ts),
                       torch.from_numpy(tc)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=ROPE_APPLY_TOL)


# --------------------------------------------------------------- serving
LINK = dict(snr_db=20.0, fading=True)
ENGINE = dict(n_slots=3, greedy=True, chunk_size=256, page_size=16)


def _long_trace(cls_req, cls_trace):
    """Prompts of 1,024-2,048 tokens (whole chunks and a ragged tail),
    arrivals staggered so prefill chunks and decode steps share cycles."""
    return cls_trace(seed=11, requests=tuple(
        cls_req(rid=i, arrival_cycle=[0, 0, 2, 5][i],
                prompt_len=[2_048, 1_300, 1_024, 1_537][i],
                max_new_tokens=[4, 6, 3, 5][i],
                snr_db=[20.0, 12.0, 25.0, 16.0][i])
        for i in range(4)))


def _rows(rep):
    return [(r.rid, r.status, r.tokens, r.prompt_len, r.admit_cycle,
             r.first_token_cycle, r.ttft_cycles, r.complete_cycle,
             r.latency_cycles, r.uplink_bits, r.downlink_bits, r.bits,
             r.erased_bits, r.energy_j, r.n_tx, r.outage_s)
            for r in rep.results]


@pytest.fixture(scope="module")
def served():
    """The JAX engine (chunked, paged) on the long trace, and both
    models' weights."""
    jp = jax_init(jax.random.PRNGKey(0), JM.param_specs(JCFG))
    pp = params_from_jax(jax.tree.map(np.asarray, jp), CFG, "cpu")
    jrep = JServeEngine(JCFG, jp, radio=JRadio(**LINK), **ENGINE).serve(
        _long_trace(JRequest, JRequestTrace))
    return jp, pp, jrep


def _record_prompts(eng, S: int) -> list:
    """Wrap the engine's prefill so that each slot's prompt is rebuilt
    chunk by chunk. Returns the list that gets, once per served prompt,
    (its tokens, the logits after its last chunk), in full after the
    serve: a slot's prompt ends where its next one starts (start 0)."""
    built = eng.build(S)
    inner, rows, done = built["prefill"], {}, []

    def prefill(cache, toks, st, nv, tbl):
        lg, cache = inner(cache, toks, st, nv, tbl)
        for b in (nv > 0).nonzero()[:, 0].tolist():
            if int(st[b]) == 0 and b in rows:
                done.append(rows.pop(b))
            seq = rows[b][0] if b in rows else []
            rows[b] = (seq + toks[b, :int(nv[b])].tolist(), lg[b].clone())
        return lg, cache

    built["prefill"] = prefill
    return done, rows


@pytest.mark.parametrize("kv", ("paged", "dense"))
def test_engine_at_long_prompts_matches_jax(served, kv):
    jp, pp, jrep = served
    trace = _long_trace(Request, RequestTrace)
    eng = ServeEngine(CFG, pp, radio=Radio(**LINK), kv=kv,
                      prefill_impl="fused", device="cpu",
                      draws=JaxServeDraws, **ENGINE)
    done, open_rows = _record_prompts(eng, max(8, trace.max_seq_len()))
    rep = eng.serve(trace)
    done += list(open_rows.values())
    assert rep.kv == kv and rep.prefill == "chunked"
    if kv == "paged":
        assert rep.n_pages == jrep.n_pages == 3 * 129
        assert rep.peak_pages == jrep.peak_pages
    assert rep.cycles == jrep.cycles
    assert _rows(rep) == _rows(jrep)
    assert sorted(len(seq) for seq, _ in done) == sorted(
        r.prompt_len for r in trace.requests)
    for seq, got in done:
        want = JT.forward(jp, {"tokens": jnp.asarray([seq], jnp.int32)},
                          JCFG)[0][0, -1]
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=LOGIT_TOL)


# ------------------------------------------- long_500k past its window
# long_500k's steps (window 8,192) with seq_len cut to 9,216: a chunk of
# PAST_C rows, PAST_VALID of them tokens, at PAST_START reads columns
# from 769 on, and its last positions' window starts past column 0
PAST_S, PAST_START, PAST_C, PAST_VALID, PAST_DECODE = 9_216, 8_960, 128, \
    100, 4
PAGE = 16
WINDOWS = {"long_500k": "long_500k", "none": "serve"}


@pytest.fixture(scope="module")
def past_window():
    """Both packages' weights, a seeded dense cache and its paged pool
    (a permuted table), and the chunk's and decode steps' tokens."""
    rng = np.random.default_rng(29)
    jp = jax_init(jax.random.PRNGKey(3), JM.param_specs(JCFG))
    pp = params_from_jax(jax.tree.map(np.asarray, jp), CFG, "cpu")
    shape = (CFG.n_layers, 1, CFG.n_kv_heads, PAST_S, CFG.hd)
    dense = {k: rng.standard_normal(shape).astype(np.float32)
             for k in ("k", "v")}
    n_lp = PAST_S // PAGE
    table = rng.permutation(n_lp).astype(np.int32)[None]
    pool = {}
    for k, x in dense.items():
        pages = x.reshape(CFG.n_layers, CFG.n_kv_heads, n_lp, PAGE, CFG.hd)
        pool[k] = np.empty((CFG.n_layers, n_lp, CFG.n_kv_heads, PAGE,
                            CFG.hd), np.float32)
        pool[k][:, table[0]] = pages.transpose(0, 2, 1, 3, 4)
    toks = rng.integers(0, CFG.vocab_size, (1, PAST_C + PAST_DECODE),
                        dtype=np.int32)
    return jp, pp, dense, pool, table, toks


def _run_steps(pkg, kv, window, past):
    """One prefill chunk and PAST_DECODE greedy-free decode steps (the
    tokens are given) through `pkg`'s step builders at long_500k (or, at
    window "none", the same shape under a name with no window). Returns
    (chunk logits, [decode logits], cache as numpy)."""
    jp, pp, dense, pool, table, toks = past
    shape = dataclasses.replace(
        (J_SHAPES if pkg == "jax" else SHAPES)["long_500k"],
        seq_len=PAST_S, name=WINDOWS[window])
    chunk, dec_toks = toks[:, :PAST_C], toks[:, PAST_C:]
    paged = kv == "paged"
    if pkg == "jax":
        P, arr, cfg, S = jp, jnp.asarray, JCFG, JSS
        prefill = (S.make_paged_prefill_step(cfg, shape, PAGE, "fused")
                   if paged else S.make_prefill_step(cfg, shape, "fused"))
        step = (S.make_paged_decode_step(cfg, shape, PAGE) if paged
                else S.make_decode_step(cfg, shape))
    else:
        P, arr, cfg, S = pp, torch.as_tensor, CFG, SS
        prefill = (S.make_paged_prefill_step(cfg, shape, PAGE, "fused",
                                             "cpu") if paged
                   else S.make_prefill_step(cfg, shape, "fused", "cpu"))
        step = (S.make_paged_decode_step(cfg, shape, PAGE) if paged
                else S.make_decode_step(cfg, shape))
    cache = {k: arr(np.array(x)) for k, x in (pool if paged else
                                              dense).items()}
    tbl = (arr(table),) if paged else ()
    # JAX op by op: compiled, its layer scan fuses RoPE's sin / cos, which
    # at these angles (up to 9,063 rad) departs from the eager sin / cos
    # by up to 8.1e-4 in a K column (measured on this suite's CPU); the
    # eager ones are within 1 ulp of the port's (the RoPE tests above)
    with jax.disable_jit() if pkg == "jax" else contextlib.nullcontext():
        lg, cache = prefill(P, cache, arr(chunk),
                            arr(np.array([PAST_START], np.int32)),
                            arr(np.array([PAST_VALID], np.int32)), *tbl)
        dec = []
        for i in range(PAST_DECODE):
            idx = arr(np.array([PAST_START + PAST_VALID + i], np.int32))
            extra = (*tbl, arr(np.array([True]))) if paged else ()
            out, cache = step(P, cache, arr(dec_toks[:, i:i + 1]), idx,
                              *extra)
            dec.append(np.asarray(out))
    return np.asarray(lg), dec, {k: np.asarray(x) for k, x in cache.items()}


@pytest.mark.parametrize("kv", ("paged", "dense"))
@pytest.mark.parametrize("window", sorted(WINDOWS))
def test_long_500k_steps_past_the_window_match_jax(past_window, kv,
                                                   window):
    want = _run_steps("jax", kv, window, past_window)
    got = _run_steps("torch", kv, window, past_window)
    np.testing.assert_allclose(got[0], want[0], rtol=0, atol=LOGIT_TOL)
    for g, w in zip(got[1], want[1]):
        np.testing.assert_allclose(g, w, rtol=0, atol=LOGIT_TOL)
    for k in ("k", "v"):
        np.testing.assert_allclose(got[2][k], want[2][k], rtol=0,
                                   atol=LOGIT_TOL)
    # the other layout gives the same bits; the other window does not
    other = _run_steps("torch", "dense" if kv == "paged" else "paged",
                       window, past_window)
    np.testing.assert_array_equal(other[0], got[0])
    for g, o in zip(got[1], other[1]):
        np.testing.assert_array_equal(o, g)
    unwindowed = _run_steps("torch", kv, "none" if window == "long_500k"
                            else "long_500k", past_window)
    assert np.abs(unwindowed[0] - got[0]).max() > 1e-2
    assert SS.window_for(CFG, SHAPES["long_500k"]) == 8_192


# -------------------------------------------------------------- training
TRAIN = {"cl_20db": dict(mode="cl", snr_db=20.0),
         "sl_q8_20db": dict(mode="sl", quant_bits=8, snr_db=20.0,
                            compress_factor=4)}
SEQ, BATCH = 1_024, 2


@pytest.mark.parametrize("name", sorted(TRAIN))
def test_step_at_seq_1024_in_two_micro_steps_matches_jax(name):
    kw = TRAIN[name]
    jshape = JShape("long", SEQ, BATCH, "train")
    shape = ShapeConfig("long", SEQ, BATCH, "train")
    jscheme = j_build_scheme(JW(**kw), cfg=JCFG, shape=jshape,
                             steps_per_cycle=1, n_data_shards=1)
    jexp = JExperiment(jscheme, cycles=1, seed=0, n_train=4, n_test=BATCH)
    jres = jexp.run()
    scheme = build_scheme(WirelessConfig(**kw), cfg=CFG, shape=shape,
                          device="cpu", key=JaxKey.root, steps_per_cycle=1)
    assert scheme._micro_count(TS.LIVE_DATA_SHARDS) == BATCH \
        == JTS.auto_microbatch(JCFG, jshape, 1)
    (xtr, ytr), _ = scheme.default_data(4, BATCH, 0)
    exp = Experiment(scheme, cycles=1, seed=0, n_train=4, n_test=BATCH,
                     on_init=scaled_on_init(j_build_scheme(
                         JW(**kw), cfg=JCFG, shape=jshape,
                         steps_per_cycle=1, n_data_shards=1), xtr, ytr))
    res = exp.run()
    (r,), (jr,) = exp.reports, jexp.reports
    assert (r.bits, r.n_tx, r.erased_bits, r.steps) == \
        (jr.bits, jr.n_tx, jr.erased_bits, jr.steps)
    if kw["mode"] == "sl":
        assert r.bits == 2 * BATCH * SEQ * (CFG.d_model // 4) * 8
    else:
        assert exp.init_delivery.bits == jexp.init_delivery.bits \
            == 4 * SEQ * 10
    np.testing.assert_allclose(res.loss, jres.loss, rtol=0,
                               atol=SL_LOSS_TOL if kw["mode"] == "sl"
                               else LOSS_TOL)
    np.testing.assert_allclose(res.accuracy, jres.accuracy, rtol=0,
                               atol=ACC_TOL)
    assert all(np.isfinite(res.loss))


# (global batch, shape microbatch, arch microbatch_size, data shards,
#  micro-steps): train_4k live on one card, cut to 32 as the card runs
#  it, with the shape's override, with an arch microbatch_size, and the
#  dry run on the 16 x 16 mesh's data shards
MICRO = {"train_4k": (256, 0, 0, None, 256),
         "train_4k_cut": (32, 0, 0, None, 32),
         "shape_override": (32, 8, 0, None, 4),
         "arch_microbatch": (32, 0, 2, None, 16),
         "dry_run_pod": (256, 0, 0, 16, 16)}


@pytest.mark.parametrize("case", sorted(MICRO))
def test_one_card_microbatch_rule_at_train_4k(case):
    batch, mb, arch_mb, shards, want = MICRO[case]
    shape = dataclasses.replace(SHAPES["train_4k"], global_batch=batch,
                                microbatch=mb)
    jshape = dataclasses.replace(J_SHAPES["train_4k"], global_batch=batch,
                                 microbatch=mb)
    cfg = dataclasses.replace(get_arch("qwen1.5-0.5b"),
                              microbatch_size=arch_mb)
    jcfg = dataclasses.replace(jax_arch("qwen1.5-0.5b"),
                               microbatch_size=arch_mb)
    got = TS.auto_microbatch(cfg, shape) if shards is None \
        else TS.auto_microbatch(cfg, shape, shards)
    assert got == want == JTS.auto_microbatch(jcfg, jshape, shards or 1)
    if shards is None:
        # the live SL scheme bills and crosses by the same count
        s = build_scheme(WirelessConfig(mode="sl"), cfg=cfg, shape=shape,
                         device="cpu")
        assert s._n_micro == want


# -------------------------------------------------------- page staging
def _decode_stage(B, Hkv, G, hd):
    n_split = dec.decode_splits(B, Hkv, G)
    return lambda n: dec.stage_pages(n, 16, n_split)


# op, shape arguments, the longest table row at page 16 (pages) one CTA
# staged whole before the staging went by segments (the ops refused one
# page more)
STAGING = {
    "decode_hd64_one_split": ("decode", (4, 99, 1, 64), 28_924),
    "decode_hd128_g8_one_split": ("decode", (4, 99, 8, 128), 28_016),
    "decode_hd160_g4_one_split": ("decode", (4, 99, 4, 160), 27_760),
    "decode_32k_qwen_16_slots": ("decode", (16, 16, 1, 64), 57_846),
    "prefill_bf16_hd64": ("prefill", (64, torch.bfloat16), 12_672),
    "prefill_bf16_hd128": ("prefill", (128, torch.bfloat16), 12_672),
    "prefill_bf16_hd160": ("prefill", (160, torch.bfloat16), 18_304),
    "prefill_f32_hd64": ("prefill", (64, torch.float32), 26_192),
    "prefill_f32_hd128": ("prefill", (128, torch.float32), 23_632),
    "prefill_f32_hd160": ("prefill", (160, torch.float32), 25_056),
}


@pytest.mark.parametrize("case", sorted(STAGING))
def test_paged_ops_refuse_past_the_staging_limit(case):
    """The staging limit is gone: a row 4x the old longest row stages no
    more page bases a CTA at a time (the launch's shared memory beside
    the body's own) than a row at the old limit, nor does the longest row
    the kernels address: one staging of STAGE_PAGES; none is refused.
    What is refused is a row past MAX_COLUMNS, before any launch."""
    op, shape, top = STAGING[case]
    if op == "decode":
        stage = _decode_stage(*shape)
    else:
        stage = (lambda hd, dt: lambda n: pre.stage_pages(hd, dt, n))(
            *shape)
    longest = build.MAX_COLUMNS // 16
    assert stage(4 * top) == stage(top) == stage(longest) \
        == build.STAGE_PAGES
    # a row of one page stages one
    assert stage(1) == 1
    build.check_table(case, 4 * top, 16)
    build.check_table(case, longest, 16)
    with pytest.raises(ValueError, match=r"1073741824 \(2\^30\)"):
        build.check_table(case, longest + 1, 16)


# long_500k's 32,768 pages at its window, in bf16 and f32 at each built
# head dim: the prefill stages the pages of window + reach columns, 515-517
# pages of 16
WINDOWED = {f"{dt}_hd{hd}": (hd, getattr(torch, dt))
            for dt in ("bfloat16", "float32") for hd in build.HEAD_DIMS}


@pytest.mark.parametrize("case", sorted(WINDOWED))
def test_paged_prefill_stages_only_its_window(case):
    hd, dtype = WINDOWED[case]
    n_lp, window = 32_768, 8_192
    reach = 63 if dtype == torch.bfloat16 else 15 + (16 if hd > 128
                                                     else 32) - 1
    pages = -(-(window + reach) // 16) + 1
    assert pages in (515, 516, 517)
    assert pre.stage_pages(hd, dtype, n_lp, 16, window) == pages \
        < build.STAGE_PAGES
    build.check_table("gqa_prefill_paged", n_lp, 16)
    # a row shorter than the span stages the row
    assert pre.stage_pages(hd, dtype, 100, 16, window) \
        == pre.stage_pages(hd, dtype, 100) == 100


@pytest.mark.parametrize("shape", ("decode_32k", "long_500k"))
def test_registered_shapes_against_the_staging_limit(shape):
    """decode_32k's 2,048 pages a slot stage once in both paged kernels;
    long_500k's 32,768 in K8 (8 splits of one slot) and, at the shape's
    window, in K10, which then stages only the window's pages; without
    a window K10 takes the row too, in segments of one staging, as it
    takes the engine's 212,992-token prompt (13,312 pages)."""
    n_lp = SHAPES[shape].seq_len // 16
    B = 16 if shape == "decode_32k" else 1
    build.check_table("gqa_decode_paged", n_lp, 16)
    build.check_table("gqa_prefill_paged", n_lp, 16)
    if shape == "decode_32k":
        assert n_lp == build.STAGE_PAGES
        assert _decode_stage(B, 16, 1, 64)(n_lp) < build.STAGE_PAGES
        assert pre.stage_pages(64, torch.bfloat16, n_lp) == n_lp
        return
    # K8's 8 splits of 4,096 pages: two stagings each without a window
    assert _decode_stage(B, 16, 1, 64)(n_lp) == build.STAGE_PAGES
    window = SS.window_for(CFG, SHAPES[shape])
    assert window == 8_192
    assert pre.stage_pages(64, torch.bfloat16, n_lp, 16, window) == 517
    assert pre.stage_pages(64, torch.bfloat16, n_lp) \
        == pre.stage_pages(64, torch.bfloat16, 212_992 // 16) \
        == build.STAGE_PAGES
    build.check_table("gqa_prefill_paged", 212_992 // 16, 16)


# (page, table row in pages, window or a decode split count): short and
# long rows at pages of 1 to 64, tiny windows and many splits, where the
# span's own pages are fewer than one loop step (MAX_STEP columns) needs
STAGE_FLOOR = {
    "prefill_page1_window1": (1, 5_000, ("prefill", 1)),
    "prefill_page3_window48": (3, 100_000, ("prefill", 48)),
    "prefill_page16_window48": (16, 40, ("prefill", 48)),
    "prefill_page64_row": (64, 3, ("prefill", 0)),
    "decode_page1_8_splits": (1, 48, ("decode", 8)),
    "decode_page16_8_splits": (16, 3, ("decode", 8)),
    "decode_page3_long": (3, 1_000_000, ("decode", 1)),
    "decode_page64_long": (64, 50_000, ("decode", 2)),
}


@pytest.mark.parametrize("case", sorted(STAGE_FLOOR))
def test_stage_pages_hold_one_loop_step(case):
    """The wrappers' staging is one the launch takes (kv_cols.cuh's
    `valid`): at least one page, at most STAGE_PAGES and the row, and
    when it holds less than the row, at least MAX_STEP columns past its
    first page, so each segment of a cut span holds a loop step; and a
    sliding window's span, window + reach columns from any column, fits
    one staging."""
    page, n_lp, (op, arg) = STAGE_FLOOR[case]
    if op == "decode":
        stages = [(dec.stage_pages(n_lp, page, arg), 0)]
    else:
        # a CTA's span reaches 63 columns past the window in bf16, 15 rows
        # and a tile (32 columns, 16 at hd 160) less one in f32
        stages = [(pre.stage_pages(hd, dt, n_lp, page, arg),
                   63 if dt == torch.bfloat16 else 15 + (
                       16 if hd > 128 else 32) - 1)
                  for hd in build.HEAD_DIMS
                  for dt in (torch.bfloat16, torch.float32)]
    for stage, reach in stages:
        assert 1 <= stage <= min(n_lp, build.STAGE_PAGES)
        assert stage == n_lp or (stage - 1) * page >= build.MAX_STEP
        if op == "prefill" and arg:
            # window + reach columns from any column touch at most
            # ceil(span / page) + 1 pages
            assert stage == n_lp or stage >= -(-(arg + reach) // page) + 1
