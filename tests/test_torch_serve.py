"""Port parity for the serving slice: the port's `ServeEngine` on the
reduced qwen1.5-0.5b (2 layers, d 256, f32), on the JAX package's own
parameters, with the JAX engine's draws handed in through the port's
seams, gives the JAX engine's tokens, TTFT cycles and — exactly — its
per-request bills. The radio pieces under it (`transmit_tokens`,
`drawn_stacked_tx`, `Radio.send_tokens`) are bit-exact given the same
draws; the page allocator, buckets and trace JSON match.

The JAX engine runs on the CPU as tests/test_serve.py runs it (scan
prefill); the port runs its plain versions (CPU tensors)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _jax_keys import JaxLinkDraws, JaxServeDraws
from repro.configs import get_arch as jax_arch
from repro.core import channel as JCH
from repro.core import wire as JW
from repro.models import api as JM
from repro.nn import init_params as jax_init
from repro.schemes.radio import Radio as JRadio
from repro.serve import PagePool as JPagePool
from repro.serve import Request as JRequest
from repro.serve import RequestTrace as JRequestTrace
from repro.serve import ServeEngine as JServeEngine
from repro.serve import bucket_for as j_bucket_for
from repro.serve import make_trace as j_make_trace
from repro.serve import pages_needed as j_pages_needed
from repro.serve import prefill_buckets as j_prefill_buckets
from repro_torch.configs import get_arch
from repro_torch.core import channel as CH
from repro_torch.core import wire as W
from repro_torch.nn import params_from_jax
from repro_torch.schemes.radio import Radio
from repro_torch.serve import (PagePool, Request, RequestTrace, ServeEngine,
                               bucket_for, make_trace, pages_needed,
                               prefill_buckets)

JCFG = jax_arch("qwen1.5-0.5b").reduced()
CFG = get_arch("qwen1.5-0.5b").reduced()
# bounded ARQ that erases whole rows: on the trace below some requests
# are served, some abandoned on the uplink, some erased on the downlink
LINK = dict(snr_db=10.0, fading=True, arq_max_tx=1, arq_attempts=1,
            arq_min_f2=0.4)
MODES = [("chunked", "paged"), ("chunked", "dense"), ("token", "paged"),
         ("token", "dense")]


# ------------------------------------------------------------ fixtures
@pytest.fixture(scope="module")
def params():
    jp = jax_init(jax.random.PRNGKey(0), JM.param_specs(JCFG))
    return jp, params_from_jax(jax.tree.map(np.asarray, jp), CFG, "cpu")


def _staggered_trace(cls_req, cls_trace):
    """tests/test_serve.py's mixed trace: prompts below the bucket floor
    and over one chunk, arrivals staggered so prefills and decodes share
    cycles."""
    return cls_trace(seed=7, requests=tuple(
        cls_req(rid=i, arrival_cycle=[0, 0, 1, 3, 7, 9][i],
                prompt_len=[40, 3, 17, 64, 5, 33][i],
                max_new_tokens=[6, 9, 4, 5, 8, 3][i],
                snr_db=[18.0, 6.0, 12.0, 25.0, 9.0, 15.0][i])
        for i in range(6)))


def _rows(rep):
    return [(r.rid, r.status, r.tokens, r.prompt_len, r.admit_cycle,
             r.first_token_cycle, r.ttft_cycles, r.complete_cycle,
             r.latency_cycles, r.uplink_bits, r.downlink_bits, r.bits,
             r.erased_bits, r.energy_j, r.n_tx, r.outage_s)
            for r in rep.results]


def _engines(params, link, trace_args, greedy, modes, impl="auto", **kw):
    """The JAX engine (chunked + paged) and the port in `modes` on one
    trace, the port fed the JAX engine's draws."""
    jp, pp = params
    ekw = dict(n_slots=3, temperature=0.8, greedy=greedy, chunk_size=16,
               page_size=8, **kw)
    jrep = JServeEngine(JCFG, jp, radio=JRadio(**link), **ekw).serve(
        trace_args(JRequest, JRequestTrace))
    reps = {m: ServeEngine(CFG, pp, radio=Radio(**link), prefill=m[0],
                           kv=m[1], prefill_impl=impl, device="cpu",
                           draws=JaxServeDraws, **ekw).serve(
                               trace_args(Request, RequestTrace))
            for m in modes}
    return jrep, reps


# ------------------------------------------------------------- engine
def test_engine_matches_jax_greedy_all_modes(params):
    """Greedy: every (prefill, kv) mode of the port gives the JAX
    engine's tokens, cycles and exactly its bills, erasures included:
    abandoned uplinks and erased downlinks are billed as in JAX, and
    the zeroed prompt rows of erased tries are served alike."""
    jrep, reps = _engines(params, LINK, _staggered_trace, True, MODES)
    assert {r.status for r in jrep.results} == {"ok", "uplink_erased",
                                                 "downlink_erased"}
    assert jrep.generated_tokens > 0 and jrep.erased_bits > 0
    for mode, rep in reps.items():
        assert (rep.prefill, rep.kv) == mode
        got, ref = _rows(rep), _rows(jrep)
        if mode[0] == "token":     # token admission: more cycles, same
            got = [g[:4] + g[9:] for g in got]      # tokens and bills
            ref = [r[:4] + r[9:] for r in ref]
        else:
            assert rep.cycles == jrep.cycles, mode
        assert got == ref, mode
    assert reps[("chunked", "paged")].peak_pages == jrep.peak_pages
    assert reps[("chunked", "paged")].n_pages == jrep.n_pages


def test_engine_matches_jax_sampled_fused(params):
    """Temperature sampling with the JAX engine's Gumbel noise injected,
    through the port's fused prefill (the path CUDA takes; the JAX
    engine runs its scan prefill): the same tokens, TTFT cycles and
    bills."""
    jrep, reps = _engines(params, LINK, _staggered_trace, False,
                          [("chunked", "paged"), ("chunked", "dense")],
                          impl="fused")
    assert len({tuple(r.tokens) for r in jrep.results}) > 1
    for mode, rep in reps.items():
        assert _rows(rep) == _rows(jrep), mode


def test_port_bills_equal_across_modes_with_own_draws(params):
    """With the port's own draws (no injection) the four prefill x kv
    modes give identical tokens and bills, and replay is deterministic."""
    reps = [ServeEngine(CFG, params[1], n_slots=3, radio=Radio(**LINK),
                        temperature=0.8, prefill=pf, kv=kv, chunk_size=16,
                        page_size=8, device="cpu").serve(
                            _staggered_trace(Request, RequestTrace))
            for pf, kv in MODES + [MODES[0]]]
    key = [[g[:4] + g[9:] for g in _rows(r)] for r in reps]
    assert all(k == key[0] for k in key)
    assert _rows(reps[0]) == _rows(reps[-1])
    rep = reps[0]
    assert rep.delivered_bits + rep.erased_bits == rep.bits


def test_warmup_runs_every_bucket_and_serve_matches(params):
    eng = ServeEngine(CFG, params[1], n_slots=2, chunk_size=16,
                      page_size=8, device="cpu")
    assert eng.warmup_compile(24) >= 0.0
    assert set(eng.build(24)["buckets"]) == {4, 8, 16}
    rep = eng.serve(make_trace(1, 3, prompt_lens=(3, 12), new_tokens=(2, 3)))
    assert all(r.status == "ok" for r in rep.results)


# ------------------------------------------------------------- radio
def _tokens(seed, shape, vocab):
    return np.random.default_rng(seed).integers(0, vocab, shape,
                                                dtype=np.int32)


@pytest.mark.parametrize("fading", [True, False])
def test_transmit_tokens_bit_exact(fading):
    key = jax.random.PRNGKey(11)
    tok = _tokens(0, (6, 40), CFG.vocab_size)
    ref = JCH.transmit_tokens(key, jnp.asarray(tok), CFG.vocab_size,
                              snr_db=3.0, fading=fading)
    got = CH.transmit_tokens(JaxLinkDraws(key), torch.from_numpy(tok),
                             CFG.vocab_size, snr_db=3.0, fading=fading)
    assert got.dtype == torch.int32
    assert (got.numpy() != tok).any()
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_channel_primitives_match():
    np.testing.assert_allclose(CH.snr_linear(7.5).numpy(),
                               np.asarray(JCH.snr_linear(7.5)), rtol=1e-7)
    f2 = np.linspace(0.0, 4.0, 33, dtype=np.float32)
    np.testing.assert_allclose(CH.bpsk_bit_error_prob(5.0, f2).numpy(),
                               np.asarray(JCH.bpsk_bit_error_prob(5.0, f2)),
                               rtol=1e-6)
    words = np.random.default_rng(2).integers(0, 1 << 32, (64,),
                                              dtype=np.uint32)
    np.testing.assert_array_equal(
        W.fmix32(torch.from_numpy(words.astype(np.int64))).numpy(),
        np.asarray(JW.fmix32(jnp.asarray(words))).astype(np.int64))
    np.testing.assert_array_equal(
        W.bit_flip_mask(torch.from_numpy(words.astype(np.int64)), 17,
                        np.float32(0.3)).numpy(),
        np.asarray(JW.bit_flip_mask(jnp.asarray(words), 17,
                                    np.float32(0.3))).astype(np.int64))


@pytest.mark.parametrize("kw", [
    dict(fading=True, arq_attempts=3, arq_max_tx=4, arq_min_f2=1.0),
    dict(fading=True, arq_attempts=1, arq_max_tx=2, ge_p_gb=0.3,
         ge_p_bg=0.4),
    dict(fading=False, arq_max_tx=3, ge_p_gb=0.5, ge_p_bg=0.2),
    dict(fading=True, arq_attempts=4, arq_min_f2=0.8),
    dict(fading=False),
])
def test_drawn_stacked_tx_bit_exact(kw):
    key = jax.random.PRNGKey(5)
    ref_tx, ref_er = JW.drawn_stacked_tx(key, 7, 3, with_erased=True, **kw)
    got_tx, got_er = W.drawn_stacked_tx(JaxLinkDraws(None, arq_key=key), 7,
                                        3, with_erased=True, **kw)
    np.testing.assert_array_equal(got_tx, np.asarray(ref_tx))
    np.testing.assert_array_equal(got_er, np.asarray(ref_er))


def test_expected_tx_payload_and_backoff_match():
    for a, f2, fad, perf in [(1, 0.25, True, False), (3, 0.5, True, False),
                             (4, 1.0, False, False), (2, 0.1, True, True)]:
        assert W.expected_arq_tx(a, f2, fad, perf) == \
            JW.expected_arq_tx(a, f2, fad, perf)
        assert W.fault_free(fad, perf, a, f2, a, 0.0) == \
            JW.fault_free(fad, perf, a, f2, a, 0.0)
    tok = _tokens(1, (3, 9), 50)
    assert W.payload_bits(torch.from_numpy(tok), 6) == \
        JW.payload_bits(jnp.asarray(tok), 6)
    n_tx = np.array([1, 3, 2, 5])
    assert W.backoff_s(n_tx, 0.01) == JW.backoff_s(n_tx, 0.01)


@pytest.mark.parametrize("kw", [
    dict(snr_db=5.0, fading=True, arq_max_tx=1, arq_attempts=1,
         arq_min_f2=1.5, arq_backoff_s=0.002),
    dict(snr_db=12.0, fading=True),
    dict(snr_db=8.0, fading=True, arq_max_tx=3, ge_p_gb=0.4),
    dict(perfect=True, fading=False),
])
def test_send_tokens_bit_exact(kw):
    """Payload and every bill field equal, given the same draws."""
    tok = _tokens(3, (8, 21), CFG.vocab_size)
    key = jax.random.PRNGKey(17)
    ref = JRadio(**kw).send_tokens(key, jnp.asarray(tok), CFG.vocab_size)
    got = Radio(**kw).send_tokens(JaxLinkDraws(key), torch.from_numpy(tok),
                                  CFG.vocab_size)
    np.testing.assert_array_equal(np.asarray(got.payload),
                                  np.asarray(ref.payload))
    for f in dataclasses.fields(ref):
        if f.name != "payload":
            assert getattr(got, f.name) == getattr(ref, f.name), f.name


def test_radio_from_wcfg_and_rate_match():
    from repro.configs.base import WirelessConfig as JW_cfg
    from repro_torch.configs import WirelessConfig
    jw, pw = JW_cfg(snr_db=7.0, arq_max_tx=2), WirelessConfig(snr_db=7.0,
                                                              arq_max_tx=2)
    assert [f.name for f in dataclasses.fields(pw)] == \
        [f.name for f in dataclasses.fields(jw)]
    jr, pr = JRadio.from_wcfg(jw), Radio.from_wcfg(pw)
    assert dataclasses.asdict(pr) == dataclasses.asdict(jr)
    assert pr.rate_bps() == jr.rate_bps()
    assert pr.energy_j(1234.0) == jr.energy_j(1234.0)


# ------------------------------------------------------ paging + trace
def test_page_pool_allocates_in_jax_order():
    ops = [("a", 3), ("a", 2), ("f", 0), ("a", 4), ("f", 1), ("a", 1),
           ("a", 2), ("f", 0), ("a", 5)]
    out = []
    for pool in (JPagePool(12), PagePool(12)):
        held, seq = [], []
        for op, n in ops:
            if op == "a":
                held.append(pool.alloc(n))
            else:
                pool.free(held.pop(n))
            seq.append((tuple(held[-1]) if held else (), pool.free_pages,
                        pool.peak_pages, pool.can_alloc(6)))
        out.append(seq)
    assert out[0] == out[1]
    with pytest.raises(RuntimeError, match="double free"):
        pool.free([0, 0])


def test_paging_helpers_match():
    for c in (1, 3, 16, 32, 33, 100):
        assert prefill_buckets(c) == j_prefill_buckets(c)
        b = prefill_buckets(c)
        for x in range(1, b[-1] + 1, 3):
            assert bucket_for(x, b) == j_bucket_for(x, b)
    for p, n, ps in [(1, 1, 16), (40, 6, 8), (256, 64, 16), (17, 1, 4)]:
        assert pages_needed(p, n, ps) == j_pages_needed(p, n, ps)


def test_trace_json_round_trips_through_both(tmp_path):
    jt = j_make_trace(5, 9, snr_dbs=(4.0, 9.5))
    pt = make_trace(5, 9, snr_dbs=(4.0, 9.5))
    assert pt.to_json() == jt.to_json()
    path = tmp_path / "trace.json"
    pt.save(str(path))
    assert JRequestTrace.load(str(path)) == jt
    jt.save(str(path))
    back = RequestTrace.load(str(path))
    assert back == pt and back.max_seq_len() == jt.max_seq_len()
    assert [dataclasses.astuple(r) for r in back.sorted()] == \
        [dataclasses.astuple(r) for r in jt.sorted()]
