"""Port parity for serving the paper's tiny classifier: the streaming
decode step (`lstm_tiny.cache_shapes` / `init_cache` / `decode_step`),
its scan prefill and the port's `ServeEngine` on `paper-tinylstm`, on
the JAX package's own parameters, against the JAX package.

* Fed a whole sequence, the decode step reproduces `forward` (within
  1e-6, the JAX suite's tiny tolerance in tests/test_serve.py), and
  one step equals JAX's within 2e-5, inactive rows included.
* With the JAX engine's draws handed in (`JaxServeDraws`), the port's
  engine gives the JAX engine's tokens, TTFT cycles and, exactly, its
  bills, greedy and sampled; `kv="paged"` degrades to dense.

The JAX engine runs on the CPU as tests/test_serve.py runs it; the
port runs its plain ops (CPU tensors)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _jax_keys import JaxServeDraws
from repro.configs import get_arch as jax_arch
from repro.models import api as JM
from repro.nn import init_params as jax_init
from repro.schemes.radio import Radio as JRadio
from repro.serve import Request as JRequest
from repro.serve import RequestTrace as JRequestTrace
from repro.serve import ServeEngine as JServeEngine
from repro_torch.configs import ShapeConfig, get_arch
from repro_torch.models import api as M
from repro_torch.models import lstm_tiny as LT
from repro_torch.nn import params_from_jax
from repro_torch.runtime.serve_step import make_prefill_step
from repro_torch.schemes.radio import Radio
from repro_torch.serve import Request, RequestTrace, ServeEngine

JCFG, CFG = jax_arch("paper-tinylstm"), get_arch("paper-tinylstm")
TOL = 2e-5
# bounded ARQ that erases whole rows, as tests/test_torch_serve.py's
LINK = dict(snr_db=10.0, fading=True, arq_max_tx=1, arq_attempts=1,
            arq_min_f2=0.4)
MODES = [("chunked", "paged"), ("chunked", "dense"), ("token", "paged"),
         ("token", "dense")]


@pytest.fixture(scope="module")
def params():
    jp = jax_init(jax.random.PRNGKey(0), JM.param_specs(JCFG))
    return jp, params_from_jax(jax.tree.map(np.asarray, jp), CFG, "cpu")


def _tokens(seed, shape):
    return np.random.default_rng(seed).integers(
        1, CFG.vocab_size, shape).astype(np.int32)


# ------------------------------------------------------------ the step
def test_cache_layout_batch_axis_0():
    shapes = LT.cache_shapes(CFG, 5, 30)
    assert {k: (sh, ax) for k, (sh, ax, dt) in shapes.items()} == {
        "emb": ((5, 2, 8), ("batch", None, None)),
        "pend": ((5, 32), ("batch", None)),
        "h": ((5, 32), ("batch", None)), "c": ((5, 32), ("batch", None))}
    jshapes = JM.get_model(JCFG).cache_shapes(JCFG, 5, 30)
    assert {k: (sh, ax) for k, (sh, ax, dt) in jshapes.items()} == \
        {k: (sh, ax) for k, (sh, ax, dt) in shapes.items()}
    cache = LT.init_cache(CFG, 5, 30, "cpu")
    assert all(v.dtype == torch.float32 and not v.any()
               for v in cache.values())


def test_decode_reproduces_forward(params):
    """Slots at different depths (the per-slot index vector): each row's
    streaming logit after its 30th token equals `forward`'s
    (tests/test_serve.py's check, on the port)."""
    _, pp = params
    model = M.get_model(CFG)
    B, S = 4, 30
    tokens = _tokens(1, (B, S))
    ref, _ = model.forward(pp, {"tokens": torch.from_numpy(tokens)}, CFG)
    cache = model.init_cache(CFG, B, S, "cpu")
    offs = np.arange(B) % 3
    pos = -offs.copy()
    got = np.zeros((B, S), np.float32)
    with torch.no_grad():
        for _ in range(S + offs.max()):
            idx = np.maximum(pos, 0).astype(np.int32)
            tk = np.array([tokens[b, min(max(pos[b], 0), S - 1)]
                           for b in range(B)], np.int32)[:, None]
            act = (pos >= 0) & (pos < S)
            lg, cache = model.decode_step(
                pp, cache, torch.from_numpy(tk), torch.from_numpy(idx), CFG,
                active=torch.from_numpy(act))
            for b in range(B):
                if 0 <= pos[b] < S:
                    got[b, pos[b]] = float(lg[b, 0, 1])
            pos += 1
    np.testing.assert_allclose(got[:, -1], ref[:, 0].numpy(), rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize("with_inactive", [False, True])
def test_decode_step_matches_jax(params, with_inactive):
    """Eight steps of the port's step against JAX's (which writes every
    row; the JAX engine keeps inactive rows by a batch select after
    it): logits and every cache leaf within 2e-5."""
    jp, pp = params
    jmodel = JM.get_model(JCFG)
    B, steps = 5, 8
    tokens = _tokens(2, (B, steps))
    jcache = jmodel.init_cache(JCFG, B, 30)
    cache = LT.init_cache(CFG, B, 30, "cpu")
    idx = np.array([0, 3, 1, 7, 2], np.int32)
    rng = np.random.default_rng(3)
    for t in range(steps):
        act = rng.random(B) < 0.6 if with_inactive else np.ones(B, bool)
        tok = tokens[:, t:t + 1]
        jl, jnew = jmodel.decode_step(jp, jcache, jnp.asarray(tok),
                                      jnp.asarray(idx), JCFG, 0)
        m = jnp.asarray(act)
        jcache = {k: jnp.where(m.reshape((-1,) + (1,) * (v.ndim - 1)), v,
                               jcache[k]) for k, v in jnew.items()}
        with torch.no_grad():
            lg, cache = LT.decode_step(
                pp, cache, torch.from_numpy(tok), torch.from_numpy(idx),
                CFG, active=torch.from_numpy(act) if with_inactive
                else None)
        np.testing.assert_allclose(lg.numpy(), np.asarray(jl), rtol=0,
                                   atol=TOL)
        for k in jcache:
            np.testing.assert_allclose(cache[k].numpy(),
                                       np.asarray(jcache[k]), rtol=0,
                                       atol=TOL)
        idx = idx + act


def test_scan_prefill_equals_token_steps(params):
    """The scan prefill over a tiny cache (batch axis 0) gives, bit for
    bit, the cache and last-valid logits of feeding the chunk through
    the decode step with the engine's row masking (staggered starts,
    ragged n_valid; tests/test_serve.py's check)."""
    _, pp = params
    B, S, C = 4, 32, 8
    tokens = torch.from_numpy(_tokens(5, (B, C)))
    start = torch.tensor([0, 3, 9, 17], dtype=torch.int32)
    n_valid = torch.tensor([8, 1, 0, 5], dtype=torch.int32)
    prefill = make_prefill_step(CFG, ShapeConfig("serve", S, B, "decode"),
                                "auto", "cpu")
    with torch.no_grad():
        cache_a = LT.init_cache(CFG, B, S, "cpu")
        lg_a, cache_a = prefill(pp, cache_a, tokens, start, n_valid)
        cache_b = LT.init_cache(CFG, B, S, "cpu")
        lg_b = torch.zeros((B, 2))
        for i in range(C):
            act = i < n_valid
            lg, cache_b = LT.decode_step(pp, cache_b, tokens[:, i:i + 1],
                                         start + i, CFG, active=act)
            lg_b = torch.where((n_valid - 1 == i)[:, None], lg[:, 0], lg_b)
    assert lg_a.shape == (B, 2) and torch.equal(lg_a, lg_b)
    assert all(torch.equal(cache_a[k], cache_b[k]) for k in cache_a)
    assert not cache_a["emb"][2].any()        # n_valid 0: untouched


# ------------------------------------------------------------- engine
def _trace(cls_req, cls_trace):
    """30-token prompts (the corpus' padded length) and one class each,
    four for every third request so generated tokens are fed back;
    arrivals staggered."""
    return cls_trace(seed=11, requests=tuple(
        cls_req(rid=i, arrival_cycle=[0, 0, 1, 2, 4, 4, 9, 10][i],
                prompt_len=30 if i != 5 else 17,
                max_new_tokens=4 if i % 3 == 2 else 1,
                snr_db=[18.0, 6.0, 12.0, 25.0, 9.0, 15.0, 3.0, 20.0][i])
        for i in range(8)))


def _rows(rep):
    return [(r.rid, r.status, r.tokens, r.prompt_len, r.admit_cycle,
             r.first_token_cycle, r.ttft_cycles, r.complete_cycle,
             r.latency_cycles, r.uplink_bits, r.downlink_bits, r.bits,
             r.erased_bits, r.energy_j, r.n_tx, r.outage_s)
            for r in rep.results]


@pytest.mark.parametrize("greedy", [True, False], ids=["greedy", "sampled"])
def test_engine_matches_jax(params, greedy):
    """The JAX engine (paged asked for, served dense) and the port in all
    four prefill x kv modes on one trace, the port fed the JAX engine's
    draws: the same tokens, cycles and exactly the same bills."""
    jp, pp = params
    ekw = dict(n_slots=3, temperature=0.8, greedy=greedy, chunk_size=16,
               page_size=8)
    jrep = JServeEngine(JCFG, jp, radio=JRadio(**LINK), **ekw).serve(
        _trace(JRequest, JRequestTrace))
    assert jrep.kv == "dense"
    assert {r.status for r in jrep.results} >= {"ok", "uplink_erased"}
    assert all(t in (0, 1) for r in jrep.results for t in r.tokens)
    for pf, kv in MODES:
        rep = ServeEngine(CFG, pp, radio=Radio(**LINK), prefill=pf, kv=kv,
                          device="cpu", draws=JaxServeDraws, **ekw).serve(
                              _trace(Request, RequestTrace))
        assert (rep.prefill, rep.kv) == (pf, "dense")
        got, ref = _rows(rep), _rows(jrep)
        if pf == "token":          # token admission: more cycles, same
            got = [g[:4] + g[9:] for g in got]      # tokens and bills
            ref = [r[:4] + r[9:] for r in ref]
        else:
            assert rep.cycles == jrep.cycles
        assert got == ref, (pf, kv)


def test_engine_clears_a_slot_on_its_batch_axis(params):
    """A freed slot is zeroed on axis 0 of every tiny leaf, and only that
    row; a request served after another on one slot gets the class it
    gets alone."""
    _, pp = params
    eng = ServeEngine(CFG, pp, n_slots=2, greedy=True, device="cpu")
    built = eng.build(30)
    cache = built["new_cache"]()
    for v in cache.values():
        v.fill_(1.0)
    built["clear"](cache, 1, None)
    assert all(v[0].all() and not v[1].any() for v in cache.values())
    one = ServeEngine(CFG, pp, n_slots=1, greedy=True, device="cpu")
    alone = one.serve(RequestTrace(3, (Request(0, 0, 30, 1, 20.0),)))
    after = one.serve(RequestTrace(3, (Request(1, 0, 30, 1, 20.0),
                                       Request(0, 1, 30, 1, 20.0))))
    b = [r for r in after.results if r.rid == 0][0]
    assert alone.results[0].tokens == b.tokens
    assert alone.results[0].bits == b.bits


def test_launch_serve_tiny_runs_on_cpu_when_asked(capsys):
    from repro_torch.launch import serve
    r = serve.main(["--arch", "paper-tinylstm", "--device", "cpu",
                    "--requests", "6", "--snr-db", "8", "--greedy",
                    "--new-tokens", "1", "--batch", "4"])
    out = capsys.readouterr().out
    assert r["report"]["kv"] == "dense" and "ttft p50" in out
    assert r["generated"].shape == (6, 1)
    assert set(np.unique(r["generated"])) <= {0, 1}

