"""Port parity for the MoE family (models/moe.py and the transformer's
expert blocks): qwen3-moe-235b-a22b and llama4-scout-17b-a16e at
`reduced()` (2 layers, d_model 256, 4 experts, top-2 / top-1 with the
shared expert, f32) on the JAX package's own parameters, against the
live JAX functions on the CPU.

Routing is compared first: the expert ids of every (token, choice) must
equal JAX's, except where JAX's two swapped choices lie within NEAR_TIE
in probability (an f32 ulp in the router can swap them; none does on
these inputs, and any that did is reported). Outputs, logits and caches
within 2e-4 (the JAX suite's attention tolerance); bills exactly.
Capacity makes a result depend on which tokens share a call, so every
engine comparison names one prefill implementation on both sides."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _jax_keys import JaxKey, JaxServeDraws, port_train_state
from repro.configs import get_arch as jax_arch
from repro.configs.base import ShapeConfig as JShape
from repro.configs.base import WirelessConfig as JW
from repro.core import split as JSPLIT
from repro.models import api as JM
from repro.models import moe as JMOE
from repro.models import transformer as JT
from repro.nn import init_params as jax_init
from repro.runtime import train_step as JTS
from repro.schemes import Experiment as JExperiment
from repro.schemes import build_scheme as j_build_scheme
from repro.schemes.radio import Radio as JRadio
from repro.serve import Request as JRequest
from repro.serve import RequestTrace as JRequestTrace
from repro.serve import ServeEngine as JServeEngine
from repro_torch.configs import ShapeConfig, WirelessConfig, get_arch
from repro_torch.core import federated as FED
from repro_torch.core import split as SPLIT
from repro_torch.models import api as M
from repro_torch.models import moe as MOE
from repro_torch.models import transformer as T
from repro_torch.nn import params_from_jax, tree_leaves
from repro_torch.runtime import train_step as TS
from repro_torch.schemes import Experiment, build_scheme
from repro_torch.schemes.radio import Radio
from repro_torch.serve import Request, RequestTrace, ServeEngine

TOL = 2e-4
LOSS_TOL = 1e-4
# two experts whose router probabilities lie this close may swap places
# between the two libraries (an f32 ulp or two of the softmax)
NEAR_TIE = 1e-6
ARCHS = ("qwen3-moe-235b-a22b", "llama4-scout-17b-a16e")
PAGE = 8


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(name, **kw):
    return (dataclasses.replace(jax_arch(name).reduced(), **kw),
            dataclasses.replace(get_arch(name).reduced(), **kw))


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module", params=ARCHS)
def model(request):
    """(JAX cfg, port cfg, JAX params, port serving params) of one
    reduced MoE config; norm scales and biases made non-trivial."""
    jcfg, cfg = _cfgs(request.param)
    jp = jax_init(jax.random.PRNGKey(0), JM.param_specs(jcfg))
    leaves, tdef = jax.tree.flatten(jp)
    rng = np.random.default_rng(0)
    leaves = [l + 0.05 * rng.standard_normal(l.shape).astype(np.float32)
              for l in leaves]
    jp = jax.tree.unflatten(tdef, [jnp.asarray(l) for l in leaves])
    return jcfg, cfg, jp, params_from_jax(jax.tree.map(np.asarray, jp), cfg,
                                          "cpu")


def _same_routing(tidx, jidx, jprobs):
    """Port expert ids [T, k] equal JAX's, or each differing pair lies
    within NEAR_TIE of JAX's probability for the port's choice."""
    tidx, jidx, jprobs = (np.asarray(a) for a in (tidx, jidx, jprobs))
    bad = np.argwhere(tidx != jidx)
    gaps = [float(jprobs[t, jidx[t, c]] - jprobs[t, tidx[t, c]])
            for t, c in bad]
    assert all(abs(g) < NEAR_TIE for g in gaps), (
        f"routing differs at {bad.tolist()}, probability gaps {gaps}")
    return len(gaps)


# ------------------------------------------------------------ the layer
@pytest.mark.parametrize("name", ARCHS)
def test_capacity_and_chunk_match_jax(name):
    jcfg, cfg = _cfgs(name)
    for T_, f, chunk in ((1, 1.25, 0), (8, 1.25, 0), (64, 1.25, 32),
                         (100, 0.25, 7), (4096, 1.25, 0), (7, 8.0, 3)):
        jc = dataclasses.replace(jcfg, capacity_factor=f, moe_chunk=chunk)
        c = dataclasses.replace(cfg, capacity_factor=f, moe_chunk=chunk)
        assert MOE.capacity(T_, c) == JMOE.capacity(T_, jc)
        assert MOE.capacity(T_, c) % 8 == 0 and MOE.capacity(T_, c) >= 8
        assert MOE.auto_chunk(T_, c) == JMOE.auto_chunk(T_, jc)
    assert MOE.EP_MIN_TOKENS == JMOE.EP_MIN_TOKENS


@pytest.mark.parametrize("factor", [1.25, 0.25])
@pytest.mark.parametrize("name", ARCHS)
def test_moe_core_matches_jax(name, factor):
    """Routing ids equal, output and aux within 2e-4, at the config's
    capacity factor and at 0.25 (drops)."""
    jcfg, cfg = _cfgs(name, capacity_factor=factor)
    jp = jax_init(jax.random.PRNGKey(1), JMOE.moe_specs(jcfg))
    pp = params_from_jax(jax.tree.map(np.asarray, jp), None, "cpu")
    x = np.random.default_rng(2).standard_normal((96, cfg.d_model)).astype(
        np.float32)
    jy, jaux = JMOE._moe_core(jp, jnp.asarray(x), jcfg)
    y, aux = MOE._moe_core(pp, _t(x), cfg)
    jlogits = np.asarray(x) @ np.asarray(jp["router"]["w"])
    jprobs = jax.nn.softmax(jnp.asarray(jlogits), -1)
    _, jidx = jax.lax.top_k(jprobs, cfg.top_k)
    _same_routing(MOE.route(pp, _t(x), cfg)[2], jidx, jprobs)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=TOL, atol=TOL)
    for k in ("lb_loss", "dropped_frac"):
        np.testing.assert_allclose(float(aux[k]), float(jaux[k]), rtol=TOL,
                                   atol=TOL, err_msg=k)
    if factor < 1:
        assert float(aux["dropped_frac"]) > 0


def test_top_k_ties_go_to_the_lower_index():
    """Exact ties: the lower expert index first, as jax.lax.top_k."""
    probs = np.array([[0.25, 0.25, 0.25, 0.25],
                      [0.1, 0.3, 0.3, 0.3],
                      [0.4, 0.1, 0.4, 0.1],
                      [0.0, 0.5, 0.0, 0.5]], np.float32)
    for k in (1, 2, 3):
        jv, ji = jax.lax.top_k(jnp.asarray(probs), k)
        v, i = MOE.top_k_lower_first(_t(probs), k)
        np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
        np.testing.assert_array_equal(v.numpy(), np.asarray(jv))
    # through the router: a zero router gives uniform probabilities
    jcfg, cfg = _cfgs("qwen3-moe-235b-a22b")
    jp = jax_init(jax.random.PRNGKey(0), JMOE.moe_specs(jcfg))
    jp = dict(jp, router={"w": jnp.zeros_like(jp["router"]["w"])})
    pp = params_from_jax(jax.tree.map(np.asarray, jp), None, "cpu")
    x = np.random.default_rng(0).standard_normal((16, 256)).astype(
        np.float32)
    _, _, idx = MOE.route(pp, _t(x), cfg)
    assert (idx.numpy() == np.arange(cfg.top_k)).all()
    jy, _ = JMOE._moe_core(jp, jnp.asarray(x), jcfg)
    y, _ = MOE._moe_core(pp, _t(x), cfg)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=TOL, atol=TOL)


def test_chunked_equals_unchunked_and_capacity_drops():
    """tests/test_models.py's MoE checks on the port: chunking is exact
    without drops (capacity factor 8), a factor of 0.25 drops tokens,
    and the Switch loss is >= 0.9; chunked and per-chunk aux are means."""
    jcfg, cfg = _cfgs("qwen3-moe-235b-a22b", capacity_factor=8.0)
    pp = params_from_jax(jax.tree.map(np.asarray, jax_init(
        jax.random.PRNGKey(0), JMOE.moe_specs(jcfg))), None, "cpu")
    x = _t(np.random.default_rng(1).standard_normal(
        (2, 64, cfg.d_model)).astype(np.float32))
    y_full, a_full = MOE.apply_moe(pp, x, dataclasses.replace(
        cfg, moe_chunk=128))
    y_chunk, a_chunk = MOE.apply_moe(pp, x, dataclasses.replace(
        cfg, moe_chunk=32))
    np.testing.assert_allclose(y_full.numpy(), y_chunk.numpy(), rtol=TOL,
                               atol=TOL)
    assert float(a_full["dropped_frac"]) == float(a_chunk["dropped_frac"])\
        == 0.0
    parts = [MOE._moe_core(pp, c, cfg)[1]["lb_loss"]
             for c in x.reshape(128, -1).split(32)]
    np.testing.assert_allclose(float(a_chunk["lb_loss"]),
                               float(torch.stack(parts).mean()), rtol=1e-6)
    _, aux = MOE.apply_moe(pp, x, dataclasses.replace(cfg,
                                                      capacity_factor=0.25))
    assert float(aux["dropped_frac"]) > 0
    _, aux = MOE.apply_moe(pp, x, dataclasses.replace(cfg,
                                                      capacity_factor=1.25))
    assert float(aux["lb_loss"]) >= 0.9


@pytest.mark.parametrize("chunk", [0, 16])
def test_apply_moe_matches_jax_chunked(model, chunk):
    """`apply_moe` (one call, or chunks of 16 tokens with per-chunk
    capacity) against JAX's, shared expert included; the one call at
    capacity factor 0.5 drops."""
    jcfg, cfg, _, _ = model
    jcfg = dataclasses.replace(jcfg, moe_chunk=chunk, capacity_factor=0.5)
    cfg = dataclasses.replace(cfg, moe_chunk=chunk, capacity_factor=0.5)
    jp = jax_init(jax.random.PRNGKey(3), JMOE.moe_specs(jcfg))
    pp = params_from_jax(jax.tree.map(np.asarray, jp), None, "cpu")
    x = np.random.default_rng(4).standard_normal((2, 32, 256)).astype(
        np.float32)
    jy, jaux = JMOE.apply_moe(jp, jnp.asarray(x), jcfg)
    y, aux = MOE.apply_moe(pp, _t(x), cfg)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=TOL, atol=TOL)
    for k in ("lb_loss", "dropped_frac"):
        np.testing.assert_allclose(float(aux[k]), float(jaux[k]), rtol=TOL,
                                   atol=TOL, err_msg=k)
    if chunk == 0:
        assert float(aux["dropped_frac"]) > 0


# ------------------------------------------------------------- the model
def test_specs_and_leaves_are_jaxs(model):
    """Block specs hold `moe` (router, wi / wg / wo [E, d, ff], shared);
    the training tree's leaves are JAX's in JAX's (sorted-key) order, so
    the wire's packets are JAX's."""
    jcfg, cfg, _, params = model
    want = jax.tree_util.tree_flatten_with_path(JM.param_specs(jcfg))[0]
    got = tree_leaves(M.train_param_specs(cfg))
    assert [tuple(s.shape) for s in got] == [tuple(s.shape) for _, s in want]
    names = ["/".join(str(getattr(p, "key", p)) for p in path)
             for path, _ in want]
    assert "layers/moe/wi" in names and "layers/moe/router/w" in names
    assert ("layers/moe/shared/wi/w" in names) == cfg.shared_expert
    lp = params["layers"][0]["moe"]
    assert tuple(lp["wi"].shape) == (cfg.n_experts, 256, cfg.expert_ff)
    assert "mlp" not in params["layers"][0]


def test_forward_matches_jax(model):
    """Teacher-forced forward at T = 2 x 24 (capacity 16 per expert of
    4 at top-2: drops), logits and aux_loss."""
    jcfg, cfg, jp, params = model
    tokens = np.random.default_rng(1).integers(1, cfg.vocab_size, (2, 24),
                                               dtype=np.int32)
    ref, jaux = JT.forward(jp, {"tokens": jnp.asarray(tokens)}, jcfg, 0)
    got, aux = T.forward(params, {"tokens": _t(tokens)}, cfg, 0)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=TOL,
                               atol=TOL)
    np.testing.assert_allclose(float(aux["aux_loss"]),
                               float(jaux["aux_loss"]), rtol=TOL, atol=TOL)
    assert float(aux["aux_loss"]) > 0


@pytest.mark.parametrize("kv", ["dense", "paged"])
def test_decode_and_fused_prefill_match_jax(model, kv):
    """A fused prefill chunk (staggered starts, ragged n_valid, one row
    inactive) then decode steps with an inactive row: last-valid logits
    and the caches after each call."""
    jcfg, cfg, jp, params = model
    B, S, C = 4, 32, 8
    n_lp = S // PAGE
    tables = np.arange(B * n_lp, dtype=np.int32)[::-1].reshape(B, n_lp)
    rng = np.random.default_rng(3)
    if kv == "dense":
        jc, pc = JT.init_cache(jcfg, B, S), T.init_cache(cfg, B, S, "cpu")
        jpg = ppg = None
    else:
        jc = JT.init_paged_cache(jcfg, B * n_lp, PAGE)
        pc = T.init_paged_cache(cfg, B * n_lp, PAGE, "cpu")
        jpg = {"tables": jnp.asarray(tables), "page_size": PAGE,
               "active": None}
        ppg = {"tables": _t(tables.copy()), "page_size": PAGE,
               "active": None}
    tokens = rng.integers(1, cfg.vocab_size, (B, C), dtype=np.int32)
    start = np.array([0, 3, 9, 17], np.int32)
    n_valid = np.array([8, 1, 0, 5], np.int32)
    jl, jc = JT.prefill_step(jp, jc, jnp.asarray(tokens), jnp.asarray(start),
                             jnp.asarray(n_valid), jcfg, 0, pages=jpg)
    pl, pc = T.prefill_step(params, pc, _t(tokens), _t(start), _t(n_valid),
                            cfg, 0, pages=ppg)
    rows = n_valid > 0
    np.testing.assert_allclose(pl.numpy()[rows], np.asarray(jl)[rows],
                               rtol=TOL, atol=TOL)
    for k in ("k", "v"):
        np.testing.assert_allclose(pc[k].numpy(), np.asarray(jc[k]),
                                   rtol=TOL, atol=TOL, err_msg=k)
    pos = start + n_valid
    for step in range(3):
        tok = rng.integers(1, cfg.vocab_size, (B, 1), dtype=np.int32)
        active = np.array([True, step % 2 == 0, False, True])
        if kv == "dense":
            jl, jn = JT.decode_step(jp, jc, jnp.asarray(tok),
                                    jnp.asarray(pos), jcfg, 0)
            m = jnp.asarray(active)[None, :, None, None, None]
            jc = {k: jnp.where(m, jn[k], jc[k]) for k in jc}
            pl, _ = T.decode_step(params, pc, _t(tok), _t(pos), cfg, 0,
                                  active=_t(active))
        else:
            jl, jc = JT.decode_step(jp, jc, jnp.asarray(tok),
                                    jnp.asarray(pos), jcfg, 0,
                                    pages=dict(jpg, active=jnp.asarray(
                                        active)))
            pl, _ = T.decode_step(params, pc, _t(tok), _t(pos), cfg, 0,
                                  pages=dict(ppg, active=_t(active)))
        np.testing.assert_allclose(pl.numpy()[active],
                                   np.asarray(jl)[active], rtol=TOL,
                                   atol=TOL)
        for k in ("k", "v"):
            np.testing.assert_allclose(pc[k].numpy(), np.asarray(jc[k]),
                                       rtol=TOL, atol=TOL, err_msg=k)
        pos = pos + active


# -------------------------------------------------------------- training
JSHAPE = JShape("t", 16, 4, "train", microbatch=4)
SHAPE = ShapeConfig("t", 16, 4, "train", microbatch=4)


def _batch(cfg, seed):
    x = np.random.default_rng(seed).integers(1, cfg.vocab_size, (4, 16),
                                             dtype=np.int32)
    return {"tokens": x, "labels": x}


def _tb(b):
    return {k: _t(v) for k, v in b.items()}


@pytest.mark.parametrize("name", ARCHS)
def test_adamw_train_step_matches_jax(name):
    """Gradients of `_loss` (the lb loss at MOE_AUX_COEF included) within
    2e-5 of `jax.grad`, under remat too; the losses and aux of 2 AdamW
    steps within 1e-4."""
    jcfg, cfg = _cfgs(name)
    js = JTS.init_train_state(jax.random.PRNGKey(0), jcfg, None, "adamw")
    st = port_train_state(js)
    b = _batch(cfg, 5)
    key = jax.random.PRNGKey(9)
    jg = jax.grad(lambda t: JTS._loss(t, b, jcfg, None, key, 0)[0])(
        js.trainable)
    for remat in (False, True):
        m, pg = TS.value_and_grad(st.trainable, _tb(b),
                                  dataclasses.replace(cfg, remat=remat),
                                  None, JaxKey(key))
        for a, w in zip(tree_leaves(pg), jax.tree.leaves(jg)):
            np.testing.assert_allclose(a.numpy(), np.asarray(w), rtol=2e-5,
                                       atol=2e-5)
    assert float(m["aux_loss"]) > 0
    jstep = jax.jit(JTS.make_train_step(jcfg, JSHAPE, None))
    step = TS.make_train_step(cfg, SHAPE, None)
    for s in range(2):
        b = _batch(cfg, 20 + s)
        js, jm = jstep(js, b, jax.random.fold_in(key, s))
        st, m = step(st, _tb(b), JaxKey(key).fold_in(s))
        for k in ("loss", "aux_loss"):
            np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=0,
                                       atol=LOSS_TOL, err_msg=k)


def test_split_at_a_layer_matches_jax():
    """The split forward (cut at layer 1 of 2, a perfect Q16 link): the
    aux loss adds up over the user's and the server's blocks; logits and
    aux against JAX's `split_forward`."""
    jcfg, cfg = _cfgs("qwen3-moe-235b-a22b")
    kw = dict(mode="sl", quant_bits=16, perfect_channel=True, split_layer=1)
    jw, w = JW(**kw), WirelessConfig(**kw)
    js = JTS.init_train_state(jax.random.PRNGKey(2), jcfg, jw, "adamw")
    st = port_train_state(js)
    b = _batch(cfg, 7)
    key = jax.random.PRNGKey(4)
    jl, jaux = JSPLIT.split_forward(js.trainable["model"],
                                    js.trainable["codec"], b, jcfg, jw, key)
    pl, aux = SPLIT.split_forward(st.trainable["model"],
                                  st.trainable["codec"], _tb(b), cfg, w,
                                  JaxKey(key))
    np.testing.assert_allclose(pl.detach().numpy(), np.asarray(jl),
                               rtol=TOL, atol=TOL)
    np.testing.assert_allclose(float(aux["aux_loss"]),
                               float(jaux["aux_loss"]), rtol=TOL, atol=TOL)
    # both sides carry a share: the user's block alone gives part of it
    model = st.trainable["model"]
    x = T.embed_inputs(model, _tb(b), cfg)
    pos = torch.arange(16)[None].expand(4, 16)
    _, user = T.apply_blocks(T.layer_list(model["layers"])[:1], x, cfg, pos)
    assert 0 < float(user) < float(aux["aux_loss"]) * cfg.n_layers


def _on_init(jscheme, xtr, ytr):
    """`Experiment.on_init` handing the port the JAX scheme's weights."""
    def hook(state):
        jstate, _ = jscheme.init(0, xtr, ytr)
        train = jstate.train
        if jscheme.mode == "fl":
            st = train["state"] if isinstance(train, dict) else train
            one = port_train_state(jax.tree.map(lambda a: a[0], st))
            train = FED.broadcast_state(one, jscheme.n_users)
        else:
            train = port_train_state(train)
        return dataclasses.replace(state, train=train)
    return hook


@pytest.mark.parametrize("mode,kw", [
    ("cl", dict(snr_db=10.0)),
    ("fl", dict(quant_bits=8, local_steps=2)),
    ("sl", dict(quant_bits=16, perfect_channel=True))])
def test_scaled_schemes_match_live_jax(mode, kw):
    """One cycle of 2 steps of the scaled CL / FL / SL schemes through
    `Experiment` on JAX's initial weights and draws: bills exactly equal
    to the live JAX scheme's (one packet per leaf, the moe leaves too),
    loss within 1e-4, accuracy within 0.01."""
    jcfg, cfg = _cfgs("qwen3-moe-235b-a22b", remat=False)
    jw, w = JW(mode=mode, **kw), WirelessConfig(mode=mode, **kw)
    jscheme = j_build_scheme(jw, cfg=jcfg, shape=JSHAPE, steps_per_cycle=2)
    jexp = JExperiment(jscheme, cycles=1, seed=0, n_train=32, n_test=8)
    jres = jexp.run()
    scheme = build_scheme(w, cfg=cfg, shape=SHAPE, device="cpu",
                          key=JaxKey.root, steps_per_cycle=2)
    (xtr, ytr), _ = scheme.default_data(32, 8, 0)
    exp = Experiment(scheme, cycles=1, seed=0, n_train=32, n_test=8,
                     on_init=_on_init(j_build_scheme(
                         jw, cfg=jcfg, shape=JSHAPE, steps_per_cycle=2),
                         xtr, ytr))
    res = exp.run()
    for r, jr in zip(exp.reports, jexp.reports):
        assert (r.bits, r.n_tx, r.erased_bits, r.outage_s, r.steps,
                r.energy_j) == (jr.bits, jr.n_tx, jr.erased_bits,
                                jr.outage_s, jr.steps, jr.energy_j)
    assert res.total_bits == jres.total_bits > 0
    np.testing.assert_allclose(res.loss, jres.loss, rtol=0, atol=LOSS_TOL)
    np.testing.assert_allclose(res.accuracy, jres.accuracy, rtol=0,
                               atol=0.01)
    pf, jf = scheme._step_cost_flops(), jscheme._step_cost_flops()
    if mode != "fl":
        assert 0.5 <= pf / jf <= 2.0, (pf, jf)
    print(f"{mode}: FLOPs per step, port FlopCounterMode {pf:.0f}, JAX "
          f"XLA {jf:.0f}")


# --------------------------------------------------------------- serving
def _trace(cls_req, cls_trace):
    """Six requests on 4 slots: prompts over one chunk and below the
    bucket floor, staggered arrivals, so prefills and decodes share
    cycles and idle rows enter the fused chunks."""
    return cls_trace(seed=3, requests=tuple(
        cls_req(rid=i, arrival_cycle=[0, 0, 1, 2, 6, 8][i],
                prompt_len=[40, 3, 17, 24, 5, 33][i],
                max_new_tokens=[5, 7, 3, 4, 6, 3][i],
                snr_db=[18.0, 6.0, 12.0, 25.0, 9.0, 15.0][i])
        for i in range(6)))


def _rows(rep):
    return [(r.rid, r.status, r.tokens, r.admit_cycle, r.first_token_cycle,
             r.complete_cycle, r.bits, r.erased_bits, r.energy_j, r.n_tx)
            for r in rep.results]


@pytest.mark.parametrize("impl", ["fused", "scan"])
def test_engine_matches_jax_engine(model, impl, monkeypatch):
    """The engine, greedy, with the JAX engine's draws through the seams
    and one prefill implementation named on both sides (`impl`; fused
    routes whole [B, C] chunks, so capacity competes across slots and
    padded tails; scan routes B tokens a step and cannot drop): the JAX
    engine's tokens, cycles and bills, paged and dense."""
    jcfg, cfg, jp, params = model
    monkeypatch.setenv("REPRO_PREFILL_IMPL", impl)
    link = dict(snr_db=12.0, fading=True)
    ekw = dict(n_slots=4, greedy=True, chunk_size=16, page_size=PAGE)
    jrep = JServeEngine(jcfg, jp, radio=JRadio(**link), **ekw).serve(
        _trace(JRequest, JRequestTrace))
    assert jrep.generated_tokens > 0
    for kv in ("paged", "dense"):
        rep = ServeEngine(cfg, params, radio=Radio(**link), kv=kv,
                          prefill_impl=impl, device="cpu",
                          draws=JaxServeDraws, **ekw).serve(
                              _trace(Request, RequestTrace))
        assert rep.kv == kv
        assert _rows(rep) == _rows(jrep), kv
