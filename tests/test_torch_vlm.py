"""Port parity for the vlm family: internvl2-76b at `reduced()` (2
layers, d_model 256, 4 heads at hd 64, 16 stub patch tokens, f32) on the
JAX package's own parameters, against the live JAX functions on the CPU.

The vision tower is a stub in both packages: a batch's `patch_embeds`
[B, P, d_model] are projected by `vis_proj` and put before the tokens.
Serving runs on tokens only (the JAX engine passes no patches), so the
engine is held to the JAX engine exactly as for the dense family.
Logits within 2e-4 (the JAX suite's attention tolerance), gradients
within 2e-5; bills exactly; the scheme losses within 1e-4 (SL at Q16
over a perfect link, as tests/test_torch_scaled_schemes.py holds it)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _jax_keys import (JaxKey, JaxServeDraws, port_train_state,
                       scaled_on_init)
from repro.configs import get_arch as jax_arch
from repro.configs.base import ShapeConfig as JShape
from repro.configs.base import WirelessConfig as JW
from repro.core import split as JSPLIT
from repro.data import pipeline as JP
from repro.models import api as JM
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
from repro_torch.core import split as SPLIT
from repro_torch.data import pipeline as P
from repro_torch.models import api as M
from repro_torch.models import transformer as T
from repro_torch.nn import params_from_jax, tree_leaves
from repro_torch.runtime import train_step as TS
from repro_torch.schemes import Experiment, build_scheme
from repro_torch.schemes.radio import Radio
from repro_torch.serve import Request, RequestTrace, ServeEngine

NAME = "internvl2-76b"
TOL, GRAD_TOL, LOSS_TOL = 2e-4, 2e-5, 1e-4
PAGE = 8
JSHAPE = JShape("t", 16, 4, "train", microbatch=4)
SHAPE = ShapeConfig("t", 16, 4, "train", microbatch=4)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(**kw):
    return (dataclasses.replace(jax_arch(NAME).reduced(), **kw),
            dataclasses.replace(get_arch(NAME).reduced(), **kw))


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def model():
    """(JAX cfg, port cfg, JAX params, port serving params); norm scales
    made non-trivial."""
    jcfg, cfg = _cfgs()
    jp = jax_init(jax.random.PRNGKey(0), JM.param_specs(jcfg))
    leaves, tdef = jax.tree.flatten(jp)
    rng = np.random.default_rng(0)
    leaves = [l + 0.05 * rng.standard_normal(l.shape).astype(np.float32)
              for l in leaves]
    jp = jax.tree.unflatten(tdef, [jnp.asarray(l) for l in leaves])
    return jcfg, cfg, jp, params_from_jax(jax.tree.map(np.asarray, jp), cfg,
                                          "cpu")


def _batch(cfg, seed, B=4, S=16):
    rng = np.random.default_rng(seed)
    x = rng.integers(1, cfg.vocab_size, (B, S), dtype=np.int32)
    pe = (0.1 * rng.standard_normal((B, cfg.n_frontend_tokens,
                                     cfg.d_model))).astype(np.float32)
    return {"tokens": x, "labels": x, "patch_embeds": pe}


def _tb(b):
    return {k: _t(v) for k, v in b.items()}


# ------------------------------------------------------------- the model
def test_config_specs_and_inputs_are_jaxs(model):
    """`vis_proj` in both layouts, the trainable leaves JAX's in JAX's
    order (the FL packets), `patch_embeds` in the step inputs."""
    jcfg, cfg, _, params = model
    assert (cfg.family, cfg.frontend, cfg.n_frontend_tokens) == \
        ("vlm", "vision", 16)
    want = jax.tree_util.tree_flatten_with_path(JM.param_specs(jcfg))[0]
    got = tree_leaves(M.train_param_specs(cfg))
    assert [tuple(s.shape) for s in got] == [tuple(s.shape) for _, s in want]
    names = ["/".join(str(getattr(p, "key", p)) for p in path)
             for path, _ in want]
    assert names[-1] == "vis_proj/w"
    assert tuple(params["vis_proj"]["w"].shape) == (256, 256)
    assert "vis_proj" in M.param_specs(cfg)
    js = JM.input_specs(jcfg, JShape("t", 16, 4, "train"))
    ps = M.input_specs(cfg, ShapeConfig("t", 16, 4, "train"))
    assert {k: (tuple(v.shape), str(v.dtype)) for k, v in js.items()} == \
        {k: (s, str(d).replace("torch.", "")) for k, (s, d) in ps.items()}


def test_embed_inputs_puts_projected_patches_first(model):
    jcfg, cfg, jp, params = model
    b = _batch(cfg, 1)
    ref = JT.embed_inputs(jp, {k: jnp.asarray(v) for k, v in b.items()},
                          jcfg)
    got = T.embed_inputs(params, _tb(b), cfg)
    assert got.shape == (4, 16 + 16, 256)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=TOL,
                               atol=TOL)
    tokens_only = T.embed_inputs(params, {"tokens": _t(b["tokens"])}, cfg)
    assert torch.equal(tokens_only, got[:, 16:])


def test_forward_with_patches_matches_jax(model):
    jcfg, cfg, jp, params = model
    b = _batch(cfg, 2)
    ref, _ = JT.forward(jp, {k: jnp.asarray(v) for k, v in b.items()},
                        jcfg, 0)
    got, aux = T.forward(params, _tb(b), cfg, 0)
    assert got.shape == (4, 32, cfg.vocab_size)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=TOL,
                               atol=TOL)
    assert float(aux["aux_loss"]) == 0.0


@pytest.mark.parametrize("kv", ["dense", "paged"])
def test_decode_and_fused_prefill_match_jax(model, kv):
    """Serving on tokens: a fused prefill chunk (staggered starts, ragged
    n_valid, one row idle) then decode steps with an inactive row;
    last-valid logits and the caches after each call."""
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
    pos = start + n_valid
    for step in range(2):
        tok = rng.integers(1, cfg.vocab_size, (B, 1), dtype=np.int32)
        active = np.array([True, step == 0, False, True])
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


def test_synthetic_lm_batches_are_byte_identical():
    """Tokens and patches from one numpy stream, batch after batch, at
    the reduced and the full width."""
    for jc, c in (_cfgs(), (jax_arch(NAME), get_arch(NAME))):
        n = 0
        for a, b in zip(P.synthetic_lm_batches(c, 2, 8, seed=1),
                        JP.synthetic_lm_batches(jc, 2, 8, seed=1)):
            assert sorted(a) == sorted(b) == ["labels", "patch_embeds",
                                              "tokens"]
            for k in a:
                assert a[k].dtype == b[k].dtype, k
                assert a[k].tobytes() == b[k].tobytes(), k
            n += 1
            if n == 2:
                break
        assert a["patch_embeds"].shape == (2, c.n_frontend_tokens,
                                           c.d_model)


# -------------------------------------------------------------- training
def test_adamw_train_step_with_patches_matches_jax():
    """Gradients (vis_proj's included) within 2e-5 of `jax.grad`, with and
    without remat; the loss of 2 AdamW steps within 1e-4."""
    jcfg, cfg = _cfgs()
    js = JTS.init_train_state(jax.random.PRNGKey(0), jcfg, None, "adamw")
    st = port_train_state(js)
    b = _batch(cfg, 5)
    key = jax.random.PRNGKey(9)
    jg = jax.grad(lambda t: JTS._loss(t, b, jcfg, None, key, 0)[0])(
        js.trainable)
    for remat in (False, True):
        _, pg = TS.value_and_grad(st.trainable, _tb(b),
                                  dataclasses.replace(cfg, remat=remat),
                                  None, JaxKey(key))
        for a, w in zip(tree_leaves(pg), jax.tree.leaves(jg)):
            np.testing.assert_allclose(a.numpy(), np.asarray(w),
                                       rtol=GRAD_TOL, atol=GRAD_TOL)
    assert float(tree_leaves(pg["model"]["vis_proj"])[0].abs().max()) > 0
    jstep = jax.jit(JTS.make_train_step(jcfg, JSHAPE, None))
    step = TS.make_train_step(cfg, SHAPE, None)
    for s in range(2):
        b = _batch(cfg, 20 + s)
        js, jm = jstep(js, b, jax.random.fold_in(key, s))
        st, m = step(st, _tb(b), JaxKey(key).fold_in(s))
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                                   rtol=0, atol=LOSS_TOL)


def test_split_with_patches_matches_jax():
    """The split forward cut at layer 1 over a perfect Q16 link: the
    crossing carries the patch positions too (crossing_elems counts
    them)."""
    jcfg, cfg = _cfgs()
    kw = dict(mode="sl", quant_bits=16, perfect_channel=True, split_layer=1)
    jw, w = JW(**kw), WirelessConfig(**kw)
    js = JTS.init_train_state(jax.random.PRNGKey(2), jcfg, jw, "adamw")
    st = port_train_state(js)
    b = _batch(cfg, 7)
    key = jax.random.PRNGKey(4)
    jl, _ = JSPLIT.split_forward(js.trainable["model"],
                                 js.trainable["codec"], b, jcfg, jw, key)
    pl, _ = SPLIT.split_forward(st.trainable["model"],
                                st.trainable["codec"], _tb(b), cfg, w,
                                JaxKey(key))
    np.testing.assert_allclose(pl.detach().numpy(), np.asarray(jl),
                               rtol=TOL, atol=TOL)
    assert SPLIT.crossing_elems(cfg, SHAPE, w) == \
        JSPLIT.crossing_elems(jcfg, JSHAPE, jw) == 4 * (16 + 16) * 64


@pytest.mark.parametrize("mode,kw", [
    ("cl", dict(snr_db=10.0)),
    ("fl", dict(quant_bits=8, local_steps=2)),
    ("sl", dict(quant_bits=16, perfect_channel=True))])
def test_scaled_schemes_match_live_jax(mode, kw):
    """One cycle of 2 steps of the scaled CL / FL / SL schemes through
    `Experiment` on JAX's initial weights and draws; the patches of each
    batch and eval slice come from the experiment's rng (eval: rng 999)
    on both sides: bills exactly equal to the live JAX scheme's (FL: one
    packet per leaf, vis_proj's too; SL: the patch positions cross),
    loss within 1e-4, accuracy within 0.01; the FLOPs of a CL / SL step
    within a factor of 2 of XLA's count."""
    jcfg, cfg = _cfgs(remat=False)
    jw, w = JW(mode=mode, **kw), WirelessConfig(mode=mode, **kw)
    jscheme = j_build_scheme(jw, cfg=jcfg, shape=JSHAPE, steps_per_cycle=2)
    jexp = JExperiment(jscheme, cycles=1, seed=0, n_train=32, n_test=8)
    jres = jexp.run()
    scheme = build_scheme(w, cfg=cfg, shape=SHAPE, device="cpu",
                          key=JaxKey.root, steps_per_cycle=2)
    (xtr, ytr), _ = scheme.default_data(32, 8, 0)
    exp = Experiment(scheme, cycles=1, seed=0, n_train=32, n_test=8,
                     on_init=scaled_on_init(j_build_scheme(
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
    if mode != "fl":
        pf, jf = scheme._step_cost_flops(), jscheme._step_cost_flops()
        assert 0.5 <= pf / jf <= 2.0, (pf, jf)


# --------------------------------------------------------------- serving
def _trace(cls_req, cls_trace):
    """Five requests on 4 slots: prompts over one chunk and below the
    bucket floor, staggered arrivals."""
    return cls_trace(seed=4, requests=tuple(
        cls_req(rid=i, arrival_cycle=[0, 0, 1, 3, 6][i],
                prompt_len=[40, 3, 17, 24, 9][i],
                max_new_tokens=[4, 6, 3, 5, 4][i],
                snr_db=[18.0, 6.0, 12.0, 25.0, 9.0][i])
        for i in range(5)))


def _rows(rep):
    return [(r.rid, r.status, r.tokens, r.admit_cycle, r.first_token_cycle,
             r.ttft_cycles, r.complete_cycle, r.bits, r.erased_bits,
             r.energy_j, r.n_tx) for r in rep.results]


def test_engine_matches_jax_engine(model, monkeypatch):
    """The engine serves the VLM on tokens, greedy, with the JAX engine's
    draws through the seams: the JAX engine's tokens, TTFT cycles and
    bills, paged and dense (the fused chunk prefill on both sides)."""
    jcfg, cfg, jp, params = model
    monkeypatch.setenv("REPRO_PREFILL_IMPL", "fused")
    link = dict(snr_db=12.0, fading=True)
    ekw = dict(n_slots=4, greedy=True, chunk_size=16, page_size=PAGE)
    jrep = JServeEngine(jcfg, jp, radio=JRadio(**link), **ekw).serve(
        _trace(JRequest, JRequestTrace))
    assert jrep.generated_tokens > 0
    for kv in ("paged", "dense"):
        rep = ServeEngine(cfg, params, radio=Radio(**link), kv=kv,
                          prefill_impl="fused", device="cpu",
                          draws=JaxServeDraws, **ekw).serve(
                              _trace(Request, RequestTrace))
        assert rep.kv == kv
        assert _rows(rep) == _rows(jrep), kv
