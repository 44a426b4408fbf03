"""Port parity for the ssm family (models/xlstm.py): xlstm-350m at
`reduced()` (2 layers: one super-block of 1 mLSTM + 1 sLSTM, d_model
256, 4 heads at hd 64, f32), and a 4-layer variant of it with two
super-blocks for the split, on the JAX package's own parameters against
the live JAX functions on the CPU.

The recurrences (mLSTM's matrix memory, sLSTM's scalar one, each with
the max-stabiliser) are compared at rtol = atol = 2e-5 (the JAX suite's
recurrence tolerance, tests/test_kernels.py:124); decode against the
teacher-forced forward at tests/test_archs_smoke.py's 3e-3; bills
exactly; the schemes' losses within 1e-4 (SL at Q16 over a perfect
link, as tests/test_torch_scaled_schemes.py holds it)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _jax_keys import (JaxKey, JaxLegacyDraws, port_train_state,
                       scaled_on_init)
from repro.configs import get_arch as jax_arch
from repro.configs.base import ShapeConfig as JShape
from repro.configs.base import WirelessConfig as JW
from repro.core import split as JSPLIT
from repro.launch import serve as JSERVE
from repro.models import api as JM
from repro.models import xlstm as JX
from repro.nn import init_params as jax_init
from repro.runtime import train_step as JTS
from repro.schemes import Experiment as JExperiment
from repro.schemes import build_scheme as j_build_scheme
from repro_torch.configs import ShapeConfig, WirelessConfig, get_arch
from repro_torch.core import split as SPLIT
from repro_torch.launch import serve as SERVE
from repro_torch.models import api as M
from repro_torch.models import xlstm as X
from repro_torch.nn import params_from_jax, tree_leaves
from repro_torch.runtime import train_step as TS
from repro_torch.schemes import Experiment, build_scheme

NAME = "xlstm-350m"
REC_TOL, LOSS_TOL = 2e-5, 1e-4
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


def _np(x):
    return x.detach().numpy() if torch.is_tensor(x) else np.asarray(x)


def _close(got, want, tol=REC_TOL, msg=""):
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol,
                               err_msg=msg)


def _params(jcfg, cfg, seed=0):
    """JAX params (norm scales and biases made non-trivial) and the
    port's plain tree of the same numbers."""
    jp = jax_init(jax.random.PRNGKey(seed), JM.param_specs(jcfg))
    leaves, tdef = jax.tree.flatten(jp)
    rng = np.random.default_rng(seed)
    leaves = [l + 0.05 * rng.standard_normal(l.shape).astype(np.float32)
              for l in leaves]
    jp = jax.tree.unflatten(tdef, [jnp.asarray(l) for l in leaves])
    return jp, params_from_jax(jax.tree.map(np.asarray, jp), cfg, "cpu")


@pytest.fixture(scope="module")
def model():
    jcfg, cfg = _cfgs()
    return (jcfg, cfg) + _params(jcfg, cfg)


def _tokens(cfg, seed, B=2, S=12):
    return np.random.default_rng(seed).integers(1, cfg.vocab_size, (B, S),
                                                dtype=np.int32)


# ---------------------------------------------------------- layout, cells
def test_config_layout_and_leaves_are_jaxs():
    """The config field for field (also reduced), the super-block layout
    (4 x (5 mLSTM + 1 sLSTM) at full size), and the parameter leaves
    JAX's in JAX's order, which the FL packets follow; about 0.18 B
    parameters at full size."""
    for jc, c in ((jax_arch(NAME), get_arch(NAME)), _cfgs()):
        for f in dataclasses.fields(c):
            if f.name not in ("dtype", "param_dtype"):
                assert getattr(c, f.name) == getattr(jc, f.name), f.name
        assert X.super_block_layout(c) == JX.super_block_layout(jc)
        want = jax.tree_util.tree_flatten_with_path(JM.param_specs(jc))[0]
        got = tree_leaves(M.train_param_specs(c))
        assert [tuple(s.shape) for s in got] == \
            [tuple(s.shape) for _, s in want]
        assert [s.init for s in got] == [s.init for _, s in want]
    full = get_arch(NAME)
    assert X.super_block_layout(full) == (4, 5)
    n = sum(int(np.prod(s.shape)) for s in tree_leaves(M.param_specs(full)))
    assert 0.17e9 < n < 0.19e9
    assert {k: v[0] for k, v in X.cache_shapes(full, 2, 8).items()} == \
        {k: v[0] for k, v in JX.cache_shapes(jax_arch(NAME), 2, 8).items()}


def _cell_inputs(seed, B=3, nh=4, hd=16):
    rng = np.random.default_rng(seed)

    def r(*s, scale=1.0):
        return (scale * rng.standard_normal(s)).astype(np.float32)
    return r, B, nh, hd


@pytest.mark.parametrize("first", [True, False])
def test_mlstm_cell_matches_jax(first):
    """From the initial state (m = -inf) and from a running one."""
    r, B, nh, hd = _cell_inputs(1)
    C, n = r(B, nh, hd, hd), r(B, nh, hd)
    m = np.full((B, nh), -np.inf, np.float32) if first else r(B, nh)
    inp = (r(B, nh, hd), r(B, nh, hd), r(B, nh, hd), r(B, nh),
           np.log(1 / (1 + np.exp(-r(B, nh)))).astype(np.float32))
    (jC, jn, jm), jy = JX.mlstm_cell(
        tuple(jnp.asarray(a) for a in (C, n, m)),
        tuple(jnp.asarray(a) for a in inp))
    (pC, pn, pm), py = X.mlstm_cell(tuple(_t(a) for a in (C, n, m)),
                                    tuple(_t(a) for a in inp))
    for a, b, k in ((pC, jC, "C"), (pn, jn, "n"), (pm, jm, "m"),
                    (py, jy, "y")):
        _close(a, b, msg=k)


@pytest.mark.parametrize("first", [True, False])
def test_slstm_cell_matches_jax(first):
    jcfg, cfg = _cfgs()
    jp = jax_init(jax.random.PRNGKey(3), JX.slstm_specs(jcfg))
    pp = params_from_jax(jax.tree.map(np.asarray, jp), None, "cpu")
    r, B, nh, hd = _cell_inputs(2, nh=4, hd=64)
    m = np.full((B, nh, hd), -np.inf, np.float32) if first else r(B, nh, hd)
    st = (r(B, nh, hd), np.abs(r(B, nh, hd)), m, r(B, nh, hd))
    xt = r(B, 4 * 256)
    js, jh = JX.slstm_cell(jp, tuple(jnp.asarray(a) for a in st),
                           jnp.asarray(xt), jcfg)
    ps, ph = X.slstm_cell(pp, tuple(_t(a) for a in st), _t(xt), cfg)
    for a, b in zip(ps + (ph,), js + (jh,)):
        _close(a, b)


# ------------------------------------------------------------ the model
@pytest.mark.parametrize("n_layers", [2, 4])
def test_forward_matches_jax(n_layers):
    """One super-block (reduced) and two (4 layers)."""
    jcfg, cfg = _cfgs(n_layers=n_layers)
    jp, pp = _params(jcfg, cfg, seed=n_layers)
    tok = _tokens(cfg, 1)
    ref, _ = JX.forward(jp, {"tokens": jnp.asarray(tok)}, jcfg)
    with torch.no_grad():
        got, aux = X.forward(pp, {"tokens": _t(tok)}, cfg)
    assert got.shape == (2, 12, cfg.vocab_size)
    _close(got, ref)
    assert float(aux["aux_loss"]) == 0.0


def test_decode_step_matches_jax_and_forward(model):
    """Token by token from `init_cache`: each step's logits and every
    cache leaf against JAX's `decode_step` (2e-5); the decoded logits
    against the teacher-forced forward at tests/test_archs_smoke.py's
    3e-3; `active` keeps an inactive row's state."""
    jcfg, cfg, jp, pp = model
    B, S = 2, 8
    tok = _tokens(cfg, 4, B, S)
    jc, pc = JX.init_cache(jcfg, B, S), X.init_cache(cfg, B, S, "cpu")
    assert sorted(pc) == sorted(jc)
    outs = []
    with torch.no_grad():
        for i in range(S):
            jl, jc = JX.decode_step(jp, jc, jnp.asarray(tok[:, i:i + 1]),
                                    jnp.int32(i), jcfg)
            pl, pc = X.decode_step(pp, pc, _t(tok[:, i:i + 1]), i, cfg)
            _close(pl, jl, msg=f"logits {i}")
            for k in jc:
                _close(pc[k], jc[k], msg=f"{k} {i}")
            outs.append(pl[:, 0])
        full, _ = X.forward(pp, {"tokens": _t(tok)}, cfg)
        _close(torch.stack(outs, 1), full, tol=3e-3)
        keep = {k: v.clone() for k, v in pc.items()}
        X.decode_step(pp, pc, _t(tok[:, :1]), S, cfg,
                      active=torch.tensor([True, False]))
    for k in pc:        # the batch axis: [n_super, n_m, B, ...] or
        bax = 2 if k.startswith("m") else 1     # [n_super, B, ...]
        assert torch.equal(pc[k].select(bax, 1), keep[k].select(bax, 1)), k
        assert not torch.equal(pc[k].select(bax, 0), keep[k].select(bax, 0))


@pytest.mark.parametrize("split_layer", [1, 5])
def test_split_at_a_super_block_matches_jax(split_layer):
    """4 layers = 2 super-blocks; the cut counts super-blocks, clamped
    to [1, n_super - 1] (split_layer 5 cuts at 1 too). Over a perfect
    Q16 link: logits against JAX's `split_forward`, and equal to the
    user's super-block, the link, then the server's."""
    jcfg, cfg = _cfgs(n_layers=4)
    kw = dict(mode="sl", quant_bits=16, perfect_channel=True,
              split_layer=split_layer)
    jw, w = JW(**kw), WirelessConfig(**kw)
    js = JTS.init_train_state(jax.random.PRNGKey(2), jcfg, jw, "adamw")
    st = port_train_state(js)
    tok = _tokens(cfg, 7, 4, 16)
    b = {"tokens": tok, "labels": tok}
    key = jax.random.PRNGKey(4)
    jl, _ = JSPLIT.split_forward(js.trainable["model"],
                                 js.trainable["codec"], b, jcfg, jw, key)
    with torch.no_grad():
        pl, _ = SPLIT.split_forward(st.trainable["model"],
                                    st.trainable["codec"],
                                    {k: _t(v) for k, v in b.items()}, cfg,
                                    w, JaxKey(key))
    _close(pl, jl, tol=2e-4)
    assert SPLIT.crossing_elems(cfg, SHAPE, w) == 4 * 16 * 64


def test_train_step_with_remat_equals_without():
    """One AdamW step's gradients with remat (super-blocks recomputed in
    the backward pass) are the bits of the step without; both within
    2e-5 of `jax.grad`, and the losses of 2 steps within 1e-4."""
    jcfg, cfg = _cfgs()
    js = JTS.init_train_state(jax.random.PRNGKey(0), jcfg, None, "adamw")
    st = port_train_state(js)
    tok = _tokens(cfg, 5, 4, 16)
    b = {"tokens": tok, "labels": tok}
    tb = {k: _t(v) for k, v in b.items()}
    key = jax.random.PRNGKey(9)
    jg = jax.grad(lambda t: JTS._loss(t, b, jcfg, None, key, 0)[0])(
        js.trainable)
    grads = {}
    for remat in (False, True):
        _, g = TS.value_and_grad(st.trainable, tb,
                                 dataclasses.replace(cfg, remat=remat),
                                 None, JaxKey(key))
        grads[remat] = tree_leaves(g)
        for a, want in zip(grads[remat], jax.tree.leaves(jg)):
            _close(a, want)
    assert all(torch.equal(a, b) for a, b in zip(grads[False], grads[True]))
    jstep = jax.jit(JTS.make_train_step(jcfg, JSHAPE, None))
    step = TS.make_train_step(cfg, SHAPE, None)
    for s in range(2):
        tok = _tokens(cfg, 20 + s, 4, 16)
        b = {"tokens": tok, "labels": tok}
        js, jm = jstep(js, b, jax.random.fold_in(key, s))
        st, m = step(st, {k: _t(v) for k, v in b.items()},
                     JaxKey(key).fold_in(s))
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                                   rtol=0, atol=LOSS_TOL)


@pytest.mark.parametrize("mode,kw", [
    ("cl", dict(snr_db=10.0)),
    ("fl", dict(quant_bits=8, local_steps=2)),
    ("sl", dict(quant_bits=16, perfect_channel=True))])
def test_scaled_schemes_match_live_jax(mode, kw):
    """One cycle of 2 steps of the scaled CL / FL / SL schemes through
    `Experiment` on JAX's initial weights and draws: bills exactly equal
    to the live JAX scheme's (FL: one packet per stacked leaf, 17 of
    them), loss within 1e-4, accuracy within 0.01."""
    jcfg, cfg = _cfgs()
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
    if mode == "fl":
        assert len(tree_leaves(M.train_param_specs(cfg))) == 17
    else:
        pf, jf = scheme._step_cost_flops(), jscheme._step_cost_flops()
        assert 0.5 <= pf / jf <= 2.0, (pf, jf)


@pytest.mark.parametrize("mode", ["cl", "sl", "fl"])
def test_flop_count_from_two_lengths_is_the_full_count(mode):
    """The ssm family's FLOPs, counted at one and two tokens and extended
    to seq_len, equal the count of the meta step at seq_len itself."""
    _, cfg = _cfgs()
    kw = dict(fl=dict(local_steps=2), sl=dict(quant_bits=16,
                                              perfect_channel=True))
    scheme = build_scheme(WirelessConfig(mode=mode, **kw.get(mode, {})),
                          cfg=cfg, shape=SHAPE, device="cpu",
                          steps_per_cycle=2)
    assert scheme._step_cost_flops() == \
        scheme._count_flops(16) * scheme._steps_per_program > 0


# --------------------------------------------------------------- serving
@pytest.mark.parametrize("argv", [
    ["--snr-db", "6", "--greedy"],
    ["--snr-db", "0", "--arq-max-tx", "1", "--greedy"],
    ["--temperature", "0.7"]])
def test_legacy_loop_matches_jax(argv, capsys):
    """The billed static loop on JAX's weights with JAX's draws (prompt,
    both crossings, sampling): the generated ids, bits, erased bits and
    energy of JAX's `legacy_main`; the prompt logits against the
    teacher-forced forward at 3e-3."""
    argv = ["--arch", NAME, "--reduced", "--batch", "3", "--prompt-len",
            "6", "--new-tokens", "4", "--seed", "5"] + argv
    jargs = JSERVE.parse_args(argv)
    args = SERVE.parse_args(argv + ["--device", "cpu"])
    jcfg, cfg = _cfgs()
    want = JSERVE.legacy_main(jargs, jcfg, None)
    jp = jax_init(jax.random.PRNGKey(5), JM.param_specs(jcfg))
    pp = params_from_jax(jax.tree.map(np.asarray, jp), cfg, "cpu")
    got = SERVE.legacy_loop(args, cfg, pp, torch.device("cpu"),
                            draws=JaxLegacyDraws(5))
    np.testing.assert_array_equal(got["generated"], want["generated"])
    for k in ("bits", "erased_bits", "energy_j"):
        assert got[k] == want[k], k
    if "--arq-max-tx" in argv:
        assert got["erased_bits"] > 0
    with torch.no_grad():
        full, _ = X.forward(pp, {"tokens": _t(got["prompt"])}, cfg)
    _close(got["prompt_logits"], full, tol=3e-3)
    assert "static loop" in capsys.readouterr().out


def test_launch_serve_routes_ssm_to_the_static_loop(capsys):
    out = SERVE.main(["--arch", NAME, "--reduced", "--device", "cpu",
                      "--batch", "2", "--prompt-len", "4", "--new-tokens",
                      "3", "--snr-db", "10", "--greedy"])
    assert out["generated"].shape == (2, 3)
    assert out["bits"] > 0
    assert "ssm: scalar-index decode only" in capsys.readouterr().out
