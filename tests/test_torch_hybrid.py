"""Port parity for the hybrid family (models/mamba2.py, models/hybrid.py):
zamba2-1.2b at `reduced()` (2 layers: two super-blocks of 1 Mamba2
block + the shared attention block, no tail; d_model 256, 4 heads at hd
64, SSM state 16, SSM head dim 32, f32) and variants with a tail (5
layers at `attn_every` 2: 2 super-blocks + 1 tail block; 7 layers: 3 +
1), on the JAX package's own parameters against the live JAX functions
on the CPU.

Tolerances: the conv at the JAX suite's recurrence tolerance 2e-5
(tests/test_kernels.py:124); the SSD scan, a block, the forward and a
decode step against JAX at 2e-4 (float32 einsums in another order);
decode against the teacher-forced forward at JAX's own 5e-3
(tests/test_archs_smoke.py:123); bills exactly; the schemes' losses
within 1e-4 (tests/test_torch_xlstm.py's)."""
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
from repro.models import hybrid as JH
from repro.models import mamba2 as JMB
from repro.nn import init_params as jax_init
from repro.runtime import train_step as JTS
from repro.schemes import Experiment as JExperiment
from repro.schemes import build_scheme as j_build_scheme
from repro_torch.configs import ShapeConfig, WirelessConfig, get_arch
from repro_torch.core import split as SPLIT
from repro_torch.launch import serve as SERVE
from repro_torch.models import api as M
from repro_torch.models import hybrid as H
from repro_torch.models import mamba2 as MB
from repro_torch.nn import params_from_jax, tree_leaves
from repro_torch.runtime import train_step as TS
from repro_torch.schemes import Experiment, build_scheme

NAME = "zamba2-1.2b"
CONV_TOL, TOL, DEC_TOL, LOSS_TOL = 2e-5, 2e-4, 5e-3, 1e-4
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


TAIL = dict(n_layers=5, attn_every=2)


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(x):
    return x.detach().numpy() if torch.is_tensor(x) else np.asarray(x)


def _close(got, want, tol=TOL, msg=""):
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol,
                               err_msg=msg)


def _perturbed(tree, seed):
    """JAX params with every leaf moved by 0.05 x normals (norm scales,
    A_log and D made non-trivial)."""
    leaves, tdef = jax.tree.flatten(tree)
    rng = np.random.default_rng(seed)
    return jax.tree.unflatten(tdef, [jnp.asarray(
        l + 0.05 * rng.standard_normal(l.shape).astype(np.float32))
        for l in leaves])


def _params(jcfg, cfg, seed=0):
    jp = _perturbed(jax_init(jax.random.PRNGKey(seed), JM.param_specs(jcfg)),
                    seed)
    return jp, params_from_jax(jax.tree.map(np.asarray, jp), cfg, "cpu")


def _tokens(cfg, seed, B=2, S=12):
    return np.random.default_rng(seed).integers(1, cfg.vocab_size, (B, S),
                                                dtype=np.int32)


def _normal(rng, *shape, scale=1.0):
    return (scale * rng.standard_normal(shape)).astype(np.float32)


# ---------------------------------------------------------- layout, leaves
def test_config_layout_and_leaves_are_jaxs():
    """The config field for field (also reduced), the layout (6 super-
    blocks of 6 + a tail of 2 at full size), the parameter leaves JAX's
    in JAX's order (the FL packets follow it), the cache JAX's (about
    1.1 B parameters at full size)."""
    for jc, c in ((jax_arch(NAME), get_arch(NAME)), _cfgs(),
                  _cfgs(**TAIL)):
        for f in dataclasses.fields(c):
            if f.name not in ("dtype", "param_dtype"):
                assert getattr(c, f.name) == getattr(jc, f.name), f.name
        assert H.layout(c) == JH.layout(jc)
        assert MB.ssm_dims(c) == JMB.ssm_dims(jc)
        want = jax.tree_util.tree_flatten_with_path(JM.param_specs(jc))[0]
        got = tree_leaves(M.train_param_specs(c))
        assert [tuple(s.shape) for s in got] == \
            [tuple(s.shape) for _, s in want]
        assert [(s.init, s.scale) for s in got] == \
            [(s.init, s.scale) for _, s in want]
        assert {k: v[0] for k, v in H.cache_shapes(c, 2, 8).items()} == \
            {k: v[0] for k, v in JH.cache_shapes(jc, 2, 8).items()}
    full = get_arch(NAME)
    assert H.layout(full) == (6, 6, 2)
    assert H.layout(_cfgs()[1]) == (2, 1, 0)
    n = sum(int(np.prod(s.shape)) for s in tree_leaves(M.param_specs(full)))
    assert 1.1e9 < n < 1.3e9, n


# ---------------------------------------------------------- Mamba2 parts
def test_causal_depthwise_conv_matches_jax():
    rng = np.random.default_rng(1)
    u, w = _normal(rng, 2, 9, 24), _normal(rng, MB.CONV_K, 24, scale=0.5)
    _close(MB._causal_depthwise_conv(_t(u), _t(w)),
           JMB._causal_depthwise_conv(jnp.asarray(u), jnp.asarray(w)),
           tol=CONV_TOL)


@pytest.mark.parametrize("S", [64, 256])
def test_ssd_chunked_matches_jax(S):
    """One chunk (S 64) and two (S 256: the inter-chunk scan hands the
    second chunk the first one's state)."""
    rng = np.random.default_rng(S)
    B, nh, hd, ds = 2, 4, 8, 16
    xh, B_, C_ = (_normal(rng, B, S, nh, hd), _normal(rng, B, S, ds),
                  _normal(rng, B, S, ds))
    dt = np.log1p(np.exp(_normal(rng, B, S, nh) - 2.0)).astype(np.float32)
    A_log, D = _normal(rng, nh, scale=0.5), _normal(rng, nh)
    args = (xh, B_, C_, dt, A_log, D)
    want = JMB.ssd_chunked(*map(jnp.asarray, args))
    got = MB.ssd_chunked(*map(_t, args))
    assert got.shape == (B, S, nh, hd)
    _close(got, want)


@pytest.fixture(scope="module")
def block():
    jcfg, cfg = _cfgs()
    jp = _perturbed(jax_init(jax.random.PRNGKey(3), JMB.mamba_specs(jcfg)), 3)
    return jcfg, cfg, jp, params_from_jax(jax.tree.map(np.asarray, jp),
                                          None, "cpu")


def test_mamba_block_matches_jax(block):
    jcfg, cfg, jp, pp = block
    x = _normal(np.random.default_rng(4), 2, 16, cfg.d_model)
    with torch.no_grad():
        got = MB.apply_mamba_block(pp, _t(x), cfg)
    _close(got, JMB.apply_mamba_block(jp, jnp.asarray(x), jcfg))


def test_mamba_decode_matches_jax_and_the_block(block):
    """Step by step from zero state: output and both states against
    JAX's `apply_mamba_decode`; the outputs against the block's
    full-sequence pass."""
    jcfg, cfg, jp, pp = block
    B, S = 2, 6
    x = _normal(np.random.default_rng(5), B, S, cfg.d_model)
    shapes = MB.mamba_cache_shapes(cfg, 1, B)
    js = [jnp.zeros(shapes[k][0][1:]) for k in ("ssm", "conv")]
    ps = [torch.zeros(shapes[k][0][1:]) for k in ("ssm", "conv")]
    outs = []
    with torch.no_grad():
        for i in range(S):
            jy, *js = JMB.apply_mamba_decode(jp, jnp.asarray(x[:, i:i + 1]),
                                             jcfg, *js)
            py, *ps = MB.apply_mamba_decode(pp, _t(x[:, i:i + 1]), cfg, *ps)
            _close(py, jy, msg=f"y {i}")
            for a, b, k in zip(ps, js, ("ssm", "conv")):
                _close(a, b, msg=f"{k} {i}")
            outs.append(py)
        full = MB.apply_mamba_block(pp, _t(x), cfg)
    _close(torch.cat(outs, 1), full, tol=DEC_TOL)


# ------------------------------------------------------------ the model
@pytest.mark.parametrize("kw", [{}, TAIL], ids=["reduced", "tail"])
def test_forward_matches_jax(kw):
    jcfg, cfg = _cfgs(**kw)
    jp, pp = _params(jcfg, cfg, seed=len(kw))
    tok = _tokens(cfg, 1, S=16)
    ref, _ = JH.forward(jp, {"tokens": jnp.asarray(tok)}, jcfg)
    with torch.no_grad():
        got, aux = H.forward(pp, {"tokens": _t(tok)}, cfg)
    assert got.shape == (2, 16, cfg.vocab_size)
    _close(got, ref)
    assert float(aux["aux_loss"]) == 0.0


@pytest.mark.parametrize("kw", [{}, TAIL], ids=["reduced", "tail"])
def test_decode_step_matches_jax_and_forward(kw):
    """Token by token from `init_cache`: each step's logits and every
    cache leaf against JAX's `decode_step`; the decoded logits against
    the port's teacher-forced forward at JAX's 5e-3."""
    jcfg, cfg = _cfgs(**kw)
    jp, pp = _params(jcfg, cfg, seed=7)
    B, S = 2, 8
    tok = _tokens(cfg, 4, B, S)
    jc, pc = JH.init_cache(jcfg, B, S), H.init_cache(cfg, B, S, "cpu")
    assert sorted(pc) == sorted(jc)
    outs = []
    with torch.no_grad():
        for i in range(S):
            jl, jc = JH.decode_step(jp, jc, jnp.asarray(tok[:, i:i + 1]),
                                    jnp.int32(i), jcfg)
            pl, pc = H.decode_step(pp, pc, _t(tok[:, i:i + 1]), i, cfg)
            _close(pl, jl, msg=f"logits {i}")
            for k in jc:
                _close(pc[k], jc[k], msg=f"{k} {i}")
            outs.append(pl[:, 0])
        full, _ = H.forward(pp, {"tokens": _t(tok)}, cfg)
    _close(torch.stack(outs, 1), full, tol=DEC_TOL)


@pytest.mark.parametrize("split_layer", [1, 2])
def test_split_at_a_super_block_matches_jax(split_layer):
    """7 layers at attn_every 2 = 3 super-blocks + 1 tail block; the cut
    counts super-blocks and the tail runs on the server after the last.
    Over a perfect Q16 link: logits against JAX's `split_forward`."""
    jcfg, cfg = _cfgs(n_layers=7, attn_every=2)
    assert H.layout(cfg) == (3, 2, 1)
    kw = dict(mode="sl", quant_bits=16, perfect_channel=True,
              split_layer=split_layer)
    jw, w = JW(**kw), WirelessConfig(**kw)
    js = JTS.init_train_state(jax.random.PRNGKey(2), jcfg, jw, "adamw")
    js = js._replace(trainable=_perturbed(js.trainable, 2))
    st = port_train_state(js)
    tok = _tokens(cfg, 7, 4, 16)
    b = {"tokens": tok, "labels": tok}
    key = jax.random.PRNGKey(4)
    jl, _ = JSPLIT.split_forward(js.trainable["model"],
                                 js.trainable["codec"], b, jcfg, jw, key)
    with torch.no_grad():
        pl, aux = SPLIT.split_forward(st.trainable["model"],
                                      st.trainable["codec"],
                                      {k: _t(v) for k, v in b.items()},
                                      cfg, w, JaxKey(key))
    _close(pl, jl)
    assert float(aux["aux_loss"]) == 0.0
    assert SPLIT.crossing_elems(cfg, SHAPE, w) == 4 * 16 * 64


def test_train_step_with_remat_equals_without():
    """One step's gradients with remat (super-blocks and the tail block
    recomputed in the backward pass) are the bits of the step without;
    both within 2e-4 of `jax.grad`; the losses of 2 AdamW steps within
    1e-4 of JAX's."""
    jcfg, cfg = _cfgs(**TAIL)
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
    `Experiment` on JAX's initial weights and draws: bills exactly the
    live JAX scheme's (FL: one packet per stacked leaf), loss within
    1e-4, accuracy within 0.01."""
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
    if mode != "fl":
        pf, jf = scheme._step_cost_flops(), jscheme._step_cost_flops()
        assert 0.5 <= pf / jf <= 2.0, (pf, jf)


# --------------------------------------------------------------- serving
@pytest.mark.parametrize("argv", [
    ["--snr-db", "6", "--greedy"],
    ["--snr-db", "0", "--arq-max-tx", "1", "--greedy"],
    ["--temperature", "0.7"]])
def test_legacy_loop_matches_jax(argv, capsys):
    """The billed static loop on JAX's weights with JAX's draws (prompt,
    both crossings, sampling): the generated ids, bits, erased bits and
    energy of JAX's `legacy_main`; the prompt logits against the
    teacher-forced forward at 5e-3."""
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
        full, _ = H.forward(pp, {"tokens": _t(got["prompt"])}, cfg)
    _close(got["prompt_logits"], full, tol=DEC_TOL)
    assert "static loop" in capsys.readouterr().out


def test_launch_serve_routes_hybrid_to_the_static_loop(capsys):
    out = SERVE.main(["--arch", NAME, "--reduced", "--device", "cpu",
                      "--batch", "2", "--prompt-len", "4", "--new-tokens",
                      "3", "--snr-db", "10", "--greedy"])
    assert out["generated"].shape == (2, 3)
    assert out["bits"] > 0
    assert "hybrid: scalar-index decode only" in capsys.readouterr().out


@pytest.mark.parametrize("mode", ["cl", "fl", "sl"])
def test_launch_train_reduced_on_cpu(mode, capsys):
    from repro_torch.launch import train
    out = train.main(["--arch", NAME, "--reduced", "--mode", mode,
                      "--steps", "2", "--device", "cpu", "--batch", "4",
                      "--seq", "16", "--n-train", "32", "--n-test", "8",
                      "--cycle-steps", "2", "--local-steps", "2"])
    assert "done: 1 cycles on cpu" in capsys.readouterr().out
    assert np.isfinite(out["final_loss"])
    exp = out["experiment"]
    if mode == "cl":
        assert exp.init_delivery.bits == 32 * 16 * 10     # 10-bit tokens
    else:
        assert exp.reports[0].bits > 0
