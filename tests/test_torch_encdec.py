"""Port parity for the audio family (models/encdec.py): seamless-m4t-
medium at `reduced()` (2 encoder + 2 decoder layers, d_model 256, 4
heads at hd 64, layernorm, vocab 1,024, f32; attn_chunk 64, so the stub
source is 64 frames), on the JAX package's own parameters against the
live JAX functions on the CPU.

Tolerances: the encoder, the cross-attention, the forward and a decode
step against JAX at 2e-5 (tests/test_torch_xlstm.py's); decode against
the teacher-forced forward at tests/test_archs_smoke.py's 3e-3; frames
bit for bit; bills exactly; the schemes' losses within 1e-4."""
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
from repro.data import pipeline as JP
from repro.launch import serve as JSERVE
from repro.models import api as JM
from repro.models import encdec as JE
from repro.nn import init_params as jax_init
from repro.runtime import train_step as JTS
from repro.schemes import Experiment as JExperiment
from repro.schemes import build_scheme as j_build_scheme
from repro_torch.configs import ShapeConfig, WirelessConfig, get_arch
from repro_torch.configs.seamless_m4t_medium import TRUE_VOCAB
from repro_torch.core import split as SPLIT
from repro_torch.data import pipeline as P
from repro_torch.launch import serve as SERVE
from repro_torch.models import api as M
from repro_torch.models import encdec as E
from repro_torch.nn import params_from_jax, tree_at, tree_leaves
from repro_torch.runtime import train_step as TS
from repro_torch.schemes import Experiment, build_scheme

NAME = "seamless-m4t-medium"
TOL, DEC_TOL, LOSS_TOL = 2e-5, 3e-3, 1e-4
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


def _close(got, want, tol=TOL, msg=""):
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol,
                               err_msg=msg)


@pytest.fixture(scope="module")
def model():
    """JAX params (norm scales and biases made non-trivial) and the
    port's plain tree of the same numbers."""
    jcfg, cfg = _cfgs()
    jp = jax_init(jax.random.PRNGKey(0), JM.param_specs(jcfg))
    leaves, tdef = jax.tree.flatten(jp)
    rng = np.random.default_rng(0)
    jp = jax.tree.unflatten(tdef, [jnp.asarray(
        l + 0.05 * rng.standard_normal(l.shape).astype(np.float32))
        for l in leaves])
    return jcfg, cfg, jp, params_from_jax(jax.tree.map(np.asarray, jp), cfg,
                                          "cpu")


def _tokens(cfg, seed, B=2, S=12):
    return np.random.default_rng(seed).integers(1, cfg.vocab_size, (B, S),
                                                dtype=np.int32)


def _frames(cfg, seed, B=2, S=12):
    return (0.1 * np.random.default_rng(seed).standard_normal(
        (B, E.src_len(cfg, S), cfg.d_model))).astype(np.float32)


# ---------------------------------------------------------- layout, inputs
def test_config_leaves_and_inputs_are_jaxs():
    """The config field for field (also reduced; vocab padded to 256,256
    from 256,206), the parameter leaves JAX's in JAX's order (~0.72 B at
    full size), `input_specs`' frames, and the cache JAX's but for the
    cross K/V, held [L, B, Hkv, S_src, hd] (K7's layout) where JAX holds
    [L, B, S_src, Hkv, hd]."""
    for jc, c in ((jax_arch(NAME), get_arch(NAME)), _cfgs()):
        for f in dataclasses.fields(c):
            if f.name not in ("dtype", "param_dtype"):
                assert getattr(c, f.name) == getattr(jc, f.name), f.name
        want = jax.tree_util.tree_flatten_with_path(JM.param_specs(jc))[0]
        got = tree_leaves(M.train_param_specs(c))
        assert [tuple(s.shape) for s in got] == \
            [tuple(s.shape) for _, s in want]
        assert [s.init for s in got] == [s.init for _, s in want]
        for kind in ("train", "decode"):
            js = JM.input_specs(jc, JShape("s", 128, 8, kind))
            ps = M.input_specs(c, ShapeConfig("s", 128, 8, kind))
            assert {k: tuple(v.shape) for k, v in js.items()} == \
                {k: tuple(v[0]) for k, v in ps.items()}
        jcache = JE.cache_shapes(jc, 2, 8)
        for k, (shape, _, _) in E.cache_shapes(c, 2, 8).items():
            sh = jcache[k][0]
            if k in ("xk", "xv"):
                sh = (sh[0], sh[1], sh[3], sh[2], sh[4])
            assert shape == sh, k
    full = get_arch(NAME)
    assert full.vocab_size % 128 == 0 and TRUE_VOCAB == 256206
    assert M.input_specs(full, ShapeConfig("s", 128, 8, "train"))[
        "frames"][0] == (8, 512, 1024)
    n = sum(int(np.prod(s.shape)) for s in tree_leaves(M.param_specs(full)))
    assert 0.7e9 < n < 0.8e9, n


def test_synthetic_lm_batches_and_scheme_frames_are_jaxs():
    """The pipeline's tokens and frames, batch after batch, and a scaled
    scheme's sampled batch (rows, then frames, from the experiment's
    rng), byte for byte the JAX package's arrays."""
    jc, c = _cfgs()
    n = 0
    for a, b in zip(P.synthetic_lm_batches(c, 2, 16, seed=1),
                    JP.synthetic_lm_batches(jc, 2, 16, seed=1)):
        assert sorted(a) == sorted(b) == ["frames", "labels", "tokens"]
        for k in a:
            assert a[k].dtype == b[k].dtype and a[k].tobytes() == \
                b[k].tobytes(), k
        n += 1
        if n == 2:
            break
    assert a["frames"].shape == (2, 64, c.d_model)
    w, jw = WirelessConfig(mode="cl"), JW(mode="cl")
    scheme = build_scheme(w, cfg=c, shape=SHAPE, device="cpu")
    jscheme = j_build_scheme(jw, cfg=jc, shape=JSHAPE)
    x = _tokens(c, 3, 32, 16)
    got = scheme._sample_batch(x, x, np.random.default_rng(5), 4)
    want = jscheme._sample_batch(x, x, np.random.default_rng(5), 4)
    assert sorted(got) == sorted(want)
    for k in got:
        assert got[k].numpy().tobytes() == np.asarray(want[k]).tobytes(), k


# ------------------------------------------------------------ the model
def test_encode_and_cross_attention_match_jax(model):
    jcfg, cfg, jp, pp = model
    fr = _frames(cfg, 1)
    x = (0.5 * np.random.default_rng(2).standard_normal(
        (2, 12, cfg.d_model))).astype(np.float32)
    jenc = JE.encode(jp, jnp.asarray(fr), jcfg)
    lp = tree_at(pp["dec"], 1)
    jlp = jax.tree.map(lambda a: a[1], jp["dec"])
    with torch.no_grad():
        enc = E.encode(pp, _t(fr), cfg)
        kv = E.enc_kv(lp["cross_attn"], enc, cfg)
        got = E.cross_attention(lp["cross_attn"], _t(x), kv, cfg)
    _close(enc, jenc)
    jkv = JE.enc_kv(jlp["cross_attn"], jenc, jcfg)
    for a, b in zip(kv, jkv):
        _close(a, b)
    _close(got, JE.cross_attention(jlp["cross_attn"], jnp.asarray(x), jkv,
                                   jcfg))


def test_forward_matches_jax(model):
    jcfg, cfg, jp, pp = model
    tok, fr = _tokens(cfg, 1), _frames(cfg, 1)
    ref, _ = JE.forward(jp, {"tokens": jnp.asarray(tok),
                             "frames": jnp.asarray(fr)}, jcfg)
    with torch.no_grad():
        got, aux = E.forward(pp, {"tokens": _t(tok), "frames": _t(fr)}, cfg)
    assert got.shape == (2, 12, cfg.vocab_size)
    _close(got, ref)
    assert float(aux["aux_loss"]) == 0.0


def test_prefill_cross_and_decode_match_jax_and_forward(model):
    """`prefill_cross` fills the cross K/V as JAX's (transposed); then
    token by token each step's logits and self-attention cache against
    JAX's `decode_step`, and the decoded logits against the port's
    teacher-forced forward at 3e-3."""
    jcfg, cfg, jp, pp = model
    B, S = 2, 8
    tok, fr = _tokens(cfg, 4, B, S), _frames(cfg, 5, B, S)
    jc = JE.prefill_cross(jp, jnp.asarray(fr), jcfg,
                          JE.init_cache(jcfg, B, S))
    with torch.no_grad():
        pc = E.prefill_cross(pp, _t(fr), cfg, E.init_cache(cfg, B, S, "cpu"))
    for k in ("xk", "xv"):
        _close(pc[k], np.asarray(jc[k]).swapaxes(2, 3), msg=k)
    outs = []
    with torch.no_grad():
        for i in range(S):
            jl, jc = JE.decode_step(jp, jc, jnp.asarray(tok[:, i:i + 1]),
                                    jnp.int32(i), jcfg)
            pl, pc = E.decode_step(pp, pc, _t(tok[:, i:i + 1]), i, cfg)
            _close(pl, jl, msg=f"logits {i}")
            for k in ("k", "v"):
                _close(pc[k], jc[k], msg=f"{k} {i}")
            outs.append(pl[:, 0])
        full, _ = E.forward(pp, {"tokens": _t(tok), "frames": _t(fr)}, cfg)
    _close(torch.stack(outs, 1), full, tol=DEC_TOL)


def test_split_at_the_encoder_matches_jax():
    """The encoder output is the smashed data: over a perfect Q16 link,
    logits against JAX's `split_forward`; one leg is B x S_src x d / 4
    elements (S_src = max(attn_chunk, S / 4))."""
    jcfg, cfg = _cfgs()
    kw = dict(mode="sl", quant_bits=16, perfect_channel=True)
    jw, w = JW(**kw), WirelessConfig(**kw)
    js = JTS.init_train_state(jax.random.PRNGKey(2), jcfg, jw, "adamw")
    st = port_train_state(js)
    tok, fr = _tokens(cfg, 7, 4, 16), _frames(cfg, 8, 4, 16)
    b = {"tokens": tok, "labels": tok, "frames": fr}
    key = jax.random.PRNGKey(4)
    jl, _ = JSPLIT.split_forward(js.trainable["model"],
                                 js.trainable["codec"], b, jcfg, jw, key)
    with torch.no_grad():
        pl, aux = SPLIT.split_forward(st.trainable["model"],
                                      st.trainable["codec"],
                                      {k: _t(v) for k, v in b.items()},
                                      cfg, w, JaxKey(key))
    _close(pl, jl, tol=2e-4)
    assert float(aux["aux_loss"]) == 0.0
    assert SPLIT.crossing_elems(cfg, SHAPE, w) == \
        JSPLIT.crossing_elems(jcfg, JSHAPE, jw) == 4 * 64 * 64
    full = get_arch(NAME)
    assert SPLIT.crossing_elems(full, ShapeConfig("s", 128, 8, "train"),
                                WirelessConfig(mode="sl")) == 8 * 512 * 256


def test_train_step_with_remat_equals_without():
    """One step's gradients with remat (every encoder and decoder layer
    recomputed in the backward pass) are the bits of the step without;
    both within 2e-5 of `jax.grad`; the losses of 2 AdamW steps within
    1e-4 of JAX's."""
    jcfg, cfg = _cfgs()
    js = JTS.init_train_state(jax.random.PRNGKey(0), jcfg, None, "adamw")
    st = port_train_state(js)
    tok, fr = _tokens(cfg, 5, 4, 16), _frames(cfg, 6, 4, 16)
    b = {"tokens": tok, "labels": tok, "frames": fr}
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
        tok, fr = _tokens(cfg, 20 + s, 4, 16), _frames(cfg, 30 + s, 4, 16)
        b = {"tokens": tok, "labels": tok, "frames": fr}
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
    `Experiment` on JAX's initial weights and draws (frames from the
    experiment's rng): bills exactly the live JAX scheme's, loss within
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
def _seeded_frames(monkeypatch, jfr):
    """Both packages' `prefill_cross` encode `jfr` in place of the static
    loop's stub frames (0.1 everywhere), which the encoder's first
    layernorm turns into rounding noise (a constant row has no variance),
    so that the two packages' loops can be compared token for token."""
    jkept, kept = JE.prefill_cross, E.prefill_cross
    monkeypatch.setattr(JE, "prefill_cross", lambda p, fr, cfg, c: jkept(
        p, jnp.asarray(jfr), cfg, c))
    monkeypatch.setattr(E, "prefill_cross", lambda p, fr, cfg, c: kept(
        p, _t(jfr).to(fr.device), cfg, c))


@pytest.mark.parametrize("argv", [
    ["--snr-db", "6", "--greedy"],
    ["--temperature", "0.7"]])
def test_legacy_loop_matches_jax(argv, monkeypatch, capsys):
    """The billed static loop (the cross K/V prefilled from the frames
    first) on JAX's weights with JAX's draws: with the stub frames, the
    bill of JAX's `legacy_main` exactly and the prompt logits against
    the port's teacher-forced forward on the same frames at 3e-3; with
    seeded frames in both packages, also JAX's generated ids (the stub
    frames' encoder output is rounding noise, which no two summation
    orders share)."""
    argv = ["--arch", NAME, "--reduced", "--batch", "3", "--prompt-len",
            "6", "--new-tokens", "4", "--seed", "5"] + argv
    jargs = JSERVE.parse_args(argv)
    args = SERVE.parse_args(argv + ["--device", "cpu"])
    jcfg, cfg = _cfgs()
    jp = jax_init(jax.random.PRNGKey(5), JM.param_specs(jcfg))
    pp = params_from_jax(jax.tree.map(np.asarray, jp), cfg, "cpu")

    def both():
        want = JSERVE.legacy_main(jargs, jcfg, None)
        got = SERVE.legacy_loop(args, cfg, pp, torch.device("cpu"),
                                draws=JaxLegacyDraws(5))
        for k in ("bits", "erased_bits", "energy_j"):
            assert got[k] == want[k], k
        return got, want

    got, _ = both()
    frames = torch.full((3, E.src_len(cfg, 10), cfg.d_model), 0.1)
    with torch.no_grad():
        full, _ = E.forward(pp, {"tokens": _t(got["prompt"]),
                                 "frames": frames}, cfg)
    _close(got["prompt_logits"], full, tol=DEC_TOL)
    _seeded_frames(monkeypatch, _frames(cfg, 11, 3, 10))
    got, want = both()
    np.testing.assert_array_equal(got["generated"], want["generated"])
    assert "static loop" in capsys.readouterr().out


def test_launch_serve_routes_audio_to_the_static_loop(capsys):
    out = SERVE.main(["--arch", NAME, "--reduced", "--device", "cpu",
                      "--batch", "2", "--prompt-len", "4", "--new-tokens",
                      "3", "--snr-db", "10", "--greedy"])
    assert out["generated"].shape == (2, 3)
    assert out["bits"] > 0
    assert "audio: scalar-index decode only" in capsys.readouterr().out


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
