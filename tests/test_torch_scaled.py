"""Port parity for the dense family's training pieces (P15) against the
JAX package on the CPU: the synthetic corpus, `chunked_attention`,
`lm_loss`, the AdamW train step with gradient accumulation, the dense
split step through the channel crossing (bf16 too), the scaled FL step's
local phase and sync (K1's and K2's plain versions against JAX's packed
path and its Pallas kernel in interpret mode), the full-width packet
layout and bills of qwen1.5-0.5b, and the FLOP counts.

The reduced config is qwen1.5-0.5b's smoke variant (2 layers, d_model
256, vocab 1,024, f32) with remat off, at batch 4 x seq 16. The JAX
package runs outside any mesh; the port gets its initial weights and
its draws (`JaxKey`, tests/_jax_keys.py). Tolerances: attention 2e-4
(tests/test_torch_transformer.py), gradients 2e-5 abs + rel, losses over
3 steps 1e-4; the wire, the syncs and the crossings bit for bit."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _jax_keys import JaxKey, port_train_state
from repro.configs import get_arch as jax_arch
from repro.configs.base import ShapeConfig as JShape
from repro.configs.base import WirelessConfig as JW
from repro.core import channel as JCH
from repro.data import pipeline as JP
from repro.models import api as JM
from repro.models import layers as JL
from repro.nn import shapes_tree
from repro.runtime import train_step as JTS
from repro.schemes import build_scheme as j_build_scheme
from repro_torch.configs import ShapeConfig, WirelessConfig, get_arch
from repro_torch.core import channel as CH
from repro_torch.core import wire as W
from repro_torch.core.draws import Key
from repro_torch.data import pipeline as P
from repro_torch.models import api as M
from repro_torch.models import layers as L
from repro_torch.nn import tree_leaves
from repro_torch.runtime import train_step as TS
from repro_torch.schemes import build_scheme
from repro_torch.schemes.scaled import packet_sizes

JCFG = dataclasses.replace(jax_arch("qwen1.5-0.5b").reduced(), remat=False)
CFG = dataclasses.replace(get_arch("qwen1.5-0.5b").reduced(), remat=False)
JSHAPE = JShape("t", 16, 4, "train", microbatch=4)
SHAPE = ShapeConfig("t", 16, 4, "train", microbatch=4)
ATT_TOL, GRAD_TOL, LOSS_TOL = 2e-4, 2e-5, 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for torch while this file runs (the suite
    runs in several worker processes at once)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(tree):
    return jax.tree.map(lambda a: torch.from_numpy(np.array(a)), tree)


def _close(got, want, tol=GRAD_TOL):
    g, w = tree_leaves(got), jax.tree.leaves(want)
    assert len(g) == len(w)
    for a, b in zip(g, w):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b),
                                   rtol=tol, atol=tol)


def _equal(got, want):
    g, w = tree_leaves(got), jax.tree.leaves(want)
    assert len(g) == len(w)
    for a, b in zip(g, w):
        assert np.array_equal(a.detach().numpy(), np.asarray(b))


def _batch(seed, n=4, s=16, lead=()):
    x, _ = JP.synthetic_corpus(JCFG, int(np.prod(lead + (n,))), s, seed)
    x = x.reshape(lead + (n, s))
    return {"tokens": x, "labels": x}


def _tb(b):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in b.items()}


# ------------------------------------------------------------------ data
@pytest.mark.parametrize("full", [False, True])
def test_synthetic_corpus_and_batches_are_byte_identical(full):
    jc, c = ((jax_arch("qwen1.5-0.5b"), get_arch("qwen1.5-0.5b")) if full
             else (JCFG, CFG))
    x, y = P.synthetic_corpus(c, 64, 32, seed=3)
    jx, jy = JP.synthetic_corpus(jc, 64, 32, seed=3)
    assert x.dtype == jx.dtype and x.tobytes() == jx.tobytes()
    assert y.tobytes() == jy.tobytes()
    for a, b in zip(P.synthetic_lm_batches(c, 4, 8, seed=1),
                    JP.synthetic_lm_batches(jc, 4, 8, seed=1)):
        assert a["tokens"].tobytes() == b["tokens"].tobytes()
        break
    for a, b in zip(P.batches(x, y, 10, seed=2),
                    JP.batches(jx, jy, 10, seed=2)):
        assert a["tokens"].tobytes() == b["tokens"].tobytes()


# ------------------------------------------------------------ attention
@pytest.mark.parametrize("case", [
    dict(S=20, chunk=8, H=4, Hkv=4),                     # padding
    dict(S=16, chunk=8, H=4, Hkv=2),                     # GQA, G 2
    dict(S=24, chunk=8, H=4, Hkv=2, window=5),           # window
    dict(S=12, chunk=8, H=4, Hkv=4, kv_offset=7, Skv=19, causal=True),
    dict(S=16, chunk=16, H=2, Hkv=1, causal=False),
], ids=["pad", "gqa", "window", "kv_offset", "noncausal"])
def test_chunked_attention_matches_jax(case):
    S, Skv = case["S"], case.get("Skv", case["S"])
    jc = dataclasses.replace(JCFG, attn_chunk=case["chunk"])
    rng = np.random.default_rng(0)
    q = rng.standard_normal((2, S, case["H"], 16)).astype(np.float32)
    k = rng.standard_normal((2, Skv, case["Hkv"], 16)).astype(np.float32)
    v = rng.standard_normal((2, Skv, case["Hkv"], 16)).astype(np.float32)
    kw = dict(causal=case.get("causal", True),
              window=case.get("window", 0),
              kv_offset=case.get("kv_offset", 0))
    want = JL.chunked_attention(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), jc, **kw)
    got = L.chunked_attention(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v), jc, **kw)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=ATT_TOL)


def test_lm_loss_matches_jax():
    rng = np.random.default_rng(1)
    logits = rng.standard_normal((3, 12, 50)).astype(np.float32) * 3
    labels = rng.integers(0, 50, (3, 12)).astype(np.int32)
    labels[:, ::4] = 0                                    # padding
    want = float(JM.lm_loss(jnp.asarray(logits),
                            {"labels": jnp.asarray(labels)}, JCFG))
    got = float(M.lm_loss(torch.from_numpy(logits),
                          {"labels": torch.from_numpy(labels)}, CFG))
    assert abs(got - want) <= 1e-6 * abs(want)


def test_input_specs_are_jax_shapes_and_dtypes():
    for kind in ("train", "decode"):
        js = JM.input_specs(JCFG, JShape("t", 16, 4, kind))
        ps = M.input_specs(CFG, ShapeConfig("t", 16, 4, kind))
        assert {k: (tuple(v.shape), str(v.dtype)) for k, v in js.items()} \
            == {k: (s, str(d).replace("torch.", "")) for k, (s, d)
                in ps.items()}


# ------------------------------------------------------------ train step
def _j_state(wcfg=None, optimizer="adamw", seed=0):
    return JTS.init_train_state(jax.random.PRNGKey(seed), JCFG, wcfg,
                                optimizer)


@pytest.mark.parametrize("n_micro", [1, 2])
def test_adamw_train_step_matches_jax(n_micro):
    """Gradients of one step within 2e-5 of `jax.grad` of JAX's `_loss`
    (microbatch i on fold_in(key, i), summed in f32, / n_micro); the
    losses of 3 AdamW steps within 1e-4."""
    jshape = JShape("t", 16, 4, "train", microbatch=4 // n_micro)
    shape = ShapeConfig("t", 16, 4, "train", microbatch=4 // n_micro)
    js = _j_state()
    st = port_train_state(js)
    batch = _batch(5)
    key = jax.random.PRNGKey(9)
    # the accumulated gradient, as JAX's step forms it
    jg = None
    for i in range(n_micro):
        mb = jax.tree.map(lambda a: jnp.asarray(a).reshape(
            (n_micro, 4 // n_micro) + a.shape[1:])[i], batch)
        g = jax.grad(lambda t: JTS._loss(t, mb, JCFG, None,
                                         jax.random.fold_in(key, i), 0)[0])(
            js.trainable)
        jg = g if jg is None else jax.tree.map(jnp.add, jg, g)
    jg = jax.tree.map(lambda a: a / n_micro, jg)
    pg = None
    for i in range(n_micro):
        mb = {k: v.reshape((n_micro, 4 // n_micro) + v.shape[1:])[i]
              for k, v in _tb(batch).items()}
        _, g = TS.value_and_grad(st.trainable, mb, CFG, None,
                                 JaxKey(key).fold_in(i))
        pg = g if pg is None else jax.tree.map(torch.add, pg, g)
    _close(jax.tree.map(lambda a: a / n_micro, pg), jg)
    jstep = jax.jit(JTS.make_train_step(JCFG, jshape, None))
    step = TS.make_train_step(CFG, shape, None)
    jl, pl = [], []
    for s in range(3):
        b = _batch(20 + s)
        js, jm = jstep(js, b, jax.random.fold_in(key, s))
        st, m = step(st, _tb(b), JaxKey(key).fold_in(s))
        jl.append(float(jm["loss"]))
        pl.append(float(m["loss"]))
    np.testing.assert_allclose(pl, jl, rtol=0, atol=LOSS_TOL)
    assert st.opt_state.step == 3 and st.step == 3


def test_remat_gives_the_same_gradients():
    st = port_train_state(_j_state())
    b = _tb(_batch(6))
    _, g0 = TS.value_and_grad(st.trainable, b, CFG, None, Key(0))
    _, g1 = TS.value_and_grad(st.trainable, b,
                              dataclasses.replace(CFG, remat=True), None,
                              Key(0))
    for a, c in zip(tree_leaves(g0), tree_leaves(g1)):
        assert torch.equal(a, c)


def test_trainable_layout_is_jaxs():
    """The trainable tree has JAX's leaves, stacked layers included."""
    st = TS.init_train_state(torch.Generator().manual_seed(0), CFG,
                             device="cpu")
    want = jax.tree.leaves(shapes_tree(JM.param_specs(JCFG)))
    got = tree_leaves(st.trainable["model"])
    assert [tuple(g.shape) for g in got] == [tuple(w.shape) for w in want]


def test_dense_split_step_matches_jax():
    """One dense SL step (cut at layer 1 of 2, Q8 over 10 dB with ARQ):
    gradients within 2e-5 of `jax.grad` through JAX's custom-VJP
    crossing, on JAX's draws (both legs)."""
    kw = dict(mode="sl", quant_bits=8, snr_db=10.0, arq_attempts=3)
    jw, w = JW(**kw), WirelessConfig(**kw)
    js = _j_state(jw)
    st = port_train_state(js)
    b = _batch(7)
    key = jax.random.PRNGKey(4)
    jg = jax.grad(lambda t: JTS._loss(t, b, JCFG, jw, key, 0)[0])(
        js.trainable)
    (m, pg) = TS.value_and_grad(st.trainable, _tb(b), CFG, w, JaxKey(key))
    jm = JTS._loss(js.trainable, b, JCFG, jw, key, 0)[1]
    assert abs(float(m["loss"]) - float(jm["loss"])) <= LOSS_TOL
    _close(pg, jg)


def test_crossing_bf16_is_bit_exact():
    """channel_crossing of a bf16 [4, 16, 64] activation: forward and
    gradient leg bit for bit with JAX's, in JAX's output dtype."""
    rng = np.random.default_rng(2)
    x = rng.standard_normal((4, 16, 64)).astype(np.float32)
    g = rng.standard_normal((4, 16, 64)).astype(np.float32) * 0.05
    xj, gj = jnp.asarray(x, jnp.bfloat16), jnp.asarray(g, jnp.bfloat16)
    key = jax.random.PRNGKey(11)
    args = (8, 5.0, True, 0.5, False, 3, 0.25)
    y, vjp = jax.vjp(lambda a: JCH.channel_crossing(a, key, *args), xj)
    (dx,) = vjp(gj)
    xt = torch.from_numpy(np.array(xj.astype(jnp.float32))) \
        .to(torch.bfloat16).requires_grad_()
    yt = CH.channel_crossing(xt, JaxKey(key), *args)
    yt.backward(torch.from_numpy(np.array(gj.astype(jnp.float32)))
                .to(torch.bfloat16))
    assert yt.dtype == torch.bfloat16 and y.dtype == jnp.bfloat16
    assert xt.grad.dtype == torch.bfloat16 and dx.dtype == jnp.bfloat16
    bits = lambda a: np.asarray(a).view(np.uint16)         # noqa: E731
    assert np.array_equal(yt.detach().view(torch.int16).numpy()
                          .view(np.uint16), bits(y))
    assert np.array_equal(xt.grad.view(torch.int16).numpy()
                          .view(np.uint16), bits(dx))


def test_flip_words_drawn_in_slabs_are_one_stream(monkeypatch):
    """`Draws.words_u32` (slab by slab) gives the words of one `words`
    call on the same stream."""
    from repro_torch.core.draws import Draws
    want = Key(3, 4).draws().words("flip", (5, 16, 256))
    want = torch.where(want >= 2 ** 31, want - 2 ** 32, want).to(torch.int32)
    monkeypatch.setattr(Draws, "WORD_SLAB", 1000)
    got = Key(3, 4).draws().words_u32("flip", (5, 16, 256), "cpu")
    assert got.dtype == torch.int32 and torch.equal(got, want)


# ------------------------------------------------------- full-width bills
def test_full_width_packets_and_bills_without_weights():
    """qwen1.5-0.5b's FL packets are JAX's leaves: 14, 463,987,712
    elements, 1,812,452 wire rows, 3,711,901,696 bits per user per Q8
    cycle (int4: half); the SL leg at batch 8, seq 128, compress 4 is
    262,144 elements (4,194,304 bits a Q8 step, both legs); the CL
    corpus 18 bits a token. Nothing is allocated."""
    jc, c = jax_arch("qwen1.5-0.5b"), get_arch("qwen1.5-0.5b")
    want = [int(np.prod(s.shape))
            for s in jax.tree.leaves(shapes_tree(JM.param_specs(jc)))]
    sizes = packet_sizes(c)
    assert sizes.tolist() == want and len(want) == 14
    assert int(sizes.sum()) == 463_987_712
    assert sum(-(-int(s) // W.WIRE_COLS) for s in sizes) == 1_812_452
    fl = build_scheme(WirelessConfig(mode="fl", quant_bits=8), cfg=c,
                      device="cpu")
    assert fl.radio.wire_width() * float(fl._packet_sizes.sum()) \
        == 3_711_901_696
    int4 = build_scheme(WirelessConfig(mode="fl", quant_bits=4,
                                       wire_dtype="int4"), cfg=c,
                        device="cpu")
    assert int4.radio.wire_width() * float(int4._packet_sizes.sum()) \
        == 1_855_950_848
    sl = build_scheme(WirelessConfig(mode="sl", quant_bits=8), cfg=c,
                      device="cpu")
    assert sl._leg_elems == 262_144 and sl._n_micro == 1
    assert 2 * sl._leg_elems * 8 == 4_194_304
    assert (c.vocab_size - 1).bit_length() == 18


# ------------------------------------------------------------------ FLOPs
def test_flop_counts_against_xla():
    """CL's and SL's FlopCounterMode count of one step within a factor 2
    of JAX's XLA cost analysis; SL's user share is cut / n_layers."""
    out = {}
    for mode, jw, w in (("cl", None, None),
                        ("sl", JW(mode="sl", quant_bits=8),
                         WirelessConfig(mode="sl", quant_bits=8))):
        js = j_build_scheme(jw, cfg=JCFG, shape=JSHAPE)
        ps = build_scheme(w, cfg=CFG, shape=SHAPE, device="cpu")
        jf, pf = js._step_cost_flops(), ps._step_cost_flops()
        out[mode] = (pf, jf)
        assert 0.5 <= pf / jf <= 2.0, (mode, pf, jf)
        u, s = ps.flops(3)
        assert (u, s) == ((0.0, 3 * pf) if mode == "cl" else
                          (3 * pf * 0.5, 3 * pf * 0.5))
    print(f"FLOPs per step (port FlopCounterMode, JAX XLA): {out}")


def test_flop_counts_equal_jax_dry_run_dot_flops():
    """CL's and SL's FlopCounterMode count of one step equals, exactly,
    the matmul FLOPs of JAX's compiled step (launch/hlo_analysis.py's
    trip-count-scaled `dot_flops`, what its dry run records): 610,271,232
    and 622,854,144. XLA's `cost_analysis`, which the test above holds
    within a factor 2, counts a scan's body once."""
    from repro.launch.hlo_analysis import analyze
    for mode, jw, w, want in (
            ("cl", None, None, 610_271_232),
            ("sl", JW(mode="sl", quant_bits=8),
             WirelessConfig(mode="sl", quant_bits=8), 622_854_144)):
        js = j_build_scheme(jw, cfg=JCFG, shape=JSHAPE)
        ps = build_scheme(w, cfg=CFG, shape=SHAPE, device="cpu")
        hlo = js._lower_for_cost().compile().as_text()
        assert analyze(hlo)["dot_flops"] == want, mode
        assert ps._step_cost_flops() == want, mode
