"""The in-place train step against the functional one and against JAX, on
the CPU: AdamW (optim/adamw.py) updates its state leaf by leaf in place,
and `make_train_step` sums its microbatches into the first microbatch's
gradient (runtime/train_step.py), the port's counterpart of the JAX
step's donated state.

(a) The in-place AdamW gives the functional expression's bits over 3
steps, -0.0, +0.0 and subnormal gradient entries and weight decay
included; the whole step gives the bits of the functional step it
replaced (`zeros + g` accumulators, a new tree per update), at one and at
two microbatches. (b) `make_train_step` on the reduced MoE and vlm
configs, CL and SL (cut at layer 1 over a perfect Q16 link): every state
leaf comes back in its own storage, and the loss, the load-balance loss
and the state are within the JAX suite's tolerances of the live JAX
step on its own weights and draws (losses 1e-4 as tests/test_torch_moe.py
and tests/test_torch_vlm.py hold them, the state 2e-5 as their
gradients). (c) The full-width bills of chip_smoke.py phase 12 (e), from
shapes only, equal JAX's formulas and the numbers the script gates."""
import dataclasses
import importlib.util
import math
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from _jax_keys import JaxKey, port_train_state
from _torch_parity import (check_adamw_in_place, functional_adamw,
                           same_bits)
from repro.configs import get_arch as jax_arch
from repro.configs.base import ShapeConfig as JShape
from repro.configs.base import WirelessConfig as JW
from repro.core import centralized as JCEN
from repro.core import split as JSPLIT
from repro.runtime import train_step as JTS
from repro_torch.configs import ShapeConfig, WirelessConfig, get_arch
from repro_torch.core import centralized as CEN
from repro_torch.core.draws import Key
from repro_torch.models import api as M
from repro_torch.nn import (count_params, tree_leaves, tree_map,
                            tree_unflatten)
from repro_torch.optim import AdamWState
from repro_torch.runtime import train_step as TS
from repro_torch.schemes import build_scheme
from repro_torch.schemes.scaled import DEFAULT_SHAPE

ROOT = Path(__file__).resolve().parents[1]
STATE_TOL, LOSS_TOL, LR = 2e-5, 1e-4, 3e-4
JSHAPE = JShape("t", 16, 4, "train", microbatch=4)
SHAPE = ShapeConfig("t", 16, 4, "train", microbatch=4)
SL = dict(mode="sl", quant_bits=16, perfect_channel=True, split_layer=1)
WIDE = ("qwen3-moe-235b-a22b", "llama4-scout-17b-a16e", "internvl2-76b")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _state_leaves(st):
    return (tree_leaves(st.trainable) + tree_leaves(st.opt_state.mu)
            + tree_leaves(st.opt_state.nu))


def clone_state(st):
    """A copy of a TrainState that no step shares."""
    def copy(x):
        return tree_map(torch.clone, x) if isinstance(x, dict) else x
    return TS.TrainState(copy(st.trainable),
                         type(st.opt_state)(*map(copy, st.opt_state)),
                         st.step)


def _batch(cfg, seed):
    rng = np.random.default_rng(seed)
    x = rng.integers(1, cfg.vocab_size, (4, 16), dtype=np.int32)
    b = {"tokens": x, "labels": x}
    if cfg.n_frontend_tokens:
        b["patch_embeds"] = (0.1 * rng.standard_normal(
            (4, cfg.n_frontend_tokens, cfg.d_model))).astype(np.float32)
    return b


def _tb(b):
    return {k: torch.from_numpy(np.array(v)) for k, v in b.items()}


# ------------------------------------------------------------------- (a)
@pytest.mark.parametrize("weight_decay", [0.0, 0.01])
def test_adamw_in_place_equals_the_functional_expression(weight_decay):
    """3 updates: weights, mu and nu bit for bit the functional
    expression's, in the storage they came in; the gradients untouched."""
    check_adamw_in_place({"a": (16, 8), "b": (8,), "c": (3, 5, 7)}, 0,
                         "cpu", weight_decay)


def test_accumulator_copies_shared_and_expanded_gradients():
    """Autograd may hand two leaves one tensor (`a + b`) and a leaf an
    expanded one (`c.sum()`); the accumulator copies those before it
    writes in place, so a second microbatch adds into each leaf alone."""
    a, b, c = (torch.randn(4, requires_grad=True) for _ in range(3))
    x = torch.randn(4)

    def grads():
        return dict(zip("abc", torch.autograd.grad(
            ((a + b) * x).sum() + c.sum(), [a, b, c])))
    g0 = grads()
    assert g0["a"] is g0["b"] and not g0["c"].is_contiguous()
    acc = TS._accumulator(g0)
    assert len({t.data_ptr() for t in acc}) == 3
    for t, g in zip(acc, tree_leaves(grads())):
        t.add_(g)
    assert all(torch.equal(t, 2 * g) for t, g in zip(acc,
                                                     tree_leaves(grads())))


def _functional_step(cfg, shape, lr=3e-4):
    """The train step as it was before it updated in place: `zeros + g`
    f32 accumulators, `/ n_micro`, AdamW as a functional expression and
    a new state."""
    n_micro = TS.auto_microbatch(cfg, shape)

    def step(state, batch, key):
        g_acc = loss = None
        for i in range(n_micro):
            mb = {k: v.reshape((n_micro, v.shape[0] // n_micro)
                               + tuple(v.shape[1:]))[i]
                  for k, v in batch.items()}
            m, g = TS.value_and_grad(state.trainable, mb, cfg, None,
                                     key.fold_in(i))
            if g_acc is None:
                g_acc = [torch.zeros_like(b) + b.float()
                         for b in tree_leaves(g)]
                loss = torch.zeros_like(m["loss"]) + m["loss"]
            else:
                g_acc = [a + b.float() for a, b in zip(g_acc, tree_leaves(g))]
                loss = loss + m["loss"]

        def flat(tree):
            return dict(enumerate(tree_leaves(tree)))
        w, mu, nu = functional_adamw(
            dict(enumerate(a / n_micro for a in g_acc)),
            flat(state.opt_state.mu), flat(state.opt_state.nu),
            flat(state.trainable), state.opt_state.step + 1, lr)

        def tree(d):
            return tree_unflatten(state.trainable, [d[i] for i in sorted(d)])
        return TS.TrainState(tree(w), AdamWState(
            tree(mu), tree(nu), state.opt_state.step + 1),
            state.step + 1), loss / n_micro
    return step


@pytest.mark.parametrize("n_micro", [1, 2])
def test_train_step_keeps_the_functional_steps_bits(n_micro):
    """2 AdamW steps of the reduced qwen1.5-0.5b: every state leaf and
    the loss bit for bit those of the functional step, the state in its
    own storage."""
    cfg = dataclasses.replace(get_arch("qwen1.5-0.5b").reduced(),
                              remat=False)
    shape = ShapeConfig("t", 16, 4, "train", microbatch=4 // n_micro)
    st = TS.init_train_state(torch.Generator().manual_seed(0), cfg,
                             device="cpu")
    ref = clone_state(st)
    ptrs = [t.data_ptr() for t in _state_leaves(st)]
    step, old = TS.make_train_step(cfg, shape), _functional_step(cfg, shape)
    for s in range(2):
        b, key = _tb(_batch(cfg, 30 + s)), Key(5).fold_in(s)
        st, m = step(st, b, key)
        ref, loss = old(ref, b, key)
        assert all(same_bits(a, w) for a, w in zip(_state_leaves(st),
                                                  _state_leaves(ref)))
        assert same_bits(m["loss"], loss)
    assert [t.data_ptr() for t in _state_leaves(st)] == ptrs


# ------------------------------------------------------------------- (b)
@pytest.mark.parametrize("mode", ["cl", "sl"])
@pytest.mark.parametrize("name", WIDE)
def test_in_place_step_matches_jax(name, mode):
    """One AdamW step of `make_train_step` against the live JAX step
    from JAX's weights and draws: the state in its own storage, the loss
    and load-balance loss within 1e-4, the moments within 2e-5 abs +
    rel, and every weight within 2e-5 abs + rel or, where JAX's gradient
    lies within 2e-5 of zero (AdamW divides a gradient by its own
    magnitude, so there its sign is float error), within 2 lr."""
    jcfg = dataclasses.replace(jax_arch(name).reduced(), remat=False)
    cfg = dataclasses.replace(get_arch(name).reduced(), remat=False)
    jw, w = (JW(**SL), WirelessConfig(**SL)) if mode == "sl" \
        else (None, None)
    js = JTS.init_train_state(jax.random.PRNGKey(1), jcfg, jw, "adamw")
    st = port_train_state(js)
    ptrs = [t.data_ptr() for t in _state_leaves(st)]
    b, key = _batch(cfg, 40), jax.random.PRNGKey(6)
    js, jm = jax.jit(JTS.make_train_step(jcfg, JSHAPE, jw, lr=LR))(
        js, b, key)
    st, m = TS.make_train_step(cfg, SHAPE, w, lr=LR)(st, _tb(b),
                                                     JaxKey(key))
    assert [t.data_ptr() for t in _state_leaves(st)] == ptrs
    for k in ("loss", "aux_loss"):
        np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=0,
                                   atol=LOSS_TOL, err_msg=k)
    if cfg.is_moe:
        assert float(m["aux_loss"]) > 0
    jmu = [np.asarray(a) for a in jax.tree.leaves(js.opt_state.mu)]
    moments = zip(tree_leaves(st.opt_state.mu) + tree_leaves(st.opt_state.nu),
                  jmu + jax.tree.leaves(js.opt_state.nu))
    for a, b in moments:
        np.testing.assert_allclose(a.numpy(), np.asarray(b),
                                   rtol=STATE_TOL, atol=STATE_TOL)
    weights = tree_leaves(st.trainable)
    assert len(weights) == len(jmu) and st.opt_state.step == 1
    for a, b, mu in zip(weights, jax.tree.leaves(js.trainable), jmu):
        a, b = a.numpy(), np.asarray(b)
        far = np.abs(a - b) > STATE_TOL + STATE_TOL * np.abs(b)
        grad = mu[far] / (1 - 0.9)          # mu after one step: 0.1 g
        assert np.all(np.abs(grad) <= STATE_TOL), grad
        assert np.all(np.abs(a - b)[far] <= 2 * LR)


# ------------------------------------------------------------------- (c)
def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("name", WIDE)
def test_full_width_bills_from_shapes(name):
    """At chip_smoke.py phase 12 (e)'s depth and the training CLI's
    corpus (512 rows, batch 8, seq 128; SL compress 4 at Q8): the CL
    corpus bits, SL's bits a step, K1's rows a leg and the parameter
    count from the port's meta shapes equal JAX's (its formulas and
    `jax.eval_shape`) and what the script gates."""
    cs = _chip_smoke()
    layers = cs.WIDE_LAYERS[name]
    jcfg = dataclasses.replace(jax_arch(name), **layers)
    cfg = dataclasses.replace(get_arch(name), **layers)
    kw = dict(mode="sl", quant_bits=8, snr_db=20.0, split_layer=2,
              compress_factor=4)
    rows = cs.SCALED_N_TRAIN * DEFAULT_SHAPE.seq_len
    cl = CEN.token_bits(cfg.vocab_size) * rows
    assert cl == JCEN.token_bits(jcfg.vocab_size) * rows \
        == cs.WIDE_BILLS[name][0]
    sl = build_scheme(WirelessConfig(**kw), cfg=cfg, device="cpu")
    jshape = JShape("scaled", 128, 8, "train", microbatch=8)
    leg = JSPLIT.crossing_elems(jcfg, jshape, JW(**kw))
    assert sl._leg_elems == leg and sl._n_micro == 1
    assert 2 * 8 * sl._leg_elems == cs.WIDE_BILLS[name][1]
    assert leg % 256 == 0 and leg // 256 == {
        "qwen3-moe-235b-a22b": 4_096, "llama4-scout-17b-a16e": 5_120,
        "internvl2-76b": 40_960}[name]
    meta = TS.train_state_sds(cfg)
    jsds = jax.eval_shape(lambda k: JTS.init_train_state(k, jcfg, None,
                                                         "adamw"),
                          jax.random.PRNGKey(0))
    n = sum(math.prod(t.shape) for t in tree_leaves(meta.trainable))
    assert all(t.is_meta for t in tree_leaves(meta.trainable))
    assert n == count_params(M.train_param_specs(cfg)) \
        == sum(math.prod(a.shape) for a in jax.tree.leaves(
            jsds.trainable)) == cs.WIDE_PARAMS[name]
