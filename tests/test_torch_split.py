"""Port parity for the tiny model's inference kernels and the two-party
split-learning protocol against the JAX package.

* K3 (conv+ReLU+pool) and K4 (the LSTM recurrence): the port's plain
  versions, which the CPU runs and the card's kernels are held to,
  against the JAX Pallas kernels in interpret mode and the JAX plain
  versions, within 2e-5 (the JAX suite's tolerance for both, since
  float32 products are summed in another order).
* The port's no-grad forward of the paper model against JAX's on the
  same weights, within 2e-5 for the same reason.
* `SLSession` with the JAX session's weights and the JAX package's
  draws (`JaxKey`): bills EXACT; weights after three steps within 2e-5
  (a crossing quantizes the activation at Q16, so an ulp's difference
  in the forward can move a code by one level); the lr is a per-call
  argument, as the JAX session's is traced.
* A two-party `Experiment` cycle against a live JAX run: bills exact,
  test accuracy within 1/n_test, train loss within 1e-3.

Everything runs on the CPU (the kernels' plain versions)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _jax_keys import JaxKey
from repro.configs import get_arch as jax_arch
from repro.configs.base import WirelessConfig as JWirelessConfig
from repro.data import sentiment as JDS
from repro.kernels.conv_pool.ops import user_conv_pool as j_conv_pool
from repro.kernels.conv_pool.ref import conv_pool_ref as j_conv_pool_ref
from repro.kernels.lstm_cell.kernel import lstm_final_state as j_lstm
from repro.kernels.lstm_cell.ref import lstm_final_state_ref as j_lstm_ref
from repro.models import lstm_tiny as JLT
from repro.nn import init_params as jax_init
from repro.runtime.sl_runtime import SLSession as JSLSession
from repro.schemes import Experiment as JExperiment
from repro.schemes import build_scheme as j_build_scheme
from repro_torch.configs import WirelessConfig, get_arch
from repro_torch.kernels.conv_pool import ops as cp
from repro_torch.kernels.conv_pool.ref import conv_pool_ref
from repro_torch.kernels.lstm_cell import ops as lc
from repro_torch.kernels.lstm_cell.ref import lstm_final_state_ref
from repro_torch.models import lstm_tiny as LT
from repro_torch.nn import params_from_jax, tree_leaves
from repro_torch.runtime.sl_runtime import SLSession
from repro_torch.schemes import Experiment, build_scheme

JCFG, CFG = jax_arch("paper-tinylstm"), get_arch("paper-tinylstm")
TOL = 2e-5
N_TRAIN, N_TEST = 3072, 512


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for torch while this file runs: the suite runs
    in several worker processes at once, and torch's spinning thread
    pool slows down by an order of magnitude when they oversubscribe
    the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol,
                               atol=tol)


# ------------------------------------------------------------ K3 and K4
# shapes drawn from tests/test_kernels.py's sweeps (b, t, e, f / b, t, h)
@pytest.mark.parametrize("b,t,e,f", [(1, 30, 8, 32), (4, 10, 16, 64),
                                     (8, 64, 8, 32), (16, 30, 16, 64),
                                     (8, 30, 8, 64), (16, 10, 8, 32)])
def test_conv_pool_plain_matches_jax_kernel(b, t, e, f):
    rng = np.random.default_rng(b * 100 + t + e + f)
    x = rng.standard_normal((b, t, e)).astype(np.float32)
    w = (rng.standard_normal((3, e, f)) * 0.2).astype(np.float32)
    bias = (rng.standard_normal(f) * 0.1).astype(np.float32)
    got = cp.user_conv_pool(_t(x), _t(w), _t(bias))    # CPU: the plain one
    assert got.shape == (b, (t - 2) // 2, f)
    _close(got, j_conv_pool(jnp.asarray(x), jnp.asarray(w),
                            jnp.asarray(bias), interpret=True))
    _close(got, j_conv_pool_ref(jnp.asarray(x), jnp.asarray(w),
                                jnp.asarray(bias)))
    _close(conv_pool_ref(_t(x), _t(w), _t(bias)), got, 0)


@pytest.mark.parametrize("b,t,h", [(1, 14, 32), (4, 1, 8), (16, 7, 32),
                                   (4, 30, 32), (1, 30, 8), (16, 14, 8)])
def test_lstm_plain_matches_jax_kernel(b, t, h):
    rng = np.random.default_rng(b * 100 + t + h)
    xw = rng.standard_normal((b, t, 4 * h)).astype(np.float32)
    wh = (rng.standard_normal((h, 4 * h)) * 0.1).astype(np.float32)
    h_p, c_p = lc.lstm_final_state(_t(xw), _t(wh))
    for jh, jc in (j_lstm(jnp.asarray(xw), jnp.asarray(wh), interpret=True),
                   j_lstm_ref(jnp.asarray(xw), jnp.asarray(wh))):
        _close(h_p, jh)
        _close(c_p, jc)
    h_r, c_r = lstm_final_state_ref(_t(xw), _t(wh))
    assert torch.equal(h_r, h_p) and torch.equal(c_r, c_p)


def test_no_grad_forward_matches_jax_and_the_kernels_compose_it():
    """The model's no-grad forward, its user side through K3's wrapper
    and its LSTM through `lstm_layer` (K4's wrapper), on the JAX
    package's weights, all within 2e-5 of JAX."""
    jp = jax_init(jax.random.PRNGKey(4), JLT.model_specs(JCFG))
    p = params_from_jax(jp, CFG, "cpu")
    (x, _), _ = JDS.make_splits(256, seed=4)
    tokens = x[:64]
    with torch.no_grad():
        logits, _ = LT.forward(p, {"tokens": torch.from_numpy(tokens)})
    jl, _ = JLT.forward(jp, {"tokens": jnp.asarray(tokens)})
    _close(logits, jl)
    emb = p["embed"][torch.from_numpy(tokens).long()]
    smashed = cp.user_conv_pool(emb, p["conv_w"], p["conv_b"])
    js = JLT.user_forward(jp, jnp.asarray(tokens))
    _close(smashed, js)
    h = lc.lstm_layer(smashed, p["lstm_wx"], p["lstm_wh"], p["lstm_b"])
    _close(h, JLT.lstm_scan(jp, js))


# ------------------------------------------------------------ SLSession
def _session_pair(wcfg_kw, lr=0.1, seed=0):
    """A JAX SLSession and the port's on the same weights."""
    js = JSLSession(JCFG, JWirelessConfig(**wcfg_kw),
                    jax.random.PRNGKey(seed), lr=lr)
    return js, _port_session(js, WirelessConfig(**wcfg_kw), lr)


def _port_session(js, wcfg, lr):
    full = dict(js.user_params, **js.server_params,
                sem_enc=js.user_codec["enc"], sem_dec=js.server_codec["dec"])
    return SLSession(CFG, wcfg, params_from_jax(full, device="cpu"), lr=lr)


def _step(sess, tokens, labels, keys, key_of, lr=None):
    up = sess.user_uplink(tokens, key_of(keys[0]))
    down = sess.server_step(up, labels, key_of(keys[1]), lr=lr)
    sess.user_downlink(down, lr=lr)
    return up, down


def _session_leaves(sess):
    return tree_leaves({"u": sess.user_params, "uc": sess.user_codec,
                        "s": sess.server_params, "sc": sess.server_codec})


def test_sl_session_matches_jax_with_its_draws():
    """Three steps at Q16 (tests/test_system.py's session): the same bills
    leg by leg, weights within 2e-5, logits of `predict` within 2e-5."""
    js, ps = _session_pair(dict(mode="sl", quant_bits=16))
    (x, y), _ = JDS.make_splits(1024, seed=0)
    for s in range(3):
        tok, lab = x[s * 256:(s + 1) * 256], y[s * 256:(s + 1) * 256]
        keys = (jax.random.PRNGKey(10 + s), jax.random.PRNGKey(20 + s))
        jup, jdown = _step(js, jnp.asarray(tok), jnp.asarray(lab), keys,
                           lambda k: k)
        up, down = _step(ps, torch.from_numpy(tok), torch.from_numpy(lab),
                         keys, JaxKey)
        assert (up.bits, up.n_tx, up.energy_j) == \
            (jup.bits, jup.n_tx, jup.energy_j)
        assert (down.bits, down.n_tx, down.energy_j) == \
            (jdown.bits, jdown.n_tx, jdown.energy_j)
        assert up.bits == 256 * 14 * 8 * 16
        assert abs(float(ps.last_loss) - float(js.last_loss)) <= TOL
    assert ps.total_bits == js.total_bits == 3 * 2 * 256 * 14 * 8 * 16
    jleaves = jax.tree.leaves({"u": js.user_params, "uc": js.user_codec,
                               "s": js.server_params,
                               "sc": js.server_codec})
    for g, w in zip(_session_leaves(ps), jleaves):
        _close(g, w)
    k = jax.random.PRNGKey(99)
    _close(ps.predict(torch.from_numpy(x[:128]), JaxKey(k)),
           js.predict(jnp.asarray(x[:128]), k))


def test_sl_session_lr_is_a_call_argument():
    """Stepping a session built with lr 0.1 at lr 0.02 gives bitwise the
    weights of a session built with lr 0.02 stepped with None, and not
    those of lr 0.1 (tests/test_system.py's traced-lr check)."""
    (x, y), _ = JDS.make_splits(512, seed=1)
    tok, lab = torch.from_numpy(x[:256]), torch.from_numpy(y[:256])

    def one_step(construct_lr, step_lr):
        _, ps = _session_pair(dict(mode="sl", quant_bits=16),
                              lr=construct_lr)
        _step(ps, tok, lab, (jax.random.PRNGKey(1), jax.random.PRNGKey(2)),
              JaxKey, lr=step_lr)
        return _session_leaves(ps)

    a, ref, c = one_step(0.1, 0.02), one_step(0.02, None), one_step(0.1, 0.1)
    assert all(torch.equal(p, q) for p, q in zip(a, ref))
    assert any(not torch.equal(p, q) for p, q in zip(a, c))


# ------------------------------------------------- two-party Experiment
def _corpus():
    from repro.schemes.base import corpus
    return corpus(N_TRAIN, N_TEST, 0)


def test_two_party_experiment_matches_live_jax():
    jw = JWirelessConfig(mode="sl", quant_bits=8, snr_db=20.0)
    w = WirelessConfig(mode="sl", quant_bits=8, snr_db=20.0)
    jexp = JExperiment(j_build_scheme(jw, protocol="two_party"), cycles=1,
                       seed=0, n_train=N_TRAIN, n_test=N_TEST)
    jres = jexp.run()

    def on_init(state):
        jstate, _ = j_build_scheme(jw, protocol="two_party").init(
            0, *_corpus()[0])
        return dataclasses.replace(
            state, train=_port_session(jstate.train, w, 0.1))

    scheme = build_scheme(w, protocol="two_party", device="cpu",
                          key=JaxKey.root)
    exp = Experiment(scheme, cycles=1, seed=0, n_train=N_TRAIN,
                     n_test=N_TEST, on_init=on_init)
    res = exp.run()
    for r, jr in zip(exp.reports, jexp.reports):
        assert (r.bits, r.n_tx, r.energy_j, r.steps) == \
            (jr.bits, jr.n_tx, jr.energy_j, jr.steps)
    assert res.total_bits == jres.total_bits == \
        (N_TRAIN // 512) * 2 * 512 * 14 * 8 * 8
    np.testing.assert_allclose(res.accuracy, jres.accuracy, rtol=0,
                               atol=1 / N_TEST)
    np.testing.assert_allclose(res.loss, jres.loss, rtol=0, atol=1e-3)
    assert (res.user_flops, res.server_flops) == \
        (jres.user_flops, jres.server_flops)
