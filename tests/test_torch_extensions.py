"""Port parity for the FL/SL options and link extensions of the JAX
package's extension study (benchmarks/extensions.py): Hamming(7,4)
coding, M-QAM, DP-FedAvg, Dirichlet shards, FedProx,
sample-with-replacement batching, the coordinate-median aggregate and
SL's `perfect_eval`, plus `EnergyReport`.

The port is handed the JAX package's weights and random streams
(`JaxDraws`/`JaxKey`, tests/_jax_keys.py; DP's noise as JAX's own
normals). Then:

* codes, shards, bills and the median sync are EXACT;
* the coded and QAM links are bit-exact given the same draws, and the
  bit error probabilities lie within 1e-6 relative of JAX's (the port
  evaluates erfc in float64, JAX in float32);
* privatized updates, DP syncs and a FedProx step agree within 2e-5
  (the tiny-model tolerance): float32 sums in another order;
* 2-cycle `Experiment`s agree with a live JAX run as in
  tests/test_torch_paper.py: accuracy within 2/512, loss within 1e-3.

Everything runs on the CPU (the kernels' plain versions)."""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _jax_keys import JaxDraws, JaxKey
from repro.configs import get_arch as jax_arch
from repro.configs.base import WirelessConfig as JWirelessConfig
from repro.core import coding as JC
from repro.core import dp as JDP
from repro.core import energy as JE
from repro.core import federated as JFED
from repro.core import modulation as JMOD
from repro.data import sentiment as JDS
from repro.models import lstm_tiny as JLT
from repro.nn import init_params as jax_init
from repro.runtime.sl_runtime import SLSession as JSLSession
from repro.runtime.train_step import init_train_state as j_init_state
from repro.runtime.train_step import make_local_step as j_local_step
from repro.schemes import Experiment as JExperiment
from repro.schemes.federated import FederatedScheme as JFederatedScheme
from repro.schemes.split import evaluate_sl as j_evaluate_sl
from repro_torch.configs import WirelessConfig, get_arch
from repro_torch.core import coding as C
from repro_torch.core import dp as DP
from repro_torch.core import energy as E
from repro_torch.core import federated as FED
from repro_torch.core import modulation as MOD
from repro_torch.data import sentiment as DS
from repro_torch.nn import params_from_jax, tree_leaves
from repro_torch.optim import SGDState
from repro_torch.runtime.sl_runtime import SLSession
from repro_torch.runtime.train_step import TrainState, make_local_step
from repro_torch.schemes import Experiment
from repro_torch.schemes.federated import FederatedScheme
from repro_torch.schemes.split import SplitScheme, evaluate_sl

JCFG, CFG = jax_arch("paper-tinylstm"), get_arch("paper-tinylstm")
N_TRAIN, N_TEST = 3072, 512          # tests/test_torch_paper.py's corpus
TOL = 2e-5
ACC_TOL, LOSS_TOL = 2 / 512, 1e-3
P_RTOL = 1e-6


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this file runs (the suite runs several
    worker processes at once; see tests/test_torch_paper.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _tree(jtree):
    return params_from_jax(jax.tree.map(np.asarray, jtree), device="cpu")


def _close(got, want, tol=TOL):
    for g, w in zip(tree_leaves(got), jax.tree.leaves(want)):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w),
                                   rtol=0, atol=tol)


def _equal(got, want):
    for g, w in zip(tree_leaves(got), jax.tree.leaves(want)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def _weights(n: int = 89_673, seed: int = 0) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal(n).astype(np.float32)


def _p_close(got, want):
    """Bit error probabilities within P_RTOL relative wherever the link
    can flip a bit (p >= 2^-32, a flip threshold p * 2^32 of 1 or more).
    Below that both give the flip threshold 0: there JAX's float32 erfc
    loses relative accuracy deep in the tail (1.1e-6 at p 8e-18) or
    flushes to 0 where the float64 erfc keeps a denormal."""
    got, want = float(got), float(want)
    if max(got, want) >= 2.0 ** -32:
        assert got == pytest.approx(want, rel=P_RTOL, abs=0)
    else:
        assert int(np.float32(got) * np.float32(2 ** 32)) == \
            int(np.float32(want) * np.float32(2 ** 32)) == 0


# ---------------------------------------------------------------- coding
@pytest.mark.parametrize("bits", [4, 8, 16])
def test_hamming_roundtrip_matches_jax(bits):
    words = jax.random.bits(jax.random.PRNGKey(bits), (256,), jnp.uint32) \
        & jnp.uint32(2 ** bits - 1)
    jblocks, jcb = JC.hamming_encode(words, bits)
    blocks, cb = C.hamming_encode(_t(words).long(), bits)
    assert cb == jcb == -(-bits // 4) * 7
    np.testing.assert_array_equal(blocks.numpy(), np.asarray(jblocks))
    out = C.hamming_decode(blocks, bits)
    np.testing.assert_array_equal(out.numpy(), np.asarray(words))


def test_hamming_corrects_single_bit_errors():
    words = torch.arange(16)
    blocks, _ = C.hamming_encode(words, 4)
    for bit in range(7):
        got = C.hamming_decode(blocks ^ (1 << bit), 4)
        want = JC.hamming_decode(jnp.asarray(blocks.numpy(), jnp.uint32)
                                 ^ jnp.uint32(1 << bit), 4)
        assert torch.equal(got, words)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("snr_db,fading", [(5.0, True), (3.0, False),
                                           (12.0, True)])
def test_coded_transmission_bit_exact(snr_db, fading):
    """The model's 89,673 weights at Q8 through Hamming(7,4) on JAX's
    draws: the same outputs bit for bit, the same payload (x 14/8)."""
    x = _weights()
    key = jax.random.PRNGKey(int(snr_db))
    jy, jbits = JC.transmit_quantized_coded(key, jnp.asarray(x), 8, snr_db,
                                            fading=fading)
    y, bits = C.transmit_quantized_coded(JaxDraws(key), torch.from_numpy(x),
                                         8, snr_db, fading=fading)
    np.testing.assert_array_equal(y.numpy(), np.asarray(jy))
    assert bits == jbits == 89_673 * 14


@pytest.mark.parametrize("p", [0.0, 1e-4, 1e-3, 1e-2, 0.1, 0.3])
def test_block_error_prob_matches_jax(p):
    for corrected in (True, False):
        assert C.block_error_prob(p, corrected) == \
            JC.block_error_prob(p, corrected)
    if 0 < p < 0.5:
        assert C.block_error_prob(p, True) < C.block_error_prob(p, False)


# ------------------------------------------------------------ modulation
@pytest.mark.parametrize("modulation", ["bpsk", "qpsk", "16qam", "64qam"])
def test_bit_error_prob_matches_jax(modulation):
    for snr in (-3.0, 0.0, 5.0, 10.0, 20.0, 30.0):
        for f2 in (1.0, 0.05, 0.3, 2.5):
            _p_close(MOD.bit_error_prob(modulation, snr, f2),
                     JMOD.bit_error_prob(modulation, snr, jnp.float32(f2)))
    assert MOD.bits_per_symbol(modulation) == \
        JMOD.bits_per_symbol(modulation)
    assert MOD.comm_time_scale(modulation) == \
        JMOD.comm_time_scale(modulation)


def test_qam_ber_ordering():
    bers = [float(MOD.bit_error_prob(m, 10.0))
            for m in ("bpsk", "16qam", "64qam")]
    assert bers[0] < bers[1] < bers[2]
    assert MOD.SUPPORTED == JMOD.SUPPORTED


@pytest.mark.parametrize("modulation", ["bpsk", "qpsk", "16qam", "64qam"])
@pytest.mark.parametrize("snr_db,fading", [(5.0, True), (8.0, False)])
def test_mod_transmission_bit_exact(modulation, snr_db, fading):
    x = _weights(20_000, 1)
    key = jax.random.PRNGKey(7)
    jy, jd = JMOD.transmit_quantized_mod(key, jnp.asarray(x), 8, snr_db,
                                         modulation, fading=fading)
    y, d = MOD.transmit_quantized_mod(JaxDraws(key), torch.from_numpy(x),
                                      8, snr_db, modulation, fading=fading)
    np.testing.assert_array_equal(y.numpy(), np.asarray(jy))
    assert d["symbols"] == jd["symbols"]
    assert float(d["f2"]) == float(jd["f2"])
    _p_close(d["ber"], jd["ber"])


# ---------------------------------------------------------------- DP
def _user_stack(seed: int, n: int):
    """A broadcast model and `n` users' local models around it."""
    jp = jax_init(jax.random.PRNGKey(seed), JLT.model_specs())
    up = jax.tree.map(
        lambda p: jnp.stack([p + 0.01 * (u + 1) * jax.random.normal(
            jax.random.PRNGKey(seed + 10 + u), p.shape) for u in range(n)]),
        jp)
    return jp, up


@pytest.mark.parametrize("sigma", [0.0, 1.0])
def test_privatize_update_matches_jax(sigma):
    jp, up = _user_stack(0, 1)
    delta = jax.tree.map(lambda a, b: a[0] - b, up, jp)
    key = jax.random.PRNGKey(3)
    want = JDP.privatize_update(key, delta, clip_c=1.0, sigma=sigma)
    got = DP.privatize_update(JaxKey(key), _tree(delta), 1.0, sigma)
    _close(got, want)
    if sigma == 0.0:      # clipped to norm 1, no noise
        norm = math.sqrt(sum(float((g ** 2).sum()) for g in
                             tree_leaves(got)))
        assert norm == pytest.approx(1.0, rel=1e-5)


def test_gaussian_epsilon_matches_jax():
    for s in (0.0, 0.1, 0.5, 1.0, 4.0):
        assert DP.gaussian_epsilon(s) == JDP.gaussian_epsilon(s)
    assert DP.gaussian_epsilon(0.5) == pytest.approx(9.6896, abs=5e-5)


@pytest.mark.parametrize("perfect", [True, False])
def test_fedavg_dp_through_channel_matches_jax(perfect):
    """Three users' privatized deltas through the channel (Q8, 20 dB),
    the JAX package's normals and channel draws injected: synced
    weights within 2e-5, the bill and epsilon equal."""
    jp, up = _user_stack(1, 3)
    jw = JWirelessConfig(mode="fl", quant_bits=8, perfect_channel=perfect)
    w = WirelessConfig(mode="fl", quant_bits=8, perfect_channel=perfect)
    key = jax.random.PRNGKey(4)
    jsync, jbits, jeps = JDP.fedavg_dp_through_channel(
        key, up, jp, jw, clip_c=1.0, sigma=0.5)
    sync, bits, eps = DP.fedavg_dp_through_channel(
        JaxKey(key), _tree(up), _tree(jp), w, clip_c=1.0, sigma=0.5)
    _close(sync, jsync)
    assert bits == jbits == 3 * 8 * 89_673
    assert eps == jeps


# ------------------------------------------------------------- non-IID
@pytest.mark.parametrize("n,alpha,seed", [(3072, 0.5, 0), (3072, 1.0, 1),
                                          (24_576, 0.1, 0), (6000, 100.0, 0)])
def test_dirichlet_shards_byte_identical(n, alpha, seed):
    from repro.schemes.base import corpus
    (x, y), _ = corpus(n, 512, 0)
    want = JDS.partition_users_dirichlet(x, y, 3, alpha=alpha, seed=seed)
    got = DS.partition_users_dirichlet(x, y, 3, alpha=alpha, seed=seed)
    for (a, b), (ja, jb) in zip(got, want):
        assert a.dtype == ja.dtype and b.dtype == jb.dtype
        assert a.tobytes() == ja.tobytes() and b.tobytes() == jb.tobytes()
    assert len({len(a) for a, _ in got}) == 1


def test_dirichlet_empty_shard_fails_as_in_jax():
    """At 3,072 rows, alpha 0.1, seed 0 a user draws no row of either
    class: both packages fail alike rather than return an empty shard."""
    from repro.schemes.base import corpus
    (x, y), _ = corpus(N_TRAIN, N_TEST, 0)
    with pytest.raises(IndexError):
        JDS.partition_users_dirichlet(x, y, 3, alpha=0.1)
    with pytest.raises(IndexError):
        DS.partition_users_dirichlet(x, y, 3, alpha=0.1)


# ------------------------------------------------------------- FedProx
def test_fedprox_local_steps_match_jax():
    """Three FedProx steps (mu 0.1) pulled toward an anchor away from
    the start: weights, velocity and loss within 2e-5."""
    js = j_init_state(jax.random.PRNGKey(5), JCFG, None, "sgd")
    anchor = jax.tree.map(lambda p: p + 0.05, js.trainable["model"])
    jstep = j_local_step(JCFG, 0.1, 0.9, prox_mu=0.1,
                         anchor={"model": anchor, "codec": {}})
    step = make_local_step(CFG, 0.1, 0.9, prox_mu=0.1,
                           anchor={"model": _tree(anchor), "codec": {}})
    st = TrainState(_tree(js.trainable),
                    SGDState(_tree(js.opt_state.velocity),
                             int(js.opt_state.step)), int(js.step))
    (x, y), _ = JDS.make_splits(1024, seed=5)
    for s in range(3):
        b = {"tokens": x[s * 64:(s + 1) * 64], "labels": y[s * 64:(s + 1) * 64]}
        js, jm = jstep(js, ({k: jnp.asarray(v) for k, v in b.items()},
                            jax.random.PRNGKey(s)))
        st, m = step(st, {k: torch.from_numpy(v) for k, v in b.items()})
        assert abs(float(m["loss"]) - float(jm["loss"])) <= TOL
    _close(st.trainable, js.trainable)
    _close(st.opt_state.velocity, js.opt_state.velocity)
    plain = make_local_step(CFG, 0.1, 0.9)
    st0 = TrainState(_tree(js.trainable), st.opt_state, st.step)
    a, _ = step(st0, {k: torch.from_numpy(v[:64]) for k, v in
                      (("tokens", x), ("labels", y))})
    c, _ = plain(st0, {k: torch.from_numpy(v[:64]) for k, v in
                       (("tokens", x), ("labels", y))})
    assert any(not torch.equal(p, q) for p, q in
               zip(tree_leaves(a.trainable), tree_leaves(c.trainable)))


# -------------------------------------------------------------- median
@pytest.mark.parametrize("n_users", [3, 4])
def test_median_sync_bit_exact(n_users):
    """The coordinate median of the delivered weights at an odd and an
    even user count (jnp.median averages the two middle values there,
    torch.median would not): bit for bit, through
    `fedavg_through_channel` on JAX's draws."""
    _, up = _user_stack(2, n_users)
    jw = JWirelessConfig(mode="fl", quant_bits=8, aggregate="median",
                         n_users=n_users)
    w = WirelessConfig(mode="fl", quant_bits=8, aggregate="median",
                       n_users=n_users)
    key = jax.random.PRNGKey(6)
    jsync, jbits = JFED.fedavg_through_channel(key, up, jw)
    sync, bits = FED.fedavg_through_channel(JaxDraws(key), _tree(up), w)
    assert bits == jbits
    _equal(sync, jsync)


@pytest.mark.parametrize("n", [1, 2, 3, 4, 5, 6])
def test_median_users_is_jnp_median(n):
    r = np.random.default_rng(n).standard_normal((n, 257)).astype(
        np.float32)
    r[:, :8] = np.round(r[:, :8])          # ties
    np.testing.assert_array_equal(
        FED.median_users(torch.from_numpy(r)).numpy(),
        np.asarray(jnp.median(jnp.asarray(r), axis=0)))


# ------------------------------------------------------------ experiments
def _corpus():
    from repro.schemes.base import corpus
    return corpus(N_TRAIN, N_TEST, 0)


def _shards(alpha):
    (x, y), _ = _corpus()
    return DS.partition_users_dirichlet(x, y, 3, alpha=alpha)


# name -> (WirelessConfig fields, scheme options); Dirichlet alpha 0.5 at
# this corpus gives 208-row shards, under one 512-row batch
FL_CASES = {
    "median": (dict(mode="fl", quant_bits=8, aggregate="median"), {}),
    "dp": (dict(mode="fl", quant_bits=8),
           dict(dp_sigma=0.5, dp_clip=1.0)),
    "dirichlet_fedprox_replacement": (
        dict(mode="fl", quant_bits=8),
        dict(shards=0.5, prox_mu=0.1, sample_with_replacement=True)),
}


@pytest.mark.parametrize("name", sorted(FL_CASES))
def test_fl_option_experiment_matches_live_jax(name):
    kw, opts = FL_CASES[name]
    if "shards" in opts:
        opts = dict(opts, shards=_shards(opts["shards"]))
    jscheme = JFederatedScheme(JWirelessConfig(**kw), **opts)
    jexp = JExperiment(jscheme, cycles=2, seed=0, n_train=N_TRAIN,
                       n_test=N_TEST)
    jres = jexp.run()

    def on_init(state):
        jstate, _ = JFederatedScheme(JWirelessConfig(**kw), **opts).init(
            0, *_corpus()[0])
        one = jax.tree.map(lambda a: a[0], jstate.train)
        st = TrainState(_tree(one.trainable),
                        SGDState(_tree(one.opt_state.velocity),
                                 int(one.opt_state.step)), int(one.step))
        return dataclasses.replace(
            state, train=FED.broadcast_state(st, jscheme.n_users))

    scheme = FederatedScheme(WirelessConfig(**kw), device="cpu",
                             key=JaxKey.root, **opts)
    exp = Experiment(scheme, cycles=2, seed=0, n_train=N_TRAIN,
                     n_test=N_TEST, on_init=on_init)
    res = exp.run()
    assert res.total_bits == jres.total_bits
    for r, jr in zip(exp.reports, jexp.reports):
        assert (r.bits, r.n_tx, r.erased_bits, r.steps, r.energy_j) == \
            (jr.bits, jr.n_tx, jr.erased_bits, jr.steps, jr.energy_j)
    assert scheme.last_epsilon == jscheme.last_epsilon
    np.testing.assert_allclose(res.accuracy, jres.accuracy, rtol=0,
                               atol=ACC_TOL)
    np.testing.assert_allclose(res.loss, jres.loss, rtol=0, atol=LOSS_TOL)


# ------------------------------------------------------------ perfect_eval
def test_fused_perfect_eval_matches_jax():
    """Fused SL scored over the noiseless link: the JAX package's score
    on the same weights (at 0 dB, where the real link would not)."""
    jw = JWirelessConfig(mode="sl", quant_bits=8, snr_db=0.0)
    w = WirelessConfig(mode="sl", quant_bits=8, snr_db=0.0)
    js = j_init_state(jax.random.PRNGKey(8), JCFG, jw, "sgd")
    tr = _tree(js.trainable)
    _, (xte, yte) = _corpus()
    for perfect in (True, False):
        want = j_evaluate_sl(js.trainable, jw, xte, yte,
                             perfect_eval=perfect)
        got = evaluate_sl(tr, w, xte, yte, key=JaxKey.root,
                          perfect_eval=perfect)
        assert abs(got - want) <= 1 / N_TEST
    scheme = SplitScheme(w, perfect_eval=True, device="cpu", key=JaxKey.root)
    st = dataclasses.replace(scheme.init(0, *_corpus()[0])[0],
                             train=TrainState(tr, None, 0))
    assert scheme.evaluate(st, xte, yte) == \
        evaluate_sl(tr, w, xte, yte, key=JaxKey.root, perfect_eval=True)


def test_two_party_perfect_predict_matches_jax():
    jw = JWirelessConfig(mode="sl", quant_bits=8, snr_db=0.0)
    w = WirelessConfig(mode="sl", quant_bits=8, snr_db=0.0)
    js = JSLSession(JCFG, jw, jax.random.PRNGKey(9), lr=0.1)
    full = dict(js.user_params, **js.server_params,
                sem_enc=js.user_codec["enc"], sem_dec=js.server_codec["dec"])
    ps = SLSession(CFG, w, params_from_jax(full, device="cpu"), lr=0.1)
    (x, _), _ = _corpus()
    k = jax.random.PRNGKey(99)
    for perfect in (True, False):
        _close(ps.predict(torch.from_numpy(x[:256]), JaxKey(k),
                          perfect=perfect),
               js.predict(jnp.asarray(x[:256]), k, perfect=perfect))
    a = ps.predict(torch.from_numpy(x[:256]), JaxKey(k), perfect=True)
    b = ps.predict(torch.from_numpy(x[:256]), JaxKey(k))
    assert not torch.equal(a, b)        # 0 dB: the real link differs


# ---------------------------------------------------------------- energy
def test_energy_report_matches_jax():
    for kw in (dict(mode="fl", snr_db=20.0), dict(mode="sl", snr_db=5.0,
                                                  fading=False)):
        rep = E.EnergyReport(717_384.0 * 3, 1.5e9, 4.0e9)
        jrep = JE.EnergyReport(717_384.0 * 3, 1.5e9, 4.0e9)
        assert rep.summary(WirelessConfig(**kw)) == \
            jrep.summary(JWirelessConfig(**kw))
