"""Port parity for the paper's privacy study (Table II) against the JAX
package: the energy rows, AdamW, the adversary's reconstruction error,
the direct read, and what each scheme captures.

* Energy, `direct_error`, the CL received corpus and the FL deltas are
  EXACT (numpy arithmetic, or the same draws through the same wire).
* One AdamW update agrees within 1e-6: float32 elementwise arithmetic
  whose only difference is the power in the bias correction.
* `reconstruction_error` with the JAX package's initial weights and
  batch indices handed in (`JaxAdversaryDraws`) agrees within 1e-3
  relative after 20 steps: the MLP's float32 matmuls sum in another
  order, and Adam's normalised steps carry those ulps along.
* The SL capture (the server's received payload) agrees with JAX's
  within one Q16 quantization step of each value's row, except where an
  ulp's difference in the user forward moves a code across a rounding
  boundary AND that code is hit by a bit flip (at most 0.1 % of values).
* `capture=True` leaves the FL and fused-SL trajectories bit-identical
  to `capture=False` within the port.

Everything runs on the CPU."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _jax_keys import JaxDraws, JaxKey
from repro.configs import get_arch as jax_arch
from repro.configs.base import WirelessConfig as JWirelessConfig
from repro.core import energy as JEN
from repro.core import privacy as JPRIV
from repro.data import sentiment as JDS
from repro.models import lstm_tiny as JLT
from repro.nn import init_params as jax_init
from repro.optim import adamw as j_adamw
from repro.runtime.train_step import init_train_state as j_init_state
from repro.schemes.centralized import CentralizedScheme as JCentralized
from repro.schemes.federated import fl_capture as j_fl_capture
from repro.schemes.radio import Radio as JRadio
from repro.schemes.split import _sl_observe_fn as j_sl_observe_fn
from repro_torch.configs import WirelessConfig, get_arch
from repro_torch.core import energy as EN
from repro_torch.core import privacy as PRIV
from repro_torch.nn import params_from_jax, tree_leaves
from repro_torch.optim import adamw
from repro_torch.runtime.sl_runtime import SLSession
from repro_torch.schemes import Experiment, build_scheme
from repro_torch.schemes.centralized import CentralizedScheme
from repro_torch.schemes.federated import fl_capture
from repro_torch.schemes.radio import Radio
from repro_torch.schemes.split import sl_observe

JCFG, CFG = jax_arch("paper-tinylstm"), get_arch("paper-tinylstm")


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


class JaxAdversaryDraws:
    """The JAX adversary's draws behind the port's `AdversaryDraws` seam:
    (kinit, kdata) = split(key); weights = init_params(kinit, ...); step
    i's rows = randint(fold_in(kdata, i), (size,), 0, n)."""

    def __init__(self, key):
        self.kinit, self.kdata = jax.random.split(key)

    def init(self, specs, device):
        (d_in, d_hidden), d_out = specs["w1"].shape, specs["w3"].shape[1]
        return params_from_jax(jax_init(self.kinit, JPRIV._mlp_specs(
            d_in, d_hidden, d_out)), device=device)

    def indices(self, step, size, n):
        idx = jax.random.randint(jax.random.fold_in(self.kdata, step),
                                 (size,), 0, n)
        return torch.from_numpy(np.asarray(idx).astype(np.int64))


# --------------------------------------------------------------- energy
@pytest.mark.parametrize("kw", [dict(mode="fl", quant_bits=8, snr_db=20.0),
                                dict(mode="sl", snr_db=10.0, fading=False),
                                dict(mode="cl", snr_db=20.0,
                                     bandwidth_hz=1e6, tx_power_w=0.2)])
def test_energy_rows_equal_jax(kw):
    w, jw = WirelessConfig(**kw), JWirelessConfig(**kw)
    for bits in (717_384.0, 44_040_192.0, 1.0):
        assert EN.comm_energy_j(bits, w) == JEN.comm_energy_j(bits, jw)
        assert EN.comm_time_s(bits, w) == JEN.comm_time_s(bits, jw)
    for flops in (0.0, 3.7e9, 1.25e13):
        assert EN.comp_energy_j(flops) == JEN.comp_energy_j(flops, "edge")
        assert EN.co2_kg(EN.comp_energy_j(flops)) == \
            JEN.co2_kg(JEN.comp_energy_j(flops, "edge"))


# ---------------------------------------------------------------- adamw
def test_adamw_updates_match_jax():
    rng = np.random.default_rng(0)
    params = {"a": rng.standard_normal((16, 8)).astype(np.float32),
              "b": {"c": rng.standard_normal(8).astype(np.float32)}}
    grads = [jax.tree.map(lambda a: (rng.standard_normal(a.shape) * 0.1)
                          .astype(np.float32), params) for _ in range(2)]
    j_init, j_update = j_adamw(weight_decay=0.01)
    init, update = adamw(weight_decay=0.01)
    jp, js = params, j_init(params)
    p = params_from_jax(params, device="cpu")
    st = init(p)
    for g in grads:             # the second update exercises the state
        jp, js = j_update(g, js, jp, 1e-3)
        p, st = update(params_from_jax(g, device="cpu"), st, p, 1e-3)
    for got, want in zip(tree_leaves(p), jax.tree.leaves(jp)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=1e-6)
    for got, want in zip(tree_leaves(st.nu), jax.tree.leaves(js.nu)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-6, atol=0)
    assert st.step == int(js.step) == 2


# ------------------------------------------------------------ adversary
def test_normalize_tokens_and_direct_error_equal_jax():
    (x, _), _ = JDS.make_splits(600, seed=3)
    got = PRIV.normalize_tokens(x, CFG.vocab_size)
    want = np.asarray(JPRIV.normalize_tokens(jnp.asarray(x),
                                             JCFG.vocab_size))
    np.testing.assert_array_equal(got.numpy(), want)
    rx = np.where(np.arange(x.size).reshape(x.shape) % 7 == 0, 0, x)
    a = rx.astype(np.float32) / CFG.vocab_size
    b = x.astype(np.float32) / CFG.vocab_size
    assert PRIV.direct_error(a, b) == JPRIV.direct_error(a, b)


def test_reconstruction_error_matches_jax_with_its_draws():
    rng = np.random.default_rng(1)
    (x, _), _ = JDS.make_splits(700, seed=1)
    obs = rng.standard_normal((600, 112)).astype(np.float32)
    tgt = x[:600].astype(np.float32) / CFG.vocab_size
    key = jax.random.PRNGKey(11)
    want = JPRIV.reconstruction_error(key, obs, tgt, steps=20)
    got = PRIV.reconstruction_error(JaxAdversaryDraws(key), obs, tgt,
                                    steps=20, device="cpu")
    assert abs(got - want) <= 1e-3 * want, (got, want)
    # the port's own draws: a different init and rows, the same scale
    own = PRIV.reconstruction_error(PRIV.AdversaryDraws(0), obs, tgt,
                                    steps=20, device="cpu")
    assert own != got and 0.2 * want < own < 5 * want


# ------------------------------------------------------------- captures
def test_cl_capture_equals_jax():
    """The CL corpus upload over a 20 dB link on the JAX package's draws:
    the received corpus equals JAX's token for token."""
    (xtr, ytr), _ = JDS.make_splits(1024, seed=0)
    kw = dict(mode="cl", snr_db=20.0)
    js = JCentralized(JWirelessConfig(**kw), capture=True)
    js.init(0, xtr, ytr)
    ps = CentralizedScheme(WirelessConfig(**kw), capture=True,
                           device="cpu", key=JaxKey.root)
    ps.init(0, xtr, ytr)
    np.testing.assert_array_equal(ps.captures["original"], xtr)
    np.testing.assert_array_equal(ps.captures["received"],
                                  js.captures["received"])
    assert (ps.captures["received"] != xtr).any()


def test_fl_capture_equals_jax():
    """One FL sync of three users' weights on the JAX package's draws: the
    recorded deltas and targets equal JAX's bit for bit."""
    jp = jax_init(jax.random.PRNGKey(3), JLT.model_specs(JCFG))
    rng = np.random.default_rng(3)
    users = jax.tree.map(lambda a: np.stack([
        np.asarray(a) + (rng.standard_normal(a.shape) * 0.01)
        .astype(np.float32) for _ in range(3)]), jp)
    key = jax.random.fold_in(jax.random.PRNGKey(5), 999)
    jd = JRadio(quant_bits=8, snr_db=20.0).send_stacked(
        key, jax.tree.map(jnp.asarray, users))
    d = Radio(quant_bits=8, snr_db=20.0).send_stacked(
        JaxDraws(key), params_from_jax(users, device="cpu"))
    toks = [rng.integers(0, 10_001, (5, 16, 30)).astype(np.int32)
            for _ in range(3)]
    jcap, cap = {"deltas": [], "targets": []}, {"deltas": [], "targets": []}
    j_fl_capture(jcap, jd.payload, jp, toks)
    fl_capture(cap, d.payload, params_from_jax(jp, device="cpu"), toks)
    assert cap["deltas"][0].shape == (3, 89_673)
    np.testing.assert_array_equal(cap["deltas"][0], jcap["deltas"][0])
    np.testing.assert_array_equal(cap["targets"][0], jcap["targets"][0])
    assert cap["targets"][0].dtype == jcap["targets"][0].dtype


def test_sl_capture_matches_jax_within_one_step():
    jw = JWirelessConfig(mode="sl", quant_bits=16, snr_db=20.0)
    w = WirelessConfig(mode="sl", quant_bits=16, snr_db=20.0)
    js = j_init_state(jax.random.PRNGKey(8), JCFG, jw, "sgd")
    tr = {"model": params_from_jax(js.trainable["model"], device="cpu"),
          "codec": params_from_jax(js.trainable["codec"], device="cpu")}
    (x, _), _ = JDS.make_splits(600, seed=8)
    key = jax.random.fold_in(jax.random.PRNGKey(9), 12345)
    want = np.asarray(j_sl_observe_fn(jw)(js.trainable, jnp.asarray(x[:512]),
                                          key))
    got = sl_observe(tr, torch.from_numpy(x[:512]), JaxKey(key), w).numpy()
    assert got.shape == want.shape == (512, 14, 8)
    # one Q16 step of each value's row (a row of the packed wire is a
    # leaf's 256-value slice; the leaf here is the whole [512, 14, 8]
    # tensor, so its scale is amax / 32767 over the tensor)
    step = np.abs(want).max() / (2 ** 15 - 1)
    far = np.abs(got - want) > 1.01 * step
    assert far.mean() <= 1e-3, far.mean()


def _weights(exp):
    tr = exp.final_state.train
    if isinstance(tr, SLSession):
        return tree_leaves({"u": tr.user_params, "uc": tr.user_codec,
                            "s": tr.server_params, "sc": tr.server_codec})
    return tree_leaves(tr.trainable)


@pytest.mark.parametrize("kw,extra", [
    (dict(mode="fl", quant_bits=8), {}),
    (dict(mode="sl", quant_bits=16), dict(capture_every=2)),
    (dict(mode="sl", quant_bits=8), dict(protocol="two_party",
                                         capture_every=2))])
def test_capture_leaves_the_trajectory_unchanged(kw, extra):
    runs = {}
    for capture in (False, True):
        scheme = build_scheme(WirelessConfig(**kw), capture=capture,
                              device="cpu", **extra)
        exp = Experiment(scheme, cycles=1, seed=0, n_train=1536,
                         n_test=256)
        runs[capture] = (exp, exp.run())
    (e0, r0), (e1, r1) = runs[False], runs[True]
    assert (r0.accuracy, r0.loss, r0.total_bits) == \
        (r1.accuracy, r1.loss, r1.total_bits)
    assert all(torch.equal(a, b) for a, b in zip(_weights(e0),
                                                 _weights(e1)))
    assert r0.captures == {}
    if kw["mode"] == "fl":
        assert [d.shape for d in r1.captures["deltas"]] == [(3, 89_673)]
        assert [t.shape for t in r1.captures["targets"]] == [(3, 30)]
    else:                       # 3 steps, captured at steps 0 and 2
        assert [s.shape for s in r1.captures["smashed"]] == \
            [(512, 14, 8)] * 2
        assert [o.shape for o in r1.captures["original"]] == [(512, 30)] * 2


def test_fl_capture_with_dp_raises():
    with pytest.raises(ValueError, match="dp_sigma"):
        build_scheme(WirelessConfig(mode="fl"), capture=True, dp_sigma=1.0,
                     device="cpu")
