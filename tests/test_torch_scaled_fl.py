"""Port parity for the scaled FL cycle (`runtime/fl_runtime.py`
`make_fl_train_step`, P15) against the JAX package's pod FL step, run
outside any mesh on the CPU: the local phase within 2e-5, and the
quantized sync of the stacked model through K1's plain version (JAX's
packed path) or K2's (JAX's Pallas kernel in interpret mode) on JAX's
draws, bit for bit, bounded ARQ's erasure-aware mean and the all-erased
fallback included. The reduced qwen1.5-0.5b config as in
tests/test_torch_scaled.py, 3 users."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _jax_keys import JaxKey, port_train_state
from repro.configs.base import WirelessConfig as JW
from repro.core import wire as JWIRE
from repro.runtime import fl_runtime as JFL
from repro_torch.configs import WirelessConfig
from repro_torch.core import federated as FED
from repro_torch.core import wire as W
from repro_torch.nn import tree_leaves
from repro_torch.runtime import fl_runtime as FL
from test_torch_scaled import (CFG, JCFG, JSHAPE, SHAPE, _batch, _close,
                               _equal, _j_state, _t, _tb)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _fl_states(seed=0, n=3):
    js = _j_state(optimizer="sgd", seed=seed)
    jst = jax.tree.map(lambda p: jnp.broadcast_to(p, (n,) + p.shape), js)
    return jst, FED.broadcast_state(port_train_state(js), n)


FL_CASES = {
    "q8": dict(quant_bits=8),
    "q8_kernel": dict(quant_bits=8, use_kernel=True),
    "int4_kernel": dict(quant_bits=4, wire_dtype="int4", use_kernel=True),
    "bounded_arq": dict(quant_bits=8, snr_db=8.0, arq_max_tx=2,
                        arq_min_f2=0.5, ge_p_gb=0.2),
    # every packet in outage: the sync keeps its fallback
    "all_erased": dict(quant_bits=8, arq_max_tx=1, arq_min_f2=60.0),
    "all_erased_kernel": dict(quant_bits=8, arq_max_tx=1, arq_min_f2=60.0,
                              use_kernel=True),
}


def _xla_cpu_mean(rx, uploads, bits: int) -> list:
    """JAX's plain FedAvg mean of the delivered stacked tree `rx` as XLA
    compiles it on the CPU when the mean shares a program with the wire:
    the dequantize product q_u * s_u is contracted into the running sum
    (one FMA rounding per user, ascending), then x f32(1/N). Emulated in
    float64 (q_u * s_u is exact there, 8 + 24 bits), from the codes
    q_u = r_u / s_u of the per-(user, leaf) scales s_u."""
    from repro_torch.core import quantization as Q
    out = []
    for r, x in zip(tree_leaves(rx), tree_leaves(uploads)):
        n = r.shape[0]
        s = Q.scale_from_amax(x.reshape(n, -1).abs().amax(1), bits)
        s = s.reshape((n,) + (1,) * (r.ndim - 1))
        q = torch.round(r / s)
        assert torch.equal(q * s, r)
        qs = q.double() * s.double()
        acc = r[0]
        for u in range(1, n):
            acc = (qs[u] + acc.double()).float()
        out.append(acc * torch.tensor(1.0 / n, dtype=torch.float32))
    return out


@pytest.mark.parametrize("name", sorted(FL_CASES))
def test_fl_step_local_phase_and_sync_match_jax(name):
    """Two delayed FL cycles from one init, on JAX's draws. The local
    phase (the carry's state) within 2e-5 of JAX's. The syncs — of the
    initial weights, and of JAX's own first-cycle uploads with JAX's
    first aggregate as the fallback: K2's plain version bit for bit with
    JAX's Pallas kernel (interpret mode), K1's with bounded ARQ (the
    erasure-aware mean) bit for bit with JAX's packed path, and an
    all-erased sync keeps the fallback, as JAX's does. Without ARQ,
    K1's plain version delivers JAX's tree bit for bit and the port
    takes its ordered mean; JAX's program equals the same delivered tree
    under XLA's fused mean (`_xla_cpu_mean`), bit for bit, and the two
    means lie within N - 1 ulps of each leaf's largest weight. The barrier
    sync keeps each user's own weights when all erased."""
    case = FL_CASES[name]
    kw = {**dict(mode="fl", n_users=3, local_steps=1, snr_db=12.0),
          **case}
    jw, w = JW(**kw), WirelessConfig(**kw)
    exact = bool(case.get("use_kernel") or case.get("arq_max_tx"))
    jst, st = _fl_states()
    b = _batch(8, lead=(3,))
    k1, k2 = jax.random.PRNGKey(3), jax.random.PRNGKey(4)
    jdel = jax.jit(JFL.make_fl_train_step(JCFG, JSHAPE, jw, n_users=3,
                                          sync="delayed"))
    jc1, _ = jdel({"state": jst, "agg": jst.trainable["model"]}, b, k1,
                  0.05)
    jc2, _ = jdel(jc1, b, k2, 0.05)
    pdel = FL.make_fl_train_step(CFG, SHAPE, w, n_users=3, sync="delayed")
    c1, _ = pdel({"state": st, "agg": st.trainable["model"]}, _tb(b),
                 JaxKey(k1), 0.05)
    _close(c1["state"].trainable, jc1["state"].trainable)
    sync = FL.make_fl_sync(w, 3)
    jup = jc1["state"].trainable["model"]
    erased = case.get("arq_min_f2") == 60.0
    for kk, up, fb, jsynced in (
            (k1, st.trainable["model"], st.trainable["model"], jc1["agg"]),
            (k2, _t(jup), _t(jc1["agg"]), jc2["agg"])):
        kch = jax.random.fold_in(kk, FL.SYNC_KEY_FOLD)
        if kk is k1:
            synced = c1["agg"]            # the step's own sync
        elif erased:                      # the barrier form's fallback
            synced = sync(JaxKey(kch), up, up)
            assert synced is up
            synced = fb
        else:
            synced = sync(JaxKey(kch), up, fb)
        if erased:
            _equal(synced, jsynced)
            _equal(fb, jsynced)
        elif exact:
            _equal(synced, jsynced)
        else:
            link = dict(bits=w.quant_bits, snr_db=w.snr_db,
                        wire_dtype=w.wire_dtype)
            rx = W.transmit_stacked(JaxKey(kch).draws(), up, **link)
            _equal(rx, JWIRE.transmit_stacked(
                kch, jax.tree.map(lambda a: jnp.asarray(a.numpy()), up),
                **link))
            for a, r in zip(tree_leaves(synced), tree_leaves(rx)):
                assert torch.equal(a, FED.mean_users(r).expand(r.shape))
            for m, jm in zip(_xla_cpu_mean(rx, up, w.quant_bits),
                             jax.tree.leaves(jsynced)):
                assert np.array_equal(m.numpy(), np.asarray(jm)[0])
            # the port's mean against JAX's: each of the N - 1 adds that
            # XLA fuses rounds its product once less, at most one ulp of
            # the leaf's largest weight
            for a, jm in zip(tree_leaves(synced), jax.tree.leaves(jsynced)):
                jm = np.asarray(jm)[0]
                np.testing.assert_allclose(
                    a[0].numpy(), jm, rtol=0,
                    atol=2 * np.spacing(np.abs(jm).max()))


def test_use_kernel_refuses_stochastic_rounding():
    with pytest.raises(ValueError, match="nearest"):
        FL.make_fl_train_step(CFG, SHAPE, WirelessConfig(
            mode="fl", use_kernel=True, rounding="stochastic"))


