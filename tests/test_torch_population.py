"""Port parity for heterogeneous populations
(src/repro_torch/schemes/population.py) against the JAX package, on the
CPU, with the JAX package's initial weights (`port_pop_state`) and its
draws (`JaxKey`, tests/_jax_keys.py) handed in:

* a 4-client mixed population (FL Q8 20 dB, FL Q4 6 dB, SL Q16 12 dB,
  SL Q8 20 dB) over 2 cycles bills exactly as JAX does, client by
  client; its global weights lie within 2e-5 of JAX's and its accuracy
  within 0.01;
* uniform-k and Bernoulli sampling, stragglers and deadline jitter
  decide exactly as JAX does, round by round (`_participants`);
* `aggregate_weighted` is the port's FedAvg bit for bit at equal
  weights and within 1e-6 of JAX's at unequal ones (an ordered float32
  sum against XLA's dot);
* CL members are billed at init only, as JAX bills them;
* the validations raise as JAX's."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _jax_keys import JaxKey, port_pop_state
from repro.configs.base import WirelessConfig as JWirelessConfig
from repro.schemes import ClientSpec as JClientSpec
from repro.schemes import Experiment as JExperiment
from repro.schemes import ParticipationPolicy as JPolicy
from repro.schemes import PopulationScheme as JPopulationScheme
from repro.schemes import corpus as j_corpus
from repro.schemes.population import aggregate_weighted as j_aggregate
from repro_torch.configs import WirelessConfig
from repro_torch.core import federated as FED
from repro_torch.nn import tree_leaves
from repro_torch.schemes import (BATCH, ClientSpec, Experiment,
                                 ParticipationPolicy, PopulationScheme,
                                 Radio, aggregate_weighted, build_scheme,
                                 corpus)

N_TRAIN, N_TEST = 2048, 256
W_TOL, ACC_TOL = 2e-5, 0.01


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _mixed(cs, w):
    base = w(mode="fl", quant_bits=8)
    return [cs.fl(base, snr_db=20.0, name="fl-good"),
            cs.fl(base, snr_db=6.0, quant_bits=4, name="fl-weak"),
            cs.sl(base, snr_db=12.0, quant_bits=16, name="sl-mid"),
            cs.sl(base, snr_db=20.0, name="sl-good")]


@pytest.fixture(scope="module")
def mixed_runs():
    jexp = JExperiment(JPopulationScheme(None, _mixed(JClientSpec,
                                                      JWirelessConfig)),
                       cycles=2, seed=0, n_train=N_TRAIN, n_test=N_TEST)
    jres = jexp.run()
    js = JPopulationScheme(None, _mixed(JClientSpec, JWirelessConfig))

    def on_init(state):
        jst, _ = js.init(0, *j_corpus(N_TRAIN, N_TEST, 0)[0])
        return dataclasses.replace(
            state, train=port_pop_state(jst.train, state.train))
    exp = Experiment(PopulationScheme(None, _mixed(ClientSpec,
                                                   WirelessConfig),
                                      device="cpu", key=JaxKey.root),
                     cycles=2, seed=0, n_train=N_TRAIN, n_test=N_TEST,
                     on_init=on_init)
    return (exp, exp.run()), (jexp, jres)


def test_mixed_population_bills_exactly_as_jax(mixed_runs):
    (exp, res), (jexp, jres) = mixed_runs
    assert res.total_bits == jres.total_bits
    for r, jr in zip(exp.reports, jexp.reports):
        assert (r.bits, r.n_tx, r.energy_j, r.erased_bits, r.outage_s,
                r.steps) == (jr.bits, jr.n_tx, jr.energy_j, jr.erased_bits,
                             jr.outage_s, jr.steps)
        assert r.metrics == jr.metrics
        for c, jc in zip(r.clients, jr.clients):
            assert (c.name, c.paradigm, c.status, c.bits, c.n_tx,
                    c.energy_j, c.weight, c.steps, c.est_round_s,
                    c.erased_bits) == \
                (jc.name, jc.paradigm, jc.status, jc.bits, jc.n_tx,
                 jc.energy_j, jc.weight, jc.steps, jc.est_round_s,
                 jc.erased_bits)
        by = {c.name: c for c in r.clients}
        assert by["fl-weak"].bits == by["fl-good"].bits / 2
        assert by["sl-mid"].bits == 2 * by["sl-good"].bits
    assert exp.reports[0].bits == 717_384 + 358_692 + 2 * (
        BATCH * 14 * 8 * 16 + BATCH * 14 * 8 * 8)
    assert res.user_flops == jres.user_flops
    assert res.server_flops == jres.server_flops


def test_mixed_population_trains_as_jax(mixed_runs):
    (exp, res), (jexp, jres) = mixed_runs
    got = exp.final_state.train.global_trainable
    want = jexp.final_state.train.global_trainable
    for a, b in zip(tree_leaves(got), jax.tree.leaves(want)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=W_TOL)
    np.testing.assert_allclose(res.accuracy, jres.accuracy, rtol=0,
                               atol=ACC_TOL)
    np.testing.assert_allclose(res.loss, jres.loss, rtol=0, atol=1e-5)


# ------------------------------------------------------ fleet dynamics
def _both(specs_fn, **kw):
    """The same fleet under JAX and in the port, both initialised."""
    jkw = {k: v for k, v in kw.items() if k != "policy"}
    pkw = dict(jkw)
    pol = kw.get("policy")
    if pol is not None:
        jkw["policy"] = JPolicy(pol.kind, pol.k, pol.p)
        pkw["policy"] = pol
    js = JPopulationScheme(None, specs_fn(JClientSpec, JWirelessConfig),
                           **jkw)
    ps = PopulationScheme(None, specs_fn(ClientSpec, WirelessConfig),
                          device="cpu", key=JaxKey.root, **pkw)
    (xtr, ytr), _ = j_corpus(4096, N_TEST, 0)
    js.init(0, xtr, ytr)
    ps.init(0, xtr, ytr)
    return js, ps


def _same_participants(js, ps, seed, cycles):
    patterns = []
    for cyc in range(cycles):
        part, status, est, frac = ps._participants(seed, cyc)
        jpart, jstatus, jest, jfrac = js._participants(seed, cyc)
        np.testing.assert_array_equal(part, jpart)
        assert status == jstatus and est == jest
        np.testing.assert_array_equal(frac, jfrac)
        patterns.append(tuple(status))
    return patterns


def _six(cs, w):
    base = w(mode="fl", quant_bits=8)
    return [cs.fl(base, name="a"), cs.fl(base, snr_db=6.0, name="b"),
            cs.sl(base, name="c"), cs.fl(base, compute_s_per_step=40.0,
                                         name="d"),
            cs.sl(base, quant_bits=16, compute_s_per_step=20.0, name="e"),
            cs.cl(base, compute_s_per_step=1e6, name="f")]


@pytest.mark.parametrize("policy", [ParticipationPolicy.uniform(3),
                                    ParticipationPolicy.bernoulli(0.5)],
                         ids=["uniform3", "bernoulli0.5"])
def test_sampling_decides_as_jax(policy):
    js, ps = _both(_six, policy=policy)
    pats = _same_participants(js, ps, seed=7, cycles=6)
    assert len(set(pats)) > 1                # the draw varies by cycle
    if policy.kind == "uniform":
        assert all(p.count("ok") == 3 for p in pats)


def test_stragglers_and_jitter_decide_as_jax():
    js, ps = _both(_six, deadline_s=50.0)
    assert [ps.estimated_round_s(i) for i in range(6)] == \
        [js.estimated_round_s(i) for i in range(6)]
    pats = _same_participants(js, ps, seed=0, cycles=2)
    assert pats[0][3] == "straggler" and pats[0][5] == "ok"   # CL exempt
    js, ps = _both(_six, deadline_s=50.0, deadline_jitter_sigma=0.8,
                   policy=ParticipationPolicy.bernoulli(0.8))
    pats = _same_participants(js, ps, seed=3, cycles=8)
    assert len({p[3] for p in pats} | {p[4] for p in pats}) > 1


def test_stragglers_bill_zero():
    base = WirelessConfig(mode="fl", quant_bits=8)
    clients = [ClientSpec.fl(base, name="fast"),
               ClientSpec.fl(base, compute_s_per_step=1e6, name="slow"),
               ClientSpec.sl(base, name="sl-fast")]
    exp = Experiment(build_scheme(base, clients=clients, deadline_s=3600.0,
                                  device="cpu"),
                     cycles=1, seed=0, n_train=N_TRAIN, n_test=N_TEST)
    exp.run()
    (rep,) = exp.reports
    by = {c.name: c for c in rep.clients}
    assert by["slow"].status == "straggler"
    assert (by["slow"].bits, by["slow"].energy_j, by["slow"].steps,
            by["slow"].weight) == (0.0, 0.0, 0, 0.0)
    assert rep.metrics["n_stragglers"] == 1
    assert sum(c.weight for c in rep.clients) == pytest.approx(1.0)


# --------------------------------------------------------- aggregation
def test_aggregate_weighted_against_jax():
    rng = np.random.default_rng(0)
    trees = [{"a": rng.standard_normal((7, 5)).astype(np.float32),
              "b": {"c": rng.standard_normal(33).astype(np.float32)}}
             for _ in range(4)]
    tt = [jax.tree.map(torch.from_numpy, t) for t in trees]
    eq = np.full(4, 0.25)
    got = aggregate_weighted(tt, eq)
    fed = jax.tree.map(lambda *ls: FED.mean_users(torch.stack(ls)), *tt)
    for a, b in zip(tree_leaves(got), tree_leaves(fed)):
        assert torch.equal(a, b)
    want = j_aggregate([jax.tree.map(jnp.asarray, t) for t in trees], eq)
    for a, b in zip(tree_leaves(got), jax.tree.leaves(want)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    w = np.asarray([512.0, 1024.0, 1536.0, 682.0])
    got = aggregate_weighted(tt, w / w.sum())
    want = j_aggregate([jax.tree.map(jnp.asarray, t) for t in trees],
                       w / w.sum())
    for a, b in zip(tree_leaves(got), jax.tree.leaves(want)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=1e-6)


# ----------------------------------------------------------- CL members
def test_cl_members_are_billed_at_init_only_as_jax():
    def specs(cs, w):
        base = w(mode="fl", quant_bits=8)
        return [cs.fl(base, name="f"), cs.cl(base, snr_db=5.0, name="c")]
    js = JPopulationScheme(None, specs(JClientSpec, JWirelessConfig))
    (xtr, ytr), _ = j_corpus(N_TRAIN, N_TEST, 0)
    _, jdlv = js.init(0, xtr, ytr)
    exp = Experiment(PopulationScheme(None, specs(ClientSpec,
                                                  WirelessConfig),
                                      capture=True, device="cpu",
                                      key=JaxKey.root),
                     cycles=1, seed=0, n_train=N_TRAIN, n_test=N_TEST)
    res = exp.run()
    dlv = exp.init_delivery
    assert (dlv.bits, dlv.energy_j, dlv.n_tx) == \
        (jdlv.bits, jdlv.energy_j, jdlv.n_tx)
    assert dlv.bits == (N_TRAIN // 2) * (30 * 14 + 1)
    by = {c.name: c for c in exp.reports[0].clients}
    assert by["c"].bits == 0.0 and by["c"].energy_j == 0.0
    assert by["c"].steps > 0 and by["c"].weight == pytest.approx(0.5)
    (rx,), (orig,) = (exp.scheme.captures["cl_received"],
                      exp.scheme.captures["cl_original"])
    assert (rx != orig).mean() > 0.01           # the 5 dB upload corrupts
    assert res.total_bits == pytest.approx(dlv.bits + exp.reports[0].bits)


# ------------------------------------------------------------- the rest
def test_groups_specs_and_eval_quantizer():
    base = WirelessConfig(mode="fl", quant_bits=8, snr_db=20.0)
    scheme = PopulationScheme(base, [ClientSpec.fl(base),
                                     ClientSpec.fl(base),
                                     ClientSpec.fl(base, snr_db=0.0)],
                              device="cpu")
    scheme.init(0, *corpus(N_TRAIN, N_TEST, 0)[0])
    assert [len(g.members) for g in scheme._groups] == [2, 1]
    spec = ClientSpec.fl(base, snr_db=3.0, quant_bits=4, fading=False)
    assert spec.radio == Radio.from_wcfg(base, snr_db=3.0, quant_bits=4,
                                         fading=False)
    assert spec.local_epochs == base.local_steps
    a = PopulationScheme(base, [ClientSpec.sl(base, quant_bits=4),
                                ClientSpec.sl(base, quant_bits=16)],
                         device="cpu")
    assert a._sl_wcfg.quant_bits == 16


def test_validations():
    base = WirelessConfig(mode="fl")
    cases = [
        (dict(clients=[]), "at least one"),
        (dict(clients=[ClientSpec.sl(base, compress_factor=4),
                       ClientSpec.sl(base, compress_factor=2)]),
         "compress_factor"),
        (dict(clients=[ClientSpec.fl(base, aggregate="median")]), "median"),
        (dict(clients=[ClientSpec.fl(base)],
              policy=ParticipationPolicy.uniform(2)), "uniform-k"),
        (dict(clients=[ClientSpec.fl(base)],
              policy=ParticipationPolicy.bernoulli(0.0)), "bernoulli"),
        (dict(clients=[ClientSpec.fl(base)],
              policy=ParticipationPolicy("sometimes")), "participation kind"),
        (dict(clients=[ClientSpec.fl(base)], deadline_s=10.0,
              deadline_jitter_sigma=-0.1), ">= 0"),
        (dict(clients=[ClientSpec.fl(base)], deadline_jitter_sigma=0.5),
         "deadline_s"),
    ]
    for kw, match in cases:
        with pytest.raises(ValueError, match=match):
            PopulationScheme(base, device="cpu", **kw)
    scheme = PopulationScheme(base, [
        ClientSpec.fl(base, n_samples=N_TRAIN),
        ClientSpec.fl(base, n_samples=N_TRAIN)], device="cpu")
    with pytest.raises(ValueError, match="exceed"):
        scheme.init(0, *corpus(N_TRAIN, N_TEST, 0)[0])
    with pytest.raises(RuntimeError, match="init"):
        PopulationScheme(base, [ClientSpec.fl(base)],
                         device="cpu").estimated_round_s(0)
