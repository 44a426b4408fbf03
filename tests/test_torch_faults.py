"""Port parity for the fault model (src/repro_torch/schemes/faults.py and
the population's fault rules) against the JAX package, on the CPU.

The JAX package's uniforms go in through the port's draw seam
(`JaxKey`, tests/_jax_keys.py: "fault_outage", "fault_dropout" and
"fault_frac" are the children of its 3-way split), so:

* `FaultPlan.events` / `events_arrays` equal JAX's exactly, and a plan
  with both probabilities 0, or a replayed log, draws nothing;
* `from_log` replays the JAX package's events from a path, JSON text or
  a list;
* outage and mid-round-dropout bills, statuses, weights and the quorum
  rule of a population equal JAX's exactly (the cases of
  tests/test_faults.py)."""
import dataclasses
import json

import numpy as np
import pytest
import torch

from _jax_keys import JaxKey, port_pop_state
from repro.configs.base import WirelessConfig as JWirelessConfig
from repro.schemes import ClientSpec as JClientSpec
from repro.schemes import Experiment as JExperiment
from repro.schemes import FaultPlan as JFaultPlan
from repro.schemes import build_scheme as j_build_scheme
from repro.schemes import corpus as j_corpus
from repro_torch.configs import WirelessConfig
from repro_torch.schemes import (ClientSpec, Experiment, FaultPlan,
                                 build_scheme)

N_TRAIN, N_TEST = 2048, 512


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this file runs (the suite runs in
    several worker processes at once)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class _NoDraws:
    """A key whose streams raise when drawn: a plan that must not draw."""

    def __init__(self, *path):
        pass

    def fold_in(self, i):
        return self

    def draws(self):
        raise AssertionError("the plan drew from its stream")


def _eq_events(got, want):
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])   # NaN where no drop


# ---------------------------------------------------------------- events
@pytest.mark.parametrize("p_out,p_drop", [(0.4, 0.3), (0.25, 0.0),
                                          (0.0, 0.5), (1.0, 0.0)])
def test_events_equal_jax(p_out, p_drop):
    jplan = JFaultPlan(seed=3, p_outage=p_out, p_dropout=p_drop)
    plan = FaultPlan(seed=3, p_outage=p_out, p_dropout=p_drop,
                     key=JaxKey.root)
    for cycle in (0, 1, 7):
        for n in (1, 5, 16):
            _eq_events(plan.events(cycle, n), jplan.events(cycle, n))


def test_events_arrays_equal_jax():
    rng = np.random.default_rng(0)
    jplan = JFaultPlan(seed=1)
    plan = FaultPlan(seed=1, key=JaxKey.root)
    for cycle in range(4):
        po = rng.uniform(0.0, 0.6, 12)
        pd = rng.uniform(0.0, 0.6, 12)
        _eq_events(plan.events_arrays(cycle, po, pd),
                   jplan.events_arrays(cycle, po, pd))
        # dropout uniforms drawn iff any client may drop
        _eq_events(plan.events_arrays(cycle, po, np.zeros(12)),
                   jplan.events_arrays(cycle, po, np.zeros(12)))
    # constant arrays are the scalar plan's events
    p = FaultPlan(seed=2, p_outage=0.25, p_dropout=0.25)
    out, frac = p.events_arrays(5, np.full(9, 0.25), np.full(9, 0.25))
    _eq_events((out, frac), p.events(5, 9))


def test_a_default_plan_or_a_log_draws_nothing():
    idle = FaultPlan(key=_NoDraws)
    assert not idle.active
    out, frac = idle.events(7, 16)
    assert not out.any() and np.isnan(frac).all()
    out, frac = idle.events_arrays(7, np.zeros(4), np.zeros(4))
    assert not out.any() and np.isnan(frac).all()
    log = FaultPlan.from_log([{"cycle": 1, "client": 0, "event": "outage"}])
    log = dataclasses.replace(log, key=_NoDraws)
    assert log.events(1, 3)[0].tolist() == [True, False, False]
    assert log.events_arrays(1, np.full(3, 0.9), np.full(3, 0.9))[0].any()
    with pytest.raises(AssertionError, match="drew"):
        FaultPlan(p_outage=0.1, key=_NoDraws).events(0, 3)


def test_from_log_replays_jax(tmp_path):
    events = [{"cycle": 2, "client": 1, "event": "outage"},
              {"cycle": 2, "client": 0, "event": "dropout", "frac": 0.4},
              {"cycle": 2, "client": 1, "event": "dropout", "frac": 0.9},
              {"cycle": 5, "client": 3, "event": "outage"},
              {"cycle": 5, "client": 9, "event": "outage"}]
    p = tmp_path / "outages.json"
    p.write_text(json.dumps(events))
    plans = (FaultPlan.from_log(str(p)), FaultPlan.from_log(json.dumps(events)),
             FaultPlan.from_log(events, seed=99))
    assert plans[0] == plans[1] and hash(plans[0]) == hash(plans[1])
    assert plans[0].log == JFaultPlan.from_log(events).log
    jplan = JFaultPlan.from_log(events)
    for plan in plans:
        for cycle in range(7):
            _eq_events(plan.events(cycle, 4), jplan.events(cycle, 4))
            _eq_events(plan.events_arrays(cycle, np.full(4, 0.7),
                                          np.full(4, 0.7)),
                       jplan.events_arrays(cycle, np.full(4, 0.7),
                                           np.full(4, 0.7)))
    out, frac = plans[0].events(2, 4)
    assert out.tolist() == [False, True, False, False]
    assert abs(frac[0] - 0.4) < 1e-12 and np.isnan(frac[1])
    with pytest.raises(ValueError, match="frac"):
        FaultPlan.from_log([{"cycle": 0, "client": 0, "event": "dropout",
                             "frac": 1.0}])
    with pytest.raises(ValueError, match="unknown fault event"):
        FaultPlan.from_log([{"cycle": 0, "client": 0, "event": "x"}])


# ---------------------------------------------------- population bills
def _clients(cs, base):
    return [cs.fl(base, name="f0"), cs.fl(base, snr_db=10.0, name="f1"),
            cs.sl(base, name="s0")]


def _pair(cycles, **kw):
    """The 2 FL + 1 SL fleet of tests/test_faults.py, under JAX and in
    the port (JAX's initial weights and draws), `kw` -> the plan and the
    quorum (plans given as FaultPlan keyword dicts)."""
    plan = kw.pop("plan", None)
    jbase = JWirelessConfig(mode="fl", quant_bits=8)
    base = WirelessConfig(mode="fl", quant_bits=8)
    jkw, pkw = dict(kw), dict(kw)
    if plan is not None:
        if "log" in plan:
            jkw["fault_plan"] = JFaultPlan.from_log(plan["log"])
            pkw["fault_plan"] = FaultPlan.from_log(plan["log"])
        else:
            jkw["fault_plan"] = JFaultPlan(**plan)
            pkw["fault_plan"] = FaultPlan(key=JaxKey.root, **plan)
    jexp = JExperiment(j_build_scheme(jbase, clients=_clients(JClientSpec,
                                                              jbase), **jkw),
                       cycles=cycles, seed=0, n_train=N_TRAIN, n_test=N_TEST)
    jres = jexp.run()
    js = j_build_scheme(jbase, clients=_clients(JClientSpec, jbase), **jkw)

    def on_init(state):
        jst, _ = js.init(0, *j_corpus(N_TRAIN, N_TEST, 0)[0])
        return dataclasses.replace(
            state, train=port_pop_state(jst.train, state.train))
    exp = Experiment(build_scheme(base, clients=_clients(ClientSpec, base),
                                  device="cpu", key=JaxKey.root, **pkw),
                     cycles=cycles, seed=0, n_train=N_TRAIN, n_test=N_TEST,
                     on_init=on_init)
    res = exp.run()
    return (exp, res), (jexp, jres)


def _same_bills(exp, jexp):
    for r, jr in zip(exp.reports, jexp.reports):
        assert (r.bits, r.n_tx, r.energy_j, r.erased_bits, r.outage_s,
                r.steps) == (jr.bits, jr.n_tx, jr.energy_j, jr.erased_bits,
                             jr.outage_s, jr.steps)
        assert r.metrics == jr.metrics
        for c, jc in zip(r.clients, jr.clients):
            assert (c.name, c.status, c.bits, c.n_tx, c.energy_j, c.weight,
                    c.steps, c.est_round_s, c.erased_bits) == \
                (jc.name, jc.status, jc.bits, jc.n_tx, jc.energy_j,
                 jc.weight, jc.steps, jc.est_round_s, jc.erased_bits)


def test_outage_bills_the_whole_round_as_erased_as_jax():
    (exp, res), (jexp, jres) = _pair(2, plan=dict(seed=0, p_outage=1.0),
                                     quorum=0.5)
    _same_bills(exp, jexp)
    scheme = exp.scheme
    assert res.accuracy[0] == res.accuracy[1]      # nothing ever trains
    for rep in exp.reports:
        assert rep.metrics["n_erased"] == 3
        assert rep.metrics["quorum_met"] is False and rep.steps == 0
        for i, c in enumerate(rep.clients):
            assert c.status == "erased" and c.weight == 0.0
            assert c.energy_j == 0.0
            assert c.bits == c.erased_bits == \
                scheme._round_bits_estimate(i) > 0.0


def test_midround_dropout_bills_a_partial_upload_as_jax():
    (exp, _), (jexp, _) = _pair(1, plan=dict(seed=0, p_dropout=1.0))
    _same_bills(exp, jexp)
    (rep,) = exp.reports
    assert rep.metrics["n_dropped_midround"] == 3
    for i, c in enumerate(rep.clients):
        est = exp.scheme._round_bits_estimate(i)
        assert c.status == "dropped_midround" and 0.0 < c.bits < est
        assert c.erased_bits == c.bits and c.energy_j > 0.0
        assert c.weight == 0.0 and c.steps == 0


def test_logged_faults_and_quorum_as_jax():
    """A replayed log (an outage, a dropout) under a quorum the round
    still meets: statuses, bills and renormalized weights as JAX's,
    the surviving client's update within 2e-5 of JAX's."""
    log = [{"cycle": 0, "client": 0, "event": "outage"},
           {"cycle": 0, "client": 2, "event": "dropout", "frac": 0.25}]
    (exp, res), (jexp, jres) = _pair(2, plan=dict(log=log), quorum=0.3)
    _same_bills(exp, jexp)
    rep0, rep1 = exp.reports
    assert [c.status for c in rep0.clients] == ["erased", "ok",
                                                "dropped_midround"]
    assert rep0.clients[1].weight == 1.0 and rep0.metrics["quorum_met"]
    assert all(c.status == "ok" for c in rep1.clients)
    np.testing.assert_allclose(res.loss, jres.loss, rtol=0, atol=1e-5)
    np.testing.assert_allclose(res.accuracy, jres.accuracy, rtol=0,
                               atol=0.01)


def test_inactive_plan_is_neutral():
    base = WirelessConfig(mode="fl", quant_bits=8)

    def run(**kw):
        exp = Experiment(build_scheme(base, clients=_clients(ClientSpec, base),
                                      device="cpu", **kw),
                         cycles=1, seed=0, n_train=N_TRAIN, n_test=N_TEST)
        return exp, exp.run()
    (ep, rp), (ei, ri) = run(), run(fault_plan=FaultPlan(), quorum=0.0)
    assert rp.accuracy == ri.accuracy and rp.total_bits == ri.total_bits
    for a, b in zip(ep.reports, ei.reports):
        assert [c.bits for c in a.clients] == [c.bits for c in b.clients]
        assert set(a.metrics) == set(b.metrics)
        assert "n_erased" not in b.metrics


def test_quorum_validation():
    base = WirelessConfig(mode="fl", quant_bits=8)
    for q in (1.5, -0.1):
        with pytest.raises(ValueError, match="quorum"):
            build_scheme(base, clients=_clients(ClientSpec, base),
                         device="cpu", quorum=q)
