"""The fleet engine (src/repro_torch/schemes/fleet.py) against the loop
engine (`PopulationScheme`) within the port, on the CPU: on every fleet
of tests/test_fleet.py the round totals (bits, n_tx, energy_j,
erased_bits, outage_s, steps) are equal bit for bit, and so is the last
round's per-client detail (bits, n_tx, energy, erased bits, status,
weight, deadline estimate). An all-FL fleet on the training plane gives
`FederatedScheme`'s bills and final weights bit for bit; a synthetic
1,000-client batch streams summaries that reassemble the round totals.

Against JAX: the spec fleets through the loop engine
(tests/test_torch_population.py, tests/test_torch_faults.py), and the
fleet engine itself on a synthetic 1,000-client batch with faults, ARQ,
Bernoulli sampling and SL clients, beside the live JAX `FleetScheme`
with JAX's draws handed in (`JaxKey`): the same round totals, streamed
summaries and per-client detail, bit for bit. The JAX package's fleet
golden does not hold on every host (ROADMAP §3), so nothing here reads
it."""
import json

import numpy as np
import pytest
import torch

from _jax_keys import JaxKey
from repro.schemes import ClientBatch as JClientBatch
from repro.schemes import Experiment as JExperiment
from repro.schemes import FleetScheme as JFleetScheme
from repro.schemes import ParticipationPolicy as JPolicy
from repro_torch.configs import WirelessConfig
from repro_torch.nn import tree_leaves
from repro_torch.schemes import (ClientBatch, ClientSpec, Experiment,
                                 FaultPlan, FederatedScheme, FleetScheme,
                                 ParticipationPolicy, PopulationScheme,
                                 build_scheme, corpus)

N_TRAIN, N_TEST = 4096, 512
BILL_FIELDS = ("bits", "n_tx", "energy_j", "erased_bits", "outage_s",
               "steps")
BASE = WirelessConfig(mode="fl", quant_bits=8)
ARQ = WirelessConfig(mode="fl", quant_bits=8, arq_max_tx=3, ge_p_gb=0.2,
                     arq_backoff_s=0.01, snr_db=4.0)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def data():
    return corpus(N_TRAIN, N_TEST, 0)


def _run(scheme, data, cycles=2, seed=0):
    exp = Experiment(scheme, cycles=cycles, seed=seed, data=data)
    exp.run()
    return exp


def _assert_engine_parity(specs, data, cycles=2, seed=0, **kw):
    el = _run(PopulationScheme(None, specs, device="cpu", **kw), data,
              cycles, seed)
    fleet = FleetScheme(None, ClientBatch.from_specs(specs), device="cpu",
                        **kw)
    ef = _run(fleet, data, cycles, seed)
    for c, (rl, rf) in enumerate(zip(el.reports, ef.reports)):
        for f in BILL_FIELDS:
            assert getattr(rl, f) == getattr(rf, f), \
                f"cycle {c} {f}: loop {getattr(rl, f)!r} fleet " \
                f"{getattr(rf, f)!r}"
    det = fleet.last_round_detail
    for i, cl in enumerate(el.reports[-1].clients):
        assert (cl.bits, cl.n_tx, cl.energy_j, cl.erased_bits, cl.status,
                cl.weight, cl.est_round_s) == \
            (det["bits"][i], det["n_tx"][i], det["energy_j"][i],
             det["erased_bits"][i], det["status_names"][i],
             det["weight"][i], det["est_round_s"][i]), f"client {i}"
    return el, ef


def _mixed_specs():
    return [ClientSpec.fl(BASE, snr_db=20.0),
            ClientSpec.fl(BASE, snr_db=6.0, quant_bits=4),
            ClientSpec.sl(BASE, snr_db=12.0, quant_bits=16),
            ClientSpec.sl(BASE, snr_db=20.0)]


def _dynamics():
    specs = _mixed_specs() + [
        ClientSpec.cl(BASE, snr_db=18.0),
        ClientSpec.fl(BASE, snr_db=20.0, compute_s_per_step=100.0)]
    return specs, dict(cycles=3, policy=ParticipationPolicy.uniform(4),
                       deadline_s=50.0, deadline_jitter_sigma=0.5)


def _faulty():
    specs = [ClientSpec.fl(ARQ, snr_db=4.0),
             ClientSpec.fl(ARQ, snr_db=4.0),
             ClientSpec.fl(ARQ, snr_db=8.0, arq_min_f2=1.5),
             ClientSpec.sl(ARQ, quant_bits=16, arq_min_f2=1.5),
             ClientSpec.sl(ARQ, quant_bits=16, arq_min_f2=1.5,
                           local_epochs=2),
             ClientSpec.cl(ARQ)]
    return specs, dict(cycles=4, policy=ParticipationPolicy.bernoulli(0.8),
                       quorum=0.3, fault_plan=FaultPlan(
                           seed=1, p_outage=0.25, p_dropout=0.25))


def _weighted():
    return [ClientSpec.fl(BASE, n_samples=512),
            ClientSpec.fl(BASE, n_samples=1024),
            ClientSpec.sl(BASE, quant_bits=16, n_samples=1536),
            ClientSpec.cl(BASE)], {}


def _sixteen(data):
    (xtr, ytr), _ = data
    shard = (xtr[:512], ytr[:512])
    specs = []
    for i in range(16):
        wc = ARQ if i % 5 == 0 else BASE
        mk = ClientSpec.sl if i % 3 == 2 else ClientSpec.fl
        specs.append(mk(wc, snr_db=4.0 + (i % 4) * 5.0, shard=shard,
                        compute_s_per_step=float(i % 3)))
    return specs, dict(policy=ParticipationPolicy.uniform(10),
                       deadline_s=1e9)


FLEETS = {"mixed": lambda d: (_mixed_specs(), {}),
          "dynamics": lambda d: _dynamics(),
          "faulty_arq_quorum": lambda d: _faulty(),
          "weighted": lambda d: _weighted(),
          "sixteen": _sixteen}


@pytest.mark.parametrize("name", sorted(FLEETS))
def test_fleet_bills_as_the_loop_bit_for_bit(name, data):
    specs, kw = FLEETS[name](data)
    el, ef = _assert_engine_parity(specs, data, **kw)
    statuses = {c.status for r in el.reports for c in r.clients}
    if name == "dynamics":
        assert {"sampled_out", "straggler"} <= statuses
    if name == "faulty_arq_quorum":
        assert sum(r.erased_bits for r in el.reports) > 0
        assert any("n_erased" in r.metrics for r in ef.reports)
    if name == "weighted":
        det = ef.scheme.last_round_detail
        assert float(det["weight"][det["part"]].sum()) == pytest.approx(1.0)
    if name == "mixed":
        assert [r.bits for r in el.reports] == [6_581_100.0] * 2


def test_all_fl_training_plane_is_federated_scheme(data):
    """Three FL clients on the training plane: the bits, transmissions
    and final weights of `FederatedScheme` at N 3, bit for bit (the
    energy, a sum of per-user energies, within 1e-12 relative; the loss,
    a mean of the same numbers in another order, within 1e-6), and the
    loop engine's weights and losses bit for bit."""
    specs = [ClientSpec.fl(BASE) for _ in range(3)]
    scheme = build_scheme(BASE, clients=specs, engine="fleet", device="cpu")
    assert isinstance(scheme, FleetScheme) and scheme.train_on
    ef = _run(scheme, data, cycles=2)
    efed = _run(FederatedScheme(BASE, device="cpu"), data, cycles=2)
    for rf, rd in zip(ef.reports, efed.reports):
        assert (rf.bits, rf.n_tx) == (rd.bits, rd.n_tx)
        # the fleet sums per-user energies, FL bills the whole send's
        assert rf.energy_j == pytest.approx(rd.energy_j, rel=1e-12)
        assert rf.loss == pytest.approx(rd.loss, abs=1e-6)
    for a, b in zip(tree_leaves(ef.final_state.train.glob["model"]),
                    tree_leaves(efed.final_state.train.trainable["model"])):
        assert torch.equal(a, b[0])
    el = _run(PopulationScheme(None, specs, device="cpu"), data, cycles=2)
    for a, b in zip(tree_leaves(ef.final_state.train.glob["model"]),
                    tree_leaves(el.final_state.train.global_trainable[
                        "model"])):
        assert torch.equal(a, b)
    assert [r.loss for r in ef.reports] == [r.loss for r in el.reports]


def _train_plane_specs():
    return [ClientSpec.fl(BASE, snr_db=20.0), ClientSpec.fl(BASE, snr_db=20.0),
            ClientSpec.fl(BASE, snr_db=6.0, quant_bits=4)]


def test_training_plane_with_sampled_groups_is_the_loop(data):
    """Two FL groups, two of three clients a round (so a group trains in
    part and keeps its idle member's optimizer state): the training
    plane's bills, losses and global weights are the loop engine's, bit
    for bit (chip_smoke.py phase 10a runs the same fleet on the card)."""
    kw = dict(policy=ParticipationPolicy.uniform(2))
    ef = _run(FleetScheme(None, ClientBatch.from_specs(_train_plane_specs()),
                          train="on", device="cpu", **kw), data, cycles=3)
    el = _run(PopulationScheme(None, _train_plane_specs(), device="cpu",
                               **kw), data, cycles=3)
    assert [tuple(getattr(r, f) for f in BILL_FIELDS) for r in ef.reports] \
        == [tuple(getattr(r, f) for f in BILL_FIELDS) for r in el.reports]
    assert [r.loss for r in ef.reports] == [r.loss for r in el.reports]
    assert any(r.clients[0].status == "sampled_out" for r in el.reports)
    for a, b in zip(tree_leaves(ef.final_state.train.glob["model"]),
                    tree_leaves(el.final_state.train.global_trainable[
                        "model"])):
        assert torch.equal(a, b)
    for gf, gl in zip(ef.final_state.train.groups,
                      el.final_state.train.groups):
        assert (gf.step, gf.opt_state.step) == (gl.step, gl.opt_state.step)
        both = [tree_leaves({"p": g.trainable, "v": g.opt_state.velocity})
                for g in (gf, gl)]
        assert len(both[0]) == len(both[1]) > 0
        for a, b in zip(*both):
            assert torch.equal(a, b)


def test_synthetic_fleet_streams_aggregates(data):
    batch = ClientBatch.synthetic(1000, seed=0, arq_max_tx=2, ge_p_gb=0.1,
                                  sl_frac=0.3, compute_s_range=(0.0, 2.0),
                                  p_outage=0.05, p_dropout=0.05)
    scheme = FleetScheme(None, batch,
                         policy=ParticipationPolicy.bernoulli(0.5),
                         deadline_s=1e9, spill_top_k=5, device="cpu")
    exp = _run(scheme, data, cycles=2)
    for rep in exp.reports:
        assert rep.clients == ()
        fl = rep.metrics["fleet"]
        assert sum(fl["status_counts"].values()) == 1000
        assert fl["bits"]["count"] == 1000
        assert fl["bits"]["sum"] == pytest.approx(rep.bits, rel=1e-12)
        assert sum(fl["bits"]["hist_counts"]) == 1000
        json.dumps(rep.metrics)          # JSON-safe for snapshots
        assert rep.metrics["n_active"] + sum(
            v for k, v in fl["status_counts"].items() if k != "ok") \
            == 1000
    det = scheme.last_round_detail
    assert det["bits"].sum() == pytest.approx(exp.reports[-1].bits)
    spill = exp.reports[-1].metrics["fleet"]["spill"]
    assert spill["bits"] == sorted(spill["bits"], reverse=True)
    for ci, b, s in zip(spill["client"], spill["bits"], spill["status"]):
        assert det["bits"][ci] == b and det["status_names"][ci] == s
    assert any(r.metrics.get("n_erased", 0) > 0 for r in exp.reports)
    secs = scheme.last_round_seconds
    assert 0.0 <= secs["sl_replay"] <= secs["round"]


SYNTH = dict(seed=0, arq_max_tx=3, arq_backoff_s=0.001, ge_p_gb=0.05,
             sl_frac=0.3, compute_s_range=(0.0, 2.0), p_outage=0.01,
             p_dropout=0.01)


def test_synthetic_fleet_bills_as_jax_bit_for_bit(data):
    """The fleet engine at 1,000 clients (chip_smoke.py phase 10c's
    fleet, cut to 1,000) against the JAX `FleetScheme` on the same
    batch, 2 rounds: every round total, the streamed `metrics` (status
    counts, summaries, spill) and the last round's per-client arrays are
    equal. Only the draws are handed over, so a bill that differs from
    the JAX package's own numbers differs by its generators alone."""
    jb = JClientBatch.synthetic(1000, **SYNTH)
    pb = ClientBatch.synthetic(1000, **SYNTH)
    for f in ("paradigm", "local_epochs", "n_samples",
              "compute_s_per_step", "wcfg_id", "radio_id", "p_outage",
              "p_dropout"):
        assert np.array_equal(getattr(pb, f), getattr(jb, f)), f
    jf = JFleetScheme(None, jb, policy=JPolicy.bernoulli(0.5),
                      deadline_s=1e9, spill_top_k=5)
    pf = FleetScheme(None, pb, policy=ParticipationPolicy.bernoulli(0.5),
                     deadline_s=1e9, spill_top_k=5, device="cpu",
                     key=JaxKey.root)
    jexp = JExperiment(jf, cycles=2, seed=0, data=data)
    jexp.run()
    pexp = _run(pf, data, cycles=2)
    for c, (r, jr) in enumerate(zip(pexp.reports, jexp.reports)):
        for f in BILL_FIELDS:
            assert getattr(r, f) == getattr(jr, f), \
                f"cycle {c} {f}: port {getattr(r, f)!r} jax " \
                f"{getattr(jr, f)!r}"
        assert r.metrics == jr.metrics, f"cycle {c}"
        assert r.erased_bits > 0 and r.metrics["n_erased"] > 0
    got, want = pf.last_round_detail, jf.last_round_detail
    assert got.keys() == want.keys()
    for k in got:
        if k == "status_names":
            assert got[k] == want[k]
        else:
            assert np.array_equal(np.asarray(got[k]), np.asarray(want[k]),
                                  equal_nan=True), k
    assert set(got["status_names"]) == {"ok", "sampled_out", "erased",
                                        "dropped_midround"}


def test_build_scheme_engine_selection():
    specs = [ClientSpec.fl(BASE), ClientSpec.sl(BASE)]
    assert isinstance(build_scheme(BASE, clients=specs, device="cpu"),
                      PopulationScheme)
    assert isinstance(build_scheme(BASE, clients=specs, engine="loop",
                                   device="cpu"), PopulationScheme)
    assert isinstance(build_scheme(BASE, clients=specs, engine="fleet",
                                   device="cpu"), FleetScheme)
    assert isinstance(build_scheme(BASE, clients=ClientBatch.from_specs(
        specs), device="cpu"), FleetScheme)
    with pytest.raises(ValueError, match="engine"):
        build_scheme(BASE, clients=specs, engine="bogus", device="cpu")


def test_synthetic_batch_validations():
    with pytest.raises(ValueError, match="n >= 1"):
        ClientBatch.synthetic(0)
    with pytest.raises(ValueError, match="batch"):
        ClientBatch.synthetic(4, n_samples=8)
    with pytest.raises(ValueError, match="capture"):
        FleetScheme(None, ClientBatch.synthetic(4), capture=True,
                    device="cpu")
    with pytest.raises(ValueError, match="train"):
        FleetScheme(None, ClientBatch.synthetic(4, sl_frac=0.5),
                    train="on", device="cpu")
    b = ClientBatch.synthetic(64, seed=3, sl_frac=0.25)
    assert int((b.paradigm == 1).sum()) == 16 and len(b) == 64
    assert set(b.quant_bits[b.paradigm == 1].tolist()) == {16}


@pytest.mark.parametrize("engine", ["synthetic", "loop", "fleet"])
def test_launch_train_runs_a_fleet(engine, capsys):
    """`launch/train.py --fleet-*`: one round per step, status counts
    printed; the loop and fleet engines bill the same specs alike."""
    from repro_torch.launch import train
    out = train.main(["--arch", "paper-tinylstm", "--device", "cpu",
                      "--fleet-size", "6", "--fleet-engine", engine,
                      "--fleet-sl-frac", "0.5", "--fleet-sample", "4",
                      "--steps", "2", "--n-train", "2048", "--n-test",
                      "256"])
    text = capsys.readouterr().out
    assert "done: 2 cycles on cpu" in text
    exp = out["experiment"]
    assert all(r.metrics["n_active"] == 4 for r in exp.reports)
    if engine != "loop":
        assert "[ok=4 sampled_out=2]" in text
    if engine == "fleet":
        loop = train.main(["--arch", "paper-tinylstm", "--device", "cpu",
                           "--fleet-size", "6", "--fleet-engine", "loop",
                           "--fleet-sl-frac", "0.5", "--fleet-sample", "4",
                           "--steps", "2", "--n-train", "2048",
                           "--n-test", "256"])
        assert [r.bits for r in exp.reports] == \
            [r.bits for r in loop["experiment"].reports]
