"""Crash-consistent resume in the port (src/repro_torch/checkpoint/ckpt.py
and `Experiment(checkpoint_every=, resume_from=)`), on the CPU: a run
killed after cycle k and resumed from its latest snapshot gives the
uninterrupted run's accuracies, losses, total bits, every report (the
per-client ones too) and final weights, bit for bit, on every scheme
family — a faulty FL link, a FaultPlan + quorum population on both
engines, faulty fused SL and CL (whose init-time corpus upload must not
be billed twice). Snapshots are atomic .npz files in the JAX package's
format; the data-rng state rides the snapshot."""
import dataclasses
import glob
import os

import numpy as np
import pytest
import torch

from repro_torch.checkpoint import ckpt as CKPT
from repro_torch.configs import WirelessConfig
from repro_torch.nn import tree_leaves
from repro_torch.optim import SGDState
from repro_torch.runtime.train_step import TrainState
from repro_torch.schemes import (ClientSpec, Experiment, FaultPlan,
                                 build_scheme)

N_TRAIN, N_TEST = 2048, 512
CYCLES, KILL_AT = 4, 2


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _fl_faulty():
    return build_scheme(WirelessConfig(
        mode="fl", quant_bits=8, n_users=3, local_steps=2,
        arq_max_tx=2, arq_min_f2=0.4, ge_p_gb=0.2, ge_p_bg=0.6,
        arq_backoff_s=0.01), device="cpu")


def _fleet_faulty(engine):
    base = WirelessConfig(mode="fl", quant_bits=8)
    clients = [ClientSpec.fl(base, name="f0"),
               ClientSpec.fl(base, snr_db=10.0, name="f1"),
               ClientSpec.sl(base, name="s0")]
    return build_scheme(base, clients=clients, engine=engine, quorum=0.34,
                        fault_plan=FaultPlan(seed=0, p_outage=0.3,
                                             p_dropout=0.3), device="cpu")


def _sl_faulty():
    return build_scheme(WirelessConfig(
        mode="sl", quant_bits=8, arq_max_tx=2, arq_min_f2=0.7),
        device="cpu")


def _cl():
    return build_scheme(WirelessConfig(mode="cl", quant_bits=8,
                                       snr_db=15.0), device="cpu")


MAKERS = {"fl-faulty": _fl_faulty,
          "fleet-faulty": lambda: _fleet_faulty("loop"),
          "fleet-engine-faulty": lambda: _fleet_faulty("fleet"),
          "sl-faulty": _sl_faulty, "cl": _cl}


def _run(scheme, tmp_path=None, cycles=CYCLES, resume=False, every=0):
    exp = Experiment(
        scheme, cycles=cycles, seed=0, n_train=N_TRAIN, n_test=N_TEST,
        checkpoint_dir=str(tmp_path) if tmp_path is not None else None,
        checkpoint_every=every,
        resume_from=str(tmp_path) if resume else None)
    return exp, exp.run()


def _tensors(state):
    out = []
    CKPT._map_with_path(lambda k, leaf: out.append((k, leaf)) or leaf,
                        state.train)
    return out


@pytest.mark.parametrize("kind", sorted(MAKERS))
def test_kill_and_resume_is_bit_for_bit(kind, tmp_path):
    make = MAKERS[kind]
    e1, r1 = _run(make())                                   # uninterrupted
    e2, _ = _run(make(), tmp_path, cycles=KILL_AT, every=1)  # "crashes"
    assert CKPT.latest_experiment_cycle(str(tmp_path)) == KILL_AT
    e3, r3 = _run(make(), tmp_path, resume=True)            # resumed
    np.testing.assert_array_equal(r1.accuracy, r3.accuracy)
    np.testing.assert_array_equal(r1.loss, r3.loss)
    assert r1.total_bits == r3.total_bits
    assert [dataclasses.asdict(r) for r in e1.reports] \
        == [dataclasses.asdict(r) for r in e3.reports]
    assert len(e3.reports) == CYCLES
    a, b = _tensors(e1.final_state), _tensors(e3.final_state)
    assert [k for k, _ in a] == [k for k, _ in b]
    for (k, x), (_, y) in zip(a, b):
        if torch.is_tensor(x):
            assert torch.equal(x, y), k
        else:
            np.testing.assert_array_equal(x, y)
    assert (e1.final_state.steps, e1.final_state.epoch) == \
        (e3.final_state.steps, e3.final_state.epoch)
    assert not glob.glob(os.path.join(str(tmp_path), "*.tmp*"))
    if kind == "cl":       # the init upload is in the total once
        assert r3.total_bits == e3.init_delivery.bits
    if kind == "fleet-faulty":    # the plan and the quorum did act
        assert any(c.status != "ok" for r in e3.reports
                   for c in r.clients)


def test_latest_experiment_cycle_picks_max(tmp_path):
    assert CKPT.latest_experiment_cycle(str(tmp_path)) is None
    assert CKPT.latest_experiment_cycle(str(tmp_path / "none")) is None
    for c in (1, 3, 2):
        CKPT.save_experiment(str(tmp_path), c, {"w": np.zeros(2)},
                             {"cycle": c})
    assert CKPT.latest_experiment_cycle(str(tmp_path)) == 3
    train, meta = CKPT.load_experiment(str(tmp_path), {"w": np.ones(2)})
    assert meta["cycle"] == 3
    np.testing.assert_array_equal(train["w"], 0.0)
    os.makedirs(tmp_path / "empty")
    with pytest.raises(FileNotFoundError):
        CKPT.load_experiment(str(tmp_path / "empty"), {"w": np.ones(2)})


def test_snapshot_roundtrips_tensors_scalars_and_arrays(tmp_path):
    """Python-scalar leaves come back as the same Python type, tensors
    with the template's dtype and device and the same bits, arrays
    exactly; a shape that differs from the template's raises."""
    g = torch.Generator().manual_seed(0)
    w = torch.randn(2, 3, generator=g)
    st = TrainState({"model": {"w": w, "b": torch.arange(3)}, "codec": {}},
                    SGDState({"model": {"w": w * 0.5,
                                        "b": torch.zeros(3)}}, 7), 7)
    train = {"state": st, "steps": [1, 2], "lr": 0.125,
             "arr": np.arange(4, dtype=np.int64), "ok": True}
    path = CKPT.save_experiment(str(tmp_path), 4, train,
                                {"cycle": 4, "note": "x"})
    out, meta = CKPT.load_experiment(path, train)
    assert meta == {"cycle": 4, "note": "x"}
    assert type(out["lr"]) is float and out["lr"] == 0.125
    assert out["steps"] == [1, 2] and type(out["steps"][0]) is int
    assert out["ok"] is True
    assert type(out["state"]) is TrainState and out["state"].step == 7
    assert type(out["state"].opt_state) is SGDState
    for a, b in zip(tree_leaves(out["state"].trainable),
                    tree_leaves(st.trainable)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    np.testing.assert_array_equal(out["arr"], train["arr"])
    with pytest.raises(ValueError, match="shape"):
        CKPT.load_experiment(path, dict(train, arr=np.zeros(3, np.int64)))
    p = CKPT.save_checkpoint(str(tmp_path), 12, {"w": w})
    assert CKPT.latest_step(str(tmp_path)) == 12 and p.endswith(".npz")
    back = CKPT.restore_checkpoint(str(tmp_path), 12, {"w": torch.zeros(2,
                                                                        3)})
    assert torch.equal(back["w"], w)


def test_checkpoint_validations(tmp_path):
    with pytest.raises(ValueError, match="checkpoint_dir"):
        Experiment(_cl(), cycles=1, checkpoint_every=1).run()
    sl2 = build_scheme(WirelessConfig(mode="sl", quant_bits=8),
                       protocol="two_party", device="cpu")
    with pytest.raises(ValueError, match="two-party"):
        Experiment(sl2, cycles=1, checkpoint_dir=str(tmp_path),
                   checkpoint_every=1).run()
    with pytest.raises(ValueError, match="two-party"):
        Experiment(sl2, cycles=1, resume_from=str(tmp_path)).run()


def test_launch_train_checkpoints_and_resumes(tmp_path, capsys):
    """`launch/train.py --ckpt-dir`: a rerun with the same directory
    resumes from the latest snapshot and ends where one straight run
    ends, bill for bill."""
    from repro_torch.launch import train
    args = ["--arch", "paper-tinylstm", "--mode", "fl", "--device", "cpu",
            "--n-train", "3072", "--n-test", "512", "--local-steps", "2"]
    straight = train.main(args + ["--steps", "8"])
    ck = ["--ckpt-dir", str(tmp_path), "--ckpt-every", "1"]
    train.main(args + ["--steps", "4"] + ck)
    assert CKPT.latest_experiment_cycle(str(tmp_path)) == 1
    resumed = train.main(args + ["--steps", "8"] + ck)
    assert "resuming from cycle 1" in capsys.readouterr().out
    assert resumed["result"].total_bits == straight["result"].total_bits
    assert resumed["result"].accuracy == straight["result"].accuracy
    assert resumed["result"].loss == straight["result"].loss
