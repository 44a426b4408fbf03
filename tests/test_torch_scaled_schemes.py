"""The scaled CL / FL / SL schemes (schemes/scaled.py, P15) through
`Experiment` against the live JAX schemes, run outside any mesh on the
CPU at the reduced qwen1.5-0.5b config (batch 4 x seq 16, 64 / 16 rows,
2 cycles of 4 steps): every report's bits, n_tx, erased bits and outage
and the init delivery's bits equal; next-token accuracy within 0.01;
losses within 1e-4 for CL, FL and SL at Q16 over a perfect link. SL at
Q8 with ARQ over 5 dB is held within 1e-2: its legs quantize the cut's
activation and gradient, so a float summed in another order can move a
codeword across a rounding boundary, one step of 1/127 of the leg's
range (on 2 of 6 keys of one step, even over a perfect link: gradients
then part by ~1e-3), the 5 dB link's bit flips turn that one-step change
into a large one, and AdamW moves the affected weights by ~lr each
step. The step's gradients agree within 2e-5 where no codeword moves
(tests/test_torch_scaled.py); here the losses part by 6e-4 after the
first cycle, 4.4e-3 after the second. At Q16 a step is 1/32,767 of the
range, and the per-step losses agree within 1.3e-5. The port gets JAX's
initial weights (`Experiment.on_init`) and draws (`JaxKey`). Then kill-and-resume of a
scaled CL and FL run (`torch.equal` state, equal reports) and
`launch.train --reduced` on the CPU and its default device."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from _jax_keys import JaxKey, port_train_state
from repro.configs.base import WirelessConfig as JW
from repro.schemes import Experiment as JExperiment
from repro.schemes import build_scheme as j_build_scheme
from repro_torch.configs import WirelessConfig
from repro_torch.core import federated as FED
from repro_torch.nn import tree_leaves
from repro_torch.schemes import (Experiment, ScaledCentralizedScheme,
                                 ScaledFederatedScheme, ScaledSplitScheme,
                                 build_scheme)
from test_torch_scaled import CFG, JCFG, JSHAPE, SHAPE

N_TRAIN, N_TEST = 64, 16
LOSS_TOL, SL_LOSS_TOL, ACC_TOL = 1e-4, 1e-2, 0.01


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


CASES = {
    "cl_10db": dict(mode="cl", snr_db=10.0),
    "fl_q8_kernel": dict(mode="fl", quant_bits=8, use_kernel=True),
    "fl_delayed_int4": dict(mode="fl", quant_bits=4, wire_dtype="int4",
                            sync="delayed"),
    "sl_q8_arq_5db": dict(mode="sl", quant_bits=8, arq_attempts=4,
                          snr_db=5.0),
    "sl_q16_perfect": dict(mode="sl", quant_bits=16, perfect_channel=True),
}
# the one case whose losses may part by more than LOSS_TOL (see above)
LOOSE_SL = "sl_q8_arq_5db"
CLASSES = {"cl": ScaledCentralizedScheme, "fl": ScaledFederatedScheme,
           "sl": ScaledSplitScheme}


def _on_init(jscheme, xtr, ytr):
    """`Experiment.on_init` handing the port the JAX scheme's weights."""
    def hook(state):
        jstate, _ = jscheme.init(0, xtr, ytr)
        train = jstate.train
        if jscheme.mode == "fl":
            st = train["state"] if isinstance(train, dict) else train
            one = port_train_state(jax.tree.map(lambda a: a[0], st))
            train = FED.broadcast_state(one, jscheme.n_users)
            if isinstance(jstate.train, dict):
                train = {"state": train, "agg": train.trainable["model"]}
        else:
            train = port_train_state(train)
        return dataclasses.replace(state, train=train)
    return hook


@pytest.mark.parametrize("name", sorted(CASES))
def test_scaled_experiment_matches_live_jax(name):
    kw = CASES[name]
    jw, w = JW(**kw), WirelessConfig(**kw)
    jscheme = j_build_scheme(jw, cfg=JCFG, shape=JSHAPE)
    jexp = JExperiment(jscheme, cycles=2, seed=0, n_train=N_TRAIN,
                       n_test=N_TEST)
    jres = jexp.run()
    scheme = build_scheme(w, cfg=CFG, shape=SHAPE, device="cpu",
                          key=JaxKey.root)
    assert type(scheme) is CLASSES[kw["mode"]]
    (xtr, ytr), _ = scheme.default_data(N_TRAIN, N_TEST, 0)
    exp = Experiment(scheme, cycles=2, seed=0, n_train=N_TRAIN,
                     n_test=N_TEST,
                     on_init=_on_init(j_build_scheme(jw, cfg=JCFG,
                                                     shape=JSHAPE),
                                      xtr, ytr))
    res = exp.run()
    assert len(exp.reports) == len(jexp.reports) == 2
    for r, jr in zip(exp.reports, jexp.reports):
        assert (r.bits, r.n_tx, r.erased_bits, r.outage_s, r.steps) == \
            (jr.bits, jr.n_tx, jr.erased_bits, jr.outage_s, jr.steps)
        assert r.energy_j == jr.energy_j
    assert res.total_bits == jres.total_bits
    if jexp.init_delivery is not None:
        assert exp.init_delivery.bits == jexp.init_delivery.bits
    else:
        assert exp.init_delivery is None
    np.testing.assert_allclose(
        res.loss, jres.loss, rtol=0,
        atol=SL_LOSS_TOL if name == LOOSE_SL else LOSS_TOL)
    np.testing.assert_allclose(res.accuracy, jres.accuracy, rtol=0,
                               atol=ACC_TOL)
    assert all(np.isfinite(res.loss))


# ----------------------------------------------------------------- resume
def _resume_scheme(mode):
    w = (WirelessConfig(mode="fl", quant_bits=8, local_steps=2,
                        arq_max_tx=2, arq_min_f2=0.4)
         if mode == "fl" else WirelessConfig(mode="cl", snr_db=15.0))
    return build_scheme(w, cfg=CFG, shape=SHAPE, device="cpu",
                        steps_per_cycle=2)


def _run(scheme, ck=None, cycles=3, every=0, resume=False):
    exp = Experiment(scheme, cycles=cycles, seed=0, n_train=N_TRAIN,
                     n_test=N_TEST,
                     checkpoint_dir=str(ck) if ck is not None else None,
                     checkpoint_every=every,
                     resume_from=str(ck) if resume else None)
    return exp, exp.run()


@pytest.mark.parametrize("mode", ["cl", "fl"])
def test_scaled_kill_and_resume_is_bit_exact(mode, tmp_path):
    """Killed after cycle 1 of 3 and resumed from its snapshot: the
    straight run's state (`torch.equal`), reports and bills."""
    straight, sres = _run(_resume_scheme(mode))
    _run(_resume_scheme(mode), tmp_path, cycles=1, every=1)
    resumed, rres = _run(_resume_scheme(mode), tmp_path, resume=True)
    assert [dataclasses.asdict(r) for r in resumed.reports] == \
        [dataclasses.asdict(r) for r in straight.reports]
    assert (rres.accuracy, rres.loss, rres.total_bits) == \
        (sres.accuracy, sres.loss, sres.total_bits)
    a = tree_leaves(straight.final_state.train.trainable)
    b = tree_leaves(resumed.final_state.train.trainable)
    assert len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b))
    opt_a = straight.final_state.train.opt_state
    opt_b = resumed.final_state.train.opt_state
    for x, y in zip(tree_leaves(opt_a[0]), tree_leaves(opt_b[0])):
        assert torch.equal(x, y)


# ------------------------------------------------------------ entry point
@pytest.mark.parametrize("mode", ["cl", "fl", "sl"])
def test_launch_train_scaled_reduced_on_cpu(mode, capsys):
    from repro_torch.launch import train
    out = train.main(["--arch", "qwen1.5-0.5b", "--reduced", "--mode", mode,
                      "--steps", "2", "--device", "cpu", "--batch", "4",
                      "--seq", "16", "--n-train", "32", "--n-test", "8",
                      "--cycle-steps", "2", "--local-steps", "2"])
    text = capsys.readouterr().out
    assert "cycle    0" in text and "done: 1 cycles on cpu" in text
    exp = out["experiment"]
    assert isinstance(exp.scheme, CLASSES[mode])
    assert np.isfinite(out["final_loss"])
    if mode == "cl":
        assert exp.init_delivery.bits == 32 * 16 * 10     # 10-bit tokens
    else:
        assert exp.reports[0].bits > 0


def test_launch_train_scaled_defaults_to_the_card(monkeypatch):
    from repro_torch.launch import train
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        train.main(["--arch", "qwen1.5-0.5b", "--reduced", "--mode", "fl"])
    with pytest.raises(RuntimeError, match="cuda"):
        build_scheme(WirelessConfig(mode="sl"), cfg=CFG)
