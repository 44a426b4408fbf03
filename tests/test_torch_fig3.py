"""Port parity for Fig. 3's entry point, `repro_torch.launch.fig3`,
against `benchmarks/accuracy_cycles.py`, `quant_sweep.py`,
`snr_sweep.py` and `fading.py` (JAX), on the CPU:

* The schedule and the lines: each JAX script's `main` runs with its
  `train_cl` / `train_fl` / `train_sl` replaced by a recorder that
  returns seeded stub accuracies (and its `RESULTS` pointed at a
  temporary directory). At `benchmarks/run.py`'s quick and full cycle
  counts the port plans the same runs in the same order (the effective
  `WirelessConfig` field for field, cycles, seed, corpus, SL's
  capture_every), and on the same stub accuracies prints JAX's lines
  letter for letter.
* Each configuration that no earlier test covers (FL at Q4, Q16 and
  Q32; FL Q8 with 4 ARQ attempts, CL and SL Q16 at 0 dB; CL with no
  radio) through `table2.drive` at 1,536 / 256 rows against the live
  JAX `Experiment`, with JAX's initial weights and draws handed in
  through the seams (tests/_jax_keys.py): bills exact, cycle by cycle
  and against `fig3.bills`; accuracy within 2/512 and loss within 1e-3
  (tests/test_torch_paper.py's tolerances and reasons).
* The CLI: `--device cpu` prints JAX's line names and `--out` writes the
  rows; without `--device` it raises on a host with no card.
"""
import contextlib
import dataclasses
import inspect
import io
import json

import jax
import numpy as np
import pytest
import torch

import benchmarks.accuracy_cycles as j3a
import benchmarks.common as jcommon
import benchmarks.fading as j3d
import benchmarks.quant_sweep as j3b
import benchmarks.snr_sweep as j3c
from _jax_keys import JaxKey
from repro.configs.base import WirelessConfig as JWirelessConfig
from repro.schemes import Experiment as JExperiment
from repro.schemes import build_scheme as j_build_scheme
from repro.schemes.base import RunResult as JRunResult
from repro.schemes.base import corpus as j_corpus
from repro_torch.core import federated as FED
from repro_torch.launch import fig3 as F3
from repro_torch.launch import table2 as T2
from repro_torch.schemes.base import RunResult
from test_torch_paper import ACC_TOL, LOSS_TOL, _port_state

N_TRAIN, N_TEST = 1536, 256       # three batches: one a user for FL
JAX_PANELS = {"a": j3a, "b": j3b, "c": j3c, "d": j3d}
# benchmarks/run.py:18-35: the quick and the full cycle counts
RUN_CYCLES = {False: {"a": 16, "b": 5, "c": 6, "d": 12},
              True: {"a": 50, "b": 7, "c": 10, "d": 20}}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this file runs (the suite runs several
    worker processes at once; see tests/test_torch_paper.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _stub_accuracy(i: int, cycles: int) -> list:
    """The i-th run's stub accuracies, one a cycle."""
    return np.random.default_rng(i).uniform(0.4, 0.9, cycles).tolist()


def _effective(kind, bound):
    """(mode, WirelessConfig or None, options) a `benchmarks/common.py`
    wrapper hands `build_scheme` (common.py:train_cl/train_fl/train_sl)."""
    a = bound.arguments
    if kind == "cl":
        return "cl", a["wcfg"], {}
    if kind == "fl":
        return "fl", dataclasses.replace(
            a["wcfg"] or JWirelessConfig(mode="fl"),
            local_steps=a["local_epochs"], n_users=a["n_users"]), {}
    return "sl", a["wcfg"] or JWirelessConfig(mode="sl", quant_bits=16), \
        dict(capture_every=a["capture_every"])


def _jax_schedule(monkeypatch, tmp_path, panel, cycles):
    """JAX's `main(cycles)` for one panel with recording trainers: (its
    lines, the runs it asked for in order)."""
    mod = JAX_PANELS[panel]
    calls = []

    def recorder(kind):
        sig = inspect.signature(getattr(jcommon, f"train_{kind}"))

        def train(*a, **kw):
            bound = sig.bind(*a, **kw)
            bound.apply_defaults()
            mode, wcfg, opts = _effective(kind, bound)
            c = bound.arguments["cycles"]
            calls.append(dict(
                mode=mode, wcfg=None if wcfg is None
                else dataclasses.asdict(wcfg), cycles=c,
                seed=bound.arguments["seed"],
                n_train=bound.arguments["n_train"],
                n_test=bound.arguments["n_test"],
                capture=bound.arguments["capture"], opts=opts))
            return JRunResult(_stub_accuracy(len(calls), c), [0.0] * c,
                              0.0, 0.0, 0.0, {})
        return train

    for kind in ("cl", "fl", "sl"):
        if hasattr(mod, f"train_{kind}"):
            monkeypatch.setattr(mod, f"train_{kind}", recorder(kind))
    monkeypatch.setattr(mod, "RESULTS", str(tmp_path))
    return mod.main(cycles=cycles), calls


def _port_schedule(panel, full):
    """The port's `run` of one panel with a recording `drive`: (its
    lines, the runs it drove in order)."""
    calls = []

    def drive(wcfg, cycles, seed, n_train, n_test, device, **opts):
        calls.append(dict(
            mode="cl" if wcfg is None else wcfg.mode,
            wcfg=None if wcfg is None else dataclasses.asdict(wcfg),
            cycles=cycles, seed=seed, n_train=n_train, n_test=n_test,
            capture=False, opts=opts))
        return T2.SchemeRun(RunResult(_stub_accuracy(len(calls), cycles),
                                      [0.0] * cycles, 0.0, 0.0, 0.0, {}),
                            [], 0.0, [], 0.0, [], [])
    f3 = F3.run([panel], full, device="cpu", drive=drive)
    return F3.lines(panel, f3.results[panel]), calls


@pytest.mark.parametrize("full", [False, True], ids=["quick", "full"])
@pytest.mark.parametrize("panel", F3.PANELS)
def test_schedule_and_lines_equal_jax(panel, full, monkeypatch, tmp_path):
    want_lines, want = _jax_schedule(monkeypatch, tmp_path, panel,
                                     RUN_CYCLES[full][panel])
    got_lines, got = _port_schedule(panel, full)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g == w
    assert got_lines == want_lines
    assert list((tmp_path).iterdir())       # JAX wrote there, not results/


# ------------------------------------------------ live JAX, per config
def _spec(panel, series, snr=None, cycles=1):
    """The port's own plan entry, cut to N_TRAIN / N_TEST and `cycles`."""
    for s in F3.plan(panel, cycles, 0, fl_cycles=cycles, sl_cycles=cycles,
                     n_train=N_TRAIN, n_test=N_TEST):
        if s.series == series and s.snr_db == snr:
            return s
    raise KeyError((panel, series, snr))


# name -> (panel, series, SNR, cycles): the configurations the
# earlier tests do not run (tests/test_torch_paper.py: CL clean and at
# 10 dB at 3,072 rows, FL Q8, SL Q16; tests/test_torch_table2.py: CL,
# FL Q8 and SL Q16 at 20 dB)
LIVE = {"fl_q4": ("b", "q4", None, 1), "fl_q16": ("b", "q16", None, 1),
        "fl_q32": ("a", "fl_q32", None, 2),
        "fl_arq_0db": ("c", "fl_arq", 0.0, 1),
        "cl_0db": ("c", "cl", 0.0, 1), "sl_0db": ("c", "sl", 0.0, 1),
        "cl_no_radio": ("d", "cl_clean", None, 2)}


def _jax_wcfg(wcfg):
    return None if wcfg is None else JWirelessConfig(
        **dataclasses.asdict(wcfg))


def _on_init(jscheme):
    """`Experiment.on_init` handing the port the JAX scheme's initial
    weights (the JAX init at the same corpus)."""
    def hook(state):
        jstate, _ = jscheme.init(0, *j_corpus(N_TRAIN, N_TEST, 0)[0])
        if jscheme.mode == "fl":
            one = jax.tree.map(lambda a: a[0], jstate.train)
            train = FED.broadcast_state(_port_state(one), jscheme.n_users)
        else:
            train = _port_state(jstate.train)
        return dataclasses.replace(state, train=train)
    return hook


@pytest.mark.parametrize("name", sorted(LIVE))
def test_run_matches_live_jax(name):
    spec = _spec(*LIVE[name])
    jw = _jax_wcfg(spec.wcfg)
    jexp = JExperiment(j_build_scheme(jw, **spec.options()), spec.cycles,
                       seed=0, n_train=N_TRAIN, n_test=N_TEST)
    jres = jexp.run()
    r = T2.drive(spec.wcfg, spec.cycles, 0, N_TRAIN, N_TEST,
                 torch.device("cpu"), key=JaxKey.root,
                 on_init=_on_init(j_build_scheme(jw, **spec.options())),
                 **spec.options())
    # bills: exact, against live JAX and against the closed form
    init, per, users = F3.bills(spec, r)
    assert r.init_bits == init == (jexp.init_delivery.bits
                                   if jexp.init_delivery else 0.0)
    assert [rep.bits for rep in r.reports] == per
    for rep, jrep in zip(r.reports, jexp.reports, strict=True):
        assert (rep.bits, rep.n_tx, rep.erased_bits, rep.steps) == \
            (jrep.bits, jrep.n_tx, jrep.erased_bits, jrep.steps)
        assert rep.energy_j == jrep.energy_j
    assert r.result.total_bits == jres.total_bits == \
        (init + sum(per)) / users
    if spec.wcfg is not None and spec.wcfg.mode == "fl":
        assert per == [3 * spec.wcfg.quant_bits * 89_673] * spec.cycles \
            or spec.wcfg.arq_attempts > 1
    # training: within the stated tolerance of the live JAX run
    np.testing.assert_allclose(r.result.accuracy, jres.accuracy, rtol=0,
                               atol=ACC_TOL)
    np.testing.assert_allclose(r.result.loss, jres.loss, rtol=0,
                               atol=LOSS_TOL)
    assert r.round_launches == [(0, 0, 0)] * spec.cycles
    assert r.eval_launches == [(0, 0, 0)] * spec.cycles


def test_fl_bills_are_b_times_the_weights_a_user():
    """FL pays b x 89,673 bits a user a cycle without ARQ: 358,692 /
    717,384 / 1,434,768 / 2,869,536 at Q4 / 8 / 16 / 32; with ARQ the
    draws decide (None)."""
    got = [T2.closed_form_bits(s.wcfg)[1] / 3 for s in F3.plan("b", 5)]
    assert got == [358_692, 717_384, 1_434_768, 2_869_536]
    arq = _spec("c", "fl_arq", 0.0).wcfg
    assert arq.arq_attempts == 4 and T2.closed_form_bits(arq)[1] is None
    assert T2.closed_form_bits(None, 3072) == (3072 * 421.0, 0.0, 1)


# ----------------------------------------------------------------- CLI
@pytest.fixture(scope="module")
def cpu_cli(tmp_path_factory):
    out = tmp_path_factory.mktemp("fig3") / "fig3.json"
    text = io.StringIO()
    with contextlib.redirect_stdout(text):
        f3 = F3.main(["--device", "cpu", "--cycles", "1", "--fl-cycles",
                      "1", "--sl-cycles", "1", "--n-train", str(N_TRAIN),
                      "--n-test", str(N_TEST), "--out", str(out)])
    return f3, text.getvalue(), out


def test_cli_prints_jax_lines_and_writes_out(cpu_cli, monkeypatch,
                                             tmp_path):
    f3, text, out = cpu_cli
    saved = json.loads(out.read_text())
    printed = [ln for ln in text.splitlines() if ln.startswith("fig3")]
    assert printed == saved["lines"] and not saved["failures"]
    want = []
    for p in F3.PANELS:
        want += _jax_schedule(monkeypatch, tmp_path, p, 1)[0]
    assert [ln.rsplit(",", 1)[0] for ln in printed] == \
        [ln.rsplit(",", 1)[0] for ln in want]
    assert printed == [ln for p in F3.PANELS
                       for ln in F3.lines(p, saved["results"][p])]
    assert "# fig3 card: none" in text
    for p, runs in saved["runs"].items():
        for s in runs:
            assert s["bits"] == s["want_bits"] and \
                s["init_bits"] == s["want_init_bits"]
            assert s["launches_round"] == [[0, 0, 0]]
            assert np.isfinite(s["accuracy"] + s["loss"]).all()
    assert not f3.other_launches


def test_failures_flag_a_wrong_bill_launch_or_cycle_count(cpu_cli):
    """`fig3.failures` (what makes the CLI exit 1) names a run whose
    bill is off its closed form by one Q32 word, one that launched a
    kernel on the CPU, and one that ran fewer cycles than planned."""
    f3, _, _ = cpu_cli
    assert F3.failures(f3, "cpu") == []
    runs = {p: list(rs) for p, rs in f3.runs.items()}
    q32 = runs["b"][3]
    runs["b"][3] = dataclasses.replace(q32, reports=[dataclasses.replace(
        q32.reports[0], bits=q32.reports[0].bits - 32)])
    runs["a"][0] = dataclasses.replace(runs["a"][0],
                                       round_launches=[(1, 0, 0)])
    runs["d"][1] = dataclasses.replace(runs["d"][1], reports=[])
    bad = F3.failures(dataclasses.replace(f3, runs=runs), "cpu")
    assert [b.split(":")[0] for b in bad] == [
        "fig3a cl", "fig3b q32", "fig3d cl_fading"]
    assert "launches" in bad[0] and "bills" in bad[1]
    assert "0 of 1 cycles" in bad[2]


def test_cli_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        F3.main([])
    with pytest.raises(RuntimeError, match="cuda"):
        F3.run(["b"], cycles=1, n_train=N_TRAIN, n_test=N_TEST)
