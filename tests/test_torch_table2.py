"""Port parity for Table II's entry point, `repro_torch.launch.table2`,
against `benchmarks/table2.py` (JAX), on the CPU:

* The assembly: seeded captures through `rows_from_runs` with the JAX
  adversary's draws injected, and through the JAX package in
  benchmarks/table2.py's order (restated below with its line numbers).
  The direct read, the projection, the drawn shard rows, the
  observations, the energy rows and the paper-scale bits are EXACT; the
  three adversary errors agree within 1e-3 relative after 20 steps (the
  tolerance of tests/test_torch_privacy.py, for the same reason: the
  MLP's float32 matmuls sum in another order); the claims are equal.
* `run` at a small corpus (1 / 1 / 1 cycles): JAX's row names and keys,
  bills equal to their closed form and to the live JAX `Experiment` at
  the same size, no kernel launched on the CPU.
* The CLI: `--device cpu` prints JAX's `table2,` lines and `--out`
  writes the rows; without `--device` it raises on a host with no card.
"""
import contextlib
import dataclasses
import io
import json
import re

import jax
import numpy as np
import pytest
import torch

from repro.configs.base import WirelessConfig as JWirelessConfig
from repro.core import energy as JEN
from repro.core import privacy as JPRIV
from repro.data.sentiment import partition_users as j_partition_users
from repro.schemes import Experiment as JExperiment
from repro.schemes import build_scheme as j_build_scheme
from repro.schemes.base import RunResult as JRunResult
from repro.schemes.base import corpus as j_corpus
from repro_torch.launch import table2 as T2
from repro_torch.schemes.base import RunResult
from test_torch_privacy import JaxAdversaryDraws

N_TRAIN, N_TEST = 1536, 256       # three batches: one a user for FL
STEPS = 20                        # adversary steps in the assembly test
REL_TOL = 1e-3
VOCAB = 10_001
# benchmarks/table2.py:95-113: the rows and each row's keys, in order
JAX_ROWS = ["central", "fl_q8_extra", "fl_q8", "sl_early_cut"]
JAX_KEYS = ["total_bits_M", "total_bits_M_paper_scale", "accuracy",
            "recon_error", "comp_energy_j", "comm_energy_j",
            "total_energy_j", "co2_kg"]
# benchmarks/table2.py:38-40, with benchmarks/common.py's train_fl (J 5,
# N 3) and train_sl (a capture every 8 steps)
JAX_SCHEMES = {
    "central": (JWirelessConfig(mode="cl", snr_db=20.0), {}),
    "fl_q8": (dataclasses.replace(
        JWirelessConfig(mode="fl", quant_bits=8, snr_db=20.0),
        local_steps=5, n_users=3), {}),
    "sl_early_cut": (JWirelessConfig(mode="sl", quant_bits=16, snr_db=20.0),
                     dict(capture_every=8)),
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this file runs (the suite runs several
    worker processes at once; see tests/test_torch_privacy.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _captures(seed=5, width=300):
    """Seeded CL / FL (2 cycles) / SL captures in the schemes' shapes; FL
    uploads `width` wide instead of 89,673 (the projection's rows)."""
    rng = np.random.default_rng(seed)
    orig = rng.integers(0, VOCAB, (5000, 30)).astype(np.int32)
    hit = rng.random(orig.shape) < 0.01
    received = np.where(hit, rng.integers(0, VOCAB, orig.shape),
                        orig).astype(np.int32)
    fl = {"deltas": [(rng.standard_normal((3, width)) * 0.01)
                     .astype(np.float32) for _ in range(2)],
          "targets": [rng.uniform(0, VOCAB, (3, 30)) for _ in range(2)]}
    sl = {"smashed": [rng.standard_normal((100, 14, 8)).astype(np.float32)
                      for _ in range(3)],
          "original": [rng.integers(0, VOCAB, (100, 30)).astype(np.int32)
                       for _ in range(3)]}
    return ({"received": received, "original": orig}, fl, sl)


def _results(cls, caps):
    """One RunResult a row, with the same bills, FLOPs and scores."""
    cl, fl, sl = caps
    return (cls([0.61, 0.70, 0.72], [0.69, 0.6, 0.55], 10_346_496.0, 0.0,
                3.1e9, cl),
            cls([0.62, 0.71], [0.68, 0.58], 2 * 717_384.0, 2.09e9, 0.0, fl),
            cls([0.6, 0.66, 0.7, 0.73], [0.7, 0.6, 0.5, 0.45],
                5_505_024.0, 2.3e8, 2.7e9, sl))


def _jax_norm(tokens):                 # benchmarks/table2.py:33-34
    return tokens.astype(np.float32) / float(VOCAB)


def _jax_assembly(cl, fl, sl, seed=0, steps=STEPS):
    """benchmarks/table2.py:46-114 on three JAX RunResults, the corpus
    at N_TRAIN / N_TEST (`corpus()` at the run's size)."""
    key = jax.random.PRNGKey(seed + 11)                           # :46
    seen = {"central": (_jax_norm(cl.captures["received"][:4096]),
                        _jax_norm(cl.captures["original"][:4096]))}
    err_cl = JPRIV.direct_error(*seen["central"])                 # :50-51
    deltas = np.concatenate(fl.captures["deltas"], axis=0)        # :61
    targets = np.concatenate(fl.captures["targets"], axis=0)      # :62
    rngp = np.random.default_rng(0)                               # :64
    proj = rngp.standard_normal((deltas.shape[1], 1024)).astype(np.float32)
    proj /= np.sqrt(deltas.shape[1])                              # :66
    seen["proj"] = proj
    seen["fl_statistic"] = (deltas @ proj, _jax_norm(targets))
    err_fl_stat = JPRIV.reconstruction_error(                     # :67-68
        key, *seen["fl_statistic"], steps=steps)
    (xtr, _), _ = j_corpus(N_TRAIN, N_TEST)                       # :72
    shards = j_partition_users(xtr, np.zeros(len(xtr), np.int32), 3)
    obs_b, tgt_b, drawn = [], [], []
    per = 64                                                      # :75
    for c in range(len(fl.captures["deltas"])):                   # :76-82
        for u in range(3):
            idx = rngp.integers(0, len(shards[u][0]), per)
            drawn.append(idx)
            obs_b.append(np.repeat(
                (fl.captures["deltas"][c][u] @ proj)[None], per, axis=0))
            tgt_b.append(shards[u][0][idx])
    seen["fl_rows"] = drawn
    seen["fl_per_sample"] = (np.concatenate(obs_b),
                             _jax_norm(np.concatenate(tgt_b)))
    err_fl = JPRIV.reconstruction_error(key, *seen["fl_per_sample"],
                                        steps=steps)              # :83-85
    obs = np.concatenate(sl.captures["smashed"], axis=0)          # :87
    orig = np.concatenate(sl.captures["original"], axis=0)        # :88
    n = min(len(obs.reshape(len(obs), -1)), 20_000)               # :89
    seen["sl"] = (obs.reshape(len(obs), -1)[:n], _jax_norm(orig)[:n])
    err_sl = JPRIV.reconstruction_error(key, *seen["sl"], steps=steps)
    scale = 1_440_000 / N_TRAIN                                   # :94
    rows = {}
    for name, res, err in (("central", cl, err_cl), ("fl_q8", fl, err_fl),
                           ("sl_early_cut", sl, err_sl)):         # :96-113
        wcfg = JAX_SCHEMES[name][0]
        comp_j = JEN.comp_energy_j(res.user_flops, "edge")
        comm_j = JEN.comm_energy_j(res.total_bits, wcfg)
        if name == "fl_q8":
            rows.setdefault("fl_q8_extra", {})[
                "recon_error_statistic"] = float(err_fl_stat)
        rows[name] = {
            "total_bits_M": res.total_bits / 1e6,
            "total_bits_M_paper_scale": res.total_bits * scale / 1e6,
            "accuracy": res.final_accuracy,
            "recon_error": float(err),
            "comp_energy_j": comp_j,
            "comm_energy_j": comm_j,
            "total_energy_j": comp_j + comm_j,
            "co2_kg": JEN.co2_kg(comp_j + comm_j),
        }
    return rows, seen


def _jax_lines(rows):
    """benchmarks/table2.py:122-141 on `rows`."""
    out = []
    for name, r in rows.items():
        for k, v in r.items():
            out.append(f"table2,{name},{k},{v:.6g}")
    out.append(f"table2,claim,privacy_sl_gt_cl,"
               f"{rows['sl_early_cut']['recon_error'] > rows['central']['recon_error']}")
    out.append(f"table2,claim,privacy_sl_gt_fl_statistic_protocol,"
               f"{rows['sl_early_cut']['recon_error'] > rows['fl_q8_extra']['recon_error_statistic']}")
    out.append(f"table2,claim,privacy_sl_gt_fl_per_sample_protocol,"
               f"{rows['sl_early_cut']['recon_error'] > rows['fl_q8']['recon_error']}")
    out.append(f"table2,claim,privacy_fl_gt_cl_per_sample,"
               f"{rows['fl_q8']['recon_error'] > rows['central']['recon_error']}")
    out.append(f"table2,claim,comp_sl_lt_fl,"
               f"{rows['sl_early_cut']['comp_energy_j'] < rows['fl_q8']['comp_energy_j']}")
    out.append(f"table2,claim,comm_sl_gt_fl,"
               f"{rows['sl_early_cut']['comm_energy_j'] > rows['fl_q8']['comm_energy_j']}")
    out.append(f"table2,claim,bits_sl_gt_cl_gt_fl,"
               f"{rows['sl_early_cut']['total_bits_M'] > rows['central']['total_bits_M'] > rows['fl_q8']['total_bits_M']}")
    return out


# ------------------------------------------------------------- assembly
@pytest.fixture(scope="module")
def assembled():
    caps = _captures()
    want, seen = _jax_assembly(*_results(JRunResult, caps))
    port = _results(RunResult, caps)
    got = T2.adversary_inputs(*(r.captures for r in port), N_TRAIN, N_TEST)
    rows = T2.rows_from_runs(*port, JaxAdversaryDraws(
        jax.random.PRNGKey(0 + 11)), adv_steps=STEPS, n_train=N_TRAIN,
        n_test=N_TEST, device="cpu")
    return want, seen, got, rows


@pytest.mark.parametrize("what", ["central", "proj", "fl_statistic",
                                  "fl_rows", "fl_per_sample", "sl"])
def test_adversary_inputs_equal_jax(assembled, what):
    _, seen, got, _ = assembled
    want, have = seen[what], got[what]
    if what == "proj":
        want, have = [want], [have]
    assert len(have) == len(want)
    for a, b in zip(have, want):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


def test_rows_equal_jax(assembled):
    want, _, _, rows = assembled
    assert list(rows) == list(want) == JAX_ROWS
    assert list(rows["fl_q8_extra"]) == ["recon_error_statistic"]
    for name in ("central", "fl_q8", "sl_early_cut"):
        assert list(rows[name]) == list(want[name]) == JAX_KEYS
        for k in JAX_KEYS:
            if k != "recon_error" or name == "central":
                assert rows[name][k] == want[name][k], (name, k)
    errs = [(rows[n]["recon_error"], want[n]["recon_error"])
            for n in ("fl_q8", "sl_early_cut")]
    errs.append((rows["fl_q8_extra"]["recon_error_statistic"],
                 want["fl_q8_extra"]["recon_error_statistic"]))
    for got, ref in errs:
        assert abs(got - ref) <= REL_TOL * ref, (got, ref)
    # the paper-scale bits: the bits x 1.44 M / the corpus' rows
    assert rows["central"]["total_bits_M_paper_scale"] == \
        10_346_496.0 * (1_440_000 / N_TRAIN) / 1e6


def test_claims_and_lines_equal_jax(assembled):
    want, _, _, rows = assembled
    jax_lines = _jax_lines(want)
    assert [f"table2,claim,{k},{v}" for k, v in T2.claims(rows)] == \
        jax_lines[-7:]
    assert [ln.rsplit(",", 1)[0] for ln in T2.lines(rows)] == \
        [ln.rsplit(",", 1)[0] for ln in jax_lines]
    assert _jax_lines(rows) == T2.lines(rows)


def test_sl_rows_are_capped_at_jax_limit(monkeypatch):
    monkeypatch.setattr(T2, "SL_ROWS", 250)
    _, _, sl = _captures()
    obs, tgt = T2.sl_pair(sl)
    assert obs.shape == (250, 112) and tgt.shape == (250, 30)
    np.testing.assert_array_equal(obs[200:], sl["smashed"][2][:50]
                                  .reshape(50, -1))


# -------------------------------------------------------- run and CLI
@pytest.fixture(scope="module")
def cpu_run(tmp_path_factory):
    out = tmp_path_factory.mktemp("table2") / "table2.json"
    text = io.StringIO()
    with contextlib.redirect_stdout(text):
        t2 = T2.main(["--device", "cpu", "--cycles", "1", "--fl-cycles",
                      "1", "--sl-cycles", "1", "--n-train", str(N_TRAIN),
                      "--n-test", str(N_TEST), "--adv-steps", "5",
                      "--out", str(out)])
    return t2, text.getvalue(), out


def _jax_run(name):
    wcfg, opts = JAX_SCHEMES[name]
    exp = JExperiment(j_build_scheme(wcfg, capture=True, **opts), 1,
                      seed=0, n_train=N_TRAIN, n_test=N_TEST)
    return exp, exp.run()


@pytest.mark.parametrize("name", ["central", "fl_q8", "sl_early_cut"])
def test_run_bills_equal_closed_form_and_live_jax(cpu_run, name):
    t2, _, _ = cpu_run
    assert list(t2.rows) == JAX_ROWS
    for row in ("central", "fl_q8", "sl_early_cut"):
        assert list(t2.rows[row]) == JAX_KEYS
    r = t2.runs[name]
    jexp, jres = _jax_run(name)
    init, per, users = T2.closed_form_bills(N_TRAIN)[name]
    assert r.init_bits == init == (jexp.init_delivery.bits
                                   if jexp.init_delivery else 0.0)
    assert [rep.bits for rep in r.reports] == [per]
    for rep, jrep in zip(r.reports, jexp.reports, strict=True):
        assert (rep.bits, rep.n_tx, rep.erased_bits, rep.steps) == \
            (jrep.bits, jrep.n_tx, jrep.erased_bits, jrep.steps)
        assert rep.energy_j == jrep.energy_j
    assert r.result.total_bits == jres.total_bits == (init + per) / users
    assert r.result.user_flops == jres.user_flops
    # the captures JAX's assembly reads, in its shapes
    for k, v in jres.captures.items():
        got = r.result.captures[k]
        if isinstance(v, list):
            assert [np.shape(a) for a in got] == [np.shape(a) for a in v]
        else:
            assert np.shape(got) == np.shape(v)
    # nothing launches on the CPU, and everything is finite
    assert r.round_launches == [(0, 0, 0)] and \
        r.eval_launches == [(0, 0, 0)]
    assert not t2.other_launches
    assert np.isfinite(r.result.accuracy + r.result.loss).all()


def test_cli_prints_jax_lines_and_writes_out(cpu_run):
    t2, text, out = cpu_run
    saved = json.loads(out.read_text())
    assert saved["rows"] == t2.rows and not saved["failures"]
    printed = [ln for ln in text.splitlines() if ln.startswith("table2,")]
    assert printed == _jax_lines(saved["rows"])
    assert len(printed) == 8 * 3 + 1 + 7
    for ln in printed[:-7]:
        assert re.fullmatch(r"table2,\w+,\w+,[-+.\deE]+|table2,\w+,\w+,"
                            r"(?:nan|inf)", ln), ln
    assert saved["claims"] == dict(T2.claims(t2.rows))
    # the constant adversary's held-out error, reported beside the rows
    sl_targets = T2.sl_pair(t2.runs["sl_early_cut"].result.captures)[1]
    held_out = sl_targets[-int(len(sl_targets) * 0.2):]
    assert saved["mean_guess"] == t2.mean_guess
    assert t2.mean_guess["sl_early_cut"] == T2.mean_guess_error(sl_targets)
    np.testing.assert_allclose(
        t2.mean_guess["sl_early_cut"],
        np.mean((held_out - sl_targets[:len(sl_targets) - len(held_out)]
                 .mean(0)) ** 2), rtol=1e-6)
    assert "table2 card: none" in text and "table2 ratios" in text


def test_sl_cycles_default_to_jax_rule(monkeypatch):
    """`sl_cycles=None` is benchmarks/table2.py:44's max(cycles, 35)."""
    seen = {}

    def drive(name, cycles, *a):
        seen[name] = cycles
        return T2.SchemeRun(RunResult([], [], 0.0, 0.0, 0.0, {}), [], 0.0,
                            [], 0.0, [], [])
    pair = (None, np.zeros((5, 30), np.float32))
    monkeypatch.setattr(T2, "_drive", drive)
    monkeypatch.setattr(T2, "adversary_inputs",
                        lambda *a: {"fl_per_sample": pair, "sl": pair})
    monkeypatch.setattr(T2, "rows_from_runs", lambda *a, **k: {})
    for cycles, want in ((20, 35), (40, 40), (1, 35)):
        T2.run(cycles, 7, device="cpu")
        assert seen == {"central": cycles, "fl_q8": 7,
                        "sl_early_cut": want}
    T2.run(1, 1, sl_cycles=2, device="cpu")
    assert seen["sl_early_cut"] == 2


def test_cli_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        T2.main([])
    with pytest.raises(RuntimeError, match="cuda"):
        T2.run(1, 1, sl_cycles=1, n_train=N_TRAIN, n_test=N_TEST)
