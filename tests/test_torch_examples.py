"""The port's examples run end to end on the CPU at small values of the
JAX examples' own arguments: the ~100M-parameter trainer's scaled CL
path (4 AdamW steps of batch 8 x seq 16; its loss must drop by 0.5, as
examples/train_100m.py asserts) and the paper's FL over the wireless
channel (one cycle on a cut of the corpus, billing one Q8 upload of
89,673 weights per user). One cycle's test accuracy on the CPU depends
on the order of the float sums (0.53 to 0.70 over three runs at two
threads), so the FL run is held to no accuracy gate here."""
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def _run(script: str, *args: str):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               OMP_NUM_THREADS="2")
    out = subprocess.run([sys.executable, str(ROOT / "examples" / script),
                          "--device", "cpu", *args], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
    return out.stdout


def test_torch_train_100m_smallest(tmp_path):
    text = _run("torch_train_100m.py", "--steps", "4", "--cycle-steps", "2",
                "--seq", "16", "--ckpt-dir", str(tmp_path))
    assert "end-to-end train OK" in text
    assert list(tmp_path.glob("*.npz"))


def test_torch_federated_wireless_smallest():
    text = _run("torch_federated_wireless.py", "--cycles", "1",
                "--n-train", "1536", "--n-test", "256", "--min-acc", "0")
    assert "per-user payload: 0.717 Mbit" in text
