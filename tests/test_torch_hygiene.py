"""The port stands alone: `repro_torch`, `chip_smoke.py` and the port's
examples (`examples/torch_*.py`) import neither JAX nor the JAX package, importing the port builds nothing, and
an entry point asked for the default device runs on the card or raises
— it never falls back to the CPU."""
import ast
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
FORBIDDEN = ("jax", "jaxlib", "repro")


def _port_files():
    return (sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
            + sorted((ROOT / "examples").glob("torch_*.py")))


def _imported_roots(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_file_imports_jax_or_the_jax_package(path):
    bad = sorted(set(_imported_roots(path)) & set(FORBIDDEN))
    assert not bad, f"{path} imports {bad}"


def _run(code: str, cwd=ROOT, env_extra=None):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    env.update(env_extra or {})
    return subprocess.run([sys.executable, "-c", code], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=240)


def test_importing_every_port_module_loads_no_jax_and_builds_nothing():
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, "
        "'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "from repro_torch.kernels import build\n"
        "bad = sorted(n for n in sys.modules if n.split('.')[0] in "
        "('jax', 'jaxlib', 'repro'))\n"
        "print('BAD', bad)\n"
        "print('BUILT', build.load.cache_info().currsize)\n")
    out = _run(code)
    assert out.returncode == 0, out.stderr
    assert "BAD []" in out.stdout and "BUILT 0" in out.stdout, out.stdout


def test_default_device_raises_without_cuda(monkeypatch):
    """Entry points default to "cuda"; with no card they raise instead
    of running on the CPU."""
    from repro_torch.configs import get_arch
    from repro_torch.launch import serve as launch
    from repro_torch.models import api as M
    from repro_torch.models import transformer as T
    from repro_torch.nn import init_params
    from repro_torch.serve import ServeEngine

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_arch("qwen1.5-0.5b").reduced()
    params = init_params(M.param_specs(cfg), torch.Generator(), "cpu")
    for call in (lambda: ServeEngine(cfg, params),
                 lambda: T.init_cache(cfg, 2, 8),
                 lambda: T.init_paged_cache(cfg, 4, 8),
                 lambda: init_params(M.param_specs(cfg), torch.Generator()),
                 lambda: launch.main(["--arch", "qwen1.5-0.5b",
                                      "--reduced"]),
                 lambda: launch.main(["--arch", "paper-tinylstm"])):
        with pytest.raises(RuntimeError, match="cuda"):
            call()


def test_launch_serve_runs_on_cpu_when_asked():
    out = _run("from repro_torch.launch import serve\n"
               "r = serve.main(['--arch', 'qwen1.5-0.5b', '--reduced', "
               "'--device', 'cpu', '--requests', '4', '--snr-db', '8', "
               "'--greedy', '--new-tokens', '3'])\n"
               "print('GEN', r['generated'].shape)\n")
    assert out.returncode == 0, out.stderr
    assert "GEN (4, 3)" in out.stdout and "ttft p50" in out.stdout


def test_unported_family_raises():
    out = _run("from repro_torch.launch import serve\n"
               "serve.main(['--arch', 'nope', '--device', 'cpu'])\n")
    assert out.returncode != 0 and "ROADMAP" in out.stderr


def test_chip_smoke_fails_without_a_card_and_alone(tmp_path):
    """Without CUDA, and in a directory that holds nothing else of the
    repository, chip_smoke.py exits non-zero and prints no result."""
    for cwd in (ROOT, tmp_path):
        script = ROOT / "chip_smoke.py"
        if cwd == tmp_path:
            script = Path(shutil.copy(script, tmp_path / "chip_smoke.py"))
        env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
        env["CUDA_VISIBLE_DEVICES"] = ""
        out = subprocess.run([sys.executable, str(script)], cwd=cwd,
                             env=env, capture_output=True, text=True,
                             timeout=240)
        assert out.returncode != 0, (cwd, out.stdout)
        assert '"ok": true' not in out.stdout, (cwd, out.stdout)
