import os
import sys

# NOTE: do NOT set xla_force_host_platform_device_count here — smoke tests
# and benches must see the real single-device CPU; only launch/dryrun.py
# fakes 512 devices (see the system design notes).
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA device; skips without one "
        "(run on the card: python -m pytest -m cuda tests/test_torch_cuda.py)")
