"""Tests that need the GPU: chip_smoke.py's phases at full size.

The test process itself stays on the CPU (conftest.py); each test runs the
smoke in a child process that owns the card.  Run them on a machine with
GPUs with ``python -m pytest tests/test_chip.py -m chip``.
"""
import json
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def gpus():
    """Number of GPUs nvidia-smi lists; skips the test when there are none."""
    try:
        out = subprocess.run(["nvidia-smi", "-L"], capture_output=True,
                             text=True, timeout=60).stdout
    except (FileNotFoundError, subprocess.TimeoutExpired):
        out = ""
    n = sum(line.startswith("GPU ") for line in out.splitlines())
    if n == 0:
        pytest.skip("no GPU: chip tests run on a machine with a card")
    return n


def _smoke(*args):
    env = {k: v for k, v in os.environ.items()
           if k not in ("JAX_PLATFORMS", "XLA_FLAGS")}
    p = subprocess.run([sys.executable, "chip_smoke.py", *args], cwd=ROOT,
                       env=env, capture_output=True, text=True, timeout=1800)
    assert p.returncode == 0, p.stdout[-4000:] + p.stderr[-4000:]
    return json.loads(p.stdout.strip().splitlines()[-1])


@pytest.mark.chip
def test_chip_smoke_one_card(gpus):
    last = _smoke()
    assert last["ok"] and last["device"]["platform"] == "gpu"


@pytest.mark.chip
def test_chip_smoke_four_cards(gpus):
    if gpus < 4:
        pytest.skip(f"needs four GPUs, found {gpus}")
    last = _smoke("--four-cards")
    assert last["ok"] and last["device"]["count"] == 4
