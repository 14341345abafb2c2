"""Tests that only an NVIDIA GPU can run.  They skip elsewhere; on a machine
with a card run them with `python -m pytest -m gpu tests/`.

The test process itself stays on the CPU (conftest.py); each test starts one
child process that owns the card, so only one process reserves its memory.
"""

import json
import os
import pathlib
import shutil
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).parent.parent


@pytest.fixture
def card_env():
    """Environment for a child process on the card; skips without a GPU."""
    if shutil.which("nvidia-smi") is None:
        pytest.skip("no NVIDIA GPU (nvidia-smi not found)")
    if subprocess.run(["nvidia-smi", "-L"], capture_output=True).returncode != 0:
        pytest.skip("no NVIDIA GPU (nvidia-smi -L failed)")
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    env.pop("XLA_FLAGS", None)
    return env


@pytest.mark.gpu
def test_chip_smoke_on_card(card_env):
    """Phases 0-5 of chip_smoke.py at real size on one card."""
    proc = subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=ROOT, env=card_env,
        capture_output=True, text=True, timeout=1200,
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    last = json.loads(proc.stdout.strip().splitlines()[-1])
    assert last["ok"] and last["device"]["platform"] == "gpu"
