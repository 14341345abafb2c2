"""chip_smoke.py: it refuses to run without a GPU, and its phases run end to
end here at tiny sizes (on the card they run at the real ones)."""

import json
import os
import pathlib
import shutil
import subprocess
import sys

import jax
import pytest

ROOT = pathlib.Path(__file__).parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402


def _run(script_dir):
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH="")
    return subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=script_dir, env=env,
        capture_output=True, text=True, timeout=300,
    )


def _has_result(stdout: str) -> bool:
    for line in stdout.splitlines():
        try:
            if json.loads(line).get("ok"):
                return True
        except (ValueError, AttributeError):
            pass
    return False


def test_cpu_exits_nonzero_naming_missing_gpu():
    proc = _run(ROOT)
    assert proc.returncode != 0
    assert "no NVIDIA GPU found" in proc.stderr
    assert not _has_result(proc.stdout)


def test_script_alone_exits_nonzero(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    proc = _run(tmp_path)
    assert proc.returncode != 0
    assert not _has_result(proc.stdout)


@pytest.fixture(scope="module")
def sk():
    from csgn_tpu import Context, SecretKey

    return SecretKey.generate(Context(1247, 16), jax.random.key(1))


@pytest.mark.parametrize("phase", ["ops", "serving"])
def test_keyed_phases_tiny(sk, phase):
    fn = {"ops": chip_smoke.phase_ops, "serving": chip_smoke.phase_serving}[phase]
    assert fn(sk, chip_smoke.TINY)


def test_kernels_phase_tiny():
    assert "no hand-written kernel remains" in chip_smoke.phase_kernels(chip_smoke.TINY)


def test_four_cards_phase_on_virtual_devices():
    assert len(jax.devices()) >= 4
    assert "== one card" in chip_smoke.phase_four_cards(chip_smoke.TINY)
