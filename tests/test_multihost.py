"""Multi-process SPMD: jax.distributed processes, cross-process collectives.

This is the real multi-host code path (BASELINE config 5's "N>=2 hosts"),
CPU-backed: separate OS processes, Gloo collectives, global mesh spanning
non-addressable devices.  N=2 covers the minimal topology; N=4 (8 global
devices) exercises non-trivial ring/all-gather fan-in.
"""

import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).parent.parent


@pytest.mark.parametrize("nproc", [2, 4])
def test_multiprocess_sharded_mul_decrypt(nproc):
    proc = subprocess.run(
        [sys.executable, str(ROOT / "tools" / "multihost_demo.py"),
         "--nproc", str(nproc)],
        capture_output=True,
        text=True,
        timeout=600,
        cwd=str(ROOT),
    )
    assert proc.returncode == 0, (proc.stdout[-2000:], proc.stderr[-1000:])
    assert "multihost demo: OK" in proc.stdout
    for pid in range(nproc):
        assert f"[proc {pid}]" in proc.stdout


def test_initialize_passes_local_device_ids(monkeypatch):
    """One process per card: `initialize` forwards `local_device_ids`, so a
    process claims only its own card."""
    import jax

    from csgn_tpu.parallel import multihost

    seen = {}
    monkeypatch.setattr(jax.distributed, "initialize", lambda **kw: seen.update(kw))
    multihost.initialize("localhost:1234", 4, 2, local_device_ids=[2])
    assert seen == {"coordinator_address": "localhost:1234", "num_processes": 4,
                    "process_id": 2, "local_device_ids": [2]}
