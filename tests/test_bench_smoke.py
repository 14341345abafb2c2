"""bench.py must run end-to-end and emit exactly one valid JSON line on stdout."""

import json
import subprocess
import sys
import pathlib

ROOT = pathlib.Path(__file__).parent.parent


def test_bench_cpu_smoke():
    env = {
        "JAX_PLATFORMS": "cpu",
        "PATH": "/usr/bin:/bin",
        "PYTHONPATH": str(ROOT),
        "HOME": "/tmp",
    }
    # bench names the device it lands on; on the CPU it uses small sizes.
    proc = subprocess.run(
        [sys.executable, str(ROOT / "bench.py")],
        capture_output=True,
        text=True,
        timeout=900,
        env=env,
        cwd=str(ROOT),
    )
    assert proc.returncode == 0, proc.stderr[-2000:]
    lines = [l for l in proc.stdout.strip().splitlines() if l.strip()]
    assert len(lines) == 1, f"stdout must be exactly one JSON line, got: {proc.stdout!r}"
    data = json.loads(lines[0])
    # driver keys plus sub-metric keys (rates + best-3 spreads per op)
    assert {"metric", "value", "unit", "vs_baseline"} <= set(data)
    for sub in ("fused_gbps", "mul_gbps", "dec_gbps", "enc_b_per_s",
                "perm_gbps", "anchor_gbps", "fused_spread_pct", "groups"):
        assert sub in data, sub
    assert data["value"] > 0
    assert data["groups"] >= 4
    assert data["device"]["platform"] == "cpu"
