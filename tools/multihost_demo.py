"""True multi-process SPMD validation (the N>=2 "hosts" config, on CPU).

Spawns N python processes (``--nproc``, default 2), each a jax.distributed
participant with its own local CPU devices; the sharded homomorphic ops then
run over the GLOBAL mesh with cross-process collectives — the same program
a real multi-host run executes, minus the fast interconnect.  At N=4 the ring/all-gather
topologies exercise non-trivial fan-in that 2 processes cannot.  Verifies
the sharded multiply + decrypt against the single-process oracle.

The coordinator port is an ephemeral bind (port 0) chosen by the driver, so
concurrent runs (parallel pytest, a leftover worker) never collide.

Run: python tools/multihost_demo.py [--nproc N]   (driver; spawns workers)
     python tools/multihost_demo.py --worker i    (internal)
"""

from __future__ import annotations

import argparse
import os
import socket
import subprocess
import sys

LOCAL_DEVICES = 2


def worker(pid: int, port: int, nproc: int, t1: int = 16, t2: int = 8) -> int:
    import jax

    jax.distributed.initialize(
        coordinator_address=f"localhost:{port}",
        num_processes=nproc,
        process_id=pid,
    )
    import jax.numpy as jnp
    import numpy as np

    import sys as _sys

    _sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    from csgn_tpu.context import Context
    from csgn_tpu.ops import core
    from csgn_tpu.parallel import (
        chunk_mesh,
        sharded_decrypt_parity,
        sharded_mul_allgather,
        sharded_mul_broadcast,
    )
    from csgn_tpu.secret_key import SecretKey

    ndev = len(jax.devices())
    assert ndev == nproc * LOCAL_DEVICES, f"global devices {ndev}"
    mesh = chunk_mesh(ndev)

    ctx = Context(1247, 16)
    rng = np.random.default_rng(0)  # same on every process: replicated inputs
    a = jnp.asarray(rng.integers(0, 2**32, (ctx.words32, t1), dtype=np.uint32) & ctx.valid_mask[:, None])
    b = jnp.asarray(rng.integers(0, 2**32, (ctx.words32, t2), dtype=np.uint32) & ctx.valid_mask[:, None])
    sk = SecretKey(ctx, np.arange(ctx.d, dtype=np.int32) * 71 + 3)
    mask = jnp.asarray(sk.mask)

    if t2 % ndev == 0:
        prod = sharded_mul_allgather(a, b, mesh)
    else:
        prod = sharded_mul_broadcast(a, b, mesh)  # small operand stays replicated
    parity = int(sharded_decrypt_parity(prod, mask, mesh))

    want_prod = np.asarray(core.mul_chunks(a, b))
    want_parity = int(core.decrypt_parity(jnp.asarray(want_prod), mask))
    # The product spans all processes; verify this process's local shards
    # against the matching slices of the single-process oracle.
    ok_words = all(
        np.array_equal(np.asarray(sh.data), want_prod[sh.index])
        for sh in prod.addressable_shards
    )
    ok = ok_words and parity == want_parity
    print(f"[proc {pid}] devices={ndev} words_exact={ok_words} "
          f"parity={parity} want={want_parity} -> {'OK' if ok else 'FAIL'}", flush=True)
    return 0 if ok else 1


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--worker", type=int, default=None)
    ap.add_argument("--port", type=int, default=None)
    ap.add_argument("--nproc", type=int, default=2)
    ap.add_argument("--t1", type=int, default=16)
    ap.add_argument("--t2", type=int, default=8)
    args = ap.parse_args()
    if args.worker is not None:
        return worker(args.worker, args.port, args.nproc, args.t1, args.t2)

    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["XLA_FLAGS"] = f"--xla_force_host_platform_device_count={LOCAL_DEVICES}"
    env["PYTHONPATH"] = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    for attempt in range(3):
        # Ephemeral coordinator port: bind 0, read the assignment, release.
        # The release leaves a TOCTOU window (another process can claim the
        # port before jax.distributed's coordinator binds it), so a failed
        # run retries on a fresh port before being declared a real failure.
        with socket.socket() as s:
            s.bind(("localhost", 0))
            port = s.getsockname()[1]
        procs = [
            subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--worker", str(i),
                 "--port", str(port), "--nproc", str(args.nproc),
                 "--t1", str(args.t1), "--t2", str(args.t2)],
                env=env,
            )
            for i in range(args.nproc)
        ]
        rc = max(p.wait(timeout=600) for p in procs)
        if rc == 0:
            break
        print(f"multihost demo: attempt {attempt + 1} rc={rc}; "
              "retrying on a fresh port", flush=True)
    print("multihost demo:", "OK" if rc == 0 else "FAIL")
    return rc


if __name__ == "__main__":
    sys.exit(main())
