"""Scaling-efficiency report: sharded mul+dec throughput per device count.

Runs the SPMD ops over 1..N-device meshes on whatever backend is present and
reports per-device sustained throughput (the BASELINE.json "ops/s scaling
efficiency at 1 chip / 1 host / N hosts" report).  Scaling numbers mean
something only on real cards (e.g. four GPUs of one host); on a virtual CPU
mesh (XLA_FLAGS=--xla_force_host_platform_device_count=N) the same compiled
collectives run at CPU speed, useful for the overhead's shape only.

Usage: python tools/scaling_bench.py [--devices 8] [--chunks 4096]
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--devices", type=int, default=0, help="max mesh size (0 = all)")
    ap.add_argument("--chunks", type=int, default=4096)
    ap.add_argument("--t2", type=int, default=256)
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    from csgn_tpu.context import Context
    from csgn_tpu.parallel import chunk_mesh, sharded_decrypt_parity, sharded_mul_allgather
    from csgn_tpu.secret_key import SecretKey
    from csgn_tpu.utils.timing import device_median_time

    ctx = Context(1247, 16)
    ndev_all = len(jax.devices())
    max_dev = args.devices or ndev_all
    rng = np.random.default_rng(0)
    sk = SecretKey.generate(ctx, jax.random.key(0))
    mask = jnp.asarray(sk.mask)
    dev = jax.devices()[0]
    print(f"platform={dev.platform} kind={dev.device_kind} devices={ndev_all}", file=sys.stderr)

    rows = []
    n = 1
    while n <= max_dev:
        mesh = chunk_mesh(n)
        t1 = args.chunks
        a = jnp.asarray(rng.integers(0, 2**32, (ctx.words32, t1), dtype=np.uint32))
        b = jnp.asarray(rng.integers(0, 2**32, (ctx.words32, args.t2), dtype=np.uint32))

        @jax.jit
        def step(a, b, mask):
            prod = sharded_mul_allgather(a, b, mesh)
            return sharded_decrypt_parity(prod, mask, mesh)

        t = device_median_time(lambda: step(a, b, mask))
        out_chunks = t1 * args.t2
        rows.append(
            {
                "devices": n,
                "ms": round(t * 1e3, 3),
                "Mchunks_per_s": round(out_chunks / t / 1e6, 1),
                "per_device": round(out_chunks / t / 1e6 / n, 1),
            }
        )
        print(rows[-1], file=sys.stderr)
        n *= 2

    eff = rows[-1]["per_device"] / rows[0]["per_device"] if rows else 0
    print(json.dumps({"rows": rows, "weak_scaling_efficiency": round(eff, 3)}))


if __name__ == "__main__":
    main()
