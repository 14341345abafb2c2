"""Sharded end-to-end pipeline over a device mesh.

Encrypt a batch (sharded), square it with the all-gather multiply, decrypt
with a psum parity — the full SPMD lifecycle on whatever devices exist
(virtual CPU mesh or several GPUs; same compiled collectives).

Run: XLA_FLAGS=--xla_force_host_platform_device_count=8 JAX_PLATFORMS=cpu \
     python examples/sharded_pipeline.py
"""

from __future__ import annotations

import os


def main(batch: int = 64, n: int = 1247, d: int = 16) -> dict:
    import jax

    if os.environ.get("JAX_PLATFORMS", "").startswith("cpu"):
        jax.config.update("jax_platforms", "cpu")

    import jax.numpy as jnp
    import numpy as np

    from csgn_tpu import Context, SecretKey
    from csgn_tpu.parallel import (
        chunk_mesh,
        sharded_decrypt_parity,
        sharded_encrypt_bits_invariant,
        sharded_mul_allgather,
    )

    ctx = Context(n, d)
    mesh = chunk_mesh()
    nd = mesh.shape["c"]
    batch = -(-batch // nd) * nd

    sk = SecretKey.generate(ctx, jax.random.key(0))
    bits = jnp.asarray(np.arange(batch) % 2, dtype=jnp.uint8)

    words = sharded_encrypt_bits_invariant(
        jax.random.key(1), bits,
        jnp.asarray(sk.indices), jnp.asarray(sk.mask),
        jnp.asarray(ctx.valid_mask), ctx.n, ctx.d, mesh,
    )
    prod = sharded_mul_allgather(words, words, mesh)
    mask = jnp.asarray(sk.mask)
    parity_in = int(sharded_decrypt_parity(words, mask, mesh))
    parity_out = int(sharded_decrypt_parity(prod, mask, mesh))

    expect = int(np.asarray(bits).sum() % 2)
    assert parity_in == expect and parity_out == (expect & expect)
    return {
        "devices": nd,
        "batch": batch,
        "product_chunks": int(prod.shape[-1]),
        "parity": parity_out,
    }


if __name__ == "__main__":
    print(main())
