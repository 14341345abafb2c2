"""Collective homomorphic ops: shard_map SPMD versions of the core ops.

Sharding design (SURVEY.md §5, §7.4):

  * Ciphertext chunk axes shard over the ``"c"`` mesh axis: ``uint32[W, C]``
    with spec ``P(None, "c")`` — each device holds a contiguous block of
    chunk columns.
  * **Multiply** is a blockwise outer product.  With `a` chunk-sharded
    (i-blocks local) and `b` either all-gathered (ICI-friendly, one big
    collective) or ring-passed (DCN-friendly, overlaps compute with
    neighbor exchange), each device emits the (i_local, j) cross-product
    block.  Keeping the output i-major means the result is *already*
    chunk-sharded by ``P(None, "c")`` — no resharding despite the
    multiplicative growth.
  * **Decrypt** reduces locally (match count per device) then crosses the
    mesh with a 1-word `psum`; parity = sum mod 2.
  * **Encrypt** shards the batch axis; each device derives its RNG stream by
    `fold_in`-ing its mesh position (counter-based threefry: reproducible
    regardless of device count, but streams differ from the single-device
    layout by design).

All functions require the sharded axis size to divide evenly; callers pad
(zero chunks are decrypt-neutral: they never match a nonzero mask).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from csgn_tpu.ops import core, dispatch
from csgn_tpu.parallel.mesh import CHUNK_AXIS
from csgn_tpu.utils.metrics import op_metrics

__all__ = [
    "sharded_mul_allgather",
    "sharded_mul_broadcast",
    "sharded_mul_decrypt",
    "sharded_mul_ring",
    "sharded_decrypt_parity",
    "sharded_encrypt_bits",
    "sharded_encrypt_bits_invariant",
    "sharded_permute",
]


def _n_axis(mesh: Mesh, axis: str) -> int:
    return mesh.shape[axis]


def sharded_mul_allgather(a: jax.Array, b: jax.Array, mesh: Mesh, axis: str = CHUNK_AXIS) -> jax.Array:
    """Chunk-sharded multiply via all-gather of the second operand.

    a: uint32[W, t1] sharded P(None, axis); b: uint32[W, t2] sharded same.
    Returns uint32[W, t1*t2] sharded P(None, axis), i-major chunk order
    (bit-identical to `core.mul_chunks`).
    """
    nd = _n_axis(mesh, axis)
    if a.shape[-1] % nd or b.shape[-1] % nd:
        raise ValueError(f"chunk counts {a.shape[-1]},{b.shape[-1]} not divisible by mesh axis {nd}")

    def local_fn(a_blk, b_blk):
        b_full = jax.lax.all_gather(b_blk, axis, axis=1, tiled=True)
        return dispatch.mul_chunks(a_blk, b_full)

    t1, t2 = a.shape[-1], b.shape[-1]
    with op_metrics().record(
        "sharded.mul_allgather", chunks_in=t1 + t2, chunks_out=t1 * t2,
        bytes_moved=(t1 + t2 + t1 * t2) * a.shape[-2] * 4,
    ):
        return jax.shard_map(
            local_fn,
            mesh=mesh,
            in_specs=(P(None, axis), P(None, axis)),
            out_specs=P(None, axis),
            check_vma=False,
        )(a, b)


def sharded_mul_broadcast(a: jax.Array, b: jax.Array, mesh: Mesh, axis: str = CHUNK_AXIS) -> jax.Array:
    """Chunk-sharded multiply with a **replicated** second operand.

    For small b (e.g. fresh 1-2 chunk operands in a deep chain) sharding b
    buys nothing; keep it replicated and skip the collective entirely.
    a: uint32[W, t1] sharded P(None, axis); b: uint32[W, t2] replicated.
    Output [W, t1*t2] sharded P(None, axis), i-major.
    """
    nd = _n_axis(mesh, axis)
    if a.shape[-1] % nd:
        raise ValueError(f"chunk count {a.shape[-1]} not divisible by mesh axis {nd}")

    t1, t2 = a.shape[-1], b.shape[-1]
    with op_metrics().record(
        "sharded.mul_broadcast", chunks_in=t1 + t2, chunks_out=t1 * t2,
        bytes_moved=(t1 + t2 + t1 * t2) * a.shape[-2] * 4,
    ):
        return jax.shard_map(
            dispatch.mul_chunks,
            mesh=mesh,
            in_specs=(P(None, axis), P(None, None)),
            out_specs=P(None, axis),
            check_vma=False,
        )(a, b)


def sharded_mul_ring(a: jax.Array, b: jax.Array, mesh: Mesh, axis: str = CHUNK_AXIS) -> jax.Array:
    """Chunk-sharded multiply via ring exchange of b blocks (ppermute).

    Same result as `sharded_mul_allgather`, but b circulates one block per
    step — peak memory per device is O(t2/nd) instead of O(t2), and each
    neighbor exchange overlaps with the block's cross-product compute.  This
    is the DCN-scale variant (ring = nearest-neighbor only).
    """
    nd = _n_axis(mesh, axis)
    if a.shape[-1] % nd or b.shape[-1] % nd:
        raise ValueError(f"chunk counts {a.shape[-1]},{b.shape[-1]} not divisible by mesh axis {nd}")
    t2 = b.shape[-1]
    t2_blk = t2 // nd

    def local_fn(a_blk, b_blk):
        w, t1l = a_blk.shape
        my = jax.lax.axis_index(axis)
        perm = [(i, (i + 1) % nd) for i in range(nd)]  # pass blocks rightward

        def step(s, carry):
            b_cur, out = carry
            # b_cur currently holds the block that started on device (my - s).
            src = (my - s) % nd
            blk_out = dispatch.mul_chunks(a_blk, b_cur)        # [W, t1l*t2_blk]
            # Scatter into out at j-offset src*t2_blk: out viewed [W, t1l, t2].
            out = jax.lax.dynamic_update_slice(
                out.reshape(w, t1l, t2),
                blk_out.reshape(w, t1l, t2_blk),
                (0, 0, src * t2_blk),
            ).reshape(w, t1l * t2)
            b_nxt = jax.lax.ppermute(b_cur, axis, perm)
            return (b_nxt, out)

        # pvary: the zeros carry must be typed device-varying over the mesh
        # axis to match the per-step updated carry under shard_map.
        out0 = jax.lax.pcast(jnp.zeros((w, t1l * t2), jnp.uint32), axis, to="varying")
        _, out = jax.lax.fori_loop(0, nd, step, (b_blk, out0))
        return out

    with op_metrics().record(
        "sharded.mul_ring", chunks_in=a.shape[-1] + t2, chunks_out=a.shape[-1] * t2,
        bytes_moved=(a.shape[-1] + t2 + a.shape[-1] * t2) * a.shape[-2] * 4,
    ):
        return jax.shard_map(
            local_fn,
            mesh=mesh,
            in_specs=(P(None, axis), P(None, axis)),
            out_specs=P(None, axis),
            check_vma=False,
        )(a, b)


def sharded_mul_decrypt(
    a: jax.Array, b: jax.Array, mask: jax.Array, mesh: Mesh, axis: str = CHUNK_AXIS
):
    """Chunk-sharded FUSED multiply+decrypt: ``(prod P(None, axis), parity)``.

    The flagship pipeline across devices: each device runs the fused
    multiply+decrypt on its (i_local, j) block — writing its product block
    and taking its block's match count from the operands — then one scalar
    psum crosses the mesh and the parity is the total mod 2.  The product is
    never re-read anywhere on the mesh.  Bit-identical to
    `sharded_mul_allgather` + `sharded_decrypt_parity` (tests assert both).
    """
    nd = _n_axis(mesh, axis)
    if a.shape[-1] % nd or b.shape[-1] % nd:
        raise ValueError(f"chunk counts {a.shape[-1]},{b.shape[-1]} not divisible by mesh axis {nd}")

    def local_fn(a_blk, b_blk, m):
        b_full = jax.lax.all_gather(b_blk, axis, axis=1, tiled=True)
        prod_blk, cnt = dispatch.mul_decrypt_count(a_blk, b_full, m)
        total = jax.lax.psum(cnt, axis)
        return prod_blk, (total.astype(jnp.uint32) & jnp.uint32(1)).reshape(1)

    t1, t2 = a.shape[-1], b.shape[-1]
    with op_metrics().record(
        "sharded.mul_decrypt", chunks_in=t1 + t2, chunks_out=t1 * t2,
        bytes_moved=(t1 + t2 + t1 * t2) * a.shape[-2] * 4,
    ):
        prod, parity = jax.shard_map(
            local_fn,
            mesh=mesh,
            in_specs=(P(None, axis), P(None, axis), P(None)),
            out_specs=(P(None, axis), P(None)),
            check_vma=False,
        )(a, b, mask)
        return prod, parity[0]


def sharded_decrypt_parity(words: jax.Array, mask: jax.Array, mesh: Mesh, axis: str = CHUNK_AXIS) -> jax.Array:
    """Chunk-sharded decrypt: local eq-all match count, 1-word psum, mod 2."""
    nd = _n_axis(mesh, axis)
    if words.shape[-1] % nd:
        raise ValueError(f"chunk count {words.shape[-1]} not divisible by mesh axis {nd}")

    def local_fn(w_blk, m):
        local = jnp.sum(core.chunk_matches(w_blk, m), dtype=jnp.uint32)
        total = jax.lax.psum(local, axis)
        return (total & jnp.uint32(1)).reshape(1)

    with op_metrics().record(
        "sharded.decrypt", chunks_in=words.shape[-1],
        bytes_moved=words.shape[-1] * words.shape[-2] * 4,
    ):
        out = jax.shard_map(
            local_fn,
            mesh=mesh,
            in_specs=(P(None, axis), P(None)),
            out_specs=P(None),
        )(words, mask)
        return out[0]


def sharded_permute(words: jax.Array, plan, mesh: Mesh, axis: str = CHUNK_AXIS) -> jax.Array:
    """Chunk-sharded permutation: apply one Beneš plan to every local block.

    Bit routing is per-chunk (reference src/Ciphertext.cpp:24-69 applies the
    permutation chunk by chunk), so the chunk axis is embarrassingly
    parallel: each device runs the fused kernel on its block — zero
    collectives, and the output keeps the input sharding.
    """
    nd = _n_axis(mesh, axis)
    if words.shape[-1] % nd:
        raise ValueError(f"chunk count {words.shape[-1]} not divisible by mesh axis {nd}")

    def local_fn(w_blk):
        return dispatch.permute(w_blk, plan)

    with op_metrics().record(
        "sharded.permute", chunks_in=words.shape[-1], chunks_out=words.shape[-1],
        bytes_moved=2 * words.shape[-1] * words.shape[-2] * 4,
    ):
        return jax.shard_map(
            local_fn,
            mesh=mesh,
            in_specs=(P(None, axis),),
            out_specs=P(None, axis),
            check_vma=False,
        )(words)


def sharded_encrypt_bits_invariant(
    rng: jax.Array,
    bits: jax.Array,
    key_indices: jax.Array,
    mask: jax.Array,
    valid_mask: jax.Array,
    n: int,
    d: int,
    mesh: Mesh,
    axis: str = CHUNK_AXIS,
) -> jax.Array:
    """Batch-sharded encryption whose output is **mesh-invariant**.

    Uses partitionable threefry (jax_threefry_partitionable) under plain
    jit + shardings instead of shard_map + per-device fold_in: each device
    generates its slice of the SAME logical random array, so results are
    bit-identical across any device count (1 chip == N hosts) — the property
    golden/replay workflows need.  `sharded_encrypt_bits` (fold_in streams)
    remains the cheaper choice when mesh-invariance doesn't matter.
    """
    from jax.sharding import NamedSharding

    nd = _n_axis(mesh, axis)
    if bits.shape[0] % nd:
        raise ValueError(f"batch {bits.shape[0]} not divisible by mesh axis {nd}")
    in_sh = NamedSharding(mesh, P(axis))
    out_sh = NamedSharding(mesh, P(None, axis))
    f = jax.jit(
        functools.partial(core.encrypt_bits, n=n, d=d),
        out_shardings=out_sh,
    )
    return f(rng, jax.device_put(bits, in_sh), key_indices, mask, valid_mask)


def sharded_encrypt_bits(
    rng: jax.Array,
    bits: jax.Array,
    key_indices: jax.Array,
    mask: jax.Array,
    valid_mask: jax.Array,
    n: int,
    d: int,
    mesh: Mesh,
    axis: str = CHUNK_AXIS,
) -> jax.Array:
    """Batch-sharded fresh encryption: bits[batch] -> uint32[W, batch] with the
    batch (chunk) axis sharded.  Per-device RNG streams via fold_in."""
    nd = _n_axis(mesh, axis)
    if bits.shape[0] % nd:
        raise ValueError(f"batch {bits.shape[0]} not divisible by mesh axis {nd}")

    def local_fn(rng, bits_blk, key_indices, mask, valid_mask):
        dev_rng = jax.random.fold_in(rng, jax.lax.axis_index(axis))
        return core.encrypt_bits(dev_rng, bits_blk, key_indices, mask, valid_mask, n, d)

    return jax.shard_map(
        functools.partial(local_fn),
        mesh=mesh,
        in_specs=(P(), P(axis), P(None), P(None), P(None)),
        out_specs=P(None, axis),
    )(rng, bits, key_indices, mask, valid_mask)
