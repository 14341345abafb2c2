"""2-D sharded batched ops: batch axis x chunk axis over a ("b", "c") mesh.

BASELINE config 4 (large-parameter batched throughput) at pod scale: a
`CiphertextBatch` ``uint32[B, W, C]`` lays out as ``P("b", None, "c")`` —
independent ciphertexts spread over the ``"b"`` mesh axis (pure data
parallel, zero collectives) while each element's chunk axis spreads over
``"c"`` (the superlinear-growth axis, collectives as in `parallel.ops`).

Op structure mirrors the 1-D chunk-sharded layer (`parallel/ops.py`):

  * **multiply** all-gathers the second operand's chunk axis over ``"c"``
    only (the batch axis never moves), then runs the batched product per
    local batch block; i-major output keeps the input sharding despite
    the multiplicative growth.
  * **decrypt** reduces matches locally to one count per local element,
    crosses ``"c"`` with a [B_local]-sized psum, and leaves the result
    batch-sharded ``P("b")``.
  * **permute** is embarrassingly parallel in BOTH axes (bit routing is
    per-chunk).

Like `parallel.ops`, sharded axis sizes must divide evenly; zero-pad chunks
are decrypt-neutral and order tags are the caller's concern (these functions
operate on raw canonical payloads).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from csgn_tpu.ops import core, dispatch
from csgn_tpu.parallel.mesh import BATCH_AXIS, CHUNK_AXIS
from csgn_tpu.utils.metrics import op_metrics

__all__ = [
    "batch_chunk_mesh",
    "shard_batch",
    "sharded_mul_batch",
    "sharded_decrypt_batch",
    "sharded_permute_batch",
]


def batch_chunk_mesh(b_devices: int, c_devices: int, devices=None) -> Mesh:
    """A (b_devices, c_devices) mesh with axes ("b", "c")."""
    from csgn_tpu.parallel.mesh import make_mesh

    return make_mesh((b_devices, c_devices), (BATCH_AXIS, CHUNK_AXIS), devices)


def shard_batch(wt: jax.Array, mesh: Mesh) -> jax.Array:
    """Lay a [B, W, C] payload out as P("b", None, "c") on the mesh."""
    return jax.device_put(wt, NamedSharding(mesh, P(BATCH_AXIS, None, CHUNK_AXIS)))


def _check_div(name: str, size: int, nd: int) -> None:
    if size % nd:
        raise ValueError(f"{name} {size} not divisible by mesh axis size {nd}")


def sharded_mul_batch(a: jax.Array, b: jax.Array, mesh: Mesh) -> jax.Array:
    """Batched chunk-sharded multiply: [B,W,t1] x [B,W,t2] -> [B,W,t1*t2],
    all P("b", None, "c"), element i of the output the cross product of the
    operands' elements i (canonical i-major order, bit-identical to the
    vmapped `core.mul_chunks`).

    The second operand's chunk axis is all-gathered over ``"c"`` (batch
    blocks never move); each device then runs the batched product on its
    [B/bd, W, t1/cd] x [B/bd, W, t2] block.
    """
    bd, cd = mesh.shape[BATCH_AXIS], mesh.shape[CHUNK_AXIS]
    _check_div("batch", a.shape[0], bd)
    _check_div("a chunks", a.shape[-1], cd)
    _check_div("b chunks", b.shape[-1], cd)
    if a.shape[0] != b.shape[0]:
        raise ValueError(f"batch mismatch: {a.shape[0]} vs {b.shape[0]}")

    def local_fn(ab, bb):
        b_full = jax.lax.all_gather(bb, CHUNK_AXIS, axis=2, tiled=True)
        return jax.vmap(dispatch.mul_chunks)(ab, b_full)

    t1, t2 = a.shape[-1], b.shape[-1]
    with op_metrics().record(
        "sharded.mul_batch", chunks_in=a.shape[0] * (t1 + t2),
        chunks_out=a.shape[0] * t1 * t2,
        bytes_moved=a.shape[0] * (t1 + t2 + t1 * t2) * a.shape[-2] * 4,
    ):
        return jax.shard_map(
            local_fn,
            mesh=mesh,
            in_specs=(P(BATCH_AXIS, None, CHUNK_AXIS),) * 2,
            out_specs=P(BATCH_AXIS, None, CHUNK_AXIS),
            check_vma=False,
        )(a, b)


def sharded_decrypt_batch(words: jax.Array, mask: jax.Array, mesh: Mesh) -> jax.Array:
    """Batched chunk-sharded decrypt: [B, W, C] P("b", None, "c") ->
    bits uint32[B] sharded P("b").  One [B/bd]-word psum over "c"."""
    bd, cd = mesh.shape[BATCH_AXIS], mesh.shape[CHUNK_AXIS]
    _check_div("batch", words.shape[0], bd)
    _check_div("chunks", words.shape[-1], cd)

    def local_fn(w_blk, m):
        local = jnp.sum(core.chunk_matches(w_blk, m), axis=-1, dtype=jnp.uint32)
        total = jax.lax.psum(local, CHUNK_AXIS)
        return total & jnp.uint32(1)

    with op_metrics().record(
        "sharded.decrypt_batch", chunks_in=words.shape[0] * words.shape[-1],
        bytes_moved=words.size * 4,
    ):
        return jax.shard_map(
            local_fn,
            mesh=mesh,
            in_specs=(P(BATCH_AXIS, None, CHUNK_AXIS), P(None)),
            out_specs=P(BATCH_AXIS),
        )(words, mask)


def sharded_permute_batch(words: jax.Array, plan, mesh: Mesh) -> jax.Array:
    """Batched chunk-sharded permutation (one plan, every element): zero
    collectives — bit routing is per-chunk, so both mesh axes are
    embarrassingly parallel; output keeps the input sharding."""
    bd, cd = mesh.shape[BATCH_AXIS], mesh.shape[CHUNK_AXIS]
    _check_div("batch", words.shape[0], bd)
    _check_div("chunks", words.shape[-1], cd)

    def local_fn(w_blk):
        return dispatch.permute_batched(w_blk, plan)

    with op_metrics().record(
        "sharded.permute_batch", chunks_in=words.shape[0] * words.shape[-1],
        chunks_out=words.shape[0] * words.shape[-1],
        bytes_moved=2 * words.size * 4,
    ):
        return jax.shard_map(
            local_fn,
            mesh=mesh,
            in_specs=(P(BATCH_AXIS, None, CHUNK_AXIS),),
            out_specs=P(BATCH_AXIS, None, CHUNK_AXIS),
            check_vma=False,
        )(words)
