"""Op dispatch: the cached jitted forms of the hot ops that the public API
calls, with a per-route counter (`utils.metrics`).

Every op here is plain XLA.  Measured on an H100 (PERF.md), XLA's fusion of
the `ops/core.py` product writes the product in one pass at the card's write
rate, so no hand-written kernel is needed.  The fused multiply+decrypt takes
its parity from the operands (see `_mul_decrypt_jit`), so the pipeline pays
one product write and no product read.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from csgn_tpu.ops import core
from csgn_tpu.utils.metrics import op_metrics

__all__ = [
    "mul_chunks",
    "mul_chunks_auto",
    "mul_chunks_batched",
    "mul_chunks_jmajor",
    "mul_decrypt",
    "mul_decrypt_auto",
    "mul_decrypt_batched",
    "mul_decrypt_batched_auto",
    "mul_decrypt_count",
    "decrypt_parity",
]


def _path(name: str) -> None:
    """Record which route served this shape (once per compilation when
    called under a trace — see utils.metrics docstring)."""
    op_metrics().count(f"dispatch.{name}")


@functools.cache
def _jit_core_mul():
    return jax.jit(core.mul_chunks)


@functools.cache
def _jit_core_decrypt():
    return jax.jit(core.decrypt_parity)


@functools.cache
def _jit_jmajor_xla():
    @jax.jit
    def jm(a, b):
        t2 = b.shape[-1]
        return jnp.concatenate([a & b[..., :, j : j + 1] for j in range(t2)], axis=-1)

    return jm


def mul_chunks_jmajor(a: jax.Array, b: jax.Array) -> jax.Array:
    """[W,t1] x [W,t2] -> [W, t1*t2] in **j-major** physical order
    (column p = j*t1 + i holds a_i & b_j): the canonical product with the
    operands swapped, which `ops/order.py` tags and canonicalizes lazily."""
    _path("mul.jm_xla")
    return _jit_jmajor_xla()(a, b)


def mul_chunks(a: jax.Array, b: jax.Array) -> jax.Array:
    """[W,t1] x [W,t2] -> [W,t1*t2] in canonical i-major order."""
    _path("mul.xla")
    return _jit_core_mul()(a, b)


def mul_chunks_auto(a: jax.Array, b: jax.Array) -> tuple[jax.Array, bool, int, int]:
    """Materialized product with its layout report ``(words, jmajor, zpad_a,
    zpad_b)`` for the caller's order tag (ops/order.py).  Every route is the
    canonical i-major product, so the report is always ``(False, 0, 0)``."""
    return mul_chunks(a, b), False, 0, 0


def mul_chunks_batched(a: jax.Array, b: jax.Array) -> tuple[jax.Array, bool, int, int]:
    """Batched `mul_chunks_auto`: [B,W,t1] x [B,W,t2] -> ([B,W,t1*t2], False,
    0, 0) — element i of the output is the cross product of the operands'
    elements i, in canonical order."""
    _path("mul.b_xla")
    return _jit_core_mul()(a, b), False, 0, 0


def _match_count(x: jax.Array, mask: jax.Array) -> jax.Array:
    """Chunks of x [..., W, t] that match the mask -> int32[...]."""
    return jnp.sum(core.chunk_matches(x, mask), axis=-1, dtype=jnp.int32)


@functools.cache
def _mul_decrypt_jit(count: bool):
    """ONE jit: the product and its decrypt parity (or raw match count).

    Product column (i, j) holds a_i & b_j, and
      ((a_i & b_j) & m) == m   <=>   (a_i & m) == m  AND  (b_j & m) == m
    (every mask bit must be present in BOTH factors), so the product's match
    count is (matching a-chunks) * (matching b-chunks).  The parity therefore
    needs only the operands, never a read of the product: bit-exactly
    `core.decrypt_parity(core.mul_chunks(a, b), mask)`.  int32 products wrap
    modulo 2^32, which keeps the low bit, so the parity is exact at any size.
    Works on 2-D ([W, t]) and batched 3-D ([B, W, t]) operands alike.
    """

    @jax.jit
    def md(a, b, mask):
        n = _match_count(a, mask) * _match_count(b, mask)
        prod = core.mul_chunks(a, b)
        if count:
            return prod, n
        return prod, (n & 1).astype(jnp.uint32)

    return md


def mul_decrypt(a: jax.Array, b: jax.Array, mask: jax.Array):
    """Fused multiply + decrypt: ``(prod [W, t1*t2] i-major, parity bit)``.

    The flagship pipeline in one dispatch: one product write, no product
    read.  Bit-exact to `core.decrypt_parity(core.mul_chunks(a, b), mask)`.
    """
    _path("mul_dec.xla")
    return _mul_decrypt_jit(False)(a, b, mask)


def mul_decrypt_count(a: jax.Array, b: jax.Array, mask: jax.Array):
    """`mul_decrypt` but returning the raw int32 match count — the psum-able
    form the chunk-sharded fused multiply needs (parallel/ops.py
    `sharded_mul_decrypt`: per-device block counts cross the mesh, then
    mod 2)."""
    _path("mul_dec.xla")
    return _mul_decrypt_jit(True)(a, b, mask)


def mul_decrypt_auto(a: jax.Array, b: jax.Array, mask: jax.Array):
    """`mul_decrypt` with the layout report of `mul_chunks_auto`:
    ``(words, jmajor, zpad_a, zpad_b, parity)``."""
    out, v = mul_decrypt(a, b, mask)
    return out, False, 0, 0, v


def mul_decrypt_batched(a: jax.Array, b: jax.Array, mask: jax.Array):
    """Batched fused multiply+decrypt: [B,W,t1] x [B,W,t2] ->
    ([B,W,t1*t2] i-major, parity uint32[B])."""
    _path("mul_dec.b_xla")
    return _mul_decrypt_jit(False)(a, b, mask)


def mul_decrypt_batched_auto(a: jax.Array, b: jax.Array, mask: jax.Array):
    """`mul_decrypt_batched` with the layout report of `mul_chunks_auto`:
    ``(words [B,W,t1*t2], jmajor, zpad_a, zpad_b, bits uint32[B])``."""
    out, bits = mul_decrypt_batched(a, b, mask)
    return out, False, 0, 0, bits


def decrypt_parity(words: jax.Array, mask: jax.Array) -> jax.Array:
    """XLA eq-all decrypt."""
    return _jit_core_decrypt()(words, mask)


@functools.cache
def _jit_permute(stacked: bool, n: int, n_pad: int, deltas, rows):
    """ONE cached jit per plan schedule for the Beneš delta swaps.  The
    static schedule (deltas/rows) keys the cache; the per-permutation masks
    enter as a traced argument, so every same-size plan shares one
    compilation."""
    from csgn_tpu.ops import permute_benes as pb

    if stacked:
        return jax.jit(lambda words, masks: pb.apply_benes_batch(
            words, pb.StackedPlans(n=n, n_pad=n_pad, deltas=deltas, masks=masks, rows=rows)
        ))
    return jax.jit(lambda words, masks: pb.apply_benes(
        words, pb.BenesPlan(n=n, n_pad=n_pad, deltas=deltas, masks=masks, rows=rows)
    ))


def _permute(words: jax.Array, plan, stacked: bool) -> jax.Array:
    f = _jit_permute(stacked, plan.n, plan.n_pad, plan.deltas, plan.rows)
    return f(words, jnp.asarray(plan.masks))


def permute(words: jax.Array, plan) -> jax.Array:
    """Beneš permutation (XLA delta swaps) over [..., W, C]."""
    _path("permute.benes_xla")
    return _permute(words, plan, stacked=False)


def permute_batched(words: jax.Array, plan) -> jax.Array:
    """Beneš permutation over a batch [B, W, C]: one plan, every element."""
    _path("permute.b_benes_xla")
    return _permute(words, plan, stacked=False)


def permute_batched_multi(words: jax.Array, stacked) -> jax.Array:
    """k DIFFERENT permutations over k ciphertexts [k, W, C] (stacked
    delta swaps)."""
    _path("permute.b_multi_xla")
    return _permute(words, stacked, stacked=True)


@functools.cache
def _jit_permute_decrypt(n: int, n_pad: int, deltas, rows):
    """Permute+decrypt in one jit, cached like `_jit_permute`."""
    from csgn_tpu.ops import permute_benes as pb

    @jax.jit
    def pd(words, masks, mask):
        plan = pb.BenesPlan(n=n, n_pad=n_pad, deltas=deltas, masks=masks, rows=rows)
        out = pb.apply_benes(words, plan)
        return out, core.decrypt_parity(out, mask)

    return pd


def permute_decrypt(words: jax.Array, plan, mask: jax.Array):
    """Permutation + decrypt in ONE jit dispatch: ``(permuted [W, C], parity)``.

    `mask` must be the key matching the OUTPUT (key-transform workflow: the
    permuted key's mask).  Bit-exact to `permute` + `decrypt_parity`.
    """
    _path("permute_dec.xla")
    pd = _jit_permute_decrypt(plan.n, plan.n_pad, plan.deltas, plan.rows)
    return pd(words, jnp.asarray(plan.masks), mask)
