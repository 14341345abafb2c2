"""Deep-circuit pipelines: fused multiplication chains with growth budgeting.

Chunk counts square under homomorphic multiply (the scheme is *bounded*), so
deep chains are a memory/scheduling problem, not just a kernel problem
(SURVEY.md §5 "long-context").  This module provides:

  * `mul_chain` — left-fold product of many ciphertexts inside ONE jit
    dispatch (a fused chain pays the per-op dispatch cost once).
  * `chain_chunks` — closed-form growth accounting, for budgeting before
    running (and deciding where the key holder should `SecretKey.recrypt`).
  * `mul_chain_sharded` — the same fold with the accumulator's chunk axis
    sharded over a mesh; the output of each step is born i-major-sharded, so
    the fold never reshards.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax.sharding import Mesh

from csgn_tpu.ciphertext import Ciphertext
from csgn_tpu.ops import dispatch
from csgn_tpu.parallel.mesh import CHUNK_AXIS
from csgn_tpu.parallel.ops import (
    sharded_decrypt_parity,
    sharded_mul_allgather,
    sharded_mul_broadcast,
    sharded_mul_decrypt,
)
from csgn_tpu.plaintext import Plaintext

__all__ = [
    "HOST_BUDGET_BYTES",
    "chain_chunks",
    "default_budget_bytes",
    "mul_chain",
    "mul_chain_decrypt",
    "mul_chain_sharded",
    "mul_chain_sharded_decrypt",
]

# Share of the device's memory a chain's intermediates may take; the rest is
# headroom for the chain's inputs and XLA's workspace.  `mul_chain` and
# `mul_chain_decrypt` refuse chains whose peak live intermediates exceed the
# budget (the fold runs inside ONE jit, so there is no opportunity to spill
# between steps) — callers pass another budget, or None to opt out.
_BUDGET_SHARE = 0.75
# The budget where the device reports no memory limit (the CPU backend).
HOST_BUDGET_BYTES = 12 << 30


def default_budget_bytes() -> int:
    """`_BUDGET_SHARE` of the first device's memory limit, or
    `HOST_BUDGET_BYTES` where the device reports none."""
    stats = jax.devices()[0].memory_stats() or {}
    limit = stats.get("bytes_limit")
    return int(limit * _BUDGET_SHARE) if limit else HOST_BUDGET_BYTES


def chain_chunks(chunk_counts: list[int]) -> int:
    """Chunks of fold(*, counts): product of all counts."""
    out = 1
    for c in chunk_counts:
        out *= c
    return out


def _check_chain_budget(ctx, counts: list[int], budget_bytes: int | None) -> None:
    """Closed-form peak-live-bytes check for the fused fold: during step k
    the input accumulator and its product coexist (acc * (1 + t_k) chunks)."""
    if budget_bytes is ...:
        budget_bytes = default_budget_bytes()
    if budget_bytes is None or len(counts) < 2:
        return
    acc = counts[0]
    peak = acc
    for t in counts[1:]:
        peak = max(peak, acc * (1 + t))
        acc *= t
    need = ctx.chunk_count_bytes(peak)
    if need > budget_bytes:
        raise ValueError(
            f"chain intermediates peak at ~{need / 2**30:.2f} GiB "
            f"({peak} live chunks) > budget {budget_bytes / 2**30:.2f} GiB; "
            "shard the chain (mul_chain_sharded), reset growth mid-chain "
            "(SecretKey.recrypt), or decrypt without materializing "
            "(SecretKey.decrypt_circuit).  Pass budget_bytes=None to override."
        )


def mul_chain(cts: list[Ciphertext], *, budget_bytes: int | None = ...) -> Ciphertext:
    """Left-fold homomorphic product in one jitted dispatch.

    Chunk ordering matches the reference's sequential `operator*` exactly
    (i-major at each step), so the result is bit-identical to folding with
    `*` one op at a time.  Raises if the fold's peak live intermediates
    exceed ``budget_bytes`` (default: `default_budget_bytes()`).
    """
    if not cts:
        raise ValueError("empty chain")
    ctx = cts[0].ctx
    for ct in cts[1:]:
        if ct.ctx != ctx:
            raise ValueError("context mismatch in chain")
    _check_chain_budget(ctx, [ct.chunks for ct in cts], budget_bytes)

    @jax.jit
    def fold(*wts):
        acc = wts[0]
        for wt in wts[1:]:
            acc = dispatch.mul_chunks(acc, wt)
        return acc

    # Canonicalize inputs (no-op for fresh ciphertexts): the fused fold
    # produces the reference i-major order, so its result carries no tag.
    return Ciphertext(fold(*[ct.canonical().wt for ct in cts]), ctx)


def mul_chain_decrypt(
    cts: list[Ciphertext], sk, *, budget_bytes: int | None = ...
) -> tuple[Ciphertext, Plaintext]:
    """`mul_chain` with the FINAL multiply fused with the decrypt — the whole
    chain-and-read-out pipeline in one jit dispatch, and the final (largest)
    product is written once and never re-read (`dispatch.mul_decrypt`).
    Returns ``(product, Dec(product))``, bit-exact to
    ``(mul_chain(cts), sk.decrypt(mul_chain(cts)))``.  Raises if peak live
    intermediates exceed ``budget_bytes`` (default: `default_budget_bytes()`).
    """
    if not cts:
        raise ValueError("empty chain")
    ctx = cts[0].ctx
    for ct in cts[1:]:
        if ct.ctx != ctx:
            raise ValueError("context mismatch in chain")
    if sk.ctx != ctx:
        raise ValueError("secret key context mismatch")
    _check_chain_budget(ctx, [ct.chunks for ct in cts], budget_bytes)

    @jax.jit
    def fold(mask, *wts):
        acc = wts[0]
        for wt in wts[1:-1]:
            acc = dispatch.mul_chunks(acc, wt)
        if len(wts) > 1:
            return dispatch.mul_decrypt(acc, wts[-1], mask)
        return acc, dispatch.decrypt_parity(acc, mask)

    words, parity = fold(jnp.asarray(sk.mask), *[ct.canonical().wt for ct in cts])
    return Ciphertext(words, ctx), Plaintext(int(parity))


def mul_chain_sharded(cts: list[Ciphertext], mesh: Mesh, axis: str = CHUNK_AXIS) -> Ciphertext:
    """`mul_chain` with the accumulator chunk-sharded over the mesh.

    The first operand's chunk axis must divide the mesh.  Later operands are
    typically small relative to the accumulator: ones that don't divide the
    mesh stay replicated (`sharded_mul_broadcast`, no collective); divisible
    ones are all-gathered from their shards.  The i-major output ordering
    keeps the accumulator contiguously sharded after every step — no
    resharding despite the multiplicative growth.
    """
    if not cts:
        raise ValueError("empty chain")
    ctx = cts[0].ctx
    nd = mesh.shape[axis]
    acc = cts[0].canonical().wt
    for ct in cts[1:]:
        ct = ct.canonical()
        if ct.chunks % nd == 0:
            acc = sharded_mul_allgather(acc, ct.wt, mesh, axis)
        else:
            acc = sharded_mul_broadcast(acc, ct.wt, mesh, axis)
    return Ciphertext(acc, ctx)


def mul_chain_sharded_decrypt(
    cts: list[Ciphertext], sk, mesh: Mesh, axis: str = CHUNK_AXIS
) -> tuple[Ciphertext, Plaintext]:
    """`mul_chain_sharded` with the final step fused with the decrypt
    (`parallel.sharded_mul_decrypt`): the final product's blocks are written
    once per device and never re-read anywhere on the mesh — one scalar psum
    carries the parity out.  Falls back to broadcast-mul + psum decrypt when
    the last operand's chunk count doesn't divide the mesh axis.
    """
    if not cts:
        raise ValueError("empty chain")
    ctx = cts[0].ctx
    if sk.ctx != ctx:
        raise ValueError("secret key context mismatch")
    mask = jnp.asarray(sk.mask)
    nd = mesh.shape[axis]
    if len(cts) == 1:
        acc = cts[0].canonical().wt
        return cts[0], Plaintext(int(sharded_decrypt_parity(acc, mask, mesh, axis)))
    acc = mul_chain_sharded(cts[:-1], mesh, axis).wt
    last = cts[-1].canonical()
    if last.chunks % nd == 0:
        words, parity = sharded_mul_decrypt(acc, last.wt, mask, mesh, axis)
    else:
        words = sharded_mul_broadcast(acc, last.wt, mesh, axis)
        parity = sharded_decrypt_parity(words, mask, mesh, axis)
    return Ciphertext(words, ctx), Plaintext(int(parity))
