"""Lazy chunk-order tags: decouple physical chunk layout from reference order.

Decryption is a parity over the *multiset* of chunks (reference
src/SecretKey.cpp:126-140), so the order of chunks inside a ciphertext is
semantically irrelevant to every homomorphic operator; only the reference's
observable byte layout (serialization, printing, golden comparisons) pins the
canonical order ``i*t2 + j`` for multiply (src/Ciphertext.cpp:159) and
"left then right" for add (src/Ciphertext.cpp:107-122).

A product may be materialized in a non-canonical physical order (the
j-major order is just a concatenation of elementwise ANDs) as long as it
carries a **logical index tag**:

    logical: int32[physical]          # physical position p holds the chunk
                                      # whose reference-order index is logical[p],
                                      # or PAD (-1) for an all-zero pad chunk
    None                              # identity: physical == canonical, no pads

**Pad chunks** extend the idea to *alignment*: an all-zero chunk is
parity-neutral under decryption ((0 & mask) != mask, so it contributes 0 to
the chunk parity) and absorbing under multiply (0 & x = 0), so the framework
may freely append zero chunks to align a shape.  Pads are marked PAD in the tag
and dropped — together with the order resolution — by the single gather at
interop boundaries (`canonicalize`).

Tags compose through every operator in O(chunks) integer work (2.5% of
payload bytes at W=40).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

__all__ = [
    "PAD",
    "concat_logical",
    "cross_logical",
    "extend_with_pads",
    "canonicalize",
    "inverse_permutation",
]

# Tag value marking an all-zero alignment pad chunk (no reference-order index).
PAD = -1


def _iota(n: int) -> jax.Array:
    return jnp.arange(n, dtype=jnp.int32)


def extend_with_pads(tag: jax.Array | None, n: int, zpad: int) -> jax.Array | None:
    """Tag for a payload extended with ``zpad`` zero chunks (identity if 0)."""
    if zpad == 0:
        return tag
    base = tag if tag is not None else _iota(n)
    return jnp.concatenate([base, jnp.full((zpad,), PAD, jnp.int32)])


def concat_logical(
    la: jax.Array | None, lb: jax.Array | None, t1: int, t2: int
) -> jax.Array | None:
    """Order tag for add = [a ; b]: b's logical indices shift by a's **logical**
    chunk count ``t1`` (pads keep PAD)."""
    if la is None and lb is None:
        return None
    ia = la if la is not None else _iota(t1)
    ib = lb if lb is not None else _iota(t2)
    ib = jnp.where(ib >= 0, ib + jnp.int32(t1), ib)
    return jnp.concatenate([ia, ib])


def cross_logical(
    la: jax.Array | None,
    lb: jax.Array | None,
    t1: int,
    t2: int,
    *,
    jmajor: bool,
) -> jax.Array | None:
    """Order tag for a physical chunk cross-product.

    ``t1``/``t2`` are the operands' **logical** chunk counts; physical counts
    come from the tags (equal to logical when a tag is None).  The logical
    index of the product of a's chunk (logical i) with b's chunk (logical j)
    is ``i*t2 + j`` (reference src/Ciphertext.cpp:159); any pair involving a
    pad chunk is itself a pad (0 & x = 0).  Physical layout is either i-major
    (canonical, ``p = p1*t2P + p2``) or j-major (``p = p2*t1P + p1``).
    """
    if la is None and lb is None and not jmajor:
        return None
    ia = la if la is not None else _iota(t1)
    ib = lb if lb is not None else _iota(t2)
    if jmajor:
        grid = ib[:, None] + ia[None, :] * jnp.int32(t2)
        pad = (ib[:, None] < 0) | (ia[None, :] < 0)
    else:
        grid = ia[:, None] * jnp.int32(t2) + ib[None, :]
        pad = (ia[:, None] < 0) | (ib[None, :] < 0)
    return jnp.where(pad, jnp.int32(PAD), grid).reshape(-1)


def inverse_permutation(perm: jax.Array) -> jax.Array:
    """inv with inv[perm[p]] = p (perm must be a permutation of [0, C))."""
    c = perm.shape[0]
    return jnp.zeros((c,), jnp.int32).at[perm].set(_iota(c))


@functools.partial(jax.jit, static_argnames=("out_len",))
def canonicalize(
    words: jax.Array, logical: jax.Array, out_len: int | None = None
) -> jax.Array:
    """Reorder payload columns into canonical order, dropping pad chunks:
    ``out[:, logical[p]] = in[:, p]`` for every p with ``logical[p] >= 0``.

    ``out_len`` is the logical chunk count (physical count minus pads); it
    must be passed whenever pads are present (it is static — shapes cannot
    depend on the tag's values).  One chunk-axis gather over the payload — the
    only cost lazy ordering ever pays, and only at interop boundaries.
    """
    phys = logical.shape[0]
    if out_len is None:
        out_len = phys
    # Scatter physical positions at their logical slots; pads (-1) are routed
    # to an out-of-bounds slot and dropped.  Slots never written (possible
    # only with a corrupted tag — non-pad entries must be a permutation of
    # [0, out_len)) keep the out-of-range sentinel and decode to all-ones
    # columns, which fail canonical-form validation (`utils.checks`) instead
    # of silently aliasing column 0.
    slots = jnp.where(logical >= 0, logical, jnp.int32(out_len))
    inv = jnp.full((out_len,), phys, jnp.int32).at[slots].set(
        _iota(phys), mode="drop"
    )
    import numpy as np

    return jnp.take(words, inv, axis=-1, mode="fill", fill_value=np.uint32(0xFFFFFFFF))
