"""Packed-bit layout: MSB-first bit <-> uint32-word conversions.

This is the data-layout contract the whole framework rests on (see SURVEY.md
§2a).  A chunk of ``n`` plaintext-domain bits is stored as ``words32``
uint32 words where bit ``j`` lives in word ``j // 32`` at shift
``31 - (j % 32)``.  This is bit-identical to the reference's MSB-first uint64
packing (reference src/SecretKey.cpp:176-197, unpacking src/SecretKey.cpp:89-95)
after splitting each uint64 into (hi, lo) uint32 halves; `u64_to_u32` /
`u32_to_u64` below are the exact bijection, used for serialization and golden
comparison against reference dumps.

All jnp functions here are shape-polymorphic over leading axes and jittable.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

__all__ = [
    "words32_for",
    "pack_bits",
    "unpack_bits",
    "pack_bits_wc",
    "unpack_bits_wc",
    "u64_to_u32",
    "u32_to_u64",
    "bit_positions_to_mask",
    "format_bits",
]


def words32_for(n: int) -> int:
    """uint32 words per n-bit chunk: 2 * ceil(n / 64)."""
    return 2 * (-(-n // 64))


def pack_bits(bits: jax.Array) -> jax.Array:
    """Pack 0/1 values ``bits[..., n]`` into uint32 words ``[..., words32]``.

    MSB-first within each word: bit j -> word j//32, shift 31 - (j%32).
    """
    n = bits.shape[-1]
    w32 = words32_for(n)
    pad = w32 * 32 - n
    b = jnp.asarray(bits).astype(jnp.uint32)
    if pad:
        b = jnp.pad(b, [(0, 0)] * (b.ndim - 1) + [(0, pad)])
    b = b.reshape(*bits.shape[:-1], w32, 32)
    shifts = jnp.arange(31, -1, -1, dtype=jnp.uint32)
    # Bits land in disjoint positions, so a sum is a bitwise OR.
    return jnp.sum(b << shifts, axis=-1, dtype=jnp.uint32)


def unpack_bits(words: jax.Array, n: int) -> jax.Array:
    """Unpack uint32 words ``[..., words32]`` into 0/1 uint8 ``[..., n]``."""
    w = jnp.asarray(words).astype(jnp.uint32)
    shifts = jnp.arange(31, -1, -1, dtype=jnp.uint32)
    bits = (w[..., :, None] >> shifts) & jnp.uint32(1)
    return bits.reshape(*w.shape[:-1], w.shape[-1] * 32)[..., :n].astype(jnp.uint8)


def pack_bits_wc(bits: jax.Array) -> jax.Array:
    """Word-major packing: 0/1 values ``bits[..., n, C]`` -> uint32 ``[..., W, C]``.

    Same MSB-first bit rule as `pack_bits`, but bits live on axis -2 and the
    chunk axis C rides along as the minor (contiguous) dimension — the
    framework's internal compute layout.
    """
    n, c = bits.shape[-2], bits.shape[-1]
    w32 = words32_for(n)
    pad = w32 * 32 - n
    b = jnp.asarray(bits).astype(jnp.uint32)
    if pad:
        b = jnp.pad(b, [(0, 0)] * (b.ndim - 2) + [(0, pad), (0, 0)])
    b = b.reshape(*b.shape[:-2], w32, 32, c)
    shifts = jnp.arange(31, -1, -1, dtype=jnp.uint32)
    return jnp.sum(b << shifts[:, None], axis=-2, dtype=jnp.uint32)


def unpack_bits_wc(words: jax.Array, n: int) -> jax.Array:
    """Inverse of `pack_bits_wc`: uint32 ``[..., W, C]`` -> uint8 ``[..., n, C]``."""
    w = jnp.asarray(words).astype(jnp.uint32)
    shifts = jnp.arange(31, -1, -1, dtype=jnp.uint32)
    bits = (w[..., :, None, :] >> shifts[:, None]) & jnp.uint32(1)
    bits = bits.reshape(*w.shape[:-2], w.shape[-2] * 32, w.shape[-1])
    return bits[..., :n, :].astype(jnp.uint8)


def u64_to_u32(words64: np.ndarray) -> np.ndarray:
    """Split uint64 words ``[..., W]`` into uint32 ``[..., 2W]`` (hi, lo) pairs.

    Host-side (numpy): the device computes in uint32; uint64 only appears at the
    serialization boundary when diffing against reference dumps.
    """
    w = np.asarray(words64, dtype=np.uint64)
    out = np.empty(w.shape[:-1] + (w.shape[-1] * 2,), dtype=np.uint32)
    out[..., 0::2] = (w >> np.uint64(32)).astype(np.uint32)
    out[..., 1::2] = (w & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    return out


def u32_to_u64(words32: np.ndarray) -> np.ndarray:
    """Inverse of `u64_to_u32`."""
    w = np.asarray(words32, dtype=np.uint32)
    assert w.shape[-1] % 2 == 0
    hi = w[..., 0::2].astype(np.uint64)
    lo = w[..., 1::2].astype(np.uint64)
    return (hi << np.uint64(32)) | lo


def bit_positions_to_mask(positions: np.ndarray, n: int) -> np.ndarray:
    """uint32[words32] mask with the given bit positions set (host-side)."""
    bits = np.zeros(n, dtype=np.uint32)
    bits[np.asarray(positions, dtype=np.int64)] = 1
    w32 = words32_for(n)
    pad = w32 * 32 - n
    b = np.pad(bits, (0, pad)).reshape(w32, 32)
    shifts = np.arange(31, -1, -1, dtype=np.uint32)
    return np.bitwise_or.reduce(b << shifts, axis=-1).astype(np.uint32)


def format_bits(words: np.ndarray, n: int) -> str:
    """Render a packed chunk (or chunks) as the reference's bit string.

    Mirrors the reference `operator<<` printing (src/Ciphertext.cpp:192-199):
    each chunk prints its n bits MSB-first, chunks concatenated.
    """
    w = np.asarray(words, dtype=np.uint32)
    if w.ndim == 1:
        w = w[None]
    out = []
    for chunk in w:
        j = np.arange(n)
        bits = (chunk[j // 32] >> (31 - (j % 32))) & 1
        out.append("".join("1" if b else "0" for b in bits))
    return "".join(out)
