"""Counter-based batched encryption: reproducible across backends and batch
sizes.

`core.encrypt_bits` (the default engine) draws its randomness with
`jax.random`, whose streams depend on the batch shape.  This engine evaluates
threefry2x32 (Salmon et al., SC'11 — the generator family jax.random uses)
on counters that depend only on (seed, row, global column), so:

  * the same (seed, batch index) gives the same ciphertext on any backend
    and at any batch size (a batch is a prefix of any larger one);
  * the whole encrypt is elementwise integer work that XLA fuses into one
    pass that writes the output once.

Stream spec (fixed; changing it is a format break): R = W + 2 rows padded
to even, R2 = R // 2.  For pair k in [0, R2) and global column j:
(y0, y1) = threefry2x32(key=(seed_lo, seed_hi), ctr=(k, j)); stream row k
is y0, row R2 + k is y1.  Rows [0, W) are the chunk words, row W selects
the broken secret index (mod d — bias d/2^32), row W + 1 supplies the
bit-0 coin.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

__all__ = ["encrypt_bits_counter"]


_TF_ROT = (13, 15, 26, 6, 17, 29, 16, 24)


def _rotl(x: jax.Array, r: int) -> jax.Array:
    return (x << jnp.uint32(r)) | (x >> jnp.uint32(32 - r))


def _threefry2x32(k0, k1, c0: jax.Array, c1: jax.Array):
    """Threefry-2x32-20 over uint32 counter arrays (Random123 spec).  The key
    words may be Python ints or traced uint32 scalars."""
    k0 = jnp.asarray(k0, jnp.uint32)
    k1 = jnp.asarray(k1, jnp.uint32)
    ks = (k0, k1, jnp.uint32(0x1BD11BDA) ^ k0 ^ k1)
    x0 = c0 + ks[0]
    x1 = c1 + ks[1]
    inj = 0
    for i in range(20):
        x0 = x0 + x1
        x1 = _rotl(x1, _TF_ROT[i % 8])
        x1 = x1 ^ x0
        if i % 4 == 3:
            inj += 1
            x0 = x0 + ks[inj % 3]
            x1 = x1 + ks[(inj + 1) % 3] + jnp.uint32(inj)
    return x0, x1


def _counter_stream(seed_lo, seed_hi, rows: int, batch: int) -> jax.Array:
    """The (rows, batch) uint32 stream over global columns [0, batch)."""
    r2 = rows // 2
    c0 = jax.lax.broadcasted_iota(jnp.uint32, (r2, batch), 0)
    c1 = jax.lax.broadcasted_iota(jnp.uint32, (r2, batch), 1)
    y0, y1 = _threefry2x32(seed_lo, seed_hi, c0, c1)
    return jnp.concatenate([y0, y1], axis=0)


@functools.partial(jax.jit, static_argnames=("d",))
def _encrypt(seed_lo, seed_hi, bits, key_indices, mask, valid_mask, d: int):
    w = mask.shape[0]
    batch = bits.shape[0]
    stream = _counter_stream(seed_lo, seed_hi, w + 2 + (w % 2), batch)
    words = stream[:w] & valid_mask[:, None]
    ones_words = words | mask[:, None]
    # bit == 0: break the AND at secret position key_indices[r].
    r_pos = key_indices[stream[w] % jnp.uint32(d)]
    r_word = r_pos // 32
    r_bit = jnp.uint32(1) << (jnp.uint32(31) - (r_pos % 32).astype(jnp.uint32))
    word_ids = jax.lax.broadcasted_iota(jnp.int32, (w, batch), 0)
    onehot = jnp.where(word_ids == r_word[None, :], r_bit[None, :], jnp.uint32(0))
    mask_wo = mask[:, None] & ~onehot
    others_all_one = jnp.all((words & mask_wo) == mask_wo, axis=0)
    rand_bit = stream[w + 1] & jnp.uint32(1)
    forced = jnp.where(others_all_one, jnp.uint32(0), rand_bit)[None, :]
    zero_words = (words & ~onehot) | (onehot * forced)
    is_one = (bits.astype(jnp.uint32) & jnp.uint32(1))[None, :] == jnp.uint32(1)
    return jnp.where(is_one, ones_words, zero_words)


def encrypt_bits_counter(
    seed: int,
    bits: jax.Array,
    key_indices: np.ndarray,
    mask: np.ndarray,
    valid_mask: np.ndarray,
    d: int,
) -> jax.Array:
    """Encrypt bits[batch] -> uint32[W, batch] from a 64-bit integer seed.

    Same invariants as `core.encrypt_bits` (reference src/SecretKey.cpp:35-80):
    bit 1 -> all d secret positions set; bit 0 -> AND over the secret
    positions broken at one uniformly chosen position; bits >= n zero.  The
    seed is a traced argument, so every seed shares one compilation.
    """
    seed = int(seed)
    return _encrypt(
        jnp.uint32(seed & 0xFFFFFFFF),
        jnp.uint32((seed >> 32) & 0xFFFFFFFF),
        jnp.asarray(bits),
        jnp.asarray(key_indices, jnp.int32),
        jnp.asarray(mask, jnp.uint32),
        jnp.asarray(valid_mask, jnp.uint32),
        d,
    )
