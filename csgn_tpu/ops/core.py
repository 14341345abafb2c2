"""Core homomorphic ops on packed chunk tensors — pure jnp reference versions.

These are the semantics oracles, and also the production compute path:
`ops.dispatch` jits them (PERF.md has their times on the card).

Layout convention — **word-major ("wc")**: a ciphertext is ``uint32[W, C]``
with W = ctx.words32 packed words (axis -2) and C chunks on the minor axis,
so each word row is contiguous across chunks.  Batched ciphertexts are
``uint32[B, W, C]``; fresh single-chunk batches are simply ``uint32[W, B]``
(batch rides the chunk axis).

Semantics parity (reference certfhe/CSGN):
  * add = chunk concatenation            (reference src/Ciphertext.cpp:107-122)
  * mul = chunk cross-product AND, output chunk index i*t2 + j
                                         (reference src/Ciphertext.cpp:153-163)
  * decrypt = per-chunk AND over the d secret positions, parity across chunks
                                         (reference src/SecretKey.cpp:126-140)
  * permutation: out bit i = in bit perm[i], applied **per chunk** (the
    mathematically correct extension; the reference truncates multi-chunk
    ciphertexts to one chunk — a bug, SURVEY.md §2b.2 — and we deliberately
    diverge, matching it only on fresh single-chunk ciphertexts).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from csgn_tpu import layout

__all__ = [
    "add_chunks",
    "mul_chunks",
    "chunk_matches",
    "decrypt_parity",
    "permute_chunks",
    "encrypt_bits",
    "keygen",
]


# ---------------------------------------------------------------------------
# Homomorphic operators
# ---------------------------------------------------------------------------


def add_chunks(a: jax.Array, b: jax.Array) -> jax.Array:
    """Homomorphic add: concatenate chunk axes.  [W,ta] + [W,tb] -> [W,ta+tb]."""
    return jnp.concatenate([a, b], axis=-1)


def mul_chunks(a: jax.Array, b: jax.Array) -> jax.Array:
    """Homomorphic multiply: chunk cross-product AND.

    [W,t1] * [W,t2] -> [W, t1*t2] with output chunk index ``i*t2 + j``
    (i-major, matching reference src/Ciphertext.cpp:159).  Batched inputs
    broadcast over leading axes.
    """
    t1, t2 = a.shape[-1], b.shape[-1]
    out = a[..., :, None] & b[..., None, :]           # [..., W, t1, t2]
    return out.reshape(*out.shape[:-2], t1 * t2)


# ---------------------------------------------------------------------------
# Decryption
# ---------------------------------------------------------------------------


def chunk_matches(words: jax.Array, mask: jax.Array) -> jax.Array:
    """Per-chunk decrypt bit: AND of the chunk's bits at the d secret positions.

    A chunk matches iff every mask bit is present: ``(chunk & mask) == mask``
    word-wise, all words (no per-bit unpack and no popcount).
    words: uint32[..., W, C]; mask: uint32[W].  Returns uint32[..., C].
    """
    m = mask[..., :, None]
    return jnp.all((words & m) == m, axis=-2).astype(jnp.uint32)


def decrypt_parity(words: jax.Array, mask: jax.Array) -> jax.Array:
    """Decrypt: parity (sum mod 2) of per-chunk AND bits.

    Matches reference src/SecretKey.cpp:126-140 for any chunk count (the
    reference's single-chunk fast path src/SecretKey.cpp:82-102 is the same
    formula with one chunk).  Returns uint32[...] scalar per leading batch.
    """
    m = chunk_matches(words, mask)
    return jnp.sum(m, axis=-1, dtype=jnp.uint32) & jnp.uint32(1)


# ---------------------------------------------------------------------------
# Permutation
# ---------------------------------------------------------------------------


def permute_chunks(words: jax.Array, perm: jax.Array, n: int) -> jax.Array:
    """Apply bit-position permutation per chunk: out bit i = in bit perm[i].

    words: uint32[..., W, C] -> same shape.  Reference semantics
    (src/Ciphertext.cpp:33-34) on single-chunk inputs; correct per-chunk
    extension for multi-chunk ones.  In the word-major layout this is a
    *row* gather on the unpacked [n, C] bit matrix — chunks stay contiguous.
    """
    bits = layout.unpack_bits_wc(words, n)
    out = jnp.take(bits, perm, axis=-2)
    return layout.pack_bits_wc(out)


# ---------------------------------------------------------------------------
# Key generation & encryption (native mode: threefry)
# ---------------------------------------------------------------------------


def keygen(rng: jax.Array, n: int, d: int) -> jax.Array:
    """Sample d distinct secret bit positions in [0, n).  Returns int32[d].

    The reference uses O(n*d) rejection sampling over C rand()
    (src/SecretKey.cpp:322-335); here we take the first d entries of a
    Fisher-Yates permutation — same distribution, O(n), counter-based.
    """
    return jax.random.permutation(rng, n)[:d].astype(jnp.int32)


def encrypt_bits(
    rng: jax.Array,
    bits: jax.Array,
    key_indices: jax.Array,
    mask: jax.Array,
    valid_mask: jax.Array,
    n: int,
    d: int,
) -> jax.Array:
    """Batched fresh encryption: bits uint[batch] -> uint32[W, batch].

    Encrypt invariant (reference src/SecretKey.cpp:35-80):
      * bit 1: all d secret positions are 1; other in-range bits uniform.
      * bit 0: pick a uniform secret index r; all other bits uniform; the bit
        at position s[r] is forced to 0 if the other d-1 secret bits are all 1,
        else uniform.  Net effect: AND over the d secret positions is 0.
    Out-of-range bits (position >= n) are always 0 (canonical form).
    """
    batch = bits.shape[0]
    w = mask.shape[-1]
    k_words, k_rbit, k_ridx = jax.random.split(rng, 3)

    words = jax.random.bits(k_words, (w, batch), dtype=jnp.uint32) & valid_mask[:, None]

    # bit == 1 branch: force every secret position to 1.
    ones_words = words | mask[:, None]

    # bit == 0 branch: force secret position s[r] to break the AND.
    r = jax.random.randint(k_ridx, (batch,), 0, d)
    r_pos = key_indices[r]                                    # int32[batch]
    r_word = (r_pos // 32).astype(jnp.int32)                  # [batch]
    r_bit = jnp.uint32(1) << (jnp.uint32(31) - (r_pos % 32).astype(jnp.uint32))
    word_ids = jax.lax.broadcasted_iota(jnp.int32, (w, batch), 0)
    onehot = jnp.where(word_ids == r_word[None, :], r_bit[None, :], jnp.uint32(0))
    mask_wo = mask[:, None] & ~onehot
    others_all_one = jnp.all((words & mask_wo) == mask_wo, axis=0)       # [batch]
    rand_bit = jax.random.bits(k_rbit, (batch,), dtype=jnp.uint32) & jnp.uint32(1)
    forced_bit = jnp.where(others_all_one, jnp.uint32(0), rand_bit)
    zero_words = (words & ~onehot) | (onehot * forced_bit[None, :])

    is_one = ((bits.astype(jnp.uint32) & jnp.uint32(1)) == 1)[None, :]
    return jnp.where(is_one, ones_words, zero_words)
