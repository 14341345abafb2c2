"""Permutation as a one-hot MXU matmul — alternative to the gather path.

A bit-position permutation is a linear map over GF(2), so it can ride the
matrix unit: unpack chunks to a [n_pad, C] bit matrix, multiply by the
one-hot permutation matrix in bf16 with float32 accumulation (0/1 values are
exact), repack.  It is off the main path: it exists as a second independent
implementation (differential testing) and as the base for batched
multi-permutation application (P can hold several permutations).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from csgn_tpu import layout

__all__ = ["onehot_matrix", "permute_chunks_mxu"]


def _pad128(n: int) -> int:
    return -(-n // 128) * 128


def onehot_matrix(perm: np.ndarray, n: int) -> jax.Array:
    """bf16 one-hot matrix P with P[i, perm[i]] = 1, padded to 128-multiples."""
    n_pad = _pad128(n)
    p = np.zeros((n_pad, n_pad), np.float32)
    p[np.arange(n), np.asarray(perm, dtype=np.int64)] = 1.0
    return jnp.asarray(p, jnp.bfloat16)


def permute_chunks_mxu(words: jax.Array, p_onehot: jax.Array, n: int) -> jax.Array:
    """Apply a permutation via MXU: uint32[..., W, C] -> same shape.

    `p_onehot` from `onehot_matrix`.  Bit-exact to `core.permute_chunks`
    (values stay in {0, 1}; bf16 represents them exactly and the contraction
    accumulates in f32 with at most one nonzero term per output).
    """
    n_pad = p_onehot.shape[0]
    bits = layout.unpack_bits_wc(words, n).astype(jnp.bfloat16)
    pad = [(0, 0)] * (bits.ndim - 2) + [(0, n_pad - n), (0, 0)]
    bits = jnp.pad(bits, pad)
    out = jax.lax.dot_general(
        p_onehot,
        bits,
        ((((1,), (bits.ndim - 2,)), ((), ()))),
        preferred_element_type=jnp.float32,
    )
    return layout.pack_bits_wc(out[..., :n, :].astype(jnp.uint8))
