"""Compute ops: jnp oracles (`core`) and the jitted op dispatch
(`dispatch`)."""

from csgn_tpu.ops.core import (
    add_chunks,
    chunk_matches,
    decrypt_parity,
    encrypt_bits,
    keygen,
    mul_chunks,
    permute_chunks,
)

__all__ = [
    "add_chunks",
    "chunk_matches",
    "decrypt_parity",
    "encrypt_bits",
    "keygen",
    "mul_chunks",
    "permute_chunks",
]
