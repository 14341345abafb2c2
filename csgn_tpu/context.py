"""Scheme parameters for the CSGN bounded homomorphic encryption scheme.

Re-design of the reference `certFHE::Context` (reference:
src/Context.{h,cpp}).  The reference stores (N, D, S, defaultLen) as mutable
members (src/Context.cpp:20-29); here the context is a frozen, hashable
dataclass so it can be closed over by jitted functions as a static argument.

Derived quantities:
  * ``s = n // (2 * d)`` — reference src/Context.cpp:22.
  * ``words64 = ceil(n / 64)`` — the reference's ``defaultLen``
    (src/Context.cpp:24-28): number of uint64 words per fresh-ciphertext chunk.
  * ``words32 = 2 * words64`` — the device layout splits each uint64 into
    (hi, lo) uint32 halves (JAX computes in 32-bit integers by default).
    The packing rule stays uniform: plaintext-domain bit ``j`` of a chunk
    lives in uint32 word ``j // 32`` at shift ``31 - (j % 32)``, which is
    exactly the reference's MSB-first uint64 layout (bit j in word ``j//64``
    at shift ``63 - (j%64)``, reference src/SecretKey.cpp:176-197) after the
    hi/lo split.  When ``n % 64 <= 32`` the final uint32 word is always zero.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np

__all__ = ["Context"]


@dataclasses.dataclass(frozen=True)
class Context:
    """Scheme parameters ``(n, d)`` plus derived layout constants.

    n: number of bits in one fresh-ciphertext chunk (reference N, e.g. 1247).
    d: number of secret bit positions (reference D, e.g. 16).
    """

    n: int
    d: int

    def __post_init__(self):
        if self.n <= 0 or self.d <= 0:
            raise ValueError(f"Context requires n > 0 and d > 0, got ({self.n}, {self.d})")
        if self.d > self.n:
            raise ValueError(f"Context requires d <= n, got ({self.n}, {self.d})")

    # -- derived scalars ----------------------------------------------------

    @property
    def s(self) -> int:
        """Reference 'S' parameter: n // (2*d) (src/Context.cpp:22)."""
        return self.n // (2 * self.d)

    @property
    def words64(self) -> int:
        """uint64 words per chunk — the reference 'defaultLen' (src/Context.cpp:24-28)."""
        return -(-self.n // 64)

    @property
    def words32(self) -> int:
        """uint32 words per chunk in the device layout (2 per uint64 word)."""
        return 2 * self.words64

    @property
    def bitlen(self) -> tuple[int, ...]:
        """Per-uint64-word occupied bit counts, MSB-first.

        The reference materializes this per ciphertext (src/SecretKey.cpp:171-173)
        but it is a pure function of n: ``[64]*(n//64) + [n%64 if any]``.
        """
        full, rem = divmod(self.n, 64)
        return (64,) * full + ((rem,) if rem else ())

    # -- derived arrays (host-side numpy; safe to close over in jit) --------

    @functools.cached_property
    def valid_mask(self) -> np.ndarray:
        """uint32[words32] with bit positions j < n set (MSB-first layout).

        Bits at positions >= n are never occupied; ANDing with this mask keeps
        packed chunks canonical (all padding bits zero).
        """
        from csgn_tpu import layout

        return layout.bit_positions_to_mask(np.arange(self.n), self.n)

    def chunk_count_bytes(self, chunks: int) -> int:
        """Bytes of packed ciphertext payload for ``chunks`` chunks."""
        return chunks * self.words32 * 4

    # -- parameter updates ----------------------------------------------------

    def with_n(self, n: int) -> "Context":
        """Functional analogue of the reference's mutating ``setN``
        (src/Context.cpp:81-85): a NEW context with n replaced and every
        derived quantity (s, words64, words32, bitlen, valid_mask)
        recomputed.  Contexts here are frozen by design — mutating scheme
        parameters under live ciphertexts is how the reference's dangling
        context bugs arise (SURVEY.md §2b.1)."""
        return dataclasses.replace(self, n=n)

    def with_d(self, d: int) -> "Context":
        """Functional analogue of the reference's ``setD`` (src/Context.cpp:87-91)."""
        return dataclasses.replace(self, d=d)

    def __str__(self) -> str:
        # Reference `operator<<` format (src/Context.cpp:40-47).
        return f"N= {self.n}\nD= {self.d}\nS= {self.s}"
