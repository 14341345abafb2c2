"""Reference-compatibility layer: bit-exact emulation of the C++ library.

The reference draws every random value from glibc `rand()` in a fixed call
order.  This module replays those call sequences exactly (on the host, in
numpy) so tests can check that our JAX pipeline produces *bit-identical*
ciphertext words to the reference binary for a pinned `srand` seed — without
linking any reference code.

Call-sequence contracts emulated here (reference file:line):
  * encrypt bit=1: for i in [0,n): secret positions set to 1 (no rand);
    others consume one rand()%2 each                (src/SecretKey.cpp:41-48)
  * encrypt bit=0: one rand()%d picks the forced secret index; every i except
    that position consumes rand()%2 in order; the forced position is 0 if the
    other d-1 secret bits are all 1, else one more rand()%2
                                                    (src/SecretKey.cpp:49-77)
  * packing: MSB-first into uint64 words            (src/SecretKey.cpp:176-197)
  * permutation generation: for each slot, draw rand()%n until unused
    (the array is pre-filled with a sentinel, so "exists" is membership in
    the already-assigned values)                    (src/Permutation.cpp:144-156)
  * keygen: rejection loop drawing rand()%n until d distinct
    (src/SecretKey.cpp:322-335).  NOTE: the reference's membership scan reads
    uninitialized memory (it checks all d slots before they are filled —
    SURVEY.md §2b.4), so its exact behavior is undefined; we emulate the
    obviously-intended semantics (scan the filled prefix).  Golden tests
    therefore pin keys explicitly via `SecretKey(ctx, indices)`, mirroring the
    reference `setKey` recipe (SURVEY.md §2b.5).
"""

from __future__ import annotations

import numpy as np

from csgn_tpu.context import Context
from csgn_tpu.rng import GlibcRand

__all__ = [
    "ref_encrypt_words",
    "ref_keygen_indices",
    "ref_permutation",
]


def ref_encrypt_words(grand: GlibcRand, bit: int, indices: np.ndarray, ctx: Context) -> np.ndarray:
    """One reference-exact encryption: returns packed uint32[words32].

    `grand` must be positioned exactly where the reference's PRNG would be
    (e.g. freshly seeded, matching an `srand(seed)` right before `encrypt`).
    """
    n, d = ctx.n, ctx.d
    s = np.asarray(indices, dtype=np.int64)
    s_set = set(int(x) for x in s)
    bits = np.zeros(n, dtype=np.uint8)

    if bit & 1:
        for i in range(n):
            if i in s_set:
                bits[i] = 1
            else:
                bits[i] = grand.randmod(2)
    else:
        s_random = int(s[grand.randmod(d)])
        v = 0
        v_nok = True
        for i in range(n):
            if i != s_random:
                bits[i] = grand.randmod(2)
                if i in s_set:
                    if v_nok:
                        v = int(bits[i])
                        v_nok = False
                    v &= int(bits[i])
        bits[s_random] = 0 if v == 1 else grand.randmod(2)

    # MSB-first packing, identical to layout.pack_bits.
    w32 = ctx.words32
    pad = w32 * 32 - n
    b = np.pad(bits.astype(np.uint32), (0, pad)).reshape(w32, 32)
    shifts = np.arange(31, -1, -1, dtype=np.uint32)
    return np.bitwise_or.reduce(b << shifts, axis=-1).astype(np.uint32)


def ref_keygen_indices(grand: GlibcRand, ctx: Context) -> np.ndarray:
    """Reference-style keygen: rejection sampling of d distinct positions.

    Same rand() consumption as the intended reference loop; see module
    docstring for the UB caveat.  Returns indices in generation order.
    """
    out: list[int] = []
    seen: set[int] = set()
    while len(out) < ctx.d:
        t = grand.randmod(ctx.n)
        if t in seen:
            continue
        out.append(t)
        seen.add(t)
    return np.array(out, dtype=np.int32)


def ref_permutation(grand: GlibcRand, n: int) -> np.ndarray:
    """Reference-exact random permutation generation (rand() consumption
    identical to src/Permutation.cpp:148-156)."""
    perm = np.empty(n, dtype=np.int32)
    assigned: set[int] = set()
    for i in range(n):
        r = grand.randmod(n)
        while r in assigned:
            r = grand.randmod(n)
        perm[i] = r
        assigned.add(r)
    return perm
