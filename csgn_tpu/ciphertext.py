"""Ciphertext: an immutable, HBM-resident packed chunk tensor.

Re-design of reference `certFHE::Ciphertext`
(src/Ciphertext.{h,cpp}).  Differences by design:

  * **Immutable pytree** — the reference's mutable value semantics harbor a
    real use-after-free (its operator= drops the context pointer,
    src/Ciphertext.cpp:306-329; see SURVEY.md §2b.1).  Here every operator
    returns a fresh `Ciphertext`; JAX's functional model makes that free.
  * **Word-major uint32 storage** — ``wt: uint32[W, chunks]`` with
    W = ctx.words32.  Chunks ride the minor (contiguous) axis, so each word
    row of a ciphertext is one contiguous run of memory; the per-bit layout is
    the exact hi/lo split of the reference's MSB-first uint64 words (see
    `csgn_tpu.layout`).  Chunk-major views exist only at the serialization
    boundary (`to_u64`/`from_u64`).
  * **Lazy chunk order** — decryption is a parity over the multiset of
    chunks (src/SecretKey.cpp:126-140), so chunk order is semantically
    irrelevant; only the reference's byte layout pins multiply's ``i*t2+j``
    order (src/Ciphertext.cpp:159).  A product may therefore be stored in
    another physical order with the reference order recorded in a
    ``logical`` index tag, resolved by one gather at interop boundaries (see
    `csgn_tpu.ops.order`).  Every product route today is canonical.
    `set_eager_order(True)` restores physically-canonical results everywhere.
  * **Alignment pad chunks** — an all-zero chunk is parity-neutral under
    decryption and absorbing under multiply, so the dispatch may append zero
    chunks (marked PAD in the tag, counted in the static ``pad`` field);
    they are dropped by the same interop gather.
    ``chunks`` always reports the reference-visible (logical) count.
  * **No materialized bitlen** — the reference carries a per-word `bitlen`
    array (src/Ciphertext.h:19-23), but it is always the same per-chunk
    pattern (src/SecretKey.cpp:171-173); here it is derived from the context
    (`ctx.bitlen`) when needed (serialization, printing).
  * **Permutation applies per chunk** — the reference silently truncates
    multi-chunk ciphertexts when permuting (src/Ciphertext.cpp:33-40, bug;
    SURVEY.md §2b.2); we apply π to every chunk, which matches the reference
    on fresh ciphertexts and is the mathematically correct extension.

Operators: ``+`` concatenates chunks (len grows additively), ``*`` is the
chunk cross-product AND (len grows multiplicatively) — semantics parity with
reference src/Ciphertext.cpp:107-179.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from csgn_tpu import layout
from csgn_tpu.context import Context
from csgn_tpu.ops import core, dispatch, order
from csgn_tpu.permutation import Permutation
from csgn_tpu.utils.metrics import op_metrics

__all__ = ["Ciphertext", "set_eager_order"]

# When True, every operator materializes the canonical chunk order physically
# (strict per-op layout parity with the reference; slower for small t2).
_EAGER_ORDER = False


def set_eager_order(eager: bool) -> bool:
    """Toggle physically-canonical chunk order for all new results.

    Returns the previous setting.  Lazy order (the default) is bit-exact at
    every interop boundary; eager mode additionally makes the raw device
    payload `wt` match the reference order after every single op.
    """
    global _EAGER_ORDER
    prev = _EAGER_ORDER
    _EAGER_ORDER = bool(eager)
    return prev


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class Ciphertext:
    """Packed ciphertext words ``uint32[W, chunks]`` plus its static context.

    ``logical`` (optional int32[chunks]) maps physical column p to its
    reference-order index; None means physical == canonical order.
    """

    wt: jax.Array
    ctx: Context = dataclasses.field(metadata=dict(static=True))
    logical: jax.Array | None = None
    pad: int = dataclasses.field(default=0, metadata=dict(static=True))

    def __post_init__(self):
        w = self.wt
        if hasattr(w, "ndim") and w.ndim != 2:
            raise ValueError(f"ciphertext words must be [W, chunks], got shape {w.shape}")
        if self.pad and self.logical is None:
            raise ValueError("padded ciphertext requires an order tag")
        if (
            self.logical is not None
            and hasattr(self.logical, "shape")
            and hasattr(w, "shape")
            and self.logical.shape != (w.shape[-1],)
        ):
            raise ValueError(
                f"order tag shape {self.logical.shape} != physical chunks {w.shape[-1]}"
            )

    # -- properties ---------------------------------------------------------

    @property
    def chunks(self) -> int:
        """Logical chunk count — what the reference layout has (pads excluded)."""
        return int(self.wt.shape[-1]) - self.pad

    @property
    def physical_chunks(self) -> int:
        """Device-resident chunk count, including alignment pad chunks."""
        return int(self.wt.shape[-1])

    @property
    def nbytes(self) -> int:
        """Payload bytes (packed)."""
        return self.ctx.chunk_count_bytes(self.chunks)

    def size(self) -> int:
        """Reference byte accounting (src/Ciphertext.cpp:91-101): four
        pointer/length fields + words and bitlen arrays (16 B per uint64
        word).  352 B for a fresh Context(1247,16) ciphertext, matching the
        reference's printed size.  Device payload bytes are `nbytes`."""
        return 32 + 16 * self.chunks * self.ctx.words64

    @property
    def bitlen(self) -> tuple[int, ...]:
        """Per-uint64-word occupied bit counts, whole ciphertext.

        The reference materializes this per ciphertext (`getBitlen`,
        src/Ciphertext.h:19-23); here it is derived — always the per-chunk
        pattern repeated (proven constant by src/SecretKey.cpp:171-173).
        """
        return self.ctx.bitlen * self.chunks

    @property
    def is_canonical(self) -> bool:
        """True if the physical payload is already in reference chunk order."""
        return self.logical is None

    # -- homomorphic operators ---------------------------------------------

    def _check_ctx(self, other: "Ciphertext") -> None:
        if self.ctx != other.ctx:
            raise ValueError(f"context mismatch: {self.ctx} vs {other.ctx}")

    def __add__(self, other: "Ciphertext") -> "Ciphertext":
        if not isinstance(other, Ciphertext):
            return NotImplemented  # let CtExpr.__radd__ lift us into a DAG
        self._check_ctx(other)
        t1, t2 = self.chunks, other.chunks
        with op_metrics().record(
            "ct.add", chunks_in=t1 + t2, chunks_out=t1 + t2,
            bytes_moved=self.ctx.chunk_count_bytes(2 * (t1 + t2)),
        ):
            tag = order.concat_logical(self.logical, other.logical, t1, t2)
            return Ciphertext(
                core.add_chunks(self.wt, other.wt), self.ctx, tag, self.pad + other.pad
            )

    def __mul__(self, other: "Ciphertext") -> "Ciphertext":
        if not isinstance(other, Ciphertext):
            return NotImplemented  # let CtExpr.__rmul__ lift us into a DAG
        self._check_ctx(other)
        t1, t2 = self.chunks, other.chunks
        with op_metrics().record(
            "ct.mul", chunks_in=t1 + t2, chunks_out=t1 * t2,
            bytes_moved=self.ctx.chunk_count_bytes(t1 + t2 + t1 * t2),
        ):
            if _EAGER_ORDER:
                a, b = self.canonical(), other.canonical()
                return Ciphertext(dispatch.mul_chunks(a.wt, b.wt), self.ctx)
            out, jmajor, zp_a, zp_b = dispatch.mul_chunks_auto(self.wt, other.wt)
            la = order.extend_with_pads(self.logical, self.chunks, zp_a)
            lb = order.extend_with_pads(other.logical, other.chunks, zp_b)
            tag = order.cross_logical(la, lb, self.chunks, other.chunks, jmajor=jmajor)
            pad = int(out.shape[-1]) - self.chunks * other.chunks
            return Ciphertext(out, self.ctx, tag, pad)

    def apply_permutation(self, p: Permutation) -> "Ciphertext":
        """Apply π per chunk (out bit i = in bit π[i]) via the Beneš
        delta-swap plan — packed-domain, no bit unpacking (bit-exact to the
        `ops.core.permute_chunks` gather oracle; see ops/permute_benes.py).
        Chunk positions are untouched, so the order tag carries over."""
        if p.n != self.ctx.n:
            raise ValueError(f"permutation length {p.n} != context n {self.ctx.n}")
        with op_metrics().record(
            "ct.permute", chunks_in=self.chunks, chunks_out=self.chunks,
            bytes_moved=self.ctx.chunk_count_bytes(2 * self.physical_chunks),
        ):
            return Ciphertext(
                dispatch.permute(self.wt, p.benes_plan()), self.ctx, self.logical, self.pad
            )

    # -- chunk order ---------------------------------------------------------

    def canonical(self) -> "Ciphertext":
        """Materialize reference chunk order, dropping alignment pad chunks
        (one lane gather; no-op if already canonical)."""
        if self.logical is None:
            return self
        return Ciphertext(
            order.canonicalize(self.wt, self.logical, self.chunks), self.ctx
        )

    # -- interop ------------------------------------------------------------

    def chunk_major(self) -> np.ndarray:
        """Host-side chunk-major view in reference order: uint32[chunks, W]."""
        return np.asarray(jax.device_get(self.canonical().wt)).T

    def to_u64(self) -> np.ndarray:
        """Reference-layout uint64 words, flat ``[chunks * words64]`` (host)."""
        return layout.u32_to_u64(self.chunk_major()).reshape(-1)

    @classmethod
    def from_u64(cls, words64: np.ndarray, ctx: Context) -> "Ciphertext":
        """Build from reference-layout uint64 words (flat or [chunks, words64])."""
        w64 = np.asarray(words64, dtype=np.uint64).reshape(-1, ctx.words64)
        w32 = layout.u64_to_u32(w64)
        return cls(jnp.asarray(np.ascontiguousarray(w32.T)), ctx)

    @classmethod
    def from_chunk_major(cls, words: np.ndarray, ctx: Context) -> "Ciphertext":
        """Build from a chunk-major uint32[chunks, W] array."""
        w = np.asarray(words, dtype=np.uint32)
        return cls(jnp.asarray(np.ascontiguousarray(w.T)), ctx)

    def bit_string(self) -> str:
        """The reference's `operator<<` rendering (src/Ciphertext.cpp:192-199)."""
        return layout.format_bits(self.chunk_major(), self.ctx.n)

    def __repr__(self) -> str:
        ordr = "canonical" if self.logical is None else "lazy"
        padinfo = f"+{self.pad}pad" if self.pad else ""
        return (
            f"Ciphertext(chunks={self.chunks}{padinfo}, W={self.wt.shape[-2]}, "
            f"order={ordr}, ctx={self.ctx})"
        )
