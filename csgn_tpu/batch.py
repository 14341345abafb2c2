"""Batched ciphertexts: B independent ciphertexts as one ``uint32[B, W, C]``.

The reference processes independent ciphertexts one at a time (its timing
harness loops, tests/timings.cpp:26-42); here a batch of B same-shape
ciphertexts is one array with a leading batch axis (SURVEY.md §7 "batch axis
in front everywhere"), and every operator runs once for the whole fleet:

  * add    — chunk concat per element              [B,W,Ca]+[B,W,Cb] -> [B,W,Ca+Cb]
  * mul    — chunk cross-product AND per element   [B,W,t1]*[B,W,t2] -> [B,W,t1*t2]
  * decrypt — per-element parity                   [B,W,C] -> bits[B]
  * permute — same Beneš plan per element (or per-element plans via
    `ops.permute_benes.apply_benes_batch`)

The `ops/core.py` ops broadcast over the leading batch axis, so each batched
operator is one XLA computation.  Both operands of `*` must share B; mixed
shapes stay a Python loop of `Ciphertext`s.

Fast paths the flat layout makes free:
  * fresh x fresh multiply (C==1 both) is ONE elementwise AND — the batched
    analogue of the reference's defaultN_multiply (src/Ciphertext.cpp:124-131).
  * fresh-batch interop: `SecretKey.encrypt_batch` emits ``[W, B]`` (batch on
    the minor axis); `from_fresh`/`to_fresh` are a transpose away.

Chunk order: batched `*` materializes the same physical order for every
element, so ONE shared `logical` tag (ops/order.py) covers the whole batch.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from csgn_tpu.ciphertext import Ciphertext
from csgn_tpu.context import Context
from csgn_tpu.ops import core, dispatch, order
from csgn_tpu.permutation import Permutation
from csgn_tpu.utils.metrics import op_metrics

__all__ = ["CiphertextBatch"]


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class CiphertextBatch:
    """B same-shape ciphertexts: ``wt uint32[B, W, chunks]`` + static context.

    ``logical``/``pad`` are the shared lazy-order tag (see `Ciphertext`):
    identical op sequences give identical physical orders, so one tag serves
    all B elements.
    """

    wt: jax.Array
    ctx: Context = dataclasses.field(metadata=dict(static=True))
    logical: jax.Array | None = None
    pad: int = dataclasses.field(default=0, metadata=dict(static=True))

    def __post_init__(self):
        w = self.wt
        if hasattr(w, "ndim") and w.ndim != 3:
            raise ValueError(f"batched ciphertext words must be [B, W, chunks], got {w.shape}")
        if self.pad and self.logical is None:
            raise ValueError("padded batch requires an order tag")
        if (
            self.logical is not None
            and hasattr(self.logical, "shape")
            and hasattr(w, "shape")
            and self.logical.shape != (w.shape[-1],)
        ):
            raise ValueError(
                f"order tag shape {self.logical.shape} != physical chunks {w.shape[-1]}"
            )

    # -- properties -----------------------------------------------------------

    @property
    def batch(self) -> int:
        return int(self.wt.shape[0])

    @property
    def chunks(self) -> int:
        """Logical chunk count per element (pads excluded)."""
        return int(self.wt.shape[-1]) - self.pad

    @property
    def physical_chunks(self) -> int:
        return int(self.wt.shape[-1])

    @property
    def nbytes(self) -> int:
        return self.batch * self.ctx.chunk_count_bytes(self.chunks)

    @property
    def is_canonical(self) -> bool:
        return self.logical is None

    # -- constructors ---------------------------------------------------------

    @classmethod
    def from_fresh(cls, words: jax.Array, ctx: Context) -> "CiphertextBatch":
        """From a fresh encrypt batch ``uint32[W, B]`` (SecretKey.encrypt_batch)."""
        w, b = words.shape
        return cls(jnp.transpose(words, (1, 0)).reshape(b, w, 1), ctx)

    @classmethod
    def stack(cls, cts: list[Ciphertext]) -> "CiphertextBatch":
        """Stack same-shape ciphertexts (canonicalized) into a batch."""
        if not cts:
            raise ValueError("empty batch")
        ctx = cts[0].ctx
        cs = [ct.canonical() for ct in cts]
        if any(c.ctx != ctx or c.chunks != cs[0].chunks for c in cs):
            raise ValueError("stack requires equal contexts and chunk counts")
        return cls(jnp.stack([c.wt for c in cs]), ctx)

    def __getitem__(self, i: int) -> Ciphertext:
        """Extract element i as a single Ciphertext (shares the tag)."""
        return Ciphertext(self.wt[i], self.ctx, self.logical, self.pad)

    def to_fresh(self) -> jax.Array:
        """Back to the ``[W, B]`` fresh layout (requires chunks == 1)."""
        if self.chunks != 1:
            raise ValueError(f"not a fresh batch: {self.chunks} chunks")
        return jnp.transpose(self.canonical().wt.reshape(self.batch, -1), (1, 0))

    # -- homomorphic operators -------------------------------------------------

    def _check(self, other: "CiphertextBatch") -> None:
        if not isinstance(other, CiphertextBatch):
            raise TypeError(f"expected CiphertextBatch, got {type(other).__name__}")
        if self.ctx != other.ctx:
            raise ValueError("context mismatch")
        if self.batch != other.batch:
            raise ValueError(f"batch mismatch: {self.batch} vs {other.batch}")

    def __add__(self, other: "CiphertextBatch") -> "CiphertextBatch":
        self._check(other)
        t1, t2 = self.chunks, other.chunks
        with op_metrics().record(
            "batch.add", chunks_in=self.batch * (t1 + t2), chunks_out=self.batch * (t1 + t2),
            bytes_moved=2 * self.batch * self.ctx.chunk_count_bytes(t1 + t2),
        ):
            tag = order.concat_logical(self.logical, other.logical, t1, t2)
            return CiphertextBatch(
                core.add_chunks(self.wt, other.wt), self.ctx, tag, self.pad + other.pad
            )

    def __mul__(self, other: "CiphertextBatch") -> "CiphertextBatch":
        self._check(other)
        t1, t2 = self.chunks, other.chunks
        with op_metrics().record(
            "batch.mul", chunks_in=self.batch * (t1 + t2), chunks_out=self.batch * t1 * t2,
            bytes_moved=self.batch * self.ctx.chunk_count_bytes(t1 + t2 + t1 * t2),
        ):
            if t1 == 1 and t2 == 1 and self.pad == 0 and other.pad == 0:
                # Batched defaultN fast path: one elementwise AND.
                return CiphertextBatch(self.wt & other.wt, self.ctx)
            out, jmajor, zp_a, zp_b = dispatch.mul_chunks_batched(self.wt, other.wt)
            la = order.extend_with_pads(self.logical, t1, zp_a)
            lb = order.extend_with_pads(other.logical, t2, zp_b)
            tag = order.cross_logical(la, lb, t1, t2, jmajor=jmajor)
            pad = int(out.shape[-1]) - t1 * t2
            return CiphertextBatch(out, self.ctx, tag, pad)

    def apply_permutation(self, p: Permutation) -> "CiphertextBatch":
        """Apply the same π to every element (per-chunk bit permutation)."""
        if p.n != self.ctx.n:
            raise ValueError(f"permutation length {p.n} != context n {self.ctx.n}")
        with op_metrics().record(
            "batch.permute", chunks_in=self.batch * self.chunks,
            chunks_out=self.batch * self.chunks,
            bytes_moved=2 * self.batch * self.ctx.chunk_count_bytes(self.physical_chunks),
        ):
            return CiphertextBatch(
                dispatch.permute_batched(self.wt, p.benes_plan()),
                self.ctx, self.logical, self.pad,
            )

    def apply_permutations(self, perms: list[Permutation]) -> "CiphertextBatch":
        """Apply permutation i to batch element i (one per element).

        The key-rotation-fleet pattern: B ciphertexts re-randomized under B
        distinct transforms in one computation.  All plans share the delta
        schedule (same n), so they stack into one mask tensor
        (ops/permute_benes.py `apply_benes_batch`); chunk positions are
        untouched, so the shared order tag carries over.
        """
        if len(perms) != self.batch:
            raise ValueError(f"need {self.batch} permutations, got {len(perms)}")
        if any(p.n != self.ctx.n for p in perms):
            raise ValueError(f"permutation length mismatch vs context n {self.ctx.n}")
        from csgn_tpu.ops import permute_benes as pb

        stacked = pb.stack_plans([p.benes_plan() for p in perms])
        with op_metrics().record(
            "batch.permute_multi", chunks_in=self.batch * self.chunks,
            chunks_out=self.batch * self.chunks,
            bytes_moved=2 * self.batch * self.ctx.chunk_count_bytes(self.physical_chunks),
        ):
            return CiphertextBatch(
                dispatch.permute_batched_multi(self.wt, stacked),
                self.ctx, self.logical, self.pad,
            )

    # -- chunk order ------------------------------------------------------------

    def canonical(self) -> "CiphertextBatch":
        if self.logical is None:
            return self
        return CiphertextBatch(
            order.canonicalize(self.wt, self.logical, self.chunks), self.ctx
        )

    # -- interop ---------------------------------------------------------------

    def to_u64(self) -> np.ndarray:
        """Reference-layout uint64 words per element: ``[B, chunks*words64]``."""
        from csgn_tpu import layout

        cm = np.asarray(jax.device_get(self.canonical().wt)).transpose(0, 2, 1)
        return layout.u32_to_u64(cm.reshape(-1, cm.shape[-1])).reshape(self.batch, -1)

    def __repr__(self) -> str:
        ordr = "canonical" if self.logical is None else "lazy"
        padinfo = f"+{self.pad}pad" if self.pad else ""
        return (
            f"CiphertextBatch(B={self.batch}, chunks={self.chunks}{padinfo}, "
            f"W={self.wt.shape[-2]}, order={ordr}, ctx={self.ctx})"
        )
