"""Secret key: keygen, encryption, decryption.

Re-design of reference `certFHE::SecretKey`
(src/SecretKey.{h,cpp}).  The key is d distinct bit positions in [0, n)
(index form, matching reference src/SecretKey.h:22) **plus** a precomputed
packed mask form ``uint32[W]`` — the device-facing representation.  With the
mask, a chunk decrypts via the eq-all trick ``(chunk & mask) == mask`` over
words, then a parity sum across chunks: no per-bit unpack (the reference
materializes one byte per bit, src/SecretKey.cpp:87-95,113-124 — the main
reason its decrypt runs at ~1 Gbit/s; the mask form streams packed words).

Randomness is counter-based (threefry) and explicit: `generate` and `encrypt`
take a `jax.random` key.  The reference's time-seeded C rand() path
(src/SecretKey.cpp:311-312, SURVEY.md §2b.5) is emulated bit-exactly in
`csgn_tpu.refcompat` for golden tests.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from csgn_tpu import layout
from csgn_tpu.ciphertext import Ciphertext
from csgn_tpu.context import Context
from csgn_tpu.ops import core, dispatch
from csgn_tpu.permutation import Permutation
from csgn_tpu.plaintext import Plaintext
from csgn_tpu.utils.metrics import op_metrics

__all__ = ["SecretKey"]


@functools.partial(jax.jit, static_argnames=("n", "d"))
def _encrypt_batch_jit(rng, bits, key_indices, mask, valid_mask, n, d):
    return core.encrypt_bits(rng, bits, key_indices, mask, valid_mask, n, d)


@jax.jit
def _chunk_matches_jit(words, mask):
    return core.chunk_matches(words, mask)


@jax.jit
def _decrypt_parity_jit(words, mask):
    return core.decrypt_parity(words, mask)


class SecretKey:
    """d secret bit positions + packed mask; encrypt/decrypt entry points."""

    __slots__ = ("ctx", "indices", "_mask")

    def __init__(self, ctx: Context, indices: np.ndarray):
        indices = np.asarray(indices, dtype=np.int32)
        if indices.shape != (ctx.d,):
            raise ValueError(f"expected {ctx.d} key indices, got shape {indices.shape}")
        if len(np.unique(indices)) != ctx.d:
            raise ValueError("key indices must be distinct")
        if indices.min() < 0 or indices.max() >= ctx.n:
            raise ValueError("key indices out of range")
        self.ctx = ctx
        self.indices = indices
        self.indices.setflags(write=False)
        self._mask = layout.bit_positions_to_mask(indices, ctx.n)

    # -- constructors -------------------------------------------------------

    @classmethod
    def generate(cls, ctx: Context, rng: jax.Array) -> "SecretKey":
        """Sample a fresh key (uniform d-subset of [0, n), random order)."""
        return cls(ctx, np.asarray(core.keygen(rng, ctx.n, ctx.d)))

    # -- properties ---------------------------------------------------------

    @property
    def mask(self) -> np.ndarray:
        """Packed indicator of the secret positions: uint32[W], popcount d."""
        return self._mask

    def size(self) -> int:
        """Reference byte accounting (src/SecretKey.cpp:268-276): context
        pointer + length field + one uint64 per secret index.  144 B at d=16,
        matching the reference's printed size.  (The device-resident footprint
        is `indices.nbytes + mask.nbytes` — the index and mask forms.)"""
        return 8 + 8 + 8 * self.ctx.d

    # -- encryption ---------------------------------------------------------

    def encrypt(self, plaintext, rng: jax.Array) -> Ciphertext:
        """Encrypt one bit into a fresh single-chunk ciphertext."""
        bit = int(plaintext) & 1
        # encrypt_batch returns [W, batch=1], which is already [W, chunks=1].
        words = self.encrypt_batch(jnp.array([bit], dtype=jnp.uint8), rng)
        return Ciphertext(words, self.ctx)

    def encrypt_batch(self, bits: jax.Array, rng, engine: str = "threefry") -> jax.Array:
        """Encrypt bits[batch] -> fresh chunk words uint32[W, batch].

        engine="threefry" (default): `jax.random` — `rng` is a PRNG key;
        reproducible and splittable.
        engine="counter": threefry2x32 on global counters
        (`ops/encrypt_counter.py`) — `rng` is an integer seed; the same
        (seed, batch index) gives the same ciphertext on any backend and at
        any batch size.  Both engines satisfy the same invariants; their
        streams differ.
        """
        if engine == "counter":
            from csgn_tpu.ops.encrypt_counter import encrypt_bits_counter

            batch = int(jnp.asarray(bits).shape[0])
            with op_metrics().record(
                "key.encrypt", chunks_out=batch,
                bytes_moved=self.ctx.chunk_count_bytes(batch),
            ):
                return encrypt_bits_counter(
                    int(rng), bits, self.indices, self._mask,
                    self.ctx.valid_mask, self.ctx.d,
                )
        if engine != "threefry":
            raise ValueError(f"unknown encrypt engine {engine!r}")
        batch = int(jnp.asarray(bits).shape[0])
        with op_metrics().record(
            "key.encrypt", chunks_out=batch,
            bytes_moved=self.ctx.chunk_count_bytes(batch),
        ):
            return _encrypt_batch_jit(
                rng,
                jnp.asarray(bits),
                jnp.asarray(self.indices),
                jnp.asarray(self._mask),
                jnp.asarray(self.ctx.valid_mask),
                self.ctx.n,
                self.ctx.d,
            )

    # -- decryption ---------------------------------------------------------

    def decrypt(self, ciphertext: Ciphertext) -> Plaintext:
        """Decrypt any-length ciphertext: parity of per-chunk ANDs."""
        if ciphertext.ctx != self.ctx:
            raise ValueError("ciphertext context mismatch")
        with op_metrics().record(
            "key.decrypt", chunks_in=ciphertext.chunks,
            bytes_moved=self.ctx.chunk_count_bytes(ciphertext.physical_chunks),
        ):
            bit = dispatch.decrypt_parity(ciphertext.wt, jnp.asarray(self._mask))
            return Plaintext(int(bit))

    def decrypt_batch(self, words) -> jax.Array:
        """Decrypt a batch of ciphertexts -> bits uint32[batch].

        Accepts either fresh single-chunk batches ``uint32[W, batch]`` (parity
        of one chunk == its match bit) or a `CiphertextBatch` / grown payload
        ``uint32[batch, W, chunks]`` (per-element parity across chunks; pad
        chunks never match, so lazy payloads decrypt directly).
        """
        from csgn_tpu.batch import CiphertextBatch

        if isinstance(words, CiphertextBatch):
            if words.ctx != self.ctx:
                raise ValueError("ciphertext context mismatch")
            words = words.wt
        words = jnp.asarray(words)
        w = self.ctx.words32
        if words.ndim == 3:
            if words.shape[-2] != w:
                raise ValueError(
                    f"decrypt_batch grown payload must be [batch, W={w}, chunks], "
                    f"got {words.shape}"
                )
            with op_metrics().record(
                "key.decrypt_batch", chunks_in=words.shape[0] * words.shape[-1],
                bytes_moved=words.size * 4,
            ):
                return _decrypt_parity_jit(words, jnp.asarray(self._mask))
        if words.ndim != 2 or words.shape[0] != w:
            raise ValueError(
                f"decrypt_batch fresh chunks must be [W={w}, batch] "
                f"(word-major; a transposed [batch, W] input would silently "
                f"decrypt garbage), got {words.shape}"
            )
        with op_metrics().record(
            "key.decrypt_batch", chunks_in=words.shape[-1],
            bytes_moved=words.size * 4,
        ):
            return _chunk_matches_jit(words, jnp.asarray(self._mask))

    def mul_and_decrypt(self, c1: Ciphertext, c2: Ciphertext) -> tuple[Ciphertext, Plaintext]:
        """Fused multiply + decrypt: ``(c1 * c2, Dec(c1 * c2))`` in ONE pass.

        The flagship pipeline (reference Ciphertext.cpp:153-163 then
        SecretKey.cpp:126-140) staged costs one product write plus one product
        read; the fused form takes the parity from the operands' match counts
        and never reads the product (`ops.dispatch.mul_decrypt_auto`; the
        parity is chunk-order-independent and pad-neutral).  Bit-exact to
        ``self.decrypt(c1 * c2)``; the returned product is a normal
        Ciphertext carrying the combined order tag (canonical physical order
        under `set_eager_order(True)`, like ``*``).
        """
        if c1.ctx != self.ctx or c2.ctx != self.ctx:
            raise ValueError("ciphertext context mismatch")
        from csgn_tpu import ciphertext as ct_mod
        from csgn_tpu.ops import order

        t1, t2 = c1.chunks, c2.chunks
        with op_metrics().record(
            "key.mul_and_decrypt", chunks_in=t1 + t2, chunks_out=t1 * t2,
            bytes_moved=self.ctx.chunk_count_bytes(t1 + t2 + t1 * t2),
        ):
            mask = jnp.asarray(self._mask)
            if ct_mod._EAGER_ORDER:
                a, b = c1.canonical(), c2.canonical()
                out, parity = dispatch.mul_decrypt(a.wt, b.wt, mask)
                return Ciphertext(out, self.ctx), Plaintext(int(parity))
            out, jmajor, zp_a, zp_b, parity = dispatch.mul_decrypt_auto(
                c1.wt, c2.wt, mask
            )
            la = order.extend_with_pads(c1.logical, t1, zp_a)
            lb = order.extend_with_pads(c2.logical, t2, zp_b)
            tag = order.cross_logical(la, lb, t1, t2, jmajor=jmajor)
            pad = int(out.shape[-1]) - t1 * t2
            return Ciphertext(out, self.ctx, tag, pad), Plaintext(int(parity))

    def mul_and_decrypt_batch(self, cb1, cb2):
        """Batched fused multiply+decrypt: ``(cb1 * cb2, bits uint32[B])`` —
        every element's product and its decrypt parity in one dispatch
        (`ops.dispatch.mul_decrypt_batched_auto`).
        Bit-exact to ``self.decrypt_batch((cb1 * cb2))``.
        """
        from csgn_tpu.batch import CiphertextBatch
        from csgn_tpu.ops import order

        if not isinstance(cb1, CiphertextBatch) or not isinstance(cb2, CiphertextBatch):
            raise TypeError("mul_and_decrypt_batch expects CiphertextBatch operands")
        if cb1.ctx != self.ctx or cb2.ctx != self.ctx:
            raise ValueError("ciphertext context mismatch")
        if cb1.batch != cb2.batch:
            raise ValueError(f"batch mismatch: {cb1.batch} vs {cb2.batch}")
        t1, t2 = cb1.chunks, cb2.chunks
        with op_metrics().record(
            "key.mul_and_decrypt_batch", chunks_in=cb1.batch * (t1 + t2),
            chunks_out=cb1.batch * t1 * t2,
            bytes_moved=cb1.batch * self.ctx.chunk_count_bytes(t1 + t2 + t1 * t2),
        ):
            out, jmajor, zp_a, zp_b, bits = dispatch.mul_decrypt_batched_auto(
                cb1.wt, cb2.wt, jnp.asarray(self._mask)
            )
            la = order.extend_with_pads(cb1.logical, t1, zp_a)
            lb = order.extend_with_pads(cb2.logical, t2, zp_b)
            tag = order.cross_logical(la, lb, t1, t2, jmajor=jmajor)
            pad = int(out.shape[-1]) - t1 * t2
            return CiphertextBatch(out, self.ctx, tag, pad), bits

    def decrypt_product(self, cts: list[Ciphertext]) -> Plaintext:
        """Decrypt a product WITHOUT materializing it: Dec(∏ cᵢ) = ∧ Dec(cᵢ).

        Multiplication is a homomorphism for AND, so the parity of the
        (t₁·t₂·…)-chunk product equals the AND of the factors' parities —
        O(Σ tᵢ) instead of O(∏ tᵢ).  Key-side only (requires decrypting).
        """
        acc = 1
        for ct in cts:
            acc &= int(self.decrypt(ct))
            if acc == 0:
                break
        return Plaintext(acc)

    def _leaf_bits(self, ct):
        """Decrypt one expr leaf: int for a Ciphertext, uint8[B] for a
        `CiphertextBatch` (one batched dispatch)."""
        from csgn_tpu.batch import CiphertextBatch

        if isinstance(ct, CiphertextBatch):
            return np.asarray(jax.device_get(self.decrypt_batch(ct))).astype(np.uint8)
        return int(self.decrypt(ct))

    def decrypt_batches_packed(self, cbs) -> list[int]:
        """Decrypt many `CiphertextBatch`es -> `pack_fleet_bits`-packed ints
        (instance i at bit i), in input order.

        Same-shape batches concatenate into ONE `decrypt_batch` dispatch —
        the shared leaf-decrypt engine for fleet circuit readouts
        (`decrypt_circuits`, serve's key-side netlist route)."""
        from csgn_tpu.batch import CiphertextBatch
        from csgn_tpu.circuit import pack_fleet_bits

        for cb in cbs:
            if cb.ctx != self.ctx:
                raise ValueError("ciphertext context mismatch")
        groups: dict[tuple, list[int]] = {}
        for i, cb in enumerate(cbs):
            groups.setdefault(tuple(cb.wt.shape), []).append(i)
        packed = [0] * len(cbs)
        for idxs in groups.values():
            stacked = CiphertextBatch(
                jnp.concatenate([cbs[i].wt for i in idxs], axis=0), self.ctx
            )
            vals = np.asarray(jax.device_get(self.decrypt_batch(stacked)))
            b = cbs[idxs[0]].batch
            for gi, i in enumerate(idxs):
                packed[i] = pack_fleet_bits(vals[gi * b : (gi + 1) * b])
        return packed

    def decrypt_circuit(self, expr) -> "Plaintext | np.ndarray":
        """Decrypt a +/* DAG of ciphertexts WITHOUT materializing it.

        Dec is a ring homomorphism (reference src/SecretKey.cpp:126-146):
        Dec(a+b) = Dec(a)^Dec(b), Dec(a*b) = Dec(a)&Dec(b).  Cost is
        O(sum of distinct leaf chunks) — each leaf decrypts once (memoized),
        bits fold through the DAG host-side.  Accepts a `circuit.CtExpr` or a
        plain Ciphertext; generalizes `decrypt_product` to arbitrary DAGs
        (e.g. 32-deep chains whose materialized form exceeds HBM).

        DAGs over `CiphertextBatch` leaves fold the whole B-fleet at once
        (one packed-int op per gate; scalar subtrees broadcast) and return
        uint8[B] instead of a Plaintext.
        """
        from csgn_tpu.circuit import lift, unpack_fleet_bits

        e = lift(expr)
        bit = e.fold(self._leaf_bits)
        if e.batch is not None:
            return unpack_fleet_bits(bit, e.batch)
        return Plaintext(bit)

    def decrypt_circuits(self, exprs) -> "list[Plaintext | np.ndarray]":
        """Decrypt MANY +/* DAGs sharing leaves with batched leaf decrypts.

        `decrypt_circuit` issues one device op per distinct leaf per call; a
        multi-output circuit (e.g. the 64 sum bits of an adder netlist, all
        folding over the same 128 input leaves) would pay
        outputs × leaves dispatches.  This collects the distinct leaves
        across ALL the DAGs, decrypts each same-shape group in ONE batched
        dispatch (`decrypt_batch`), and folds every DAG host-side from the
        shared bit table — a netlist's whole output vector decrypts in a
        handful of dispatches.  Bit-exact to per-expr `decrypt_circuit`.

        `CiphertextBatch` leaves (fleet DAGs) are likewise grouped by shape
        and concatenated into one dispatch; their outputs come back as
        uint8[B] arrays (one bit per instance) instead of Plaintexts.
        """
        from csgn_tpu.batch import CiphertextBatch
        from csgn_tpu.circuit import collect_leaves, fold_many, lift, unpack_fleet_bits

        exprs = [lift(e) for e in exprs]
        leaves = collect_leaves(exprs)
        for ct in leaves:
            if ct.ctx != self.ctx:
                raise ValueError("ciphertext context mismatch")
        scalars = [ct for ct in leaves if isinstance(ct, Ciphertext)]
        fleets = [ct for ct in leaves if isinstance(ct, CiphertextBatch)]
        bits: dict[int, int] = {}
        groups: dict[tuple, list[Ciphertext]] = {}
        for ct in scalars:
            groups.setdefault(tuple(ct.wt.shape), []).append(ct)
        for cts in groups.values():
            batch = CiphertextBatch(jnp.stack([c.wt for c in cts]), self.ctx)
            vals = jax.device_get(self.decrypt_batch(batch))
            for c, v in zip(cts, vals):
                bits[id(c)] = int(v)
        for cb, packed in zip(fleets, self.decrypt_batches_packed(fleets)):
            bits[id(cb)] = packed
        # One shared-memo walk over the union DAG: multi-output circuits
        # share interior nodes, so per-expr fold would cost outputs × gates.
        vals = fold_many(exprs, lambda ct: bits[id(ct)])
        return [
            unpack_fleet_bits(v, e.batch) if e.batch is not None else Plaintext(v)
            for e, v in zip(exprs, vals)
        ]

    def recrypt(self, ciphertext: Ciphertext, rng: jax.Array) -> Ciphertext:
        """Key-side re-encryption: decrypt and produce a fresh 1-chunk
        ciphertext of the same bit.

        The scheme is *bounded* homomorphic — chunk counts grow additively
        under + and multiplicatively under * — and there is no public
        compaction (a chunk's decrypt bit is keyed, so chunks cannot be
        folded without the key).  `recrypt` is the key-holder's growth
        reset for deep circuits.
        """
        return self.encrypt(int(self.decrypt(ciphertext)), rng)

    # -- permutation --------------------------------------------------------

    def permute_and_decrypt(
        self, ciphertext: Ciphertext, p: Permutation
    ) -> tuple[Ciphertext, Plaintext]:
        """Key rotation + readout: ``(π(c), Dec_{π(k)}(π(c)))`` in ONE
        dispatch (the reference's permute-then-decrypt flow,
        tests/timings.cpp:56-66).  By the transform identity the
        result equals ``self.decrypt(ciphertext)`` — asserting both is a
        built-in self-check of the rotation (tests do).
        """
        if ciphertext.ctx != self.ctx:
            raise ValueError("ciphertext context mismatch")
        if p.n != self.ctx.n:
            raise ValueError(f"permutation length {p.n} != context n {self.ctx.n}")
        psk = self.apply_permutation(p)
        with op_metrics().record(
            "key.permute_and_decrypt", chunks_in=ciphertext.chunks,
            chunks_out=ciphertext.chunks,
            bytes_moved=2 * self.ctx.chunk_count_bytes(ciphertext.physical_chunks),
        ):
            out, parity = dispatch.permute_decrypt(
                ciphertext.wt, p.benes_plan(), jnp.asarray(psk.mask)
            )
            return (
                Ciphertext(out, self.ctx, ciphertext.logical, ciphertext.pad),
                Plaintext(int(parity)),
            )

    def apply_permutation(self, p: Permutation) -> "SecretKey":
        """Key transform: Dec_{π(k)}(π(c)) = Dec_k(c).

        The permuted key's positions are { i : π[i] ∈ s } = π⁻¹[s]; the
        reference re-extracts them in ascending order
        (src/SecretKey.cpp:244-250), which we match.
        """
        if p.n != self.ctx.n:
            raise ValueError(f"permutation length {p.n} != context n {self.ctx.n}")
        inv = np.argsort(p.perm)
        return SecretKey(self.ctx, np.sort(inv[self.indices]).astype(np.int32))

    def __repr__(self) -> str:
        return f"SecretKey(ctx={self.ctx}, d={self.ctx.d})"

    def __str__(self) -> str:
        # Space-separated index list, as the reference prints it
        # (src/SecretKey.cpp:22-29).
        return " ".join(str(int(x)) for x in self.indices) + " "
