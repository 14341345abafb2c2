"""Serving executor: microbatch independent homomorphic requests.

The reference processes one ciphertext op per call (its timing harness loops
single ops, /root/reference/tests/timings.cpp:26-42); a production service
sees *fleets* of small independent requests.  On this class of deployment the
wall-clock cost of a small op is dominated by dispatch latency, not compute
(a dispatch costs far more than the device work of a fresh multiply).

`BatchExecutor` queues requests and executes each *compatible group* as ONE
batched dispatch on the existing `CiphertextBatch` / `encrypt_batch` /
`decrypt_batch` kernels: B requests cost one device round-trip instead of B.
Grouping is by (op, context, chunk shape); incompatible shapes simply land in
different groups and still flush together.

Semantics:
  * `submit_*` returns a `ServeFuture`; nothing touches the device until
    `flush()` (or a group reaching `max_batch`, or the first
    `ServeFuture.result()` — results force a flush of everything pending).
  * Execution is deterministic: requests are batched in submission order and
    encrypt randomness is derived from (executor rng, encrypt-flush index,
    slot) — independent of any interleaved non-encrypt groups — so
    re-running the same submission sequence reproduces every ciphertext.
  * Single-threaded by design — the batching win is dispatch amortization,
    not host concurrency.  Wrap calls in a lock if driving from many threads.

Example::

    ex = BatchExecutor(sk, rng=jax.random.key(0))
    futs = [ex.submit_mul_decrypt(a, b) for a, b in requests]   # no device work
    ex.flush()                                                  # ~1 dispatch/group
    bits = [f.result()[1] for f in futs]
"""

from __future__ import annotations

from typing import Callable

import jax
import jax.numpy as jnp
import numpy as np

from csgn_tpu.batch import CiphertextBatch
from csgn_tpu.ciphertext import Ciphertext
from csgn_tpu.permutation import Permutation
from csgn_tpu.secret_key import SecretKey
from csgn_tpu.utils.metrics import op_metrics

__all__ = ["BatchExecutor", "ServeFuture"]


class ServeFuture:
    """Result placeholder; `result()` flushes the executor if still pending."""

    __slots__ = ("_executor", "_value", "_exc", "_ready")

    def __init__(self, executor: "BatchExecutor"):
        self._executor = executor
        self._value = None
        self._exc: BaseException | None = None
        self._ready = False

    @property
    def done(self) -> bool:
        return self._ready

    def _set(self, value) -> None:
        self._value, self._ready = value, True

    def _set_exception(self, exc: BaseException) -> None:
        self._exc, self._ready = exc, True

    def result(self):
        if not self._ready:
            self._executor.flush()
        if self._exc is not None:
            raise self._exc
        return self._value


def _stack(cts: list[Ciphertext]) -> CiphertextBatch:
    """Stack same-shape ciphertexts with one dispatch when tags allow.

    All-canonical (fresh or already-canonicalized) requests stack raw; mixed
    lazy tags fall back to `CiphertextBatch.stack`, which canonicalizes each
    element (a per-element gather — still correct, just not free).  Requests
    sharing ONE tag object (e.g. sliced from the same batch) keep it shared.
    """
    first = cts[0]
    if all(c.logical is None for c in cts):
        return CiphertextBatch(jnp.stack([c.wt for c in cts]), first.ctx)
    if all(c.logical is first.logical and c.pad == first.pad for c in cts):
        return CiphertextBatch(
            jnp.stack([c.wt for c in cts]), first.ctx, first.logical, first.pad
        )
    return CiphertextBatch.stack(cts)


class BatchExecutor:
    """Microbatching front-end over the batched CSGN kernels.

    Args:
      key: `SecretKey` used by encrypt / decrypt / mul_decrypt requests
        (pure ciphertext ops work without one).
      rng: base PRNG key for encrypt requests (default `jax.random.key(0)`);
        each flush derives a fresh subkey, so ciphertexts are reproducible
        given (rng, submission order).
      max_batch: a group reaching this many requests flushes immediately
        (bounds peak HBM for the stacked batch); None = unbounded.
      netlist_budget_bytes: materialization budget enforced by the
        `submit_netlist` route (default: `pipeline.default_budget_bytes()`,
        the budget mul_chain uses); pass None to disable, or another value.
        `submit_netlist_expr` never materializes and ignores this.
    """

    def __init__(
        self,
        key: SecretKey | None = None,
        *,
        rng: jax.Array | None = None,
        max_batch: int | None = 4096,
        netlist_budget_bytes: "int | None" = ...,  # ... = mul_chain's budget
    ):
        if netlist_budget_bytes is ...:
            from csgn_tpu.pipeline import default_budget_bytes

            netlist_budget_bytes = default_budget_bytes()
        self._key = key
        self._rng = rng if rng is not None else jax.random.key(0)
        self._max_batch = max_batch
        self._netlist_budget = netlist_budget_bytes
        self._groups: dict[tuple, list[tuple]] = {}
        self._enc_flushes = 0  # dedicated counter: encrypt randomness depends
        # only on how many encrypt groups ran, never on unrelated op groups.
        self._net_flushes = 0  # same discipline for netlist NOT-constants.
        # (the expr route needs no NOT-constant: it evaluates key-side on
        # decrypted bits, INV is a plain bit flip)
        self.stats = {"requests": 0, "flushes": 0, "group_dispatches": 0}

    # -- submission -------------------------------------------------------------

    def _need_key(self, what: str) -> SecretKey:
        if self._key is None:
            raise ValueError(f"{what} requests need a BatchExecutor(key=...)")
        return self._key

    def _enqueue(self, group_key: tuple, payload: tuple) -> ServeFuture:
        fut = ServeFuture(self)
        pending = self._groups.setdefault(group_key, [])
        pending.append((payload, fut))
        self.stats["requests"] += 1
        if self._max_batch is not None and len(pending) >= self._max_batch:
            self._flush_group(group_key)
        return fut

    def _check_ct(self, ct: Ciphertext, what: str) -> None:
        if not isinstance(ct, Ciphertext):
            raise TypeError(f"{what} expects Ciphertext, got {type(ct).__name__}")
        if self._key is not None and ct.ctx != self._key.ctx:
            raise ValueError(f"{what}: ciphertext context differs from the key's")

    def submit_encrypt(self, bit: int) -> ServeFuture:
        """Encrypt one bit; B queued encrypts become one `encrypt_batch`."""
        self._need_key("encrypt")
        return self._enqueue(("enc",), (int(bit) & 1,))

    def submit_add(self, a: Ciphertext, b: Ciphertext) -> ServeFuture:
        self._check_ct(a, "add"), self._check_ct(b, "add")
        if a.ctx != b.ctx:
            raise ValueError("add: operand context mismatch")
        return self._enqueue(("add", a.ctx, a.chunks, b.chunks), (a, b))

    def submit_mul(self, a: Ciphertext, b: Ciphertext) -> ServeFuture:
        self._check_ct(a, "mul"), self._check_ct(b, "mul")
        if a.ctx != b.ctx:
            raise ValueError("mul: operand context mismatch")
        return self._enqueue(("mul", a.ctx, a.chunks, b.chunks), (a, b))

    def submit_decrypt(self, ct: Ciphertext) -> ServeFuture:
        """Decrypt; resolves to an int bit."""
        self._need_key("decrypt")
        self._check_ct(ct, "decrypt")
        return self._enqueue(("dec", ct.ctx, ct.chunks), (ct,))

    def submit_mul_decrypt(self, a: Ciphertext, b: Ciphertext) -> ServeFuture:
        """Fused multiply+decrypt; resolves to ``(product, bit)``."""
        self._need_key("mul_decrypt")
        self._check_ct(a, "mul_decrypt"), self._check_ct(b, "mul_decrypt")
        if a.ctx != b.ctx:
            raise ValueError("mul_decrypt: operand context mismatch")
        return self._enqueue(("muldec", a.ctx, a.chunks, b.chunks), (a, b))

    def submit_netlist(self, netlist, inputs) -> ServeFuture:
        """Evaluate a Bristol netlist over one request's encrypted inputs;
        resolves to the nested output list (``list[list[Ciphertext]]``).

        B queued same-circuit requests (same netlist, context, and per-wire
        chunk shapes) run as ONE batched evaluation: each input wire stacks
        across requests into a `CiphertextBatch` and every gate is one
        batched dispatch for the whole fleet
        (`models.netlist.eval_homomorphic_batch`), so the flush costs
        O(gates) dispatches instead of O(B * gates).  Requires a key (the
        NOT-constant is an encryption of 1 derived from the executor rng on
        a stream independent of `submit_encrypt`'s).
        """
        return self._submit_netlist_common("net", "netlist", netlist, inputs)

    def _submit_netlist_common(self, kind: str, label: str, netlist, inputs) -> ServeFuture:
        """Shared validation + enqueue for both netlist routes (materialized
        `submit_netlist` and expr-route `submit_netlist_expr`)."""
        from csgn_tpu.models.netlist import Netlist, _flatten_inputs

        self._need_key(label)
        if not isinstance(netlist, Netlist):
            raise TypeError(f"expected Netlist, got {type(netlist).__name__}")
        inputs = tuple(tuple(v) for v in inputs)
        flat = _flatten_inputs(netlist, inputs)
        for ct in flat:
            self._check_ct(ct, label)
        shapes = tuple(ct.chunks for ct in flat)
        return self._enqueue((kind, netlist, self._key.ctx, shapes), (netlist, inputs))

    def submit_netlist_expr(self, netlist, inputs) -> ServeFuture:
        """Evaluate a netlist growth-free and decrypt its outputs; resolves
        to the nested BIT list (``list[list[int]]``, mirroring
        ``output_sizes``).

        The fleet route for DEEP circuits (AES-128 / SHA-256 class, where
        `submit_netlist` would materialize superlinear chunk growth): B
        queued same-circuit requests stack each input wire into a
        `CiphertextBatch`, ONE `CtExpr` DAG serves the whole group, the
        distinct leaves decrypt in a handful of batched dispatches, and one
        vectorized fold reads out every request's bits.  Key-side by
        necessity — the results are decrypted bits, not ciphertexts.
        """
        return self._submit_netlist_common("netexpr", "netlist_expr", netlist, inputs)

    def submit_decrypt_circuit(self, expr) -> ServeFuture:
        """Decrypt a +/* DAG (`CtExpr` or Ciphertext); resolves to an int bit
        (or a uint8[B] array when the DAG has `CiphertextBatch` fleet leaves).

        All pending circuit requests flush as ONE `SecretKey.decrypt_circuits`
        call: distinct leaves across every submitted DAG decrypt in one
        batched dispatch per leaf shape, then each DAG folds host-side — a
        fleet of expr readouts (e.g. the auction pattern in
        examples/netlist_service.py) costs a handful of dispatches total.
        """
        from csgn_tpu.circuit import CtExpr

        sk = self._need_key("decrypt_circuit")
        if isinstance(expr, Ciphertext):
            self._check_ct(expr, "decrypt_circuit")
        elif isinstance(expr, CtExpr):
            # O(depth) spot check only: walking every leaf here would cost
            # O(gates) per submitted output (128 AES outputs share a ~229k-node
            # interior).  Full leaf validation happens once per flush inside
            # SecretKey.decrypt_circuits.
            if expr._any_leaf().ctx != sk.ctx:
                raise ValueError(
                    "decrypt_circuit: leaf context differs from the key's"
                )
        else:
            raise TypeError(
                f"decrypt_circuit expects CtExpr or Ciphertext, got {type(expr).__name__}"
            )
        return self._enqueue(("deccirc", sk.ctx), (expr,))

    def submit_permute(self, ct: Ciphertext, perm: Permutation) -> ServeFuture:
        """Apply a per-request permutation; B requests run the batched
        stacked-plan Beneš kernel (one dispatch for the whole fleet)."""
        self._check_ct(ct, "permute")
        if perm.n != ct.ctx.n:
            raise ValueError(f"permutation length {perm.n} != context n {ct.ctx.n}")
        return self._enqueue(("perm", ct.ctx, ct.chunks), (ct, perm))

    # -- execution ----------------------------------------------------------------

    def pending(self) -> int:
        return sum(len(v) for v in self._groups.values())

    def flush(self) -> None:
        """Execute every pending group (one batched dispatch per group)."""
        if not self._groups:
            return
        self.stats["flushes"] += 1
        for group_key in list(self._groups):
            self._flush_group(group_key)

    def _flush_group(self, group_key: tuple) -> None:
        pending = self._groups.pop(group_key, [])
        if not pending:
            return
        payloads = [p for p, _ in pending]
        futures = [f for _, f in pending]
        self.stats["group_dispatches"] += 1
        runner: Callable = getattr(self, f"_run_{group_key[0]}")
        try:
            with op_metrics().record(
                f"serve.{group_key[0]}", chunks_in=len(pending)
            ):
                results = runner(payloads)
        except Exception as exc:  # noqa: BLE001 — delivered via futures
            for f in futures:
                f._set_exception(exc)
            return
        for f, r in zip(futures, results):
            f._set(r)

    # Per-kind batched runners: each is ONE batched device computation.

    def _run_enc(self, payloads: list[tuple]) -> list[Ciphertext]:
        sk = self._need_key("encrypt")
        bits = jnp.array([p[0] for p in payloads], dtype=jnp.uint8)
        subkey = jax.random.fold_in(self._rng, self._enc_flushes)
        self._enc_flushes += 1
        words = sk.encrypt_batch(bits, subkey)  # [W, B]
        batch = CiphertextBatch.from_fresh(words, sk.ctx)
        return [batch[i] for i in range(len(payloads))]

    def _run_add(self, payloads: list[tuple]) -> list[Ciphertext]:
        ca = _stack([a for a, _ in payloads])
        cb = _stack([b for _, b in payloads])
        out = ca + cb
        return [out[i] for i in range(len(payloads))]

    def _run_mul(self, payloads: list[tuple]) -> list[Ciphertext]:
        ca = _stack([a for a, _ in payloads])
        cb = _stack([b for _, b in payloads])
        out = ca * cb
        return [out[i] for i in range(len(payloads))]

    def _run_dec(self, payloads: list[tuple]) -> list[int]:
        sk = self._need_key("decrypt")
        batch = _stack([p[0] for p in payloads])
        bits = sk.decrypt_batch(batch)
        return [int(b) for b in jax.device_get(bits)]

    def _run_muldec(self, payloads: list[tuple]) -> list[tuple[Ciphertext, int]]:
        sk = self._need_key("mul_decrypt")
        ca = _stack([a for a, _ in payloads])
        cb = _stack([b for _, b in payloads])
        out, bits = sk.mul_and_decrypt_batch(ca, cb)
        host_bits = jax.device_get(bits)
        return [(out[i], int(host_bits[i])) for i in range(len(payloads))]

    def _netlist_flush_setup(self, payloads: list[tuple], tag: int, counter: str):
        """Shared per-flush setup for both netlist runners: one public
        encryption of 1 on a stream tagged away from submit_encrypt's
        (reproducible; see class doc), plus each input wire stacked across
        the group's requests."""
        sk = self._need_key("netlist")
        one_rng = jax.random.fold_in(
            jax.random.fold_in(self._rng, tag), getattr(self, counter)
        )
        setattr(self, counter, getattr(self, counter) + 1)
        return sk, sk.encrypt(1, one_rng), self._stack_wires(payloads)

    @staticmethod
    def _stack_wires(payloads: list[tuple]) -> list[list[CiphertextBatch]]:
        """Stack each input wire across the group's requests (both netlist
        runners share this shape)."""
        return [
            [
                _stack([p[1][v][j] for p in payloads])
                for j in range(len(payloads[0][1][v]))
            ]
            for v in range(len(payloads[0][1]))
        ]

    def _run_net(self, payloads: list[tuple]) -> list[list[list[Ciphertext]]]:
        from csgn_tpu.models.netlist import eval_homomorphic_batch

        netlist = payloads[0][0]  # group key pins one netlist per group
        sk, one, stacked = self._netlist_flush_setup(payloads, 0x6E65, "_net_flushes")
        # Deep circuits explode materialized growth: reject before the first
        # superlinear multiply allocates, pointing at submit_netlist_expr.
        # Knob: BatchExecutor(netlist_budget_bytes=...).
        out_batches = eval_homomorphic_batch(
            netlist, stacked, one, budget_bytes=self._netlist_budget
        )
        return [
            [[cb[i] for cb in value] for value in out_batches]
            for i in range(len(payloads))
        ]

    def _run_netexpr(self, payloads: list[tuple]) -> list[list[list[int]]]:
        """Key-side fleet readout: decrypting a netlist's expr DAG folds to
        plain evaluation over the decrypted input bits (Dec is a ring
        homomorphism), so this route skips building the 10^5-node DAG a
        published-size circuit would need — decrypt every input wire batch
        (grouped into one dispatch per chunk shape), then run the circuit
        once on packed bit-masks (`eval_plain_packed`, one int op per gate
        for the whole group).  Bit-exact to the eval_expr + decrypt_circuits
        path (tests/test_serve.py)."""
        from csgn_tpu.circuit import unpack_fleet_bits
        from csgn_tpu.models.netlist import eval_plain_packed

        sk = self._need_key("netlist_expr")
        netlist = payloads[0][0]  # group key pins one netlist per group
        b = len(payloads)
        # Stack each input wire across the group's requests, then decrypt
        # all same-shape wires in one batched dispatch each.
        stacked = self._stack_wires(payloads)
        packed = sk.decrypt_batches_packed(
            [cb for value in stacked for cb in value]
        )
        it = iter(packed)
        packed_inputs = [[next(it) for _ in value] for value in stacked]
        outs = eval_plain_packed(netlist, packed_inputs, b)
        out_vecs = [[unpack_fleet_bits(v, b) for v in value] for value in outs]
        return [
            [[int(vec[i]) for vec in value] for value in out_vecs]
            for i in range(b)
        ]

    def _run_deccirc(self, payloads: list[tuple]) -> "list[int | object]":
        sk = self._need_key("decrypt_circuit")
        # Fleet DAGs (CiphertextBatch leaves) resolve to uint8[B] arrays;
        # scalar DAGs to int bits.
        out = []
        for v in sk.decrypt_circuits([p[0] for p in payloads]):
            out.append(v if hasattr(v, "shape") else int(v))
        return out

    def _run_perm(self, payloads: list[tuple]) -> list[Ciphertext]:
        batch = _stack([ct for ct, _ in payloads])
        out = batch.apply_permutations([perm for _, perm in payloads])
        return [out[i] for i in range(len(payloads))]

    def __repr__(self) -> str:
        return (
            f"BatchExecutor(pending={self.pending()}, "
            f"requests={self.stats['requests']}, "
            f"group_dispatches={self.stats['group_dispatches']})"
        )
