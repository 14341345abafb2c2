"""Compositional circuit decrypt: Dec folds through +/* DAGs without
materializing products (reference semantics anchor src/SecretKey.cpp:126-146)."""

import jax
import numpy as np
import pytest

from csgn_tpu import Permutation, SecretKey, lift
from csgn_tpu.circuit import CtExpr


@pytest.fixture
def setup(small_ctx, rng):
    sk = SecretKey.generate(small_ctx, rng)
    def enc(bit, i):
        return sk.encrypt(bit, jax.random.fold_in(rng, i))
    return sk, enc


def test_expr_matches_materialized(setup):
    sk, enc = setup
    a, b, c = enc(1, 1), enc(0, 2), enc(1, 3)
    e = (lift(a) + b) * c + a * c
    m = e.materialize()
    assert m.chunks == e.chunks == (1 + 1) * 1 + 1 * 1
    assert int(sk.decrypt_circuit(e)) == int(sk.decrypt(m))
    assert int(sk.decrypt_circuit(e)) == ((1 ^ 0) & 1) ^ (1 & 1)


def test_shared_subexpression_decrypts_each_leaf_once(setup, monkeypatch):
    sk, enc = setup
    a, b = enc(1, 1), enc(1, 2)
    shared = lift(a) * b
    e = (shared + a) * (shared + b)   # true DAG: `shared` and leaves reused
    calls = []
    orig = SecretKey.decrypt
    monkeypatch.setattr(SecretKey, "decrypt", lambda self, ct: calls.append(id(ct)) or orig(self, ct))
    bit = int(sk.decrypt_circuit(e))
    assert len(calls) == 2                      # one decrypt per distinct leaf
    assert bit == int(sk.decrypt(e.materialize()))


def test_fold_many_overlapping_roots(setup):
    """The shared visited/memo state across roots must survive duplicate
    roots, a root that is a subexpression of an earlier root, and reversed
    processing order — every combination equals the per-root fold."""
    from csgn_tpu.circuit import collect_leaves, fold_many

    sk, enc = setup
    a, b, c = enc(1, 1), enc(1, 2), enc(0, 3)
    inner = lift(a) * b            # subexpression shared by both roots
    outer = (inner + c) * inner
    for roots in ([outer, inner], [inner, outer], [outer, outer, inner, outer]):
        got = fold_many(roots, lambda ct: int(sk.decrypt(ct)))
        assert got == [int(sk.decrypt_circuit(e)) for e in roots], roots
        leaves = collect_leaves(roots)
        assert len(leaves) == len({id(ct) for ct in leaves})
        assert {id(ct) for ct in leaves} == {id(a), id(b)} | (
            {id(c)} if outer in roots else set()
        )
    assert int(sk.decrypt_circuit(outer)) == ((1 & 1) ^ 0) & (1 & 1)


def test_batch_leaf_dags(setup, small_ctx, rng):
    """CiphertextBatch leaves: one DAG folds the whole fleet; mixed
    batch × scalar leaves broadcast; two same-shape fleets share one
    grouped decrypt dispatch and match elementwise scalar folds."""
    import numpy as np

    from csgn_tpu.batch import CiphertextBatch

    sk, enc = setup
    bits_a, bits_b = [1, 0, 1, 1], [1, 1, 0, 1]
    ca = [enc(b, 10 + i) for i, b in enumerate(bits_a)]
    cb = [enc(b, 20 + i) for i, b in enumerate(bits_b)]
    A, B_ = CiphertextBatch.stack(ca), CiphertextBatch.stack(cb)
    one = enc(1, 30)
    e = (lift(A) + B_) * A + (lift(A) * one)      # scalar leaf mixes in
    got = sk.decrypt_circuit(e)
    assert isinstance(got, np.ndarray)
    expect = [((a ^ b) & a) ^ (a & 1) for a, b in zip(bits_a, bits_b)]
    assert got.tolist() == expect
    # element-wise scalar DAGs agree
    for i in range(4):
        es = (lift(ca[i]) + cb[i]) * ca[i] + (lift(ca[i]) * one)
        assert int(sk.decrypt_circuit(es)) == expect[i]
    # decrypt_circuits over mixed scalar/batch roots
    outs = sk.decrypt_circuits([e, lift(one), lift(A) + B_])
    assert np.array_equal(outs[0], got) and int(outs[1]) == 1
    assert outs[2].tolist() == [a ^ b for a, b in zip(bits_a, bits_b)]


def test_batch_leaf_permutation_pushdown(setup, small_ctx, rng):
    """apply_permutation on a fleet DAG maps CiphertextBatch leaves and
    preserves fleet semantics: Dec_perm-key(perm(DAG)) == Dec(DAG)."""
    from csgn_tpu import Permutation
    from csgn_tpu.batch import CiphertextBatch

    sk, enc = setup
    A = CiphertextBatch.stack([enc(b, 130 + i) for i, b in enumerate([1, 0, 1])])
    Bb = CiphertextBatch.stack([enc(b, 140 + i) for i, b in enumerate([1, 1, 0])])
    e = lift(A) * Bb + A
    p = Permutation.random(small_ctx, jax.random.fold_in(rng, 99))
    pe = e.apply_permutation(p)
    assert pe.batch == 3
    psk = sk.apply_permutation(p)
    assert psk.decrypt_circuit(pe).tolist() == sk.decrypt_circuit(e).tolist()


def test_pack_unpack_fleet_bits_roundtrip():
    import numpy as np

    from csgn_tpu.circuit import pack_fleet_bits, unpack_fleet_bits

    rng = np.random.default_rng(5)
    for b in (1, 7, 8, 64, 65, 200):
        bits = rng.integers(0, 2, b).astype(np.uint8)
        v = pack_fleet_bits(bits)
        assert v == sum(int(x) << i for i, x in enumerate(bits))
        assert np.array_equal(unpack_fleet_bits(v, b), bits), b
    assert pack_fleet_bits([1, 0, 1]) == 0b101
    assert unpack_fleet_bits(0, 3).tolist() == [0, 0, 0]


def test_fleet_fold_large_batch(setup):
    """B=70 (crosses the 64-bit boundary of the packed representation):
    fleet fold equals per-instance scalar folds."""
    from csgn_tpu.batch import CiphertextBatch

    sk, enc = setup
    B = 70
    bits_a = [(i * 7 + 3) % 2 for i in range(B)]
    bits_b = [(i * 5 + 1) % 2 for i in range(B)]
    ca = [enc(b, 700 + i) for i, b in enumerate(bits_a)]
    cb = [enc(b, 800 + i) for i, b in enumerate(bits_b)]
    A, Bb = CiphertextBatch.stack(ca), CiphertextBatch.stack(cb)
    one = enc(1, 900)
    e = (lift(A) + Bb) * A + one * lift(Bb)
    got = sk.decrypt_circuit(e)
    expect = [((a ^ b) & a) ^ (1 & b) for a, b in zip(bits_a, bits_b)]
    assert got.tolist() == expect


def test_fleet_dag_guards(setup):
    """Mismatched fleet sizes fail at CONSTRUCTION (incl. the silent B=1
    broadcast trap); mixed scalar/batch DAGs refuse to materialize with an
    explaining message; nbytes accounts for the fleet size."""
    import pytest as _p

    from csgn_tpu.batch import CiphertextBatch

    sk, enc = setup
    b3 = CiphertextBatch.stack([enc(1, 40 + i) for i in range(3)])
    b2 = CiphertextBatch.stack([enc(1, 50 + i) for i in range(2)])
    b1 = CiphertextBatch.stack([enc(1, 60)])
    with _p.raises(ValueError, match="fleet batch mismatch"):
        lift(b3) + b2
    with _p.raises(ValueError, match="fleet batch mismatch"):
        lift(b1) * b3  # B=1 must NOT silently broadcast across the fleet
    e = lift(b3) * b3
    assert e.batch == 3
    assert e.nbytes_materialized == 3 * e._any_leaf().ctx.chunk_count_bytes(1)
    mixed = e + enc(1, 70)  # scalar constant broadcasts in folds...
    assert sk.decrypt_circuit(mixed).shape == (3,)
    with _p.raises(ValueError, match="fold-only|cannot materialize"):
        mixed.materialize()  # ...but has no materialized form
    # all-batch DAGs still materialize to a CiphertextBatch
    m = e.materialize()
    assert isinstance(m, CiphertextBatch) and m.batch == 3


def test_deep_chain_beyond_hbm(setup):
    """32-deep multiply chain of 2-chunk inputs: materialized = 2^32 chunks
    (64 GiB); the circuit decrypts from 64 fresh leaf chunks."""
    sk, enc = setup
    cts = [enc(1, i) + enc(0, 100 + i) for i in range(32)]   # 2 chunks each
    e = lift(cts[0])
    for ct in cts[1:]:
        e = e * ct
    assert e.chunks == 2 ** 32
    assert e.nbytes_materialized >= 64 * 2 ** 30  # 64 GiB at 16 B per chunk
    assert int(sk.decrypt_circuit(e)) == 1
    e0 = e * (enc(0, 999) + enc(1, 998) + enc(1, 997))  # xor in a 0 -> product 0... parity(0^1^1)=0
    assert int(sk.decrypt_circuit(e0)) == 0


def test_permutation_pushes_to_leaves(setup, small_ctx, rng):
    sk, enc = setup
    p = Permutation.random(small_ctx, jax.random.fold_in(rng, 7))
    a, b = enc(1, 1), enc(1, 2)
    e = (lift(a) * b + a).apply_permutation(p)
    psk = sk.apply_permutation(p)
    want = int(sk.decrypt((a * b + a)))
    assert int(psk.decrypt_circuit(e)) == want
    assert int(psk.decrypt(e.materialize())) == want


def test_decrypt_circuit_accepts_plain_ciphertext(setup):
    sk, enc = setup
    c = enc(1, 1)
    assert int(sk.decrypt_circuit(c)) == 1


def test_lift_rejects_non_ciphertext():
    with pytest.raises(TypeError):
        lift(3)


def test_fuzz_random_dags_vs_materialized(small_ctx, rng):
    """Random +/* DAGs with node sharing: circuit decrypt == materialized
    decrypt == plaintext circuit (differential fuzz, SURVEY §4c)."""
    sk = SecretKey.generate(small_ctx, rng)
    py_rng = np.random.default_rng(42)
    for trial in range(12):
        nodes: list[tuple[CtExpr, int]] = []
        for i in range(4):
            bit = int(py_rng.integers(0, 2))
            ct = sk.encrypt(bit, jax.random.fold_in(rng, 1000 * trial + i))
            nodes.append((lift(ct), bit))
        for i in range(8):
            (ea, pa), (eb, pb) = (nodes[py_rng.integers(0, len(nodes))] for _ in range(2))
            if py_rng.integers(0, 2) or ea.chunks * eb.chunks > 4096:
                nodes.append((ea + eb, pa ^ pb))
            else:
                nodes.append((ea * eb, pa & pb))
        expr, want = nodes[-1]
        got = int(sk.decrypt_circuit(expr))
        assert got == want, f"trial {trial}: circuit {got} != plaintext {want}"
        if expr.chunks <= 4096:
            assert got == int(sk.decrypt(expr.materialize()))


def test_decrypt_circuits_batched_leaves(setup, rng):
    """decrypt_circuits == per-expr decrypt_circuit, with ONE batched leaf
    decrypt per distinct leaf shape (not one per leaf per output)."""
    import jax

    from csgn_tpu.models.netlist import adder, eval_expr

    sk, _enc = setup
    key = jax.random.fold_in(rng, 777)
    width = 6
    nl = adder(width)
    ks = jax.random.split(key, 2 * width + 1)
    x, y = 41, 27
    a = [sk.encrypt((x >> i) & 1, ks[i]) for i in range(width)]
    b = [sk.encrypt((y >> i) & 1, ks[width + i]) for i in range(width)]
    # grow one leaf to 2 chunks so two shape groups exist
    a[0] = a[0] + sk.encrypt(0, ks[-1])
    one = sk.encrypt(1, jax.random.key(999))
    (outs,) = eval_expr(nl, [a, b], one)

    calls = []
    orig = type(sk).decrypt_batch

    def spy(self, words):
        calls.append(1)
        return orig(self, words)

    type(sk).decrypt_batch = spy
    try:
        got = [int(v) for v in sk.decrypt_circuits(outs)]
    finally:
        type(sk).decrypt_batch = orig
    # 13 leaves in 2 shape groups -> exactly 2 batched decrypts for 7 outputs
    assert len(calls) == 2
    want = [int(sk.decrypt_circuit(e)) for e in outs]
    assert got == want
    s = sum(bit << i for i, bit in enumerate(got))
    assert s == x + y

    import pytest as _pytest

    from csgn_tpu.context import Context
    from csgn_tpu.secret_key import SecretKey

    other = SecretKey.generate(Context(sk.ctx.n + 2, sk.ctx.d), jax.random.key(1))
    with _pytest.raises(ValueError, match="context mismatch"):
        other.decrypt_circuits(outs)
