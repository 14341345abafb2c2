"""Lazy chunk-order tags: composition through ops, canonicalization, interop.

The tests force the j-major (and zero-padded j-major) multiply layouts that
the tags describe; every result must canonicalize to the reference-order
oracle bit-exactly."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import csgn_tpu.ciphertext as ciphertext_mod
from csgn_tpu.ciphertext import Ciphertext, set_eager_order
from csgn_tpu.ops import core, dispatch, order
from csgn_tpu.secret_key import SecretKey


def _rand_ct(rng, chunks, ctx):
    w = rng.integers(0, 2**32, size=(ctx.words32, chunks), dtype=np.uint32)
    return Ciphertext(jnp.asarray(w & ctx.valid_mask[:, None]), ctx)


@pytest.fixture
def jmajor_mul(monkeypatch):
    """Force Ciphertext.__mul__ onto the j-major physical order path."""

    def auto(a, b):
        return dispatch.mul_chunks_jmajor(a, b), True, 0, 0

    monkeypatch.setattr(dispatch, "mul_chunks_auto", auto)
    # ciphertext.py imported `dispatch` as a module, so the patch is seen.
    yield


def padded_jmajor(a, b, align=16):
    """A zero-padded j-major product: a's chunk axis padded with all-zero
    chunks up to a multiple of `align`, then swapped-operand canonical
    product — the layout a route that aligns its streamed operand emits."""
    t1 = a.shape[-1]
    zp = -t1 % align
    ap = jnp.pad(a, [(0, 0)] * (a.ndim - 1) + [(0, zp)])
    return core.mul_chunks(b, ap), True, zp, 0


@pytest.fixture
def ragged_mul(monkeypatch):
    """Force Ciphertext.__mul__ onto a zero-padded j-major path."""

    def auto(a, b):
        return padded_jmajor(a, b)

    monkeypatch.setattr(dispatch, "mul_chunks_auto", auto)
    yield


def test_jmajor_oracle_equivalence(ctx):
    rng = np.random.default_rng(0)
    a, b = _rand_ct(rng, 5, ctx), _rand_ct(rng, 3, ctx)
    jm = dispatch.mul_chunks_jmajor(a.wt, b.wt)
    want = core.mul_chunks(a.wt, b.wt)
    tag = order.cross_logical(None, None, 5, 3, jmajor=True)
    np.testing.assert_array_equal(
        np.asarray(order.canonicalize(jm, tag)), np.asarray(want)
    )


def test_mul_lazy_tag_canonicalizes(ctx, jmajor_mul):
    rng = np.random.default_rng(1)
    a, b = _rand_ct(rng, 4, ctx), _rand_ct(rng, 7, ctx)
    prod = a * b
    assert not prod.is_canonical
    want = core.mul_chunks(a.wt, b.wt)
    np.testing.assert_array_equal(np.asarray(prod.canonical().wt), np.asarray(want))
    # interop paths canonicalize implicitly
    np.testing.assert_array_equal(prod.chunk_major(), np.asarray(want).T)


def test_tags_compose_through_random_circuits(ctx, jmajor_mul):
    """(a*b + c) * d ... with lazy tags == same circuit on canonical oracles."""
    rng = np.random.default_rng(2)
    cts = [_rand_ct(rng, int(c), ctx) for c in rng.integers(1, 5, size=6)]

    def oracle(x, y, op):
        return core.add_chunks(x, y) if op == "+" else core.mul_chunks(x, y)

    got, want = cts[0], cts[0].wt
    for i, ct in enumerate(cts[1:]):
        op = "+" if i % 2 == 0 else "*"
        got = got + ct if op == "+" else got * ct
        want = oracle(want, ct.wt, op)
    np.testing.assert_array_equal(np.asarray(got.canonical().wt), np.asarray(want))


def test_decrypt_ignores_order(ctx, jmajor_mul):
    keys = jax.random.split(jax.random.key(3), 8)
    sk = SecretKey.generate(ctx, keys[0])
    bits = [1, 0, 1, 1]
    cts = [sk.encrypt(b, k) for b, k in zip(bits, keys[1:])]
    expr = (cts[0] + cts[1]) * cts[2] + cts[3]
    want = ((bits[0] ^ bits[1]) & bits[2]) ^ bits[3]
    assert sk.decrypt(expr) == want
    assert sk.decrypt(expr.canonical()) == want


def test_add_of_tagged_operands(ctx, jmajor_mul):
    rng = np.random.default_rng(4)
    a, b, c = (_rand_ct(rng, k, ctx) for k in (3, 2, 4))
    s = (a * b) + c
    assert not s.is_canonical
    want = core.add_chunks(core.mul_chunks(a.wt, b.wt), c.wt)
    np.testing.assert_array_equal(np.asarray(s.canonical().wt), np.asarray(want))


def test_permutation_preserves_tag(ctx, jmajor_mul):
    from csgn_tpu.permutation import Permutation

    rng = np.random.default_rng(5)
    a, b = _rand_ct(rng, 2, ctx), _rand_ct(rng, 3, ctx)
    p = Permutation.random(ctx, jax.random.key(6))
    prod = a * b
    permuted = prod.apply_permutation(p)
    assert permuted.is_canonical == prod.is_canonical
    want = core.permute_chunks(core.mul_chunks(a.wt, b.wt), jnp.asarray(p.perm), ctx.n)
    np.testing.assert_array_equal(np.asarray(permuted.canonical().wt), np.asarray(want))


def test_eager_order_mode(ctx, jmajor_mul):
    rng = np.random.default_rng(7)
    a, b = _rand_ct(rng, 4, ctx), _rand_ct(rng, 3, ctx)
    prev = set_eager_order(True)
    try:
        prod = a * b
        assert prod.is_canonical
        np.testing.assert_array_equal(
            np.asarray(prod.wt), np.asarray(core.mul_chunks(a.wt, b.wt))
        )
    finally:
        set_eager_order(prev)


def test_inverse_permutation_roundtrip():
    rng = np.random.default_rng(8)
    perm = jnp.asarray(rng.permutation(257).astype(np.int32))
    inv = order.inverse_permutation(perm)
    np.testing.assert_array_equal(np.asarray(perm)[np.asarray(inv)], np.arange(257))


def test_pad_chunks_compose_and_canonicalize(ctx, ragged_mul):
    rng = np.random.default_rng(11)
    a, b = _rand_ct(rng, 37, ctx), _rand_ct(rng, 3, ctx)
    prod = a * b
    assert prod.chunks == 37 * 3
    assert prod.pad == prod.physical_chunks - 37 * 3 > 0
    want = core.mul_chunks(a.wt, b.wt)
    np.testing.assert_array_equal(np.asarray(prod.canonical().wt), np.asarray(want))
    # pads survive an add and still canonicalize away
    c = _rand_ct(rng, 5, ctx)
    s = prod + c
    assert s.pad == prod.pad and s.chunks == 37 * 3 + 5
    want_s = core.add_chunks(want, c.wt)
    np.testing.assert_array_equal(np.asarray(s.canonical().wt), np.asarray(want_s))
    # and survive being an operand of a further (j-major) multiply
    d = _rand_ct(rng, 2, ctx)
    p2 = s * d
    assert p2.chunks == s.chunks * 2
    want_p2 = core.mul_chunks(want_s, d.wt)
    np.testing.assert_array_equal(np.asarray(p2.canonical().wt), np.asarray(want_p2))


def test_pad_decrypt_neutral_and_serialization(ctx, ragged_mul):
    keys = jax.random.split(jax.random.key(12), 8)
    sk = SecretKey.generate(ctx, keys[0])
    bits = [1, 1, 0, 1]
    cts = [sk.encrypt(b, k) for b, k in zip(bits, keys[1:])]
    expr = ((cts[0] + cts[1] + cts[2]) * cts[3]) * cts[1]
    assert expr.pad > 0
    want = ((bits[0] ^ bits[1] ^ bits[2]) & bits[3]) & bits[1]
    assert sk.decrypt(expr) == want
    # serialization drops pads and matches the eager (pad-free) bytes
    prev = set_eager_order(True)
    try:
        eager = ((cts[0] + cts[1] + cts[2]) * cts[3]) * cts[1]
        assert eager.pad == 0 and eager.is_canonical
    finally:
        set_eager_order(prev)
    np.testing.assert_array_equal(expr.to_u64(), eager.to_u64())


def test_pad_requires_tag(ctx):
    rng = np.random.default_rng(13)
    ct = _rand_ct(rng, 4, ctx)
    with pytest.raises(ValueError, match="order tag"):
        Ciphertext(ct.wt, ctx, None, 1)


def test_canonicalize_drops_pads():
    rng = np.random.default_rng(14)
    words = jnp.asarray(rng.integers(0, 2**32, size=(4, 7), dtype=np.uint32))
    # physical: [real2, pad, real0, pad, real1, real3, pad]
    tag = jnp.asarray(np.array([2, -1, 0, -1, 1, 3, -1], np.int32))
    got = np.asarray(order.canonicalize(words, tag, 4))
    want = np.asarray(words)[:, [2, 4, 0, 5]]
    np.testing.assert_array_equal(got, want)


def test_ciphertext_pytree_with_tag(ctx, jmajor_mul):
    rng = np.random.default_rng(9)
    a, b = _rand_ct(rng, 2, ctx), _rand_ct(rng, 2, ctx)
    prod = a * b
    leaves, treedef = jax.tree_util.tree_flatten(prod)
    assert len(leaves) == 2  # payload + tag
    back = jax.tree_util.tree_unflatten(treedef, leaves)
    np.testing.assert_array_equal(np.asarray(back.wt), np.asarray(prod.wt))
