"""Fused multiply+decrypt over the FULL dispatch envelope.

The reference pipeline (multiply src/Ciphertext.cpp:153-163 then decrypt
src/SecretKey.cpp:104-147) serves every chunk count through one code path;
`ops.dispatch.mul_decrypt_auto` must too.  The fused form takes the parity
from the operands' match counts, so it is checked against the staged oracle
at ragged chunk counts and both word widths, and `SecretKey.mul_and_decrypt`
is checked on the tagged and padded layouts the order tags describe
(forced via monkeypatch).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from csgn_tpu.ciphertext import Ciphertext, set_eager_order
from csgn_tpu.context import Context
from csgn_tpu.ops import core, dispatch, order
from csgn_tpu.secret_key import SecretKey


def _rand_wc(rng, chunks, ctx):
    w = rng.integers(0, 2**32, size=(ctx.words32, chunks), dtype=np.uint32)
    return jnp.asarray(w & ctx.valid_mask[:, None])


def _with_matches(rng, ctx, words, mask, n_force):
    """OR the mask into n_force random columns so the parity is non-trivial."""
    w_np = np.asarray(words).copy()
    if n_force:
        cols = rng.choice(w_np.shape[1], size=n_force, replace=False)
        w_np[:, cols] |= np.asarray(mask)[:, None]
    return jnp.asarray(w_np)


@pytest.fixture
def sk(ctx):
    return SecretKey.generate(ctx, jax.random.key(99))


# -- fused identity at ragged shapes, W=40 and W=128 ---------------------------


@pytest.mark.parametrize("n,d", [(1247, 16), (4095, 32)], ids=["W40", "W128"])
@pytest.mark.parametrize(
    "t1,t2,fa,fb", [(3, 1100, 1, 7), (2, 2048, 2, 4), (5, 1500, 3, 3), (3, 700, 2, 5),
                    (7, 333, 0, 3)],
)
def test_mul_decrypt_count_ragged(n, d, t1, t2, fa, fb):
    """Parity and raw count from the operands == the staged oracle over the
    materialized product, at chunk counts that are not powers of two."""
    ctx = Context(n, d)
    sk = SecretKey.generate(ctx, jax.random.key(n + t2))
    rng = np.random.default_rng(t1 * 10000 + t2)
    mask = jnp.asarray(sk.mask)
    a = _with_matches(rng, ctx, _rand_wc(rng, t1, ctx), mask, fa)
    b = _with_matches(rng, ctx, _rand_wc(rng, t2, ctx), mask, fb)
    want = core.mul_chunks(a, b)
    prod, parity = dispatch.mul_decrypt(a, b, mask)
    np.testing.assert_array_equal(np.asarray(prod), np.asarray(want))
    assert int(parity) == int(core.decrypt_parity(want, mask)) == (fa * fb) & 1
    _, count = dispatch.mul_decrypt_count(a, b, mask)
    assert int(count) == int(np.sum(np.asarray(core.chunk_matches(want, mask))))


# -- SecretKey.mul_and_decrypt across forced routes ---------------------------


def _route_jm_xla(a, b, mask):
    out = dispatch.mul_chunks_jmajor(a, b)
    return out, True, 0, 0, core.decrypt_parity(out, mask)


def _padded_jmajor(a, b, align=16):
    """Zero-pad a's chunk axis to a multiple of `align`, then j-major
    product: the layout of a route that aligns its streamed operand."""
    zp = -a.shape[-1] % align
    ap = jnp.pad(a, [(0, 0)] * (a.ndim - 1) + [(0, zp)])
    return core.mul_chunks(b, ap), zp


def _route_jm_ragged(a, b, mask):
    out, zp = _padded_jmajor(a, b)
    return out, True, zp, 0, core.decrypt_parity(out, mask)


@pytest.mark.parametrize(
    "route,t1,t2",
    [(_route_jm_ragged, 777, 2), (_route_jm_xla, 9, 4)],
    ids=["jm_ragged", "jm_xla"],
)
def test_mul_and_decrypt_forced_routes(ctx, sk, monkeypatch, route, t1, t2):
    """Every fused route: product canonicalizes to the oracle, parity matches,
    pad accounting is consistent (chunks excludes pads)."""
    monkeypatch.setattr(dispatch, "mul_decrypt_auto", route)
    rng = np.random.default_rng(t1 * 31 + t2)
    mask = jnp.asarray(sk.mask)
    ca = Ciphertext(_with_matches(rng, ctx, _rand_wc(rng, t1, ctx), mask, 3), ctx)
    cb = Ciphertext(_with_matches(rng, ctx, _rand_wc(rng, t2, ctx), mask, 2), ctx)

    prod, bit = sk.mul_and_decrypt(ca, cb)
    assert prod.chunks == t1 * t2
    want = core.mul_chunks(ca.wt, cb.wt)
    np.testing.assert_array_equal(prod.chunk_major().T, np.asarray(want))
    assert int(bit) == int(core.decrypt_parity(want, mask))


def test_mul_and_decrypt_tagged_padded_operands(ctx, sk, monkeypatch):
    """Fused auto on operands that ALREADY carry tags and pads (the chain
    shape class the round-3 dispatch silently degraded on)."""
    monkeypatch.setattr(dispatch, "mul_decrypt_auto", _route_jm_ragged)
    rng = np.random.default_rng(55)
    mask = jnp.asarray(sk.mask)
    base = Ciphertext(_with_matches(rng, ctx, _rand_wc(rng, 37, ctx), mask, 4), ctx)
    small = Ciphertext(_with_matches(rng, ctx, _rand_wc(rng, 3, ctx), mask, 1), ctx)

    # Build a padded, tag-carrying accumulator via a padded j-major route.
    def ragged_auto(a, b):
        out, zp = _padded_jmajor(a, b)
        return out, True, zp, 0

    monkeypatch.setattr(dispatch, "mul_chunks_auto", ragged_auto)
    acc = base * small
    assert acc.pad > 0 and not acc.is_canonical

    prod, bit = sk.mul_and_decrypt(acc, small)
    want = core.mul_chunks(core.mul_chunks(base.wt, small.wt), small.wt)
    np.testing.assert_array_equal(prod.chunk_major().T, np.asarray(want))
    assert int(bit) == int(core.decrypt_parity(want, mask))


def test_mul_and_decrypt_eager_order(ctx, sk):
    rng = np.random.default_rng(77)
    mask = jnp.asarray(sk.mask)
    ca = Ciphertext(_with_matches(rng, ctx, _rand_wc(rng, 5, ctx), mask, 2), ctx)
    cb = Ciphertext(_with_matches(rng, ctx, _rand_wc(rng, 3, ctx), mask, 2), ctx)
    prev = set_eager_order(True)
    try:
        prod, bit = sk.mul_and_decrypt(ca, cb)
        assert prod.is_canonical and prod.pad == 0
        want = core.mul_chunks(ca.wt, cb.wt)
        np.testing.assert_array_equal(np.asarray(prod.wt), np.asarray(want))
        assert int(bit) == int(core.decrypt_parity(want, mask))
    finally:
        set_eager_order(prev)


# -- batched fused auto --------------------------------------------------------


def _b_route_jm_ragged(a, b, mask):
    out, zp = _padded_jmajor(a, b)
    return out, True, zp, 0, core.decrypt_parity(out, mask)


def test_mul_and_decrypt_batch_forced_ragged(ctx, sk, monkeypatch):
    from csgn_tpu.batch import CiphertextBatch

    monkeypatch.setattr(dispatch, "mul_decrypt_batched_auto", _b_route_jm_ragged)
    rng = np.random.default_rng(88)
    mask = jnp.asarray(sk.mask)
    B, t1, t2 = 3, 70, 2
    a = np.stack([np.asarray(_with_matches(rng, ctx, _rand_wc(rng, t1, ctx), mask, 2)) for _ in range(B)])
    b = np.stack([np.asarray(_with_matches(rng, ctx, _rand_wc(rng, t2, ctx), mask, 1)) for _ in range(B)])
    cb1 = CiphertextBatch(jnp.asarray(a), ctx)
    cb2 = CiphertextBatch(jnp.asarray(b), ctx)

    prod, bits = sk.mul_and_decrypt_batch(cb1, cb2)
    assert prod.chunks == t1 * t2 and prod.pad > 0
    want = core.mul_chunks(jnp.asarray(a), jnp.asarray(b))
    got = np.asarray(
        order.canonicalize(prod.wt, prod.logical, prod.chunks)
    )
    np.testing.assert_array_equal(got, np.asarray(want))
    np.testing.assert_array_equal(
        np.asarray(bits), np.asarray(core.decrypt_parity(want, mask))
    )


def test_mul_decrypt_batched_auto_xla_fallback(ctx, sk):
    """Batched route: canonical order, per-element parity."""
    rng = np.random.default_rng(5)
    mask = jnp.asarray(sk.mask)
    B = 4
    a = jnp.stack([_with_matches(rng, ctx, _rand_wc(rng, 3, ctx), mask, 1) for _ in range(B)])
    b = jnp.stack([_with_matches(rng, ctx, _rand_wc(rng, 2, ctx), mask, 1) for _ in range(B)])
    out, jmajor, zp_a, zp_b, bits = dispatch.mul_decrypt_batched_auto(a, b, mask)
    assert (jmajor, zp_a, zp_b) == (False, 0, 0)
    want = core.mul_chunks(a, b)
    np.testing.assert_array_equal(np.asarray(out), np.asarray(want))
    np.testing.assert_array_equal(
        np.asarray(bits), np.asarray(core.decrypt_parity(want, mask))
    )


def test_mul_decrypt_auto_xla_fallback_matches_staged(ctx, sk):
    rng = np.random.default_rng(6)
    mask = jnp.asarray(sk.mask)
    a = _with_matches(rng, ctx, _rand_wc(rng, 7, ctx), mask, 3)
    b = _with_matches(rng, ctx, _rand_wc(rng, 4, ctx), mask, 2)
    out, jmajor, zp_a, zp_b, parity = dispatch.mul_decrypt_auto(a, b, mask)
    assert (jmajor, zp_a, zp_b) == (False, 0, 0)
    want = core.mul_chunks(a, b)
    np.testing.assert_array_equal(np.asarray(out), np.asarray(want))
    assert int(parity) == int(core.decrypt_parity(want, mask))
