"""Encrypt engines: the counter engine's invariants and stream contract,
and the engine selector."""

import jax
import jax.numpy as jnp
import pytest

from csgn_tpu import SecretKey


@pytest.mark.parametrize("engine", ["bogus", "pallas"])
def test_unknown_engine_rejected(ctx, rng, engine):
    sk = SecretKey.generate(ctx, rng)
    with pytest.raises(ValueError, match="unknown encrypt engine"):
        sk.encrypt_batch(jnp.asarray([1], dtype=jnp.uint8), rng, engine=engine)


# -- counter engine (reproducible across backends) --------------------------------


def _invariant_check(sk, words, bits):
    """Reference encrypt invariant (src/SecretKey.cpp:35-80 semantics)."""
    import numpy as np

    from csgn_tpu.ops import core

    w = np.asarray(words)
    mask = sk.mask
    # canonical form: no bits beyond n
    assert np.all(w & ~np.asarray(sk.ctx.valid_mask)[:, None] == 0)
    matches = np.asarray(core.chunk_matches(jnp.asarray(w), jnp.asarray(mask)))
    assert np.array_equal(matches, np.asarray(bits) & 1)


def test_counter_oracle_invariants_and_roundtrip(ctx, rng):
    sk = SecretKey.generate(ctx, rng)
    bits = jnp.asarray([0, 1] * 64, dtype=jnp.uint8)
    words = sk.encrypt_batch(bits, 1234, engine="counter")
    assert words.shape == (ctx.words32, 128)
    _invariant_check(sk, words, bits)
    dec = sk.decrypt_batch(words)
    assert jnp.array_equal(dec, bits.astype(jnp.uint32))


@pytest.mark.parametrize("n,d", [(17, 3), (95, 4), (1247, 16), (4095, 32)])
def test_counter_invariants_across_contexts(n, d):
    """Canonical form, the bit-1/bit-0 secret-position invariants and the
    decrypt round trip, at odd and even word counts and both word widths."""
    import numpy as np

    from csgn_tpu.context import Context

    ctx = Context(n, d)
    sk = SecretKey.generate(ctx, jax.random.key(n))
    bits = jnp.asarray(np.random.default_rng(n).integers(0, 2, 300), dtype=jnp.uint8)
    words = sk.encrypt_batch(bits, 2**40 + n, engine="counter")
    assert words.shape == (ctx.words32, 300)
    _invariant_check(sk, words, bits)
    assert jnp.array_equal(sk.decrypt_batch(words), bits.astype(jnp.uint32))


def test_counter_seed_is_traced(ctx, rng):
    """Every seed shares one compilation (the seed is a traced argument)."""
    from csgn_tpu.ops import encrypt_counter as ec

    sk = SecretKey.generate(ctx, rng)
    bits = jnp.asarray([1, 0, 1, 1, 0], dtype=jnp.uint8)
    sk.encrypt_batch(bits, 1, engine="counter")
    size = ec._encrypt._cache_size()
    for seed in (2, 3, 2**63 + 5):
        sk.encrypt_batch(bits, seed, engine="counter")
    assert ec._encrypt._cache_size() == size


def test_counter_stream_is_batch_prefix_stable(ctx, rng):
    """Element j's ciphertext depends only on (seed, j), not the batch size."""
    sk = SecretKey.generate(ctx, rng)
    bits_small = jnp.asarray([1, 0, 1], dtype=jnp.uint8)
    bits_big = jnp.concatenate([bits_small, jnp.ones(200, dtype=jnp.uint8)])
    small = sk.encrypt_batch(bits_small, 7, engine="counter")
    big = sk.encrypt_batch(bits_big, 7, engine="counter")
    assert jnp.array_equal(big[:, :3], small)


def test_counter_deterministic_and_seed_sensitive(ctx, rng):
    sk = SecretKey.generate(ctx, rng)
    bits = jnp.asarray([1, 1, 0, 0], dtype=jnp.uint8)
    a = sk.encrypt_batch(bits, 42, engine="counter")
    b = sk.encrypt_batch(bits, 42, engine="counter")
    c = sk.encrypt_batch(bits, 43, engine="counter")
    assert jnp.array_equal(a, b)
    assert not jnp.array_equal(a, c)


def test_counter_threefry_vector():
    """Pin the generator to the published Random123 threefry2x32-20 test
    vector: key=(0x13198a2e, 0x03707344), ctr=(0x243f6a88, 0x85a308d3)
    -> (0xc4923a9c, 0x483df7a0)."""
    from csgn_tpu.ops.encrypt_counter import _threefry2x32

    y0, y1 = _threefry2x32(
        0x13198A2E, 0x03707344,
        jnp.asarray([0x243F6A88], dtype=jnp.uint32),
        jnp.asarray([0x85A308D3], dtype=jnp.uint32),
    )
    assert int(y0[0]) == 0xC4923A9C and int(y1[0]) == 0x483DF7A0


def test_counter_matches_jax_threefry_primitive():
    """Our threefry must equal jax's own threefry2x32 primitive
    (same Random123 function) on random (key, counter) probes."""
    import numpy as np
    from jax._src.prng import threefry_2x32

    from csgn_tpu.ops.encrypt_counter import _threefry2x32

    rng = np.random.default_rng(5)
    k = rng.integers(0, 2**32, size=2, dtype=np.uint32)
    c0 = jnp.asarray(rng.integers(0, 2**32, size=64, dtype=np.uint32))
    c1 = jnp.asarray(rng.integers(0, 2**32, size=64, dtype=np.uint32))
    ours = _threefry2x32(int(k[0]), int(k[1]), c0, c1)
    theirs = threefry_2x32(jnp.asarray(k), jnp.stack([c0, c1]))
    assert jnp.array_equal(ours[0], theirs[0]) and jnp.array_equal(ours[1], theirs[1])
