"""The jitted op dispatch against the native C++ oracle (csgn_host.cpp),
which shares no code with the JAX path."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from csgn_tpu.native import binding as native
from csgn_tpu.ops import core, dispatch
from csgn_tpu.secret_key import SecretKey


def _rand_words_wc(rng, chunks, ctx):
    w = rng.integers(0, 2**32, size=(ctx.words32, chunks), dtype=np.uint32)
    return jnp.asarray(w & ctx.valid_mask[:, None])


@pytest.mark.parametrize("t1,t2", [(1, 1), (2, 3), (8, 16), (13, 7), (9, 33)])
def test_mul_chunks_matches_native(ctx, t1, t2):
    rng = np.random.default_rng(t1 * 100 + t2)
    a = _rand_words_wc(rng, t1, ctx)
    b = _rand_words_wc(rng, t2, ctx)
    got = dispatch.mul_chunks(a, b)
    want = native.mul(np.asarray(a).T, np.asarray(b).T)
    np.testing.assert_array_equal(np.asarray(got).T, want)
    out, jmajor, zp_a, zp_b = dispatch.mul_chunks_auto(a, b)
    assert (jmajor, zp_a, zp_b) == (False, 0, 0)
    np.testing.assert_array_equal(np.asarray(out), np.asarray(got))


@pytest.mark.parametrize("chunks", [1, 2, 19, 512, 1025])
def test_decrypt_parity_matches_native(ctx, chunks):
    rng = np.random.default_rng(chunks)
    words = _rand_words_wc(rng, chunks, ctx)
    sk = SecretKey.generate(ctx, jax.random.key(chunks))
    w_np = np.asarray(words).copy()
    w_np[:, rng.choice(chunks, size=(chunks + 1) // 2, replace=False)] |= sk.mask[:, None]
    got = dispatch.decrypt_parity(jnp.asarray(w_np), jnp.asarray(sk.mask))
    assert int(got) == native.decrypt(w_np.T, sk.mask)


def test_decrypt_on_real_ciphertexts(ctx):
    keys = jax.random.split(jax.random.key(0), 4)
    sk = SecretKey.generate(ctx, keys[0])
    c = sk.encrypt(1, keys[1]) + sk.encrypt(0, keys[2]) + sk.encrypt(1, keys[3])
    assert int(dispatch.decrypt_parity(c.wt, jnp.asarray(sk.mask))) == 0  # 1 ^ 0 ^ 1
    c1 = c + sk.encrypt(1, keys[1])
    assert int(dispatch.decrypt_parity(c1.wt, jnp.asarray(sk.mask))) == 1


def test_dispatch_matches_core(ctx):
    rng = np.random.default_rng(0)
    a = _rand_words_wc(rng, 5, ctx)
    b = _rand_words_wc(rng, 4, ctx)
    np.testing.assert_array_equal(
        np.asarray(dispatch.mul_chunks(a, b)), np.asarray(core.mul_chunks(a, b))
    )
    sk = SecretKey.generate(ctx, jax.random.key(9))
    m = jnp.asarray(sk.mask)
    assert int(dispatch.decrypt_parity(a, m)) == int(core.decrypt_parity(a, m))


# -- fused multiply + decrypt -------------------------------------------------


def _forced(rng, ctx, mask, t, n_force):
    """Random words with the mask OR-ed into `n_force` columns so matches
    exist (a random chunk matches a d-bit mask with prob 2^-d)."""
    w_np = np.asarray(_rand_words_wc(rng, t, ctx)).copy()
    w_np[:, rng.choice(t, size=n_force, replace=False)] |= np.asarray(mask)[:, None]
    return jnp.asarray(w_np)


@pytest.mark.parametrize(
    "t1,t2,fa,fb",
    [(4, 128, 1, 3), (5, 128, 3, 5), (8, 256, 2, 3), (3, 384, 3, 128), (4, 256, 1, 1),
     (7, 128, 5, 3)],
)
def test_mul_and_decrypt_matches_native(ctx, t1, t2, fa, fb):
    """SecretKey.mul_and_decrypt: product == native.mul, parity ==
    native.decrypt of that product, over odd*odd (parity 1), odd*even
    (parity 0) and zero-match operands."""
    from csgn_tpu.ciphertext import Ciphertext

    rng = np.random.default_rng(t1 * 1000 + t2)
    sk = SecretKey.generate(ctx, jax.random.key(int(rng.integers(1 << 30))))
    a = _forced(rng, ctx, sk.mask, t1, fa)
    b = _forced(rng, ctx, sk.mask, t2, fb)
    prod, parity = sk.mul_and_decrypt(Ciphertext(a, ctx), Ciphertext(b, ctx))
    want = native.mul(np.asarray(a).T, np.asarray(b).T)
    np.testing.assert_array_equal(np.asarray(prod.canonical().wt).T, want)
    assert int(parity) == native.decrypt(want, sk.mask) == (fa * fb) & 1


def test_mul_decrypt_dispatch_and_secret_key(ctx):
    """dispatch.mul_decrypt + SecretKey.mul_and_decrypt end-to-end on real
    ciphertexts (Dec(E(1)*E(1)) = 1, Dec(E(1)*E(0)) = 0)."""
    keys = jax.random.split(jax.random.key(42), 4)
    sk = SecretKey.generate(ctx, keys[0])
    c1 = sk.encrypt(1, keys[1])
    c0 = sk.encrypt(0, keys[2])
    big1 = c1
    for _ in range(5):
        big1 = big1 + c1  # 6 chunks of E(1)-parity... (concat: parity XOR)

    prod, parity = dispatch.mul_decrypt(c1.wt, c0.wt, jnp.asarray(sk.mask))
    np.testing.assert_array_equal(np.asarray(prod), np.asarray(core.mul_chunks(c1.wt, c0.wt)))
    assert int(parity) == 0

    p11, d11 = sk.mul_and_decrypt(c1, c1)
    assert int(d11) == 1 and int(sk.decrypt(p11)) == 1
    p10, d10 = sk.mul_and_decrypt(c1, c0)
    assert int(d10) == 0 and int(sk.decrypt(p10)) == 0
    pb, db = sk.mul_and_decrypt(big1, c1)
    assert int(db) == int(sk.decrypt(big1)) & 1


def test_mul_and_decrypt_lazy_order_inputs(ctx):
    """Fused product of tag-carrying inputs: combined tag canonicalizes to the
    oracle product of the canonical inputs; parity is order-independent."""
    from csgn_tpu.ciphertext import Ciphertext

    rng = np.random.default_rng(11)
    t1, t2 = 6, 4
    sk = SecretKey.generate(ctx, jax.random.key(3))
    a_np = np.asarray(_rand_words_wc(rng, t1, ctx)).copy()
    a_np[:, :3] |= sk.mask[:, None]
    # physical order = reversed canonical order
    tag = jnp.asarray(np.arange(t1)[::-1].copy(), dtype=jnp.int32)
    ca = Ciphertext(jnp.asarray(a_np), ctx, tag)
    cb = Ciphertext(_rand_words_wc(rng, t2, ctx) | jnp.asarray(sk.mask)[:, None], ctx)

    prod, parity = sk.mul_and_decrypt(ca, cb)
    want = core.mul_chunks(np.asarray(ca.canonical().wt), np.asarray(cb.wt))
    np.testing.assert_array_equal(prod.chunk_major().T, np.asarray(want))
    assert int(parity) == int(core.decrypt_parity(jnp.asarray(want), jnp.asarray(sk.mask)))


def test_mul_decrypt_count_inside_shard_map(ctx):
    """The psum-able fused form traces inside shard_map bodies: per-device
    block counts summed over the mesh equal the product's match count."""
    from jax.sharding import PartitionSpec as P

    from csgn_tpu.parallel.mesh import chunk_mesh

    rng = np.random.default_rng(5)
    sk = SecretKey.generate(ctx, jax.random.key(5))
    mask = jnp.asarray(sk.mask)
    a = _forced(rng, ctx, sk.mask, 32, 5)
    b = _forced(rng, ctx, sk.mask, 128, 9)
    mesh = chunk_mesh(8)

    def local_fn(a_blk, b_blk, m):
        b_full = jax.lax.all_gather(b_blk, "c", axis=1, tiled=True)
        prod, cnt = dispatch.mul_decrypt_count(a_blk, b_full, m)
        return prod, jax.lax.psum(cnt, "c").reshape(1)

    prod, cnt = jax.shard_map(
        local_fn, mesh=mesh, in_specs=(P(None, "c"), P(None, "c"), P(None)),
        out_specs=(P(None, "c"), P(None)), check_vma=False,
    )(a, b, mask)
    want = core.mul_chunks(a, b)
    assert np.array_equal(np.asarray(prod), np.asarray(want))
    assert int(cnt[0]) == int(np.sum(np.asarray(core.chunk_matches(want, mask)))) == 45
