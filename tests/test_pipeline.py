"""Deep multiplication chains (fused + sharded) and the MXU permute path."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from csgn_tpu import Ciphertext, SecretKey
from csgn_tpu.ops import core
from csgn_tpu.ops.permute_mxu import onehot_matrix, permute_chunks_mxu
from csgn_tpu.parallel.mesh import chunk_mesh
from csgn_tpu.pipeline import chain_chunks, mul_chain, mul_chain_sharded


def test_chain_chunks():
    assert chain_chunks([2, 3, 4]) == 24
    assert chain_chunks([1]) == 1


def test_mul_chain_matches_sequential(small_ctx):
    keys = jax.random.split(jax.random.key(0), 10)
    sk = SecretKey.generate(small_ctx, keys[0])
    cts = [
        sk.encrypt(1, keys[1]) + sk.encrypt(0, keys[2]),
        sk.encrypt(1, keys[3]),
        sk.encrypt(1, keys[4]) + sk.encrypt(1, keys[5]) + sk.encrypt(0, keys[6]),
        sk.encrypt(1, keys[7]),
    ]
    fused = mul_chain(cts)
    seq = cts[0]
    for ct in cts[1:]:
        seq = seq * ct
    assert fused.chunks == chain_chunks([c.chunks for c in cts]) == 6
    np.testing.assert_array_equal(np.asarray(fused.wt), np.asarray(seq.wt))
    assert int(sk.decrypt(fused)) == int(sk.decrypt(seq))


def test_mul_chain_sharded_matches(small_ctx):
    keys = jax.random.split(jax.random.key(1), 8)
    sk = SecretKey.generate(small_ctx, keys[0])
    base_bits = jnp.asarray(np.arange(8) % 2, dtype=jnp.uint8)
    base = Ciphertext(sk.encrypt_batch(base_bits, keys[1]), small_ctx)  # 8 chunks
    ops = [
        sk.encrypt(1, keys[2]) + sk.encrypt(0, keys[3]),                # 2 chunks
        sk.encrypt(1, keys[4]),                                          # 1 chunk
    ]
    mesh = chunk_mesh(8)
    got = mul_chain_sharded([base] + ops, mesh)
    want = mul_chain([base] + ops)
    assert got.chunks == 16
    np.testing.assert_array_equal(np.asarray(got.wt), np.asarray(want.wt))


def test_deep_chain_bit_growth(small_ctx):
    """16-deep chain of 2-chunk operands: 2^16 chunks, decrypt correct."""
    keys = jax.random.split(jax.random.key(2), 34)
    sk = SecretKey.generate(small_ctx, keys[0])
    cts = []
    expect = 1
    for i in range(16):
        bit = 1 if i % 5 else 1  # all ones: product stays 1
        cts.append(sk.encrypt(bit, keys[2 * i + 1]) + sk.encrypt(0, keys[2 * i + 2]))
        expect &= bit ^ 0
    prod = mul_chain(cts)
    assert prod.chunks == 2 ** 16
    assert int(sk.decrypt(prod)) == expect == 1


def test_permute_mxu_matches_gather(ctx, rng):
    r = np.random.default_rng(4)
    words = jnp.asarray(
        r.integers(0, 2**32, (ctx.words32, 17), dtype=np.uint32) & ctx.valid_mask[:, None]
    )
    perm = r.permutation(ctx.n).astype(np.int32)
    p1 = core.permute_chunks(words, jnp.asarray(perm), ctx.n)
    p2 = permute_chunks_mxu(words, onehot_matrix(perm, ctx.n), ctx.n)
    np.testing.assert_array_equal(np.asarray(p1), np.asarray(p2))


def test_mul_chain_decrypt_fused(small_ctx):
    """Fused chain+decrypt == staged chain then decrypt, bit-exact."""
    import jax

    from csgn_tpu.pipeline import mul_chain, mul_chain_decrypt
    from csgn_tpu.secret_key import SecretKey

    keys = jax.random.split(jax.random.key(2), 6)
    sk = SecretKey.generate(small_ctx, keys[0])
    cts = [sk.encrypt(1, k) for k in keys[1:5]]
    cts[2] = cts[2] + sk.encrypt(0, keys[5])  # a 2-chunk operand (1 XOR 0 = 1)

    prod, dec = mul_chain_decrypt(cts, sk)
    want = mul_chain(cts)
    np.testing.assert_array_equal(np.asarray(prod.wt), np.asarray(want.wt))
    assert int(dec) == int(sk.decrypt(want)) == 1

    # single-element chain degenerates to decrypt
    p1, d1 = mul_chain_decrypt(cts[:1], sk)
    assert int(d1) == 1
    np.testing.assert_array_equal(np.asarray(p1.wt), np.asarray(cts[0].wt))


def test_mul_chain_sharded_decrypt_fused(small_ctx):
    """Sharded fused chain+decrypt == unsharded oracle on the virtual mesh,
    both the divisible (fused) and indivisible (broadcast) last-operand
    branches."""
    import jax
    import jax.numpy as jnp

    from csgn_tpu.ops import core
    from csgn_tpu.parallel import chunk_mesh
    from csgn_tpu.pipeline import mul_chain, mul_chain_sharded_decrypt
    from csgn_tpu.secret_key import SecretKey

    rng = np.random.default_rng(4)
    mesh = chunk_mesh(8)
    keys = jax.random.split(jax.random.key(3), 4)
    sk = SecretKey.generate(small_ctx, keys[0])
    w = small_ctx.words32
    first = Ciphertext(
        jnp.asarray(rng.integers(0, 2**32, (w, 16), dtype=np.uint32)
                    & small_ctx.valid_mask[:, None]), small_ctx)
    lasts = {
        "divisible": Ciphertext(sk.encrypt_batch(
            jnp.asarray(np.ones(8, np.uint8)), keys[1]), small_ctx),
        "indivisible": Ciphertext(sk.encrypt_batch(
            jnp.asarray(np.ones(3, np.uint8)), keys[2]), small_ctx),
    }
    for name, last in lasts.items():
        prod, dec = mul_chain_sharded_decrypt([first, last], sk, mesh)
        want = mul_chain([first, last])
        np.testing.assert_array_equal(jax.device_get(prod.wt), np.asarray(want.wt), err_msg=name)
        assert int(dec) == int(sk.decrypt(want)), name


def test_default_budget_on_host_device():
    """The CPU backend reports no memory limit: the host default applies."""
    import jax

    from csgn_tpu import pipeline

    stats = jax.devices()[0].memory_stats() or {}
    if "bytes_limit" not in stats:
        assert pipeline.default_budget_bytes() == pipeline.HOST_BUDGET_BYTES


def test_default_budget_follows_device_limit(monkeypatch, small_ctx):
    """A device that reports its memory limit sets the budget (3/4 of it),
    and mul_chain's default enforces that budget."""
    import jax

    from csgn_tpu import pipeline

    class FakeDevice:
        def memory_stats(self):
            return {"bytes_limit": 1 << 20}

    monkeypatch.setattr(jax, "devices", lambda *a: [FakeDevice()])
    assert pipeline.default_budget_bytes() == 3 << 18
    rng = np.random.default_rng(64)
    cts = [
        Ciphertext(jnp.asarray(rng.integers(0, 2**32, (small_ctx.words32, t), dtype=np.uint32)
                               & small_ctx.valid_mask[:, None]), small_ctx)
        for t in (256, 256, 2)
    ]
    # Peak live chunks 256 * 257 exceed 3/4 MiB; the same chain fits without a budget.
    with pytest.raises(ValueError, match="budget"):
        pipeline.mul_chain(cts)
    assert pipeline.mul_chain(cts, budget_bytes=None).chunks == 256 * 256 * 2
