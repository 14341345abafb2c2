"""Serialization / checkpoint round-trips, including reference-layout interop."""

import jax
import numpy as np

from csgn_tpu import Ciphertext, Permutation, SecretKey
from csgn_tpu import io as cio


def test_ciphertext_roundtrip(tmp_path, ctx, rng):
    keys = jax.random.split(rng, 3)
    sk = SecretKey.generate(ctx, keys[0])
    ct = (sk.encrypt(1, keys[1]) + sk.encrypt(0, keys[2])) * sk.encrypt(1, keys[1])
    path = tmp_path / "ct.npz"
    cio.save_ciphertext(path, ct)
    back = cio.load_ciphertext(path)
    assert back.ctx == ct.ctx
    np.testing.assert_array_equal(np.asarray(back.wt), np.asarray(ct.wt))
    assert int(sk.decrypt(back)) == int(sk.decrypt(ct))


def test_secret_key_roundtrip(tmp_path, ctx, rng):
    sk = SecretKey.generate(ctx, rng)
    path = tmp_path / "sk.npz"
    cio.save_secret_key(path, sk)
    back = cio.load_secret_key(path)
    assert back.ctx == sk.ctx
    np.testing.assert_array_equal(back.indices, sk.indices)
    np.testing.assert_array_equal(back.mask, sk.mask)


def test_permutation_roundtrip(tmp_path, ctx, rng):
    p = Permutation.random(ctx, rng)
    path = tmp_path / "p.npz"
    cio.save_permutation(path, p)
    assert cio.load_permutation(path) == p


def test_state_checkpoint_resume(tmp_path, small_ctx):
    """Checkpoint mid-computation, resume, and finish identically."""
    keys = jax.random.split(jax.random.key(3), 6)
    sk = SecretKey.generate(small_ctx, keys[0])
    p = Permutation.random(small_ctx, keys[1])
    acc = sk.encrypt(1, keys[2]) + sk.encrypt(0, keys[3])
    acc = acc * (sk.encrypt(1, keys[4]) + sk.encrypt(1, keys[5]))

    path = tmp_path / "state.npz"
    cio.save_state(path, {"acc": acc, "sk": sk, "perm": p})
    state = cio.load_state(path)

    # Resume: continue the chain from the checkpoint on both copies.
    fresh = sk.encrypt(1, keys[2])
    done_a = (acc * fresh).apply_permutation(p)
    done_b = (state["acc"] * fresh).apply_permutation(state["perm"])
    np.testing.assert_array_equal(np.asarray(done_a.wt), np.asarray(done_b.wt))
    assert int(state["sk"].apply_permutation(p).decrypt(done_b)) == int(
        sk.apply_permutation(p).decrypt(done_a)
    )


def test_reference_u64_interop(ctx, rng):
    """to_u64/from_u64 is a lossless bijection to the reference layout."""
    keys = jax.random.split(rng, 2)
    sk = SecretKey.generate(ctx, keys[0])
    ct = sk.encrypt(1, keys[1]) + sk.encrypt(0, keys[1])
    w64 = ct.to_u64()
    assert w64.shape == (2 * ctx.words64,)
    back = Ciphertext.from_u64(w64, ctx)
    np.testing.assert_array_equal(np.asarray(back.wt), np.asarray(ct.wt))


# -- per-shard checkpoints -----------------------------------------------------


def test_sharded_checkpoint_reshard_roundtrip(tmp_path, ctx, rng):
    """Save a chunk-sharded payload per-shard (8 devices), load onto meshes
    of 4, 2, and 1 devices — bit-identical payload and decrypt each time."""
    import jax.numpy as jnp

    from csgn_tpu.parallel import chunk_mesh, shard_ciphertext

    keys = jax.random.split(rng, 3)
    sk = SecretKey.generate(ctx, keys[0])
    words = np.random.default_rng(0).integers(
        0, 2**32, (ctx.words32, 64), dtype=np.uint32
    ).astype(np.uint32) & np.asarray(ctx.valid_mask)[:, None]
    words[:, [3, 17, 40]] |= sk.mask[:, None]  # 3 matches -> parity 1
    ct = shard_ciphertext(Ciphertext(jnp.asarray(words), ctx), chunk_mesh(8))

    d = tmp_path / "ckpt_sharded"
    cio.save_state_sharded(d, {"acc": ct, "sk": sk})
    assert (d / "manifest.json").exists() and (d / "aux.npz").exists()
    assert len(list(d.glob("acc.c*.npy"))) == 8  # one block per owning shard

    for nd in (4, 2, 1):
        state = cio.load_state_sharded(d, mesh=chunk_mesh(nd))
        got = state["acc"]
        assert {(s.index[-1].stop or 64) - (s.index[-1].start or 0)
                for s in got.wt.addressable_shards} == {64 // nd}
        np.testing.assert_array_equal(jax.device_get(got.wt), words)
        assert int(state["sk"].decrypt(got)) == 1

    # meshless load assembles the full payload on one device
    state = cio.load_state_sharded(d)
    np.testing.assert_array_equal(np.asarray(state["acc"].wt), words)


def test_sharded_checkpoint_rejects_lazy_payload(tmp_path, ctx):
    import jax.numpy as jnp
    import pytest

    words = jnp.zeros((ctx.words32, 4), jnp.uint32)
    lazy = Ciphertext(words, ctx, jnp.asarray([3, 2, 1, 0], jnp.int32))
    with pytest.raises(ValueError, match="canonical"):
        cio.save_state_sharded(tmp_path / "x", {"bad": lazy})


def test_sharded_checkpoint_unsharded_payload(tmp_path, small_ctx):
    """A plain single-device ciphertext round-trips through the sharded
    format too (one block)."""
    import jax.numpy as jnp

    from csgn_tpu.parallel import chunk_mesh

    keys = jax.random.split(jax.random.key(4), 3)
    sk = SecretKey.generate(small_ctx, keys[0])
    ct = sk.encrypt(1, keys[1]) + sk.encrypt(1, keys[2])
    d = tmp_path / "ckpt1"
    cio.save_state_sharded(d, {"ct": ct, "sk": sk})
    state = cio.load_state_sharded(d, mesh=chunk_mesh(2))
    np.testing.assert_array_equal(jax.device_get(state["ct"].wt), np.asarray(ct.wt))
    assert int(state["sk"].decrypt(state["ct"])) == 0  # 1 XOR 1


def test_sharded_checkpoint_uneven_chunk_count(tmp_path, ctx, rng):
    """Resume onto a mesh whose size does NOT divide the saved chunk count:
    load_state_sharded zero-pads the chunk axis to the
    new mesh — pad chunks are canonical and parity-neutral — so ANY mesh can
    resume any checkpoint."""
    import jax.numpy as jnp

    from csgn_tpu.parallel import chunk_mesh, shard_ciphertext

    keys = jax.random.split(rng, 2)
    sk = SecretKey.generate(ctx, keys[0])
    c = 67  # divides neither 8, 4, nor 2
    words = np.random.default_rng(7).integers(
        0, 2**32, (ctx.words32, c), dtype=np.uint32
    ).astype(np.uint32) & np.asarray(ctx.valid_mask)[:, None]
    words[:, [5, 66]] |= sk.mask[:, None]  # 2 matches -> parity 0
    ct = Ciphertext(jnp.asarray(words), ctx)

    d = tmp_path / "ckpt_uneven"
    cio.save_state_sharded(d, {"acc": ct, "sk": sk})

    for nd in (8, 4, 2):
        state = cio.load_state_sharded(d, mesh=chunk_mesh(nd))
        got = jax.device_get(state["acc"].wt)
        cp = -(-c // nd) * nd
        assert got.shape == (ctx.words32, cp) and cp > c
        np.testing.assert_array_equal(got[:, :c], words)
        assert not got[:, c:].any()  # pad chunks are zero (canonical)
        assert int(state["sk"].decrypt(state["acc"])) == 0

    # Meshless load returns the exact saved size.
    state = cio.load_state_sharded(d)
    np.testing.assert_array_equal(np.asarray(state["acc"].wt), words)

    # A mesh-sharded save (even shards) also resumes onto a non-dividing
    # mesh: 64 chunks from 8 devices onto a 3-device mesh (pads to 66).
    words64 = words[:, :64].copy()
    ct8 = shard_ciphertext(Ciphertext(jnp.asarray(words64), ctx), chunk_mesh(8))
    d2 = tmp_path / "ckpt_uneven2"
    cio.save_state_sharded(d2, {"acc": ct8, "sk": sk})
    state = cio.load_state_sharded(d2, mesh=chunk_mesh(3))
    got = jax.device_get(state["acc"].wt)
    assert got.shape == (ctx.words32, 66)
    np.testing.assert_array_equal(got[:, :64], words64)
    assert not got[:, 64:].any()
