"""Negative tests: every guarded entry point must fail LOUDLY (unguarded
paths + proof the subprocess harnesses can detect corruption instead of
printing OK)."""

import importlib.util
import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from csgn_tpu import io as cio
from csgn_tpu.ciphertext import Ciphertext
from csgn_tpu.ops import core
from csgn_tpu.permutation import Permutation
from csgn_tpu.pipeline import mul_chain, mul_chain_decrypt
from csgn_tpu.secret_key import SecretKey

ROOT = pathlib.Path(__file__).parent.parent


# -- SecretKey.decrypt_batch shape guards -------------------------------------


def test_decrypt_batch_rejects_transposed_fresh(ctx):
    sk = SecretKey.generate(ctx, jax.random.key(0))
    bad = jnp.zeros((16, ctx.words32), jnp.uint32)  # [batch, W] transposed
    with pytest.raises(ValueError, match="word-major"):
        sk.decrypt_batch(bad)


def test_decrypt_batch_rejects_bad_ndim_and_w(ctx):
    sk = SecretKey.generate(ctx, jax.random.key(0))
    with pytest.raises(ValueError):
        sk.decrypt_batch(jnp.zeros((7,), jnp.uint32))
    with pytest.raises(ValueError, match="chunks"):
        sk.decrypt_batch(jnp.zeros((4, ctx.words32 + 1, 3), jnp.uint32))


def test_decrypt_batch_valid_shapes_still_work(ctx):
    keys = jax.random.split(jax.random.key(1), 2)
    sk = SecretKey.generate(ctx, keys[0])
    bits = jnp.asarray([1, 0, 1, 1], jnp.uint8)
    fresh = sk.encrypt_batch(bits, keys[1])
    np.testing.assert_array_equal(np.asarray(sk.decrypt_batch(fresh)), np.asarray(bits))


# -- permutation serialization version meta ------------------------------------


def test_permutation_roundtrip_with_meta(ctx, tmp_path):
    p = Permutation.random(ctx, jax.random.key(2))
    f = tmp_path / "p.npz"
    cio.save_permutation(f, p)
    with np.load(f) as z:
        assert "meta" in z.files
    back = cio.load_permutation(f)
    np.testing.assert_array_equal(back.perm, p.perm)


def test_permutation_version_bump_rejected(tmp_path):
    f = tmp_path / "bad.npz"
    np.savez(f, kind=np.array("permutation"),
             meta=np.array([99, 5], np.int64), perm=np.arange(5))
    with pytest.raises(ValueError, match="version"):
        cio.load_permutation(f)


def test_permutation_length_mismatch_rejected(tmp_path):
    f = tmp_path / "bad.npz"
    np.savez(f, kind=np.array("permutation"),
             meta=np.array([1, 7], np.int64), perm=np.arange(5))
    with pytest.raises(ValueError, match="length"):
        cio.load_permutation(f)


def test_permutation_legacy_no_meta_loads(tmp_path):
    f = tmp_path / "legacy.npz"
    np.savez(f, kind=np.array("permutation"), perm=np.arange(5))
    back = cio.load_permutation(f)
    np.testing.assert_array_equal(back.perm, np.arange(5))


def test_state_bundle_permutation_meta(ctx, tmp_path):
    p = Permutation.random(ctx, jax.random.key(3))
    f = tmp_path / "state.npz"
    cio.save_state(f, {"p": p})
    back = cio.load_state(f)
    np.testing.assert_array_equal(back["p"].perm, p.perm)
    # tampered bundle version rejected
    np.savez(f, **{"p/kind": np.array("permutation"),
                   "p/meta": np.array([42, p.n], np.int64), "p/perm": p.perm})
    with pytest.raises(ValueError, match="version"):
        cio.load_state(f)


# -- sharded checkpoint: chunk-axis-only sharding ------------------------------


def test_save_state_sharded_rejects_word_sharding(ctx, tmp_path):
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    devs = np.array(jax.devices()[:4]).reshape(2, 2)
    mesh = Mesh(devs, ("w", "c"))
    rng = np.random.default_rng(0)
    wt = jnp.asarray(
        rng.integers(0, 2**32, (ctx.words32, 8), dtype=np.uint32)
        & ctx.valid_mask[:, None]
    )
    bad = jax.device_put(wt, NamedSharding(mesh, P("w", "c")))
    with pytest.raises(ValueError, match="chunk-axis-only"):
        cio.save_state_sharded(tmp_path / "ck", {"x": Ciphertext(bad, ctx)})
    # chunk-axis-only sharding on the same mesh still saves + loads
    good = jax.device_put(wt, NamedSharding(mesh, P(None, "c")))
    cio.save_state_sharded(tmp_path / "ok", {"x": Ciphertext(good, ctx)})
    back = cio.load_state_sharded(tmp_path / "ok")
    np.testing.assert_array_equal(np.asarray(back["x"].wt), np.asarray(wt))


# -- mul_chain HBM budget -------------------------------------------------------


def test_mul_chain_budget_guard(ctx):
    keys = jax.random.split(jax.random.key(4), 6)
    sk = SecretKey.generate(ctx, keys[0])
    cts = [sk.encrypt(1, k) + sk.encrypt(0, k) for k in keys[1:]]  # 2 chunks each
    # 5-deep chain of 2-chunk operands: peak 2^4*(1+2)=48 chunks — fine by
    # default, must trip a deliberately tiny budget.
    with pytest.raises(ValueError, match="budget"):
        mul_chain(cts, budget_bytes=1024)
    with pytest.raises(ValueError, match="budget"):
        mul_chain_decrypt(cts, sk, budget_bytes=1024)
    out = mul_chain(cts)  # default budget passes
    assert out.chunks == 2 ** len(cts)
    out2, bit = mul_chain_decrypt(cts, sk, budget_bytes=None)
    assert int(bit) == int(sk.decrypt(out2))


# -- the fault harness can FAIL -------------------------------------------------


def test_fault_resume_detects_corrupted_checkpoint(tmp_path):
    """Corrupt one payload bit in an otherwise-valid checkpoint: the resume
    phase must exit nonzero and print FAIL (proves the stdout-grep
    assertions in test_fault_injection.py are backed by a real check)."""
    spec = importlib.util.spec_from_file_location(
        "fault_demo_mod", ROOT / "tools" / "fault_demo.py"
    )
    fd = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(fd)

    ctx, acc0, ops, sk = fd._inputs()
    acc = core.mul_chunks(acc0, ops[0])  # honest post-step-0 accumulator
    acc_np = np.asarray(acc).copy()
    # Complement chunk 0 inside the valid mask: a single-bit flip can be
    # absorbed by the AND chain, but the complement differs from the original
    # at every op bit, so the resumed product provably diverges (checked
    # below against the oracle before spending the subprocess).
    acc_np[:, 0] = (~acc_np[:, 0]) & ctx.valid_mask
    resumed = jnp.asarray(acc_np)
    want = jnp.asarray(np.asarray(acc))
    for op in ops[1:]:
        resumed = core.mul_chunks(resumed, op)
        want = core.mul_chunks(want, op)
    assert not np.array_equal(np.asarray(resumed), np.asarray(want))
    cio.save_state(
        tmp_path / "ckpt_step0.npz",
        {"acc": Ciphertext(jnp.asarray(acc_np), ctx), "sk": sk},
    )
    (tmp_path / "done_step0").touch()

    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
    env["PYTHONPATH"] = str(ROOT)
    proc = subprocess.run(
        [sys.executable, str(ROOT / "tools" / "fault_demo.py"),
         "--resume", "--workdir", str(tmp_path)],
        capture_output=True, text=True, timeout=300, env=env,
    )
    assert proc.returncode != 0, proc.stdout
    assert "FAIL" in proc.stdout
