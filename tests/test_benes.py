"""Beneš-network permutation: router correctness + packed-domain equivalence."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from csgn_tpu import Permutation, SecretKey
from csgn_tpu.ops import core
from csgn_tpu.ops.permute_benes import _route, apply_benes, build_plan


def _apply_element_stages(x, stages):
    x = list(x)
    for d, mask in stages:
        for i in np.nonzero(mask)[0]:
            x[i], x[i + d] = x[i + d], x[i]
    return np.array(x)


@pytest.mark.parametrize("n", [2, 4, 8, 32, 128])
def test_router_realizes_permutation(n):
    rng = np.random.default_rng(n)
    for _ in range(20):
        perm = rng.permutation(n)
        stages = _route(perm)
        assert len(stages) == 2 * int(np.log2(n)) - 1
        got = _apply_element_stages(np.arange(n), stages)
        np.testing.assert_array_equal(got, np.arange(n)[perm])
        # Stage masks only mark positions with (i & delta) == 0.
        for d, m in stages:
            assert not np.any(m & (np.arange(n) & d).astype(bool))


@pytest.mark.parametrize("n", [95, 1247, 4095])
def test_packed_apply_matches_gather_oracle(n):
    from csgn_tpu.context import Context

    ctx = Context(n, 4)
    rng = np.random.default_rng(n)
    perm = rng.permutation(n).astype(np.int32)
    plan = build_plan(perm, n)
    words = jnp.asarray(
        rng.integers(0, 2**32, (ctx.words32, 5), dtype=np.uint32) & ctx.valid_mask[:, None]
    )
    got = apply_benes(words, plan)
    want = core.permute_chunks(words, jnp.asarray(perm), n)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
    # Canonical form preserved (padding routed as identity on zero bits).
    assert np.all(np.asarray(got) & ~ctx.valid_mask[:, None] == 0)


def test_ciphertext_permutation_uses_benes(ctx, rng):
    """End-to-end through the class API: Dec_{π(k)}(π(c)) = Dec_k(c)."""
    keys = jax.random.split(rng, 3)
    sk = SecretKey.generate(ctx, keys[0])
    c = sk.encrypt(1, keys[1]) + sk.encrypt(1, keys[2])
    p = Permutation.random(ctx, keys[2])
    permuted = c.apply_permutation(p)
    assert int(sk.apply_permutation(p).decrypt(permuted)) == int(sk.decrypt(c)) == 0
    # Same words as the gather oracle.
    want = core.permute_chunks(c.wt, jnp.asarray(p.perm), ctx.n)
    np.testing.assert_array_equal(np.asarray(permuted.wt), np.asarray(want))


def test_plan_caching(ctx, rng):
    p = Permutation.random(ctx, rng)
    assert p.benes_plan() is p.benes_plan()


@pytest.mark.parametrize("chunks", [64, 129, 4096])
def test_apply_benes_matches_native(chunks):
    """The XLA delta swaps (direct and through the jitted dispatch) vs the
    native C++ permutation oracle."""
    from csgn_tpu.context import Context
    from csgn_tpu.native import binding as native
    from csgn_tpu.ops import dispatch

    ctx2 = Context(1247, 16)
    rng = np.random.default_rng(chunks)
    perm = rng.permutation(ctx2.n).astype(np.int32)
    plan = build_plan(perm, ctx2.n)
    words = jnp.asarray(
        rng.integers(0, 2**32, (ctx2.words32, chunks), dtype=np.uint32)
        & ctx2.valid_mask[:, None]
    )
    want = native.permute(np.asarray(words).T, perm, ctx2.n).T
    np.testing.assert_array_equal(np.asarray(apply_benes(words, plan)), want)
    np.testing.assert_array_equal(np.asarray(dispatch.permute(words, plan)), want)


def test_apply_benes_batch_multi_permutation(ctx):
    """k different permutations over k ciphertexts in one computation: the
    stacked delta swaps (direct and through the jitted dispatch) must match
    the per-element native oracle."""
    from csgn_tpu.native import binding as native
    from csgn_tpu.ops import dispatch
    from csgn_tpu.ops.permute_benes import apply_benes_batch, stack_plans

    rng = np.random.default_rng(77)
    k, chunks = 3, 6
    plans, perms = [], []
    for _ in range(k):
        p = rng.permutation(ctx.n).astype(np.int32)
        perms.append(p)
        plans.append(build_plan(p, ctx.n))
    stacked = stack_plans(plans)
    assert stacked.k == k and stacked.rows == plans[0].rows
    words = jnp.asarray(
        rng.integers(0, 2**32, (k, ctx.words32, chunks), dtype=np.uint32)
        & ctx.valid_mask[None, :, None]
    )
    got = apply_benes_batch(words, stacked)
    got_d = dispatch.permute_batched_multi(words, stacked)
    for i in range(k):
        want = native.permute(np.asarray(words[i]).T, perms[i], ctx.n).T
        np.testing.assert_array_equal(np.asarray(got[i]), want, err_msg=str(i))
        np.testing.assert_array_equal(np.asarray(got_d[i]), want, err_msg=str(i))


def test_ciphertext_batch_apply_permutations(small_ctx):
    """CiphertextBatch.apply_permutations: per-element plans end to end,
    round-tripping under the per-element permuted secret keys."""
    import jax

    from csgn_tpu.batch import CiphertextBatch
    from csgn_tpu.permutation import Permutation
    from csgn_tpu.secret_key import SecretKey

    rng = np.random.default_rng(5)
    k = 4
    sk = SecretKey.generate(small_ctx, jax.random.key(0))
    bits = jnp.asarray(rng.integers(0, 2, k, dtype=np.uint8))
    batch = CiphertextBatch.from_fresh(sk.encrypt_batch(bits, jax.random.key(1)), small_ctx)
    perms = [Permutation.random(small_ctx, jax.random.key(10 + i)) for i in range(k)]

    permuted = batch.apply_permutations(perms)
    for i in range(k):
        psk = sk.apply_permutation(perms[i])
        assert int(psk.decrypt(permuted[i])) == int(bits[i]), i
        want = core.permute_chunks(batch.wt[i], jnp.asarray(perms[i].perm), small_ctx.n)
        np.testing.assert_array_equal(np.asarray(permuted.wt[i]), np.asarray(want))


@pytest.mark.parametrize("chunks,forced", [(6, 3), (256, 7), (130, 0)])
def test_permute_decrypt_matches_staged(ctx, chunks, forced):
    """One-dispatch permute+decrypt == staged permute then eq-all decrypt,
    with forced matches so nonzero parities are exercised."""
    import jax

    from csgn_tpu.ops import dispatch
    from csgn_tpu.secret_key import SecretKey

    rng = np.random.default_rng(chunks * 7 + forced)
    sk = SecretKey.generate(ctx, jax.random.key(chunks))
    perm = rng.permutation(ctx.n).astype(np.int32)
    plan = build_plan(perm, ctx.n)
    w_np = np.asarray(
        rng.integers(0, 2**32, (ctx.words32, chunks), dtype=np.uint32)
        & ctx.valid_mask[:, None]
    )
    # Force matches AGAINST THE OUTPUT KEY: permute its mask back through
    # the inverse so the permuted chunk matches.
    psk_mask = jnp.asarray(sk.mask)
    if forced:
        inv = np.argsort(perm)
        pre = np.asarray(core.permute_chunks(psk_mask[:, None], jnp.asarray(inv), ctx.n))
        w_np[:, rng.choice(chunks, forced, replace=False)] |= pre[:, 0:1]
    words = jnp.asarray(w_np)

    out, parity = dispatch.permute_decrypt(words, plan, psk_mask)
    want_out = core.permute_chunks(words, jnp.asarray(perm), ctx.n)
    np.testing.assert_array_equal(np.asarray(out), np.asarray(want_out))
    assert int(parity) == int(core.decrypt_parity(want_out, psk_mask))
    if forced:
        assert int(parity) == forced & 1


def test_secret_key_permute_and_decrypt(ctx):
    """Public fused rotation API: result equals both the permuted-key
    decrypt of the permuted ciphertext AND (transform identity) the plain
    decrypt of the original."""
    import jax

    from csgn_tpu.permutation import Permutation
    from csgn_tpu.secret_key import SecretKey

    keys = jax.random.split(jax.random.key(8), 3)
    sk = SecretKey.generate(ctx, keys[0])
    ct = sk.encrypt(1, keys[1]) + sk.encrypt(0, keys[2])
    p = Permutation.random(ctx, jax.random.key(4))

    pct, dec = sk.permute_and_decrypt(ct, p)
    psk = sk.apply_permutation(p)
    assert int(dec) == int(psk.decrypt(pct)) == int(sk.decrypt(ct)) == 1
    np.testing.assert_array_equal(
        np.asarray(pct.wt), np.asarray(ct.apply_permutation(p).wt)
    )


@pytest.mark.parametrize("kind", ["identity", "transposition"])
def test_zero_mask_stage_skip(ctx, kind):
    """Structured perms route to plans with all-zero (identity) stages; the
    apply paths skip those at trace time and must stay bit-exact.  The
    identity permutation is the extreme case: EVERY stage skips and the
    network degenerates to a copy."""
    from csgn_tpu.ops import dispatch
    from csgn_tpu.ops.permute_benes import apply_benes_batch, stack_plans

    n = ctx.n
    perm = np.arange(n)
    if kind == "transposition":
        perm[3], perm[n - 7] = perm[n - 7], perm[3]
    plan = build_plan(perm, n)
    if kind == "identity":
        assert not plan.masks.any()  # every stage is skippable
    else:
        assert (~plan.masks.any(axis=1)).sum() > 0  # some stages skip

    rng_np = np.random.default_rng(11)
    words = jnp.asarray(
        rng_np.integers(0, 2**32, (ctx.words32, 256), dtype=np.uint32)
        & ctx.valid_mask[:, None]
    )
    want = core.permute_chunks(words, jnp.asarray(perm), n)
    np.testing.assert_array_equal(np.asarray(apply_benes(words, plan)), np.asarray(want))
    np.testing.assert_array_equal(np.asarray(dispatch.permute(words, plan)), np.asarray(want))

    mask = np.zeros(ctx.words32, np.uint32)
    mask[0] = 1 << 31
    out, parity = dispatch.permute_decrypt(words, plan, jnp.asarray(mask))
    np.testing.assert_array_equal(np.asarray(out), np.asarray(want))
    assert int(parity) == int(core.decrypt_parity(want, jnp.asarray(mask)))

    # Stacked batch: identity plan alongside a random one — the all-k skip
    # only fires where EVERY plan's stage is zero.
    rnd = build_plan(np.random.default_rng(5).permutation(n), n)
    stacked = stack_plans([plan, rnd])
    batch = jnp.stack([words, words])
    got_b = apply_benes_batch(batch, stacked)
    got_bd = dispatch.permute_batched_multi(batch, stacked)
    np.testing.assert_array_equal(np.asarray(got_b[0]), np.asarray(want))
    np.testing.assert_array_equal(np.asarray(got_bd[0]), np.asarray(want))
    np.testing.assert_array_equal(np.asarray(got_b[1]), np.asarray(got_bd[1]))


def test_tiny_n_words_exceed_network_width():
    """n < 32 contexts have words32 = 2 > words_pad = 1: every path must
    drop/restore the canonical-zero trailing row instead of negative-padding
    (a past regression: the XLA path raised on these shapes)."""
    import numpy as np
    import jax.numpy as jnp

    from csgn_tpu.context import Context
    from csgn_tpu.ops import core, dispatch, permute_benes

    rng = np.random.default_rng(4)
    for n in (17, 31):
        ctx = Context(n, 3)
        p = rng.permutation(n)
        plan = permute_benes.build_plan(p, n)
        assert plan.words_pad < ctx.words32
        x = jnp.asarray(
            rng.integers(0, 2**32, (ctx.words32, 16), dtype=np.uint32)
            & ctx.valid_mask[:, None]
        )
        want = core.permute_chunks(x, jnp.asarray(p), n)
        assert jnp.array_equal(permute_benes.apply_benes(x, plan), want)
        assert jnp.array_equal(dispatch.permute(x, plan), want)
        mask = np.zeros(ctx.words32, np.uint32)
        for pos in range(0, n, 7):
            mask[pos // 32] |= np.uint32(1) << (31 - pos % 32)
        out, par = dispatch.permute_decrypt(x, plan, jnp.asarray(mask))
        assert jnp.array_equal(out, want)
        assert int(par) == int(core.decrypt_parity(want, jnp.asarray(mask)))
        # batch paths: 3 distinct plans
        ps = [rng.permutation(n) for _ in range(3)]
        stacked = permute_benes.stack_plans(
            [permute_benes.build_plan(q, n) for q in ps]
        )
        xb = jnp.asarray(
            rng.integers(0, 2**32, (3, ctx.words32, 8), dtype=np.uint32)
            & ctx.valid_mask[None, :, None]
        )
        want_b = jnp.stack(
            [core.permute_chunks(xb[i], jnp.asarray(ps[i]), n) for i in range(3)]
        )
        assert jnp.array_equal(permute_benes.apply_benes_batch(xb, stacked), want_b)
        assert jnp.array_equal(dispatch.permute_batched_multi(xb, stacked), want_b)
