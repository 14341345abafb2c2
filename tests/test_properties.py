"""Property-based tests (hypothesis): scheme laws over random inputs.

SURVEY.md §4's test-plan item (c): Dec∘Enc = id; homomorphism of +/* for
random circuits; permutation equivariance; XOR-parity semantics under chunk
concatenation.
"""

import jax
import jax.numpy as jnp
import numpy as np
from hypothesis import given, settings, strategies as st

from csgn_tpu import Context, Permutation, SecretKey
from csgn_tpu import layout
from csgn_tpu.ops import core

SMALL = Context(95, 4)
_KEYS = jax.random.split(jax.random.key(1234), 64)
_SK = SecretKey.generate(SMALL, _KEYS[0])


@settings(max_examples=25, deadline=None)
@given(st.integers(1, 300), st.integers(0, 2**32 - 1))
def test_pack_unpack_roundtrip_any_n(n, seed):
    rng = np.random.default_rng(seed)
    bits = rng.integers(0, 2, size=(2, n)).astype(np.uint8)
    words = layout.pack_bits(jnp.asarray(bits))
    np.testing.assert_array_equal(np.asarray(layout.unpack_bits(words, n)), bits)
    # word-major twin agrees with chunk-major
    words_wc = layout.pack_bits_wc(jnp.asarray(bits.T))
    np.testing.assert_array_equal(np.asarray(words_wc), np.asarray(words).T)


@settings(max_examples=15, deadline=None)
@given(st.lists(st.sampled_from(["xor", "and"]), min_size=1, max_size=5),
       st.lists(st.integers(0, 1), min_size=6, max_size=6),
       st.integers(0, 31))
def test_random_circuit_homomorphism(ops, bits, key_off):
    """Fold a random +/* circuit over encrypted bits == plain evaluation."""
    ks = jax.random.split(_KEYS[1 + key_off], len(bits))
    cts = [_SK.encrypt(b, ks[i]) for i, b in enumerate(bits)]
    acc_ct, acc = cts[0], bits[0]
    for i, op in enumerate(ops):
        nxt_ct, nxt = cts[(i + 1) % len(bits)], bits[(i + 1) % len(bits)]
        if op == "xor":
            acc_ct, acc = acc_ct + nxt_ct, acc ^ nxt
        else:
            if acc_ct.chunks * nxt_ct.chunks > 64:
                continue  # keep growth bounded for test speed
            acc_ct, acc = acc_ct * nxt_ct, acc & nxt
    assert int(_SK.decrypt(acc_ct)) == acc


@settings(max_examples=10, deadline=None)
@given(st.integers(0, 2**31 - 1), st.integers(1, 4))
def test_permutation_equivariance(seed, chunks):
    rng = np.random.default_rng(seed)
    perm = Permutation(rng.permutation(SMALL.n).astype(np.int32))
    ks = jax.random.split(jax.random.key(seed), chunks + 1)
    ct = _SK.encrypt(1, ks[0])
    for i in range(1, chunks):
        ct = ct + _SK.encrypt(rng.integers(0, 2), ks[i])
    assert int(_SK.apply_permutation(perm).decrypt(ct.apply_permutation(perm))) == int(
        _SK.decrypt(ct)
    )


@settings(max_examples=10, deadline=None)
@given(st.lists(st.integers(0, 1), min_size=1, max_size=16), st.integers(0, 31))
def test_concat_parity_semantics(bits, key_off):
    """Decrypting a concatenation of fresh chunks = XOR of the bits."""
    ks = jax.random.split(_KEYS[32 + key_off], 1)[0]
    words = _SK.encrypt_batch(jnp.asarray(bits, dtype=jnp.uint8), ks)
    got = int(core.decrypt_parity(words, jnp.asarray(_SK.mask)))
    assert got == (sum(bits) % 2)


@settings(max_examples=10, deadline=None)
@given(st.integers(0, 2**31 - 1))
def test_mul_is_and_on_parities(seed):
    rng = np.random.default_rng(seed)
    ta, tb = int(rng.integers(1, 5)), int(rng.integers(1, 5))
    ks = jax.random.split(jax.random.key(seed), ta + tb)
    bits_a = [int(rng.integers(0, 2)) for _ in range(ta)]
    bits_b = [int(rng.integers(0, 2)) for _ in range(tb)]
    ca = _SK.encrypt(bits_a[0], ks[0])
    for i in range(1, ta):
        ca = ca + _SK.encrypt(bits_a[i], ks[i])
    cb = _SK.encrypt(bits_b[0], ks[ta])
    for i in range(1, tb):
        cb = cb + _SK.encrypt(bits_b[i], ks[ta + i])
    want = (sum(bits_a) % 2) & (sum(bits_b) % 2)
    assert int(_SK.decrypt(ca * cb)) == want


@settings(max_examples=15, deadline=None)
@given(st.integers(17, 300), st.integers(1, 260), st.integers(0, 2**31 - 1))
def test_benes_random_shapes(n, c, seed):
    """The Beneš delta swaps (direct and through the jitted dispatch) match
    the gather oracle for arbitrary (n, chunks): w > wp (n < 32), unaligned
    chunk tails, payload windows above/below W."""
    import numpy as np

    from csgn_tpu.context import Context
    from csgn_tpu.ops import core, permute_benes

    ctx = Context(n, min(3, n - 1))
    r = np.random.default_rng(seed)
    perm = r.permutation(n)
    plan = permute_benes.build_plan(perm, n)
    x = jnp.asarray(
        r.integers(0, 2**32, (ctx.words32, c), dtype=np.uint32)
        & ctx.valid_mask[:, None]
    )
    want = core.permute_chunks(x, jnp.asarray(perm), n)
    assert jnp.array_equal(permute_benes.apply_benes(x, plan), want)
    from csgn_tpu.ops import dispatch

    assert jnp.array_equal(dispatch.permute(x, plan), want)
