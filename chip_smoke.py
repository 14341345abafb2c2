"""Smoke test of csgn_tpu's main path on one NVIDIA GPU, at real size.

    python chip_smoke.py                # phases 0-5 on one card
    python chip_smoke.py --four-cards   # the chunk-sharded path on four cards

Phases (each prints its result and wall time on its own line):
  0. device: a GPU is required (no CPU fallback); prints the card's name and
     power limit and the compile-cache directory.
  1. the reference scenarios, as `python -m csgn_tpu.cli demo` runs them.
  2. real-size ops at Context(1247, 16), each against a plain reference that
     shares no code with the path under test: 2^22-bit encrypt/decrypt, a
     4096x4096-chunk fused multiply+decrypt, a 2^24-chunk decrypt and a
     2^20-chunk permutation.
  3. serving: a `BatchExecutor` flush of mul+decrypt requests and netlist
     fleets on both netlist routes, against `eval_plain`.
  4. the flagship circuits: AES-128 (FIPS-197 C.1), SHA-256 (hashlib) and a
     B=64 AES fleet.
  5. hand-written kernels: none remains (every op is XLA), so this phase
     checks the XLA ops bit for bit at W=40 and W=128 at chunk counts that
     are not powers of two, and prints each op's time beside a copy of the
     same bytes.

The last line of stdout is one JSON object naming the device; any failure
exits non-zero before it is printed.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np

# Real sizes (run on the card) and the tiny ones the CPU tests use.
FULL = dict(
    enc_bits=1 << 22, mul_t=4096, mul_samples=1024, dec_chunks=1 << 24,
    perm_chunks=1 << 20, perm_samples=1024, serve_requests=64, net_requests=16,
    fleet_b=64, k40=(3001, 1499), k128=(1499, 1001),
    four_a=1 << 20, four_b=16, four_batch=(8, 1024, 256),
)
TINY = dict(
    enc_bits=1 << 10, mul_t=64, mul_samples=64, dec_chunks=1 << 12,
    perm_chunks=1 << 10, perm_samples=64, serve_requests=64, net_requests=4,
    fleet_b=4, k40=(37, 19), k128=(19, 11),
    four_a=1 << 8, four_b=16, four_batch=(8, 16, 8),
)


def _phase(name: str):
    """Decorator: print the phase's result line and wall time."""

    def wrap(fn):
        def run(*args, **kwargs):
            t0 = time.perf_counter()
            result = fn(*args, **kwargs)
            print(f"[phase {name}] ok  {time.perf_counter() - t0:.2f} s  {result}", flush=True)
            return result

        return run

    return wrap


def _rand_words(key, ctx, chunks, lead=()):
    """Canonical random chunk words uint32[*lead, W, chunks], made on the
    device."""
    import jax
    import jax.numpy as jnp

    w = jax.random.bits(key, (*lead, ctx.words32, chunks), dtype=jnp.uint32)
    return w & jnp.asarray(ctx.valid_mask)[:, None]


def _np_matches(words: np.ndarray, mask: np.ndarray, block: int = 1 << 20) -> int:
    """Chunks of words [W, C] whose bits include the mask (numpy, blocked)."""
    m = mask[:, None]
    return sum(
        int(np.count_nonzero(np.all((words[:, i : i + block] & m) == m, axis=0)))
        for i in range(0, words.shape[1], block)
    )


def _plant(words, mask, cols):
    """OR the mask into the given chunk columns (they then match)."""
    import jax.numpy as jnp

    cols = jnp.asarray(cols)
    return words.at[:, cols].set(words[:, cols] | jnp.asarray(mask)[:, None])


@_phase("1 reference scenarios")
def phase_reference() -> str:
    from csgn_tpu import cli

    if cli.main(["demo"]) != 0:
        raise RuntimeError("cli demo failed")
    return "cli demo: add, multiply, permuted-key decrypt asserted"


@_phase("2 real-size ops")
def phase_ops(sk, sz) -> str:
    import jax
    import jax.numpy as jnp

    from csgn_tpu import Ciphertext, Permutation
    from csgn_tpu.native import binding as native

    ctx = sk.ctx
    mask = np.asarray(sk.mask)
    keys = jax.random.split(jax.random.key(2), 8)
    rng = np.random.default_rng(2)
    out = []

    # encrypt_batch -> decrypt_batch round trip.
    bits = jax.random.bits(keys[0], (sz["enc_bits"],), dtype=jnp.uint8) & 1
    dec = sk.decrypt_batch(sk.encrypt_batch(bits, keys[1]))
    if not np.array_equal(np.asarray(dec), np.asarray(bits)):
        raise RuntimeError("encrypt_batch/decrypt_batch round trip failed")
    out.append(f"enc/dec {sz['enc_bits']} bits")

    # Fused multiply + decrypt at t x t chunks.
    t = sz["mul_t"]
    a = _plant(_rand_words(keys[2], ctx, t), mask, rng.choice(t, 7, replace=False))
    b = _plant(_rand_words(keys[3], ctx, t), mask, rng.choice(t, 3, replace=False))
    prod, bit = sk.mul_and_decrypt(Ciphertext(a, ctx), Ciphertext(b, ctx))
    a_np, b_np = np.asarray(a), np.asarray(b)
    n_a, n_b = _np_matches(a_np, mask), _np_matches(b_np, mask)
    if int(bit) != (n_a * n_b) % 2:
        raise RuntimeError(f"mul_and_decrypt parity {int(bit)} != ({n_a}*{n_b}) mod 2")
    idx = np.unique(np.concatenate([[0, t * t - 1], rng.integers(0, t * t, sz["mul_samples"])]))
    got = np.asarray(prod.canonical().wt[:, jnp.asarray(idx)]).T
    want = np.concatenate([
        native.mul(a_np[:, [p // t]].T, b_np[:, [p % t]].T) for p in idx
    ])
    if not np.array_equal(got, want):
        raise RuntimeError("mul_and_decrypt product differs from native.mul")
    del prod
    out.append(f"mul+dec {t}x{t} parity {int(bit)} ({n_a}x{n_b} matches), "
               f"{len(idx)} product chunks == native.mul")

    # Decrypt a large ciphertext against a numpy eq-all parity.
    c = sz["dec_chunks"]
    words = _plant(_rand_words(keys[4], ctx, c), mask, rng.choice(c, 5, replace=False))
    p = int(sk.decrypt(Ciphertext(words, ctx)))
    n_m = _np_matches(np.asarray(words), mask)
    if p != n_m % 2:
        raise RuntimeError(f"decrypt {p} != numpy parity of {n_m} matches")
    del words
    out.append(f"decrypt {c} chunks == numpy ({n_m} matches)")

    # Permutation: sampled chunks vs native.permute, permuted-key decrypt == 1.
    c = sz["perm_chunks"]
    words = _plant(_rand_words(keys[5], ctx, c), mask, rng.choice(c, 3, replace=False))
    w_np = np.array(words)
    if _np_matches(w_np, mask) % 2 == 0:  # make the expected decrypt 1
        w_np[:, 0] |= mask
        words = jnp.asarray(w_np)
    perm = Permutation.random(ctx, keys[6])
    pct = Ciphertext(words, ctx).apply_permutation(perm)
    pdec = int(sk.apply_permutation(perm).decrypt(pct))
    if pdec != 1:
        raise RuntimeError(f"permuted-key decrypt {pdec} != 1")
    idx = np.unique(np.concatenate([[0, c - 1], rng.integers(0, c, sz["perm_samples"])]))
    got = np.asarray(pct.wt[:, jnp.asarray(idx)]).T
    want = native.permute(w_np[:, idx].T, np.asarray(perm.perm), ctx.n)
    if not np.array_equal(got, want):
        raise RuntimeError("apply_permutation differs from native.permute")
    out.append(f"permute {c} chunks: {len(idx)} chunks == native.permute, decrypt 1")
    return "; ".join(out)


def _enc_bits(sk, bits, key):
    """One encrypt_batch dispatch -> one fresh Ciphertext per bit."""
    import jax.numpy as jnp

    from csgn_tpu import Ciphertext

    words = sk.encrypt_batch(jnp.asarray(np.asarray(bits, dtype=np.uint8)), key)
    return [Ciphertext(words[:, i : i + 1], sk.ctx) for i in range(len(bits))]


@_phase("3 serving")
def phase_serving(sk, sz) -> str:
    import jax

    from csgn_tpu import BatchExecutor
    from csgn_tpu.models.netlist import adder, comparator_gt, eval_plain
    from csgn_tpu.ops import core

    rng = np.random.default_rng(3)
    keys = jax.random.split(jax.random.key(3), 4)
    ex = BatchExecutor(sk, rng=jax.random.key(31))

    n = sz["serve_requests"]
    bits = rng.integers(0, 2, 3 * n)
    cts = _enc_bits(sk, bits, keys[0])
    # a has 2 chunks (E(x) + E(y): parity x^y), b has 1.
    reqs = [(cts[3 * i] + cts[3 * i + 1], cts[3 * i + 2]) for i in range(n)]
    futs = [ex.submit_mul_decrypt(a, b) for a, b in reqs]

    width = 4
    nl_gt = comparator_gt(width)
    net_cases = [tuple(rng.integers(0, 1 << width, 2)) for _ in range(sz["net_requests"])]
    net_futs = []
    for i, (x, y) in enumerate(net_cases):
        xs = [(int(x) >> j) & 1 for j in range(width)]
        ys = [(int(y) >> j) & 1 for j in range(width)]
        e = _enc_bits(sk, xs + ys, jax.random.fold_in(keys[1], i))
        net_futs.append((ex.submit_netlist(nl_gt, [e[:width], e[width:]]), xs, ys))

    wide = 16
    nl_add = adder(wide)
    expr_futs = []
    for i in range(sz["net_requests"]):
        x, y = (int(v) for v in rng.integers(0, 1 << wide, 2))
        xs = [(x >> j) & 1 for j in range(wide)]
        ys = [(y >> j) & 1 for j in range(wide)]
        e = _enc_bits(sk, xs + ys, jax.random.fold_in(keys[2], i))
        expr_futs.append((ex.submit_netlist_expr(nl_add, [e[:wide], e[wide:]]), xs, ys))

    before = ex.stats["group_dispatches"]
    ex.flush()
    groups = ex.stats["group_dispatches"] - before
    if groups != 3:
        raise RuntimeError(f"flush ran {groups} group dispatches, want 3")

    for i, (f, (a, b)) in enumerate(zip(futs, reqs)):
        prod, bit = f.result()
        want = (bits[3 * i] ^ bits[3 * i + 1]) & bits[3 * i + 2]
        if int(bit) != want:
            raise RuntimeError(f"mul_decrypt request {i}: bit {int(bit)} != {want}")
        if not np.array_equal(np.asarray(prod.canonical().wt),
                              np.asarray(core.mul_chunks(a.canonical().wt, b.wt))):
            raise RuntimeError(f"mul_decrypt request {i}: product != core.mul_chunks")
    for f, xs, ys in net_futs:
        (out,) = f.result()
        (plain,) = eval_plain(nl_gt, [xs, ys])
        if [int(sk.decrypt(o)) for o in out] != plain:
            raise RuntimeError("submit_netlist result != eval_plain")
    for f, xs, ys in expr_futs:
        (out_bits,) = f.result()
        (plain,) = eval_plain(nl_add, [xs, ys])
        if list(out_bits) != plain:
            raise RuntimeError("submit_netlist_expr result != eval_plain")
    return (f"{n} mul_decrypt + {len(net_futs)} netlist + {len(expr_futs)} netlist_expr "
            f"requests in {groups} group dispatches, all == references")


@_phase("4 flagship circuits")
def phase_flagship(sk, sz) -> str:
    from bench import aes_fleet_blocks_per_s
    from csgn_tpu import cli

    if cli.main(["flagship"]) != 0:
        raise RuntimeError("cli flagship failed")
    bps = aes_fleet_blocks_per_s(sk, sk.ctx, fb=sz["fleet_b"])
    return (f"AES-128 == FIPS-197 C.1, SHA-256 == hashlib; AES fleet B={sz['fleet_b']} "
            f"at {bps:.2f} blocks/s")


@_phase("5 kernels")
def phase_kernels(sz) -> str:
    import jax
    import jax.numpy as jnp

    from csgn_tpu import Context, Permutation, SecretKey
    from csgn_tpu.native import binding as native
    from csgn_tpu.ops import core, dispatch
    from csgn_tpu.utils.timing import device_median_time as _time

    copy = jax.jit(lambda x: x ^ jnp.uint32(1))
    rows = ["no hand-written kernel remains; XLA ops checked"]
    for (n, d), (t1, t2) in (((1247, 16), sz["k40"]), ((4095, 32), sz["k128"])):
        ctx = Context(n, d)
        w = ctx.words32
        sk = SecretKey.generate(ctx, jax.random.key(n))
        mask = jnp.asarray(sk.mask)
        rng = np.random.default_rng(n)
        ka, kb, kp = jax.random.split(jax.random.key(n + 1), 3)
        a = _plant(_rand_words(ka, ctx, t1), sk.mask, rng.choice(t1, 5, replace=False))
        b = _plant(_rand_words(kb, ctx, t2), sk.mask, rng.choice(t2, 3, replace=False))
        prod, parity = dispatch.mul_decrypt(a, b, mask)
        p_np = np.asarray(prod)
        want_p = _np_matches(p_np, sk.mask) % 2
        if int(parity) != want_p:
            raise RuntimeError(f"W={w}: mul_decrypt parity {int(parity)} != numpy {want_p}")
        cols = np.unique(rng.integers(0, t1 * t2, 256))
        want = np.concatenate([native.mul(np.asarray(a)[:, [c // t2]].T,
                                          np.asarray(b)[:, [c % t2]].T) for c in cols])
        if not np.array_equal(p_np[:, cols].T, want):
            raise RuntimeError(f"W={w}: product differs from native.mul")
        if int(dispatch.decrypt_parity(prod, mask)) != want_p:
            raise RuntimeError(f"W={w}: decrypt_parity != numpy")
        perm = Permutation.random(ctx, kp)
        x = a[:, : t1 - 2]
        if not np.array_equal(np.asarray(dispatch.permute(x, perm.benes_plan())),
                              np.asarray(core.permute_chunks(x, jnp.asarray(perm.perm), n))):
            raise RuntimeError(f"W={w}: permute != core.permute_chunks")
        t_md = _time(lambda: dispatch.mul_decrypt(a, b, mask))
        t_dec = _time(lambda: dispatch.decrypt_parity(prod, mask))
        t_cp = _time(lambda: copy(prod))
        gb = p_np.nbytes / 1e9
        rows.append(
            f"W={w} {t1}x{t2}: mul_decrypt {t_md*1e3:.3f} ms ({gb/t_md:.0f} GB/s written), "
            f"decrypt {t_dec*1e3:.3f} ms ({gb/t_dec:.0f} GB/s read), "
            f"copy of the product {t_cp*1e3:.3f} ms ({2*gb/t_cp:.0f} GB/s r+w)"
        )
        del prod, p_np
    return "; ".join(rows)


@_phase("four cards: chunk-sharded path")
def phase_four_cards(sz, n_devices: int = 4) -> str:
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from csgn_tpu import Context, Permutation, SecretKey
    from csgn_tpu.ops import core, dispatch
    from csgn_tpu.parallel import (
        batch_chunk_mesh,
        chunk_mesh,
        shard_batch,
        sharded_decrypt_batch,
        sharded_decrypt_parity,
        sharded_mul_allgather,
        sharded_mul_batch,
        sharded_mul_decrypt,
        sharded_mul_ring,
        sharded_permute,
    )

    ctx = Context(1247, 16)
    sk = SecretKey.generate(ctx, jax.random.key(4))
    mask = jnp.asarray(sk.mask)
    rng = np.random.default_rng(4)
    ka, kb, kp, kw = jax.random.split(jax.random.key(5), 4)
    one = jax.devices()[0]
    a1 = jax.device_put(_plant(_rand_words(ka, ctx, sz["four_a"]), sk.mask,
                               rng.choice(sz["four_a"], 5, replace=False)), one)
    b1 = jax.device_put(_plant(_rand_words(kb, ctx, sz["four_b"]), sk.mask, [1, 2, 3]), one)
    mesh = chunk_mesh(n_devices)
    spec = NamedSharding(mesh, P(None, "c"))
    a, b = jax.device_put(a1, spec), jax.device_put(b1, spec)

    want_dev = core.mul_chunks(a1, b1)
    want_par = int(core.decrypt_parity(want_dev, mask))
    want = np.asarray(want_dev)
    del want_dev
    rows = []
    for name, got in (("allgather", sharded_mul_allgather(a, b, mesh)),
                      ("ring", sharded_mul_ring(a, b, mesh))):
        if not np.array_equal(np.asarray(got), want):
            raise RuntimeError(f"sharded_mul_{name} != one-card product")
        rows.append(f"mul_{name}")
    prod, par = sharded_mul_decrypt(a, b, mask, mesh)
    if int(par) != want_par or not np.array_equal(np.asarray(prod), want):
        raise RuntimeError("sharded_mul_decrypt != one-card product/parity")
    if int(sharded_decrypt_parity(prod, mask, mesh)) != want_par:
        raise RuntimeError("sharded_decrypt_parity != one-card parity")
    rows.append(f"mul_decrypt + decrypt_parity (parity {want_par})")

    plan = Permutation.random(ctx, kp).benes_plan()
    got = np.asarray(sharded_permute(a, plan, mesh))
    if not np.array_equal(got, np.asarray(dispatch.permute(a1, plan))):
        raise RuntimeError("sharded_permute != one-card permute")
    rows.append("permute")

    bsz, t1, t2 = sz["four_batch"]
    mesh2 = batch_chunk_mesh(n_devices // 2, 2)
    wb = jax.device_put(_rand_words(kw, ctx, t1, lead=(bsz,)), one)
    wb2 = wb[:, :, :t2]
    prod_b = sharded_mul_batch(shard_batch(wb, mesh2), shard_batch(wb2, mesh2), mesh2)
    bits_b = np.asarray(sharded_decrypt_batch(prod_b, mask, mesh2))
    oracle = core.mul_chunks(wb, wb2)
    if not np.array_equal(np.asarray(prod_b), np.asarray(oracle)):
        raise RuntimeError("2-D mesh batched mul != one-card product")
    if not np.array_equal(bits_b, np.asarray(core.decrypt_parity(oracle, mask))):
        raise RuntimeError("2-D mesh batched decrypt != one-card decrypt")
    rows.append(f"2-D ({n_devices // 2}x2) batch mul + decrypt")
    return (f"{sz['four_a']}x{sz['four_b']} chunks on {n_devices} devices == one card: "
            + ", ".join(rows))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the chunk-sharded path on four cards")
    args = ap.parse_args(argv)

    import jax

    t0 = time.perf_counter()
    devs = jax.devices()
    if devs[0].platform != "gpu":
        print(f"chip_smoke: no NVIDIA GPU found (JAX platform is "
              f"{devs[0].platform!r}); this smoke test needs a GPU", file=sys.stderr)
        return 1
    need = 4 if args.four_cards else 1
    if len(devs) < need:
        print(f"chip_smoke: need {need} GPUs, JAX sees {len(devs)}", file=sys.stderr)
        return 1

    from bench import card_name_and_power_limit
    from csgn_tpu import Context, SecretKey
    from csgn_tpu.utils.compile_cache import enable_compile_cache

    cache_dir = enable_compile_cache()
    print(f"[phase 0 device] ok  {time.perf_counter() - t0:.2f} s  platform={devs[0].platform} "
          f"kind={devs[0].device_kind} count={len(devs)} jax={jax.__version__} "
          f"compile_cache={cache_dir}", flush=True)
    print(f"card: {card_name_and_power_limit()}", flush=True)

    if args.four_cards:
        phase_four_cards(FULL)
    else:
        sk = SecretKey.generate(Context(1247, 16), jax.random.key(1))
        phase_reference()
        phase_ops(sk, FULL)
        phase_serving(sk, FULL)
        phase_flagship(sk, FULL)
        phase_kernels(FULL)
    d = jax.devices()[0]
    print(json.dumps({"ok": True, "device": {"platform": d.platform, "kind": d.device_kind,
                                             "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
