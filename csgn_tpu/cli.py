"""Command-line entry point: `python -m csgn_tpu.cli <command>`.

Commands:
  demo      — the reference's basic_operations + permutations scenarios,
              asserted (reference tests/basic_operations.cpp, permutations.cpp)
  selftest  — quick end-to-end correctness sweep (host backend)
  timings   — microbenchmark table mirroring reference tests/timings.cpp
  info      — context / device / layout report
  flagship  — homomorphic AES-128 (FIPS-197) + SHA-256 (hashlib), asserted
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from csgn_tpu.config import RunConfig


def _load_config(args) -> RunConfig:
    if args.config:
        with open(args.config) as f:
            return RunConfig.from_json(f.read())
    return RunConfig(n=args.n, d=args.d, seed=args.seed)


def cmd_demo(cfg: RunConfig) -> int:
    import jax

    from csgn_tpu import Permutation, Plaintext, SecretKey

    ctx = cfg.context()
    keys = jax.random.split(jax.random.key(cfg.seed), 4)
    print(f"Context: n={ctx.n} d={ctx.d} s={ctx.s} words/chunk={ctx.words64}")

    sk = SecretKey.generate(ctx, keys[0])
    c1 = sk.encrypt(Plaintext(1), keys[1])
    c0 = sk.encrypt(Plaintext(0), keys[2])
    added, multiplied = c1 + c0, c1 * c0
    da, dm = sk.decrypt(added), sk.decrypt(multiplied)
    print(f"Dec ( Enc (1) + Enc (0) ) = {da}")
    print(f"Dec ( Enc (1) * Enc (0) ) = {dm}")
    assert int(da) == 1 and int(dm) == 0

    perm = Permutation.random(ctx, keys[3])
    psk = sk.apply_permutation(perm)
    pct = c1.apply_permutation(perm)
    dp = psk.decrypt(pct)
    print(f"Dec_perm ( Perm ( Enc (1) ) ) = {dp}")
    assert int(dp) == 1
    assert (perm + perm.inverse()).is_identity()
    print("demo OK")
    return 0


def cmd_selftest(cfg: RunConfig) -> int:
    import jax
    import jax.numpy as jnp

    from csgn_tpu import SecretKey

    ctx = cfg.context()
    keys = jax.random.split(jax.random.key(cfg.seed), 3)
    sk = SecretKey.generate(ctx, keys[0])
    bits = jnp.asarray(np.random.default_rng(cfg.seed).integers(0, 2, cfg.batch), dtype=jnp.uint8)
    words = sk.encrypt_batch(bits, keys[1])
    dec = sk.decrypt_batch(words)
    ok = bool(np.array_equal(np.asarray(dec), np.asarray(bits)))
    print(f"batched encrypt/decrypt roundtrip x{cfg.batch}: {'OK' if ok else 'FAIL'}")
    return 0 if ok else 1


def cmd_timings(cfg: RunConfig) -> int:
    """Eight rows, mapping 1:1 onto reference tests/timings.cpp: keygen,
    encrypt, fresh add, fresh multiply, permutation generation, permute
    secret key, permute ciphertext, decrypt (permuted key + ciphertext) —
    plus the reference's size lines.  Device rows are medians of calls that
    each wait for their result (`utils.timing.device_median_time`)."""
    import jax
    import jax.numpy as jnp

    from csgn_tpu import Ciphertext, Permutation, SecretKey
    from csgn_tpu.utils.timing import Timer, device_median_time

    ctx = cfg.context()
    keys = jax.random.split(jax.random.key(cfg.seed), 4)

    SecretKey.generate(ctx, keys[3])          # warm the keygen compile
    t = Timer("keygen")
    t.start()
    sk = SecretKey.generate(ctx, keys[0])
    t.stop_and_print()

    mask = jnp.asarray(sk.mask)
    bits = jnp.asarray(np.random.default_rng(0).integers(0, 2, cfg.batch), dtype=jnp.uint8)
    te = device_median_time(lambda: sk.encrypt_batch(bits, keys[1]))
    print(f"encrypt x{cfg.batch}: {te*1e3:.3f} ms ({cfg.batch/te:,.0f} enc/s)")

    words = sk.encrypt_batch(bits, keys[1])
    from csgn_tpu.ops import core

    # Fresh addition (reference timings.cpp:34-37): chunk concatenation.
    add_jit = jax.jit(core.add_chunks)
    ta = device_median_time(lambda: add_jit(words, words))
    print(f"add {cfg.batch}+{cfg.batch} chunks: {ta*1e3:.3f} ms")

    mul_jit = jax.jit(core.mul_chunks)
    tm = device_median_time(lambda: mul_jit(words, words))
    print(f"multiply {cfg.batch}x{cfg.batch} chunks: {tm*1e3:.3f} ms")

    Permutation.random(ctx, keys[3])          # warm the compile
    tp = Timer("permutation generation")
    tp.start()
    perm = Permutation.random(ctx, keys[2])
    tp.stop_and_print()

    tk = Timer("permute secret key")
    tk.start()
    psk = sk.apply_permutation(perm)
    tk.stop_and_print()

    # Permute the ciphertext (reference timings.cpp:56-60): Beneš plan over
    # the whole batch of chunks (plan build is host-side, done once here).
    from csgn_tpu.ops import dispatch

    plan = perm.benes_plan()
    tc = device_median_time(lambda: dispatch.permute(words, plan))
    print(f"permute ciphertext ({cfg.batch} chunks): {tc*1e3:.3f} ms")

    # Decrypt with the permuted key over the permuted ciphertext
    # (reference timings.cpp:62-66).
    pwords = dispatch.permute(words, plan)
    pmask = jnp.asarray(psk.mask)
    dec_jit = jax.jit(core.decrypt_parity)
    td = device_median_time(lambda: dec_jit(pwords, pmask))
    print(f"decrypt {cfg.batch} chunks (permuted key): {td*1e3:.3f} ms")

    # Size lines (reference timings.cpp:69-72).
    c1 = Ciphertext(words[:, :1], ctx)
    print(f"\nSecret key size: {sk.size()} bytes")
    print(f"Fresh ciphertext size: {c1.size()} bytes")
    print(f"After multiplication ciphertext size: {(c1 * c1).size()} bytes")
    print(f"After addition ciphertext size: {(c1 + c1).size()} bytes")

    # Per-op structured counters accumulated by the production path above
    # (SURVEY.md §5 observability; reference has only the Timer prints).
    from csgn_tpu.utils.metrics import op_metrics

    print("\nper-op metrics (host dispatch wall time):")
    print(op_metrics().format_table())
    return 0


def cmd_flagship(cfg: RunConfig) -> int:
    """Homomorphic AES-128 (FIPS-197 C.1) + SHA-256 (vs hashlib) end-to-end:
    encrypt every input bit, evaluate the full published-suite circuit as a
    growth-free expr DAG, decrypt key-side, assert the known answers."""
    import hashlib
    import struct
    import time

    import jax
    import jax.numpy as jnp

    from csgn_tpu import Ciphertext, SecretKey
    from csgn_tpu.models.aes import aes128
    from csgn_tpu.models.netlist import bits_from_bytes, bytes_from_bits, eval_expr
    from csgn_tpu.models.sha256 import (
        SHA256_IV,
        sha256_compress,
        sha256_pad_one_block,
    )

    ctx = cfg.context()
    keys = jax.random.split(jax.random.key(cfg.seed), 4)
    sk = SecretKey.generate(ctx, keys[0])
    one = sk.encrypt(1, keys[1])

    def enc_bits(bits, key):
        words = sk.encrypt_batch(jnp.asarray(np.array(bits, dtype=np.uint8)), key)
        return [Ciphertext(words[:, i : i + 1], ctx) for i in range(len(bits))]

    aes_key = bytes(range(16))
    block = bytes.fromhex("00112233445566778899aabbccddeeff")
    t0 = time.time()
    cts = enc_bits(bits_from_bytes(aes_key + block), keys[2])
    (outs,) = eval_expr(aes128(), [cts[:128], cts[128:]], one)
    got = bytes_from_bits([int(v) for v in sk.decrypt_circuits(outs)])
    print(f"AES-128(FIPS C.1) homomorphically = {got.hex()}  [{time.time()-t0:.1f}s]")
    assert got.hex() == "69c4e0d86a7b0430d8cdb78070b4c55a"

    msg = b"csgn_tpu flagship"
    iv = b"".join(struct.pack(">I", h) for h in SHA256_IV)
    t0 = time.time()
    cts = enc_bits(bits_from_bytes(sha256_pad_one_block(msg) + iv), keys[3])
    (outs,) = eval_expr(sha256_compress(), [cts[:512], cts[512:]], one)
    got = bytes_from_bits([int(v) for v in sk.decrypt_circuits(outs)])
    print(f"SHA-256({msg!r}) homomorphically = {got.hex()}  [{time.time()-t0:.1f}s]")
    assert got == hashlib.sha256(msg).digest()
    print("flagship OK")
    return 0


def cmd_info(cfg: RunConfig) -> int:
    import jax

    ctx = cfg.context()
    print(f"csgn_tpu context: n={ctx.n} d={ctx.d} s={ctx.s}")
    print(f"layout: words64={ctx.words64} words32={ctx.words32} bitlen={ctx.bitlen[:3]}...{ctx.bitlen[-1]}")
    print(f"backend: {jax.default_backend()}")
    print(f"devices: {jax.devices()}")
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="csgn_tpu", description=__doc__)
    p.add_argument(
        "command", choices=["demo", "selftest", "timings", "info", "flagship"]
    )
    p.add_argument("--n", type=int, default=1247)
    p.add_argument("--d", type=int, default=16)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--config", type=str, default=None, help="JSON RunConfig path")
    p.add_argument(
        "--metrics", action="store_true",
        help="print the per-op metrics table after the command",
    )
    args = p.parse_args(argv)
    cfg = _load_config(args)
    from csgn_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    rc = {
        "demo": cmd_demo,
        "selftest": cmd_selftest,
        "timings": cmd_timings,
        "info": cmd_info,
        "flagship": cmd_flagship,
    }[args.command](cfg)
    if args.metrics:
        from csgn_tpu.utils.metrics import op_metrics

        print("\nper-op metrics (host dispatch wall time):")
        print(op_metrics().format_table())
    return rc


if __name__ == "__main__":
    sys.exit(main())
