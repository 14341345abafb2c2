"""Headline benchmark: homomorphic multiply + decrypt throughput per device.

Prints ONE JSON line on stdout:
  {"metric": ..., "value": N, "unit": ..., "vs_baseline": N, ...sub-metrics}

Workload (BASELINE.md / BASELINE.json configs): Context(1247, 16), the fused
multiply+decrypt pipeline (`dispatch.mul_decrypt`: the product is written
once and its parity comes from the operands), plus staged multiply, decrypt,
encrypt, permutation, a serving fleet and a homomorphic AES-128 fleet as
sub-metrics.  Sizes are the real ones on a GPU (4096x4096 product, 2^24-chunk
decrypt, 2^22 encrypts, 2^20-chunk permutation) and small elsewhere, so the
CPU run is a smoke test only: its numbers are not device metrics.

The reference C++ baseline, measured in this environment (BASELINE.md):
  * multiply: 128x128 chunks -> 16384 out-chunks in 5.5 ms   (0.3357 us/chunk)
  * decrypt:  16384 chunks in 23.3 ms                        (1.4221 us/chunk)

Timing: every call waits for its whole result (`jax.block_until_ready`), so
no output can be folded away and no dispatch is timed without its work.  The
ops are measured in interleaved groups (each op once per group, REPS calls,
median); a value is the median of the group medians and its spread is the
distance between the quartiles of the group medians over that median.  An
XLA copy of the product's bytes runs in the same groups as the anchor.
Diagnostics, including the device and the card's power limit, go to stderr.
"""

from __future__ import annotations

import json
import shutil
import subprocess
import sys
import time

import numpy as np

REF_MUL_US_PER_CHUNK = 5.5e3 / 16384    # BASELINE.md: 128x128-chunk multiply
REF_DEC_US_PER_CHUNK = 23.3e3 / 16384   # BASELINE.md: 16384-chunk decrypt

GROUPS = 5   # interleaved measurement groups
REPS = 5     # timed calls per op per group


def log(*args):
    print(*args, file=sys.stderr, flush=True)


def card_name_and_power_limit() -> str:
    """`nvidia-smi`'s name and power limit of the card(s), or a note."""
    if shutil.which("nvidia-smi") is None:
        return "nvidia-smi not found"
    proc = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    return proc.stdout.strip() or proc.stderr.strip()


def median_time(fn, reps):
    """Median wall time of fn() with its result ready on the device."""
    import jax

    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        ts.append(time.perf_counter() - t0)
    return sorted(ts)[len(ts) // 2]


def _stats(ts):
    """(median, spread): spread = quartile distance / median."""
    q1, med, q3 = np.percentile(ts, [25, 50, 75])
    return float(med), float((q3 - q1) / med) if med > 0 else 0.0


def interleaved_measure(fns: dict, groups=GROUPS, reps=REPS):
    """Each op once per group, in turn.  Returns {name: (median, spread,
    [group medians])}."""
    import jax

    for f in fns.values():
        jax.block_until_ready(f())  # compile + warm
    per_group = {k: [] for k in fns}
    for _ in range(groups):
        for name, f in fns.items():
            per_group[name].append(median_time(f, reps))
    return {name: (*_stats(ts), ts) for name, ts in per_group.items()}


def aes_fleet_blocks_per_s(sk, ctx, fb: int = 64) -> float:
    """Homomorphic AES-128 blocks/s over a B-instance fleet (fleet expr path:
    one encrypt_batch, one DAG, packed-int fold), best of 2 runs.  Raises if
    instance 0 does not give FIPS-197 C.1."""
    import jax
    import jax.numpy as jnp

    from csgn_tpu.batch import CiphertextBatch
    from csgn_tpu.models.aes import aes128
    from csgn_tpu.models.netlist import bits_from_bytes, bytes_from_bits, eval_expr

    fleet_nl = aes128()
    fkeys = [bytes([(7 * b + i) % 256 for i in range(16)]) for b in range(fb)]
    fkeys[0] = bytes(range(16))  # FIPS-197 C.1
    fblock = bytes.fromhex("00112233445566778899aabbccddeeff")
    bit_mat = np.zeros((256, fb), dtype=np.uint8)
    for b in range(fb):
        bit_mat[:, b] = bits_from_bytes(fkeys[b] + fblock)
    one_ct = sk.encrypt(1, jax.random.key(0xF1))
    times = []
    for rep in range(2):
        t0 = time.perf_counter()
        fw = sk.encrypt_batch(jnp.asarray(bit_mat.reshape(-1)), jax.random.key(0xF2 + rep))
        w3 = jnp.transpose(jnp.reshape(fw, (fw.shape[0], 256, fb)), (2, 0, 1))
        wires = [CiphertextBatch(w3[:, :, i : i + 1], ctx) for i in range(256)]
        (fouts,) = eval_expr(fleet_nl, [wires[:128], wires[128:]], one_ct)
        fres = sk.decrypt_circuits(fouts)
        times.append(time.perf_counter() - t0)
        got0 = bytes_from_bits([int(r[0]) for r in fres]).hex()
        if got0 != "69c4e0d86a7b0430d8cdb78070b4c55a":
            raise RuntimeError(f"AES fleet instance 0 gave {got0}, not FIPS-197 C.1")
    return fb / min(times)


def main():
    import jax
    import jax.numpy as jnp

    from csgn_tpu.context import Context
    from csgn_tpu.ops import core, dispatch, permute_benes
    from csgn_tpu.utils.compile_cache import enable_compile_cache

    cache_dir = enable_compile_cache()
    dev = jax.devices()[0]
    on_gpu = dev.platform == "gpu"
    log(f"device: platform={dev.platform} kind={dev.device_kind} "
        f"count={len(jax.devices())} jax={jax.__version__}")
    log(f"card (name, power limit): {card_name_and_power_limit()}")
    log(f"compile cache: {cache_dir}")
    if not on_gpu:
        log("not a GPU: small sizes, and no number below is a device metric")

    ctx = Context(1247, 16)
    w = ctx.words32
    rng = np.random.default_rng(0)
    vm = ctx.valid_mask[:, None]
    t1 = t2 = 4096 if on_gpu else 256          # 2.68 GB product on the GPU
    dec_chunks = 1 << 24 if on_gpu else 1 << 16

    a = jnp.asarray(rng.integers(0, 2**32, (w, t1), dtype=np.uint32) & vm)
    b = jnp.asarray(rng.integers(0, 2**32, (w, t2), dtype=np.uint32) & vm)
    mask_np = np.zeros(w, np.uint32)
    for pos in (np.arange(ctx.d) * 71 + 5) % ctx.n:
        mask_np[pos // 32] |= np.uint32(1) << np.uint32(31 - pos % 32)
    mask = jnp.asarray(mask_np)
    # Plant matches in both operands so the parity is not trivially 0.
    a = a.at[:, :3].set(a[:, :3] | mask[:, None])
    b = b.at[:, :5].set(b[:, :5] | mask[:, None])
    big = jnp.asarray(rng.integers(0, 2**32, (w, dec_chunks), dtype=np.uint32))

    # --- exactness guards at the measured shapes.
    prod, parity = dispatch.mul_decrypt(a, b, mask)
    head = np.asarray(prod[:, :t2])
    tail = np.asarray(prod[:, -t2:])
    if not (np.array_equal(head, np.asarray(core.mul_chunks(a[:, :1], b)))
            and np.array_equal(tail, np.asarray(core.mul_chunks(a[:, -1:], b)))):
        raise RuntimeError("fused product mismatch vs core.mul_chunks")
    n_a = int(np.sum(np.asarray(core.chunk_matches(a, mask))))
    n_b = int(np.sum(np.asarray(core.chunk_matches(b, mask))))
    want_parity = (n_a * n_b) & 1
    if int(parity) != want_parity:
        raise RuntimeError(f"fused parity {int(parity)} != {want_parity}")
    del prod, head, tail
    small = big[:, :1024]
    if int(dispatch.decrypt_parity(small, mask)) != int(core.decrypt_parity(small, mask)):
        raise RuntimeError("decrypt mismatch vs core.decrypt_parity")

    copy = jax.jit(lambda x: x ^ jnp.uint32(1))
    res = interleaved_measure({
        "fused": lambda: dispatch.mul_decrypt(a, b, mask),
        "mul": lambda: dispatch.mul_chunks(a, b),
        "dec": lambda: dispatch.decrypt_parity(big, mask),
        "anchor": lambda: copy(big),
    })
    t_fused, t_mul, t_dec, t_anchor = (res[k][0] for k in ("fused", "mul", "dec", "anchor"))
    out_chunks = t1 * t2
    out_bytes = out_chunks * w * 4
    fused_gbps = out_bytes / t_fused / 1e9
    mul_gbps = out_bytes / t_mul / 1e9
    dec_gbps = dec_chunks * w * 4 / t_dec / 1e9
    anchor_gbps = 2 * dec_chunks * w * 4 / t_anchor / 1e9   # read + write
    for name, (med, spread, ts) in res.items():
        log(f"{name}: median {med*1e3:.3f} ms  spread {spread*100:.1f}%  "
            f"groups [{', '.join(f'{t*1e3:.3f}' for t in ts)}] ms")
    log(f"fused mul+dec {t1}x{t2}: {fused_gbps:.0f} GB/s written; mul {mul_gbps:.0f} GB/s; "
        f"dec {dec_chunks}: {dec_gbps:.0f} GB/s read; copy anchor {anchor_gbps:.0f} GB/s r+w")
    del big

    # --- encrypt and permutation.
    from csgn_tpu.secret_key import SecretKey

    sk = SecretKey.generate(ctx, jax.random.key(0))
    enc_batch = 1 << 22 if on_gpu else 1 << 12
    bits = jnp.asarray(rng.integers(0, 2, enc_batch, dtype=np.uint8))
    pc = 1 << 20 if on_gpu else 1 << 12
    perm = rng.permutation(ctx.n)
    plan = permute_benes.build_plan(perm, ctx.n)
    px = jnp.asarray(rng.integers(0, 2**32, (w, pc), dtype=np.uint32) & vm)
    small_in = px[:, :256]
    if not np.array_equal(
        np.asarray(dispatch.permute(small_in, plan)),
        np.asarray(core.permute_chunks(small_in, jnp.asarray(perm), ctx.n)),
    ):
        raise RuntimeError("permutation mismatch vs core.permute_chunks")
    enc_key = jax.random.key(5)
    aux = interleaved_measure({
        "enc": lambda: sk.encrypt_batch(bits, enc_key),
        "perm": lambda: dispatch.permute(px, plan),
    }, groups=4, reps=3)
    t_enc, t_perm = aux["enc"][0], aux["perm"][0]
    enc_rate = enc_batch / t_enc / 1e9
    perm_gbps = 2 * pc * w * 4 / t_perm / 1e9   # read + write
    log(f"enc {enc_batch}: {t_enc*1e3:.3f} ms  {enc_rate:.3f} B enc/s  "
        f"spread {aux['enc'][1]*100:.1f}%")
    log(f"perm {pc}: {t_perm*1e3:.3f} ms  {perm_gbps:.0f} GB/s r+w  "
        f"spread {aux['perm'][1]*100:.1f}%")

    # --- serving: S small fused mul+decrypt requests one call at a time vs
    # ONE BatchExecutor flush (same requests).
    from csgn_tpu.ciphertext import Ciphertext
    from csgn_tpu.serve import BatchExecutor

    s_req = 64 if on_gpu else 6
    sc = 2  # 2x2-chunk products: dispatch-bound, the serving-fleet regime
    pw = rng.integers(0, 2**32, (2 * s_req, w, sc), dtype=np.uint32) & vm[None]
    pairs = [
        (Ciphertext(jnp.asarray(pw[2 * i]), ctx), Ciphertext(jnp.asarray(pw[2 * i + 1]), ctx))
        for i in range(s_req)
    ]

    def serve_loop():
        return np.asarray([int(sk.mul_and_decrypt(c1, c2)[1]) for c1, c2 in pairs])

    def serve_batch():
        ex = BatchExecutor(sk)
        futs = [ex.submit_mul_decrypt(c1, c2) for c1, c2 in pairs]
        ex.flush()
        return np.asarray([int(f.result()[1]) for f in futs])

    if not np.array_equal(serve_loop(), serve_batch()):
        raise RuntimeError("serve paths disagree")
    sres = interleaved_measure({"serve_loop": serve_loop, "serve_batch": serve_batch},
                               groups=3, reps=3)
    t_loop, t_batch = sres["serve_loop"][0], sres["serve_batch"][0]
    serve_spread = max(sres["serve_loop"][1], sres["serve_batch"][1])
    log(f"serve: loop {t_loop*1e3:.1f} ms vs flush {t_batch*1e3:.1f} ms for "
        f"{s_req} requests -> {t_loop / t_batch:.1f}x  spread {serve_spread*100:.1f}%")

    aes_bps = aes_fleet_blocks_per_s(sk, ctx)
    log(f"aes fleet: B=64 -> {aes_bps:.2f} homomorphic AES-128 blocks/s (FIPS-anchored)")

    fused_us_per_chunk = t_fused * 1e6 / out_chunks
    print(json.dumps({
        "metric": "homomorphic mul+dec chunk throughput per device, Context(1247,16)",
        "value": round(1.0 / fused_us_per_chunk, 3),
        "unit": "M chunk-ops/s",
        "vs_baseline": round((REF_MUL_US_PER_CHUNK + REF_DEC_US_PER_CHUNK) / fused_us_per_chunk, 1),
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
        "fused_gbps": round(fused_gbps, 1),
        "fused_spread_pct": round(res["fused"][1] * 100, 1),
        "groups": len(res["fused"][2]),
        "anchor_gbps": round(anchor_gbps, 1),
        "value_vs_anchor": round(fused_gbps / anchor_gbps, 3),
        "mul_gbps": round(mul_gbps, 1),
        "mul_spread_pct": round(res["mul"][1] * 100, 1),
        "dec_gbps": round(dec_gbps, 1),
        "dec_spread_pct": round(res["dec"][1] * 100, 1),
        "enc_b_per_s": round(enc_rate, 3),
        "enc_spread_pct": round(aux["enc"][1] * 100, 1),
        "perm_gbps": round(perm_gbps, 1),
        "perm_spread_pct": round(aux["perm"][1] * 100, 1),
        "serve_speedup": round(t_loop / t_batch, 2),
        "serve_loop_ms": round(t_loop * 1e3, 2),
        "serve_batch_ms": round(t_batch * 1e3, 2),
        "serve_spread_pct": round(serve_spread * 100, 1),
        "aes_fleet_blocks_per_s": round(aes_bps, 2),
    }))


if __name__ == "__main__":
    main()
