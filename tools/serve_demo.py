"""Serving-executor demo: correctness + dispatch-amortization measurement.

Runs on the default backend.  Asserts the `BatchExecutor` results bit-equal
the unbatched ops, then times a fleet of 32 independent fused
multiply+decrypt requests two ways: a per-request dispatch loop (the
reference's one-op-per-call pattern, tests/timings.cpp:26-42) vs one
executor flush.  The win is dispatch amortization, so it scales with fleet
size.

Usage: PYTHONPATH=. python tools/serve_demo.py   (from the repository root)
"""

import time

import jax
import numpy as np

from csgn_tpu import BatchExecutor, Context, Permutation, SecretKey

print("backend:", jax.default_backend())
ctx = Context(1247, 16)
keys = jax.random.split(jax.random.key(11), 256)
sk = SecretKey.generate(ctx, keys[0])

N = 32
bits_a = [1] * N
bits_b = [(i % 2) for i in range(N)]
a = [sk.encrypt(b, keys[2 + i]) for i, b in enumerate(bits_a)]
b = [sk.encrypt(v, keys[64 + i]) for i, v in enumerate(bits_b)]
# grow operands so requests are not the trivial 1x1 AND
ga = [x + y for x, y in zip(a, b)]          # 2 chunks, parity 1^bit
gb = [y + x for x, y in zip(a, b)]

# --- correctness: executor vs unbatched, on chip ---
ex = BatchExecutor(sk, rng=jax.random.key(77))
enc_f = [ex.submit_encrypt(v) for v in bits_b]
md_f = [ex.submit_mul_decrypt(x, y) for x, y in zip(ga, gb)]
rng = np.random.default_rng(1)
perms = [Permutation(np.asarray(rng.permutation(ctx.n), dtype=np.int32)) for _ in range(8)]
pm_f = [ex.submit_permute(a[i], perms[i]) for i in range(8)]
ex.flush()
got_enc = [int(sk.decrypt(f.result())) for f in enc_f]
assert got_enc == bits_b, got_enc
assert 1 in got_enc  # at least one decrypt == 1
for x, y, f in zip(ga, gb, md_f):
    prod, bit = f.result()
    want = int(sk.decrypt(x * y))
    assert bit == want and int(sk.decrypt(prod)) == want
for i, f in enumerate(pm_f):
    want = a[i].apply_permutation(perms[i]).to_u64().tobytes()
    assert f.result().to_u64().tobytes() == want
print("correctness: enc/mul_decrypt/permute batched == unbatched OK")
print("group dispatches for", ex.stats["requests"], "requests:",
      ex.stats["group_dispatches"])

# --- latency: per-request dispatch vs one batched flush ---
def timed(fn):
    t0 = time.perf_counter(); out = fn(); t1 = time.perf_counter()
    return out, t1 - t0

# warm both paths (compile cache)
sk.mul_and_decrypt(ga[0], gb[0])
ex2 = BatchExecutor(sk, rng=jax.random.key(78))
_ = [ex2.submit_mul_decrypt(x, y) for x, y in zip(ga[:2], gb[:2])]
ex2.flush()

for trial in range(3):
    def per_request():
        return [int(sk.mul_and_decrypt(x, y)[1]) for x, y in zip(ga, gb)]
    seq_bits, t_seq = timed(per_request)

    def batched():
        ex3 = BatchExecutor(sk, rng=jax.random.key(100 + trial))
        fs = [ex3.submit_mul_decrypt(x, y) for x, y in zip(ga, gb)]
        ex3.flush()
        return [f.result()[1] for f in fs]
    bat_bits, t_bat = timed(batched)
    assert seq_bits == bat_bits
    print(f"trial {trial}: {N} mul_decrypt requests  per-request {t_seq*1e3:7.1f} ms"
          f"  batched {t_bat*1e3:7.1f} ms  speedup {t_seq/t_bat:5.1f}x")
print("VERIFY SERVE: ALL OK")
