"""Key-rotation fleet: B ciphertexts re-keyed under B DISTINCT permutations.

The permutation transform is CSGN's key-rotation primitive: π moves a
ciphertext from key k to key π(k) without decrypting
(Dec_{π(k)}(π(c)) = Dec_k(c), reference src/SecretKey.cpp:232-259).  A
serving fleet rotating many clients' keys at once applies a DIFFERENT π to
every ciphertext — ONE dispatch over the whole batch
(`CiphertextBatch.apply_permutations`: all Beneš plans share the delta
schedule, so the k plans stack into one mask tensor).

Flow: encrypt a fleet under one key -> grow each ciphertext (a mul step)
-> rotate every element under its own permutation -> each client decrypts
under its own rotated key.

Run: python examples/key_rotation.py [--fleet 8] [--n 1247] [--d 16]
"""

from __future__ import annotations

import argparse

import numpy as np


def main(fleet: int = 8, n: int = 1247, d: int = 16, seed: int = 0) -> dict:
    import jax
    import jax.numpy as jnp

    from csgn_tpu import Context, Permutation, SecretKey
    from csgn_tpu.batch import CiphertextBatch

    ctx = Context(n, d)
    keys = jax.random.split(jax.random.key(seed), 3 + fleet)
    sk = SecretKey.generate(ctx, keys[0])

    # Fleet of fresh ciphertexts (one batched dispatch), grown by one
    # homomorphic multiply so the rotation runs on multi-chunk payloads.
    rng = np.random.default_rng(seed)
    bits = jnp.asarray(rng.integers(0, 2, fleet, dtype=np.uint8))
    other = jnp.asarray(np.ones(fleet, np.uint8))  # AND with 1: bit-preserving
    batch = CiphertextBatch.from_fresh(sk.encrypt_batch(bits, keys[1]), ctx)
    batch = batch + CiphertextBatch.from_fresh(sk.encrypt_batch(other, keys[2]), ctx)
    grown = batch * batch  # 4 chunks/element: (b ^ 1)^2 = b ^ 1

    # One rotation per element, all in one fused kernel dispatch.
    perms = [Permutation.random(ctx, keys[3 + i]) for i in range(fleet)]
    rotated = grown.apply_permutations(perms)

    # Every client decrypts under its own rotated key.
    decs = []
    for i in range(fleet):
        client_key = sk.apply_permutation(perms[i])
        decs.append(int(client_key.decrypt(rotated[i])))
    want = [int(b) ^ 1 for b in np.asarray(bits)]
    assert decs == want, (decs, want)

    print(f"fleet={fleet}: rotated under {fleet} distinct permutations, "
          f"all client decrypts correct")
    return {"fleet": fleet, "decrypted": decs, "expected": want}


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--fleet", type=int, default=8)
    ap.add_argument("--n", type=int, default=1247)
    ap.add_argument("--d", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    a = ap.parse_args()
    main(a.fleet, a.n, a.d, a.seed)
