"""Private-comparison service: netlists + the serving executor together.

A sealed-bid setting: each client encrypts its bid bit-by-bit; an untrusted
server evaluates a standard Bristol-Fashion comparator netlist over every
encrypted bid against an encrypted reserve price — with NO key and NO device
growth (the `eval_expr` path builds +/* DAGs, deferring all chunk growth);
the auctioneer decrypts each one-output DAG in O(leaves) with
`decrypt_circuit`.

The serving layer does the encryption fleet: `BatchExecutor` groups all
bids × width bit-encrypts into ONE batched dispatch instead of one
dispatch per bit.

Run: python examples/netlist_service.py [--bidders 8] [--width 16]
"""

from __future__ import annotations

import argparse


def main(bidders: int = 8, width: int = 16, n: int = 95, d: int = 4, seed: int = 0) -> dict:
    import jax
    import numpy as np

    from csgn_tpu import BatchExecutor, Context, SecretKey
    from csgn_tpu.models import comparator_gt
    from csgn_tpu.models.netlist import eval_expr, eval_plain

    ctx = Context(n, d)
    k_key, k_enc, k_bids = jax.random.split(jax.random.key(seed), 3)
    sk = SecretKey.generate(ctx, k_key)

    rng = np.random.default_rng(int(jax.random.randint(k_bids, (), 0, 2**31 - 1)))
    bids = rng.integers(0, 1 << width, size=bidders)
    reserve = int(rng.integers(0, 1 << width))

    def bits(x: int) -> list[int]:
        return [(x >> i) & 1 for i in range(width)]

    # --- clients + auctioneer: encrypt every bid bit in ONE batched dispatch
    ex = BatchExecutor(sk, rng=k_enc)
    bid_futs = [[ex.submit_encrypt(b) for b in bits(int(v))] for v in bids]
    reserve_futs = [ex.submit_encrypt(b) for b in bits(reserve)]
    one_fut = ex.submit_encrypt(1)
    ex.flush()
    assert ex.stats["group_dispatches"] == 1, ex.stats
    enc_bids = [[f.result() for f in row] for row in bid_futs]
    enc_reserve = [f.result() for f in reserve_futs]
    one = one_fut.result()

    # --- untrusted server: evaluate the comparator netlist per bid (no key;
    # no growth — the expr path never materializes the AND chains)
    netlist = comparator_gt(width)
    exprs = [eval_expr(netlist, [eb, enc_reserve], one)[0][0] for eb in enc_bids]

    # --- auctioneer: all bids' DAGs share the reserve leaves — one batched
    # leaf decrypt for the whole auction (decrypt_circuits, r5)
    qualified = [int(v) for v in sk.decrypt_circuits(exprs)]

    want = [int(v > reserve) for v in bids]
    assert qualified == want, (bids.tolist(), reserve, qualified, want)
    plain = [eval_plain(netlist, [bits(int(v)), bits(reserve)])[0][0] for v in bids]
    assert plain == want
    return {
        "bidders": bidders,
        "reserve": reserve,
        "qualified": qualified,
        "encrypt_dispatches": ex.stats["group_dispatches"],
        "and_gates": netlist.and_count,
    }


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--bidders", type=int, default=8)
    ap.add_argument("--width", type=int, default=16)
    ap.add_argument("--n", type=int, default=95)
    ap.add_argument("--d", type=int, default=4)
    args = ap.parse_args()
    out = main(args.bidders, args.width, args.n, args.d)
    print(out)
