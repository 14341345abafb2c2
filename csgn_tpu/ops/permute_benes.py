"""Permutation as a Beneš network of word-parallel delta swaps.

The gather path (`core.permute_chunks`) unpacks to a byte-per-bit tensor —
8-32x traffic amplification.  This module stays in the packed uint32 domain:
any permutation of N = 2^m bit positions decomposes into 2m-1 "delta swap"
stages (deltas 1, 2, ..., N/2, ..., 2, 1), each a masked exchange of bit
pairs at distance delta:

  * delta < 32: in-word —  t = (X ^ (X << delta)) & M;  X ^= t ^ (t >> delta)
  * delta >= 32: across words at the same in-word shift — row rolls + mask.

Every stage is a handful of elementwise uint32 ops over the whole [Wp, C]
tensor; XLA fuses the 21 stages into a few bandwidth-bound passes.  Routing
(control-bit computation) runs once per permutation on the host in
O(N log N) (the classic looping algorithm) and is cached on the Permutation
object by callers.

Semantics: `apply_benes(X, plan)` computes out bit i = in bit perm[i] for
every chunk — identical to `core.permute_chunks` (tests enforce equality).
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

__all__ = [
    "BenesPlan",
    "StackedPlans",
    "build_plan",
    "apply_benes",
    "apply_benes_batch",
    "stack_plans",
]


def _route(perm: np.ndarray) -> list[tuple[int, np.ndarray]]:
    """Beneš looping algorithm: stage list [(delta, swap_mask_bool[N])].

    `perm` is gather form: out[i] = in[perm[i]].  A stage's mask marks
    positions i (with (i & delta) == 0) whose pair (i, i+delta) swaps.
    """
    n = len(perm)
    assert n & (n - 1) == 0
    if n == 1:
        return []
    if n == 2:
        return [(1, np.array([perm[0] == 1, False]))]

    inv = np.argsort(perm)
    m = n // 2
    halves = np.full(n, -1, dtype=np.int8)  # which half each OUTPUT rides

    for start in range(n):
        if halves[start] != -1:
            continue
        p, h = start, 0
        while halves[p] == -1:
            halves[p] = h
            halves[p ^ 1] = 1 - h
            # the element feeding out[p^1] travels in half 1-h; its input
            # partner must take half h, surfacing at output inv[source^1].
            src = perm[p ^ 1]
            p = int(inv[src ^ 1])
            # h stays: that output must ride half h.

    pair_idx = np.arange(m)
    lcontrol = halves[2 * pair_idx] != 0            # swap at output pair i
    fcontrol = halves[inv[2 * pair_idx]] != 0       # swap at input pair j

    # Sub-permutations realized by the inner networks (top = even slots).
    out_slot_top = 2 * pair_idx + lcontrol.astype(int)
    out_slot_bot = 2 * pair_idx + (1 - lcontrol.astype(int))
    top = perm[out_slot_top] // 2
    bot = perm[out_slot_bot] // 2

    first_mask = np.zeros(n, dtype=bool)
    first_mask[2 * pair_idx[fcontrol]] = True
    last_mask = np.zeros(n, dtype=bool)
    last_mask[2 * pair_idx[lcontrol]] = True

    sub_top = _route(top)
    sub_bot = _route(bot)
    mid = []
    for (dt, mt), (db, mb) in zip(sub_top, sub_bot):
        assert dt == db
        mask = np.zeros(n, dtype=bool)
        mask[0::2] = mt
        mask[1::2] = mb
        mid.append((2 * dt, mask))
    return [(1, first_mask)] + mid + [(1, last_mask)]


def _pack_mask(mask: np.ndarray, wp: int) -> np.ndarray:
    """bool[N] -> uint32[wp] in the MSB-first layout."""
    n = len(mask)
    out = np.zeros(wp, dtype=np.uint32)
    idx = np.nonzero(mask)[0]
    np.bitwise_or.at(out, idx // 32, (np.uint32(1) << (31 - idx % 32).astype(np.uint32)))
    return out


@dataclasses.dataclass(frozen=True)
class BenesPlan:
    """Precomputed routing for one permutation: per-stage (delta, packed mask).

    `rows` is the number of leading word-rows each stage must process (a
    multiple of 8, ≤ words_pad): payload bits enter the padded network in the
    first ceil(n/32) words and can only spread by the stage's word radius per
    cross-word stage (symmetrically contracting toward the output).  Mask
    bits outside the payload reach are zeroed at build time — those switches
    only ever exchanged zero padding, so dropping them is value-neutral (at
    n=1247 only 39 of 64 padded words carry payload at the network edges).
    """

    n: int                      # logical bit count
    n_pad: int                  # power-of-two network size
    deltas: tuple[int, ...]
    masks: np.ndarray           # uint32[stages, n_pad/32]
    rows: tuple[int, ...] = ()  # per-stage processed row count (8-aligned)

    @property
    def words_pad(self) -> int:
        return self.n_pad // 32


def _payload_rows(n: int, n_pad: int, deltas: tuple[int, ...]) -> tuple[np.ndarray, np.ndarray]:
    """Per-stage payload-row bounds.

    Returns (pb, rows): pb[s] = bound on word-rows that may hold payload
    BEFORE stage s (mask rows ≥ pb[s] are value-neutral and get zeroed);
    rows[s] = 8-aligned row count stage s can touch (pb + roll radius).
    """
    wp = n_pad // 32
    w_pay = -(-n // 32)
    s_cnt = len(deltas)
    radii = [0 if d < 32 else d // 32 for d in deltas]
    fwd = np.empty(s_cnt + 1, np.int64)
    fwd[0] = w_pay
    for s, r in enumerate(radii):
        fwd[s + 1] = min(wp, fwd[s] + r)
    bwd = np.empty(s_cnt + 1, np.int64)
    bwd[s_cnt] = w_pay
    for s in range(s_cnt - 1, -1, -1):
        bwd[s] = min(wp, bwd[s + 1] + radii[s])
    pb = np.minimum(fwd[:-1], bwd[:-1])
    rows = np.minimum(wp, -(-(pb + radii) // 8) * 8)
    return pb, rows


def build_plan(perm: np.ndarray, n: int) -> BenesPlan:
    """Route `perm` (gather form, length n) into a delta-swap plan."""
    perm = np.asarray(perm, dtype=np.int64)
    n_pad = 1 << max(5, int(np.ceil(np.log2(max(n, 2)))))
    full = np.concatenate([perm, np.arange(n, n_pad)])  # identity on padding
    stages = _route(full)
    wp = n_pad // 32
    deltas = tuple(int(d) for d, _ in stages)
    masks = np.stack([_pack_mask(m, wp) for _, m in stages])
    pb, rows = _payload_rows(n, n_pad, deltas)
    for s in range(len(deltas)):
        masks[s, pb[s]:] = 0  # value-neutral switches beyond payload reach
    return BenesPlan(n=n, n_pad=n_pad, deltas=deltas, masks=masks,
                     rows=tuple(int(r) for r in rows))


def apply_benes(words: jax.Array, plan: BenesPlan) -> jax.Array:
    """Apply the planned permutation to packed chunks uint32[..., W, C].

    W may differ from the network's word count: smaller W zero-pads the rows
    and slices back (padding bits are zero and identity-routed); larger W
    (n < 32 contexts, where words32 = 2 > words_pad = 1) drops the trailing
    rows through the network — they hold bits >= n_pad >= n, zero in
    canonical form — and restores them as zeros.  Canonical form is
    preserved either way.
    """
    w = words.shape[-2]
    wp = plan.words_pad
    x = jnp.asarray(words).astype(jnp.uint32)
    if wp > w:
        pad = [(0, 0)] * (x.ndim - 2) + [(0, wp - w), (0, 0)]
        x = jnp.pad(x, pad)
    elif wp < w:
        x = x[..., :wp, :]

    for delta, mask in zip(plan.deltas, plan.masks):
        if isinstance(mask, np.ndarray) and not mask.any():
            # All-zero mask = identity stage: free skip for structured perms.
            # (Guarded: dispatch.permute_decrypt traces masks as jit args.)
            continue
        m = jnp.asarray(mask)[..., :, None]
        if delta < 32:
            d = jnp.uint32(delta)
            t = (x ^ (x << d)) & m
            x = x ^ t ^ (t >> d)
        else:
            r = delta // 32
            t = (x ^ jnp.roll(x, -r, axis=-2)) & m
            x = x ^ t ^ jnp.roll(t, r, axis=-2)

    if wp < w:  # restore the dropped (canonical-zero) trailing rows
        pad = [(0, 0)] * (x.ndim - 2) + [(0, w - wp), (0, 0)]
        return jnp.pad(x, pad)
    return x[..., :w, :]


@dataclasses.dataclass(frozen=True)
class StackedPlans:
    """k same-size Beneš plans as one tensor: all networks on the same n_pad
    share the delta schedule AND the live row windows (both derive from
    (n, n_pad, deltas) only — see `_payload_rows`); only the per-stage masks
    differ, so k permutations batch into ``masks uint32[k, S, WP]``."""

    n: int
    n_pad: int
    deltas: tuple[int, ...]
    masks: np.ndarray           # uint32[k, stages, n_pad/32]
    rows: tuple[int, ...]

    @property
    def k(self) -> int:
        return self.masks.shape[0]

    @property
    def words_pad(self) -> int:
        return self.n_pad // 32


def stack_plans(plans: list[BenesPlan]) -> StackedPlans:
    """Stack k same-(n, n_pad) plans into a `StackedPlans`."""
    if not plans:
        raise ValueError("no plans")
    p0 = plans[0]
    for p in plans[1:]:
        if p.n_pad != p0.n_pad or p.n != p0.n:
            raise ValueError("plans must share n and n_pad")
    rows = p0.rows if len(p0.rows) == len(p0.deltas) else (p0.words_pad,) * len(p0.deltas)
    return StackedPlans(
        n=p0.n, n_pad=p0.n_pad, deltas=p0.deltas,
        masks=np.stack([p.masks for p in plans]), rows=rows,
    )


def apply_benes_batch(words: jax.Array, stacked: StackedPlans) -> jax.Array:
    """Apply k DIFFERENT permutations to k ciphertexts in one computation
    (XLA delta-swap path; each stage materializes to HBM).

    words: uint32[k, W, C]; batch element i gets permutation i — the
    key-rotation-fleet pattern (e.g. re-randomizing many ciphertexts under
    distinct transforms at once).
    """
    k, w, c = words.shape
    wp = stacked.words_pad
    x = jnp.asarray(words).astype(jnp.uint32)
    if wp > w:
        x = jnp.pad(x, ((0, 0), (0, wp - w), (0, 0)))
    elif wp < w:  # n < 32: trailing rows are canonical-zero (see apply_benes)
        x = x[:, :wp, :]
    m_all = jnp.asarray(stacked.masks)

    for s, delta in enumerate(stacked.deltas):
        if isinstance(stacked.masks, np.ndarray) and not stacked.masks[:, s].any():
            continue  # identity stage across ALL k plans
        m = m_all[:, s, :, None]                      # [k, WP, 1]
        if delta < 32:
            d = jnp.uint32(delta)
            t = (x ^ (x << d)) & m
            x = x ^ t ^ (t >> d)
        else:
            r = delta // 32
            t = (x ^ jnp.roll(x, -r, axis=-2)) & m
            x = x ^ t ^ jnp.roll(t, r, axis=-2)
    if wp < w:
        return jnp.pad(x, ((0, 0), (0, w - wp), (0, 0)))
    return x[:, :w, :]
