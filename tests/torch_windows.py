"""Hostile decision windows shared by the port's kernel tests
(test_torch_fused.py, test_torch_lane_header.py).

The generator is the shape of test_pallas_fused.py's: duplicate-key
segments with uniform per-segment params, degenerate params (zero
emission, zero/negative/huge tolerance, quantity-0 probes) when asked,
invalid lanes, and saturating-scale values.  Inputs are numpy, made from
a seed, so the JAX package and the port see the same bytes.
"""

import numpy as np

NS = 1_000_000_000
T0 = 1_753_700_000 * NS
EMPTY_EXPIRY = -(1 << 63)

# (compact, with_degen) pairs the kernel serves: cur/w32 only exist on
# the certified path.
TIERS = [
    (False, True), (True, True), (True, False), ("cur", False),
    ("w32", False),
]


def fresh_state(rows, width):
    """i32[rows, width] empty table rows (TAT 0, expiry EMPTY_EXPIRY)."""
    st = np.zeros((rows, width), np.int32)
    st[:, 3] = np.int32(-(1 << 31))  # expiry hi word of i64::MIN; lo 0
    return st


def rand_window(rng, K, B, cap, degen):
    """A hostile packed window: (packed i32[K, B, 9], now i64[K],
    valid bool[K, B])."""
    from throttlecrab_tpu_torch.tpu.kernel import pack_requests

    slots = rng.integers(0, cap, (K, B)).astype(np.int32)
    em = rng.choice([0, 1, 1000, NS, 7 * NS, 1 << 62], (K, B)).astype(
        np.int64
    )
    tol = rng.choice(
        [0, 5, NS, 100 * NS, (1 << 61) + 7, -(3 * NS)], (K, B)
    ).astype(np.int64)
    q = rng.choice([0, 1, 2, 50], (K, B)).astype(np.int64)
    if not degen:
        em = np.maximum(em % (10 * NS), 1)
        tol = np.abs(tol) % (100 * NS) + 1
        q = np.maximum(q, 1)
    valid = rng.random((K, B)) < 0.9
    rank = np.zeros((K, B), np.int32)
    is_last = np.ones((K, B), bool)
    for k in range(K):
        first: dict = {}
        seen: dict = {}
        for i in range(B):
            if not valid[k, i]:
                continue
            s = int(slots[k, i])
            if s in seen:
                cnt, last = seen[s]
                rank[k, i] = cnt
                is_last[k, last] = False
                seen[s] = (cnt + 1, i)
                j = first[s]  # uniform params per segment
                em[k, i], tol[k, i], q[k, i] = em[k, j], tol[k, j], q[k, j]
            else:
                seen[s] = (1, i)
                first[s] = i
    now = T0 + np.sort(rng.integers(0, 100 * NS, K)).astype(np.int64)
    return pack_requests(slots, rank, is_last, em, tol, q, valid), now, valid


def out_mask(valid, compact):
    """Valid lanes of an output of tier `compact` (invalid lanes are
    don't-care in every tier)."""
    return valid if compact in ("cur", "w32") else valid[:, None, :]
