"""Hostile decision windows shared by the port's kernel tests
(test_torch_fused.py, test_torch_lane_header.py, test_torch_card.py),
and the host build of the window kernel both kernel test files replay
them on (`host_shim`, `host_window`).

The generator is the shape of test_pallas_fused.py's: duplicate-key
segments with uniform per-segment params, degenerate params (zero
emission, zero/negative/huge tolerance, quantity-0 probes) when asked,
invalid lanes, and saturating-scale values.  Inputs are numpy, made from
a seed, so the JAX package and the port see the same bytes.
"""

import ctypes
import shutil
import subprocess
from pathlib import Path

import numpy as np

_TIER = {False: 0, True: 1, "cur": 2, "w32": 3}  # gcra_lane.cuh TIER_*

NS = 1_000_000_000
T0 = 1_753_700_000 * NS
EMPTY_EXPIRY = -(1 << 63)

# (compact, with_degen) pairs the kernel serves: cur/w32 only exist on
# the certified path.
TIERS = [
    (False, True), (True, True), (True, False), ("cur", False),
    ("w32", False),
]
# All six, one per kernel instantiation at each row width.
ALL_TIERS = TIERS + [(False, False)]


def fresh_state(rows, width):
    """i32[rows, width] empty table rows (TAT 0, expiry EMPTY_EXPIRY)."""
    st = np.zeros((rows, width), np.int32)
    st[:, 3] = np.int32(-(1 << 31))  # expiry hi word of i64::MIN; lo 0
    return st


def segments(slots, valid):
    """Duplicate-key structure of one sub-batch: (rank, is_last, first)
    per lane, `first` the lane opening its segment.  Invalid lanes are
    segments of their own (rank 0, is_last)."""
    n = len(slots)
    lane = np.arange(n)
    key = np.where(valid, slots.astype(np.int64), -1 - lane)
    order = np.argsort(key, kind="stable")
    sk = key[order]
    start = np.r_[True, sk[1:] != sk[:-1]]
    run_start = np.maximum.accumulate(np.where(start, lane, 0))
    rank = np.empty(n, np.int32)
    rank[order] = lane - run_start
    is_last = np.empty(n, bool)
    is_last[order] = np.r_[sk[1:] != sk[:-1], True]
    first = np.empty(n, np.int64)
    first[order] = order[run_start]
    return rank, is_last, first


def rand_window(rng, K, B, cap, degen, slots=None, valid=None):
    """A hostile packed window: (packed i32[K, B, 9], now i64[K],
    valid bool[K, B]); `slots` i32[K, B] replaces the uniform draw, and
    `valid` bool[K, B] the 90 % draw."""
    from throttlecrab_tpu_torch.tpu.kernel import pack_requests

    drawn = rng.integers(0, cap, (K, B)).astype(np.int32)
    slots = drawn if slots is None else np.asarray(slots, np.int32)
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
    drawn_valid = rng.random((K, B)) < 0.9
    valid = drawn_valid if valid is None else np.asarray(valid, bool)
    rank = np.zeros((K, B), np.int32)
    is_last = np.ones((K, B), bool)
    for k in range(K):
        rank[k], is_last[k], first = segments(slots[k], valid[k])
        # uniform params per segment
        em[k], tol[k], q[k] = em[k][first], tol[k][first], q[k][first]
    now = T0 + np.sort(rng.integers(0, 100 * NS, K)).astype(np.int64)
    return pack_requests(slots, rank, is_last, em, tol, q, valid), now, valid


def cross_block_windows(rng, K, B, cap, degen):
    """Two windows whose segments cross the kernel's blocks: every lane of
    every sub-batch on one slot, and one slot recurring in every
    sub-batch at lanes 0 and B-1 (the other lanes elsewhere)."""
    hot = int(rng.integers(0, cap))
    edge = rng.integers(0, cap, (K, B))
    edge[edge == hot] = (hot + 1) % cap
    edge[:, 0] = edge[:, -1] = hot
    return [
        rand_window(rng, K, B, cap, degen, slots=s)
        for s in (np.full((K, B), hot), edge)
    ]


def out_mask(valid, compact):
    """Valid lanes of an output of tier `compact` (invalid lanes are
    don't-care in every tier)."""
    return valid if compact in ("cur", "w32") else valid[:, None, :]


def byid_words(ids, slots):
    """tk_assemble_ids request words (i64[K, B]) for raw ids i32[K, B]
    against id rows with slots `slots`: segments per slot in arrival
    order; padding (negative ids) has the valid bit clear."""
    ids = np.asarray(ids, np.int64)
    words = ids & 0xFFFFFFFF
    for k in range(ids.shape[0]):
        valid = ids[k] >= 0
        slot = np.asarray(slots, np.int64)[np.clip(ids[k], 0, len(slots) - 1)]
        # + 1: an unresolved slot (-1) is a key of its own, apart from
        # segments()'s negative keys for invalid lanes.
        rank, is_last, _ = segments(slot + 1, valid)
        meta = rank.astype(np.int64) | (is_last << 14) | (1 << 15)
        words[k] |= np.where(valid, meta << 32, 0)
    return words


def host_shim(out_dir):
    """The host build of the window kernel (csrc/lane_host.cpp over
    gcra_lane.cuh, g++, seconds) in `out_dir`, bound with ctypes; None
    where g++ is missing."""
    from throttlecrab_tpu_torch.tpu.nvcc import CSRC

    gxx = shutil.which("g++")
    if gxx is None:
        return None
    out = Path(out_dir) / "liblane_host.so"
    subprocess.run(
        [gxx, "-O2", "-std=c++17", "-shared", "-fPIC", "-Wall", "-Werror",
         "-I", str(CSRC), "-o", str(out), str(CSRC / "lane_host.cpp")],
        check=True, capture_output=True, text=True,
    )
    lib = ctypes.CDLL(str(out))
    p = ctypes.c_void_p
    args = [
        p, ctypes.c_longlong, ctypes.c_int, p, p, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, p, p, p, ctypes.c_uint,
    ]
    for fn in (lib.tc_host_window, lib.tc_host_window_tiny_owner):
        fn.argtypes = args + [p]
        fn.restype = ctypes.c_int
    lib.tc_host_cluster_window.argtypes = args
    lib.tc_host_cluster_window.restype = ctypes.c_int
    lib.tc_host_geometry.argtypes = [ctypes.c_int, ctypes.c_int, p]
    lib.tc_host_geometry.restype = None
    lib.tc_host_one_block.argtypes = [ctypes.c_int]
    lib.tc_host_one_block.restype = ctypes.c_int
    return lib


def host_window(lib, state, packed, now, width, compact, with_degen,
                visits=None, seed=0, forwarded=None, cluster=False,
                tiny_owner=False):
    """Run the C++ window in place on numpy `state`; (out, n_exp).
    `visits` (i32[K, 2, B] zeros) collects each lane's decides and
    scatters, `forwarded` (i64[1]) gains the forwarded lanes; `cluster`
    replays the cluster schedule whatever the width, `tiny_owner` the
    one-block schedule with 4-bucket owner tables (most lookups scan)."""
    K, B = packed.shape[:2]
    if compact in ("cur", "w32"):
        out = np.zeros((K, B), np.int64 if compact == "cur" else np.int32)
    else:
        out = np.zeros((K, 4, B), np.int32 if compact else np.int64)
    n_exp = np.zeros(K, np.int64)
    packed = np.ascontiguousarray(packed)
    now = np.ascontiguousarray(now)
    args = (
        state.ctypes.data, state.shape[0], width, packed.ctypes.data,
        now.ctypes.data, K, B, int(with_degen), _TIER[compact],
        out.ctypes.data, n_exp.ctypes.data,
        None if visits is None else visits.ctypes.data, seed,
    )
    if cluster:
        rc = lib.tc_host_cluster_window(*args)
    else:
        fn = lib.tc_host_window_tiny_owner if tiny_owner else lib.tc_host_window
        rc = fn(*args, None if forwarded is None else forwarded.ctypes.data)
    assert rc == 0
    return out, n_exp


def forwarded_count(packed, N):
    """Lanes of rounds k >= 1 whose gathered row round k-1 wrote: a valid
    is_last lane's slot or a lane's scratch row N - B + i (numpy)."""
    from throttlecrab_tpu_torch.tpu.kernel import (
        PACK_FLAG_IS_LAST,
        PACK_FLAG_VALID,
    )

    K, B = packed.shape[:2]
    slot = np.clip(packed[..., 0].astype(np.int64), 0, N - 1)
    flags = packed[..., 2]
    writes_slot = ((flags & PACK_FLAG_IS_LAST) != 0) & (
        (flags & PACK_FLAG_VALID) != 0)
    target = np.where(writes_slot, slot, N - B + np.arange(B))
    return sum(int(np.isin(slot[k], target[k - 1]).sum())
               for k in range(1, K))
