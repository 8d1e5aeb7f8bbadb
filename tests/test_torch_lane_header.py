"""The CUDA kernel's own arithmetic and schedule, checked on the CPU.

`csrc/gcra_lane.cuh` is the per-lane body and the launch geometry of the
decision-window kernel, written once as `__host__ __device__` inline
C++.  This file compiles it with g++ through the host shim
`csrc/lane_host.cpp` (plain C interface, no torch headers: seconds to
build), which replays the kernel's schedule — its blocks and threads in
reversed or shuffled order inside each phase, the phases in barrier
order — and holds the C++ window against the port's plain version on the
hostile windows of test_torch_fused.py: every tier, both widths, state
carried across windows, batches from 1 lane to the 65,536 the table's
scratch tail allows.  Exact equality.

Batches of at most 256 lanes take the kernel's one-block schedule, which
gathers a round's rows before the previous round scatters and forwards
that round's writes through shared memory; its replay is held to the
plain version and, table and scratch rows whole, to the cluster
schedule's replay of the same windows, on windows built to forward
(every lane of a round on the slots the round before wrote, a slot
skipping a round, duplicate segments, invalid lanes), with its
forwarded-lane count against a count from the packed rows.
"""

import numpy as np
import pytest
import torch

from throttlecrab_tpu_torch.tpu import kernel
from torch_windows import (
    ALL_TIERS,
    NS,
    cross_block_windows,
    forwarded_count,
    fresh_state,
    host_shim,
    host_window,
    out_mask,
    rand_window,
)

SMEM_LIMIT = 227 * 1024  # bytes of shared memory a Hopper block may use


@pytest.fixture(scope="module")
def lane_lib(tmp_path_factory):
    lib = host_shim(tmp_path_factory.mktemp("lane"))
    if lib is None:
        pytest.skip("g++ is not installed: the lane header cannot be built")
    return lib


def _geometry(lib, B, width):
    """(blocks, threads, lanes per thread, shared bytes, cluster limit,
    shared-memory limit) of the kernel's launch for B lanes."""
    g = np.zeros(6, np.int32)
    lib.tc_host_geometry(B, width, g.ctypes.data)
    return tuple(int(x) for x in g)



@pytest.mark.parametrize("width", [4, 6])
@pytest.mark.parametrize("compact,with_degen", ALL_TIERS)
@pytest.mark.parametrize("K,B,cap", [(2, 16, 32), (3, 48, 64), (1, 4, 64)])
def test_lane_header_matches_plain_version(
    lane_lib, width, compact, with_degen, K, B, cap
):
    rng = np.random.default_rng(1000 * width + 10 * K + B)
    N = cap + B
    st_h = fresh_state(N, width)
    st_t = torch.from_numpy(fresh_state(N, width))
    for step in range(3):
        packed, now, valid = rand_window(rng, K, B, cap, with_degen)
        now = now + step * 200 * NS
        out_h, ne_h = host_window(
            lane_lib, st_h, packed, now, width, compact, with_degen,
            seed=step,
        )
        out_t, ne_t = kernel.decide_window(
            st_t, torch.from_numpy(packed), torch.from_numpy(now),
            with_degen=with_degen, compact=compact,
        )
        bad = (out_h != out_t.numpy()) & out_mask(valid, compact)
        assert not bad.any(), np.argwhere(bad)[:4]
        assert (st_h[:cap] == st_t.numpy()[:cap]).all()
        assert (ne_h == ne_t.numpy()).all()


@pytest.mark.parametrize("width", [4, 6])
@pytest.mark.parametrize("B", [1, 255, 256, 511, 512, 4096, 4097, 65535,
                               65536])
def test_launch_geometry_fits_the_card(lane_lib, B, width):
    """One cluster covers every lane of the batch, within the portable
    cluster size and a block's shared memory, and no block is idle."""
    blocks, threads, lanes, smem, cluster_max, smem_max = _geometry(
        lane_lib, B, width)
    assert cluster_max == 16 and smem_max == SMEM_LIMIT
    assert 1 <= blocks <= cluster_max and blocks & (blocks - 1) == 0
    assert blocks * threads * lanes >= B
    assert (blocks // 2) * threads * lanes < B or blocks == 1
    assert lanes == 1 or blocks * threads * (lanes - 1) < B
    assert smem == lanes * threads * width * 4 <= smem_max


# Batch widths at the edges of the geometry: one lane, one partial
# block, one lane past a full cluster (a second round per thread), and
# the largest batch (16 rounds).
_SCHEDULE_CASES = [
    (1, 6, 4, ALL_TIERS[0]), (255, 3, 6, ALL_TIERS[1]),
    (4097, 2, 4, ALL_TIERS[2]), (4097, 2, 6, ALL_TIERS[5]),
    (65536, 1, 6, ALL_TIERS[3]), (65536, 1, 4, ALL_TIERS[4]),
]


@pytest.mark.parametrize("B,K,width,tier", _SCHEDULE_CASES)
def test_schedule_decides_and_scatters_every_lane_once(
    lane_lib, B, K, width, tier
):
    """The kernel's schedule, replayed with blocks and threads out of
    order: each lane decided and scattered exactly once per sub-batch,
    and the window identical to the plain version on random and
    cross-block windows (one slot over every lane; one slot at lanes 0
    and B-1 of every sub-batch)."""
    compact, with_degen = tier
    rng = np.random.default_rng(B + width)
    cap = max(2 * B, 64)
    N = cap + B
    st_h = fresh_state(N, width)
    st_t = torch.from_numpy(fresh_state(N, width))
    windows = [rand_window(rng, K, B, cap, with_degen)]
    windows += cross_block_windows(rng, K, B, cap, with_degen)
    for step, (packed, now, valid) in enumerate(windows):
        now = now + step * 200 * NS
        visits = np.zeros((K, 2, B), np.int32)
        out_h, ne_h = host_window(
            lane_lib, st_h, packed, now, width, compact, with_degen,
            visits=visits, seed=7 + step,
        )
        assert (visits == 1).all()
        out_t, ne_t = kernel.decide_window(
            st_t, torch.from_numpy(packed), torch.from_numpy(now),
            with_degen=with_degen, compact=compact,
        )
        bad = (out_h != out_t.numpy()) & out_mask(valid, compact)
        assert not bad.any(), np.argwhere(bad)[:4]
        assert (st_h[:cap] == st_t.numpy()[:cap]).all()
        assert (ne_h == ne_t.numpy()).all()


def test_lane_header_rejects_unknown_arguments(lane_lib):
    """The C entry refuses a width, tier or batch it does not serve (-1),
    the same contract as the CUDA entry."""
    st = fresh_state(8, 4)
    packed = np.zeros((1, 4, 9), np.int32)
    now = np.zeros(1, np.int64)
    out = np.zeros((1, 4), np.int32)
    n_exp = np.zeros(1, np.int64)
    tail = (out.ctypes.data, n_exp.ctypes.data, None, 0)

    def call(width, B, with_degen, tier, rows=8):
        return lane_lib.tc_host_window(
            st.ctypes.data, rows, width, packed.ctypes.data,
            now.ctypes.data, 1, B, with_degen, tier, *tail, None,
        )

    assert call(5, 4, 0, 0) == -1
    assert call(4, 4, 1, 3) == -1
    assert call(4, 0, 0, 0) == -1
    assert call(4, 4, 0, 0, rows=3) == -1


# ---- the one-block schedule (B <= 256) ----------------------------------- #


def _check_block_replay(lib, windows, cap, B, width, compact, with_degen,
                        tiny_owner=False):
    """Replay `windows` ((packed, now, valid) in turn, state carried) on
    the one-block schedule, the cluster schedule and the plain version:
    valid outputs and expired hits equal everywhere, the table whole
    (scratch rows included) equal to the cluster replay's, the real
    slots equal to the plain version's, every lane decided and scattered
    once a round, and the forwarded lanes as counted from the rows."""
    N = cap + B
    st_b, st_c = fresh_state(N, width), fresh_state(N, width)
    st_t = torch.from_numpy(fresh_state(N, width))
    forwarded = np.zeros(1, np.int64)
    want = 0
    for step, (packed, now, valid) in enumerate(windows):
        K = packed.shape[0]
        visits = np.zeros((K, 2, B), np.int32)
        out_b, ne_b = host_window(lib, st_b, packed, now, width, compact,
                                  with_degen, visits=visits, seed=step,
                                  forwarded=forwarded, tiny_owner=tiny_owner)
        out_c, ne_c = host_window(lib, st_c, packed, now, width, compact,
                                  with_degen, seed=step + 1, cluster=True)
        out_t, ne_t = kernel.decide_window(
            st_t, torch.from_numpy(packed), torch.from_numpy(now),
            with_degen=with_degen, compact=compact,
        )
        mask = out_mask(valid, compact)
        assert (visits == 1).all()
        assert not ((out_b != out_c) & mask).any(), np.argwhere(
            (out_b != out_c) & mask)[:4]
        assert not ((out_b != out_t.numpy()) & mask).any()
        assert (st_b == st_c).all(), np.argwhere(st_b != st_c)[:4]
        assert (st_b[:cap] == st_t.numpy()[:cap]).all()
        assert (ne_b == ne_c).all() and (ne_b == ne_t.numpy()).all()
        want += forwarded_count(packed, N)
        assert forwarded[0] == want
    return want


@pytest.mark.parametrize("width", [4, 6])
@pytest.mark.parametrize("compact,with_degen", ALL_TIERS)
@pytest.mark.parametrize("B", [1, 16, 255, 256])
def test_block_schedule_matches_cluster_and_plain(
    lane_lib, B, width, compact, with_degen
):
    """Random hostile windows (duplicates, degenerate params, invalid
    lanes) and the cross-block ones, on every width and tier: the
    one-block replay, rows gathered before the previous round scatters,
    against the cluster replay and the plain version."""
    rng = np.random.default_rng(31 * B + width)
    cap = max(2 * B, 8)
    windows = [rand_window(rng, 5, B, cap, with_degen) for _ in range(2)]
    windows += cross_block_windows(rng, 4, B, cap, with_degen)
    _check_block_replay(lane_lib, windows, cap, B, width, compact,
                        with_degen)


def _reuse_slots(rng, K, B, cap, kind):
    """Slots i32[K, B] and valid bool[K, B] of a window built to forward:
    `every` - each round a permutation of the round before's distinct
    slots; `skip` - rounds alternate between two disjoint slot sets, so a
    slot written at k is read again at k+2 and not at k+1; `dups` - each
    round a few slots repeated over many lanes, and the next round reads
    them; `invalid` - as `every` with a third of the lanes invalid."""
    valid = np.ones((K, B), bool)
    if kind == "skip":
        sets = rng.permutation(cap)[:2 * B].reshape(2, B)
        slots = np.stack([rng.permutation(sets[k % 2]) for k in range(K)])
        return slots, valid
    if kind == "dups":
        hot = rng.permutation(cap)[:max(1, B // 8)]
        slots = np.stack([rng.choice(hot, B) for _ in range(K)])
        return slots, valid
    base = rng.permutation(cap)[:B]
    slots = np.stack([rng.permutation(base) for _ in range(K)])
    if kind == "invalid":
        valid = rng.random((K, B)) >= 1 / 3
    return slots, valid


@pytest.mark.parametrize("owner", ["kernel", "tiny"])
@pytest.mark.parametrize("width", [4, 6])
@pytest.mark.parametrize("kind", ["every", "skip", "dups", "invalid"])
@pytest.mark.parametrize("B,tier", [(256, ALL_TIERS[4]), (255, ALL_TIERS[0]),
                                    (16, ALL_TIERS[2]), (3, ALL_TIERS[5])])
def test_block_schedule_forwards_the_previous_round(
    lane_lib, B, tier, kind, width, owner
):
    """Windows whose rounds read what the round before wrote: the
    forwarded rows carry exactly that round's writes (and the gathered
    rows every earlier round's), and the count of forwarded lanes is the
    count from the packed rows (all B lanes a round from the second on,
    for `every`; none for `skip`); with the kernel's owner tables and
    with 4-bucket ones, whose lookups nearly all scan."""
    compact, with_degen = tier
    rng = np.random.default_rng(B + 7 * width + len(kind))
    K, cap = 6, 3 * B + 2
    windows = []
    for _ in range(2):
        slots, valid = _reuse_slots(rng, K, B, cap, kind)
        windows.append(rand_window(rng, K, B, cap, with_degen, slots=slots,
                                   valid=valid))
    total = _check_block_replay(lane_lib, windows, cap, B, width, compact,
                                with_degen, tiny_owner=owner == "tiny")
    if kind == "every":
        assert total == 2 * (K - 1) * B
    if kind == "skip":
        assert total == 0
    if kind in ("dups", "invalid"):
        assert total > 0


@pytest.mark.parametrize("B,schedule", [(1, "block"), (255, "block"),
                                        (256, "block"), (257, "cluster"),
                                        (4096, "cluster"),
                                        (65536, "cluster")])
def test_schedule_follows_the_geometry(lane_lib, B, schedule):
    """The rule the launch, the shim and the wrapper's BLOCK_LAUNCHES
    count read (gcra_lane.cuh one_block) names the geometry the kernel
    launches: one block exactly when B <= 256."""
    for width in (4, 6):
        blocks = _geometry(lane_lib, B, width)[0]
        assert (blocks == 1) == (schedule == "block")
    assert lane_lib.tc_host_one_block(B) == (schedule == "block")


@pytest.mark.parametrize("width", [4, 6])
def test_batch_past_one_block_takes_the_cluster_schedule(lane_lib, width):
    """B = 257 replays the cluster schedule: the same table and outputs
    as the forced cluster replay, and no lane forwarded, on windows in
    which every round rereads the round before's slots."""
    B, K, cap = 257, 4, 600
    rng = np.random.default_rng(width)
    compact, with_degen = ALL_TIERS[4]
    N = cap + B
    st_h, st_c = fresh_state(N, width), fresh_state(N, width)
    forwarded = np.zeros(1, np.int64)
    slots, valid = _reuse_slots(rng, K, B, cap, "every")
    packed, now, vmask = rand_window(rng, K, B, cap, with_degen,
                                     slots=slots, valid=valid)
    out_h, ne_h = host_window(lane_lib, st_h, packed, now, width, compact,
                              with_degen, seed=3, forwarded=forwarded)
    out_c, ne_c = host_window(lane_lib, st_c, packed, now, width, compact,
                              with_degen, seed=3, cluster=True)
    assert forwarded[0] == 0
    assert forwarded_count(packed, N) == (K - 1) * B
    assert (out_h == out_c).all() and (st_h == st_c).all()
    assert (ne_h == ne_c).all()

