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
"""

import ctypes
import shutil
import subprocess

import numpy as np
import pytest
import torch

from throttlecrab_tpu_torch.tpu import kernel
from throttlecrab_tpu_torch.tpu.nvcc import CSRC
from torch_windows import (
    ALL_TIERS,
    NS,
    cross_block_windows,
    fresh_state,
    out_mask,
    rand_window,
)

_TIER = {False: 0, True: 1, "cur": 2, "w32": 3}
SMEM_LIMIT = 227 * 1024  # bytes of shared memory a Hopper block may use


@pytest.fixture(scope="module")
def lane_lib(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ is not installed: the lane header cannot be built")
    out = tmp_path_factory.mktemp("lane") / "liblane_host.so"
    subprocess.run(
        [gxx, "-O2", "-std=c++17", "-shared", "-fPIC", "-Wall", "-Werror",
         "-I", str(CSRC), "-o", str(out),
         str(CSRC / "lane_host.cpp")],
        check=True, capture_output=True, text=True,
    )
    lib = ctypes.CDLL(str(out))
    p = ctypes.c_void_p
    lib.tc_host_window.argtypes = [
        p, ctypes.c_longlong, ctypes.c_int, p, p, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, p, p, p, ctypes.c_uint,
    ]
    lib.tc_host_window.restype = ctypes.c_int
    lib.tc_host_geometry.argtypes = [ctypes.c_int, ctypes.c_int, p]
    lib.tc_host_geometry.restype = None
    return lib


def _geometry(lib, B, width):
    """(blocks, threads, lanes per thread, shared bytes, cluster limit,
    shared-memory limit) of the kernel's launch for B lanes."""
    g = np.zeros(6, np.int32)
    lib.tc_host_geometry(B, width, g.ctypes.data)
    return tuple(int(x) for x in g)


def _host_window(lib, state, packed, now, width, compact, with_degen,
                 visits=None, seed=0):
    """Run the C++ window in place on numpy `state`; (out, n_exp).
    `visits` (i32[K, 2, B] zeros) collects each lane's decides and
    scatters."""
    K, B = packed.shape[:2]
    if compact in ("cur", "w32"):
        out = np.zeros((K, B), np.int64 if compact == "cur" else np.int32)
    else:
        out = np.zeros((K, 4, B), np.int32 if compact else np.int64)
    n_exp = np.zeros(K, np.int64)
    packed = np.ascontiguousarray(packed)
    now = np.ascontiguousarray(now)
    rc = lib.tc_host_window(
        state.ctypes.data, state.shape[0], width, packed.ctypes.data,
        now.ctypes.data, K, B, int(with_degen), _TIER[compact],
        out.ctypes.data, n_exp.ctypes.data,
        None if visits is None else visits.ctypes.data, seed,
    )
    assert rc == 0
    return out, n_exp


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
        out_h, ne_h = _host_window(
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
        out_h, ne_h = _host_window(
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
            now.ctypes.data, 1, B, with_degen, tier, *tail,
        )

    assert call(5, 4, 0, 0) == -1
    assert call(4, 4, 1, 3) == -1
    assert call(4, 0, 0, 0) == -1
    assert call(4, 4, 0, 0, rows=3) == -1
