"""The CUDA kernel's own arithmetic, checked on the CPU.

`csrc/gcra_lane.cuh` is the per-lane body of the decision-window kernel,
written once as `__host__ __device__` inline C++.  This file compiles it
with g++ through the host shim `csrc/lane_host.cpp` (plain C interface,
no torch headers: seconds to build) and holds the C++ window against the
port's plain version on the hostile windows of test_torch_fused.py —
every tier, both widths, state carried across windows.  Exact equality.
"""

import ctypes
import shutil
import subprocess

import numpy as np
import pytest
import torch

from throttlecrab_tpu_torch.tpu import kernel
from throttlecrab_tpu_torch.tpu.nvcc import CSRC
from torch_windows import NS, TIERS, fresh_state, out_mask, rand_window

_TIER = {False: 0, True: 1, "cur": 2, "w32": 3}


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
        ctypes.c_int, ctypes.c_int, ctypes.c_int, p, p,
    ]
    lib.tc_host_window.restype = ctypes.c_int
    return lib


def _host_window(lib, state, packed, now, width, compact, with_degen):
    """Run the C++ window in place on numpy `state`; (out, n_exp)."""
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
    )
    assert rc == 0
    return out, n_exp


@pytest.mark.parametrize("width", [4, 6])
@pytest.mark.parametrize("compact,with_degen", TIERS)
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
            lane_lib, st_h, packed, now, width, compact, with_degen
        )
        out_t, ne_t = kernel.decide_window(
            st_t, torch.from_numpy(packed), torch.from_numpy(now),
            with_degen=with_degen, compact=compact,
        )
        bad = (out_h != out_t.numpy()) & out_mask(valid, compact)
        assert not bad.any(), np.argwhere(bad)[:4]
        assert (st_h[:cap] == st_t.numpy()[:cap]).all()
        assert (ne_h == ne_t.numpy()).all()


def test_lane_header_rejects_unknown_arguments(lane_lib):
    """The C entry refuses a width or tier it does not serve (-1), the
    same contract as the CUDA entry."""
    st = fresh_state(8, 4)
    packed = np.zeros((1, 4, 9), np.int32)
    now = np.zeros(1, np.int64)
    out = np.zeros((1, 4), np.int32)
    n_exp = np.zeros(1, np.int64)
    args = (packed.ctypes.data, now.ctypes.data, 1, 4)
    assert lane_lib.tc_host_window(
        st.ctypes.data, 8, 5, *args, 0, 0, out.ctypes.data, n_exp.ctypes.data
    ) == -1
    assert lane_lib.tc_host_window(
        st.ctypes.data, 8, 4, *args, 1, 3, out.ctypes.data, n_exp.ctypes.data
    ) == -1
