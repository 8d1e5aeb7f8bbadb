"""The decision window as one hand-written CUDA kernel (sm_90a).

The port of `throttlecrab_tpu/tpu/pallas_fused.py:fused_window`: for each
of a window's K sub-batches, in order, gather the slots' state rows,
evaluate the GCRA closed forms, write the outputs of the requested tier
and the expired-hit count, and scatter the surviving rows back at unique
indices.  The source is `csrc/fused_window.cu` over the lane body and
launch geometry in `csrc/gcra_lane.cuh`; it is compiled with nvcc into a
plain-C shared library at first use (into `throttlecrab_tpu_torch/build/`,
keyed by a hash of the sources) and bound with ctypes.

A window is one CUDA launch, on one of two schedules that the batch's
width picks (`gcra_lane.cuh` window_geometry; no knob):

- **block** (B <= 256): one block of 256 threads, one lane a thread,
  ordered by `__syncthreads` alone: every thread that touches the table
  is in the block, so block scope makes each round's writes visible to
  the next, with no release to L2.  Sub-batch k+1's rows are gathered
  while k decides; such a row is stale exactly where round k wrote it,
  and round k records every row it writes in a table in shared memory,
  so round k+1 takes those rows from there instead (the forwarded
  lanes).  Bound: the lane arithmetic and one barrier a round.
- **cluster** (B > 256): one thread block cluster (up to 16 blocks of
  256 threads) with a cluster barrier between each gather and its
  scatter and between each scatter and the next gather.  Bound: per
  round, the scatter's drain to L2, the next gather's L2 round trip and
  two cluster barriers.

Either writes the expired-hit counts itself; the wrapper allocates the
outputs with `torch.empty` and launches nothing else.  Every window of
`BucketTable` comes here: the serving path's packed windows, and the
by-id windows once `kernel.py`'s front end has expanded their ids into
packed rows.

Each wrapper takes the kernel's plain version (`kernel.decide_window`)
only for tensors that lie on the CPU; for a CUDA tensor it launches the
kernel or raises.  `LAUNCHES` counts kernel launches (one per window),
`BLOCK_LAUNCHES` those on the block schedule; `forwarded_lanes(device)`
reads the device's running count of forwarded lanes.

The table is updated in place (the JAX package donates it instead).
"""

from __future__ import annotations

import ctypes

import torch

from . import kernel, nvcc
from .kernel import INS_WIDTH, PACK_FLAG_VALID, PACK_WIDTH

#: Kernel windows launched through tc_fused_window since import.
LAUNCHES = 0
#: Of those, the windows the one-block schedule took (B <= 256).
BLOCK_LAUNCHES = 0

MAX_BATCH = 1 << 16  # the table's scratch tail bounds a sub-batch

# Output tier codes of the C entry point (gcra_lane.cuh TIER_*).
TIER_NS = 0  # compact=False
TIER_WIRE = 1  # compact=True
TIER_CUR = 2  # compact="cur"
TIER_W32 = 3  # compact="w32"

LIB_STEM = "libtc_fused"
SOURCES = ("fused_window.cu", "gcra_lane.cuh")

_TIERS = {"cur": TIER_CUR, "w32": TIER_W32}
_lib = None
_launch = None  # the bound tc_fused_window
_raw_stream = None  # device index -> the current stream's handle
_forwarded = {}  # device index -> u64[1] forwarded-lane count (as i64)


def _tier(compact) -> int:
    """The C tier code of a `compact` argument (False/True/"cur"/"w32")."""
    if isinstance(compact, str):
        if compact not in _TIERS:
            raise ValueError(f"unknown output tier {compact!r}")
        return _TIERS[compact]
    return TIER_WIRE if compact else TIER_NS


def forwarded_lanes(device) -> int:
    """Lanes of the one-block schedule that took the previous round's
    row from shared memory, on `device` since its kernels were prepared
    (0 before).  Synchronises the device."""
    index = torch.device(device).index
    if index is None:
        index = torch.cuda.current_device()
    count = _forwarded.get(index)
    if count is None:
        return 0
    torch.cuda.synchronize(index)
    return int(count.item())


def build():
    """Compile the kernel library unless this source revision is built;
    returns its path (see nvcc.build)."""
    return nvcc.build(LIB_STEM, SOURCES)


def _load(index):
    """The bound launch function, with the library built and loaded and
    the kernels prepared on device `index` (once each; preparing also
    zeroes the device's forwarded-lane count)."""
    global _lib, _launch, _raw_stream
    if _lib is None:
        lib = nvcc.load(LIB_STEM, SOURCES)
        fn = lib.tc_fused_window
        p = ctypes.c_void_p
        fn.argtypes = [
            p, ctypes.c_longlong, ctypes.c_int, p, p, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, p, p, p, p,
        ]
        fn.restype = ctypes.c_int
        lib.tc_fused_window_prepare.argtypes = []
        lib.tc_fused_window_prepare.restype = ctypes.c_int
        lib.tc_fused_window_one_block.argtypes = [ctypes.c_int]
        lib.tc_fused_window_one_block.restype = ctypes.c_int
        _raw_stream = torch._C._cuda_getCurrentRawStream
        _lib, _launch = lib, fn
    if index not in _forwarded:
        with torch.cuda.device(index):
            rc = _lib.tc_fused_window_prepare()
        if rc == -2:
            raise RuntimeError(
                "this card cannot hold the decision window's schedules "
                "(256 threads in one block, or one thread block cluster)"
            )
        if rc != 0:
            raise RuntimeError(f"tc_fused_window_prepare failed: error {rc}")
        _forwarded[index] = torch.zeros(
            1, dtype=torch.int64, device=torch.device("cuda", index))
        torch.cuda.synchronize(index)  # zeroed before any stream adds
    return _launch


def _check(state, packed, now, with_degen, tier):
    if state.device.type != "cuda":
        raise ValueError(
            f"fused_window runs on cuda or cpu tensors, got {state.device}"
        )
    for name, t, dtype in (
        ("state", state, torch.int32),
        ("packed", packed, torch.int32),
        ("now", now, torch.int64),
    ):
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
        if t.device != state.device:
            raise ValueError(f"{name} is on {t.device}, state on {state.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if state.dim() != 2 or state.shape[1] not in (4, INS_WIDTH):
        raise ValueError(f"state must be i32[N, 4|6], got {tuple(state.shape)}")
    if packed.dim() != 3 or packed.shape[2] != PACK_WIDTH:
        raise ValueError(
            f"packed must be i32[K, B, {PACK_WIDTH}], got {tuple(packed.shape)}"
        )
    K, B = packed.shape[0], packed.shape[1]
    if now.shape != (K,):
        raise ValueError(f"now must be i64[{K}], got {tuple(now.shape)}")
    if not 1 <= B <= min(MAX_BATCH, state.shape[0]):
        raise ValueError(f"batch width {B} outside [1, {MAX_BATCH}]")
    if state.data_ptr() % 16:  # the kernel moves rows in 16-byte vectors
        raise ValueError("state must be 16-byte aligned")
    if tier >= TIER_CUR and with_degen:
        raise ValueError('compact="cur"/"w32" require with_degen=False')


def fused_window(state, packed, now, *, with_degen=True, compact=False):
    """Decide one K-deep window, updating `state` (i32[N, W], W in {4, 6})
    in place.  `packed` is i32[K, B, PACK_WIDTH], `now` i64[K], on the
    state's device.  Returns (out, n_exp i64[K]) with `out` per tier:
    False i64[K, 4, B], True i32[K, 4, B], "cur" i64[K, B], "w32"
    i32[K, B].  Invalid lanes' outputs are don't-care.  The launch is
    queued on the current stream; nothing synchronises."""
    global LAUNCHES, BLOCK_LAUNCHES
    if state.device.type == "cpu":
        return kernel.decide_window(
            state, packed, now, with_degen=with_degen, compact=compact
        )
    tier = _tier(compact)
    _check(state, packed, now, with_degen, tier)
    K, B = packed.shape[0], packed.shape[1]
    N, W = state.shape
    dev = state.device
    if tier in (TIER_NS, TIER_WIRE):
        out = torch.empty(
            (K, 4, B), dtype=torch.int64 if tier == TIER_NS else torch.int32,
            device=dev,
        )
    else:
        out = torch.empty(
            (K, B), dtype=torch.int64 if tier == TIER_CUR else torch.int32,
            device=dev,
        )
    n_exp = torch.empty(K, dtype=torch.int64, device=dev)  # kernel-written
    launch = _load(dev.index)
    rc = launch(
        state.data_ptr(), N, W, packed.data_ptr(), now.data_ptr(), K, B,
        int(bool(with_degen)), tier, out.data_ptr(), n_exp.data_ptr(),
        _forwarded[dev.index].data_ptr(), _raw_stream(dev.index),
    )
    if rc != 0:
        raise RuntimeError(f"tc_fused_window failed: error {rc}")
    BLOCK_LAUNCHES += _lib.tc_fused_window_one_block(B)
    LAUNCHES += 1
    return out, n_exp


def gcra_scan_packed_fused_acc(
    state, exp_acc, packed, now, *, with_degen=True, compact=False
):
    """Kernel twin of kernel.gcra_scan_packed_acc: (state, exp_acc, out),
    with `state` updated in place."""
    out, n_exp = fused_window(
        state, packed, now, with_degen=with_degen, compact=compact
    )
    return state, exp_acc + n_exp.sum(), out


def gcra_scan_packed_fused_ins(
    state, exp_acc, ins_counts, packed, now, *, with_degen=True,
    compact=False,
):
    """Kernel twin of kernel.gcra_scan_packed_ins (INS_WIDTH rows); the
    [allowed, denied] totals advance from the outputs with torch ops."""
    out, n_exp = fused_window(
        state, packed, now, with_degen=with_degen, compact=compact
    )
    ins_counts = kernel._insight_totals(
        ins_counts, (packed[..., 2] & PACK_FLAG_VALID) != 0, out, compact
    )
    return state, exp_acc + n_exp.sum(), ins_counts, out
