"""Bucket-table row gather and scatter as hand-written CUDA kernels (sm_90a).

The port of `throttlecrab_tpu/tpu/pallas_ops.py` (`row_gather`,
`row_scatter`).  They move every live row of a snapshot save or restore
(`snapshot.gather_rows` / `scatter_rows`), a checkpoint generation or
recovery (`persist/`) and the supervisor's degrade export and
re-promotion, ceil(n / MAX_BATCH) launches each, and the rows of the
composed by-id scans of `kernel.py`, one gather and one scatter per
sub-batch.  The table's own windows move their rows inside the window
kernel (`fused.py`).  The source is `csrc/row_ops.cu` with its tile
arithmetic in `csrc/row_tile.cuh`, built with nvcc at first use
(tpu/nvcc.py) and bound with ctypes.

Rows are i32[W] with W = 4, or 6 for the insight layout.  The kernels
move a W=4 row as one 16-byte part and a W=6 row as three 8-byte parts
on adjacent lanes, so on a card the table must start on a 16-byte
boundary and the scatter's rows on 16 bytes (W=4) or 8 (W=6); the
wrappers raise on anything else (every caller passes whole allocations
or views at multiples of MAX_BATCH rows, and the gather allocates its
own output).  Each wrapper takes the plain version
(`row_gather_plain` / `row_scatter_plain`: `index_select` /
`index_copy_`) only for tensors that lie on the CPU; for a CUDA tensor
it launches the kernel or raises.  `GATHER_LAUNCHES` and
`SCATTER_LAUNCHES` count kernel launches.  Both kernels are queued on
the current stream without synchronising, so a sub-batch's scatter
stays ahead of the next sub-batch's gather.  A launch costs the host
more than the device, so the wrappers keep their own work small: the
bound functions are looked up once and the stream handle comes from one
C call.
"""

from __future__ import annotations

import ctypes
from types import SimpleNamespace

import torch

from . import nvcc

#: Kernel launches through tc_row_gather / tc_row_scatter since import.
GATHER_LAUNCHES = 0
SCATTER_LAUNCHES = 0

MAX_BATCH = 1 << 16  # the table's scratch tail bounds a sub-batch
WIDTHS = (4, 6)

LIB_STEM = "libtc_row_ops"
SOURCES = ("row_ops.cu", "row_tile.cuh")

_lib = None
_gather = None  # the bound tc_row_gather
_scatter = None  # the bound tc_row_scatter
_raw_stream = None  # device index -> the current stream's handle


def build():
    """Compile the kernel library unless this source revision is built;
    returns its path (see nvcc.build)."""
    return nvcc.build(LIB_STEM, SOURCES)


def _load():
    """Build, load and bind the library (once: the plain-C functions
    launch on whichever device is current, so they serve every device)."""
    global _lib, _gather, _scatter, _raw_stream
    if _lib is None:
        lib = nvcc.load(LIB_STEM, SOURCES)
        p = ctypes.c_void_p
        for fn in (lib.tc_row_gather, lib.tc_row_scatter):
            fn.argtypes = [
                p, ctypes.c_longlong, ctypes.c_int, p, ctypes.c_int, p, p,
            ]
            fn.restype = ctypes.c_int
        _raw_stream = torch._C._cuda_getCurrentRawStream
        _gather, _scatter = lib.tc_row_gather, lib.tc_row_scatter
        _lib = lib


# ---- the plain version ---------------------------------------------------- #


def row_gather_plain(table, idx):
    """rows[i] = table[idx[i]]."""
    return table.index_select(0, idx)


def row_scatter_plain(table, idx, rows):
    """table[idx[i]] = rows[i] in place; returns `table`."""
    return table.index_copy_(0, idx.to(torch.int64), rows)


#: Plain row movement for `kernel._gcra_body`'s `rowops` argument (the
#: kernels' route passes this module itself).
PLAIN = SimpleNamespace(
    row_gather=row_gather_plain, row_scatter=row_scatter_plain
)


# ---- the wrappers --------------------------------------------------------- #


def _check(table, idx, rows=None):
    """Raise on what the kernels do not take; returns (N, W, B, device
    index), the index -1 for a CPU table."""
    dev = table.get_device()
    for name, t in (("table", table), ("idx", idx), ("rows", rows)):
        if t is None:
            continue
        if t.dtype is not torch.int32:
            raise TypeError(f"{name} must be torch.int32, got {t.dtype}")
        if t.get_device() != dev:
            raise ValueError(
                f"{name} is on {t.device}, table on {table.device}"
            )
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    has_rows = rows is not None
    shape = table.shape
    if len(shape) != 2 or shape[1] not in WIDTHS:
        raise ValueError(f"table must be i32[N, 4|6], got {tuple(shape)}")
    N, W = shape
    if idx.dim() != 1:
        raise ValueError(f"idx must be i32[B], got {tuple(idx.shape)}")
    B = idx.shape[0]
    if not 1 <= B <= min(MAX_BATCH, N):
        raise ValueError(f"batch {B} outside [1, min({MAX_BATCH}, N={N})]")
    if has_rows and rows.shape != (B, W):
        raise ValueError(
            f"rows must be i32[{B}, {W}], got {tuple(rows.shape)}"
        )
    if table.is_cuda:
        # The table on 16 bytes; the rows on their part: a W=4 row moves
        # as one 16-byte vector, a W=6 row as three 8-byte ones.
        for name, t, align in (("table", table, 16),
                               ("rows", rows, 16 if W == 4 else 8)):
            if t is not None and t.data_ptr() % align:
                raise ValueError(f"{name} must be {align}-byte aligned")
    elif table.device.type != "cpu":
        raise ValueError(
            f"row ops run on cuda or cpu tensors, got {table.device}"
        )
    return N, W, B, dev


def row_gather(table, idx):
    """rows = table[idx]: `table` i32[N, W] (W 4 or 6), `idx` i32[B] with
    every index in [0, N); returns i32[B, W] on the table's device."""
    global GATHER_LAUNCHES
    N, W, B, dev = _check(table, idx)
    if dev < 0:
        return row_gather_plain(table, idx)
    if _lib is None:
        _load()
    out = table.new_empty((B, W))
    rc = _gather(table.data_ptr(), N, W, idx.data_ptr(), B, out.data_ptr(),
                 _raw_stream(dev))
    if rc != 0:
        raise RuntimeError(f"tc_row_gather failed: CUDA error {rc}")
    GATHER_LAUNCHES += 1
    return out


def row_scatter(table, idx, rows):
    """table[idx] = rows in place: `idx` i32[B] unique (the caller's
    guarantee, as for the TPU kernel), in [0, N); `rows` i32[B, W].
    Returns `table`."""
    global SCATTER_LAUNCHES
    N, W, B, dev = _check(table, idx, rows)
    if dev < 0:
        return row_scatter_plain(table, idx, rows)
    if _lib is None:
        _load()
    rc = _scatter(table.data_ptr(), N, W, idx.data_ptr(), B, rows.data_ptr(),
                  _raw_stream(dev))
    if rc != 0:
        raise RuntimeError(f"tc_row_scatter failed: CUDA error {rc}")
    SCATTER_LAUNCHES += 1
    return table

