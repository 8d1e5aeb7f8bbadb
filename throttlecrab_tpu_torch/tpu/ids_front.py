"""The by-id front end as one hand-written CUDA kernel (sm_90a).

Turns a by-id window of raw key ids (i32[K, B], negative = padding)
against the resident id rows into the packed window i32[K, B,
PACK_WIDTH] that the decision window (`fused.py`) decides: bit for bit
what `kernel.ids_window`, the plain version, computes with some forty
torch ops (the id-row gather, the validity masks, `_device_segments`'
two stable argsorts and cummax, `_pack_window`'s concatenation).  It
replaces no TPU kernel: the JAX package's front end is composed jnp
ops.  The source is `csrc/ids_front.cu` over the lane logic and rank
derivation in `csrc/ids_front.cuh`, built with nvcc at first use
(tpu/nvcc.py) and bound with ctypes.

One block per sub-batch: each lane's slot read from its id row, the
sub-batch's lanes ranked by a stable radix sort in shared memory on the
slot, and the packed rows written through shared memory in coalesced
stores (see the source for the design and its bound, the packed rows'
bytes).  A block holds up to MAX_BATCH lanes, the widest batch any
cell or BASELINE config sends.

`ids_window` / `ids20_window` take the plain version for tensors that
lie on the CPU; on a card they launch the kernel, or, for a window
wider than MAX_BATCH (a shape the wrapper sees, not a failure), run the
plain ops there.  `LAUNCHES` counts the windows the kernel expanded,
`PLAIN_WINDOWS` the windows on a card that took the plain ops for
their width.  `BucketTable.check_many_ids` / `_ids20` come here;
`check_many_byid` (host-ranked 8-byte words) keeps `kernel.byid_window`.
"""

from __future__ import annotations

import ctypes

import torch

from . import kernel, nvcc
from .kernel import PACK_WIDTH

#: By-id windows expanded by tc_ids_front since import.
LAUNCHES = 0
#: By-id windows on a card wider than MAX_BATCH: the plain ops took them.
PLAIN_WINDOWS = 0

MAX_BATCH = 4096  # the widest sub-batch a block holds (FRONT_MAX_BATCH)

LIB_STEM = "libtc_ids_front"
SOURCES = ("ids_front.cu", "ids_front.cuh", "gcra_lane.cuh")

_I32 = (-(1 << 31), (1 << 31) - 1)
_launch = None  # the bound tc_ids_front
_raw_stream = None  # device index -> the current stream's handle


def build():
    """Compile the kernel library unless this source revision is built;
    returns its path (see nvcc.build)."""
    return nvcc.build(LIB_STEM, SOURCES)


def _load():
    """The bound launch function, with the library built and loaded
    (once: the plain-C function launches on whichever device is current,
    so it serves every device)."""
    global _launch, _raw_stream
    if _launch is None:
        fn = nvcc.load(LIB_STEM, SOURCES).tc_ids_front
        p = ctypes.c_void_p
        fn.argtypes = [
            p, ctypes.c_longlong, ctypes.c_int, p, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, p, p,
        ]
        fn.restype = ctypes.c_int
        _raw_stream = torch._C._cuda_getCurrentRawStream
        _launch = fn
    return _launch


def quantity_words(quantity: int):
    """The launch-uniform quantity's (lo, hi) i32 words, as
    `kernel._pack_window` writes them."""
    lo = ((quantity & 0xFFFFFFFF) ^ (1 << 31)) - (1 << 31)
    hi = quantity >> 32
    if not _I32[0] <= hi <= _I32[1]:
        raise ValueError(f"quantity {quantity} does not fit the packed "
                         "row's two i32 words")
    return lo, hi


def _check(id_rows, ids):
    for name, t in (("id_rows", id_rows), ("ids", ids)):
        if t.dtype != torch.int32:
            raise TypeError(f"{name} must be torch.int32, got {t.dtype}")
        if t.device != ids.device:
            raise ValueError(f"{name} is on {t.device}, ids on {ids.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if id_rows.dim() != 2 or id_rows.shape[1] < 5:
        raise ValueError(
            f"id_rows must be i32[n_ids, >= 5], got {tuple(id_rows.shape)}")
    if not 1 <= id_rows.shape[0] <= _I32[1]:
        raise ValueError(f"{id_rows.shape[0]} id rows: the kernel takes "
                         f"1 to {_I32[1]}")
    if ids.dim() != 2:
        raise ValueError(f"ids must be i32[K, B], got {tuple(ids.shape)}")


def ids_window(id_rows, ids, quantity):
    """Raw key ids (i32[K, B], negative = padding) against resident
    `id_rows` -> the packed window i32[K, B, PACK_WIDTH], as
    `kernel.ids_window`; `quantity` a launch-uniform int.  On a card one
    launch on the current stream, nothing synchronised."""
    global LAUNCHES, PLAIN_WINDOWS
    if ids.device.type == "cpu":
        return kernel.ids_window(id_rows, ids, quantity)
    if ids.shape[-1] > MAX_BATCH:
        PLAIN_WINDOWS += 1
        return kernel.ids_window(id_rows, ids, quantity)
    _check(id_rows, ids)
    K, B = ids.shape
    q_lo, q_hi = quantity_words(int(quantity))
    out = torch.empty((K, B, PACK_WIDTH), dtype=torch.int32,
                      device=ids.device)
    if K == 0 or B == 0:
        return out
    rc = _load()(
        id_rows.data_ptr(), id_rows.shape[0], id_rows.shape[1],
        ids.data_ptr(), K, B, q_lo, q_hi, out.data_ptr(),
        _raw_stream(ids.device.index),
    )
    if rc != 0:
        raise RuntimeError(f"tc_ids_front failed: error {rc}")
    LAUNCHES += 1
    return out


def ids20_window(id_rows, packed, quantity):
    """The 20-bit id stream (u16[K, B + B//4], kernel.pack_ids20) -> the
    packed window, as `kernel.ids20_window`: decoded with torch ops,
    then expanded as `ids_window` does."""
    if packed.device.type == "cpu":
        return kernel.ids20_window(id_rows, packed, quantity)
    return ids_window(
        id_rows, kernel._ids20_decode(packed, kernel._ids20_width(packed)),
        quantity,
    )
