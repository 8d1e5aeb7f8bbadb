"""The by-id front-end kernel's lane logic and ranks, checked on the CPU.

`csrc/ids_front.cuh` holds what each lane of `csrc/ids_front.cu` does
(the id row it reads, whether it is valid, its sort key under the
sub-batch's sort plan, its rank and is_last from its neighbours in the
sorted order, its nine packed words) and the block a sub-batch takes,
written once as `__host__ __device__` inline C++.  This file compiles it
with g++ through the host shim `csrc/ids_front_host.cpp` (plain C
interface, no torch headers: about a second to build), which runs every
sub-batch as the kernel does, a stable sort on the plan's bits in place
of the block's radix sort, and holds its packed window to the plain
version (`kernel.ids_window`: `_ids_fields` and `_pack_window`) bit for
bit, padding and invalid lanes included: padding lanes, ids at and past
`n_ids`, id rows with slot -1, two ids on one slot, a whole sub-batch
of one key, a Zipf-1.1 draw with a ~500-lane head, slots within B of
2^31 - 1 (where an invalid lane's segment key can equal a valid slot),
id rows 5 and 8 wide, at B = 1, 16, 255, 256, 257, 1,000, 2,048, 2,049
and 4,096.  A wider window (4,097) is refused by the shim, as by the
kernel, and `tpu/ids_front.py` sends it to the plain ops.  The wrapper
takes the plain version on the CPU and counts nothing there.

Exact equality throughout: integer copies and ranks.
"""

import ctypes
import shutil
import subprocess

import numpy as np
import pytest
import torch

from throttlecrab_tpu_torch.spans import recording
from throttlecrab_tpu_torch.tpu import ids_front
from throttlecrab_tpu_torch.tpu import kernel as tk
from throttlecrab_tpu_torch.tpu.nvcc import CSRC
from throttlecrab_tpu_torch.tpu.table import BucketTable

I32_MAX = (1 << 31) - 1
NS = 1_000_000_000
Q = (1 << 33) + 5  # both words of the quantity column in use
BATCHES = (1, 16, 255, 256, 257, 1000, 2048, 2049, 4096)


@pytest.fixture(scope="module")
def front_lib(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ is not installed: the front-end header cannot be "
                    "built")
    out = tmp_path_factory.mktemp("front") / "libids_front_host.so"
    subprocess.run(
        [gxx, "-O2", "-std=c++17", "-shared", "-fPIC", "-Wall", "-Werror",
         "-I", str(CSRC), "-o", str(out), str(CSRC / "ids_front_host.cpp")],
        check=True, capture_output=True, text=True,
    )
    lib = ctypes.CDLL(str(out))
    p = ctypes.c_void_p
    lib.tc_host_ids_front.argtypes = [
        p, ctypes.c_longlong, ctypes.c_int, p, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, p,
    ]
    lib.tc_host_ids_front.restype = ctypes.c_int
    lib.tc_host_ids_front_geometry.argtypes = [ctypes.c_int, p]
    lib.tc_host_ids_front_geometry.restype = None
    return lib


def _shim(lib, rows, ids, quantity):
    """The host shim's packed window, or None where it refuses the
    window."""
    rows = np.ascontiguousarray(rows, np.int32)
    ids = np.ascontiguousarray(ids, np.int32)
    K, B = ids.shape
    out = np.full((K, B, tk.PACK_WIDTH), -7, np.int32)
    lo, hi = ids_front.quantity_words(quantity)
    rc = lib.tc_host_ids_front(rows.ctypes.data, rows.shape[0], rows.shape[1],
                               ids.ctypes.data, K, B, lo, hi, out.ctypes.data)
    return None if rc != 0 else out


def _plain(rows, ids, quantity):
    return tk.ids_window(torch.from_numpy(np.asarray(rows, np.int32)),
                         torch.from_numpy(np.asarray(ids, np.int32)),
                         quantity).numpy()


def _rows(rng, n_ids, cap, width=tk.IDROW_WIDTH, slots=None):
    """Resident id rows over `cap` slots: ids 2 and 3 share a slot, about
    one id in ten is unresolved (slot -1)."""
    if slots is None:
        slots = rng.choice(cap, n_ids, replace=False).astype(np.int32)
        slots[3] = slots[2] = max(slots[2], 0)
        slots[4 + np.flatnonzero(rng.random(n_ids - 4) < 0.1)] = -1
    em = rng.choice([0, 1, 1000, NS, 7 * NS, 1 << 62, -5], n_ids)
    tol = rng.choice([0, 5, NS, 100 * NS, (1 << 61) + 7, -(3 * NS)], n_ids)
    return tk.pack_id_rows(slots, em, tol, width)


def _zipf(rng, n, shape, s=1.1):
    p = 1.0 / np.arange(1, n + 1) ** s
    return rng.choice(n, size=shape, p=p / p.sum()).astype(np.int32)


def _window(kind, rng, K, B, n_ids):
    """i32[K, B] raw ids of one of the edge patterns."""
    if kind == "mixed":
        ids = np.where(rng.random((K, B)) < 0.5,
                       rng.integers(0, 6, (K, B)),
                       rng.integers(0, n_ids, (K, B)))
        ids[rng.random((K, B)) < 0.08] = -1
        ids[rng.random((K, B)) < 0.03] = n_ids
        ids[rng.random((K, B)) < 0.03] = n_ids + 9
        return ids.astype(np.int32)
    if kind == "padding":
        ids = np.full((K, B), -1, np.int32)
        ids[:, ::3] = rng.integers(0, n_ids, ids[:, ::3].shape)
        return ids
    if kind == "shared_slot":  # ids 2 and 3 share a slot, interleaved
        return np.where(rng.random((K, B)) < 0.5, 2, 3).astype(np.int32)
    if kind == "one_key":
        return np.full((K, B), int(rng.integers(0, n_ids)), np.int32)
    if kind == "zipf":
        return _zipf(rng, n_ids, (K, B))
    raise ValueError(kind)


KINDS = ("mixed", "padding", "shared_slot", "one_key", "zipf")


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("B", BATCHES)
def test_shim_packs_as_the_plain_front_end(front_lib, B, kind):
    rng = np.random.default_rng(B * 31 + KINDS.index(kind))
    n_ids = 3000 if kind == "zipf" else 200
    K = 3 if B > 1000 else 5
    rows = _rows(rng, n_ids, 1 << 20)
    ids = _window(kind, rng, K, B, n_ids)
    got = _shim(front_lib, rows, ids, Q)
    want = _plain(rows, ids, Q)
    assert got is not None
    bad = np.argwhere(got != want)
    assert not len(bad), f"first differing (k, lane, word): {bad[:4]}"


@pytest.mark.parametrize("width", [5, 8])
def test_row_widths_and_quantities(front_lib, width):
    """Id rows 5 and 8 wide; quantities 0, 1, 2^32 + 7 and -3."""
    rng = np.random.default_rng(width)
    rows = _rows(rng, 300, 4096, width)
    ids = _window("mixed", rng, 4, 512, 300)
    for q in (0, 1, (1 << 32) + 7, -3):
        np.testing.assert_array_equal(_shim(front_lib, rows, ids, q),
                                      _plain(rows, ids, q))


def test_zipf_head_of_a_config3_sub_batch(front_lib):
    """A Zipf-1.1 draw over 1M ids at B = 4,096: key 0 holds ~500 lanes
    of each sub-batch, one run the ranks walk from 0 to its length."""
    rng = np.random.default_rng(1100)
    n_ids = 1_000_000
    rows = _rows(rng, n_ids, 1 << 20,
                 slots=rng.permutation(1 << 20)[:n_ids].astype(np.int32))
    ids = _zipf(rng, n_ids, (2, 4096))
    head = (ids == 0).sum(axis=1)
    assert (head > 400).all() and (head < 650).all()
    got = _shim(front_lib, rows, ids, 1)
    np.testing.assert_array_equal(got, _plain(rows, ids, 1))
    for k in range(2):
        lanes = got[k][ids[k] == 0]
        np.testing.assert_array_equal(lanes[:, 1], np.arange(head[k]))
        assert (lanes[:, 2] & tk.PACK_FLAG_IS_LAST).tolist() == \
            [0] * (head[k] - 1) + [1]


@pytest.mark.parametrize("B", [16, 256, 4096])
def test_slots_within_b_of_i32_max(front_lib, B):
    """Valid slots near 2^31 - 1: an invalid lane at position p keys on
    2^31 - 1 - p in the plain version, which joins the segment of a
    valid lane on that slot.  The kernel keys on the slots themselves
    then (the exact plan) and ranks as the plain version does."""
    rng = np.random.default_rng(B)
    n_ids = 8
    slots = (I32_MAX - np.array([0, 1, 2, 3, 5, 7, 11, 13])).astype(np.int32)
    rows = _rows(rng, n_ids, 0, slots=slots)
    ids = rng.integers(0, n_ids, (3, B)).astype(np.int32)
    ids[:, :16:2] = -1  # positions 0, 2, ..., 14: keys 2^31 - 1 - p
    ids[1, 1::4] = n_ids  # out of range: invalid too
    want = _plain(rows, ids, 1)
    # The plain version does merge invalid lanes into valid segments.
    flags = want[..., 2]
    merged = (flags & tk.PACK_FLAG_VALID == 0) & (
        flags & tk.PACK_FLAG_IS_LAST == 0)
    assert merged.any()
    np.testing.assert_array_equal(_shim(front_lib, rows, ids, 1), want)


def test_geometry_covers_each_batch_and_refuses_wider(front_lib):
    out = np.zeros(3, np.int32)
    shapes = set()
    for B in list(range(1, 300)) + [511, 512, 513, 1023, 1024, 1025, 2047,
                                     2048, 2049, 4095, 4096]:
        front_lib.tc_host_ids_front_geometry(B, out.ctypes.data)
        threads, items, limit = (int(x) for x in out)
        assert limit == ids_front.MAX_BATCH == 4096
        assert threads * items >= B and threads % 32 == 0
        # One block of 256 up to its width, then 512 threads with the
        # fewest of 2, 4 or 8 lanes each that hold B.
        assert (threads == 256) == (B <= 256)
        assert threads == 256 or items == 2 or threads * items // 2 < B
        shapes.add((threads, items))
    assert shapes == {(256, 1), (512, 2), (512, 4), (512, 8)}
    for B in (0, 4097, 65536):
        front_lib.tc_host_ids_front_geometry(B, out.ctypes.data)
        assert out[0] == 0


def test_wider_windows_are_refused_and_take_the_plain_ops(front_lib):
    rng = np.random.default_rng(4097)
    rows = _rows(rng, 100, 8192)
    ids = _window("mixed", rng, 2, 4097, 100)
    assert _shim(front_lib, rows, ids, 1) is None
    before = (ids_front.LAUNCHES, ids_front.PLAIN_WINDOWS)
    got = ids_front.ids_window(torch.from_numpy(rows), torch.from_numpy(ids),
                               1)
    np.testing.assert_array_equal(got.numpy(), _plain(rows, ids, 1))
    assert (ids_front.LAUNCHES, ids_front.PLAIN_WINDOWS) == before


@pytest.mark.parametrize("variant", ["ids", "ids20"])
def test_wrapper_takes_the_plain_version_on_the_cpu(variant):
    rng = np.random.default_rng(20)
    rows = torch.from_numpy(_rows(rng, 300, 4096))
    ids = _window("mixed", rng, 4, 256, 300)
    before = (ids_front.LAUNCHES, ids_front.PLAIN_WINDOWS)
    if variant == "ids":
        got = ids_front.ids_window(rows, torch.from_numpy(ids), Q)
        want = tk.ids_window(rows, torch.from_numpy(ids), Q)
    else:
        stream = torch.from_numpy(tk.pack_ids20(ids))
        got = ids_front.ids20_window(rows, stream, Q)
        want = tk.ids20_window(rows, stream, Q)
    assert torch.equal(got, want)
    assert (ids_front.LAUNCHES, ids_front.PLAIN_WINDOWS) == before


def test_quantity_words_are_the_pack_windows():
    rows = torch.from_numpy(_rows(np.random.default_rng(0), 10, 64))
    ids = torch.zeros((1, 1), dtype=torch.int32)
    for q in (0, 1, -1, (1 << 31), (1 << 33) + 5, -(1 << 40) - 3):
        lo, hi = ids_front.quantity_words(q)
        assert tk.ids_window(rows, ids, q)[0, 0, 7:].tolist() == [lo, hi]
    with pytest.raises(ValueError, match="two i32 words"):
        ids_front.quantity_words(1 << 63)


def test_table_front_span_notes_whether_the_kernel_ran():
    """The table's tc.ids.front span carries `kernel`: False on the CPU,
    where the plain version expands the window."""
    table = BucketTable(64, device="cpu")
    rows = table.upload_id_rows(np.arange(20), np.full(20, NS, np.int64),
                                np.full(20, 4 * NS, np.int64))
    ids = np.random.default_rng(0).integers(0, 20, (2, 16), np.int32)
    with recording() as rec:
        table.check_many_ids(rows, ids, np.array([NS, 2 * NS]), 1,
                             with_degen=False, compact="w32")
    (front,) = [s for s in rec.spans if s.name == "tc.ids.front"]
    assert front.attrs == {"kernel": False}
