"""The row kernels' tile arithmetic, checked on the CPU.

`csrc/row_tile.cuh` is how `csrc/row_ops.cu` cuts a launch (the tile
picked from the batch, the width and the kind) and what each lane of it
moves, written once as `__host__ __device__` inline C++.
This file compiles it with g++ through the host shim
`csrc/row_host.cpp` (plain C interface, no torch headers: about a
second to build), which runs every lane of every block of the launch the
card would get, and holds the result against the wrappers' plain
versions (`row_ops.row_gather_plain` / `row_scatter_plain`): both widths,
batches from one row to the 65,536 the table's scratch tail allows,
batches one row short of, at and past a block edge of the tile the
largest batches pick and the batch where the W=6 scatter goes to two
rows a lane, odd and even first rows, indices outside the table (a zero
row for the gather, a dropped write for the scatter), and a W=6 dense
buffer 8 bytes off 16 (a W=4 one, or one 4 bytes off, is refused).
Every (row, part) must be owned by exactly one lane, and no access may
be misaligned for its vector width.  Exact equality: integer copies.
"""

import ctypes
import shutil
import subprocess

import numpy as np
import pytest
import torch

from throttlecrab_tpu_torch.tpu import row_ops
from throttlecrab_tpu_torch.tpu.nvcc import CSRC

I32 = (-(2**31), 2**31 - 1)
SMS = 132  # an H100's SMs: the tile gives each one a block where b allows
TILE_FIELDS = ("part", "lanes_per_row", "rows_per_warp", "steps", "threads",
               "rows_per_block", "blocks")


@pytest.fixture(scope="module")
def row_lib(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ is not installed: the row tile header cannot be "
                    "built")
    out = tmp_path_factory.mktemp("row") / "librow_host.so"
    subprocess.run(
        [gxx, "-O2", "-std=c++17", "-shared", "-fPIC", "-Wall", "-Werror",
         "-I", str(CSRC), "-o", str(out), str(CSRC / "row_host.cpp")],
        check=True, capture_output=True, text=True,
    )
    lib = ctypes.CDLL(str(out))
    p = ctypes.c_void_p
    lib.tc_host_row_tile.argtypes = [
        ctypes.c_int, ctypes.c_int, ctypes.c_int, p,
    ]
    lib.tc_host_row_tile.restype = None
    lib.tc_host_row_move.argtypes = [
        ctypes.c_int, p, ctypes.c_longlong, ctypes.c_int, p, ctypes.c_int,
        p, p,
    ]
    lib.tc_host_row_move.restype = ctypes.c_long
    return lib


def _tile(lib, scatter, b, width):
    out = np.zeros(7, np.int32)
    lib.tc_host_row_tile(int(scatter), b, width, out.ctypes.data)
    return dict(zip(TILE_FIELDS, (int(x) for x in out)))


def _buffer(shape, offset, fill=0):
    """A zeroed int32 array of `shape` whose address is `offset` bytes
    past a 16-byte boundary."""
    n = int(np.prod(shape))
    raw = np.full(n + 8, fill, np.int32)
    skip = ((offset - raw.ctypes.data) % 16) // 4
    view = raw[skip:skip + n].reshape(shape)
    assert view.ctypes.data % 16 == offset
    return view


def _move(lib, scatter, table, idx, dense, count=True):
    """Run the launch on numpy arrays in place; returns the lanes' visits
    per (row, part) (None without `count`)."""
    b, width = dense.shape
    tile = _tile(lib, scatter, b, width)
    visits = (np.zeros(b * tile["lanes_per_row"], np.int32) if count
              else None)
    bad = lib.tc_host_row_move(
        int(scatter), table.ctypes.data, table.shape[0], width,
        idx.ctypes.data, b, dense.ctypes.data,
        None if visits is None else visits.ctypes.data,
    )
    assert bad == 0, f"{bad} misaligned part accesses"
    return visits


def _want_gather(table, idx):
    """The plain version on the in-range indices, zero rows elsewhere."""
    keep = (idx >= 0) & (idx < table.shape[0])
    want = np.zeros((len(idx), table.shape[1]), np.int32)
    want[keep] = row_ops.row_gather_plain(
        torch.from_numpy(table), torch.from_numpy(idx[keep])).numpy()
    return want


def _want_scatter(table, idx, rows):
    """The plain version on the in-range indices; the rest are dropped."""
    keep = (idx >= 0) & (idx < table.shape[0])
    want = torch.from_numpy(table.copy())
    row_ops.row_scatter_plain(want, torch.from_numpy(idx[keep]),
                              torch.from_numpy(rows[keep]))
    return want.numpy()


def _case(rng, n, b, width, first_parity):
    """(table i32[n, width] 16-byte aligned, idx i32[b] unique, the
    first index of the given parity)."""
    table = _buffer((n, width), 0)
    table[:] = rng.integers(*I32, (n, width))
    perm = rng.permutation(n).astype(np.int32)
    j = int(np.flatnonzero(perm % 2 == first_parity)[0])
    perm[[0, j]] = perm[[j, 0]]
    return table, perm[:b].copy()


# Rows per block of the tile both kernels pick at b = 65,536 (and at
# every b down to the block edge below it); the card tests and
# chip_smoke.py's phase 5 take their edge batches from the same numbers.
BIG_BLOCK_ROWS = {4: 256, 6: 80}
STEP_EDGE = 42_240  # the W=6 scatter moves two rows a lane above this b


def _batch(label, width):
    """b for a label of _BATCHES: "edge-1", "edge", "edge+1" are one row
    short of, at and one past the last whole block of the big tile below
    65,536 rows."""
    if isinstance(label, int):
        return label
    per = BIG_BLOCK_ROWS[width]
    edge = (MAX_B - 1) // per * per
    return edge + {"edge-1": -1, "edge": 0, "edge+1": 1}[label]


MAX_B = 1 << 16
_BATCHES = [1, 2, 255, 256, 257, 4096, STEP_EDGE, STEP_EDGE + 1, "edge-1",
            "edge", "edge+1", MAX_B - 1, MAX_B]
# (width, dense buffer's bytes past a 16-byte boundary) the kernels take.
_LAYOUTS = [(4, 0), (6, 0), (6, 8)]


@pytest.mark.parametrize("first", [0, 1], ids=["even", "odd"])
@pytest.mark.parametrize("label", _BATCHES)
@pytest.mark.parametrize("width,offset", _LAYOUTS)
def test_gather_tiles_match_plain_version(row_lib, width, offset, label,
                                          first):
    b = _batch(label, width)
    rng = np.random.default_rng([width, b, offset, first])
    table, idx = _case(rng, max(2 * b, 64) + 3, b, width, first)
    out = _buffer((b, width), offset, fill=0x5A5A5A5A)
    visits = _move(row_lib, False, table, idx, out)
    assert (visits == 1).all()
    np.testing.assert_array_equal(out, _want_gather(table, idx))


@pytest.mark.parametrize("first", [0, 1], ids=["even", "odd"])
@pytest.mark.parametrize("label", _BATCHES)
@pytest.mark.parametrize("width,offset", _LAYOUTS)
def test_scatter_tiles_match_plain_version(row_lib, width, offset, label,
                                           first):
    b = _batch(label, width)
    rng = np.random.default_rng([width, b, offset, first, 1])
    table, idx = _case(rng, max(2 * b, 64) + 3, b, width, first)
    rows = _buffer((b, width), offset)
    rows[:] = rng.integers(*I32, (b, width))
    want = _want_scatter(table, idx, rows)
    visits = _move(row_lib, True, table, idx, rows)
    assert (visits == 1).all()
    np.testing.assert_array_equal(table, want)


@pytest.mark.parametrize("kind", ["gather", "scatter"])
@pytest.mark.parametrize("bad", ["-1", "N", "2^31-1"])
@pytest.mark.parametrize("width", row_ops.WIDTHS)
def test_indices_outside_the_table(row_lib, width, bad, kind):
    """An index outside [0, N) reads a zero row or drops its write, at
    the first, a middle and the last row of a batch over several
    blocks; the other rows move as ever, and the two rows past the
    table's end (in the same buffer) are neither read nor written."""
    rng = np.random.default_rng([width, len(bad), len(kind)])
    n, b = 20_011, 4097
    inner, idx = _case(rng, n, b, width, 1)
    full = _buffer((n + 2, width), 0)
    full[:n] = inner
    full[n:] = rng.integers(*I32, (2, width))
    table, guard = full[:n], full[n:].copy()
    idx[[0, b // 2, b - 1]] = {"-1": -1, "N": n, "2^31-1": I32[1]}[bad]
    if kind == "gather":
        out = _buffer((b, width), 0, fill=-1)
        _move(row_lib, False, table, idx, out)
        np.testing.assert_array_equal(out, _want_gather(table, idx))
        assert not out[[0, b // 2, b - 1]].any()
    else:
        rows = _buffer((b, width), 0)
        rows[:] = rng.integers(*I32, (b, width))
        want = _want_scatter(table, idx, rows)
        _move(row_lib, True, table, idx, rows)
        np.testing.assert_array_equal(table, want)
    np.testing.assert_array_equal(full[n:], guard)


@pytest.mark.parametrize("scatter", [False, True],
                         ids=["gather", "scatter"])
@pytest.mark.parametrize("b", [1, 255, 4096, 4097, STEP_EDGE + 1, MAX_B])
@pytest.mark.parametrize("width", row_ops.WIDTHS)
def test_picked_tile_covers_the_batch(row_lib, width, b, scatter):
    """The tile picked from b: the width's part (16 bytes for W=4, 8 for
    W=6); one row a lane for the gather, two for the scatter only where
    one would take more than half the warps the SMs hold; blocks that
    just cover b, of at most 256 lane steps, within the kernels' launch
    bounds; a block for every SM whenever one warp per block allows
    it."""
    t = _tile(row_lib, scatter, b, width)
    part = {4: 4, 6: 2}[width]
    assert t["part"] == part and t["lanes_per_row"] == width // part
    assert t["rows_per_warp"] == 32 // t["lanes_per_row"]
    warps = -(-b // t["rows_per_warp"])  # one step, one warp a block
    assert t["steps"] == (2 if scatter and warps > 32 * SMS else 1)
    assert t["threads"] % 32 == 0 and 32 <= t["threads"]
    assert t["threads"] * t["steps"] <= 256
    assert t["rows_per_block"] == (t["threads"] // 32 * t["rows_per_warp"]
                                   * t["steps"])
    assert (t["blocks"] - 1) * t["rows_per_block"] < b
    assert t["blocks"] * t["rows_per_block"] >= b
    assert t["blocks"] >= min(SMS, -(-warps // t["steps"]))


@pytest.mark.parametrize("scatter", [False, True],
                         ids=["gather", "scatter"])
@pytest.mark.parametrize("width", row_ops.WIDTHS)
def test_edge_batches_take_the_big_tile(row_lib, width, scatter):
    """The "edge" batches sit on a block edge of the tile picked at
    65,536 rows (BIG_BLOCK_ROWS), and the W=6 scatter changes its steps
    between STEP_EDGE and STEP_EDGE + 1, so those batches test what they
    are named for."""
    big = _tile(row_lib, scatter, MAX_B, width)
    assert big["rows_per_block"] == BIG_BLOCK_ROWS[width]
    edge = _batch("edge", width)
    assert edge % big["rows_per_block"] == 0
    for label, blocks in (("edge-1", 0), ("edge", 0), ("edge+1", 1)):
        want = dict(big, blocks=edge // big["rows_per_block"] + blocks)
        assert _tile(row_lib, scatter, _batch(label, width), width) == want
    steps = [_tile(row_lib, scatter, b, width)["steps"]
             for b in (STEP_EDGE, STEP_EDGE + 1)]
    assert steps == ([1, 2] if scatter and width == 6 else [1, 1])


@pytest.mark.parametrize("scatter", [False, True],
                         ids=["gather", "scatter"])
@pytest.mark.parametrize("width,offset", [(4, 4), (4, 8), (6, 4)])
def test_dense_buffer_off_its_part_is_refused(row_lib, width, offset,
                                              scatter):
    """A dense buffer not aligned to the width's part (16 bytes for W=4,
    8 for W=6) is refused, as the CUDA entry refuses it: nothing moves."""
    rng = np.random.default_rng([width, offset, scatter])
    table, idx = _case(rng, 64, 8, width, 0)
    before = table.copy()
    dense = _buffer((8, width), offset, fill=7)
    assert row_lib.tc_host_row_move(
        int(scatter), table.ctypes.data, table.shape[0], width,
        idx.ctypes.data, 8, dense.ctypes.data, None) == -1
    np.testing.assert_array_equal(table, before)
    assert (dense == 7).all()


def test_refused_launches(row_lib):
    """What the CUDA entry refuses, the shim refuses (-1): a table base
    off 16 bytes, a batch outside [1, 65,536], a width the kernels do not
    take."""
    table = _buffer((64, 4), 0)
    idx = np.arange(8, dtype=np.int32)
    out = _buffer((8, 4), 0)

    def call(t=table, b=8, width=4, dense=out):
        return row_lib.tc_host_row_move(
            0, t.ctypes.data, t.shape[0], width, idx.ctypes.data, b,
            dense.ctypes.data, None)

    assert call() == 0
    assert call(t=_buffer((64, 4), 8)) == -1
    assert call(t=_buffer((64, 4), 4)) == -1
    out6 = _buffer((8, 6), 0)
    assert call(t=_buffer((64, 6), 0), width=6, dense=out6) == 0
    assert call(t=_buffer((64, 6), 8), width=6, dense=out6) == -1
    assert call(b=0) == -1
    assert call(b=(1 << 16) + 1) == -1
    assert call(width=5) == -1
