"""The port's by-id window front end against the JAX package's by-id scans.

`kernel.byid_window` / `ids_window` / `ids20_window` expand a whole
window's ids into packed request rows, which `kernel.decide_window` (the
plain version of the window kernel) then decides; the table's by-id
entry points take that route.  On the same numpy inputs as
test_torch_byid.py it must decide as the JAX package's
`gcra_scan_{byid,ids,ids20}_acc`, and its packed rows must be, field by
field, the per-sub-batch request tuples of the composed scans.  Edge
lanes: ids sharing a slot, unresolved (slot -1) id rows, ids beyond the
resident rows (clamped and valid as words, invalid as raw ids), -1 and
ids20 sentinel padding, and a sub-batch in which one id fills more than
2^14 lanes.

Tolerance: exact equality (integer arithmetic throughout) on valid-lane
outputs, real-slot state rows and the expired-hit accumulator.
"""

import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_byid import (
    _CASES,
    _JAX_SCANS,
    _PORT_SCANS,
    CAP,
    K,
    N_IDS,
    VARIANTS,
    B,
    _mask,
    _stream,
    _valid,
    id_params,
    raw_ids,
)
from throttlecrab_tpu_torch.tpu import fused
from throttlecrab_tpu_torch.tpu import kernel as tk
from throttlecrab_tpu_torch.tpu.table import BucketTable
from torch_windows import NS, T0, fresh_state

_FRONTS = {
    "byid": tk.byid_window,
    "ids": tk.ids_window,
    "ids20": tk.ids20_window,
}
_TWINS = {
    "byid": lambda s, rows, q: tk._byid_batch(s, 0, rows, q),
    "ids": lambda s, rows, q: tk._ids_batch(s, 0, rows, q),
    "ids20": lambda s, rows, q: tk._ids_batch(
        tk._ids20_decode(s, s.shape[0] * 4 // 5), 0, rows, q),
}


def _window_scan(variant, state, acc, rows, stream, now, q, **kw):
    """The table's by-id route: front end, then the plain decision window."""
    packed = _FRONTS[variant](rows, stream, q)
    out, n_exp = tk.decide_window(state, packed, now, **kw)
    return state, acc + n_exp.sum(), out


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("width,compact,with_degen", _CASES)
def test_window_route_matches_jax(variant, width, compact, with_degen):
    """Two consecutive windows through the front end + decide_window and
    through the JAX by-id scan."""
    rng = np.random.default_rng(
        zlib.crc32(f"window{variant}{width}{compact}".encode())
    )
    slots, em, tol = id_params(rng, with_degen)
    rows = tk.pack_id_rows(slots, em, tol)
    q = int(rng.choice([0, 2])) if with_degen else int(rng.choice([1, 2]))
    st_j = jnp.asarray(fresh_state(CAP + B, width))
    st_t = torch.from_numpy(fresh_state(CAP + B, width))
    acc_j, acc_t = jnp.zeros((), jnp.int64), torch.zeros((), dtype=torch.int64)
    kw = dict(with_degen=with_degen, compact=compact)
    for step in range(2):
        ids = raw_ids(rng)
        stream = _stream(variant, ids, slots)
        now = T0 + step * 200 * NS + np.sort(rng.integers(0, 100 * NS, K))
        st_j, acc_j, out_j = _JAX_SCANS[variant](
            st_j, acc_j, jnp.asarray(rows), jnp.asarray(stream),
            jnp.asarray(now), q, **kw,
        )
        st_t, acc_t, out_t = _window_scan(
            variant, st_t, acc_t, torch.from_numpy(rows),
            torch.from_numpy(stream), torch.from_numpy(now), q, **kw,
        )
        oj, ot = np.asarray(out_j), out_t.numpy()
        assert oj.shape == ot.shape and oj.dtype == ot.dtype
        mask = _mask(_valid(variant, ids, stream, slots), compact)
        bad = (oj != ot) & mask
        assert not bad.any(), f"{step=}: {np.argwhere(bad)[:4]}"
        np.testing.assert_array_equal(np.asarray(st_j)[:CAP],
                                      st_t.numpy()[:CAP])
        assert int(acc_j) == int(acc_t)


@pytest.mark.parametrize("variant", VARIANTS)
def test_packed_window_is_the_sub_batch_tuples(variant):
    """Each sub-batch of the packed window holds, field by field, the
    request tuple `_byid_batch` / `_ids_batch` builds for it."""
    rng = np.random.default_rng(zlib.crc32(variant.encode()))
    slots, em, tol = id_params(rng, True)
    rows = torch.from_numpy(tk.pack_id_rows(slots, em, tol))
    stream = torch.from_numpy(_stream(variant, raw_ids(rng), slots))
    q = (1 << 33) + 5  # both halves of the quantity column in use
    packed = _FRONTS[variant](rows, stream, q)
    assert packed.dtype == torch.int32
    assert packed.shape == (K, B, tk.PACK_WIDTH)
    for k in range(K):
        got = tk._unpack_requests(packed[k], 0)
        want = _TWINS[variant](stream[k], rows, q)
        names = ("slots", "rank", "is_last", "emission", "tolerance",
                 "quantity", "valid")
        for name, a, b in zip(names, got, want):
            assert a.dtype == b.dtype, name
            assert torch.equal(a, b), f"sub-batch {k}: {name}"


def test_out_of_range_ids_and_padding():
    """An id beyond the resident rows is clamped and stays valid as a
    word, and is invalid as a raw id; -1 padding and the ids20 sentinel
    are invalid; an unresolved id row is invalid in every variant; ids
    sharing a slot form one segment."""
    slots = np.array([5, 9, 9, -1], np.int32)
    em = np.full(4, NS, np.int64)
    rows = torch.from_numpy(tk.pack_id_rows(slots, em, em * 3))
    ids = np.array([[1, 2, 7, -1, 3, 0, 2, 1]], np.int32)
    words = np.zeros(ids.shape, np.int64)
    seg = {}  # rank per slot, as tk_assemble_ids builds the words
    for i, x in enumerate(ids[0]):
        if x < 0:
            continue
        sl = int(slots[min(x, 3)])
        words[0, i] = ((seg.get(sl, 0) | (1 << 15)) << 32) | int(x)
        seg[sl] = seg.get(sl, 0) + 1
    valid = {}
    for variant, stream in (("byid", words), ("ids", ids),
                            ("ids20", tk.pack_ids20(ids))):
        packed = _FRONTS[variant](rows, torch.from_numpy(stream), 1)
        valid[variant] = (packed[0, :, 2] & tk.PACK_FLAG_VALID).bool().tolist()
        if variant != "byid":
            assert packed[0, :, 1].tolist() == [0, 1, 0, 0, 0, 0, 2, 3]
            is_last = (packed[0, :, 2] & tk.PACK_FLAG_IS_LAST).bool()
            assert is_last.tolist() == [0, 0, 1, 1, 1, 1, 0, 1]
    # id 7 is beyond the 4 rows: as a word it reads row 3 (slot -1).
    assert valid["byid"] == [True, True, False, False, False, True, True,
                             True]
    assert valid["ids"] == valid["ids20"] == [True, True, False, False,
                                              False, True, True, True]
    clamped = torch.from_numpy(tk.pack_id_rows(np.array([5, 9, 9, 11]),
                                               em, em * 3))
    packed = tk.byid_window(clamped, torch.from_numpy(words), 1)
    assert packed[0, 2, 0] == 11 and packed[0, 2, 2] & tk.PACK_FLAG_VALID
    packed = tk.ids_window(clamped, torch.from_numpy(ids), 1)
    assert not packed[0, 2, 2] & tk.PACK_FLAG_VALID


@pytest.mark.parametrize("variant", ["ids", "ids20"])
def test_segment_longer_than_2_14_lanes(variant):
    """One id fills 17,000 of a sub-batch's 20,000 lanes: its ranks run
    to 16,999 in the packed rank column (a 14-bit field would wrap), and
    the window decides as the JAX scan."""
    rng = np.random.default_rng(14)
    B, n = 20_000, 17_000
    slots, em, tol = id_params(rng, False)
    hot = 4 + int(np.flatnonzero(slots[4:] >= 0)[0])  # a slot of its own
    rows = tk.pack_id_rows(slots, em, tol)
    ids = rng.integers(0, N_IDS, (2, B)).astype(np.int32)
    ids[ids == hot] = hot + 1
    ids[0, rng.choice(B, n, replace=False)] = hot
    ids[1, :5] = -1
    stream = tk.pack_ids20(ids) if variant == "ids20" else ids
    packed = _FRONTS[variant](torch.from_numpy(rows),
                              torch.from_numpy(stream), 1)
    on_hot = torch.from_numpy(ids[0] == hot)
    ranks = packed[0, :, 1][on_hot]
    assert torch.equal(ranks, torch.arange(n, dtype=torch.int32))
    now = T0 + np.array([0, 3 * NS], np.int64)
    kw = dict(with_degen=False, compact="cur")
    st_j, acc_j, out_j = _JAX_SCANS[variant](
        jnp.asarray(fresh_state(CAP + B, 4)), jnp.zeros((), jnp.int64),
        jnp.asarray(rows), jnp.asarray(stream), jnp.asarray(now), 1, **kw,
    )
    st_t, acc_t, out_t = _window_scan(
        variant, torch.from_numpy(fresh_state(CAP + B, 4)),
        torch.zeros((), dtype=torch.int64), torch.from_numpy(rows),
        torch.from_numpy(stream), torch.from_numpy(now), 1, **kw,
    )
    valid = _valid(variant, ids, stream, slots)
    assert not ((np.asarray(out_j) != out_t.numpy()) & valid).any()
    np.testing.assert_array_equal(np.asarray(st_j)[:CAP], st_t.numpy()[:CAP])
    assert int(acc_j) == int(acc_t)


def test_device_segments_batched_rows_match_one_by_one():
    """_device_segments over [K, B] equals it on each row alone."""
    rng = np.random.default_rng(3)
    key = torch.from_numpy(rng.integers(0, 7, (5, 129)).astype(np.int32))
    rank, last = tk._device_segments(key)
    for k in range(key.shape[0]):
        r, l = tk._device_segments(key[k])
        assert torch.equal(rank[k], r) and torch.equal(last[k], l)


@pytest.mark.parametrize("width", [4, 6])
@pytest.mark.parametrize("variant", VARIANTS)
def test_table_entry_points_take_the_window_route(
    monkeypatch, variant, width
):
    """check_many_{byid,ids,ids20} on cpu reach
    fused.gcra_scan_packed_fused_acc once per call (the `_acc` window on
    an insight table too, whose totals stay put) and decide as the
    composed scan on the same inputs."""
    calls = []
    window = fused.gcra_scan_packed_fused_acc

    def spy(state, exp_acc, packed, now, **kw):
        calls.append(tuple(packed.shape))
        return window(state, exp_acc, packed, now, **kw)

    def no_ins(*a, **kw):
        raise AssertionError("by-id windows leave the insight totals alone")

    monkeypatch.setattr(fused, "gcra_scan_packed_fused_acc", spy)
    monkeypatch.setattr(fused, "gcra_scan_packed_fused_ins", no_ins)
    rng = np.random.default_rng(41 + width)
    slots, em, tol = id_params(rng, False)
    table = BucketTable(CAP, device="cpu", insight=width > 4)
    rows = table.upload_id_rows(slots, em, tol)
    state = table.state.clone()
    acc = torch.zeros((), dtype=torch.int64)
    for step in range(2):
        ids = raw_ids(rng)
        stream = _stream(variant, ids, slots)
        now = np.full(K, T0 + step * 300 * NS, np.int64)
        out = getattr(table, "check_many_" + variant)(
            rows, stream, now, 2, with_degen=False, compact="w32"
        )
        state, acc, want = _PORT_SCANS[variant](
            state, acc, rows, torch.from_numpy(stream),
            torch.from_numpy(now), 2, with_degen=False, compact="w32",
        )
        valid = torch.from_numpy(_valid(variant, ids, stream, slots))
        assert torch.equal(out[valid], want[valid])
        assert torch.equal(table.state[:CAP], state[:CAP])
        assert table.expired_hits() == int(acc)
    assert calls == [(K, B, tk.PACK_WIDTH)] * 2
    assert table.insight_counts() == (0, 0)
