"""The port's by-id launch path against the JAX package's.

`gcra_scan_{byid,ids,ids20}_acc` (and their plain twins) and the
`BucketTable` entry points (`upload_id_rows`, `check_many_byid`,
`check_many_ids`, `check_many_ids20`) run on device="cpu", where the
row gather/scatter take their plain version, against the JAX package's
composed-XLA scans on the same numpy inputs: every output tier, both row
widths, duplicate keys and ids sharing a slot, -1 padding, ids beyond
the resident rows, and unresolved (slot -1) id rows.  One case runs the
JAX reference in a subprocess with THROTTLECRAB_PALLAS=1, so its rows
move through the Pallas row kernels in interpret mode.

Tolerance: exact equality (integer arithmetic throughout) on valid-lane
outputs, real-slot state rows and the expired-hit accumulator.
"""

import os
import subprocess
import sys
import zlib
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from throttlecrab_tpu.tpu import kernel as jk
from throttlecrab_tpu.tpu.table import BucketTable as JaxTable
from throttlecrab_tpu_torch.tpu import kernel as tk
from throttlecrab_tpu_torch.tpu.table import (
    BucketTable,
    ResidentIdRows,
    StaleIdRowsError,
)
from torch_windows import NS, T0, TIERS, fresh_state

REPO = Path(__file__).resolve().parent.parent
CAP, N_IDS, K, B = 128, 48, 3, 64
VARIANTS = ("byid", "ids", "ids20")


def id_params(rng, degen):
    """(slots i32[N_IDS], em i64, tol i64): ids 2 and 3 share a slot,
    about one id in ten is unresolved (slot -1)."""
    slots = rng.choice(CAP, N_IDS, replace=False).astype(np.int32)
    slots[3] = slots[2]
    slots[rng.random(N_IDS) < 0.1] = -1
    slots[2] = max(slots[2], 0)
    if degen:
        em = rng.choice([0, 1, 1000, NS, 7 * NS, 1 << 62], N_IDS)
        tol = rng.choice([0, 5, NS, 100 * NS, (1 << 61) + 7, -(3 * NS)],
                         N_IDS)
    else:
        em = rng.choice([1, 1000, NS, 7 * NS], N_IDS)
        tol = rng.choice([1, 5, NS, 100 * NS], N_IDS)
    return slots, np.asarray(em, np.int64), np.asarray(tol, np.int64)


def raw_ids(rng):
    """i32[K, B] over a hot set (long segments), with -1 padding and ids
    beyond the resident rows."""
    ids = np.where(
        rng.random((K, B)) < 0.5,
        rng.integers(0, 6, (K, B)),
        rng.integers(0, N_IDS, (K, B)),
    )
    ids[rng.random((K, B)) < 0.08] = -1
    ids[rng.random((K, B)) < 0.04] = N_IDS + 3
    return ids.astype(np.int32)


def words_of(ids, slots):
    """tk_assemble_ids words for `ids`: segments per slot, in arrival
    order.  Ids beyond the rows keep their valid bit (the scan clips
    them, as the JAX scan does); padding is invalid."""
    words = np.zeros(ids.shape, np.int64)
    for k in range(ids.shape[0]):
        seen: dict = {}
        for i, x in enumerate(ids[k]):
            if x < 0:
                words[k, i] = int(x) & 0xFFFFFFFF
                continue
            sl = int(slots[min(int(x), N_IDS - 1)])
            rank = 0
            if sl in seen:
                rank, last = seen[sl]
                words[k, last] &= ~(1 << (32 + 14))
            seen[sl] = (rank + 1, i)
            meta = rank | (1 << 14) | (1 << 15)
            words[k, i] = (meta << 32) | int(x)
    return words


def valid_lanes(variant, stream, slots):
    if variant == "byid":
        idx = np.clip(stream & 0xFFFFFFFF, 0, N_IDS - 1)
        return (((stream >> 32) & (1 << 15)) != 0) & (slots[idx] >= 0)
    return (stream >= 0) & (stream < N_IDS) & (
        slots[np.clip(stream, 0, N_IDS - 1)] >= 0
    )


def _valid(variant, ids, stream, slots):
    return valid_lanes(variant, ids if variant == "ids20" else stream, slots)


def _stream(variant, ids, slots):
    if variant == "byid":
        return words_of(ids, slots)
    if variant == "ids20":
        return jk.pack_ids20(ids)
    return ids


def _mask(valid, compact):
    return valid if compact in ("cur", "w32") else valid[:, None, :]


_JAX_SCANS = {
    "byid": jk.gcra_scan_byid_acc,
    "ids": jk.gcra_scan_ids_acc,
    "ids20": jk.gcra_scan_ids20_acc,
}
_PORT_SCANS = {
    "byid": tk.gcra_scan_byid_acc,
    "ids": tk.gcra_scan_ids_acc,
    "ids20": tk.gcra_scan_ids20_acc,
}


# Every tier on 4-wide rows; the insight layout on one exact and one
# certified tier.
_CASES = [(4, c, d) for c, d in TIERS] + [(6, False, True), (6, "w32", False)]


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("width,compact,with_degen", _CASES)
def test_scan_matches_jax(variant, width, compact, with_degen):
    """Two consecutive windows through the port's scan and the JAX one."""
    rng = np.random.default_rng(
        zlib.crc32(f"{variant}{width}{compact}".encode())
    )
    slots, em, tol = id_params(rng, with_degen)
    rows = tk.pack_id_rows(slots, em, tol)
    np.testing.assert_array_equal(rows, jk.pack_id_rows(slots, em, tol))
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
        st_t, acc_t, out_t = _PORT_SCANS[variant](
            st_t, acc_t, torch.from_numpy(rows), torch.from_numpy(stream),
            torch.from_numpy(now), q, **kw,
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
def test_plain_twin_matches_acc(variant):
    """gcra_scan_{byid,ids,ids20} decide as their _acc twins do."""
    rng = np.random.default_rng(7)
    slots, em, tol = id_params(rng, False)
    rows = torch.from_numpy(tk.pack_id_rows(slots, em, tol))
    stream = torch.from_numpy(_stream(variant, raw_ids(rng), slots))
    now = torch.full((K,), T0, dtype=torch.int64)
    plain = {"byid": tk.gcra_scan_byid, "ids": tk.gcra_scan_ids,
             "ids20": tk.gcra_scan_ids20}[variant]
    st1, out1 = plain(torch.from_numpy(fresh_state(CAP + B, 4)), rows,
                      stream, now, 1, with_degen=False, compact="cur")
    st2, acc, out2 = _PORT_SCANS[variant](
        torch.from_numpy(fresh_state(CAP + B, 4)),
        torch.zeros((), dtype=torch.int64), rows, stream, now, 1,
        with_degen=False, compact="cur",
    )
    assert torch.equal(out1, out2) and torch.equal(st1, st2)
    assert int(acc) == 0


def test_device_segments_keep_arrival_order():
    """Ties keep arrival order: rank counts earlier equal keys, is_last
    marks the final one; the JAX twin agrees bit for bit."""
    rng = np.random.default_rng(5)
    key = rng.integers(0, 9, 257).astype(np.int32)
    rank, last = tk._device_segments(torch.from_numpy(key))
    jr, jl = jk._device_segments(jnp.asarray(key))
    rank, last = rank.numpy(), last.numpy()
    np.testing.assert_array_equal(rank, np.asarray(jr))
    np.testing.assert_array_equal(last, np.asarray(jl))
    for i, x in enumerate(key):
        assert rank[i] == (key[:i] == x).sum()
        assert bool(last[i]) == (not (key[i + 1:] == x).any())


def _tables(width):
    jt, tt = JaxTable(CAP), BucketTable(CAP, device="cpu")
    if width > 4:
        jt.enable_insight()
        tt.enable_insight()
    return jt, tt


@pytest.mark.parametrize("width", [4, 6])
def test_table_entry_points_match_jax(width):
    """upload_id_rows + check_many_byid/_ids/_ids20 in turn on one table:
    outputs, real-slot state, expired hits and both high-water marks."""
    rng = np.random.default_rng(31 + width)
    slots, em, tol = id_params(rng, False)
    jt, tt = _tables(width)
    rj = jt.upload_id_rows(slots, em, tol)
    rt = tt.upload_id_rows(slots, em, tol)
    assert isinstance(rt, torch.Tensor) and rt.device == tt.device
    np.testing.assert_array_equal(np.asarray(rj), rt.numpy())
    assert jt.tol_hwm == tt.tol_hwm
    now = T0
    for variant, compact in (("byid", "cur"), ("ids", "w32"),
                             ("ids20", "w32"), ("byid", False)):
        ids = raw_ids(rng)
        stream = _stream(variant, ids, slots)
        nows = np.full(K, now, np.int64)
        fn = "check_many_" + variant
        oj = np.asarray(getattr(jt, fn)(
            rj, stream, nows, 1, with_degen=compact is False, compact=compact
        ))
        ot = getattr(tt, fn)(
            rt, stream, nows, 1, with_degen=compact is False, compact=compact
        ).numpy()
        valid = _valid(variant, ids, stream, slots)
        assert not ((oj != ot) & _mask(valid, compact)).any(), variant
        np.testing.assert_array_equal(np.asarray(jt.state)[:CAP],
                                      tt.state.numpy()[:CAP])
        assert jt.expired_hits() == tt.expired_hits()
        assert (jt.now_hwm, jt.tol_hwm, jt.cur_safe) == (
            tt.now_hwm, tt.tol_hwm, tt.cur_safe)
        now += 700 * NS


class _Keymap:
    mutations = 0


def test_stale_id_rows_guard():
    """A keymap mutation after upload makes every by-id launch raise
    StaleIdRowsError until the rows are uploaded again."""
    km = _Keymap()
    t = BucketTable(64, device="cpu")
    slots = np.arange(8, dtype=np.int32)
    em = np.full(8, NS, np.int64)
    rows = t.upload_id_rows(slots, em, em * 4, keymap=km)
    assert isinstance(rows, ResidentIdRows)
    ids = np.arange(8, dtype=np.int32).reshape(1, 8)
    now = np.array([T0], np.int64)
    kw = dict(with_degen=False, compact="cur")
    t.check_many_ids(rows, ids, now, 1, **kw)
    km.mutations += 1
    for call, stream in (
        (t.check_many_byid, words_of(ids, slots)),
        (t.check_many_ids, ids),
        (t.check_many_ids20, tk.pack_ids20(ids)),
    ):
        with pytest.raises(StaleIdRowsError):
            call(rows, stream, now, 1, **kw)
    rows = t.upload_id_rows(slots, em, em * 4, keymap=km)
    t.check_many_byid(rows, words_of(ids, slots), now, 1, **kw)


def test_ids20_guards():
    t = BucketTable(64, device="cpu")
    rows = t.upload_id_rows(np.arange(4, dtype=np.int32),
                            np.full(4, NS, np.int64),
                            np.full(4, 2 * NS, np.int64))
    now = np.array([T0], np.int64)
    with pytest.raises(ValueError, match="pack_ids20"):
        t.check_many_ids20(rows, np.zeros((1, 5), np.int32), now)
    with pytest.raises(ValueError, match="pack_ids20"):
        t.check_many_ids20(rows, np.zeros((1, 8), np.uint16), now)
    with pytest.raises(ValueError, match="sentinel"):
        t.check_many_ids20(torch.zeros((1 << 20, 8), dtype=torch.int32),
                           tk.pack_ids20(np.zeros((1, 4), np.int32)), now)
    with pytest.raises(ValueError, match="multiple of 5"):
        tk.gcra_scan_ids20(fresh_state_t(64), rows,
                           torch.zeros((1, 8), dtype=torch.uint16),
                           torch.from_numpy(now), 1)
    ids = np.array([[0, 1, 0xFFFF, 0x9FFFE, -1, 7, 8, 9]], np.int32)
    np.testing.assert_array_equal(tk.pack_ids20(ids), jk.pack_ids20(ids))
    for bad in (np.full((1, 8), tk.IDS20_SENTINEL, np.int32),
                np.zeros((1, 6), np.int32)):
        with pytest.raises(ValueError):
            tk.pack_ids20(bad)


def fresh_state_t(rows):
    return torch.from_numpy(fresh_state(rows, 4))


_PALLAS_RUNNER = r"""
import sys
import jax
jax.config.update("jax_platforms", "cpu")
import numpy as np
import jax.numpy as jnp
import throttlecrab_tpu  # enables x64
from throttlecrab_tpu.tpu import kernel, pallas_ops

assert pallas_ops.enabled()
d = np.load(sys.argv[1])
out = {}
for variant in ("byid", "ids"):
    scan = getattr(kernel, f"gcra_scan_{variant}_acc")
    st, acc, o = scan(
        jnp.asarray(d["state"]), jnp.zeros((), jnp.int64),
        jnp.asarray(d["rows"]), jnp.asarray(d[variant]),
        jnp.asarray(d["now"]), 1, with_degen=True, compact=False,
    )
    out[variant + "_state"] = np.asarray(st)
    out[variant + "_acc"] = np.asarray(acc)
    out[variant + "_out"] = np.asarray(o)
np.savez(sys.argv[2], **out)
print("OK")
"""


def test_scans_match_jax_through_pallas_rows(tmp_path):
    """The JAX reference with THROTTLECRAB_PALLAS=1 (its state rows moved
    by pallas_ops.row_gather/row_scatter in interpret mode) against the
    port on the same inputs; a subprocess, as the flag is read when the
    scan is traced."""
    rng = np.random.default_rng(77)
    slots, em, tol = id_params(rng, True)
    rows = tk.pack_id_rows(slots, em, tol)
    ids = raw_ids(rng)[:2]
    now = T0 + np.array([0, 40 * NS], np.int64)
    state = fresh_state(CAP + B, 4)
    inputs = dict(state=state, rows=rows, now=now, ids=ids,
                  byid=words_of(ids, slots))
    np.savez(tmp_path / "in.npz", **inputs)
    env = dict(os.environ, THROTTLECRAB_PALLAS="1", JAX_PLATFORMS="cpu",
               PYTHONPATH=str(REPO))
    r = subprocess.run(
        [sys.executable, "-c", _PALLAS_RUNNER, str(tmp_path / "in.npz"),
         str(tmp_path / "out.npz")],
        env=env, capture_output=True, text=True, timeout=600,
    )
    assert r.returncode == 0, r.stderr[-3000:]
    ref = np.load(tmp_path / "out.npz")
    for variant in ("byid", "ids"):
        st, acc, out = _PORT_SCANS[variant](
            torch.from_numpy(state.copy()), torch.zeros((), dtype=torch.int64),
            torch.from_numpy(rows), torch.from_numpy(inputs[variant]),
            torch.from_numpy(now), 1, with_degen=True, compact=False,
        )
        valid = valid_lanes(variant, inputs[variant], slots)
        bad = (ref[variant + "_out"] != out.numpy()) & valid[:, None, :]
        assert not bad.any(), variant
        np.testing.assert_array_equal(ref[variant + "_state"][:CAP],
                                      st.numpy()[:CAP])
        assert int(ref[variant + "_acc"]) == int(acc)
