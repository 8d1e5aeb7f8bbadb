"""The port's snapshot (tpu/snapshot.py) against the JAX package's.

A file saved by either package must load in the other: after the same
traffic, both packages write the same .npz members; a file restored by
the port and by the JAX package gives the same per-key state, the same
certificates (`cur_safe`, `tol_hwm`, `now_hwm`) and the same decisions
in the next window.  Covered: the python and native keymaps (and restores
across them), W = 4 and the insight layout W = 6, str / bytes /
NUL-bearing / non-UTF-8 / lone-surrogate keys, expired entries, a
non-empty target, a pathological foreign tolerance, two keys resolving
to one slot, a chunked restore, corrupt files, and the server's boot
restore and shutdown save.  The port runs on device="cpu", where the row
wrappers take their plain versions.  Tolerance: exact equality.
"""

import json
import os
import signal
import socket
import subprocess
import sys
import time
import urllib.request
from pathlib import Path

import numpy as np
import pytest

from throttlecrab_tpu.tpu import snapshot as jsnap
from throttlecrab_tpu.tpu.limiter import TpuRateLimiter
from throttlecrab_tpu_torch.server import __main__ as port_main
from throttlecrab_tpu_torch.server.config import Config
from throttlecrab_tpu_torch.tpu import row_ops
from throttlecrab_tpu_torch.tpu import snapshot as psnap
from throttlecrab_tpu_torch.tpu.limiter import TorchRateLimiter

REPO = Path(__file__).resolve().parent.parent
NS = 1_000_000_000
T0 = 1_753_700_000 * NS
I64_MAX = (1 << 63) - 1
_FIELDS = ("allowed", "limit", "remaining", "reset_after_ns",
           "retry_after_ns", "status")


def _jax(keymap="python", insight=False, capacity=256):
    return TpuRateLimiter(capacity=capacity, keymap=keymap, insight=insight)


def _port(keymap="python", insight=False, capacity=256):
    return TorchRateLimiter(
        capacity=capacity, keymap=keymap, device="cpu", insight=insight
    )


def _keys(keymap, n):
    """A key pool: plain and NUL-bearing str keys; with the python keymap
    also bytes (non-UTF-8 too) and lone-surrogate keys; with the native
    keymap bytes keys (non-UTF-8 too)."""
    keys = [f"user:{i}" for i in range(n)] + ["a\x00b", "nul\x00"]
    keys += [b"\xff\xfe", b"raw:\x00\x01"]
    if keymap == "python":
        keys += ["lone\ud800", "\udcff"]
    return keys


def _traffic(rng, keys, n):
    """One window: Zipf-ish key picks, per-key params; a tenth of the keys
    have 1-2 s periods, so their entries (TTL <= 20 s) expire before a
    restore 30 s later, while the others (TTL >= 170 s) survive."""
    p = np.arange(1, len(keys) + 1, dtype=np.float64) ** -1.1
    ix = rng.choice(len(keys), size=n, p=p / p.sum())
    picked = [keys[i] for i in ix]
    burst = 2 + ix % 5
    count = 1 + ix % 7
    period = np.where(ix % 10 == 3, 1 + ix % 2, 600 + 30 * (ix % 40))
    q = np.where(ix % 13 == 0, 0, 1 + (ix % 3 == 0))
    return picked, burst, count, period, q


def _drive(lims, rng, keys, windows=4, n=48, start=T0):
    """Every key of the pool once, then `windows` windows of traffic."""
    now = start
    for lim in lims:
        lim.rate_limit_batch(keys, 3, 1, 600, 1, now)
    for _ in range(windows):
        batch = _traffic(rng, keys, n)
        for lim in lims:
            lim.rate_limit_batch(*batch, now)
        now += int(rng.integers(0, NS // 2))
    return now


def _state(mod, lim):
    keys, _, _, tat, exp, _, _ = mod.export_state(lim)
    return {k: (int(t), int(e)) for k, t, e in zip(keys, tat, exp)}


def _certs(lim):
    t = lim.table
    return bool(t.cur_safe), int(t.tol_hwm), int(t.now_hwm)


def _same_results(r_j, r_t):
    for f in _FIELDS:
        a, b = np.asarray(getattr(r_j, f)), np.asarray(getattr(r_t, f))
        assert a.shape == b.shape and (a == b).all(), f


def _npz(path):
    with np.load(path) as data:
        return {k: data[k] for k in data.files}


@pytest.mark.parametrize("insight", [False, True], ids=["w4", "w6"])
@pytest.mark.parametrize("keymap", ["python", "native"])
def test_same_traffic_writes_the_same_file(tmp_path, keymap, insight):
    rng = np.random.default_rng(7)
    jl, pl = _jax(keymap, insight), _port(keymap, insight)
    _drive([jl, pl], rng, _keys(keymap, 40))
    assert jsnap.save_snapshot(jl, tmp_path / "j") == psnap.save_snapshot(
        pl, tmp_path / "p"
    )
    fj, fp = _npz(tmp_path / "j.npz"), _npz(tmp_path / "p.npz")
    assert sorted(fj) == sorted(fp)
    for name in fj:
        assert fj[name].dtype == fp[name].dtype, name
        assert np.array_equal(fj[name], fp[name]), name


@pytest.mark.parametrize("insight", [False, True], ids=["w4", "w6"])
@pytest.mark.parametrize("dst", ["python", "native"])
@pytest.mark.parametrize("src", ["python", "native"])
@pytest.mark.parametrize("saver", ["port", "jax"])
def test_file_of_either_package_restores_identically(
    tmp_path, saver, src, dst, insight
):
    """Save with one package, restore into a fresh JAX and a fresh port
    limiter: per-key state, certificates, the next two windows' decisions
    and the state after them are identical."""
    rng = np.random.default_rng(11)
    # A lone surrogate cannot reach a native keymap (str keys encode).
    keys = _keys("python" if src == dst == "python" else "native", 40)
    saving = _port(src, insight) if saver == "port" else _jax(src, insight)
    now = _drive([saving], rng, keys)
    mod = psnap if saver == "port" else jsnap
    path = tmp_path / "snap.npz"
    mod.save_snapshot(saving, path)

    jl, pl = _jax(dst, insight), _port(dst, insight)
    restore_at = now + 30 * NS  # past the short-period entries' TTL
    n_j = jsnap.load_snapshot(jl, path, restore_at)
    n_p = psnap.load_snapshot(pl, path, restore_at)
    assert n_j == n_p and 0 < n_p < len(saving)  # some entries expired
    assert _state(jsnap, jl) == _state(psnap, pl)
    assert _certs(jl) == _certs(pl)
    assert pl.table.state.shape[-1] == (6 if insight else 4)

    if src == "native" and dst == "python":
        # The restore decoded the native keymap's bytes keys to str.
        keys = [k.decode("utf-8", "surrogateescape") if isinstance(k, bytes)
                else k for k in keys]
    for step in range(2):
        batch = _traffic(rng, keys, 48)
        t = restore_at + step * NS
        _same_results(jl.rate_limit_batch(*batch, t),
                      pl.rate_limit_batch(*batch, t))
    assert _state(jsnap, jl) == _state(psnap, pl)


@pytest.mark.parametrize("saver", ["port", "jax"])
def test_restore_drops_expired_and_refuses_non_empty_target(tmp_path, saver):
    mod = psnap if saver == "port" else jsnap
    lim = _port() if saver == "port" else _jax()
    lim.rate_limit("short", 2, 10, 1, 1, T0)  # TTL ~1 s
    lim.rate_limit("long", 2, 10, 3600, 1, T0)  # TTL ~1 h
    path = tmp_path / "snap.npz"
    assert mod.save_snapshot(lim, path) == 2
    for loader, fresh in ((psnap, _port), (jsnap, _jax)):
        target = fresh()
        assert loader.load_snapshot(target, path, T0 + 100 * NS) == 1
        assert list(_state(loader, target)) == ["long"]
    with pytest.raises(ValueError, match="empty limiter"):
        psnap.load_snapshot(lim if saver == "port" else _port_with_key(),
                            path, T0)


def _port_with_key():
    lim = _port()
    lim.rate_limit("x", 2, 10, 60, 1, T0)
    return lim


@pytest.mark.parametrize("keymap", ["python", "native"])
def test_empty_snapshot_round_trip(tmp_path, keymap):
    path = tmp_path / "empty.npz"
    assert psnap.save_snapshot(_port(keymap), path) == 0
    target = _port(keymap)
    assert psnap.load_snapshot(target, path, T0) == 0
    assert len(target) == 0
    assert jsnap.load_snapshot(_jax(keymap), path, T0) == 0


def _craft(path, keys, tats, expiries, source_bytes_keys=0):
    offsets = np.zeros(len(keys) + 1, np.int64)
    np.cumsum([len(k) for k in keys], out=offsets[1:])
    np.savez_compressed(
        path,
        version=np.int64(2),
        capacity=np.int64(256),
        slots=np.arange(len(keys), dtype=np.int64),
        shard=np.zeros(len(keys), np.int32),
        n_shards=np.int64(1),
        tat=np.asarray(tats, np.int64),
        expiry=np.asarray(expiries, np.int64),
        key_offsets=offsets,
        key_blob=np.frombuffer(b"".join(keys), np.uint8),
        key_is_bytes=np.zeros(len(keys), np.uint8),
        key_codec=np.zeros(len(keys), np.uint8),
        source_bytes_keys=np.uint8(source_bytes_keys),
        meta=np.frombuffer(
            json.dumps({"n_keys": len(keys)}).encode(), np.uint8
        ),
    )


@pytest.mark.parametrize(
    "tats,expiries",
    [
        # A negative TAT under an I64_MAX expiry: expiry - tat exceeds
        # i64, so the tolerance mark saturates (w32 stays off).
        ([T0, -(1 << 62)], [T0 + 3600 * NS, I64_MAX]),
        # A well-formed snapshot seeds the exact recovered max.
        ([T0, T0 + NS], [T0 + 60 * NS, T0 + 121 * NS]),
        # A TAT >= 2^62 clears cur_safe.
        ([T0, (1 << 62) + 5], [T0 + 60 * NS, I64_MAX]),
    ],
    ids=["pathological-tol", "normal", "tat-above-cur-bound"],
)
def test_restored_certificates_equal_jax(tmp_path, tats, expiries):
    path = tmp_path / "foreign.npz"
    _craft(path, [b"ok", b"other"], tats, expiries)
    jl, pl = _jax(), _port()
    with np.errstate(over="raise"):  # a wrap would raise, not corrupt
        assert psnap.load_snapshot(pl, path, T0) == 2
    assert jsnap.load_snapshot(jl, path, T0) == 2
    assert _certs(jl) == _certs(pl)
    assert _state(jsnap, jl) == _state(psnap, pl)


def test_big_tolerance_state_restores_without_cur_certificate(tmp_path):
    big = (3_000_000_000, 1, 1, 3_000_000_000)  # tol ~3e18
    pl = _port()
    assert bool(pl.rate_limit_batch(["k"], *big, T0, wire=True).allowed[0])
    assert pl.table.cur_safe is False
    path = tmp_path / "poison.npz"
    psnap.save_snapshot(pl, path)
    jl, pl2 = _jax(), _port()
    jsnap.load_snapshot(jl, path, T0 + NS)
    psnap.load_snapshot(pl2, path, T0 + NS)
    assert _certs(pl2) == _certs(jl) and pl2.table.cur_safe is False
    _same_results(jl.rate_limit_batch(["k"], 10, 100, 60, 1, T0 + NS),
                  pl2.rate_limit_batch(["k"], 10, 100, 60, 1, T0 + NS))


@pytest.mark.parametrize("saver", ["port", "jax"])
def test_two_keys_on_one_slot_keep_the_last(tmp_path, saver):
    """A python keymap holding "a" and b"a" restored into a native keymap:
    both become b"a".  The JAX restore's `.at[].set` keeps the last row;
    the port keeps the last occurrence before the (unique-index)
    scatter, and counts both keys as JAX does."""
    lim = _port() if saver == "port" else _jax()
    lim.rate_limit("a", 5, 10, 3600, 1, T0)
    for _ in range(3):
        lim.rate_limit(b"a", 5, 10, 3600, 1, T0)
    path = tmp_path / "dup.npz"
    (psnap if saver == "port" else jsnap).save_snapshot(lim, path)
    jl, pl = _jax("native"), _port("native")
    assert jsnap.load_snapshot(jl, path, T0) == 2
    assert psnap.load_snapshot(pl, path, T0) == 2
    assert len(pl) == 1
    assert _state(jsnap, jl) == _state(psnap, pl)
    _same_results(jl.rate_limit_batch([b"a"], 5, 10, 3600, 1, T0 + 1),
                  pl.rate_limit_batch([b"a"], 5, 10, 3600, 1, T0 + 1))


@pytest.mark.parametrize("chunk", [1, 3, 7])
def test_chunked_gather_and_scatter(tmp_path, monkeypatch, chunk):
    """With MAX_BATCH cut to `chunk`, export and restore take
    ceil(n / chunk) row-op calls each and give the unchunked result."""
    keys = [f"k{i}" for i in range(20)]
    pl = _port()
    pl.rate_limit_batch(keys, 3, 5, 60, 1, T0)
    whole = tmp_path / "whole.npz"
    psnap.save_snapshot(pl, whole)
    calls = {"gather": 0, "scatter": 0}
    gather, scatter = row_ops.row_gather, row_ops.row_scatter

    def counted_gather(table, idx):
        calls["gather"] += 1
        assert len(idx) <= chunk
        return gather(table, idx)

    def counted_scatter(table, idx, rows):
        calls["scatter"] += 1
        assert len(idx) <= chunk
        return scatter(table, idx, rows)

    monkeypatch.setattr(row_ops, "MAX_BATCH", chunk)
    monkeypatch.setattr(row_ops, "row_gather", counted_gather)
    monkeypatch.setattr(row_ops, "row_scatter", counted_scatter)
    cut = tmp_path / "cut.npz"
    psnap.save_snapshot(pl, cut)
    target = _port()
    psnap.load_snapshot(target, cut, T0)
    assert calls == {"gather": -(-20 // chunk), "scatter": -(-20 // chunk)}
    assert _npz(whole).keys() == _npz(cut).keys()
    for name, arr in _npz(whole).items():
        assert np.array_equal(arr, _npz(cut)[name]), name
    assert _state(psnap, target) == _state(psnap, pl)
    cap = pl.table.capacity  # real rows; the scratch tail differs
    assert np.array_equal(target.table.state[:cap].numpy(),
                          pl.table.state[:cap].numpy())


def _corrupt(path, kind):
    """Write a corrupted variant of a good snapshot to `path`."""
    good = path.with_name("good.npz")
    lim = _port()
    lim.rate_limit_batch([f"k{i}" for i in range(30)], 3, 5, 3600, 1, T0)
    psnap.save_snapshot(lim, good)
    raw = good.read_bytes()
    members = _npz(good)
    if kind.startswith("truncated"):
        frac = int(kind.split("-")[1]) / 100
        path.write_bytes(raw[: int(len(raw) * frac)])
        return
    if kind == "garbage":
        path.write_bytes(np.random.default_rng(3).bytes(len(raw)))
        return
    if kind == "missing-column":
        del members["expiry"]
    elif kind == "bad-version":
        members["version"] = np.int64(99)
    elif kind == "short-tat":
        members["tat"] = members["tat"][:-1]
    elif kind == "bad-offsets":
        members["key_offsets"] = members["key_offsets"][::-1].copy()
    elif kind == "bad-meta":
        members["meta"] = np.frombuffer(b"{not json", np.uint8)
    np.savez_compressed(path, **members)


@pytest.mark.parametrize("kind", [
    "truncated-10", "truncated-50", "truncated-90", "garbage",
    "missing-column", "bad-version", "short-tat", "bad-offsets", "bad-meta",
])
def test_corrupt_files_raise_snapshot_error(tmp_path, kind):
    path = tmp_path / "bad.npz"
    _corrupt(path, kind)
    with pytest.raises(psnap.SnapshotError):
        psnap.load_snapshot(_port(), path, T0)
    with pytest.raises(jsnap.SnapshotError):
        jsnap.load_snapshot(_jax(), path, T0)


@pytest.mark.parametrize("strict", [True, False])
def test_boot_restore_strict_and_non_strict(tmp_path, strict):
    bad = tmp_path / "bad.npz"
    _corrupt(bad, "truncated-50")
    cfg = Config(http=True, device="cpu", snapshot_path=str(bad),
                 snapshot_strict=strict)
    lim = _port()
    if strict:
        with pytest.raises(port_main.SnapshotRefused):
            port_main.restore_snapshot_on_boot(lim, cfg)
    else:
        assert port_main.restore_snapshot_on_boot(lim, cfg) == 0
    assert len(lim) == 0
    # No file at the path: a cold start, strict or not.
    cfg.snapshot_path = str(tmp_path / "absent")
    assert port_main.restore_snapshot_on_boot(_port(), cfg) == 0
    # A suffix-less path names the same .npz the save wrote.
    good = _port()
    good.rate_limit("k", 3, 1, 3600, 1, time.time_ns())
    psnap.save_snapshot(good, tmp_path / "state")
    cfg.snapshot_path = str(tmp_path / "state")
    target = _port()
    assert port_main.restore_snapshot_on_boot(target, cfg) == 1
    assert _state(psnap, target) == _state(psnap, good)


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _boot(path, port):
    env = {k: v for k, v in os.environ.items() if not k.startswith("PYTEST")}
    env["PYTHONPATH"] = str(REPO)
    return subprocess.Popen(
        [sys.executable, "-m", "throttlecrab_tpu_torch.server", "--http",
         "--http-host", "127.0.0.1", "--http-port", str(port),
         "--device", "cpu", "--store-capacity", "1024", "--keymap",
         "python", "--snapshot-path", str(path)],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
    )


def _throttle(port):
    body = json.dumps({"key": "life", "max_burst": 3,
                       "count_per_period": 1, "period": 3600}).encode()
    deadline = time.monotonic() + 60
    while True:
        try:
            with urllib.request.urlopen(urllib.request.Request(
                f"http://127.0.0.1:{port}/throttle", data=body,
                method="POST",
            ), timeout=5) as resp:
                return json.loads(resp.read())
        except OSError:
            if time.monotonic() > deadline:
                raise
            time.sleep(0.1)


def test_server_saves_on_sigterm_and_restores_on_boot(tmp_path):
    """Boot with --snapshot-path, take 2 of a key's 3, SIGTERM (the save),
    boot again on the same path: the third request answers remaining 0
    and the fourth is denied."""
    path = tmp_path / "state"
    for step, expect in enumerate(([2, 1], [0, None])):
        port = _free_port()
        proc = _boot(path, port)
        try:
            got = [_throttle(port) for _ in range(2)]
        finally:
            proc.send_signal(signal.SIGTERM)
            _, err = proc.communicate(timeout=60)
        assert proc.returncode == 0, err.decode()[-2000:]
        if step == 0:
            assert [g["remaining"] for g in got] == expect
            assert all(g["allowed"] for g in got)
            assert b"saved 1 keys to snapshot" in err
        else:
            assert b"restored 1 keys from snapshot" in err
            assert got[0]["allowed"] and got[0]["remaining"] == 0
            assert not got[1]["allowed"]
