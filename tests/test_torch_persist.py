"""The port's crash durability (throttlecrab_tpu_torch/persist/) against the
JAX package's.

Mirrors tests/test_persist.py on the port (the chain written on one shard
count and restored onto another waits for the mesh): the TCKP format and
every damage shape, base/delta chains and what they decide after
recovery, deltas holding only dirty rows across key encodings, the
fallbacks past a corrupt manifest, delta or base, retention and
generation numbering, the `snapshot:truncate` and `fsyncfail` faults,
the boot restore precedence, the engine's and the native driver's dirty
marks and ticks, the checkpoint gauges and the `/health` suffix, and a
SIGKILLed server that reboots warm on its chain.  Across packages, both
ways: for the same state and `now_ns` the two packages write
byte-identical files, and a chain written by either recovers in the
other to the same per-key state, certificates and next-window
decisions.  The port runs on device="cpu" (the plain row versions).
Tolerance: exact equality.
"""

from __future__ import annotations

import asyncio
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

from throttlecrab_tpu import faults as jax_faults
from throttlecrab_tpu import persist as jax_persist
from throttlecrab_tpu.tpu import snapshot as jsnap
from throttlecrab_tpu.tpu.limiter import TpuRateLimiter
from throttlecrab_tpu_torch import faults
from throttlecrab_tpu_torch.persist import (
    MANIFEST_NAME,
    Checkpointer,
    CheckpointCorrupt,
    checkpoint_name,
    decode_checkpoint,
    encode_checkpoint,
    parse_checkpoint_name,
    read_checkpoint,
    read_manifest,
    recover_into,
    scan_chains,
)
from throttlecrab_tpu_torch.tpu import snapshot as psnap
from throttlecrab_tpu_torch.tpu.limiter import TorchRateLimiter

REPO = Path(__file__).resolve().parent.parent
NS = 1_000_000_000
T0 = 1_700_000_000 * NS


@pytest.fixture(autouse=True)
def _always_disarm():
    yield
    faults.disarm()
    jax_faults.disarm()


def _lim(capacity=256, keymap="python", insight=False):
    return TorchRateLimiter(capacity=capacity, keymap=keymap, device="cpu",
                            insight=insight)


def _ck(lim, directory, cls=Checkpointer, **kw):
    kw.setdefault("interval_ns", 1)  # every explicit tick is due
    kw.setdefault("now_fn", lambda: T0)
    return cls(lim, directory, **kw)


def _spend(lim, key, n, t=T0, burst=3, period=3600):
    for _ in range(n):
        lim.rate_limit(key, burst, 10, period, 1, t)


# ------------------------------------------------------------------ #
# Format


def test_format_round_trip():
    keys = ["plain", b"\x00raw\xffbytes", "utf8-é"]
    tat = np.array([T0 + 1, T0 + 2, T0 + 3], np.int64)
    exp = np.array([T0 + 10, T0 + 20, T0 + 30], np.int64)
    blob = encode_checkpoint("base", 7, 7, T0, 256, 1, False, keys, tat, exp)
    rec = decode_checkpoint(blob)
    assert rec.kind == "base"
    assert rec.generation == 7 and rec.base_generation == 7
    assert rec.created_ns == T0
    assert (rec.capacity, rec.n_shards) == (256, 1)
    assert rec.source_bytes_keys is False
    assert list(rec.tat) == list(tat) and list(rec.expiry) == list(exp)
    assert rec.keys_raw[1] == b"\x00raw\xffbytes"
    assert bool(rec.key_is_bytes[1]) and not bool(rec.key_is_bytes[0])


@pytest.mark.parametrize("kind", ["base", "delta"])
def test_encode_byte_identical_to_jax_and_decodes_across(kind):
    keys = ["plain", b"\x00raw\xffbytes", "utf8-é", "lone\ud800", "a\x00b"]
    tat = np.array([T0 + i for i in range(5)], np.int64)
    exp = np.array([T0 + 10 * i for i in range(5)], np.int64)
    args = (kind, 3, 1, T0, 512, 1, True, keys, tat, exp)
    blob = encode_checkpoint(*args)
    assert blob == jax_persist.encode_checkpoint(*args)
    for rec in (decode_checkpoint(blob), jax_persist.decode_checkpoint(blob)):
        assert rec.keys_raw == decode_checkpoint(blob).keys_raw
        assert list(rec.key_codec) == list(
            decode_checkpoint(blob).key_codec)


def test_decode_rejects_every_damage_shape():
    blob = encode_checkpoint(
        "delta", 3, 0, T0, 64, 1, False, ["k1", "k2"],
        np.array([1, 2], np.int64), np.array([3, 4], np.int64),
    )
    for cut in (0, 2, 4, 10, len(blob) // 2, len(blob) - 1):
        with pytest.raises(CheckpointCorrupt):
            decode_checkpoint(blob[:cut])
    flipped = bytearray(blob)
    flipped[len(blob) // 2] ^= 0x40
    with pytest.raises(CheckpointCorrupt, match="CRC"):
        decode_checkpoint(bytes(flipped))
    with pytest.raises(CheckpointCorrupt, match="magic"):
        decode_checkpoint(b"XXXX" + blob[4:])
    with pytest.raises(CheckpointCorrupt):
        decode_checkpoint(blob + b"junk")


def test_checkpoint_name_round_trip():
    assert checkpoint_name(42, "base") == "ckpt-000000000042-base.tck"
    assert parse_checkpoint_name("ckpt-000000000042-base.tck") == (42, "base")
    for bad in ("ckpt-12-wat.tck", "snap.npz", "ckpt-xx-base.tck",
                "ckpt-1-base.tmp", "MANIFEST.json"):
        assert parse_checkpoint_name(bad) is None


# ------------------------------------------------------------------ #
# Chain write + recovery


def test_base_delta_chain_round_trips_decisions(tmp_path):
    lim = _lim()
    _spend(lim, "hot", 3)
    for i in range(20):
        _spend(lim, f"k{i}", 1)
    ck = _ck(lim, tmp_path)
    assert ck.checkpoint_now(T0) == 21
    _spend(lim, "hot2", 3)
    ck.note_keys(["hot2"])
    assert ck.checkpoint_now(T0) == 1
    assert ck.last_generation == 1

    lim2 = _lim()
    res = recover_into(lim2, tmp_path, T0 + NS)
    assert res is not None and res.restored == 22
    assert res.generation == 1 and res.chain == [0, 1]
    assert res.corrupt_skipped == 0 and res.used_manifest
    assert not lim2.rate_limit("hot", 3, 10, 3600, 1, T0 + NS)[0]
    assert not lim2.rate_limit("hot2", 3, 10, 3600, 1, T0 + NS)[0]
    allowed, r = lim2.rate_limit("k0", 3, 10, 3600, 1, T0 + NS)
    assert allowed and r.remaining == 1


def test_delta_contains_only_dirty_rows(tmp_path):
    lim = _lim()
    for i in range(10):
        _spend(lim, f"k{i}", 1)
    ck = _ck(lim, tmp_path)
    ck.checkpoint_now(T0)
    ck.note_keys(["k3", "k7", "never-decided"])
    ck.checkpoint_now(T0)
    rec = read_checkpoint(tmp_path / checkpoint_name(1, "delta"))
    assert sorted(k.decode() for k in rec.keys_raw) == ["k3", "k7"]
    assert rec.base_generation == 0


@pytest.mark.parametrize("keymap", ["python", "native"])
def test_delta_dirty_marks_match_across_key_encodings(tmp_path, keymap):
    """Transports note wire (str) keys while a bytes-keyed keymap exports
    bytes: the delta matches on canonical byte identity."""
    lim = _lim(keymap=keymap)
    _spend(lim, b"enc-a", 1)
    _spend(lim, "enc-b", 1)
    ck = _ck(lim, tmp_path)
    ck.checkpoint_now(T0)
    ck.note_keys(["enc-a", b"enc-b"])
    ck.checkpoint_now(T0)
    rec = read_checkpoint(tmp_path / checkpoint_name(1, "delta"))
    assert sorted(k.decode() for k in rec.keys_raw) == ["enc-a", "enc-b"]


def test_all_expired_dirty_set_still_writes_empty_delta(tmp_path):
    lim = _lim()
    _spend(lim, "a", 1)
    ck = _ck(lim, tmp_path)
    ck.checkpoint_now(T0)
    ck.note_keys(["gone-key"])
    assert ck.checkpoint_now(T0) == 0
    assert (tmp_path / checkpoint_name(1, "delta")).exists()
    res = recover_into(_lim(), tmp_path, T0 + NS)
    assert res.chain == [0, 1] and res.restored == 1


def test_idle_interval_writes_no_file(tmp_path):
    lim = _lim()
    _spend(lim, "a", 1)
    ck = _ck(lim, tmp_path)
    ck.checkpoint_now(T0)
    assert ck.checkpoint_now(T0) == 0
    assert not (tmp_path / checkpoint_name(1, "delta")).exists()
    assert ck.last_generation == 0


def test_interval_zero_keeps_no_dirty_set(tmp_path):
    lim = _lim()
    ck = _ck(lim, tmp_path, interval_ns=0)
    ck.note_keys(["a", "b"])
    assert ck.dirty_count() == 0 and not ck.tick_due(T0)
    assert ck.maybe_tick(T0) == 0


def test_recovery_corrupt_manifest_falls_back_to_scan(tmp_path):
    lim = _lim()
    _spend(lim, "hot", 3)
    _ck(lim, tmp_path).checkpoint_now(T0)
    (tmp_path / MANIFEST_NAME).write_bytes(b'{"chains": [[torn')
    assert read_manifest(tmp_path) is None
    lim2 = _lim()
    res = recover_into(lim2, tmp_path, T0 + NS)
    assert res.restored == 1 and not res.used_manifest
    assert not lim2.rate_limit("hot", 3, 10, 3600, 1, T0 + NS)[0]


def test_recovery_corrupt_newest_delta_drops_one_generation(tmp_path):
    lim = _lim()
    _spend(lim, "fall", 1)
    ck = _ck(lim, tmp_path)
    ck.checkpoint_now(T0)
    _spend(lim, "other", 1)
    ck.note_keys(["other"])
    ck.checkpoint_now(T0)
    _spend(lim, "fall", 2)
    ck.note_keys(["fall"])
    ck.checkpoint_now(T0)
    path2 = tmp_path / checkpoint_name(2, "delta")
    blob = path2.read_bytes()
    path2.write_bytes(blob[: len(blob) // 2])
    lim2 = _lim()
    res = recover_into(lim2, tmp_path, T0 + NS)
    assert res.generation == 1 and res.chain == [0, 1]
    assert res.corrupt_skipped == 1
    allowed, r = lim2.rate_limit("fall", 3, 10, 3600, 1, T0 + NS)
    assert allowed and r.remaining == 1


def test_recovery_corrupt_base_abandons_chain_for_previous(tmp_path):
    lim = _lim()
    _spend(lim, "hot", 3)
    ck = _ck(lim, tmp_path, retain=2)
    ck.checkpoint_now(T0)
    ck.note_keys(["hot"])
    ck.checkpoint_now(T0)
    _spend(lim, "late", 1)
    ck.checkpoint_now(T0, force_base=True)
    (tmp_path / checkpoint_name(2, "base")).write_bytes(b"TCKPgarbage")
    lim2 = _lim()
    res = recover_into(lim2, tmp_path, T0 + NS)
    assert res.chain == [0, 1] and res.corrupt_skipped == 1
    assert not lim2.rate_limit("hot", 3, 10, 3600, 1, T0 + NS)[0]
    assert lim2.rate_limit("late", 3, 10, 3600, 1, T0 + NS)[0]


def test_recovery_nothing_usable_boots_empty(tmp_path):
    lim = _lim()
    _spend(lim, "hot", 3)
    _ck(lim, tmp_path).checkpoint_now(T0)
    for entry in tmp_path.iterdir():
        if entry.name != MANIFEST_NAME:
            entry.write_bytes(b"\x00" * 16)
    lim2 = _lim()
    assert recover_into(lim2, tmp_path, T0 + NS) is None
    assert len(lim2) == 0


def test_recovery_missing_dir_and_empty_dir(tmp_path):
    assert recover_into(_lim(64), tmp_path / "absent", T0) is None
    assert recover_into(_lim(64), tmp_path, T0) is None


def test_recovery_requires_empty_limiter(tmp_path):
    lim = _lim()
    _spend(lim, "hot", 1)
    _ck(lim, tmp_path).checkpoint_now(T0)
    with pytest.raises(ValueError, match="empty"):
        recover_into(lim, tmp_path, T0 + NS)


def test_restore_time_ttl_sweep_across_chain(tmp_path):
    lim = _lim()
    _spend(lim, "short", 1, period=2)
    _spend(lim, "long", 1, period=3600)
    ck = _ck(lim, tmp_path)
    ck.checkpoint_now(T0)
    _spend(lim, "short2", 1, t=T0 + NS, period=2)
    ck.note_keys(["short2"])
    ck.checkpoint_now(T0)
    lim2 = _lim()
    res = recover_into(lim2, tmp_path, T0 + 100 * NS)
    assert res.restored == 1
    assert len(lim2) == 1


def test_retention_prunes_to_newest_chains(tmp_path):
    lim = _lim()
    _spend(lim, "a", 1)
    ck = _ck(lim, tmp_path, retain=2, mode="full")
    for _ in range(5):
        assert ck.checkpoint_now(T0) == 1
    gens = sorted(parse_checkpoint_name(e.name)[0] for e in tmp_path.iterdir()
                  if parse_checkpoint_name(e.name) is not None)
    assert gens == [3, 4]
    assert read_manifest(tmp_path) == [[4], [3]]
    assert scan_chains(tmp_path) == [[4], [3]]


def test_base_every_rebases_the_chain(tmp_path):
    lim = _lim()
    _spend(lim, "a", 1)
    ck = _ck(lim, tmp_path, base_every=2, retain=5)
    kinds = []
    for _ in range(6):
        ck.note_keys(["a"])
        ck.checkpoint_now(T0)
        base = tmp_path / checkpoint_name(ck.last_generation, "base")
        kinds.append("base" if base.exists() else "delta")
    assert kinds == ["base", "delta", "delta", "base", "delta", "delta"]
    assert read_manifest(tmp_path) == [[3, 4, 5], [0, 1, 2]]


def test_generation_numbering_resumes_past_disk(tmp_path):
    lim = _lim()
    _spend(lim, "a", 1)
    ck = _ck(lim, tmp_path)
    ck.checkpoint_now(T0)
    ck.note_keys(["a"])
    ck.checkpoint_now(T0)
    lim2 = _lim()
    res = recover_into(lim2, tmp_path, T0 + NS)
    ck2 = _ck(lim2, tmp_path)
    ck2.note_recovery(res.restored, res.corrupt_skipped, res.chains)
    assert ck2.generation == 2
    ck2.checkpoint_now(T0 + NS)
    assert (tmp_path / checkpoint_name(2, "base")).exists()
    assert recover_into(_lim(), tmp_path, T0 + NS).chain == [2]


# ------------------------------------------------------------------ #
# Fault modes on the snapshot site


def test_truncate_fault_tears_final_file_and_recovery_survives(tmp_path):
    lim = _lim()
    _spend(lim, "safe", 1)
    ck = _ck(lim, tmp_path)
    ck.checkpoint_now(T0)
    _spend(lim, "torn-row", 3)
    ck.note_keys(["torn-row"])
    faults.arm(faults.FaultInjector(faults.parse_spec("snapshot:truncate:0.4")))
    with pytest.raises(OSError, match="torn write"):
        ck.checkpoint_now(T0)
    faults.disarm()
    torn = tmp_path / checkpoint_name(1, "delta")
    assert torn.exists()
    with pytest.raises(CheckpointCorrupt):
        read_checkpoint(torn)
    assert ck.write_errors == 1
    assert ck.dirty_count() == 1
    assert ck.last_generation == 0
    (tmp_path / MANIFEST_NAME).unlink()
    lim2 = _lim()
    res = recover_into(lim2, tmp_path, T0 + NS)
    assert not res.used_manifest
    assert res.generation == 0 and res.corrupt_skipped == 1
    assert lim2.rate_limit("torn-row", 3, 10, 3600, 1, T0 + NS)[0]
    allowed, r = lim2.rate_limit("safe", 3, 10, 3600, 1, T0 + NS)
    assert allowed and r.remaining == 1
    assert ck.checkpoint_now(T0) == 1
    assert read_checkpoint(torn).kind == "delta"
    assert recover_into(_lim(), tmp_path, T0 + NS).generation == 1


def test_fsyncfail_fault_fails_cleanly_before_rename(tmp_path):
    lim = _lim()
    _spend(lim, "a", 1)
    ck = _ck(lim, tmp_path)
    faults.arm(faults.FaultInjector(faults.parse_spec("snapshot:fsyncfail")))
    with pytest.raises(OSError, match="fsync"):
        ck.checkpoint_now(T0)
    faults.disarm()
    assert list(tmp_path.iterdir()) == []
    assert ck.write_errors == 1
    assert ck.checkpoint_now(T0) == 1
    assert (tmp_path / checkpoint_name(0, "base")).exists()


def test_maybe_tick_never_raises_and_retries(tmp_path):
    lim = _lim()
    _spend(lim, "a", 1)
    ck = _ck(lim, tmp_path, interval_ns=NS)
    faults.arm(faults.FaultInjector(faults.parse_spec("snapshot:fsyncfail")))
    assert ck.maybe_tick(T0) == 0
    faults.disarm()
    assert not ck.tick_due(T0 + NS - 1)
    assert ck.maybe_tick(T0 + NS) == 1
    assert ck.write_errors == 1 and ck.last_generation == 0


# ------------------------------------------------------------------ #
# Across packages


def _state(mod, lim):
    keys, _, _, tat, exp, _, _ = mod.export_state(lim)
    return {k: (int(t), int(e)) for k, t, e in zip(keys, tat, exp)}


def _certs(lim):
    t = lim.table
    return bool(t.cur_safe), int(t.tol_hwm), int(t.now_hwm)


def _traffic(rng, keys, n, now):
    ix = rng.integers(0, len(keys), n)
    return ([keys[i] for i in ix], 2 + ix % 4, 1 + ix % 5, 600 + ix % 50,
            np.where(ix % 11 == 0, 0, 1), now)


def _write_chain(lim, ck, rng, keys, insight):
    """Every key once, a base, then two deltas after a window each."""
    now = T0
    lim.rate_limit_batch(keys, 3, 1, 600, 1, now)
    ck.checkpoint_now(now)
    for _ in range(2):
        now += NS
        batch = _traffic(rng, keys, 40, now)
        lim.rate_limit_batch(*batch)
        ck.note_keys(batch[0])
        ck.checkpoint_now(now)
    return now


def _keys(keymap):
    keys = [f"user:{i}" for i in range(30)] + ["a\x00b", b"\xff\xfe"]
    if keymap == "python":
        keys.append("lone\ud800")
    return keys


@pytest.mark.parametrize("insight", [False, True], ids=["w4", "w6"])
@pytest.mark.parametrize("keymap", ["python", "native"])
def test_same_state_writes_byte_identical_files(tmp_path, keymap, insight):
    """The same traffic through both packages, checkpointed at the same
    now_ns: every generation file and the manifest are the same bytes."""
    dirs = {"jax": tmp_path / "j", "port": tmp_path / "p"}
    for side, lim, cls in (
        ("jax", TpuRateLimiter(capacity=256, keymap=keymap, insight=insight),
         jax_persist.Checkpointer),
        ("port", _lim(keymap=keymap, insight=insight), Checkpointer),
    ):
        ck = _ck(lim, dirs[side], cls=cls)
        _write_chain(lim, ck, np.random.default_rng(5), _keys(keymap),
                     insight)
    names = sorted(p.name for p in dirs["jax"].iterdir())
    assert names == sorted(p.name for p in dirs["port"].iterdir())
    assert len(names) == 4  # base, 2 deltas, manifest
    for name in names:
        assert (dirs["port"] / name).read_bytes() == (
            dirs["jax"] / name).read_bytes(), name


@pytest.mark.parametrize("dst", ["python", "native"])
@pytest.mark.parametrize("src", ["python", "native"])
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_chain_of_either_package_recovers_in_the_other(tmp_path, writer,
                                                       src, dst):
    """A chain written by one package recovers into a fresh JAX and a
    fresh port limiter: the same restored count, per-key state and
    certificates, and the same decisions and state after the next
    window."""
    if writer == "jax":
        lim = TpuRateLimiter(capacity=256, keymap=src)
        ck = _ck(lim, tmp_path, cls=jax_persist.Checkpointer)
    else:
        lim = _lim(keymap=src)
        ck = _ck(lim, tmp_path)
    rng = np.random.default_rng(9)
    keys = _keys(src)
    now = _write_chain(lim, ck, rng, keys, False) + NS
    jl = TpuRateLimiter(capacity=256, keymap=dst)
    pl = _lim(keymap=dst)
    rj = jax_persist.recover_into(jl, tmp_path, now)
    rp = recover_into(pl, tmp_path, now)
    assert (rp.restored, rp.generation, rp.chain, rp.chains) == (
        rj.restored, rj.generation, rj.chain, rj.chains)
    assert rp.chain == [0, 1, 2] and rp.restored > 0
    assert _state(psnap, pl) == _state(jsnap, jl)
    assert _certs(pl) == _certs(jl)
    batch = _traffic(rng, keys, 48, now)
    a, b = jl.rate_limit_batch(*batch), pl.rate_limit_batch(*batch)
    for f in ("allowed", "limit", "remaining", "reset_after_ns",
              "retry_after_ns", "status"):
        assert np.array_equal(np.asarray(getattr(a, f)), getattr(b, f)), f
    assert _state(psnap, pl) == _state(jsnap, jl)


# ------------------------------------------------------------------ #
# Server wiring


@pytest.mark.parametrize("kw,ok", [
    (dict(checkpoint_dir="/tmp/x", checkpoint_interval_ms=100), True),
    (dict(checkpoint_interval_ms=100), False),
    (dict(checkpoint_dir="/tmp/x", checkpoint_interval_ms=-1), False),
    (dict(checkpoint_dir="/tmp/x", checkpoint_retain=0), False),
    (dict(checkpoint_dir="/tmp/x", checkpoint_mode="weekly"), False),
], ids=["valid", "no-dir", "negative", "retain-zero", "mode"])
def test_config_checkpoint_knobs_validate_as_jax(kw, ok):
    from throttlecrab_tpu.server import config as jax_config
    from throttlecrab_tpu_torch.server import config as port_config

    for mod in (jax_config, port_config):
        cfg = mod.Config(http=True, **kw)
        if ok:
            cfg.validate()
        else:
            with pytest.raises(mod.ConfigError):
                cfg.validate()


def test_restore_on_boot_prefers_checkpoint_over_snapshot(tmp_path):
    from throttlecrab_tpu_torch.server.__main__ import restore_on_boot
    from throttlecrab_tpu_torch.server.config import Config

    now = time.time_ns()
    src = _lim()
    _spend(src, "snap-key", 1, t=now)
    snap = tmp_path / "snap.npz"
    psnap.save_snapshot(src, snap)
    src2 = _lim()
    _spend(src2, "ck-a", 1, t=now)
    _spend(src2, "ck-b", 1, t=now)
    ckdir = tmp_path / "ckpt"
    Checkpointer(src2, ckdir, interval_ns=1, now_fn=lambda: now
                 ).checkpoint_now(now)
    cfg = Config(http=True, snapshot_path=str(snap),
                 checkpoint_dir=str(ckdir), device="cpu")
    lim = _lim()
    ck2 = Checkpointer(lim, ckdir, interval_ns=1)
    assert restore_on_boot(lim, cfg, ck2) == 2
    assert ck2.recoveries == 1 and ck2.generation == 1
    for entry in ckdir.iterdir():
        entry.write_bytes(b"\x00")
    lim2 = _lim()
    ck3 = Checkpointer(lim2, ckdir, interval_ns=1)
    assert restore_on_boot(lim2, cfg, ck3) == 1
    assert ck3.recoveries == 0
    # No checkpointer: the snapshot path alone.
    assert restore_on_boot(_lim(), cfg, None) == 1


def test_metrics_export_checkpoint_gauges_as_jax():
    from throttlecrab_tpu.server.metrics import Metrics as JaxMetrics
    from throttlecrab_tpu_torch.server.metrics import METRIC_NAMES, Metrics

    texts = []
    for metrics_cls, ck_cls, lim in (
        (JaxMetrics, jax_persist.Checkpointer, TpuRateLimiter(capacity=64)),
        (Metrics, Checkpointer, _lim(64)),
    ):
        m = metrics_cls()
        before = m.export_prometheus()
        _spend(lim, "a", 1)
        ck = ck_cls(lim, "/nonexistent-unused", interval_ns=1,
                    now_fn=lambda: T0)
        ck.note_keys(["a", "b"])
        m.set_checkpoint_stats_provider(ck.metric_stats)
        after = m.export_prometheus()
        texts.append([[line for line in t.splitlines()
                       if "_checkpoint_" in line] for t in (before, after)])
    assert texts[1] == texts[0]
    assert "throttlecrab_tpu_checkpoint_generation -1" in texts[1][0]
    for name in METRIC_NAMES:
        if name.startswith("throttlecrab_tpu_checkpoint"):
            assert any(line.startswith(name + " ") for line in texts[1][1])


def test_health_suffix_states():
    clock = {"t": T0}
    ck = Checkpointer(_lim(64), "/unused", interval_ns=1,
                      now_fn=lambda: clock["t"])
    assert ck.health_suffix() == "checkpoint_age_s=never"
    ck.last_checkpoint_ns = T0
    clock["t"] = T0 + 2 * NS
    assert ck.health_suffix() == "checkpoint_age_s=2.0"


def test_engine_marks_decided_keys_dirty_and_ticks(tmp_path):
    from throttlecrab_tpu_torch.server.engine import BatchingEngine
    from throttlecrab_tpu_torch.server.http import HttpTransport
    from throttlecrab_tpu_torch.server.metrics import Metrics
    from throttlecrab_tpu_torch.server.types import ThrottleRequest

    lim = _lim()
    ck = _ck(lim, tmp_path, interval_ns=1 << 62)  # ticks never due
    engine = BatchingEngine(lim, batch_size=8, checkpointer=ck)

    async def drive(engine):
        reqs = [ThrottleRequest(key=f"e{i}", max_burst=3, count_per_period=10,
                                period=3600, quantity=1) for i in range(5)]
        await asyncio.gather(*(engine.throttle(r) for r in reqs))
        health = await HttpTransport("127.0.0.1", 0, engine, Metrics()
                                     )._route("GET", "/health", b"")
        await engine.shutdown()
        return health

    health = asyncio.run(drive(engine))
    assert health == (200, b"OK checkpoint_age_s=never", "text/plain")
    assert ck.dirty_count() == 5
    ck.checkpoint_now(T0)
    ck.note_keys(["e0"])
    ck.checkpoint_now(T0)
    rec = read_checkpoint(tmp_path / checkpoint_name(1, "delta"))
    assert [k.decode() for k in rec.keys_raw] == ["e0"]
    # With the interval due, the engine's housekeeping writes the base.
    lim2 = _lim()
    ck2 = _ck(lim2, tmp_path / "due", interval_ns=1)
    asyncio.run(drive(BatchingEngine(lim2, batch_size=8, checkpointer=ck2,
                                     now_fn=lambda: T0)))
    assert ck2.last_generation == 0 and ck2.checkpoints_total == 1


def test_native_driver_marks_dirty_and_ticks(tmp_path):
    """The native HTTP driver notes each launched window's wire keys and
    drives the throttled tick after it; /health carries the suffix."""
    from throttlecrab_tpu_torch.native import get_wire_lib
    from throttlecrab_tpu_torch.server.metrics import Metrics
    from throttlecrab_tpu_torch.server.native_http import NativeHttpTransport

    if get_wire_lib() is None:
        pytest.skip("the native wire server needs g++")
    lim = _lim(keymap="native")
    ck = Checkpointer(lim, tmp_path, interval_ns=50_000_000)
    port = _free_port()
    t = NativeHttpTransport("127.0.0.1", port, lim, Metrics(),
                            checkpointer=ck, max_linger_us=100)

    async def run():
        await t.start()
        loop = asyncio.get_running_loop()
        try:
            for key in ("n:1", "n:2"):
                await loop.run_in_executor(None, _post, port, key, 3)
            deadline = time.monotonic() + 10
            while ck.last_generation < 0 or not _http(
                    port, "/health").startswith(b"OK checkpoint_age_s=0"):
                assert time.monotonic() < deadline
                await loop.run_in_executor(None, _post, port, "n:3", 3)
                await asyncio.sleep(0.1)
        finally:
            await t.stop()

    asyncio.run(run())
    res = recover_into(_lim(keymap="native"), tmp_path, time.time_ns())
    assert res is not None and res.restored >= 2


# ------------------------------------------------------------------ #
# A SIGKILLed server reboots warm on its chain.


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _http(port, path, body=None):
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=body,
                                 method="POST" if body else "GET")
    with urllib.request.urlopen(req, timeout=10) as r:
        return r.read()


def _post(port, key, burst):
    return json.loads(_http(port, "/throttle", json.dumps(
        {"key": key, "max_burst": burst, "count_per_period": 1,
         "period": 3600}).encode()))


def _generation(port) -> float:
    for line in _http(port, "/metrics").decode().splitlines():
        if line.startswith("throttlecrab_tpu_checkpoint_generation "):
            return float(line.split()[1])
    raise AssertionError("no checkpoint generation gauge")


def _boot(port, ckdir, backend):
    env = {k: v for k, v in os.environ.items() if not k.startswith("PYTEST")}
    env["PYTHONPATH"] = str(REPO)
    proc = subprocess.Popen(
        [sys.executable, "-m", "throttlecrab_tpu_torch.server", "--http",
         "--http-host", "127.0.0.1", "--http-port", str(port),
         "--http-backend", backend, "--device", "cpu", "--store-capacity",
         "1024", "--checkpoint-dir", str(ckdir),
         "--checkpoint-interval-ms", "200", "--log-level", "warn"],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    )
    deadline = time.monotonic() + 120
    while True:
        if proc.poll() is not None:
            raise AssertionError(proc.stdout.read())
        try:
            health = _http(port, "/health")
            assert health.startswith(b"OK checkpoint_age_s="), health
            return proc
        except OSError:
            pass
        if time.monotonic() > deadline:
            proc.kill()
            raise AssertionError("server did not come up")
        time.sleep(0.2)


@pytest.mark.parametrize("backend", ["python", "native"])
def test_sigkill_restart_keeps_the_key_denied(tmp_path, backend):
    """Exhaust a key, wait for two checkpoint intervals, SIGKILL the
    server and boot it again on the same directory: the key is still
    denied, and the boot counts one recovery."""
    port = _free_port()
    proc = _boot(port, tmp_path, backend)
    try:
        answers = [_post(port, "kill:1", 2)["allowed"] for _ in range(3)]
        assert answers == [True, True, False]
        # Two generations past the exhausting answers: the first may have
        # swapped its dirty set before the last spend, the second cannot.
        # Each sentinel request's window drives the throttled tick.
        g0 = _generation(port)
        deadline = time.monotonic() + 30
        i = 0
        while _generation(port) < g0 + 2:
            assert time.monotonic() < deadline
            _post(port, f"kill:tick{i}", 2)
            i += 1
            time.sleep(0.25)
        assert _http(port, "/health").startswith(b"OK checkpoint_age_s=")
        proc.send_signal(signal.SIGKILL)
        proc.wait(timeout=30)
        proc = _boot(port, tmp_path, backend)
        assert _post(port, "kill:1", 2)["allowed"] is False
        deadline = time.monotonic() + 10
        while b"throttlecrab_tpu_checkpoint_recoveries_total 1" not in _http(
                port, "/metrics"):
            assert time.monotonic() < deadline
            time.sleep(0.2)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
