"""The mesh's serving surfaces (insight, tenants, quotas, snapshot,
persist, engine and transports, replay) against the JAX package's.

Mirrors tests/test_mesh_insight.py (and the mesh cases of
tests/test_persist.py and tests/test_replay.py) on the port: each case
drives the port's `ShardedTorchRateLimiter` on CPU shards and the JAX
`ShardedTpuRateLimiter` on the composed-XLA mesh with the same inputs, and
holds results, per-shard state, counters, tenant stats, the mesh top-K
(a tie across shards included), `/stats`, `/metrics`, snapshot files,
checkpoint chains and the answers of every transport to a tenant-quota
refusal (status 5: HTTP 503, gRPC RESOURCE_EXHAUSTED, RESP -ERR, the
native driver's bytes) equal.  Tolerance: exact equality.
"""

import asyncio
import json
import logging

import numpy as np
import pytest

from throttlecrab_tpu.harness.workload import make_keys
from throttlecrab_tpu.insight import InsightTier as JaxTier
from throttlecrab_tpu.parallel import sharded as jax_sharded
from throttlecrab_tpu_torch.insight import InsightTier
from throttlecrab_tpu_torch.insight.collector import ShardedSlotKeyResolver
from throttlecrab_tpu_torch.parallel import sharded as port_sharded
from throttlecrab_tpu_torch.parallel import tenants as port_tenants
from throttlecrab_tpu_torch.tpu import kernel
from throttlecrab_tpu_torch.tpu.limiter import (
    STATUS_TENANT_QUOTA,
    TorchRateLimiter,
)
from torch_mesh import NS, T0, pair, same_result, same_state, tenant_keys


@pytest.fixture(autouse=True)
def _composed_mesh(monkeypatch):
    """JAX's fused mesh cannot run under the installed jax, and JAX's
    server factory writes THROTTLECRAB_PALLAS_FUSED into os.environ:
    hold the port against the composed-XLA mesh and restore the env."""
    monkeypatch.setenv("THROTTLECRAB_PALLAS_FUSED", "0")


def _both(lims, method, *args, **kw):
    """Call `method` on both limiters; results pinned equal."""
    a, b = (getattr(lim, method)(*args, **kw) for lim in lims)
    same_result(a, b, method)
    return b


def _per_key_state(lim, key):
    """(tat, expiry, deny) of one key on a port sharded insight limiter."""
    d = lim.shard_of(key.encode())
    slot = dict(lim.keymaps[d].items())[key]
    return (int(lim.table.tat[d, slot]), int(lim.table.expiry[d, slot]),
            int(lim.table.deny[d, slot]))


# --------------------------------------------------------------------- #
# Routing and quotas.


def test_oversized_key_routes_per_key():
    lims = pair(4, 128, tenants=dict(max_tenants=8, affinity=True))
    with pytest.raises(port_tenants.KeyTooLong):
        port_tenants.key_matrix([b"x" * (1 << 20), b"small"])
    keys = [f"ta:k{j}" for j in range(6)] + ["tbig:" + "x" * (1 << 20)]
    res = _both(lims, "rate_limit_batch", keys, 5, 10, 60, 1, T0, wire=True)
    assert (res.status == 0).all()
    pl = lims[1]
    for k in keys:
        d = pl.shard_of(k.encode())
        assert k in dict(pl.keymaps[d].items()), k
    same_state(*lims)


def test_quota_spray_cannot_force_growth():
    lims = pair(4, 64, tenants=dict(max_tenants=8, quota_frac=0.25,
                                    affinity=True))
    pl = lims[1]
    _both(lims, "rate_limit_batch", [f"tq:f{j}" for j in range(16)], 3, 10,
          3600, 1, T0)
    res = _both(lims, "rate_limit_batch", [f"tq:s{j}" for j in range(200)],
                3, 10, 3600, 1, T0, wire=True)
    assert (res.status == STATUS_TENANT_QUOTA).all()
    assert pl.table.capacity == 64 and pl.keymaps[0].capacity == 64
    res = _both(lims, "rate_limit_batch", [f"tz:s{j}" for j in range(80)],
                3, 10, 3600, 1, T0, wire=True)
    assert (res.status == 0).sum() > 0 and pl.table.capacity > 64
    same_state(*lims)


def test_tenant_affinity_makes_keys_shard_local():
    lims = pair(4, 256, tenants=dict(max_tenants=16, affinity=True))
    pl = lims[1]
    keys = [f"t{t}:k{j}" for t in range(8) for j in range(16)]
    _both(lims, "rate_limit_batch", keys, 5, 10, 60, 1, T0)
    for t in range(8):
        homes = {d for d, km in enumerate(pl.keymaps)
                 for k, _ in km.items() if k.startswith(f"t{t}:")}
        assert len(homes) == 1, (t, homes)
    bare = [f"bare{i}" for i in range(64)]
    _both(lims, "rate_limit_batch", bare, 5, 10, 60, 1, T0)
    assert len({pl.shard_of(k.encode()) for k in bare}) > 1
    same_state(*lims)


def test_tenant_quota_isolates_without_touching_live_keys():
    lims = pair(4, 256, insight=True,
                tenants=dict(max_tenants=8, quota_frac=0.05, affinity=True))
    pl = lims[1]
    cap = int(0.05 * 256)
    res = _both(lims, "rate_limit_batch", [f"t0:spray{j}" for j in range(64)],
                3, 10, 60, 1, T0, wire=True)
    assert (res.status == STATUS_TENANT_QUOTA).sum() == 64 - cap
    assert not res.allowed[res.status == STATUS_TENANT_QUOTA].any()
    res = _both(lims, "rate_limit_batch", [f"t1:k{j}" for j in range(8)],
                3, 10, 60, 1, T0, wire=True)
    assert (res.status == 0).all()
    res = _both(lims, "rate_limit_batch", ["t0:spray0"], 3, 10, 60, 1,
                T0 + 1, wire=True)
    assert int(res.status[0]) == 0
    assert pl.tenant_stats()["t0"]["quota_rejections"] == 64 - cap
    same_state(*lims)
    freed = [lim.sweep(T0 + 7200 * NS) for lim in lims]
    assert freed[0] == freed[1] > 0
    res = _both(lims, "rate_limit_batch", [f"t0:post{j}" for j in range(4)],
                3, 10, 60, 1, T0 + 7200 * NS, wire=True)
    assert (res.status == 0).all()
    same_state(*lims)


def test_tenant_counters_ride_the_scan_path_too():
    lims = pair(4, 256, insight=True, tenants=dict(max_tenants=8))
    rng = np.random.default_rng(7)
    batches = [(tenant_keys(rng, 64, tenants=4), 2, 10, 60, 1, T0 + j)
               for j in range(3)]
    results = [lim.rate_limit_many(batches, wire=True) for lim in lims]
    for a, b in zip(*results):
        same_result(a, b)
    want = sum(int(r.allowed.sum()) for r in results[1])
    stats = lims[1].tenant_stats()
    assert sum(t["allowed"] for t in stats.values()) == want
    assert sum(t["denied"] for t in stats.values()) == 3 * 64 - want
    same_state(*lims)


def test_mixed_batch_keeps_affine_routing():
    lims = pair(4, 128, tenants=dict(max_tenants=8, affinity=True))
    clean = [f"ta:k{j}" for j in range(8)]
    _both(lims, "rate_limit_batch", clean, 5, 10, 60, 1, T0)
    _both(lims, "rate_limit_batch", clean + [("exotic", 1)], 5, 10, 60, 1,
          T0 + 1)
    pl = lims[1]
    homes = {d for d, km in enumerate(pl.keymaps) for k, _ in km.items()
             if isinstance(k, str) and k.startswith("ta:")}
    assert len(homes) == 1 and len(pl) == len(clean) + 1
    same_state(*lims)


# --------------------------------------------------------------------- #
# Insight on the mesh.


@pytest.mark.parametrize("pattern", ["hotkey-abuse", "chaos"])
def test_sharded_insight_bit_identical_to_single_device(pattern):
    """Decisions AND stored state (tat, expiry, the per-slot deny heat)
    of the port's mesh equal the port's single-device insight limiter
    and the JAX mesh, quantity-0 probes (the degenerate path) included."""
    lims = pair(4, 512, insight=True, tenants=dict(max_tenants=8))
    pl = lims[1]
    single = TorchRateLimiter(capacity=2048, device="cpu", insight=True)
    rng = np.random.default_rng(sum(map(ord, pattern)))
    stream = make_keys(pattern, 640, 800, seed=5)
    for i in range(8):
        ks = stream[i * 80:(i + 1) * 80]
        qty = [0 if rng.random() < 0.05 else 1 for _ in ks]
        now = T0 + i * NS // 5
        r1 = _both(lims, "rate_limit_batch", ks, 4, 20, 60, qty, now,
                   wire=True)
        same_result(r1, single.rate_limit_batch(ks, 4, 20, 60, qty, now,
                                                wire=True), i)
    same_state(*lims)
    deny_1 = kernel.unpack_deny(single.table.state)
    slots_1 = dict(single.keymap.items())
    checked = 0
    for k in set(stream):
        if k not in slots_1:
            continue
        s1 = slots_1[k]
        assert _per_key_state(pl, k) == (
            int(single.table.tat[s1]), int(single.table.expiry[s1]),
            int(deny_1[s1])), k
        checked += 1
    assert checked > 50
    assert pl.table.insight_counts() == single.table.insight_counts()


def test_insight_kill_switch_bit_identity_on_mesh():
    on = port_sharded.ShardedTorchRateLimiter(
        256, mesh=port_sharded.make_mesh(4, device="cpu"), insight=True)
    off = port_sharded.ShardedTorchRateLimiter(
        256, mesh=port_sharded.make_mesh(4, device="cpu"), insight=False)
    assert on.table.shards[0].state.shape[-1] == kernel.INS_WIDTH
    assert off.table.shards[0].state.shape[-1] == 4
    stream = make_keys("hotkey-abuse", 480, 600, seed=9)
    for i in range(6):
        ks = stream[i * 80:(i + 1) * 80]
        now = T0 + i * NS // 3
        same_result(on.rate_limit_batch(ks, 3, 10, 60, 1, now, wire=True),
                    off.rate_limit_batch(ks, 3, 10, 60, 1, now, wire=True))
    assert (on.table.tat == off.table.tat).all()
    assert (on.table.expiry == off.table.expiry).all()


def _topk_both(lims, k):
    jv, ji = (np.asarray(x) for x in lims[0].table.insight_topk(k))
    pv, pi = lims[1].table.insight_topk(k)
    np.testing.assert_array_equal(jv, pv.numpy())
    np.testing.assert_array_equal(ji, pi.numpy())
    return pv.tolist(), pi.tolist()


def test_mesh_topk_is_global_and_resolves_keys():
    lims = pair(4, 256, insight=True)
    pl = lims[1]
    keys = [f"hot{i}" for i in range(12)]
    for i, k in enumerate(keys):
        _both(lims, "rate_limit_batch", [k] * (4 + i), 2, 1, 3600, 1, T0)
    want = {k: 2 + i for i, k in enumerate(keys)}
    vals, ids = _topk_both(lims, 12)
    assert vals == sorted(want.values(), reverse=True)
    got = {k: v for v, k in zip(vals, ShardedSlotKeyResolver(pl).keys_for(
        ids)) if v > 0}
    assert got == want
    assert len({pl.shard_of(k.encode()) for k in keys}) > 1
    for lim in lims:
        lim.table.insight_decay()
    vals, _ = _topk_both(lims, 12)
    assert vals == sorted((v // 2 for v in want.values()), reverse=True)


def test_mesh_topk_ties_across_shards_in_jax_order():
    """Equal deny counts on keys of different shards: the lower shard,
    then the lower slot, comes first, as JAX's top_k over the gathered
    partials orders them; the K boundary cuts the tie the same way."""
    lims = pair(4, 64, insight=True)
    pl = lims[1]
    keys = [f"tie{i}" for i in range(24)]
    _both(lims, "rate_limit_batch", [k for k in keys for _ in range(5)], 2,
          1, 3600, 1, T0)  # every key: 2 allowed, 3 denied
    homes = {pl.shard_of(k.encode()) for k in keys}
    assert len(homes) == 4
    for k in (1, 5, 7, 24, 64):
        vals, ids = _topk_both(lims, k)
        assert vals[: min(k, 24)] == [3] * min(k, 24)
        assert ids[: min(k, 24)] == sorted(ids[: min(k, 24)])


def test_sweep_clears_heat_per_shard():
    lims = pair(4, 128, insight=True)
    keys = [f"sw{i}" for i in range(40)]
    for _ in range(4):
        _both(lims, "rate_limit_batch", keys, 2, 10, 1, 1, T0)
    assert int(lims[1].table.deny.sum()) > 0
    assert [lim.sweep(T0 + 3600 * NS) for lim in lims] == [40, 40]
    assert int(lims[1].table.deny.sum()) == 0 and len(lims[1]) == 0
    same_state(*lims)


def _tiers(lims, **kw):
    tiers = (JaxTier(limiter=lims[0], poll_ms=1, decay_s=0, **kw),
             InsightTier(limiter=lims[1], poll_ms=1, decay_s=0, **kw))
    for t in tiers:
        t.prime()
    return tiers


def test_insight_tier_on_mesh_truthful_stats():
    lims = pair(4, 256, insight=True, tenants=dict(max_tenants=8))
    tiers = _tiers(lims)
    rng = np.random.default_rng(3)
    allowed_want = total = 0
    for i in range(6):
        ks = tenant_keys(rng, 96)
        res = _both(lims, "rate_limit_batch", ks, 2, 10, 60, 1, T0 + i * NS,
                    wire=True)
        allowed_want += int(res.allowed.sum())
        total += len(ks)
        for t in tiers:
            t.maybe_poll(T0 + i * NS)
    for t in tiers:
        t.poll(T0 + 10 * NS)
    docs = [t.stats(state="ok") for t in tiers]
    assert docs[0] == docs[1]
    doc = docs[1]
    assert doc["totals"]["allowed"] == allowed_want
    assert doc["totals"]["denied"] == total - allowed_want
    assert doc["top_denied"] and doc["top_denied"][0]["key"].startswith("t")
    tenants = doc["tenants"]
    assert sum(t["allowed"] for t in tenants.values()) == allowed_want
    assert sum(t["denied"] for t in tenants.values()) == total - allowed_want
    assert tiers[0].metric_stats() == tiers[1].metric_stats()


def test_growth_rebases_heat_deltas_without_double_count():
    lims = pair(4, 128, insight=True)
    tiers = _tiers(lims)
    _both(lims, "rate_limit_batch", ["hot"] * 10, 1, 1, 3600, 2, T0)
    for t in tiers:
        t.poll(T0 + NS)
    assert [dict(t.sketch.top(4)).get("hot") for t in tiers] == [10, 10]
    for lim in lims:
        for km in lim.keymaps:
            km.grow(256)
        lim.table.grow(256)
        lim._grow_tenant_slots(256)
    for t in tiers:
        t.poll(T0 + 2 * NS)
    assert [dict(t.sketch.top(4)).get("hot") for t in tiers] == [10, 10]
    _both(lims, "rate_limit_batch", ["hot"] * 4, 1, 1, 3600, 2, T0 + 3 * NS)
    for t in tiers:
        t.poll(T0 + 4 * NS)
    assert [dict(t.sketch.top(4)).get("hot") for t in tiers] == [14, 14]
    same_state(*lims)


# --------------------------------------------------------------------- #
# Snapshot and checkpoints on the mesh.


def test_snapshot_roundtrip_sharded_insight_tenants(tmp_path):
    from throttlecrab_tpu.tpu import snapshot as jsnap
    from throttlecrab_tpu_torch.tpu import snapshot as psnap

    tk = dict(max_tenants=8, quota_frac=0.1, affinity=True)
    lims = pair(4, 256, insight=True, tenants=tk)
    keys = [f"t{t}:k{j}" for t in range(3) for j in range(10)]
    for i in range(3):
        _both(lims, "rate_limit_batch", keys, 3, 10, 3600, 1, T0 + i)
    before = {k: _per_key_state(lims[1], k) for k in keys}
    paths = [str(tmp_path / "jax-snap"), str(tmp_path / "port-snap")]
    assert jsnap.save_snapshot(lims[0], paths[0]) == len(keys)
    assert psnap.save_snapshot(lims[1], paths[1]) == len(keys)
    with np.load(paths[0] + ".npz") as a, np.load(paths[1] + ".npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for name in a.files:
            np.testing.assert_array_equal(a[name], b[name], err_msg=name)
    # Each package restores the other's file onto a fresh mesh.
    for path in paths:
        again = pair(4, 256, insight=True, tenants=tk)
        got = [jsnap.load_snapshot(again[0], path + ".npz", now_ns=T0 + NS),
               psnap.load_snapshot(again[1], path + ".npz", now_ns=T0 + NS)]
        assert got == [len(keys)] * 2
        for k in keys:
            assert _per_key_state(again[1], k)[:2] == before[k][:2], k
            assert _per_key_state(again[1], k)[2] == 0
        same_state(*again)
        res = _both(again, "rate_limit_batch", keys[:5], 3, 10, 3600, 1,
                    T0 + 2 * NS, wire=True)
        assert (res.status == 0).all()
        assert int(sum(u.sum() for u in again[1]._tenant_used)) == len(keys)


def test_snapshot_restores_across_shard_counts(tmp_path):
    from throttlecrab_tpu_torch.tpu import snapshot as psnap

    src = pair(4, 128)[1]
    keys = [f"k{i}" for i in range(40)]
    for _ in range(2):
        src.rate_limit_batch(keys, 3, 10, 3600, 1, T0)
    psnap.save_snapshot(src, tmp_path / "s")
    for target in (pair(2, 128)[1],
                   TorchRateLimiter(capacity=512, device="cpu")):
        assert psnap.load_snapshot(target, tmp_path / "s.npz", T0) == 40
        res = target.rate_limit_batch(keys, 3, 10, 3600, 1, T0)
        assert (res.remaining == 0).all()


def _spend(lim, key, n, t=T0, burst=3, period=3600):
    for _ in range(n):
        lim.rate_limit(key, burst, 10, period, 1, t)


def test_chain_restores_across_shard_counts(tmp_path):
    """A chain written on 4 shards restores onto 2 shards and onto a
    single device in both packages, and the files the two packages write
    are byte-identical."""
    from throttlecrab_tpu import persist as jax_persist
    from throttlecrab_tpu_torch import persist as port_persist

    dirs = [tmp_path / "jax", tmp_path / "port"]
    lims = pair(4, 128)
    for lim, pkg, d in zip(lims, (jax_persist, port_persist), dirs):
        _spend(lim, "hot", 3)
        for i in range(20):
            _spend(lim, f"k{i}", 1)
        ck = pkg.Checkpointer(lim, d, interval_ns=1, now_fn=lambda: T0)
        ck.checkpoint_now(T0)
        _spend(lim, "hot2", 3)
        ck.note_keys(["hot2"])
        ck.checkpoint_now(T0)
    names = sorted(p.name for p in dirs[0].iterdir())
    assert names == sorted(p.name for p in dirs[1].iterdir())
    for name in names:
        assert (dirs[0] / name).read_bytes() == (dirs[1] / name).read_bytes()
    for d in dirs:
        for target in (pair(2, 128)[1],
                       TorchRateLimiter(capacity=512, device="cpu")):
            res = port_persist.recover_into(target, d, T0 + NS)
            assert res.restored == 22
            assert not target.rate_limit("hot", 3, 10, 3600, 1, T0 + NS)[0]
            assert not target.rate_limit("hot2", 3, 10, 3600, 1, T0 + NS)[0]
        jt = jax_sharded.ShardedTpuRateLimiter(
            capacity_per_shard=128, mesh=jax_sharded.make_mesh(2))
        assert jax_persist.recover_into(jt, d, T0 + NS).restored == 22


def test_supervisor_degrade_and_repromote_on_the_mesh():
    """The supervisor's degrade export (row gathers per shard) and its
    re-promotion (row scatters per shard) through the sharded branches,
    decisions and state equal to JAX's supervised mesh.  The mesh has no
    fault site of its own (in JAX neither), so the launch is broken by
    hand with a transient-shaped error."""
    from throttlecrab_tpu.server.supervisor import (
        SupervisedLimiter as JaxSupervised,
    )
    from throttlecrab_tpu_torch.server.supervisor import SupervisedLimiter

    lims = pair(2, 128, insight=True)
    broken = {"on": False}
    for lim in lims:
        def check(*a, _orig=lim.table.check_batch, **k):
            if broken["on"]:
                raise RuntimeError("UNAVAILABLE: device lost")
            return _orig(*a, **k)
        lim.table.check_batch = check
    sups = [cls(lim, retries=1, probe_interval_ms=1, sleep_fn=lambda s: None)
            for cls, lim in zip((JaxSupervised, SupervisedLimiter), lims)]
    keys = [f"k{i}" for i in range(30)]
    _both(sups, "rate_limit_batch", keys, 3, 10, 3600, 1, T0)
    broken["on"] = True
    _both(sups, "rate_limit_batch", keys[:10] + ["new"], 3, 10, 3600, 1,
          T0 + 1)
    assert [s.state for s in sups] == ["degraded"] * 2
    broken["on"] = False
    _both(sups, "rate_limit_batch", keys, 3, 10, 3600, 1, T0 + 5 * 10**6)
    assert [s.state for s in sups] == ["ok"] * 2
    assert [s.repromote_count for s in sups] == [1, 1]
    same_state(*lims)


# --------------------------------------------------------------------- #
# The server: factory, engine, transports, metrics.


def test_create_limiter_builds_the_mesh_as_in_jax(monkeypatch):
    from throttlecrab_tpu.server import config as jax_config
    from throttlecrab_tpu.server import store as jax_store
    from throttlecrab_tpu_torch.server import config as port_config
    from throttlecrab_tpu_torch.server import store as port_store

    argv = ["--http", "--shards", "4", "--store-capacity", "8192",
            "--tenant-quota", "0.25", "--tenant-affinity", "--keymap",
            "python"]
    jl = jax_store.create_limiter(jax_config.Config.from_env_and_args(argv))
    pl = port_store.create_limiter(port_config.Config.from_env_and_args(
        argv + ["--device", "cpu"]))
    assert isinstance(pl, port_sharded.ShardedTorchRateLimiter)
    assert (pl.n_shards, pl.table.capacity, pl.table.width) == (
        jl.n_shards, jl.table.capacity, jl.table.width) == (4, 2048, 6)
    for name in ("max_tenants", "delim", "quota_frac", "affinity"):
        assert getattr(pl.tenants, name) == getattr(jl.tenants, name)
    rng = np.random.default_rng(1)
    ks = tenant_keys(rng, 200)
    _both((jl, pl), "rate_limit_batch", ks, 3, 10, 60, 1, T0, wire=True)
    same_state(jl, pl)
    # THROTTLECRAB_TENANT_MAX=0 turns the tenant layer off in both.
    monkeypatch.setenv("THROTTLECRAB_TENANT_MAX", "0")
    plain = ["--http", "--shards", "2", "--device", "cpu"]
    assert port_store.create_limiter(
        port_config.Config.from_env_and_args(plain)).tenants is None


def test_boot_warns_when_deny_cache_uncertifiable(caplog):
    from throttlecrab_tpu_torch.server.config import Config
    from throttlecrab_tpu_torch.server.metrics import Metrics
    from throttlecrab_tpu_torch.server.store import create_front_tier

    lim = pair(4, 256)[1]
    with caplog.at_level(logging.INFO, logger="throttlecrab.store"):
        front = create_front_tier(Config(http=True, front_deny_cache=1024),
                                  Metrics(), lim)
    assert front is not None and front.deny_cache is None
    dropped = [r for r in caplog.records
               if "cannot certify entries" in r.message]
    assert dropped and dropped[0].levelno == logging.WARNING
    caplog.clear()
    with caplog.at_level(logging.INFO, logger="throttlecrab.store"):
        create_front_tier(Config(http=True), Metrics(), lim)
    dropped = [r for r in caplog.records
               if "cannot certify entries" in r.message]
    assert dropped and dropped[0].levelno == logging.INFO


def _quota_pair(D=4):
    return pair(D, 64, insight=True,
                tenants=dict(max_tenants=8, quota_frac=0.05, affinity=True))


def _engines(lims, clock, **kw):
    from throttlecrab_tpu.server.engine import BatchingEngine as JaxEngine
    from throttlecrab_tpu.server.metrics import Metrics as JaxMetrics
    from throttlecrab_tpu_torch.server.engine import BatchingEngine
    from throttlecrab_tpu_torch.server.metrics import Metrics

    metrics = (JaxMetrics(max_denied_keys=100), Metrics(max_denied_keys=100))
    for m, lim in zip(metrics, lims):
        m.set_tenant_stats_provider(lim.tenant_stats)
    engines = tuple(
        cls(lim, now_fn=clock, metrics=m, **kw)
        for cls, lim, m in zip((JaxEngine, BatchingEngine), lims, metrics)
    )
    return engines, metrics


def _render(metrics):
    return [line for line in metrics.export_prometheus().splitlines()
            if not line.startswith("throttlecrab_uptime_seconds ")]


def test_tenant_quota_surfaces_as_overload_and_in_metrics():
    from throttlecrab_tpu_torch.server.engine import OverloadError
    from throttlecrab_tpu_torch.server.types import ThrottleRequest

    clock = {"now": T0}
    lims = _quota_pair()
    (je, pe), metrics = _engines(lims, lambda: clock["now"], batch_size=8,
                                 max_linger_us=100)

    async def run(eng):
        out = []
        for j in range(12):  # quota = 0.05 * 64 = 3 slots
            try:
                r = await eng.throttle(
                    ThrottleRequest(f"q:spray{j}", 3, 10, 3600, 1))
                out.append((r.allowed, r.remaining))
            except Exception as e:
                out.append((type(e).__name__, str(e)))
            clock["now"] += 1_000_000
        await eng.shutdown()
        return out

    want = asyncio.run(run(je))
    clock["now"] = T0
    got = asyncio.run(run(pe))
    assert got == want
    overloads = [o for o in got if o[0] == OverloadError.__name__]
    assert len(overloads) == 12 - 3
    assert overloads[0][1] == "tenant capacity quota exceeded"
    assert _render(metrics[0]) == _render(metrics[1])
    assert any('throttlecrab_tpu_tenant_quota_rejections{tenant="q"} 9' == line
               for line in _render(metrics[1]))
    same_state(*lims)


def test_engine_serves_stats_for_sharded_insight():
    from throttlecrab_tpu.server.http import HttpTransport as JaxHttp
    from throttlecrab_tpu_torch.server.http import HttpTransport
    from throttlecrab_tpu_torch.server.types import ThrottleRequest

    lims = pair(4, 256, insight=True, tenants=dict(max_tenants=8))
    tiers = _tiers(lims)
    clock = {"now": T0}
    (je, pe), metrics = _engines(lims, lambda: clock["now"], batch_size=16,
                                 max_linger_us=100)
    je.insight, pe.insight = tiers

    async def run(eng, tier, http_cls, m):
        outcomes = []
        for step in range(4):
            reqs = [ThrottleRequest(f"t{i % 3}:web:{i}", 2, 10, 60, 1)
                    for i in range(32)]
            outcomes += await asyncio.gather(*[eng.throttle(r) for r in reqs])
            clock["now"] += NS
        await eng.shutdown()
        tier.poll(clock["now"] + NS)
        t = http_cls("127.0.0.1", 0, eng, m)
        status, payload, ctype = await t._route("GET", "/stats", b"")
        return [o.allowed for o in outcomes], status, json.loads(payload)

    want = asyncio.run(run(je, tiers[0], JaxHttp, metrics[0]))
    clock["now"] = T0
    got = asyncio.run(run(pe, tiers[1], HttpTransport, metrics[1]))
    assert got == want
    allowed, status, doc = got
    assert status == 200
    assert doc["totals"]["allowed"] == sum(allowed)
    assert set(doc["tenants"]) == {"t0", "t1", "t2"}
    assert sum(t["allowed"] for t in doc["tenants"].values()) == sum(allowed)


def test_http_answers_quota_refusal_as_in_jax():
    from throttlecrab_tpu.server.http import HttpTransport as JaxHttp
    from throttlecrab_tpu_torch.server.http import HttpTransport

    lims = _quota_pair()
    (je, pe), metrics = _engines(lims, lambda: T0, batch_size=8,
                                 max_linger_us=100)
    servers = (JaxHttp("127.0.0.1", 0, je, metrics[0]),
               HttpTransport("127.0.0.1", 0, pe, metrics[1]))

    async def run(srv):
        out = []
        for j in range(6):
            body = json.dumps({"key": f"q:k{j}", "max_burst": 3,
                               "count_per_period": 10, "period": 60}).encode()
            out.append(await srv._route("POST", "/throttle", body, {}))
        await srv.engine.shutdown()
        return out

    want, got = (asyncio.run(run(s)) for s in servers)
    assert got == want
    assert [s for s, *_ in got] == [200] * 3 + [503] * 3
    assert b"tenant capacity quota exceeded" in got[-1][1]


def test_resp_answers_quota_refusal_as_in_jax():
    from throttlecrab_tpu.server.redis import RedisTransport as JaxRedis
    from throttlecrab_tpu_torch.server.redis import RedisTransport

    lims = _quota_pair()
    (je, pe), metrics = _engines(lims, lambda: T0, batch_size=8,
                                 max_linger_us=100)
    servers = (JaxRedis("127.0.0.1", 0, je, metrics[0]),
               RedisTransport("127.0.0.1", 0, pe, metrics[1]))
    data = b"".join(
        b"*5\r\n$8\r\nTHROTTLE\r\n$%d\r\n%s\r\n$1\r\n3\r\n$2\r\n10\r\n"
        b"$2\r\n60\r\n" % (len(k), k)
        for k in (b"q:k%d" % j for j in range(6))
    ) + b"*1\r\n$4\r\nQUIT\r\n"

    async def run(srv):
        await srv.start()
        try:
            reader, writer = await asyncio.open_connection(
                "127.0.0.1", srv.bound_port)
            writer.write(data)
            await writer.drain()
            out = await asyncio.wait_for(reader.read(), 30)
            writer.close()
        finally:
            await srv.engine.shutdown()
            await srv.stop()
        return out

    want, got = (asyncio.run(run(s)) for s in servers)
    assert got == want
    assert got.count(b"-ERR tenant capacity quota exceeded\r\n") == 3


def test_grpc_answers_quota_refusal_as_in_jax():
    grpc = pytest.importorskip("grpc")
    from throttlecrab_tpu.server.grpc import GrpcTransport as JaxGrpc
    from throttlecrab_tpu_torch.server.grpc import GrpcTransport
    from throttlecrab_tpu_torch.server.proto import throttlecrab_pb2 as pb

    lims = _quota_pair()
    (je, pe), metrics = _engines(lims, lambda: T0, batch_size=8,
                                 max_linger_us=100)
    servers = (JaxGrpc("127.0.0.1", 0, je, metrics[0]),
               GrpcTransport("127.0.0.1", 0, pe, metrics[1]))

    async def run(srv):
        await srv.start()
        out = []
        async with grpc.aio.insecure_channel(
                f"127.0.0.1:{srv.bound_port}") as ch:
            method = ch.unary_unary(
                "/throttlecrab.RateLimiter/Throttle",
                request_serializer=pb.ThrottleRequest.SerializeToString,
                response_deserializer=pb.ThrottleResponse.FromString,
            )
            for j in range(6):
                req = pb.ThrottleRequest(key=f"q:k{j}", max_burst=3,
                                         count_per_period=10, period=60,
                                         quantity=1)
                try:
                    out.append(("OK", (await method(req))
                                .SerializeToString()))
                except grpc.aio.AioRpcError as e:
                    out.append((e.code().name, e.details()))
        await srv.engine.shutdown()
        await srv.stop()
        return out

    want, got = (asyncio.run(run(s)) for s in servers)
    assert got == want
    assert got[-1] == ("RESOURCE_EXHAUSTED", "tenant capacity quota exceeded")


def test_native_driver_answers_quota_refusal_as_in_jax():
    """The native RESP driver takes the dispatch_many route for a mesh
    (no dispatch_wire_window, as in JAX) and its reply bytes equal
    JAX's, status 5 rows included."""
    from throttlecrab_tpu.server.metrics import Metrics as JaxMetrics
    from throttlecrab_tpu.server.native_redis import (
        NativeRedisTransport as JaxNative,
    )
    from throttlecrab_tpu_torch import native
    from throttlecrab_tpu_torch.server import native_redis
    from throttlecrab_tpu_torch.server.metrics import Metrics

    if not native.wire_available():
        pytest.fail(f"wire server build failed: {native.wire_build_error()}")
    assert not hasattr(port_sharded.ShardedTorchRateLimiter,
                       "dispatch_wire_window")
    lims = _quota_pair()
    data = b"".join(
        b"*5\r\n$8\r\nTHROTTLE\r\n$%d\r\n%s\r\n$1\r\n3\r\n$2\r\n10\r\n"
        b"$2\r\n60\r\n" % (len(k), k)
        for k in (b"q:k%d" % j for j in range(8))
    ) + b"*1\r\n$4\r\nQUIT\r\n"

    async def run(cls, lim, m):
        t = cls("127.0.0.1", 0, lim, m, batch_size=64, max_linger_us=500,
                now_fn=lambda: T0)
        await t.start()
        try:
            reader, writer = await asyncio.open_connection(
                "127.0.0.1", t.bound_port)
            writer.write(data)
            await writer.drain()
            out = await asyncio.wait_for(reader.read(), 30)
            writer.close()
        finally:
            await t.stop()
        return out

    want = asyncio.run(run(JaxNative, lims[0], JaxMetrics()))
    wire_before = native_redis.WIRE_WINDOWS
    got = asyncio.run(run(native_redis.NativeRedisTransport, lims[1],
                          Metrics()))
    assert got == want
    assert native_redis.WIRE_WINDOWS == wire_before
    assert got.count(b"-ERR tenant capacity quota exceeded\r\n") == 5
    same_state(*lims)


# --------------------------------------------------------------------- #
# Replay through the mesh.


@pytest.mark.parametrize("D", [1, 2, 4])
def test_differential_replay_synthetic_patterns_sharded(D):
    from throttlecrab_tpu.replay import generators as jax_gen
    from throttlecrab_tpu.replay import player as jax_player
    from throttlecrab_tpu_torch.replay import generators as port_gen
    from throttlecrab_tpu_torch.replay import player as port_player

    for pattern in ("diurnal", "flash-crowd", "slow-drift"):
        args = dict(windows=8, batch=48, key_space=512, seed=3)
        jt = jax_gen.synthesize(pattern, **args)
        pt = port_gen.synthesize(pattern, **args)
        target = port_player.make_target(f"sharded:{D}", pt, device="cpu")
        assert isinstance(target, port_sharded.ShardedTorchRateLimiter)
        assert target.n_shards == D
        assert target.table.capacity == max(
            jax_player._next_pow2(2 * jt.distinct_keys()) // D, 1024)
        report = port_player.differential_replay(pt, target)
        assert report.ok, (pattern, report.summary())
        want = jax_player.replay(jt, jax_player.make_target(f"sharded:{D}",
                                                            jt))
        got = port_player.replay(pt, port_player.make_target(
            f"sharded:{D}", pt, device="cpu"))
        for (ga, gs), (wa, ws) in zip(got, want):
            np.testing.assert_array_equal(ga, wa)
            np.testing.assert_array_equal(gs, ws)
