"""The port's insight tier (throttlecrab_tpu_torch/insight/) against the
JAX package's, field by field.

Both limiters run on the CPU (the port's on device="cpu", the plain
version) and see the same windows at the same `now_ns`.  The device
aggregates (the [allowed, denied] totals and the denied-hit column) must
equal each other and a host recount of the results; the top-K must give
the same counts and slot ids in the same order, ties at the K boundary
included (the lower slot first, as `jax.lax.top_k` orders them — a case
that `torch.topk` gets wrong); and two tiers polled over the same
traffic must agree poll for poll: totals, top-K, sketch, `stats_json`,
`metric_stats`, the keys prewarmed into the deny cache and the admission
concentration.  The sketch, the rate window, the slot resolver, the
feedback loop, the degrade/recover accounting through the host oracle,
a dead device mid-outage, GET /stats on the asyncio and the native HTTP
backends, the gauges and the config wiring are held against the JAX
package the same way.  Mirrors tests/test_insight.py.
"""

import asyncio
import json
import socket
import time
import urllib.request

import numpy as np
import pytest
import torch

from throttlecrab_tpu import faults as jax_faults
from throttlecrab_tpu.front import AdmissionController as JaxAdmission
from throttlecrab_tpu.front import DenyCache as JaxDenyCache
from throttlecrab_tpu.front import FrontTier as JaxFront
from throttlecrab_tpu.harness.workload import make_keys
from throttlecrab_tpu.insight import InsightTier as JaxTier
from throttlecrab_tpu.insight import SpaceSavingSketch as JaxSketch
from throttlecrab_tpu.insight.collector import RateWindow as JaxWindow
from throttlecrab_tpu.server.supervisor import (
    SupervisedLimiter as JaxSupervised,
)
from throttlecrab_tpu.tpu.limiter import TpuRateLimiter
from throttlecrab_tpu_torch import faults
from throttlecrab_tpu_torch.front import AdmissionController, DenyCache
from throttlecrab_tpu_torch.front import FrontTier
from throttlecrab_tpu_torch.insight import InsightTier, SpaceSavingSketch
from throttlecrab_tpu_torch.insight.collector import (
    RateWindow,
    SlotKeyResolver,
)
from throttlecrab_tpu_torch.server.supervisor import (
    STATE_DEGRADED,
    STATE_OK,
    SupervisedLimiter,
)
from throttlecrab_tpu_torch.tpu import kernel
from throttlecrab_tpu_torch.tpu.limiter import TorchRateLimiter

NS = 1_000_000_000
T0 = 1_700_000_000 * NS
FIELDS = ("allowed", "limit", "remaining", "status")


@pytest.fixture(autouse=True)
def _always_disarm():
    yield
    faults.disarm()
    jax_faults.disarm()


def _pair(capacity=1 << 10, keymap="python"):
    return (
        TpuRateLimiter(capacity=capacity, keymap=keymap, insight=True),
        TorchRateLimiter(capacity=capacity, keymap=keymap, insight=True,
                         device="cpu"),
    )


def _same_results(a, b):
    fields = FIELDS + (
        ("reset_after_s", "retry_after_s") if hasattr(a, "reset_after_s")
        else ("reset_after_ns", "retry_after_ns")
    )
    for f in fields:
        np.testing.assert_array_equal(
            np.asarray(getattr(a, f)), np.asarray(getattr(b, f)), err_msg=f)


def _recount(keys, results):
    """Totals and per-key denied counts from the decided results."""
    allowed = denied = 0
    per_key: dict = {}
    for ks, res in zip(keys, results):
        ok = np.asarray(res.status) == 0
        for k, a, o in zip(ks, np.asarray(res.allowed), ok):
            if not o:
                continue
            if a:
                allowed += 1
            else:
                denied += 1
                per_key[k] = per_key.get(k, 0) + 1
    return allowed, denied, per_key


def _column(lim):
    """The whole denied-hit column as (counts, slot ids), highest first."""
    vals, ids = lim.table.insight_topk(lim.table.capacity)
    return np.asarray(vals).tolist(), np.asarray(ids).tolist()


def _slot_counts(lim):
    vals, ids = _column(lim)
    rev = lim.keymap._rev
    return {rev[s]: v for v, s in zip(vals, ids) if v > 0}


def _both_same(jax_lim, port_lim):
    assert port_lim.table.insight_counts() == jax_lim.table.insight_counts()
    assert _column(port_lim) == _column(jax_lim)
    cap = jax_lim.table.capacity
    np.testing.assert_array_equal(
        port_lim.table.state[:cap].numpy(),
        np.asarray(jax_lim.table.state)[:cap],
    )


# --------------------------------------------------------------------- #
# Device aggregates: equal to JAX's and to a host recount.


@pytest.mark.parametrize(
    "pattern", ["hotkey-abuse", "flash-crowd", "chaos", "zipfian"]
)
def test_device_aggregates_match_jax_and_host_recount(pattern):
    jax_lim, port_lim = _pair(1 << 12)
    stream = make_keys(pattern, 1024, 2000, seed=3)
    batches, results = [], []
    for i in range(8):
        ks = stream[i * 128:(i + 1) * 128]
        now = T0 + i * NS // 10
        wire = i % 2 == 0
        got = port_lim.rate_limit_batch(
            ks, 3, 10, 60, 1, now, wire=wire, collect_cur=wire)
        want = jax_lim.rate_limit_batch(
            ks, 3, 10, 60, 1, now, wire=wire, collect_cur=wire)
        _same_results(got, want)
        batches.append(ks)
        results.append(got)
    allowed, denied, per_key = _recount(batches, results)
    assert port_lim.table.insight_counts() == (allowed, denied)
    assert _slot_counts(port_lim) == per_key
    _both_same(jax_lim, port_lim)


def test_aggregates_exact_on_scan_and_degenerate_paths():
    jax_lim, port_lim = _pair()
    batches, results = [], []
    wins = [
        ([f"d{i % 7}" for i in range(64)], 2, 6, 60, 1, T0),
        ([f"d{i % 3}" for i in range(64)], 2, 6, 60, 1, T0 + NS),
    ]
    got = port_lim.rate_limit_many(wins, wire=True)
    for a, b in zip(got, jax_lim.rate_limit_many(wins, wire=True)):
        _same_results(a, b)
    batches += [w[0] for w in wins]
    results += got
    ks = [f"d{i % 5}" for i in range(32)]
    # Degenerate lanes (burst 1: tolerance 0; quantity-0 probes) and
    # invalid rows, which must count nowhere.
    for args in ((ks, 1, 10, 60, 1, T0 + 2 * NS),
                 (ks, 2, 6, 60, 0, T0 + 3 * NS),
                 (["x", "y"], 0, 0, 0, 1, T0 + 4 * NS)):
        res = port_lim.rate_limit_batch(*args)
        _same_results(res, jax_lim.rate_limit_batch(*args))
        batches.append(args[0])
        results.append(res)
    allowed, denied, per_key = _recount(batches, results)
    assert port_lim.table.insight_counts() == (allowed, denied)
    assert _slot_counts(port_lim) == per_key
    _both_same(jax_lim, port_lim)


def test_kill_switch_decisions_bit_identical_and_state_layout():
    on = TorchRateLimiter(capacity=1 << 8, keymap="python", insight=True,
                          device="cpu")
    off = TorchRateLimiter(capacity=1 << 8, keymap="python", device="cpu")
    assert off.table.state.shape[-1] == 4
    assert on.table.state.shape[-1] == 6
    stream = make_keys("hotkey-abuse", 512, 500, seed=9)
    for i in range(4):
        ks = stream[i * 128:(i + 1) * 128]
        a = on.rate_limit_batch(ks, 3, 10, 60, 1, T0 + i, wire=True)
        b = off.rate_limit_batch(ks, 3, 10, 60, 1, T0 + i, wire=True)
        _same_results(a, b)
    cap = off.table.capacity
    assert torch.equal(on.table.state[:cap, :4], off.table.state[:cap])
    assert off.table.insight_topk(4) is None
    assert off.table.insight_counts() == (0, 0)


def test_sweep_clears_heat_and_decay_halves():
    jax_lim, port_lim = _pair(1 << 8)
    for lim in (jax_lim, port_lim):
        # burst 2, 1 per 100 s: a 10-deep segment allows 2, denies 8.
        lim.rate_limit_batch(["a"] * 10, 2, 1, 100, 1, T0)
    assert _slot_counts(port_lim) == {"a": 8}
    _both_same(jax_lim, port_lim)
    for lim in (jax_lim, port_lim):
        lim.table.insight_decay()
    assert _slot_counts(port_lim) == {"a": 4}
    _both_same(jax_lim, port_lim)
    for lim in (jax_lim, port_lim):
        lim.sweep(T0 + 10**15)
    assert _slot_counts(port_lim) == {}
    assert port_lim.table.insight_counts() == (2, 8)
    _both_same(jax_lim, port_lim)


def _tied_tables(counts):
    """A JAX and a port insight table whose denied columns hold `counts`
    (slots 0..n-1), the rest of the rows empty."""
    jax_lim, port_lim = _pair(len(counts))
    state = port_lim.table.state.clone()
    state[:len(counts), 4:] = kernel._split_cols(
        torch.tensor(counts, dtype=torch.int64))
    port_lim.table.state = state
    import jax.numpy as jnp

    jax_lim.table.state = jnp.asarray(state.numpy())
    return jax_lim, port_lim


@pytest.mark.parametrize("k", [1, 4, 7, 11, 30])
def test_topk_ties_at_the_boundary_order_as_jax(k):
    """Equal counts straddle the K boundary: which slots make the top-K
    (and in what order) must be JAX's — the lower slot first.  Plain
    torch.topk picks other slots here, so this test fails against it."""
    counts = [1, 5, 3, 5, 0, 5, 3, 3, 2, 5] * 3
    jax_lim, port_lim = _tied_tables(counts)
    want = [np.asarray(a).tolist() for a in jax_lim.table.insight_topk(k)]
    vals, ids = port_lim.table.insight_topk(k)
    assert ids.dtype == torch.int32 and vals.dtype == torch.int64
    assert [vals.tolist(), ids.tolist()] == want
    if k == 7:
        # The case the plain library call orders differently.
        assert torch.topk(torch.tensor(counts), k).indices.tolist() != (
            want[1])


@pytest.mark.parametrize("k", [0, -3, 31, 1000])
def test_topk_k_clamped_to_capacity(k):
    counts = [2, 7, 7, 1] * 5 + [0] * 10
    jax_lim, port_lim = _tied_tables(counts)
    want = [np.asarray(a).tolist() for a in jax_lim.table.insight_topk(k)]
    got = [a.tolist() for a in port_lim.table.insight_topk(k)]
    assert got == want
    assert len(got[1]) == max(1, min(k, 30))


def test_poll_ties_at_the_boundary_feed_the_same_sketch():
    """Ties at the K boundary through a whole poll: the same keys reach
    the sketch, /stats and the prewarm list on both tiers."""
    jax_lim, port_lim = _pair(64)
    # 12 keys denied 3 times each (burst 1, 1 per hour, 4 requests).
    ks = [f"t{i}" for i in range(12) for _ in range(4)]
    for lim in (jax_lim, port_lim):
        lim.rate_limit_batch(ks, 1, 1, 3600, 1, T0)
    _both_same(jax_lim, port_lim)
    tiers = [cls(limiter=lim, topk=5, poll_ms=1, decay_s=0)
             for cls, lim in ((JaxTier, jax_lim), (InsightTier, port_lim))]
    for tier in tiers:
        assert tier.poll(T0 + NS)
    assert tiers[1].stats_json() == tiers[0].stats_json()
    assert sorted(dict(tiers[1].sketch.top(12))) == sorted(
        dict(tiers[0].sketch.top(12)))


# --------------------------------------------------------------------- #
# Space-saving sketch and collector pieces.


def test_sketch_exact_below_capacity_as_jax():
    sketches = [SpaceSavingSketch(8), JaxSketch(8)]
    for s in sketches:
        for i, n in enumerate([5, 3, 8, 1]):
            for _ in range(n):
                s.record(f"k{i}")
    assert sketches[0].top_with_error(10) == sketches[1].top_with_error(10)
    assert sketches[0].error_bound == 0


def test_sketch_error_bounds_hold_under_pressure_as_jax():
    keys = np.random.default_rng(4).zipf(1.3, 5000) % 160
    sketches = [SpaceSavingSketch(16), JaxSketch(16)]
    truth: dict = {}
    for k in keys:
        truth[int(k)] = truth.get(int(k), 0) + 1
        for s in sketches:
            s.record(int(k))
    assert sketches[0].top_with_error(48) == sketches[1].top_with_error(48)
    assert sketches[0].error_bound == sketches[1].error_bound
    for key, est, err in sketches[0].top_with_error(16):
        assert est - err <= truth.get(key, 0) <= est


def test_sketch_merge_partials_via_record_counts():
    s = SpaceSavingSketch(8)
    s.record("a", 10)
    s.record("b", 3)
    s.record("a", 5)
    assert dict(s.top(2)) == {"a": 15, "b": 3}


def test_rate_window_as_jax():
    windows = [RateWindow(10.0), JaxWindow(10.0)]
    for t, a, d in ((T0, 0, 0), (T0 + 5 * NS, 50, 100),
                    (T0 + 20 * NS, 50, 100), (T0 + 23 * NS, 80, 130),
                    (T0, 60, 110), (T0 + NS, 70, 111)):
        for w in windows:
            w.sample(t, a, d)
        assert windows[0].rates() == windows[1].rates()
    assert windows[0].rates() == (10.0, 1.0)


@pytest.mark.parametrize("keymap", ["python", "native"])
def test_slot_key_resolver_backends(keymap):
    lim = TorchRateLimiter(capacity=64, keymap=keymap, device="cpu")
    lim.rate_limit_batch(["x", "y"], 2, 5, 60, 1, T0)
    r = SlotKeyResolver(lim.keymap)
    slots = dict((k, s) for k, s in lim.keymap.items())
    x = b"x" if keymap == "native" else "x"
    assert r.keys_for([slots[x], 9999]) == [x, None]
    # The native map is cached, pinned by the keymap's mutation stamp.
    lim.sweep(T0 + 10**15)
    assert r.keys_for([slots[x]]) == [None]


# --------------------------------------------------------------------- #
# Poll sequences: the two tiers agree poll for poll.


def _recording(tier, front):
    """Log each poll's top-K and the keys prewarmed into the deny cache."""
    log = {"topk": [], "prewarm": []}
    table = tier.limiter.table
    topk, prewarm = table.insight_topk, front.prewarm

    def rec_topk(k):
        out = topk(k)
        log["topk"].append([np.asarray(a).tolist() for a in out])
        return out

    def rec_prewarm(keys):
        keys = list(keys)
        n = prewarm(keys)
        log["prewarm"].append((keys, n))
        return n

    table.insight_topk = rec_topk
    front.prewarm = rec_prewarm
    return log


def _observe_denials(front, keys, res, now, params):
    """Feed a decided window's rows to the deny cache as the engine does
    (certified denials come from the exact observed TAT)."""
    cache = front.deny_cache
    seq = cache.next_seq()
    cur = np.asarray(res.cur_ns)
    for i, k in enumerate(keys):
        if int(res.status[i]) != 0:
            continue
        cache.observe(k, *params, 1, now, bool(res.allowed[i]), seq,
                      cur_ns=int(cur[i]))


@pytest.mark.parametrize("keymap", ["python", "native"])
def test_poll_sequences_equal_jax(keymap):
    """Over the same windows and now_ns, every poll of the two tiers
    agrees: top-K counts and ids in order, totals, sketch, stats_json,
    metric_stats, the keys prewarmed into the deny cache (and the cache's
    eviction order after it) and the admission concentration — across
    top-K drop-out and re-entry, decay, cache-served denials and
    sweeps."""
    jax_lim, port_lim = _pair(1 << 10, keymap)
    sides = []
    for tier_cls, front_cls, cache_cls, adm_cls, lim in (
        (JaxTier, JaxFront, JaxDenyCache, JaxAdmission, jax_lim),
        (InsightTier, FrontTier, DenyCache, AdmissionController, port_lim),
    ):
        front = front_cls(cache_cls(32), adm_cls(max_pending=100),
                          bytes_keys=keymap == "native")
        tier = tier_cls(limiter=lim, front=front, topk=4, poll_ms=1000,
                        decay_s=3.0, prewarm=8, hot_denies=3,
                        shed_weight=0.5, sketch_capacity=16)
        sides.append((lim, front, tier, _recording(tier, front)))
    rng = np.random.default_rng(11)
    hot = [f"hot{i}" for i in range(6)]
    params = (2, 1, 30)
    now = T0
    for step in range(12):
        # A shifting hot set over a cold background.
        heavy = hot[step % 3:step % 3 + 3]
        ks = [heavy[int(i)] for i in rng.integers(0, 3, 48)] + [
            f"c{int(i)}" for i in rng.integers(0, 200, 80)]
        wkeys = [k.encode() if keymap == "native" else k for k in ks]
        got = []
        for lim, front, tier, _ in sides:
            # The deny cache answers first, as in the engine.
            rows, _ = front.lookup_window(
                wkeys, [params[0]] * len(ks), [params[1]] * len(ks),
                [params[2]] * len(ks), [1] * len(ks), now,
                mark_inflight=False)
            res = lim.rate_limit_batch(ks, *params, 1, now, wire=True,
                                       collect_cur=True)
            _observe_denials(front, wkeys, res, now, params)
            got.append((rows, res))
        _same_results(got[1][1], got[0][1])
        assert [r is None for r in got[1][0]] == [
            r is None for r in got[0][0]]
        now += int(rng.integers(300, 1500)) * 1_000_000
        if step == 8:
            for lim, *_ in sides:
                lim.sweep(now + 40 * NS)
            now += 40 * NS
        polled = [tier.maybe_poll(now) for _, _, tier, _ in sides]
        assert polled[0] == polled[1]
        (_, jf, jt, jlog), (_, pf, pt, plog) = sides
        assert plog == jlog
        assert pt.stats_json(state="ok") == jt.stats_json(state="ok")
        assert pt.metric_stats() == jt.metric_stats()
        assert pt.sketch.top_with_error(64) == jt.sketch.top_with_error(64)
        assert pf.admission.hot_concentration == (
            jf.admission.hot_concentration)
        assert list(pf.deny_cache._entries) == list(jf.deny_cache._entries)
        assert list(pf.deny_cache._records) == list(jf.deny_cache._records)
        _both_same(jax_lim, port_lim)
    assert pt.polls >= 6 and pt.poll_failures == 0
    assert pt.prewarmed_total > 0 and pt.stats()["front_path"]["denied"] > 0
    assert any(len(ids) for ids in plog["topk"])


def _make_tier(front=None, **kw):
    lim = TorchRateLimiter(capacity=1 << 10, keymap="python", insight=True,
                           device="cpu")
    defaults = dict(poll_ms=1000, window_s=10.0, decay_s=0.0)
    defaults.update(kw)
    return lim, InsightTier(limiter=lim, front=front, **defaults)


def test_poll_is_throttled_and_stats_truthful():
    lim, ins = _make_tier()
    ks = ["h"] * 50
    lim.rate_limit_batch(ks, 2, 5, 60, 1, T0, wire=True)
    assert ins.maybe_poll(T0)
    assert not ins.maybe_poll(T0 + ins.poll_ns - 1)
    lim.rate_limit_batch(ks, 2, 5, 60, 1, T0 + NS, wire=True)
    assert ins.maybe_poll(T0 + 2 * NS)
    s = ins.stats(state="ok")
    assert s["totals"]["allowed"] + s["totals"]["denied"] == 100
    assert s["top_denied"][0]["key"] == "h"
    assert s["engine_state"] == "ok"
    assert json.loads(ins.stats_json(state="ok")) == s


def test_prime_at_boot_leaves_the_table_untouched():
    """prime() runs the poll's device ops (decay included) on the empty
    table at boot: no state, totals or poll changes."""
    lim, tier = _make_tier(decay_s=60.0)
    tier.prime()
    assert torch.equal(lim.table.state, TorchRateLimiter(
        capacity=1 << 10, insight=True, device="cpu").table.state)
    assert lim.table.insight_counts() == (0, 0) and tier.polls == 0


def test_prewarm_refreshes_hot_keys_against_eviction():
    cache = DenyCache(capacity=4)
    front = FrontTier(cache, None)
    seq = cache.next_seq()
    cache.observe("hot", 2, 5, 60, 1, T0, True, seq, cur_ns=T0 + 10 * NS)
    cache.observe("hot", 2, 5, 60, 1, T0, False, seq, cur_ns=T0 + 10 * NS)
    assert len(cache) == 1
    assert front.prewarm(["hot", "absent"]) == 1
    for i in range(4):
        k = f"cold{i}"
        cache.observe(k, 2, 5, 60, 1, T0, True, seq, cur_ns=T0 + 10 * NS)
        front.prewarm(["hot"])
        cache.observe(k, 2, 5, 60, 1, T0, False, seq, cur_ns=T0 + 10 * NS)
    assert cache.lookup("hot", 2, 5, 60, 1, T0 + NS) is not None


def test_hot_concentration_tightens_peek_shedding_only():
    adm = AdmissionController(max_pending=100, peek_frac=0.9)
    adm.set_hot_concentration(1.0)
    assert adm.admit(89, peek=True)
    adm.hot_shed_weight = 0.5
    assert not adm.admit(89, peek=True)
    assert adm.admit(99, peek=False)
    assert not adm.admit(100, peek=False)


def test_topk_dropout_and_reentry_not_double_counted():
    jax_lim, port_lim = _pair(1 << 8)
    tiers = [JaxTier(limiter=jax_lim, poll_ms=1, topk=1),
             InsightTier(limiter=port_lim, poll_ms=1, topk=1)]

    def deny(key, n, t):
        for lim in (jax_lim, port_lim):
            lim.rate_limit_batch([key] * n, 2, 1, 100, 1, T0 + t, wire=True)

    deny("a", 12, 0)
    for t in tiers:
        t.poll(T0 + NS)
    deny("b", 15, 2 * NS)
    for t in tiers:
        t.poll(T0 + 3 * NS)
    deny("a", 10, 4 * NS)
    for t in tiers:
        t.poll(T0 + 5 * NS)
    counts = dict(tiers[1].sketch.top(4))
    assert counts == {"a": 20, "b": 13}
    assert tiers[1].sketch.top_with_error(4) == (
        tiers[0].sketch.top_with_error(4))
    assert tiers[1].stats_json() == tiers[0].stats_json()


def test_cache_served_denials_count_into_stats_totals():
    docs = []
    for cache_cls, front_cls, tier_cls, lim in (
        (JaxDenyCache, JaxFront, JaxTier, _pair(1 << 8)[0]),
        (DenyCache, FrontTier, InsightTier, _pair(1 << 8)[1]),
    ):
        cache = cache_cls(capacity=64)
        front = front_cls(cache, None)
        ins = tier_cls(limiter=lim, front=front, poll_ms=1000)
        assert front.insight is ins
        seq = cache.next_seq()
        cache.observe("hot", 2, 5, 60, 1, T0, True, seq,
                      cur_ns=T0 + 10 * NS)
        cache.observe("hot", 2, 5, 60, 1, T0, False, seq,
                      cur_ns=T0 + 10 * NS)
        assert front.lookup("hot", 2, 5, 60, 1, T0 + NS) is not None
        _, n_hits = front.lookup_window(
            ["hot", "cold"], [2, 2], [5, 5], [60, 60], [1, 1], T0 + NS,
            mark_inflight=False)
        assert n_hits == 1
        docs.append(ins.stats())
    assert docs[1] == docs[0]
    assert docs[1]["front_path"]["denied"] == 2
    assert docs[1]["totals"]["denied"] == 2
    assert [(d["key"], d["count"]) for d in docs[1]["top_denied"]] == [
        ("hot", 2)]


def test_insight_feedback_sets_concentration_on_admission():
    out = []
    for front_cls, cache_cls, adm_cls, tier_cls, lim in (
        (JaxFront, JaxDenyCache, JaxAdmission, JaxTier, _pair()[0]),
        (FrontTier, DenyCache, AdmissionController, InsightTier, _pair()[1]),
    ):
        front = front_cls(cache_cls(64), adm_cls(max_pending=100))
        ins = tier_cls(limiter=lim, front=front, poll_ms=1000, hot_denies=5,
                       shed_weight=0.7, prewarm=8)
        assert front.admission.hot_shed_weight == 0.7
        for t in range(4):
            lim.rate_limit_batch(["hot0", "hot1"] * 32, 2, 5, 60, 1,
                                 T0 + t * NS, wire=True)
            ins.maybe_poll(T0 + t * NS)
        out.append((front.admission.hot_concentration, ins.stats_json()))
    assert out[1] == out[0]
    assert out[1][0] > 0.5


# --------------------------------------------------------------------- #
# Degrade / recover, and a dead device.


def test_stats_truthful_across_degrade_recover_cycle():
    """Through the HostOracle: the host path keeps /stats truthful while
    the device is down, nothing is lost or counted twice over the cycle,
    and every document equals the JAX tier's."""
    jax_lim, port_lim = _pair()
    sides = []
    for sup_cls, tier_cls, lim in ((JaxSupervised, JaxTier, jax_lim),
                                   (SupervisedLimiter, InsightTier,
                                    port_lim)):
        sup = sup_cls(lim, retries=1, backoff_us=0, probe_interval_ms=1,
                      sleep_fn=lambda s: None)
        ins = tier_cls(limiter=sup, poll_ms=1000)
        sup.insight = ins
        sides.append((sup, ins))
    ks = ["c0", "c1"] * 16
    total = 0
    now = T0

    def decide(n_batches):
        nonlocal now, total
        for _ in range(n_batches):
            got = [sup.rate_limit_batch(ks, 2, 5, 60, 1, now, wire=True)
                   for sup, _ in sides]
            _same_results(got[1], got[0])
            assert (got[1].status == 0).all()
            total += len(ks)
            now += NS
            for _, ins in sides:
                ins.maybe_poll(now)
            assert sides[1][1].stats_json() == sides[0][1].stats_json()

    decide(3)
    assert sides[1][0].state == STATE_OK
    for mod in (faults, jax_faults):
        mod.arm(mod.FaultInjector(mod.parse_spec("launch:persistent"),
                                  seed=1))
    decide(3)
    assert sides[1][0].state == STATE_DEGRADED
    s = sides[1][1].stats()
    assert s["totals"]["allowed"] + s["totals"]["denied"] == total
    assert s["host_path"]["allowed"] + s["host_path"]["denied"] > 0
    faults.disarm()
    jax_faults.disarm()
    decide(3)
    assert sides[1][0].state == STATE_OK
    s = sides[1][1].stats()
    # The one extra allowed row is the recovery probe's decision.
    assert s["totals"]["allowed"] + s["totals"]["denied"] == total + 1
    assert s["top_denied"][0]["key"] in ("c0", "c1")


def test_poll_survives_dead_device_mid_outage():
    counts = []
    for lim in _pair():
        tier_cls = InsightTier if isinstance(lim, TorchRateLimiter) else (
            JaxTier)
        ins = tier_cls(limiter=lim, poll_ms=1000, decay_s=0)
        lim.rate_limit_batch(["k"] * 8, 2, 5, 60, 1, T0, wire=True)
        ins.maybe_poll(T0)

        class Boom:
            def insight_counts(self):
                raise ConnectionError("UNAVAILABLE: device gone")

        real = ins.limiter.table
        ins.limiter.table = Boom()
        try:
            assert ins.maybe_poll(T0 + 2 * NS)
            assert ins.poll_failures == 1
        finally:
            ins.limiter.table = real
        assert ins.stats()["totals"]["allowed"] >= 1
        counts.append(ins.stats_json())
    assert counts[1] == counts[0]


# --------------------------------------------------------------------- #
# Server surfaces: /stats on both HTTP backends, gauges, config.


def test_http_stats_route_as_jax():
    from throttlecrab_tpu.server.engine import BatchingEngine as JaxEngine
    from throttlecrab_tpu.server.http import HttpTransport as JaxHttp
    from throttlecrab_tpu.server.metrics import Metrics as JaxMetrics
    from throttlecrab_tpu_torch.server.engine import BatchingEngine
    from throttlecrab_tpu_torch.server.http import HttpTransport
    from throttlecrab_tpu_torch.server.metrics import Metrics

    async def run():
        docs = []
        for engine_cls, http_cls, metrics_cls, tier_cls, lim in (
            (JaxEngine, JaxHttp, JaxMetrics, JaxTier, _pair()[0]),
            (BatchingEngine, HttpTransport, Metrics, InsightTier,
             _pair()[1]),
        ):
            ins = tier_cls(limiter=lim, poll_ms=1000, decay_s=0)
            lim.rate_limit_batch(["s"] * 20, 2, 5, 60, 1, T0, wire=True)
            ins.maybe_poll(T0)
            engine = engine_cls(lim, insight=ins, now_fn=lambda: T0)
            t = http_cls("127.0.0.1", 0, engine, metrics_cls())
            docs.append(await t._route("GET", "/stats", b""))
            engine2 = engine_cls(lim, now_fn=lambda: T0)
            t2 = http_cls("127.0.0.1", 0, engine2, metrics_cls())
            docs.append(await t2._route("GET", "/stats", b""))
        assert docs[2:] == docs[:2]
        status, payload, ctype = docs[2]
        assert status == 200 and ctype == "application/json"
        doc = json.loads(payload)
        assert doc["insight"]["enabled"] is True
        assert doc["engine_state"] == "ok"
        assert json.loads(docs[3][1]) == {"insight": {"enabled": False}}

    asyncio.run(run())


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _get(port, path, body=None):
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=body,
                                 method="POST" if body else "GET")
    with urllib.request.urlopen(req, timeout=10) as r:
        return r.read()


def test_native_http_stats_pushed_from_the_driver():
    """The native HTTP backend answers GET /stats from the snapshot its
    driver pushes: the tier's document, counting the requests sent."""
    from throttlecrab_tpu_torch.native import get_wire_lib
    from throttlecrab_tpu_torch.server.metrics import Metrics
    from throttlecrab_tpu_torch.server.native_http import NativeHttpTransport

    if get_wire_lib() is None:
        pytest.skip("the native wire server needs g++")
    lim = TorchRateLimiter(capacity=1 << 10, keymap="native", insight=True,
                           device="cpu")
    ins = InsightTier(limiter=lim, poll_ms=1, decay_s=0)
    port = _free_port()
    t = NativeHttpTransport("127.0.0.1", port, lim, Metrics(), insight=ins,
                            max_linger_us=100)

    async def run():
        await t.start()
        try:
            body = json.dumps({"key": "n:1", "max_burst": 2,
                               "count_per_period": 1, "period": 3600})
            loop = asyncio.get_running_loop()
            answers = [json.loads(await loop.run_in_executor(
                None, _get, port, "/throttle", body.encode()))
                for _ in range(5)]
            assert [a["allowed"] for a in answers] == [True] * 2 + [False] * 3
            deadline = time.monotonic() + 10
            while True:
                doc = json.loads(await loop.run_in_executor(
                    None, _get, port, "/stats"))
                if doc.get("totals", {}).get("denied") == 3:
                    break
                assert time.monotonic() < deadline, doc
                await asyncio.sleep(0.2)
            assert doc["totals"] == {"allowed": 2, "denied": 3,
                                     "deny_rate": 0.6}
            assert doc["top_denied"][0] == {"key": "n:1", "count": 3,
                                            "error": 0}
            assert doc["engine_state"] == "ok"
            assert doc == ins.stats(state="ok")
        finally:
            await t.stop()

    asyncio.run(run())


def test_metrics_export_insight_gauges_as_jax():
    from throttlecrab_tpu.server.metrics import Metrics as JaxMetrics
    from throttlecrab_tpu_torch.server.metrics import METRIC_NAMES, Metrics

    texts = []
    jax_lim, port_lim = _pair()
    for metrics_cls, tier_cls, lim in ((JaxMetrics, JaxTier, jax_lim),
                                       (Metrics, InsightTier, port_lim)):
        m = metrics_cls(max_denied_keys=10)
        m.record_request_with_key("http", False, "u:1")
        m.record_request_with_key("http", False, "u:1")
        before = m.export_prometheus()
        assert 'throttlecrab_top_denied_keys{key="u:1",rank="1"} 2' in before
        ins = tier_cls(limiter=lim, poll_ms=1000)
        lim.rate_limit_batch(["g"] * 9, 2, 5, 60, 1, T0, wire=True)
        ins.maybe_poll(T0)
        lim.rate_limit_batch(["g"] * 9, 2, 5, 60, 1, T0 + 2 * NS, wire=True)
        ins.maybe_poll(T0 + 2 * NS)
        m.set_insight_stats_provider(ins.metric_stats)
        after = m.export_prometheus()
        texts.append([
            [line for line in text.splitlines() if "_insight_" in line]
            for text in (before, after)
        ])
    assert texts[1] == texts[0]
    assert "throttlecrab_tpu_insight_polls 0" in texts[1][0]
    assert "throttlecrab_tpu_insight_polls 2" in texts[1][1]
    for name in METRIC_NAMES:
        if "_insight_" in name:
            assert any(line.startswith(name + " ") for line in texts[1][1])


def test_config_knobs_and_factory_wiring(caplog):
    from throttlecrab_tpu_torch.server.config import Config, ConfigError
    from throttlecrab_tpu_torch.server.metrics import Metrics
    from throttlecrab_tpu_torch.server.store import (
        create_front_tier,
        create_insight,
        create_limiter,
        create_supervised_limiter,
    )

    cfg = Config(http=True, store_capacity=1 << 10, device="cpu",
                 keymap="python")
    cfg.validate()
    limiter = create_limiter(cfg)
    assert limiter.table.insight  # default on
    metrics = Metrics()
    sup = create_supervised_limiter(cfg, limiter, metrics)
    front = create_front_tier(cfg, metrics, sup)
    ins = create_insight(cfg, metrics, sup, front)
    assert ins is not None and ins.limiter is limiter
    assert front.insight is ins
    assert "throttlecrab_tpu_insight_polls 0" in metrics.export_prometheus()
    cfg_off = Config(http=True, store_capacity=1 << 10, insight=False,
                     device="cpu", keymap="python")
    lim_off = create_limiter(cfg_off)
    assert not lim_off.table.insight
    assert lim_off.table.state.shape[-1] == 4
    assert create_insight(cfg_off, metrics, lim_off, front) is None
    # Asked for, but the limiter carries no insight columns: dropped
    # with a warning.
    with caplog.at_level("WARNING"):
        assert create_insight(cfg, metrics, lim_off, front) is None
    assert "does not carry the insight" in caplog.text
    with pytest.raises(ConfigError):
        Config(http=True, insight_shed_weight=1.5).validate()
    with pytest.raises(ConfigError):
        Config(http=True, insight_topk=0).validate()
