"""The port's launch supervisor (server/supervisor.py) against the JAX
package's, under the same fault schedules.

Each case runs one request stream through JAX's
`SupervisedLimiter(TpuRateLimiter)` and the port's
`SupervisedLimiter(TorchRateLimiter(device="cpu"))`, each armed with the
same fault spec and seed in its own package, and compares after every
call: every field of every result, the supervisor's state,
`retry_count` / `degrade_count` / `repromote_count` and `len()`; and
`export_state` mid-outage and after re-promotion.  Each decision is also
held against an uninterrupted scalar `RateLimiter` run of the same
stream (the host oracle's own semantics: nothing lost or double-counted
across a degrade or a re-promotion).  Covered: `rate_limit_batch` (wire
on and off, collect_cur), `dispatch_many` with fetch faults,
`dispatch_wire_window` on the native keymap including the native
driver's `None` fallback, mode "fail", deterministic (keymap) errors,
the engine and /health over a supervised limiter, and the snapshot
site.  Exact equality: integer math.
"""

import asyncio

import numpy as np
import pytest

from throttlecrab_tpu import faults as jax_faults
from throttlecrab_tpu.server import supervisor as jax_sup
from throttlecrab_tpu.server.engine import BatchingEngine as JaxEngine
from throttlecrab_tpu.server.http import HttpTransport as JaxHttp
from throttlecrab_tpu.server.metrics import Metrics as JaxMetrics
from throttlecrab_tpu.server.native_redis import (
    NativeRedisTransport as JaxNativeRedis,
)
from throttlecrab_tpu.server.types import ThrottleRequest as JaxRequest
from throttlecrab_tpu.tpu import snapshot as jax_snapshot
from throttlecrab_tpu.tpu.limiter import TpuRateLimiter
from throttlecrab_tpu_torch import faults as port_faults
from throttlecrab_tpu_torch.core.rate_limiter import RateLimiter
from throttlecrab_tpu_torch.core.store.mapstore import MapStore
from throttlecrab_tpu_torch.native import wire_available
from throttlecrab_tpu_torch.server import supervisor as port_sup
from throttlecrab_tpu_torch.server.engine import BatchingEngine
from throttlecrab_tpu_torch.server.http import HttpTransport
from throttlecrab_tpu_torch.server.metrics import Metrics
from throttlecrab_tpu_torch.server.native_redis import NativeRedisTransport
from throttlecrab_tpu_torch.server.types import ThrottleRequest
from throttlecrab_tpu_torch.tpu import snapshot as port_snapshot
from throttlecrab_tpu_torch.tpu.limiter import TorchRateLimiter

NS = 1_000_000_000
T0 = 1_700_000_000 * NS
_FIELDS_NS = ("allowed", "limit", "remaining", "reset_after_ns",
              "retry_after_ns", "status", "cur_ns")
_FIELDS_S = ("allowed", "limit", "remaining", "reset_after_s",
             "retry_after_s", "status", "cur_ns")


@pytest.fixture(autouse=True)
def _disarm_both():
    yield
    jax_faults.disarm()
    port_faults.disarm()


def _arm(spec, seed=1):
    for pkg in (jax_faults, port_faults):
        pkg.arm(pkg.FaultInjector(pkg.parse_spec(spec), seed=seed,
                                  sleep_fn=lambda s: None))


def _heal():
    for pkg in (jax_faults, port_faults):
        pkg.active_injector().heal()


class _PlainStore(MapStore):
    def _maybe_cleanup(self, now_ns):
        pass


def _pair(capacity=256, keymap="python", **kw):
    """(JAX supervised limiter, port supervised limiter, their metrics)."""
    kw.setdefault("sleep_fn", lambda s: None)
    jm, pm = JaxMetrics(), Metrics()
    return (
        jax_sup.SupervisedLimiter(
            TpuRateLimiter(capacity=capacity, keymap=keymap), metrics=jm,
            **kw),
        port_sup.SupervisedLimiter(
            TorchRateLimiter(capacity=capacity, keymap=keymap, device="cpu"),
            metrics=pm, **kw),
        jm, pm,
    )


def _same_result(a, b, wire, where):
    assert type(a).__name__ == type(b).__name__, where
    for f in _FIELDS_S if wire else _FIELDS_NS:
        x, y = getattr(a, f), getattr(b, f)
        if x is None or y is None:
            assert x is None and y is None, (where, f)
        else:
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y),
                                          err_msg=f"{where} {f}")


def _same_supervisor(js, ps, where):
    assert (js.state, js.retry_count, js.degrade_count, js.repromote_count,
            len(js)) == (ps.state, ps.retry_count, ps.degrade_count,
                         ps.repromote_count, len(ps)), where


def _keyed(export):
    keys, slots, _shard, tat, exp, _cap, _d = export
    return {k: (int(t), int(e)) for k, t, e in zip(keys, tat, exp)}, set(
        np.asarray(slots).tolist())


def _batch(rng, t, n=8, pool=12):
    """Keys over a small pool (one hot key), per-key params, a few
    quantity-2 spends."""
    kid = rng.integers(0, pool, n)
    kid[0] = 0
    keys = [f"k{i}" for i in kid.tolist()]
    burst = 3 + kid % 4
    count = 10 + kid % 7
    period = 60 + kid % 5
    q = np.where(rng.random(n) < 0.1, 2, 1)
    return keys, burst, count, period, q, t


def _check_scalar(ref, batch, res, wire, where):
    keys, burst, count, period, q, t = batch
    for j, key in enumerate(keys):
        ok, r = ref.rate_limit(key, int(burst[j]), int(count[j]),
                               int(period[j]), int(q[j]), t)
        assert bool(res.allowed[j]) == ok, (where, j)
        assert int(res.remaining[j]) == r.remaining, (where, j)
        if wire:
            assert int(res.reset_after_s[j]) == r.reset_after_ns // NS
            assert int(res.retry_after_s[j]) == r.retry_after_ns // NS
        else:
            assert int(res.reset_after_ns[j]) == r.reset_after_ns
            assert int(res.retry_after_ns[j]) == r.retry_after_ns


# ---- rate_limit_batch under schedules ------------------------------------ #

_SCHEDULES = [
    # (spec, seed, supervisor kw, calls, heal at call)
    ("launch:count:3", 1, dict(retries=3), 12, None),
    ("launch:count:6", 1, dict(retries=1, probe_interval_ms=1000), 40, None),
    ("launch:count:2", 1, dict(retries=0, probe_interval_ms=10_000_000),
     30, None),
    ("launch:transient:0.3", 42, dict(retries=1, probe_interval_ms=500),
     40, None),
    ("launch:persistent", 3, dict(retries=2, probe_interval_ms=1000), 30, 18),
    ("launch:hang:0.1,launch:transient:0.5", 9,
     dict(retries=2, probe_interval_ms=700), 30, None),
]


@pytest.mark.parametrize("wire,collect_cur", [(False, False), (True, False),
                                              (True, True)],
                         ids=["ns", "wire", "wire-cur"])
@pytest.mark.parametrize("spec,seed,kw,calls,heal_at", _SCHEDULES,
                         ids=[s[0] for s in _SCHEDULES])
def test_rate_limit_batch_under_faults_matches_jax(spec, seed, kw, calls,
                                                   heal_at, wire,
                                                   collect_cur):
    """Retries, degrade, probe, re-promotion: both supervisors take the
    same transitions on the same calls and answer every field alike,
    and both answer as an uninterrupted scalar run."""
    _arm(spec, seed)
    js, ps, jm, pm = _pair(**kw)
    ref = RateLimiter(_PlainStore())
    rng = np.random.default_rng(seed)
    t = T0
    states = set()
    for i in range(calls):
        if i == heal_at:
            _heal()
        t += 3 * NS // 10
        batch = _batch(rng, t)
        got = [sup.rate_limit_batch(*batch, wire=wire,
                                    collect_cur=collect_cur)
               for sup in (js, ps)]
        _same_result(*got, wire, (spec, i))
        _same_supervisor(js, ps, (spec, i))
        _check_scalar(ref, batch, got[1], wire, (spec, i))
        states.add(ps.state)
        if ps.degraded:
            mid = [_keyed(port_snapshot.export_state(ps)),
                   _keyed(jax_snapshot.export_state(js))]
            assert mid[0] == mid[1], (spec, i)
            assert mid[0][1] == {-1}
    assert (jm.supervisor_retries, jm.supervisor_degrades,
            jm.supervisor_repromotes) == (pm.supervisor_retries,
                                          pm.supervisor_degrades,
                                          pm.supervisor_repromotes)
    if ps.degrade_count:
        assert port_sup.STATE_DEGRADED in states
    if ps.repromote_count:
        # Re-promoted: both tables hold the same buckets again, the
        # probe key included, and they are the scalar run's buckets.
        after = [_keyed(jax_snapshot.export_state(js))[0],
                 _keyed(port_snapshot.export_state(ps))[0]]
        assert after[0] == after[1]
        live = {k: v for k, v in after[1].items()
                if k != port_sup.PROBE_KEY and v[1] > t}
        want = {k: v for k, v in ref.store._data.items() if v[1] > t}
        assert live == want


def test_schedules_reach_every_state():
    """The schedules above really drive ok -> retrying -> degraded ->
    recovering -> ok (watched through the port's state writes)."""
    _arm("launch:count:6")
    _, ps, _, _ = _pair(retries=1, probe_interval_ms=1000)
    seen = []
    set_state = ps._set_state
    ps._set_state = lambda s: (seen.append(s), set_state(s))
    cas = ps._cas_state
    ps._cas_state = lambda e, s: (seen.append(s) if ps.state in e else None,
                                  cas(e, s))
    rng = np.random.default_rng(1)
    t = T0
    for _ in range(40):
        t += 3 * NS // 10
        ps.rate_limit_batch(*_batch(rng, t))
    assert {"retrying", "degraded", "recovering", "ok"} <= set(seen)
    assert ps.state == "ok" and ps.repromote_count == 1


# ---- dispatch_many with fetch faults ------------------------------------- #

@pytest.mark.parametrize("spec,retries", [
    ("fetch:count:2", 3), ("fetch:transient:0.4", 3),
    ("fetch:count:3,launch:count:1", 4),
])
def test_dispatch_many_fetch_faults_absorbed_as_in_jax(spec, retries):
    _arm(spec, 5)
    js, ps, _, _ = _pair(retries=retries)
    ref = RateLimiter(_PlainStore())
    rng = np.random.default_rng(8)
    t = T0
    for i in range(8):
        batches = []
        for _ in range(3):
            t += NS // 5
            batches.append(_batch(rng, t))
        handles = [sup.dispatch_many(batches, wire=True) for sup in (js, ps)]
        got = [h.fetch() for h in handles]
        for b, (a, c) in enumerate(zip(*got)):
            _same_result(a, c, True, (spec, i, b))
        for batch, res in zip(batches, got[1]):
            _check_scalar(ref, batch, res, True, (spec, i))
        _same_supervisor(js, ps, (spec, i))
    assert ps.state == "ok" and ps.degrade_count == 0
    assert ps.retry_count > 0


def test_fetch_exhaustion_raises_then_next_launch_degrades_as_in_jax():
    """Exhausted fetch retries re-raise (the window is unreadable; its
    writes committed); the next launch under a persistent fault
    degrades.  Same errors, same counters in both packages."""
    _arm("fetch:count:5", 2)
    js, ps, _, _ = _pair(retries=1)
    rng = np.random.default_rng(3)
    batches = [_batch(rng, T0 + NS)]
    errs = []
    for sup in (js, ps):
        h = sup.dispatch_many(batches, wire=True)
        with pytest.raises(RuntimeError) as e:
            h.fetch()
        errs.append(str(e.value))
    assert errs[0] == errs[1]
    _same_supervisor(js, ps, "after fetch exhaustion")
    _arm("launch:persistent")
    batches = [_batch(rng, T0 + 2 * NS)]
    got = [sup.dispatch_many(batches, wire=True).fetch() for sup in (js, ps)]
    _same_result(got[0][0], got[1][0], True, "degraded window")
    _same_supervisor(js, ps, "after degrade")
    assert ps.state == "degraded"


# ---- dispatch_wire_window on the native keymap --------------------------- #

def _frame(keys, params):
    blob = b"".join(keys)
    offsets = np.zeros(len(keys) + 1, np.int64)
    np.cumsum([len(k) for k in keys], out=offsets[1:])
    return blob, offsets, np.asarray(params, np.int64)


def _wire_frames(rng, n_frames=2, n=16):
    frames = []
    for _ in range(n_frames):
        kid = rng.integers(0, 20, n)
        keys = [b"w:%d" % i for i in kid.tolist()]
        params = np.stack([3 + kid % 4, 10 + kid % 7, 60 + kid % 5,
                           np.ones(n, np.int64)], 1)
        frames.append(_frame(keys, params))
    return frames


needs_native = pytest.mark.skipif(
    not wire_available(), reason="no C++ toolchain for the wire server")


@needs_native
@pytest.mark.parametrize("collect_cur", [False, True])
def test_wire_window_and_driver_fallback_match_jax(collect_cur):
    """Each package's native driver decides the same windows over its
    supervised native limiter through `_decide_frames`: transient launch
    faults are retried inside dispatch_wire_window; once degraded it
    returns None and the driver's exact path decides on the wrapper (the
    host oracle); after healing and the probe interval, the device again.
    Every result field, the route counters' story and the exported state
    agree, and every decision matches an uninterrupted scalar run."""
    _arm("launch:count:2")
    js, ps, _, _ = _pair(keymap="native", retries=3, probe_interval_ms=1000)
    jd = JaxNativeRedis("127.0.0.1", 0, js, JaxMetrics())
    pd = NativeRedisTransport("127.0.0.1", 0, ps, Metrics())
    if collect_cur:
        for d in (jd, pd):
            d._collect_cur_kw = {"collect_cur": True}
    ref = RateLimiter(_PlainStore())
    rng = np.random.default_rng(21)
    t = T0
    plan = ["ok"] * 3 + ["persistent"] + ["degraded"] * 3 + ["heal"] + \
        ["ok"] * 3
    for i, step in enumerate(plan):
        if step == "persistent":
            _arm("launch:persistent")
        if step == "heal":
            _heal()
            t += 2 * NS
        t += NS // 10
        frames = _wire_frames(rng)
        got = [d._decide_frames(frames, t)[0] for d in (jd, pd)]
        for a, b in zip(*got):
            assert a is not None and b is not None, (i, step)
            _same_result(a, b, True, (i, step))
        _same_supervisor(js, ps, (i, step))
        for (blob, offsets, params), res in zip(frames, got[1]):
            keys = [blob[offsets[j]:offsets[j + 1]]
                    for j in range(len(offsets) - 1)]
            batch = (keys, params[:, 0], params[:, 1], params[:, 2],
                     params[:, 3], t)
            _check_scalar(ref, batch, res, True, (i, step))
        if ps.degraded:
            assert _keyed(port_snapshot.export_state(ps)) == _keyed(
                jax_snapshot.export_state(js))
    assert (ps.degrade_count, ps.repromote_count) == (1, 1)
    after = [_keyed(jax_snapshot.export_state(js))[0],
             _keyed(port_snapshot.export_state(ps))[0]]
    assert after[0] == after[1]


@needs_native
def test_wire_window_returns_none_while_degraded_as_in_jax():
    _arm("launch:persistent")
    js, ps, _, _ = _pair(keymap="native", retries=1)
    rng = np.random.default_rng(4)
    frames = _wire_frames(rng)
    assert js.dispatch_wire_window(frames, T0) is None
    assert ps.dispatch_wire_window(frames, T0) is None
    _same_supervisor(js, ps, "degraded by the wire window")
    assert ps.state == "degraded"


# ---- mode "fail", deterministic errors ----------------------------------- #

def test_mode_fail_raises_instead_of_degrading_as_in_jax():
    _arm("launch:persistent")
    js, ps, _, _ = _pair(retries=1, mode="fail")
    rng = np.random.default_rng(6)
    batch = _batch(rng, T0)
    errs = []
    for sup in (js, ps):
        with pytest.raises(RuntimeError) as e:
            sup.rate_limit_batch(*batch)
        errs.append((type(e.value).__name__, str(e.value)))
    assert errs[0] == errs[1]
    assert errs[1][1].startswith("UNAVAILABLE")
    _same_supervisor(js, ps, "mode fail")
    assert ps.degrade_count == 0 and ps.retry_count == 2


def test_deterministic_error_not_retried_not_degraded_as_in_jax():
    _arm("keymap:persistent")
    js, ps, _, _ = _pair(retries=3)
    batch = _batch(np.random.default_rng(0), T0)
    errs = []
    for sup in (js, ps):
        with pytest.raises(Exception) as e:
            sup.rate_limit_batch(*batch)
        errs.append((type(e.value).__name__, str(e.value)))
    assert errs[0] == errs[1] == ("InternalError", "bucket table full")
    _same_supervisor(js, ps, "deterministic")
    assert ps.retry_count == 0 and ps.state == "ok"


# Real CUDA runtime messages: the first carries no JAX marker; the other
# two carry one ("UNAVAILABLE", "FAILED TO CONNECT").
_CUDA_ERRORS = (
    "CUDA error: an illegal memory access was encountered",
    "CUDA error: CUDA-capable device(s) is/are busy or unavailable",
    "CUDA error: MPS client failed to connect to the MPS control daemon "
    "or the MPS server",
)


def test_cuda_errors_classify_as_deterministic():
    """The JAX markers unchanged, so `classify_exception` agrees with
    JAX on every CUDA message, markers and all; on a card the
    supervisor treats each as deterministic (sticky context: no retry
    can help), which the stub test below drives."""
    want = ("deterministic", "transient", "transient")
    for msg, kind in zip(_CUDA_ERRORS, want):
        err = RuntimeError(msg)
        assert port_sup.classify_exception(err) == \
            jax_sup.classify_exception(err) == kind
    assert port_sup._TRANSIENT_MARKERS == jax_sup._TRANSIENT_MARKERS
    for exc in (ConnectionError("x"), TimeoutError("x"),
                RuntimeError("deadline exceeded"), ValueError("bad")):
        assert port_sup.classify_exception(exc) == \
            jax_sup.classify_exception(exc)


class _CardStub:
    """A limiter whose table claims a CUDA device and whose every launch
    (or, with `at_fetch`, every fetch) raises `exc`."""

    def __init__(self, exc, at_fetch=False):
        import types

        import torch

        self.table = types.SimpleNamespace(device=torch.device("cuda"))
        self.keymap = types.SimpleNamespace(BYTES_KEYS=False,
                                            items=lambda: [])
        self.exc, self.at_fetch, self.calls = exc, at_fetch, 0

    def _raise(self):
        self.calls += 1
        raise self.exc

    def rate_limit_batch(self, keys, max_burst, count_per_period, period,
                         quantity, now_ns, wire=False, collect_cur=False):
        self._raise()

    def dispatch_many(self, batches, wire=False, collect_cur=False):
        if not self.at_fetch:
            self._raise()
        stub = self

        class Handle:
            def fetch(self):
                stub._raise()

        return Handle()

    def __len__(self):
        return 0


@pytest.mark.parametrize("path", ["batch", "dispatch", "fetch"])
@pytest.mark.parametrize("msg", _CUDA_ERRORS)
def test_real_cuda_error_on_card_never_reaches_the_oracle(msg, path):
    """On a card a real CUDA error re-raises on its first attempt, with
    or without a JAX marker: no retry, no degrade, no host oracle."""
    err = RuntimeError(msg)
    stub = _CardStub(err, at_fetch=(path == "fetch"))
    sup = port_sup.SupervisedLimiter(stub, retries=3,
                                     sleep_fn=lambda s: None)
    batch = (["k"], 5, 10, 60, 1, T0)
    with pytest.raises(RuntimeError) as e:
        if path == "batch":
            sup.rate_limit_batch(*batch)
        else:
            sup.dispatch_many([batch]).fetch()
    assert e.value is err and stub.calls == 1
    assert (sup.state, sup.retry_count, sup.degrade_count) == ("ok", 0, 0)
    assert sup._oracle is None and not sup.degraded


def test_injected_fault_on_card_still_degrades():
    """The gate above passes injected faults: the drill's path."""
    err = port_faults.InjectedDeviceError(
        "UNAVAILABLE: injected launch fault (persistent)")
    stub = _CardStub(err)
    sup = port_sup.SupervisedLimiter(stub, retries=2,
                                     sleep_fn=lambda s: None)
    res = sup.rate_limit_batch(["k"], 5, 10, 60, 1, T0)
    assert stub.calls == 3 and sup.retry_count == 3
    assert sup.state == "degraded" and sup.degrade_count == 1
    assert bool(res.allowed[0]) and len(sup) == 1


def test_supervisor_state_helper_walks_wrappers_as_in_jax():
    js, ps, _, _ = _pair(retries=0)

    class JaxCluster:
        local = js

    class PortCluster:
        local = ps

    assert port_sup.supervisor_state(ps) == "ok"
    assert port_sup.supervisor_state(PortCluster()) == \
        jax_sup.supervisor_state(JaxCluster()) == "ok"
    assert port_sup.supervisor_state(
        TorchRateLimiter(capacity=16, device="cpu")) == "ok"
    assert port_sup.supervisor_of(ps.inner) is None


def test_supervised_api_surface_as_in_jax():
    """The optional methods are offered only where the inner limiter
    offers them, and everything else delegates."""
    js, ps, _, _ = _pair()
    for name in ("rate_limit_many", "dispatch_many", "dispatch_wire_window",
                 "expired_hits_fetch_due", "take_expired_hits"):
        assert hasattr(ps, name) == hasattr(js, name), name
    assert ps.total_capacity == js.total_capacity
    assert ps.keymap is ps.inner.keymap


# ---- the engine, /health and metrics over a supervisor ------------------- #

class _Clock:
    def __init__(self):
        self.now = T0

    def __call__(self):
        return self.now


def _norm(r):
    if isinstance(r, Exception):
        return type(r).__name__, str(r)
    return (r.allowed, r.limit, r.remaining, r.reset_after, r.retry_after)


@pytest.mark.parametrize("spec,kw", [
    ("launch:count:3", dict(retries=3)),
    ("fetch:count:2", dict(retries=3)),
    ("launch:persistent", dict(retries=2)),
    ("launch:persistent", dict(retries=1, mode="fail")),
    ("keymap:persistent", dict(retries=3)),
])
def test_engine_over_supervisor_matches_jax(spec, kw):
    """Both engines over their supervised limiters answer the same
    requests alike, report the same /health body and render the same
    supervisor and fault lines on /metrics."""
    _arm(spec, 4)
    js, ps, jm, pm = _pair(**kw)
    jm.set_engine_state_provider(lambda: js.state)
    pm.set_engine_state_provider(lambda: ps.state)

    async def main():
        clock = _Clock()
        engines = (
            JaxEngine(js, now_fn=clock, metrics=jm, batch_size=8,
                      max_linger_us=500),
            BatchingEngine(ps, now_fn=clock, metrics=pm, batch_size=8,
                           max_linger_us=500),
        )
        https = (JaxHttp("127.0.0.1", 0, engines[0], jm),
                 HttpTransport("127.0.0.1", 0, engines[1], pm))
        out = []
        for wave in range(4):
            reqs = [(f"e{(wave * 3 + i) % 5}", 3, 10, 60, 1)
                    for i in range(8)]
            got = []
            for eng, req in zip(engines, (JaxRequest, ThrottleRequest)):
                got.append(await asyncio.gather(
                    *[eng.throttle(req(*r)) for r in reqs],
                    return_exceptions=True))
            out.append(([_norm(r) for r in got[0]],
                        [_norm(r) for r in got[1]]))
            health = [await h._route("GET", "/health", b"") for h in https]
            out.append(tuple(health))
            clock.now += NS // 3
        for eng in engines:
            await eng.shutdown()
        return out

    for jax_side, port_side in asyncio.run(main()):
        assert jax_side == port_side

    def lines(m):
        return [ln for ln in m.export_prometheus().splitlines()
                if "supervisor" in ln or "engine_state" in ln
                or "faults_injected" in ln]

    assert lines(jm) == lines(pm)


# ---- the snapshot site and a degraded snapshot --------------------------- #

def test_snapshot_site_raises_the_same_shape(tmp_path):
    _arm("snapshot:persistent")
    errs = []
    for lim, snap in ((TpuRateLimiter(capacity=64, keymap="python"),
                       jax_snapshot),
                      (TorchRateLimiter(capacity=64, device="cpu"),
                       port_snapshot)):
        lim.rate_limit_batch(["a"], 5, 10, 60, 1, T0)
        with pytest.raises(OSError) as e:
            snap.save_snapshot(lim, tmp_path / f"{snap.__name__}.npz")
        errs.append(str(e.value))
        empty = type(lim)(capacity=64, **(
            {"device": "cpu"} if snap is port_snapshot else
            {"keymap": "python"}))
        with pytest.raises(OSError) as e:
            snap.load_snapshot(empty, tmp_path / "missing.npz", T0)
        errs.append(str(e.value))
    assert errs[0] == errs[1]
    assert list(tmp_path.iterdir()) == []


def test_fsync_fault_leaves_no_file(tmp_path):
    _arm("snapshot:fsyncfail")
    lim = TorchRateLimiter(capacity=64, device="cpu")
    lim.rate_limit_batch(["a"], 5, 10, 60, 1, T0)
    with pytest.raises(port_faults.FsyncFailError):
        port_snapshot.save_snapshot(lim, tmp_path / "s")
    assert list(tmp_path.iterdir()) == []


def test_degraded_snapshot_exports_host_state_as_in_jax(tmp_path):
    """A snapshot taken mid-outage holds the host oracle's state; both
    packages write the same keys and buckets, and either file restores
    into a healthy limiter of the other package."""
    _arm("launch:persistent")
    js, ps, _, _ = _pair(retries=0)
    t = T0
    for i in range(5):
        t += NS // 10
        for sup in (js, ps):
            sup.rate_limit_batch([f"s{i}", "hot"], 5, 10, 60, 1, t)
    assert js.state == ps.state == "degraded"
    n = [jax_snapshot.save_snapshot(js, tmp_path / "j"),
         port_snapshot.save_snapshot(ps, tmp_path / "p")]
    assert n == [6, 6]
    jax_faults.disarm()
    port_faults.disarm()
    restored = []
    for path in ("j", "p"):
        fresh_j = TpuRateLimiter(capacity=64, keymap="python")
        fresh_p = TorchRateLimiter(capacity=64, device="cpu")
        assert jax_snapshot.load_snapshot(fresh_j, tmp_path / path, t) == 6
        assert port_snapshot.load_snapshot(fresh_p, tmp_path / path, t) == 6
        restored += [_keyed(jax_snapshot.export_state(fresh_j))[0],
                     _keyed(port_snapshot.export_state(fresh_p))[0]]
    assert all(r == restored[0] for r in restored)


def test_load_snapshot_clears_the_front_as_in_jax(tmp_path):
    from throttlecrab_tpu_torch.front import DenyCache, FrontTier

    lim = TorchRateLimiter(capacity=64, device="cpu")
    lim.rate_limit_batch(["a"], 5, 10, 60, 1, T0)
    port_snapshot.save_snapshot(lim, tmp_path / "s")
    front = FrontTier(DenyCache(16), None)
    front.deny_cache._records["a"] = (1, 1, 1)
    assert port_snapshot.load_snapshot(
        TorchRateLimiter(capacity=64, device="cpu"), tmp_path / "s", T0,
        front=front) == 1
    assert front.deny_cache._records == {}


def test_scalar_oracle_is_the_jax_oracle():
    """HostOracle over each package's core answers a mixed stream (bad
    params, negative quantity, str and bytes keys) identically."""
    outs = []
    for mod in (jax_sup, port_sup):
        oracle = mod.HostOracle(bytes_keys=True)
        oracle.seed(["s", b"t"], [T0 + 5 * NS, T0], [T0 + 9 * NS, T0 + NS])
        res = [oracle.rate_limit_batch(
            ["s", b"t", "u", "v", "s"], [3, 3, 0, 3, 3], [1, 1, 1, 1, 1],
            [60, 60, 60, 60, 60], [1, 1, 1, -1, 2], T0 + k * NS, wire=w)
            for k, w in ((0, False), (1, True), (2, False))]
        outs.append((res, sorted(oracle.mutated), len(oracle),
                     oracle.export_mutated(T0 + 3 * NS),
                     oracle.sweep(T0 + 10**6 * NS)))
    (rj, mj, lj, ej, sj), (rp, mp, lp, ep, sp) = outs
    for a, b in zip(rj, rp):
        _same_result(a, b, hasattr(a, "reset_after_s"), "oracle")
    assert (mj, lj, ej, sj) == (mp, lp, ep, sp)


def test_recovery_at_a_window_with_earlier_batches_matches_jax():
    """A reference behaviour the port keeps (ROADMAP C5): the supervisor
    probes and re-promotes at a window's LAST timestamp, so a host bucket
    that lapsed by then is not written back, while an earlier batch of
    the same window still sees it live in an uninterrupted run.  Both
    packages answer that batch alike (first touch); the scalar oracle
    continues the bucket.  Served windows carry one timestamp, where
    this cannot happen."""
    _arm("launch:persistent")
    js, ps, _, _ = _pair(retries=0, probe_interval_ms=1000)
    ref = RateLimiter(_PlainStore())
    ms = 1_000_000
    params = (5, 590, 90, 1)  # em 152.5 ms, tol 610 ms
    for sup in (js, ps):
        sup.rate_limit_batch(["warm"], *params, T0)
        # The oracle allows "k": its bucket lapses at +660 ms.
        sup.rate_limit_batch(["k"], *params, T0 + 50 * ms)
    assert js.state == ps.state == "degraded"
    ref.rate_limit("warm", *params, T0)
    ref.rate_limit("k", *params, T0 + 50 * ms)
    _heal()
    window = [(["k"], *params, T0 + 600 * ms),
              (["x"], *params, T0 + 1100 * ms)]
    got = [sup.dispatch_many(window, wire=True).fetch() for sup in (js, ps)]
    for a, b in zip(*got):
        _same_result(a, b, True, "recovering window")
    _same_supervisor(js, ps, "recovered")
    assert ps.repromote_count == 1
    ok, want = ref.rate_limit("k", *params, T0 + 600 * ms)
    assert bool(got[1][0].allowed[0]) == ok
    assert int(got[1][0].remaining[0]) == 4 != want.remaining == 6
