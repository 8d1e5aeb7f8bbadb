"""The port's front tier (throttlecrab_tpu_torch/front/) against the JAX
package's (throttlecrab_tpu/front/).

- `DenyCache`: a hypothesis differential over random operation
  sequences (lookup, lookup_window, observe and observe_window of
  allowed and denied rows, in-flight marks, release_window,
  fail_window, seq rollback, prewarm, sweep, clear, capacity eviction):
  every answer and, after every operation, the cache's whole state
  (entries in eviction order, write records, in-flight counts, seq,
  hit and stale counters) must be equal.
- `AdmissionController`: the same admit / record_launch / hot-set
  sequence gives the same verdicts, counters and EWMA.
- The engine: the same abuse traffic through the port's engine with the
  deny cache, without it, and through the JAX engine with its deny
  cache must give the same answer for every request (across sweeps,
  parameter churn, expiry jumps and a snapshot round trip), with
  hundreds of cache hits.
- Each transport's answer to a shed request (HTTP 503, gRPC
  RESOURCE_EXHAUSTED, RESP `-ERR server overloaded`, and the native
  RESP / HTTP wire servers) is byte-identical to the JAX transport's.
- The native RESP driver with a front tier answers a pipelined stream
  byte for byte as the JAX driver does, with deny-cache hits and fewer
  launches than windows.

All on the CPU (the port's limiter on device="cpu"); exact equality.
"""

import asyncio
import json
import os
import socket
import tempfile
import threading

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from throttlecrab_tpu import front as jax_front
from throttlecrab_tpu.server.config import Config as JaxConfig
from throttlecrab_tpu.server.engine import BatchingEngine as JaxEngine
from throttlecrab_tpu.server.metrics import Metrics as JaxMetrics
from throttlecrab_tpu.server.store import create_front_tier as jax_create
from throttlecrab_tpu.server.types import ThrottleRequest as JaxRequest
from throttlecrab_tpu.tpu import cleanup as jax_cleanup
from throttlecrab_tpu.tpu import snapshot as jax_snapshot
from throttlecrab_tpu.tpu.limiter import TpuRateLimiter
from throttlecrab_tpu_torch import front as port_front
from throttlecrab_tpu_torch.native import wire_available
from throttlecrab_tpu_torch.server.config import Config
from throttlecrab_tpu_torch.server.engine import BatchingEngine
from throttlecrab_tpu_torch.server.metrics import Metrics
from throttlecrab_tpu_torch.server.store import create_front_tier
from throttlecrab_tpu_torch.server.types import ThrottleRequest
from throttlecrab_tpu_torch.tpu import cleanup as port_cleanup
from throttlecrab_tpu_torch.tpu import snapshot as port_snapshot
from throttlecrab_tpu_torch.tpu.limiter import (
    TorchRateLimiter,
    limiter_uses_bytes_keys,
)

NS = 1_000_000_000
T0 = 1_800_000_000 * NS


def test_status_and_message_as_in_jax():
    assert port_front.STATUS_OVERLOADED == jax_front.STATUS_OVERLOADED == 4
    assert port_front.OVERLOAD_MESSAGE == jax_front.OVERLOAD_MESSAGE
    assert str(port_front.OverloadError()) == str(jax_front.OverloadError())


# ---- DenyCache: hypothesis differential ---------------------------------- #

_KEYS = ["a", "b", "c", "d"]
# em = 1 s, tol = 2 s; em = 2 s, tol = 2 s; an invalid triple.
_PARAMS = [(3, 60, 60), (2, 30, 60), (0, 1, 1)]
_NOW = st.integers(-2, 8 * NS).map(lambda d: T0 + d if d >= 0 else -5)
_CUR = st.sampled_from([None, T0, T0 + 2 * NS, T0 + 3 * NS, T0 + 4 * NS])

_op = st.one_of(
    st.tuples(st.just("lookup"), st.sampled_from(_KEYS),
              st.sampled_from(_PARAMS), st.integers(0, 3), _NOW),
    st.tuples(st.just("lookup_window"),
              st.lists(st.sampled_from(_KEYS), min_size=1, max_size=40),
              st.sampled_from(_PARAMS), st.integers(0, 3), _NOW,
              st.booleans()),
    st.tuples(st.just("observe"), st.sampled_from(_KEYS),
              st.sampled_from(_PARAMS), st.integers(0, 3), _NOW,
              st.booleans(), st.integers(0, 12), _CUR),
    st.tuples(st.just("observe_window"),
              st.lists(st.tuples(st.sampled_from(_KEYS),
                                 st.sampled_from(_PARAMS),
                                 st.integers(0, 3), st.booleans(), _CUR),
                       min_size=1, max_size=10),
              _NOW, st.integers(0, 12)),
    st.tuples(st.just("begin"), st.sampled_from(_KEYS)),
    st.tuples(st.just("end"), st.sampled_from(_KEYS)),
    st.tuples(st.just("release"), st.lists(st.sampled_from(_KEYS))),
    st.tuples(st.just("fail"), st.lists(st.sampled_from(_KEYS))),
    st.tuples(st.just("next_seq")),
    st.tuples(st.just("sweep"), _NOW),
    st.tuples(st.just("prewarm"), st.lists(st.sampled_from(_KEYS))),
    st.tuples(st.just("invalidate"), st.sampled_from(_KEYS)),
    st.tuples(st.just("clear")),
)


def _apply(cache, op):
    kind = op[0]
    if kind == "lookup":
        _, key, (mb, cpp, per), q, now = op
        hit = cache.lookup(key, mb, cpp, per, q, now)
        return None if hit is None else (
            hit.limit, hit.remaining, hit.reset_after_ns,
            hit.retry_after_ns, hit.reset_after_s, hit.retry_after_s)
    if kind == "lookup_window":
        _, keys, (mb, cpp, per), q, now, mark = op
        n = len(keys)
        return cache.lookup_window(
            keys, np.full(n, mb), [cpp] * n, np.full(n, per), [q] * n, now,
            mark_inflight=mark)
    if kind == "observe":
        _, key, (mb, cpp, per), q, now, allowed, seq, cur = op
        return cache.observe(key, mb, cpp, per, q, now, allowed, seq,
                             cur_ns=cur)
    if kind == "observe_window":
        _, rows, now, seq = op
        return cache.observe_window(
            [(k, mb, cpp, per, q, a, c)
             for k, (mb, cpp, per), q, a, c in rows], now, seq)
    if kind == "begin":
        return cache.begin_inflight(op[1])
    if kind == "end":
        return cache.end_inflight(op[1])
    if kind == "release":
        return cache.release_window(op[1])
    if kind == "fail":
        return cache.fail_window(op[1])
    if kind == "next_seq":
        return cache.next_seq()
    if kind == "sweep":
        return cache.on_sweep(op[1])
    if kind == "prewarm":
        return cache.prewarm(op[1])
    if kind == "invalidate":
        return cache.invalidate_key(op[1])
    return cache.clear()


def _state(cache):
    return (
        [(k, (e.tat, e.emission, e.tolerance, e.increment, e.limit,
              e.expiry)) for k, e in cache._entries.items()],
        {k: sorted(v) for k, v in cache._by_key.items()},
        list(cache._records.items()),
        dict(cache._inflight),
        cache._seq, cache.hits, cache.stale_evictions, len(cache),
    )


@settings(max_examples=150, deadline=None)
@given(capacity=st.integers(1, 6), ops=st.lists(_op, max_size=60))
def test_deny_cache_matches_jax(capacity, ops):
    jax_cache = jax_front.DenyCache(capacity)
    port_cache = port_front.DenyCache(capacity)
    for i, op in enumerate(ops):
        got = [_apply(c, op) for c in (jax_cache, port_cache)]
        assert got[0] == got[1], (i, op)
        assert _state(jax_cache) == _state(port_cache), (i, op)


def _prime(cache, key="u", now=T0):
    """An allowed write that saturated the bucket, then a certifying
    quantity-3 denial one ns later (burst 3 / 60 per 60 s: em 1 s,
    tol 2 s, a 3 s proven window)."""
    tat = now + 2 * NS
    cache.observe(key, 3, 60, 60, 1, now, True, seq=1, cur_ns=tat)
    cache.observe(key, 3, 60, 60, 3, now + 1, False, seq=2, cur_ns=tat)
    return tat


def test_deny_cache_serves_decayed_hits_as_in_jax():
    """The primed sequence of the JAX suite's unit tests: hits decay by
    exactly the elapsed time, the window closes, sweeps evict, on both."""
    out = []
    for pkg in (jax_front, port_front):
        cache = pkg.DenyCache(64)
        tat = _prime(cache)
        rows, n = cache.lookup_window(["u"] * 40 + ["v"], [3] * 41,
                                      [60] * 41, [60] * 41, [3] * 41,
                                      T0 + 5)
        cache.release_window(["v"])
        hits = [cache.lookup("u", 3, 60, 60, 3, T0 + d)
                for d in (2, 2 + NS, 3 * NS - 1, 3 * NS)]
        out.append(([None if h is None else (
            h.limit, h.remaining, h.reset_after_ns, h.retry_after_ns)
            for h in hits], rows, n, cache.on_sweep(tat + 2 * NS + 1),
            cache.hits, cache.stale_evictions))
    assert out[0] == out[1]
    hits = out[1][0]
    assert hits[0][3] - hits[1][3] == NS and hits[3] is None
    assert out[1][2] == 40


# ---- AdmissionController ------------------------------------------------- #

_adm_op = st.one_of(
    st.tuples(st.just("admit"), st.integers(0, 300), st.booleans()),
    st.tuples(st.just("launch"), st.integers(-1, 500),
              st.floats(-0.001, 0.05, allow_nan=False)),
    st.tuples(st.just("hot"), st.floats(-1, 2, allow_nan=False)),
    st.tuples(st.just("weight"), st.sampled_from([0.0, 0.5, 1.0])),
    st.tuples(st.just("wait"), st.integers(0, 300)),
)


@settings(max_examples=150, deadline=None)
@given(max_pending=st.integers(0, 200), max_wait_us=st.integers(0, 2000),
       peek_frac=st.sampled_from([0.1, 0.5, 0.9, 1.0]),
       ops=st.lists(_adm_op, max_size=80))
def test_admission_matches_jax(max_pending, max_wait_us, peek_frac, ops):
    ctl = [pkg.AdmissionController(max_pending, max_wait_us, peek_frac)
           for pkg in (jax_front, port_front)]
    for op in ops:
        got = []
        for c in ctl:
            if op[0] == "admit":
                got.append(c.admit(op[1], op[2]))
            elif op[0] == "launch":
                got.append(c.record_launch(op[1], op[2]))
            elif op[0] == "hot":
                got.append(c.set_hot_concentration(op[1]))
            elif op[0] == "weight":
                c.hot_shed_weight = op[1]
                got.append(None)
            else:
                got.append(c.estimated_wait_us(op[1]))
        assert got[0] == got[1], op
        assert [(c.shed_peek, c.shed_consume, c._cost_us,
                 c.hot_concentration) for c in ctl][0] == (
            ctl[1].shed_peek, ctl[1].shed_consume, ctl[1]._cost_us,
            ctl[1].hot_concentration)


@pytest.mark.parametrize("args", [(-1, 0, 0.9), (0, -1, 0.9), (0, 0, 0.0),
                                  (0, 0, 1.5)])
def test_admission_bounds_refused_as_in_jax(args):
    for pkg in (jax_front, port_front):
        with pytest.raises(ValueError):
            pkg.AdmissionController(*args)


# ---- the engine: cache on == cache off == JAX ---------------------------- #

class VirtualClock:
    def __init__(self, start_ns=T0):
        self.now = start_ns

    def __call__(self):
        return self.now


def _norm(r):
    if isinstance(r, Exception):
        return type(r).__name__, str(r)
    return (r.allowed, r.limit, r.remaining, r.reset_after, r.retry_after)


def _draw_params(rng):
    return int(rng.integers(2, 6)), int(rng.integers(1, 5)), int(
        rng.integers(10, 90))


def _abuse_window(rng, pool, params, size):
    """~85 % of rows hammer 3 hot keys, the rest the cold tail; a few
    quantity-0 probes, quantity-2 spends and invalid params."""
    reqs = []
    for _ in range(size):
        key = pool[int(rng.integers(0, 3))] if rng.random() < 0.85 else \
            pool[int(rng.integers(3, len(pool)))]
        burst, count, period = params[key]
        q = 1
        p = rng.random()
        if p < 0.015:
            q = 0
        elif p < 0.08:
            q = 2
        elif p < 0.10:
            burst = -1
        reqs.append((key, burst, count, period, q))
    return reqs


_POLICIES = {
    "periodic": lambda m: m.PeriodicPolicy(interval_ns=20 * NS),
    "probabilistic": lambda m: m.ProbabilisticPolicy(probability=257),
    "adaptive": lambda m: m.AdaptivePolicy(
        min_interval_ns=10 * NS, max_interval_ns=120 * NS,
        max_operations=700),
}


def _engines(clock, policy, limiters=None, fronts=None):
    """(port engine with the deny cache, port engine without, JAX engine
    with its deny cache), their limiters and the two fronts."""
    pl, bl, jl = limiters or (
        TorchRateLimiter(capacity=1024, device="cpu"),
        TorchRateLimiter(capacity=1024, device="cpu"),
        TpuRateLimiter(capacity=1024, keymap="python"))
    pf, jf = fronts or (
        port_front.FrontTier(port_front.DenyCache(4096), None,
                             bytes_keys=limiter_uses_bytes_keys(pl)),
        jax_front.FrontTier(jax_front.DenyCache(4096), None,
                            bytes_keys=False))
    kw = dict(now_fn=clock, batch_size=64, max_linger_us=500)
    return (
        BatchingEngine(pl, front=pf,
                       cleanup_policy=_POLICIES[policy](port_cleanup), **kw),
        BatchingEngine(bl, cleanup_policy=_POLICIES[policy](port_cleanup),
                       **kw),
        JaxEngine(jl, front=jf,
                  cleanup_policy=_POLICIES[policy](jax_cleanup), **kw),
    ), (pl, bl, jl), (pf, jf)


@pytest.mark.parametrize("policy", sorted(_POLICIES))
def test_engine_cache_on_equals_cache_off_and_jax(policy):
    """~1,800 requests of hot-key abuse per policy: the port's engine
    with the deny cache answers every request as the port's engine
    without it and as the JAX engine with its cache, across param churn,
    expiry jumps, sweeps and a mid-run snapshot round trip (which clears
    the cache); the caches serve hundreds of hits and hit alike."""
    rng = np.random.default_rng(0xF2047 + sorted(_POLICIES).index(policy))
    n_windows, window = 56, 32

    async def run():
        clock = VirtualClock()
        engines, lims, fronts = _engines(clock, policy)
        pool = [f"fk:{i}" for i in range(16)]
        params = {k: _draw_params(rng) for k in pool}
        hits_before = 0
        for step in range(n_windows):
            if rng.random() < 0.10:
                params[pool[int(rng.integers(0, 3))]] = _draw_params(rng)
            reqs = _abuse_window(rng, pool, params, window)
            got = await asyncio.gather(*[
                asyncio.gather(*[eng.throttle(cls(*r)) for r in reqs],
                               return_exceptions=True)
                for eng, cls in zip(engines, (ThrottleRequest,
                                              ThrottleRequest, JaxRequest))
            ])
            for i, (a, b, c) in enumerate(zip(*got)):
                assert _norm(a) == _norm(b) == _norm(c), (step, i, reqs[i])
            clock.now += int(rng.integers(0, 3 * NS))
            if rng.random() < 0.08:
                clock.now += int(rng.integers(120, 600)) * NS
            if step == n_windows // 2:
                hits_before = fronts[0].deny_cache.hits
                assert len(fronts[0].deny_cache) > 0
                for eng in engines:
                    await eng.shutdown()
                with tempfile.TemporaryDirectory() as d:
                    paths = [os.path.join(d, n) for n in "pbj"]
                    port_snapshot.save_snapshot(lims[0], paths[0])
                    port_snapshot.save_snapshot(lims[1], paths[1])
                    jax_snapshot.save_snapshot(lims[2], paths[2])
                    new = (TorchRateLimiter(capacity=1024, device="cpu"),
                           TorchRateLimiter(capacity=1024, device="cpu"),
                           TpuRateLimiter(capacity=1024, keymap="python"))
                    port_snapshot.load_snapshot(new[0], paths[0], clock.now,
                                                front=fronts[0])
                    port_snapshot.load_snapshot(new[1], paths[1], clock.now)
                    jax_snapshot.load_snapshot(new[2], paths[2], clock.now,
                                               front=fronts[1])
                assert len(fronts[0].deny_cache) == 0
                # The cleared fronts carry on (their hit counters too).
                engines, lims, fronts = _engines(clock, policy, new, fronts)
        for eng in engines:
            await eng.shutdown()
        return fronts, hits_before

    fronts, hits_before = asyncio.run(run())
    assert hits_before > 50
    assert fronts[0].deny_cache.hits > hits_before + 50
    assert fronts[0].deny_cache.hits == fronts[1].deny_cache.hits


def test_engine_sheds_and_releases_as_in_jax():
    """max_pending=1: the first request lingers, the second is shed with
    OverloadError; the shed row holds nothing in the cache."""

    async def run(pkg, engine_cls, limiter, req_cls):
        front = pkg.FrontTier(pkg.DenyCache(64),
                              pkg.AdmissionController(max_pending=1))
        eng = engine_cls(limiter, now_fn=lambda: T0, front=front,
                         max_linger_us=200_000)
        t1 = asyncio.ensure_future(eng.throttle(req_cls("d1", 3, 10, 60, 1)))
        await asyncio.sleep(0.01)
        try:
            await eng.throttle(req_cls("d2", 3, 10, 60, 1))
            shed = None
        except Exception as e:
            shed = (type(e).__name__, str(e))
        r1 = await t1
        await eng.shutdown()
        return (shed, _norm(r1), front.admission.shed_consume,
                dict(front.deny_cache._inflight))

    got = [asyncio.run(run(jax_front, JaxEngine,
                           TpuRateLimiter(capacity=64, keymap="python"),
                           JaxRequest)),
           asyncio.run(run(port_front, BatchingEngine,
                           TorchRateLimiter(capacity=64, device="cpu"),
                           ThrottleRequest))]
    assert got[0] == got[1]
    assert got[1][0] == ("OverloadError", "server overloaded")
    assert got[1][3] == {}


# ---- shed replies per transport ------------------------------------------ #

class _AlwaysShed:
    """Factory of an admission controller that sheds every request, in
    either package (the verdict is forced so the wire mapping is pinned
    independently of queue depth)."""

    @staticmethod
    def of(pkg):
        class AlwaysShed(pkg.AdmissionController):
            def __init__(self):
                super().__init__(max_pending=1)

            def admit(self, depth, peek):
                with self._lock:
                    if peek:
                        self.shed_peek += 1
                    else:
                        self.shed_consume += 1
                return False

        return AlwaysShed()


def _shed_engines():
    jm, pm = JaxMetrics(), Metrics()
    jf = jax_front.FrontTier(None, _AlwaysShed.of(jax_front), metrics=jm)
    pf = port_front.FrontTier(None, _AlwaysShed.of(port_front), metrics=pm)
    return (
        JaxEngine(TpuRateLimiter(capacity=64, keymap="python"),
                  now_fn=lambda: T0, front=jf),
        BatchingEngine(TorchRateLimiter(capacity=64, device="cpu"),
                       now_fn=lambda: T0, front=pf),
        jm, pm,
    )


def test_http_shed_reply_as_in_jax():
    from throttlecrab_tpu.server.http import HttpTransport as JaxHttp
    from throttlecrab_tpu_torch.server.http import HttpTransport

    async def run():
        je, pe, jm, pm = _shed_engines()
        body = json.dumps({"key": "s", "max_burst": 3,
                           "count_per_period": 10, "period": 60}).encode()
        got = [await JaxHttp("127.0.0.1", 0, je, jm)._route(
                   "POST", "/throttle", body, {}),
               await HttpTransport("127.0.0.1", 0, pe, pm)._route(
                   "POST", "/throttle", body, {})]
        return got, jm, pm

    got, jm, pm = asyncio.run(run())
    assert got[0] == got[1]
    assert got[1][0] == 503 and b"overloaded" in got[1][1]
    assert jm.front_shed_consume == pm.front_shed_consume == 1


def test_grpc_shed_status_as_in_jax():
    grpc = pytest.importorskip("grpc")
    import grpc.aio

    from throttlecrab_tpu.server.grpc import GrpcTransport as JaxGrpc
    from throttlecrab_tpu_torch.server.grpc import GrpcTransport
    from throttlecrab_tpu_torch.server.proto import throttlecrab_pb2 as pb

    async def call(transport):
        await transport.start()
        try:
            async with grpc.aio.insecure_channel(
                    f"127.0.0.1:{transport.bound_port}") as ch:
                method = ch.unary_unary(
                    "/throttlecrab.RateLimiter/Throttle",
                    request_serializer=pb.ThrottleRequest.SerializeToString,
                    response_deserializer=pb.ThrottleResponse.FromString)
                try:
                    await method(pb.ThrottleRequest(
                        key="s", max_burst=3, count_per_period=10,
                        period=60, quantity=1))
                    return None
                except grpc.aio.AioRpcError as e:
                    return e.code(), e.details()
        finally:
            await transport.stop()

    async def run():
        je, pe, jm, pm = _shed_engines()
        return [await call(JaxGrpc("127.0.0.1", 0, je, jm)),
                await call(GrpcTransport("127.0.0.1", 0, pe, pm))]

    got = asyncio.run(run())
    assert got[0] == got[1]
    assert got[1][0] == grpc.StatusCode.RESOURCE_EXHAUSTED


def test_redis_shed_reply_as_in_jax():
    from throttlecrab_tpu.server.redis import RedisTransport as JaxRedis
    from throttlecrab_tpu_torch.server.redis import RedisTransport

    frame = (b"*6\r\n$8\r\nTHROTTLE\r\n$1\r\ns\r\n$1\r\n3\r\n$2\r\n10\r\n"
             b"$2\r\n60\r\n$1\r\n1\r\n*1\r\n$4\r\nQUIT\r\n")

    async def call(transport):
        await transport.start()
        try:
            reader, writer = await asyncio.open_connection(
                "127.0.0.1", transport.bound_port)
            writer.write(frame)
            await writer.drain()
            raw = await asyncio.wait_for(reader.read(), 10)
            writer.close()
            return raw
        finally:
            await transport.stop()

    async def run():
        je, pe, jm, pm = _shed_engines()
        return [await call(JaxRedis("127.0.0.1", 0, je, jm)),
                await call(RedisTransport("127.0.0.1", 0, pe, pm))]

    got = asyncio.run(run())
    assert got[0] == got[1]
    assert got[1].startswith(b"-ERR server overloaded")


# ---- the native wire servers with a front tier --------------------------- #

needs_native = pytest.mark.skipif(
    not wire_available(), reason="no C++ toolchain for the wire server")


def _resp(key, burst, count, period, q=1):
    parts = [b"THROTTLE", key] + [b"%d" % v for v in (burst, count, period,
                                                      q)]
    return b"*%d\r\n" % len(parts) + b"".join(
        b"$%d\r\n%s\r\n" % (len(p), p) for p in parts)


def _serve_native(transport, payload, http=False):
    """Send `payload` on one connection, read until the server closes."""
    out = []

    def client():
        with socket.create_connection(("127.0.0.1", transport.bound_port),
                                      30) as s:
            s.sendall(payload)
            data = b""
            while chunk := s.recv(1 << 16):
                data += chunk
            out.append(data)

    async def main():
        await transport.start()
        try:
            th = threading.Thread(target=client)
            th.start()
            await asyncio.get_running_loop().run_in_executor(
                None, th.join, 60)
        finally:
            await transport.stop()

    asyncio.run(main())
    return out[0]


def _native_pair(front_of, keymap, cls_names=("NativeRedisTransport",),
                 **kw):
    """(JAX transport, port transport, JAX front, port front, metrics)."""
    from throttlecrab_tpu.server import native_http as jax_nh
    from throttlecrab_tpu.server import native_redis as jax_nr
    from throttlecrab_tpu_torch.server import native_http as port_nh
    from throttlecrab_tpu_torch.server import native_redis as port_nr

    name = cls_names[0]
    jmod = jax_nr if name == "NativeRedisTransport" else jax_nh
    pmod = port_nr if name == "NativeRedisTransport" else port_nh
    jl = TpuRateLimiter(capacity=4096, keymap=keymap)
    pl = TorchRateLimiter(capacity=4096, keymap=keymap, device="cpu")
    jm, pm = JaxMetrics(max_denied_keys=10), Metrics(max_denied_keys=10)
    jf, pf = front_of(jax_front, jm, jl), front_of(port_front, pm, pl)
    return (
        getattr(jmod, name)("127.0.0.1", 0, jl, jm, now_fn=lambda: T0,
                            front=jf, **kw),
        getattr(pmod, name)("127.0.0.1", 0, pl, pm, now_fn=lambda: T0,
                            front=pf, **kw),
        jf, pf, jm, pm,
    )


@needs_native
@pytest.mark.parametrize("keymap", ["native", "python"])
def test_native_resp_with_front_matches_jax_bytes(keymap):
    """One pipelined connection of hot-key abuse (3,000 THROTTLEs over
    40 keys, a few probes and bad params) into each package's native RESP
    driver over a deny cache and default admission: the reply bytes are
    identical, the cache served hits, and the port launched fewer
    windows than it decided."""
    rng = np.random.default_rng(7)
    kid = np.minimum(rng.zipf(1.3, 3000), 40) - 1
    cmds = []
    for k in kid.tolist():
        q = 0 if rng.random() < 0.01 else 1
        burst = 0 if rng.random() < 0.01 else 2 + k % 3
        cmds.append(_resp(b"nk:%d" % k, burst, 1 + k % 5, 60, q))
    payload = b"".join(cmds) + b"*1\r\n$4\r\nQUIT\r\n"

    def front_of(pkg, metrics, lim):
        return pkg.FrontTier(pkg.DenyCache(65536),
                             pkg.AdmissionController(max_pending=100_000),
                             metrics=metrics,
                             bytes_keys=bool(getattr(lim.keymap,
                                                     "BYTES_KEYS", False)))

    from throttlecrab_tpu_torch.server import native_redis as port_nr

    jt, pt, jf, pf, jm, pm = _native_pair(front_of, keymap, batch_size=64,
                                          max_scan_depth=4)
    jax_bytes = _serve_native(jt, payload)
    wire, exact = port_nr.WIRE_WINDOWS, port_nr.EXACT_WINDOWS
    port_bytes = _serve_native(pt, payload)
    windows = (port_nr.WIRE_WINDOWS - wire) + (port_nr.EXACT_WINDOWS - exact)
    assert port_bytes == jax_bytes
    assert port_bytes.count(b"*5\r\n") + port_bytes.count(b"-ERR") == 3000
    # Every request is counted, cache-served windows included (the
    # launch counts depend on how the stream fell into windows).
    counts = [(m.requests_total, dict(m.requests_by_transport),
               m.requests_allowed, m.requests_denied, m.requests_errors,
               m.top_denied.top()) for m in (jm, pm)]
    assert counts[0] == counts[1] and counts[1][0] == 3000
    assert pf.deny_cache.hits > 100
    assert pm.front_deny_hits == pf.deny_cache.hits
    assert pm.device_launches < pm.requests_total
    assert windows <= pm.device_launches + 1
    assert pf.deny_cache._inflight == {} and jf.deny_cache._inflight == {}


@needs_native
@pytest.mark.parametrize("cls", ["NativeRedisTransport",
                                 "NativeHttpTransport"])
def test_native_shed_reply_as_in_jax(cls):
    def front_of(pkg, metrics, lim):
        return pkg.FrontTier(None, _AlwaysShed.of(pkg), metrics=metrics)

    jt, pt, _, _, jm, pm = _native_pair(front_of, "native", (cls,),
                                        batch_size=64)
    if cls == "NativeRedisTransport":
        payload = _resp(b"s", 3, 10, 60) + b"*1\r\n$4\r\nQUIT\r\n"
    else:
        body = (b'{"key": "s", "max_burst": 3, '
                b'"count_per_period": 10, "period": 60}')
        payload = (b"POST /throttle HTTP/1.1\r\nHost: x\r\nContent-Length: "
                   + str(len(body)).encode()
                   + b"\r\nConnection: close\r\n\r\n" + body)
    got = [_serve_native(jt, payload), _serve_native(pt, payload)]
    assert got[0] == got[1]
    assert b"overloaded" in got[1]
    if cls == "NativeHttpTransport":
        assert b"503 Service Unavailable" in got[1].split(b"\r\n", 1)[0]
    assert jm.front_shed_consume == pm.front_shed_consume == 1


# ---- factory, config and metrics ----------------------------------------- #

@pytest.mark.parametrize("overrides", [
    {}, {"front_deny_cache": 0}, {"front_max_pending": 0},
    {"front_deny_cache": 0, "front_max_pending": 0},
    {"front_max_pending": 0, "front_max_wait_us": 50},
    {"front_peek_frac": 0.5, "front_deny_cache": 7},
], ids=["default", "no-cache", "no-admission", "off", "wait-only",
        "custom"])
def test_create_front_tier_as_in_jax(overrides):
    def shape(front):
        if front is None:
            return None
        d, a = front.deny_cache, front.admission
        return (None if d is None else d.capacity,
                None if a is None else (a.max_pending, a.max_wait_us,
                                        a.peek_frac),
                front.bytes_keys)

    for keymap in ("python", "native"):
        got = [
            shape(jax_create(JaxConfig(**overrides), None,
                             TpuRateLimiter(capacity=64, keymap=keymap))),
            shape(create_front_tier(Config(**overrides), None,
                                    TorchRateLimiter(capacity=64,
                                                     keymap=keymap,
                                                     device="cpu"))),
        ]
        assert got[0] == got[1], keymap


def test_front_metrics_exported_as_in_jax():
    lines = []
    for pkg, m in ((jax_front, JaxMetrics()), (port_front, Metrics())):
        front = pkg.FrontTier(pkg.DenyCache(8), None, metrics=m)
        m.set_front_stats_provider(front.stats)
        _prime(front.deny_cache)
        m.record_front_hit()
        m.record_front_hits(4)
        m.record_front_shed(peek=True)
        m.record_front_shed(peek=False)
        m.record_front_stale(3)
        lines.append([ln for ln in m.export_prometheus().splitlines()
                      if "front" in ln])
    assert lines[0] == lines[1]
    assert "throttlecrab_tpu_front_deny_hits 5" in lines[1]
    assert "throttlecrab_tpu_front_deny_cache_size 1" in lines[1]



@needs_native
def test_native_cache_served_window_is_counted_as_in_jax():
    """Requests sent one at a time (a window each): the repeat denial is
    served from the cache in a window with no launch, answered with the
    same bytes and counted in the same request metrics as in JAX."""
    def front_of(pkg, metrics, lim):
        return pkg.FrontTier(pkg.DenyCache(1024), None, metrics=metrics,
                             bytes_keys=True)

    async def four(transport):
        await transport.start()
        try:
            reader, writer = await asyncio.open_connection(
                "127.0.0.1", transport.bound_port)
            replies = []
            for _ in range(4):  # allow, allow, deny, deny (cached)
                writer.write(_resp(b"nk", 2, 10, 60))
                await writer.drain()
                replies.append(b"".join([
                    await asyncio.wait_for(reader.readline(), 5)
                    for _ in range(6)]))
            writer.close()
            return replies
        finally:
            await transport.stop()

    jt, pt, _, _, jm, pm = _native_pair(front_of, "native", batch_size=64)
    got = [(asyncio.run(four(t)), m.requests_total, m.requests_denied,
            m.front_deny_hits, m.device_launches)
           for t, m in ((jt, jm), (pt, pm))]
    assert got[0] == got[1]
    assert got[1][1:4] == (4, 2, 1) and got[1][4] == 3
