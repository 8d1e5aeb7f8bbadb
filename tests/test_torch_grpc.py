"""The port's gRPC transport (server/grpc.py) against the JAX package's.

Both transports listen on real sockets over their engines (the port's on
a device="cpu" limiter), with one virtual clock, and get the same
`throttlecrab.RateLimiter/Throttle` calls: valid requests, repeats until
denial, quantity-0 probes, invalid parameters, negative quantities,
i32-scale fields, a call whose native gRPC deadline lapses in the queue,
calls while draining and after shutdown.  The serialized response
messages, the status codes and details, and the metrics (counters and
the top-denied leaderboard at the server's default size) must be
identical.  Tolerance: exact equality.
"""

import asyncio

import grpc
import grpc.aio
import numpy as np
import pytest

from throttlecrab_tpu.server.engine import BatchingEngine as JaxEngine
from throttlecrab_tpu.server.grpc import GrpcTransport as JaxGrpc
from throttlecrab_tpu.server.metrics import Metrics as JaxMetrics
from throttlecrab_tpu.tpu.limiter import TpuRateLimiter
from throttlecrab_tpu_torch.server.engine import BatchingEngine
from throttlecrab_tpu_torch.server.grpc import GrpcTransport
from throttlecrab_tpu_torch.server.metrics import Metrics
from throttlecrab_tpu_torch.server.proto import throttlecrab_pb2 as pb
from throttlecrab_tpu_torch.tpu.limiter import TorchRateLimiter

NS = 1_000_000_000
T0 = 1_753_700_000 * NS
I32_MAX = (1 << 31) - 1


class VirtualClock:
    def __init__(self, start_ns=T0):
        self.now = start_ns

    def __call__(self):
        return self.now


def _transports(clock, **kw):
    jm, pm = JaxMetrics(max_denied_keys=100), Metrics(max_denied_keys=100)
    je = JaxEngine(TpuRateLimiter(capacity=1024), now_fn=clock,
                   metrics=jm, **kw)
    pe = BatchingEngine(TorchRateLimiter(capacity=1024, device="cpu"),
                        now_fn=clock, metrics=pm, **kw)
    return JaxGrpc("127.0.0.1", 0, je, jm), GrpcTransport("127.0.0.1", 0,
                                                          pe, pm)


def _requests(rng, n):
    out = []
    for _ in range(n):
        k = int(rng.integers(0, 8))
        req = dict(key=f"g:{k}", max_burst=1 + k % 4,
                   count_per_period=1 + k % 3, period=1 + 7 * k, quantity=1)
        r = rng.random()
        if r < 0.1:
            req["quantity"] = 0
        elif r < 0.15:
            req["quantity"] = -1
        elif r < 0.2:
            req["max_burst"] = 0
        elif r < 0.25:
            req.update(max_burst=I32_MAX, count_per_period=I32_MAX,
                       period=I32_MAX)
        elif r < 0.3:
            req["quantity"] = I32_MAX
        out.append(pb.ThrottleRequest(**req))
    return out


async def _call(method, req, **kw):
    try:
        resp = await method(req, **kw)
        return "OK", resp.SerializeToString()
    except grpc.aio.AioRpcError as e:
        return e.code().name, e.details()


def _metrics(m):
    return (m.requests_total, m.requests_allowed, m.requests_denied,
            m.requests_errors, dict(m.requests_by_transport),
            m.top_denied.top(), m.deadline_shed, m.drain_shed)


class _Clients:
    def __init__(self, transports):
        self.transports = transports
        self.channels = []
        self.methods = []

    async def __aenter__(self):
        for t in self.transports:
            await t.start()
            ch = grpc.aio.insecure_channel(f"127.0.0.1:{t.bound_port}")
            self.channels.append(ch)
            self.methods.append(ch.unary_unary(
                "/throttlecrab.RateLimiter/Throttle",
                request_serializer=pb.ThrottleRequest.SerializeToString,
                response_deserializer=pb.ThrottleResponse.FromString,
            ))
        return self

    async def __aexit__(self, *exc):
        for ch in self.channels:
            await ch.close()
        for t in self.transports:
            await t.engine.shutdown()
            await t.stop()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_throttle_responses_byte_identical(seed):
    async def main():
        clock = VirtualClock()
        transports = _transports(clock, batch_size=8, max_linger_us=500)
        rng = np.random.default_rng(seed)
        async with _Clients(transports) as c:
            for step in range(4):
                reqs = _requests(rng, 16)
                # One call at a time: concurrent calls over HTTP/2 reach
                # each server in an order of their own.
                got = [[await _call(m, r) for r in reqs] for m in c.methods]
                for r, a, b in zip(reqs, *got):
                    assert a == b, (step, r, a, b)
                clock.now += int(rng.integers(0, 3 * NS))
        assert _metrics(transports[0].metrics) == _metrics(
            transports[1].metrics
        )
        assert transports[1].metrics.top_denied.top()

    asyncio.run(main())


def test_deadline_drain_and_shutdown_statuses_identical():
    """A call with a 30 s gRPC deadline parks in the queue (batch 2, huge
    linger); the virtual clock then jumps 60 s and a second call fills
    the batch: the first is shed DEADLINE_EXCEEDED, the second decided.
    Then RESOURCE_EXHAUSTED while draining, INTERNAL after shutdown."""

    async def main():
        clock = VirtualClock()
        transports = _transports(clock, batch_size=2,
                                 max_linger_us=10_000_000)
        req = pb.ThrottleRequest(key="gd", max_burst=3, count_per_period=10,
                                 period=60, quantity=1)
        req2 = pb.ThrottleRequest(key="gd2", max_burst=3,
                                  count_per_period=10, period=60, quantity=1)
        out = []
        async with _Clients(transports) as c:
            for m, t in zip(c.methods, transports):
                start = clock.now
                first = asyncio.ensure_future(_call(m, req, timeout=30.0))
                while not t.engine._pending:
                    await asyncio.sleep(0.01)
                clock.now += 60 * NS
                second = await _call(m, req2)
                out.append((await first, second))
                clock.now = start
            out = [tuple(out)]
            for t in transports:
                t.engine.begin_drain()
            out.append(tuple([await _call(m, req) for m in c.methods]))
            for t in transports:
                await t.engine.shutdown()
            out.append(tuple([await _call(m, req) for m in c.methods]))
        return out

    (dl_j, dl_p), drain, shut = asyncio.run(main())
    assert dl_j == dl_p
    assert dl_j[0][0] == "DEADLINE_EXCEEDED" and dl_j[1][0] == "OK"
    assert drain[0] == drain[1] and drain[0][0] == "RESOURCE_EXHAUSTED"
    assert shut[0] == shut[1] and shut[0][0] == "INTERNAL"


def test_server_boots_grpc_only():
    """`--grpc` alone passes validation and builds the gRPC transport."""
    from throttlecrab_tpu_torch.server.__main__ import build_transports
    from throttlecrab_tpu_torch.server.config import Config

    cfg = Config.from_env_and_args(["--grpc", "--grpc-port", "0",
                                    "--device", "cpu"])
    engine = BatchingEngine(TorchRateLimiter(capacity=64, device="cpu"))
    (t,) = build_transports(cfg, engine, Metrics())
    assert isinstance(t, GrpcTransport) and (t.host, t.port) == ("0.0.0.0", 0)
