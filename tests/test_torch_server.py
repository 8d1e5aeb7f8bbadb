"""The port's BatchingEngine + HTTP transport against the JAX server's.

Both servers run over a limiter on the CPU (the port's on device="cpu",
the plain version), with the same injected clock, and get the same
`POST /throttle` bodies — valid requests, duplicate keys in one window,
quantity-0 probes, invalid params, negative quantities, malformed JSON,
client deadlines that lapse in the queue, requests after shutdown.  The
HTTP status and the JSON body must be byte-identical.  `/health` and
`/metrics` answer 200 over a real socket.
"""

import asyncio
import json

import numpy as np

from throttlecrab_tpu.server.engine import BatchingEngine as JaxEngine
from throttlecrab_tpu.server.http import HttpTransport as JaxHttp
from throttlecrab_tpu.server.metrics import Metrics as JaxMetrics
from throttlecrab_tpu.tpu.limiter import TpuRateLimiter
from throttlecrab_tpu_torch.server.engine import BatchingEngine
from throttlecrab_tpu_torch.server.http import HttpTransport
from throttlecrab_tpu_torch.server.metrics import Metrics
from throttlecrab_tpu_torch.tpu.limiter import TorchRateLimiter

NS = 1_000_000_000
T0 = 1_753_700_000 * NS


class VirtualClock:
    def __init__(self, start_ns=T0):
        self.now = start_ns

    def __call__(self):
        return self.now


def _servers(clock, **kw):
    jax_metrics, port_metrics = JaxMetrics(), Metrics()
    jax_engine = JaxEngine(
        TpuRateLimiter(capacity=1024), now_fn=clock, metrics=jax_metrics,
        **kw,
    )
    port_engine = BatchingEngine(
        TorchRateLimiter(capacity=1024, device="cpu"), now_fn=clock,
        metrics=port_metrics, **kw,
    )
    return (
        JaxHttp("127.0.0.1", 0, jax_engine, jax_metrics),
        HttpTransport("127.0.0.1", 0, port_engine, port_metrics),
    )


def _bodies(rng, n):
    out = []
    for _ in range(n):
        k = int(rng.integers(0, 12))
        req = {
            "key": f"user:{k}",
            "max_burst": int(1 + k % 4),
            "count_per_period": int(1 + k % 3),
            "period": int(1 + 2 * k),
        }
        r = rng.random()
        if r < 0.1:
            req["quantity"] = 0
        elif r < 0.15:
            req["quantity"] = -1
        elif r < 0.2:
            req["max_burst"] = 0
        elif r < 0.25:
            req["quantity"] = 3
        out.append(json.dumps(req).encode())
    out.append(b"{not json")
    out.append(json.dumps({"key": "x", "max_burst": 1}).encode())
    return out


async def _route_both(servers, body, headers=None):
    return await asyncio.gather(
        *[s._route("POST", "/throttle", body, headers or {}) for s in servers]
    )


def test_throttle_bodies_byte_identical():
    async def main():
        clock = VirtualClock()
        servers = _servers(clock, batch_size=8, max_linger_us=500)
        rng = np.random.default_rng(0)
        for step in range(5):
            bodies = _bodies(rng, 20)
            # One concurrent wave per server: the engines coalesce it into
            # windows (duplicate keys in one window, several sub-batches).
            results = [
                await asyncio.gather(
                    *[s._route("POST", "/throttle", b, {}) for b in bodies]
                )
                for s in servers
            ]
            for b, got_j, got_t in zip(bodies, *results):
                assert got_j == got_t, (step, b, got_j, got_t)
            clock.now += int(rng.integers(0, 3 * NS))

    asyncio.run(main())


def test_deadline_and_shutdown_answers_byte_identical():
    async def main():
        clock = VirtualClock()
        servers = _servers(clock, batch_size=64, max_linger_us=2000)
        body = json.dumps(
            {"key": "d", "max_burst": 2, "count_per_period": 1, "period": 9}
        ).encode()
        hdr = {"x-throttlecrab-deadline-ms": "1"}
        tasks = [
            asyncio.create_task(s._route("POST", "/throttle", body, hdr))
            for s in servers
        ]
        await asyncio.sleep(0)
        clock.now += 2_000_000  # the deadline lapses while queued
        got = await asyncio.gather(*tasks)
        assert got[0] == got[1] and got[0][0] == 504
        got = await _route_both(servers, body, {"x-throttlecrab-deadline-ms": "50"})
        assert got[0] == got[1] and got[0][0] == 200
        for s in servers:
            s.engine.begin_drain()
        got = await _route_both(servers, body)
        assert got[0] == got[1] and got[0][0] == 503
        health = [await s._route("GET", "/health", b"") for s in servers]
        assert health[0] == health[1] == (200, b"draining", "text/plain")
        for s in servers:
            await s.engine.shutdown()
        got = await _route_both(servers, body)
        assert got[0] == got[1] and got[0][0] == 500
        health = [await s._route("GET", "/health", b"") for s in servers]
        assert health[0] == health[1] == (200, b"shutdown", "text/plain")

    asyncio.run(main())


async def _http(port, method, path, body=b""):
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    writer.write(
        f"{method} {path} HTTP/1.1\r\nHost: x\r\nContent-Length: "
        f"{len(body)}\r\nConnection: close\r\n\r\n".encode() + body
    )
    await writer.drain()
    raw = await reader.read()
    writer.close()
    head, _, payload = raw.partition(b"\r\n\r\n")
    return int(head.split(b" ")[1]), payload


def test_real_socket_health_metrics_throttle():
    async def main():
        clock = VirtualClock()
        _, server = _servers(clock, batch_size=16, max_linger_us=200)
        await server.start()
        port = server.bound_port
        try:
            body = json.dumps(
                {"key": "u:1", "max_burst": 3, "count_per_period": 1,
                 "period": 3600}
            ).encode()
            answers = [await _http(port, "POST", "/throttle", body)
                       for _ in range(5)]
            assert [json.loads(p)["allowed"] for _, p in answers] == [
                True, True, True, False, False
            ]
            assert [json.loads(p)["remaining"] for _, p in answers[:3]] == [
                2, 1, 0
            ]
            assert await _http(port, "GET", "/health") == (200, b"OK")
            status, text = await _http(port, "GET", "/metrics")
            assert status == 200
            assert b"throttlecrab_requests_total 5" in text
            assert b"throttlecrab_requests_allowed 3" in text
            assert b"throttlecrab_tpu_device_launches 5" in text
            assert (await _http(port, "GET", "/nope"))[0] == 404
        finally:
            await server.engine.shutdown()
            await server.stop()

    asyncio.run(main())
