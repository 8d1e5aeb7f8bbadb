"""The port's native transports against the JAX package's, over real
sockets.

Both sides run the unmodified C++ wire server (`native/wire_server.cpp`,
built by each package's own loader) under their own driver thread: the
JAX `NativeRedisTransport` / `NativeHttpTransport` over a `TpuRateLimiter`,
the port's over `TorchRateLimiter(keymap="native", device="cpu")`, both
with the same fixed clock.  Each client script runs against one side and
then the other, on fresh limiters; the bytes each side answers must be
identical.  Covered: PING/THROTTLE/QUIT, argument and protocol errors,
pipelining, inline commands behind a THROTTLE staying in order, QUIT
waiting for pipelined THROTTLEs, half-close, null bulk arguments, a
window that must take the exact path (a full table; a key whose
parameters change inside one batch), concurrent clients sharing limits,
and the HTTP protocol's /throttle, /health and /metrics.  The port's
route counters (`WIRE_WINDOWS`, `EXACT_WINDOWS`, `DISPATCH_ERRORS`) must
show which path each window took, and `stop` must wake a parked driver
within a second.  Last, the server's wiring: the flags pick each
transport's backend, `--redis` counts as a transport, and a transport
that dies ends the server with a TransportFailure that names it.
"""

import asyncio
import json
import socket
import time

import pytest

from throttlecrab_tpu.server.metrics import Metrics as JaxMetrics
from throttlecrab_tpu.tpu.limiter import TpuRateLimiter
from throttlecrab_tpu_torch import native
from throttlecrab_tpu_torch.server import native_redis
from throttlecrab_tpu_torch.server.metrics import Metrics
from throttlecrab_tpu_torch.tpu.limiter import TorchRateLimiter

# A broken build with a compiler present is a bug, not an environment gap:
# fail the whole module loudly instead of skipping.
if not native.wire_available() and native.toolchain_available():
    pytest.fail(
        "C++ wire server failed to build with g++ present:\n"
        f"{native.wire_build_error()}",
        pytrace=False,
    )
pytestmark = pytest.mark.skipif(
    not native.wire_available(),
    reason=f"no C++ toolchain for the wire server: "
    f"{native.wire_build_error()}",
)

T0 = 1_753_700_000 * 1_000_000_000


def _transport(side, protocol, capacity=1024, **kw):
    """A native transport of `side` ("jax" or "port") for `protocol`
    ("redis" or "http") on a fresh limiter, at batch 64 by default."""
    kw = dict(dict(batch_size=64, max_linger_us=500), **kw)
    if side == "jax":
        from throttlecrab_tpu.server.native_http import NativeHttpTransport
        from throttlecrab_tpu.server.native_redis import NativeRedisTransport

        limiter = TpuRateLimiter(capacity=capacity)
        metrics = JaxMetrics(max_denied_keys=100)
    else:
        from throttlecrab_tpu_torch.server.native_http import (
            NativeHttpTransport,
        )
        from throttlecrab_tpu_torch.server.native_redis import (
            NativeRedisTransport,
        )

        limiter = TorchRateLimiter(capacity=capacity, keymap="native",
                                   device="cpu")
        metrics = Metrics(max_denied_keys=100)
    cls = NativeHttpTransport if protocol == "http" else NativeRedisTransport
    return cls("127.0.0.1", 0, limiter, metrics, now_fn=lambda: T0, **kw)


def _on_both(client, protocol="redis", **kw):
    """Run `client(transport)` against the JAX side, then the port side;
    returns (jax result, port result, the port's route-counter deltas)."""
    async def one(side):
        t = _transport(side, protocol, **kw)
        await t.start()
        try:
            return await client(t)
        finally:
            await t.stop()

    want = asyncio.run(one("jax"))
    before = _routes()
    got = asyncio.run(one("port"))
    after = _routes()
    return want, got, tuple(a - b for a, b in zip(after, before))


def _routes():
    return (native_redis.WIRE_WINDOWS, native_redis.EXACT_WINDOWS,
            native_redis.DISPATCH_ERRORS)


def frame(*parts):
    """A RESP array; None parts encode as null bulk strings ($-1)."""
    out = b"*%d\r\n" % len(parts)
    for part in parts:
        if part is None:
            out += b"$-1\r\n"
        else:
            data = part.encode() if isinstance(part, str) else part
            out += b"$%d\r\n%s\r\n" % (len(data), data)
    return out


QUIT = frame("QUIT")


async def _send_until_closed(port, data):
    """Write `data` in one go, then read until the server closes."""
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    writer.write(data)
    await writer.drain()
    out = await asyncio.wait_for(reader.read(), timeout=10)
    writer.close()
    return out


def _stream_client(data):
    async def client(t):
        return await _send_until_closed(t.bound_port, data)
    return client


# name -> (bytes written in one go, the route the port's windows take:
# "wire" = every window through dispatch_wire_window, "exact" = at least
# one window on the exact path, None = no THROTTLE reaches a window).
STREAMS = {
    "ping_throttle_quit": (
        frame("PING") + frame("PING", "hey")
        + frame("throttle", "nk", "3", "10", "60")
        + b"".join(frame("THROTTLE", "nk", "3", "10", "60") for _ in range(3))
        + QUIT, "wire",
    ),
    # qk's quantity changes inside the batch: a conflict for the native
    # prep, so the exact path decides the window.
    "errors_and_params": (
        frame("BOGUS") + frame("THROTTLE", "k")
        + frame("THROTTLE", "k", "x", "10", "60")
        + frame("THROTTLE", "k", "-5", "10", "60")
        + frame("THROTTLE", "k", "10", "10", "60", "-1")
        + frame("THROTTLE", "qk", "10", "100", "60", "5")
        + frame("THROTTLE", "qk", "10", "100", "60", "0")
        + frame("THROTTLE", "qk", "10", "100", "60", "1", "100000")
        + frame("THROTTLE", "k", "٣", "10", "60")
        + QUIT, "exact",
    ),
    "pipelined": (
        frame("THROTTLE", "pk", "10", "100", "60") * 20 + frame("PING")
        + QUIT, "wire",
    ),
    "inline_after_throttle_in_order": (
        frame("THROTTLE", "ok1", "10", "100", "60") + frame("PING")
        + frame("THROTTLE", "ok1", "10", "100", "60") + frame("PING", "x")
        + QUIT, "wire",
    ),
    "quit_waits_for_pipelined": (
        frame("THROTTLE", "qk1", "10", "100", "60")
        + frame("THROTTLE", "qk2", "10", "100", "60") + QUIT
        + frame("THROTTLE", "after", "10", "100", "60"), "wire",
    ),
    "null_bulk_arguments": (
        frame("THROTTLE", None, "10", "100", "60") + frame(None, "x")
        + frame("THROTTLE", "k", None, "100", "60") + frame("PING", None)
        + QUIT, None,
    ),
    "bad_marker": (
        frame("THROTTLE", "a", "2", "1", "60") + b"!inline\r\n", "wire",
    ),
    "huge_array": (b"*999999999999\r\n", None),
    "huge_bulk": (b"*1\r\n$99999999999999\r\n", None),
    # One batch of 40 keys over a table of 16 slots: the native prep
    # reports it full, so the exact path decides it (and grows the table).
    "full_table_exact_path": (
        b"".join(frame("THROTTLE", f"f{i}", "2", "1", "60")
                 for i in range(40)) * 2 + QUIT, "exact",
    ),
    # One key whose parameters change inside one batch.
    "param_change_exact_path": (
        frame("THROTTLE", "c", "3", "1", "60")
        + frame("THROTTLE", "c", "5", "1", "60")
        + frame("THROTTLE", "c", "3", "1", "60") + QUIT, "exact",
    ),
}


@pytest.mark.parametrize("name", sorted(STREAMS))
def test_resp_stream_byte_identical(name):
    data, route = STREAMS[name]
    want, got, (wire, exact, errors) = _on_both(
        _stream_client(data), capacity=16,
    )
    assert got == want, (name, want, got)
    assert got and errors == 0
    if route == "wire":
        assert wire >= 1 and exact == 0, (wire, exact)
    elif route == "exact":
        assert exact >= 1, (wire, exact)
    else:
        assert wire == exact == 0, (wire, exact)


def test_half_close_still_delivers_pipelined_responses():
    """printf | nc style: THROTTLE + THROTTLE + QUIT, then SHUT_WR before
    reading; every reply and the +OK still arrive."""
    def blocking(port):
        s = socket.create_connection(("127.0.0.1", port), 5)
        s.sendall(frame("THROTTLE", "hc1", "10", "100", "60")
                  + frame("THROTTLE", "hc2", "10", "100", "60") + QUIT)
        s.shutdown(socket.SHUT_WR)
        s.settimeout(5)
        data = b""
        while chunk := s.recv(4096):
            data += chunk
        s.close()
        return data

    async def client(t):
        loop = asyncio.get_running_loop()
        return await loop.run_in_executor(None, blocking, t.bound_port)

    want, got, _ = _on_both(client)
    assert got == want
    assert got.count(b"*5\r\n:1\r\n") == 2 and got.endswith(b"+OK\r\n")


def test_concurrent_clients_share_limits():
    """Four connections x 10 THROTTLEs on one key of burst 20: exactly 20
    allowed on each side (which connection wins is the scheduler's)."""
    async def client(t):
        async def one():
            reader, writer = await asyncio.open_connection(
                "127.0.0.1", t.bound_port)
            allowed = 0
            for _ in range(10):
                writer.write(frame("THROTTLE", "shared", "20", "100", "3600"))
                await writer.drain()
                out = await asyncio.wait_for(reader.read(4096), timeout=5)
                allowed += out.startswith(b"*5\r\n:1\r\n")
            writer.close()
            return allowed

        counts = await asyncio.gather(*[one() for _ in range(4)])
        return sum(counts), t

    # The metrics are read once the transport has stopped: a driver
    # records a window after it has sent the window's replies.
    want, got, _ = _on_both(client)
    assert [(n, t.metrics.requests_total, t.metrics.requests_denied,
             t.metrics.top_denied.top()) for n, t in (want, got)] == [
        (20, 40, 20, [("shared", 20)])] * 2


def test_stop_wakes_parked_driver_within_a_second():
    async def main():
        t = _transport("port", "redis", max_linger_us=30_000_000)
        await t.start()
        await asyncio.sleep(0.3)  # the driver parks in ws_next_batch
        start = time.monotonic()
        await t.stop()
        return time.monotonic() - start, t._driver

    elapsed, driver = asyncio.run(main())
    assert elapsed < 1.0, f"stop took {elapsed:.2f} s"
    assert not driver.is_alive()


async def _http(port, method, path, body=None, headers=""):
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    payload = body if isinstance(body, bytes) else (
        json.dumps(body).encode() if body is not None else b"")
    writer.write(
        f"{method} {path} HTTP/1.1\r\nHost: x\r\nContent-Length: "
        f"{len(payload)}\r\n{headers}Connection: close\r\n\r\n".encode()
        + payload)
    await writer.drain()
    out = await asyncio.wait_for(reader.read(), timeout=10)
    writer.close()
    return out


def test_http_throttle_error_and_health_answers_byte_identical():
    bodies = (
        [{"key": "nh:1", "max_burst": 3, "count_per_period": 10,
          "period": 60}] * 5
        + [{"key": 'a"b\nc', "max_burst": 2, "count_per_period": 10,
            "period": 3600}] * 3
        + [{"key": "q", "max_burst": 10, "count_per_period": 100,
            "period": 60, "quantity": 0},
           {"key": "q", "max_burst": 10, "count_per_period": 100,
            "period": 60, "quantity": -2},
           {"key": "k", "max_burst": -1, "count_per_period": 10,
            "period": 60},
           b"not json"]
    )

    async def client(t):
        out = [await _http(t.bound_port, "POST", "/throttle", b)
               for b in bodies]
        out.append(await _http(t.bound_port, "GET", "/nope"))
        await asyncio.sleep(0.1)  # the driver pushed its first snapshot
        out.append(await _http(t.bound_port, "GET", "/health"))
        await t.drain()
        out.append(await _http(t.bound_port, "GET", "/health"))
        await asyncio.sleep(1.3)  # the next once-a-second push
        metrics = (await _http(t.bound_port, "GET", "/metrics")).decode()
        counts = sorted(line for line in metrics.splitlines()
                        if line.startswith(("throttlecrab_requests_total",
                                            "throttlecrab_requests_by",
                                            "throttlecrab_top_denied")))
        return out, counts

    (want, want_counts), (got, got_counts), (wire, exact, errors) = (
        _on_both(client, protocol="http"))
    assert got == want
    assert got_counts == want_counts
    assert any(line.startswith('throttlecrab_top_denied_keys{key="a\\"b\\nc"')
               for line in got_counts), got_counts
    assert got[-1].endswith(b"\r\n\r\ndraining")
    assert got[-2].endswith(b"\r\n\r\nOK")
    assert wire >= 1 and exact == errors == 0


@pytest.mark.parametrize("http_backend", ["python", "native"])
@pytest.mark.parametrize("redis_backend", ["python", "native"])
def test_build_transports_picks_each_backend(http_backend, redis_backend):
    """The server's flags pick each transport's backend; the native ones
    drive the engine's limiter under the engine's lock and clock."""
    from throttlecrab_tpu_torch.server.__main__ import build_transports
    from throttlecrab_tpu_torch.server.config import Config
    from throttlecrab_tpu_torch.server.engine import BatchingEngine

    cfg = Config(http=True, redis=True, http_backend=http_backend,
                 redis_backend=redis_backend, device="cpu")
    cfg.validate()
    engine = BatchingEngine(TorchRateLimiter(capacity=64, device="cpu"))
    got = build_transports(cfg, engine, Metrics())
    want = [
        "NativeHttpTransport" if http_backend == "native" else
        "HttpTransport",
        "NativeRedisTransport" if redis_backend == "native" else
        "RedisTransport",
    ]
    assert [type(t).__name__ for t in got] == want
    for t in got:
        if type(t).__name__.startswith("Native"):
            assert t.limiter is engine.limiter
            assert t.limiter_lock is engine.limiter_lock
            assert t.now_fn is engine.now_fn
        else:
            assert t.engine is engine


def test_config_counts_redis_as_a_transport():
    from throttlecrab_tpu_torch.server.config import Config, ConfigError

    Config(redis=True).validate()
    with pytest.raises(ConfigError, match="--http, --grpc, or --redis"):
        Config().validate()
    with pytest.raises(ConfigError, match="redis backend"):
        Config(redis=True, redis_backend="rust").validate()


def test_transport_failure_names_the_transport(monkeypatch):
    """A transport whose serve loop dies ends the server with
    TransportFailure naming it."""
    from throttlecrab_tpu_torch.server import __main__ as entry
    from throttlecrab_tpu_torch.server.config import Config

    class Dying:
        name = "redis"

        async def start(self):
            pass

        async def serve_forever(self):
            raise RuntimeError("native redis driver thread died")

        async def drain(self):
            pass

        async def stop(self):
            pass

    monkeypatch.setattr(entry, "build_transports",
                        lambda config, engine, metrics: [Dying()])
    cfg = Config(redis=True, device="cpu", store_capacity=64)
    with pytest.raises(entry.TransportFailure, match="the redis transport"):
        asyncio.run(entry.run_server(cfg))
