"""The port's asyncio RESP transport against the JAX package's.

Both transports run over a BatchingEngine on a CPU limiter (the port's on
device="cpu", the plain version), with the same injected clock, and get
the same RESP byte streams over real sockets: valid commands, pipelined
and partial frames, protocol and argument errors, QUIT, quantity 0 and
negative quantities, invalid parameters, deadline tokens, the 64 KB
buffer cap.  Every stream ends with QUIT or an error that closes the
connection, or with the client's half-close, so each side's reply is
everything read until the server closes; the two must be byte-identical.
Deadlines that lapse in the queue, draining and shutdown are driven
through `_process_command` with the clock moved in between, as
tests/test_torch_server.py does for HTTP.
"""

import asyncio

import pytest

from throttlecrab_tpu.server.engine import BatchingEngine as JaxEngine
from throttlecrab_tpu.server.metrics import Metrics as JaxMetrics
from throttlecrab_tpu.server.redis import RedisTransport as JaxRedis
from throttlecrab_tpu.server.resp import Array as JaxArray
from throttlecrab_tpu.server.resp import BulkString as JaxBulk
from throttlecrab_tpu.server.resp import serialize as jax_serialize
from throttlecrab_tpu.tpu.limiter import TpuRateLimiter
from throttlecrab_tpu_torch.server.engine import BatchingEngine
from throttlecrab_tpu_torch.server.metrics import Metrics
from throttlecrab_tpu_torch.server.redis import RedisTransport
from throttlecrab_tpu_torch.server.resp import Array, BulkString, serialize
from throttlecrab_tpu_torch.tpu.limiter import TorchRateLimiter

NS = 1_000_000_000
T0 = 1_753_700_000 * NS


class VirtualClock:
    def __init__(self, start_ns=T0):
        self.now = start_ns

    def __call__(self):
        return self.now


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
THR = ("THROTTLE", "pk", "10", "100", "60")

# name -> list of chunks written with a pause between them.
STREAMS = {
    "valid": [
        frame("PING") + frame("ping", "hey")
        + b"".join(frame("THROTTLE", "v", "3", "10", "60") for _ in range(4))
        + frame("throttle", "v2", "5", "1", "3600", "2") + QUIT
    ],
    "pipelined": [frame(*THR) * 20 + frame("PING") + QUIT],
    "partial": [
        (frame("THROTTLE", "part", "4", "2", "10") * 3 + QUIT)[i:i + 7]
        for i in range(0, len(frame("THROTTLE", "part", "4", "2", "10") * 3
                             + QUIT), 7)
    ],
    "errors": [
        frame("BOGUS") + frame("THROTTLE", "k")
        + frame("THROTTLE", "k", "x", "10", "60")
        + frame("THROTTLE", "k", "10", "1.5", "60")
        + frame("THROTTLE", "k", "10", "10", "")
        + frame("THROTTLE", "k", "10", "10", "60", "q")
        + frame("THROTTLE", "k", "10", "10", "60", "1", "soon")
        + frame("THROTTLE", "k", "10", "10", "60", "1", "5", "extra")
        + frame("THROTTLE", "k", "٣", "10", "60")
        + frame("THROTTLE", "k", "9223372036854775808", "10", "60")
        + frame("THROTTLE", "k", "+7", "10", "60")
        + frame("THROTTLE", None, "10", "100", "60")
        + frame(None, "x") + frame("PING", None) + frame("PING", "a", "b")
        + b"*0\r\n" + b"+OK\r\n" + b":5\r\n"
        + b"*5\r\n$8\r\nTHROTTLE\r\n$2\r\nik\r\n:4\r\n:10\r\n:60\r\n"
        + QUIT
    ],
    "quantities_and_params": [
        frame("THROTTLE", "q", "5", "10", "60", "0")
        + frame("THROTTLE", "q", "5", "10", "60", "-1")
        + frame("THROTTLE", "q", "5", "10", "60", "3")
        + frame("THROTTLE", "q", "5", "10", "60", "0")
        + frame("THROTTLE", "q", "5", "10", "60", "9")
        + frame("THROTTLE", "bad", "0", "10", "60")
        + frame("THROTTLE", "bad", "5", "-10", "60")
        + frame("THROTTLE", "bad", "5", "10", "0")
        + frame("THROTTLE", "big", "1", "1", "9223372036854775807")
        + QUIT
    ],
    "deadline_tokens": [
        frame("THROTTLE", "d", "5", "10", "60", "1", "0")
        + frame("THROTTLE", "d", "5", "10", "60", "1", "50")
        + frame("THROTTLE", "d", "5", "10", "60", "1", "-5")
        + frame("THROTTLE", "d", "5", "10", "60", "2", "100000")
        + QUIT
    ],
    "bad_marker_closes": [frame(*THR) + b"!inline\r\n" + frame("PING")],
    "invalid_utf8_closes": [b"*2\r\n$4\r\nPING\r\n$2\r\n\xff\xfe\r\n"],
    "deep_nesting_closes": [b"*1\r\n" * 200 + b":1\r\n"],
    "buffer_cap_closes": [frame(*THR), b"$70000\r\n" + b"x" * 66000],
    "no_quit_then_eof": [frame(*THR) + frame("PING")],
}


def _transports(clock, **kw):
    # The servers' default leaderboard size.
    jax_metrics = JaxMetrics(max_denied_keys=100)
    port_metrics = Metrics(max_denied_keys=100)
    jax_engine = JaxEngine(TpuRateLimiter(capacity=256), now_fn=clock,
                           metrics=jax_metrics, **kw)
    port_engine = BatchingEngine(
        TorchRateLimiter(capacity=256, device="cpu"), now_fn=clock,
        metrics=port_metrics, **kw,
    )
    return (JaxRedis("127.0.0.1", 0, jax_engine, jax_metrics),
            RedisTransport("127.0.0.1", 0, port_engine, port_metrics))


async def _exchange(port, chunks):
    """Write the chunks (pausing between them), half-close, then read
    until the server closes."""
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    for chunk in chunks:
        writer.write(chunk)
        await writer.drain()
        await asyncio.sleep(0.01)
    writer.write_eof()
    data = await asyncio.wait_for(reader.read(), timeout=30)
    writer.close()
    return data


def _counts(metrics):
    return (metrics.requests_total, metrics.requests_allowed,
            metrics.requests_denied, metrics.requests_errors,
            dict(metrics.requests_by_transport), metrics.top_denied.top())


@pytest.mark.parametrize("name", sorted(STREAMS))
def test_stream_replies_byte_identical(name):
    async def main():
        clock = VirtualClock()
        servers = _transports(clock, batch_size=64, max_linger_us=300)
        for s in servers:
            await s.start()
        try:
            got = [await _exchange(s.bound_port, STREAMS[name])
                   for s in servers]
        finally:
            for s in servers:
                await s.engine.shutdown()
                await s.stop()
        return got, [_counts(s.metrics) for s in servers]

    (want, got), (want_counts, got_counts) = asyncio.run(main())
    assert got == want, (name, want, got)
    assert got, name
    assert got_counts == want_counts


def test_streams_in_sequence_share_state_identically():
    """Every stream on one server pair, one after another (later streams
    see the buckets earlier ones left), with the clock moving between."""
    async def main():
        clock = VirtualClock()
        servers = _transports(clock, batch_size=8, max_linger_us=300)
        for s in servers:
            await s.start()
        out = []
        try:
            for name in sorted(STREAMS):
                out.append([await _exchange(s.bound_port, STREAMS[name])
                            for s in servers])
                clock.now += NS // 3
        finally:
            for s in servers:
                await s.engine.shutdown()
                await s.stop()
        return out, [_counts(s.metrics) for s in servers]

    out, (want_counts, got_counts) = asyncio.run(main())
    for want, got in out:
        assert got == want
    assert got_counts == want_counts


_MODS = ((JaxArray, JaxBulk, jax_serialize), (Array, BulkString, serialize))


async def _both(servers, *parts, between=None):
    """One command through both transports' `_process_command`; each
    answer as (serialized reply, close flag).  `between` runs after the
    commands are queued and before they are awaited."""
    tasks = [
        asyncio.create_task(s._process_command(array(tuple(
            bulk(p) for p in parts))))
        for s, (array, bulk, _) in zip(servers, _MODS)
    ]
    await asyncio.sleep(0)
    if between is not None:
        between()
    res = await asyncio.gather(*tasks)
    return [(ser(r), q) for (r, q), (_, _, ser) in zip(res, _MODS)]


def test_deadline_drain_and_shutdown_answers_identical():
    async def main():
        clock = VirtualClock()
        servers = _transports(clock, batch_size=64, max_linger_us=2000)
        args = ("THROTTLE", "dl", "2", "1", "9", "1")

        def lapse():
            clock.now += 2_000_000  # the 1 ms deadline lapses in the queue

        got = await _both(servers, *args, "1", between=lapse)
        assert got[0] == got[1] == (b"-ERR deadline exceeded\r\n", False)
        got = await _both(servers, *args, "50")
        assert got[0] == got[1] and got[0][0].startswith(b"*5\r\n:1\r\n")
        for s in servers:
            s.engine.begin_drain()
        got = await _both(servers, *args)
        assert got[0] == got[1] and got[0][0].startswith(b"-ERR")
        for s in servers:
            await s.engine.shutdown()
        got = await _both(servers, *args)
        assert got[0] == got[1] and got[0][0].startswith(b"-ERR")
        got = await _both(servers, "quit")
        assert got[0] == got[1] == (b"+OK\r\n", True)
        return [_counts(s.metrics) for s in servers]

    want, got = asyncio.run(main())
    assert got == want
