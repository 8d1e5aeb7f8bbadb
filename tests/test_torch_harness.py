"""The port's load harness against the JAX package's.

The workload generators (`make_keys` for every key pattern,
`crash_restart_ledger`, `flash_crowd_hot_sets`, the pacing shapes) give
the same keys and delays for one seed; the trace a recorded run writes
is byte-identical and round-trips through the port's `replay/trace`; the
CLI parses as JAX's; and a `perf-test` run of each harness against a
port server in this process, over HTTP, RESP and gRPC, reports the same
counts.
"""

import asyncio
import json

import numpy as np
import pytest

from throttlecrab_tpu.harness import loadgen as jax_loadgen
from throttlecrab_tpu.harness import workload as jax_workload
from throttlecrab_tpu_torch.harness import loadgen
from throttlecrab_tpu_torch.harness import workload
from throttlecrab_tpu_torch.replay.trace import Trace
from throttlecrab_tpu_torch.server.engine import BatchingEngine
from throttlecrab_tpu_torch.server.grpc import GrpcTransport
from throttlecrab_tpu_torch.server.http import HttpTransport
from throttlecrab_tpu_torch.server.metrics import Metrics
from throttlecrab_tpu_torch.server.redis import RedisTransport
from throttlecrab_tpu_torch.tpu.limiter import TorchRateLimiter

T0 = 1_700_000_000 * 1_000_000_000
PATTERNS = ["sequential", "random", "zipfian", "user-resource",
            "hotkey-abuse", "flash-crowd", "chaos", "noisy-neighbor",
            "diurnal", "slow-drift", "rolling-restart", "crash-restart"]


@pytest.mark.parametrize("pattern", PATTERNS)
def test_make_keys_equals_jax(pattern):
    for seed, n, space in ((0, 500, 1000), (7, 333, 50), (123, 2000, 10)):
        assert workload.make_keys(pattern, n, space, seed=seed) == (
            jax_workload.make_keys(pattern, n, space, seed=seed))


@pytest.mark.parametrize("space", [1, 199, 1000, 10_000, 123_457])
def test_ledger_and_hot_sets_equal_jax(space):
    assert workload.crash_restart_ledger(space) == (
        jax_workload.crash_restart_ledger(space))
    assert workload.flash_crowd_hot_sets(space) == (
        jax_workload.flash_crowd_hot_sets(space))


@pytest.mark.parametrize("shape", ["steady", "burst", "ramp", "wave"])
def test_workload_delays_equal_jax(shape):
    for rps in (0.0, 50.0, 1000.0):
        a = workload.Workload(shape, rps, 1500)
        b = jax_workload.Workload(shape, rps, 1500)
        assert list(a.delays()) == list(b.delays())


def test_perf_result_summary_equals_jax():
    args = ("http", 10, 1.0, 5, 5, 0)
    kw = dict(seed=42, key_pattern="flash-crowd",
              latencies_s=[0.001 * i for i in range(1, 50)])
    a, b = loadgen.PerfResult(*args, **kw), jax_loadgen.PerfResult(*args,
                                                                   **kw)
    for i, k in enumerate(["key:1", "t:2", "key:1"]):
        for r in (a, b):
            r.track_tenant(k, i % 2 == 0)
            r.track_ledger(k, True)
            r.track_outcome(i == 1, 0.1 * i)
    assert a.summary() == b.summary()
    assert a.chaos_summary() == b.chaos_summary()
    assert a.tenant_summary() == b.tenant_summary()
    assert a.summary()["seed"] == 42


def test_harness_trace_roundtrip_byte_identical(tmp_path):
    """The recorded run's trace: the same bytes from both harnesses, and
    the port's reader gives back keys, outcomes and the quantity."""
    rows = [
        ("k:1", 5, 100, 60, 1, True, T0),
        ("k:2", 5, 100, 60, 2, False, T0 + 1),
        ("k:3", 5, 100, 60, 1, None, T0 + 2),  # transport error
    ]
    paths = [str(tmp_path / f"{n}.tctr") for n in ("port", "jax")]
    loadgen._write_harness_trace(paths[0], [rows, rows[:1]])
    jax_loadgen._write_harness_trace(paths[1], [rows, rows[:1]])
    blobs = [open(p, "rb").read() for p in paths]
    assert blobs[0] == blobs[1]
    trace = Trace.load(paths[0])
    w = trace.windows[0]
    assert w.keys == [b"k:1", b"k:2", b"k:3"]
    assert w.allowed.tolist() == [1, 0, 0]
    assert w.status.tolist() == [0, 0, 3]
    np.testing.assert_array_equal(w.params[:, 3], [1, 2, 1])


@pytest.mark.parametrize("argv", [
    ["perf-test", "--pipeline", "4"],
    ["perf-test", "--stats", "--procs", "2"],
    ["perf-test", "--record", "x.tctr", "--procs", "2"],
    ["perf-test", "--transport", "bogus"],
    [],
], ids=["pipeline-not-redis", "stats-procs", "record-procs",
        "bad-transport", "no-command"])
def test_cli_refusals_as_in_jax(argv, capsys):
    got = []
    for mod in (loadgen, jax_loadgen):
        try:
            got.append(("rc", mod.main(argv)))
        except SystemExit as e:
            got.append(("exit", e.code))
        capsys.readouterr()
    assert got[0] == got[1] and got[0][1] == 2


async def _serve_and_drive(harness, transport, keys_kw):
    """A fresh port server (one limiter, HTTP + RESP + gRPC) in this
    loop, driven by `harness`'s run_perf_test over `transport`."""
    metrics = Metrics()
    engine = BatchingEngine(
        TorchRateLimiter(capacity=4096, device="cpu"), metrics=metrics,
        batch_size=64, max_linger_us=200)
    servers = {"http": HttpTransport("127.0.0.1", 0, engine, metrics),
               "redis": RedisTransport("127.0.0.1", 0, engine, metrics),
               "grpc": GrpcTransport("127.0.0.1", 0, engine, metrics)}
    srv = servers[transport]
    await srv.start()
    try:
        port = srv.bound_port
        res = await harness.run_perf_test(
            transport, "127.0.0.1", port, workers=4,
            requests_per_worker=60, **keys_kw)
    finally:
        await srv.stop()
        await engine.shutdown()
    return res


@pytest.mark.parametrize("transport", ["http", "redis", "grpc"])
def test_perf_test_reports_as_jax(transport):
    """Burst 3 over a fixed key set, refill once an hour: every key is
    allowed exactly 3 times in any order, so both harnesses must count
    the same allowed and denied replies, with no errors."""
    kw = dict(burst=3, count=1, period=3600, key_pattern="sequential",
              key_space=40, seed=5)
    got = [asyncio.run(_serve_and_drive(h, transport, kw))
           for h in (loadgen, jax_loadgen)]
    for r in got:
        assert r.total_requests == 240 and r.errors == 0
        assert r.allowed == 40 * 3 and r.denied == 120
    keys = {"transport", "requests", "allowed", "denied", "errors", "seed",
            "key_pattern"}
    summaries = [{k: v for k, v in r.summary().items() if k in keys}
                 for r in got]
    assert summaries[0] == summaries[1]
    assert sorted(got[0].summary()) == sorted(got[1].summary())


def test_cli_perf_test_prints_one_json_line(capsys):
    async def main():
        metrics = Metrics()
        engine = BatchingEngine(
            TorchRateLimiter(capacity=1024, device="cpu"), metrics=metrics)
        srv = HttpTransport("127.0.0.1", 0, engine, metrics)
        await srv.start()
        loop = asyncio.get_running_loop()
        try:
            return await loop.run_in_executor(None, loadgen.main, [
                "perf-test", "--transport", "http", "--port",
                str(srv.bound_port), "--workers", "2", "--requests",
                "20", "--key-space", "10", "--burst", "2", "--count",
                "1", "--period", "3600", "--key-pattern", "sequential"])
        finally:
            await srv.stop()
            await engine.shutdown()
    assert asyncio.run(main()) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["transport"] == "http" and line["requests"] == 40
    assert line["allowed"] == 20 and line["errors"] == 0
