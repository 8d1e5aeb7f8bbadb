"""The port's server as a cluster node, against the JAX server.

In process: a two-node cluster of each package (same ports, one after
the other) serves the same HTTP bodies through each package's engine and
HTTP transport, and every answer, `GET /health/cluster`, `GET /stats`
(the cluster view folded in) and every `/metrics` line (the nine
`throttlecrab_cluster_*` metrics included) is byte-identical; the
engine hands per-window deadline columns to a deadline-aware limiter as
JAX's does (`_deadline_many_kw`), so a forward carries its remaining
budget (`OP_DROUTE_BATCH`).  Then one pair of port server processes on
the CPU (`--cluster-nodes`): a key owned by either node is limited
across both frontends, `/health/cluster` shows the epoch and the peer,
`/metrics` counts forwards, and SIGTERM on one node drains with a
planned leave, exits 0, and leaves the survivor deciding that node's
keys from their migrated state.
"""

import asyncio
import json
import os
import signal
import subprocess
import sys
import time
import urllib.request
from pathlib import Path

import numpy as np
import pytest

from throttlecrab_tpu.server.engine import BatchingEngine as JaxEngine
from throttlecrab_tpu.server.http import HttpTransport as JaxHttp
from throttlecrab_tpu.server.metrics import Metrics as JaxMetrics
from throttlecrab_tpu.server.types import ThrottleRequest as JaxRequest
from throttlecrab_tpu_torch.parallel import cluster as pc
from throttlecrab_tpu_torch.parallel.ring import HashRing
from throttlecrab_tpu_torch.server.engine import BatchingEngine
from throttlecrab_tpu_torch.server.http import HttpTransport
from throttlecrab_tpu_torch.server.metrics import Metrics
from throttlecrab_tpu_torch.server.types import ThrottleRequest
from torch_cluster import NS, T0, Cluster, Ports, free_ports

pytestmark = pytest.mark.filterwarnings("ignore::DeprecationWarning")

REPO = Path(__file__).resolve().parent.parent
SERVERS = {"jax": (JaxEngine, JaxHttp, JaxMetrics),
           "port": (BatchingEngine, HttpTransport, Metrics)}


class _Clock:
    def __init__(self):
        self.now = T0

    def __call__(self):
        return self.now


def _serve(pkg, ports, bodies):
    """Boot a two-node cluster of `pkg`, serve `bodies` in waves through
    the nodes' HTTP routes in turn, then read both nodes' cluster
    routes."""
    engine_cls, http_cls, metrics_cls = SERVERS[pkg]
    cl = Cluster(ports, [pkg, pkg])
    try:
        for i in (0, 1):
            cl.boot(i)
        out = []

        async def main():
            clock = _Clock()
            https = []
            for node in cl.nodes:
                m = metrics_cls(max_denied_keys=100)
                m.set_cluster_stats_provider(node.cl.peer_stats)
                m.set_cluster_view_provider(node.cl.cluster_view)
                eng = engine_cls(node.cl, now_fn=clock, metrics=m,
                                 batch_size=8, max_linger_us=500)
                https.append(http_cls("127.0.0.1", 0, eng, m))
            for w, wave in enumerate(bodies):
                # One frontend per wave: two engines deciding one key at
                # once would race each other.
                got = await asyncio.gather(*[
                    https[w % 2]._route("POST", "/throttle", b, {})
                    for b in wave])
                out.append(got)
                clock.now += NS // 3
            cl.quiesce()
            for h in https:
                for path in ("/health/cluster", "/stats", "/health"):
                    out.append(await h._route("GET", path, b""))
                out.append([
                    line for line in
                    h.metrics.export_prometheus().splitlines()
                    if not line.startswith("throttlecrab_uptime_seconds ")
                ])
            for h in https:
                await h.engine.shutdown()
        asyncio.run(main())
        return out
    finally:
        cl.close()


def test_cluster_routes_and_metrics_byte_identical():
    rng = np.random.default_rng(5)
    bodies = []
    for _ in range(4):
        wave = []
        for _ in range(24):
            k = int(rng.integers(0, 16))
            wave.append(json.dumps({
                "key": f"c:{k}", "max_burst": 1 + k % 4,
                "count_per_period": 1 + k % 3, "period": 60,
            }).encode())
        bodies.append(wave)
    ports = Ports(2)
    got = {pkg: _serve(pkg, ports, bodies) for pkg in ("jax", "port")}
    assert len(got["port"]) == len(got["jax"])
    for a, b in zip(got["jax"], got["port"]):
        assert a == b
    view = json.loads(got["port"][len(bodies)][1])
    assert view["mode"] == "ring" and view["epoch"] >= 1
    assert list(view["peers"]) == [f"127.0.0.1:{ports[1]}"]
    stats = json.loads(got["port"][len(bodies) + 1][1])
    assert stats["cluster"] == view
    metrics = got["port"][len(bodies) + 3]
    names = {line.split()[2] for line in metrics if line.startswith("# TYPE")}
    assert {n for n in names if n.startswith("throttlecrab_cluster_")} == {
        "throttlecrab_cluster_forwarded_total",
        "throttlecrab_cluster_failed_total",
        "throttlecrab_cluster_breaker_open",
        "throttlecrab_cluster_migrated_keys",
        "throttlecrab_cluster_epoch",
        "throttlecrab_cluster_migrated_in_total",
        "throttlecrab_cluster_replica_rows",
        "throttlecrab_cluster_takeovers_total",
        "throttlecrab_cluster_leaves_total",
    }
    fwd = [line for line in metrics
           if line.startswith("throttlecrab_cluster_forwarded_total{")]
    assert fwd and int(fwd[0].split()[-1]) > 0


def test_single_node_health_cluster_answers_mode_none():
    async def main():
        outs = []
        for engine_cls, http_cls, metrics_cls in SERVERS.values():
            class Lim:  # any limiter without a cluster view
                def rate_limit_batch(self, *a, **k):
                    raise AssertionError

                def sweep(self, now_ns):
                    return 0
            m = metrics_cls()
            eng = engine_cls(Lim(), metrics=m)
            outs.append(await http_cls("127.0.0.1", 0, eng, m)._route(
                "GET", "/health/cluster", b""))
            await eng.shutdown()
        return outs
    jax_out, port_out = asyncio.run(main())
    assert port_out == jax_out == (200, b'{"mode": "none"}',
                                   "application/json")


class _DeadlineSpy:
    """A deadline-aware limiter that records the keywords it was given."""

    accepts_deadlines = True

    def __init__(self):
        self.calls = []

    def rate_limit_batch(self, keys, mb, cp, pd, qt, now_ns, wire=False,
                         deadlines_ns=None):
        self.calls.append(("batch", deadlines_ns))
        raise RuntimeError("spy")

    def rate_limit_many(self, batches, wire=False, deadlines=None):
        self.calls.append(("many", deadlines))
        raise RuntimeError("spy")

    def sweep(self, now_ns):
        return 0


@pytest.mark.parametrize("deadlines", [[None, None, None],
                                       [T0 + NS, None, T0 + 2 * NS]],
                         ids=["none", "some"])
def test_deadline_many_kw_as_in_jax(deadlines):
    """The per-window deadline columns (0 for a request without one) go
    to a deadline-aware limiter, and nothing at all when no request in
    the flush carries one or the limiter takes none: JAX's keywords."""
    got = []
    for engine_cls, req_cls in ((JaxEngine, JaxRequest),
                                (BatchingEngine, ThrottleRequest)):
        spy = _DeadlineSpy()
        eng = engine_cls(spy)
        windows = [[(req_cls(f"k{i}", 5, 10, 60, 1, deadline_ns=d), None)
                    for i, d in enumerate(deadlines)]] * 2
        plain = engine_cls(type("P", (), {
            "rate_limit_batch": lambda *a, **k: None,
            "sweep": lambda self, n: 0})())
        got.append((eng._deadline_many_kw(windows),
                    plain._deadline_many_kw(windows)))
    assert got[0] == got[1]
    kw, plain_kw = got[1]
    assert plain_kw == {}
    if deadlines[0] is None:
        assert kw == {}
    else:
        assert kw == {"deadlines": [[T0 + NS, 0, T0 + 2 * NS]] * 2}


def test_engine_passes_deadlines_to_the_cluster_as_in_jax():
    """Through the engine's flush: a request with a deadline header
    reaches the limiter with its deadline column, in both packages."""
    async def main(engine_cls, req_cls):
        spy = _DeadlineSpy()
        eng = engine_cls(spy, now_fn=lambda: T0, batch_size=4,
                         max_linger_us=200)
        reqs = [req_cls("a", 5, 10, 60, 1, deadline_ns=T0 + 5 * NS),
                req_cls("b", 5, 10, 60, 1)]
        res = await asyncio.gather(*[eng.throttle(r) for r in reqs],
                                   return_exceptions=True)
        await eng.shutdown()
        return spy.calls, [type(r).__name__ for r in res]
    got = [asyncio.run(main(e, r)) for e, r in (
        (JaxEngine, JaxRequest), (BatchingEngine, ThrottleRequest))]
    assert got[0] == got[1]
    calls = got[1][0]
    assert calls and calls[0][1] is not None
    flat = calls[0][1][0] if calls[0][0] == "many" else calls[0][1]
    assert list(flat) == [T0 + 5 * NS, 0]


def test_forward_carries_the_budget_as_droute():
    """A forwarded sub-batch with deadlines rides OP_DROUTE_BATCH with
    each row's remaining budget; without deadlines the classic route."""
    cl = pc.ClusterLimiter(object(), ["127.0.0.1:1", "127.0.0.1:2"], 0,
                           vnodes=16)
    try:
        kb = [b"a", b"b"]
        ix = np.array([0, 1])
        b = np.array([5, 5])
        dl = np.array([T0 + 3 * NS, 0])
        frame = cl._forward_frame(kb, ix, b, b, b, b, T0, 1, dl)
        assert frame[4] == pc.OP_DROUTE_BATCH
        hops, keys, _p, now, budgets = pc.decode_droute(frame[5:])
        assert (hops, keys, now) == (1, kb, T0)
        assert budgets.tolist() == [3 * NS, 0]
        frame = cl._forward_frame(kb, ix, b, b, b, b, T0, 1, None)
        assert frame[4] == pc.OP_ROUTE_BATCH
    finally:
        cl.close()


# ------------------------------------------------- two server processes #


def _http(port, method, path, body=None, timeout=30):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=body, method=method,
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return r.status, r.read()


def _throttle(port, key, burst=3):
    body = json.dumps({"key": key, "max_burst": burst,
                       "count_per_period": 10, "period": 600}).encode()
    return json.loads(_http(port, "POST", "/throttle", body)[1])


def _spawn(index, nodes, http_port):
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO) + os.pathsep + env.get("PYTHONPATH", "")
    return subprocess.Popen(
        [sys.executable, "-m", "throttlecrab_tpu_torch.server",
         "--http", "--http-host", "127.0.0.1", "--http-port", str(http_port),
         "--device", "cpu", "--store-capacity", "4096",
         "--cluster-nodes", ",".join(nodes), "--cluster-index", str(index),
         "--cluster-bind-host", "127.0.0.1", "--log-level", "info"],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)


def _wait_healthy(proc, port, deadline_s=90):
    t_end = time.monotonic() + deadline_s
    while time.monotonic() < t_end:
        if proc.poll() is not None:
            pytest.fail(f"node exited rc={proc.returncode}:\n"
                        f"{proc.stdout.read()}")
        try:
            if _http(port, "GET", "/health", timeout=2)[1] == b"OK":
                return
        except OSError:
            pass
        time.sleep(0.1)
    pytest.fail("node never became healthy")


@pytest.fixture(scope="module")
def two_servers():
    rpc = free_ports(2)
    http = free_ports(2)
    nodes = [f"127.0.0.1:{p}" for p in rpc]
    procs = [_spawn(i, nodes, http[i]) for i in (0, 1)]
    try:
        for p, port in zip(procs, http):
            _wait_healthy(p, port)
        # Both announced and both handoff gates drained.
        t_end = time.monotonic() + 60
        while time.monotonic() < t_end:
            views = [json.loads(_http(p, "GET", "/health/cluster")[1])
                     for p in http]
            if all(not v["pending_handoffs"] for v in views):
                break
            time.sleep(0.1)
        yield procs, http, HashRing(nodes, 128)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait(timeout=30)
            p.stdout.close()


def _owned(ring, node, prefix):
    return next(k for k in (f"{prefix}:{i}" for i in range(10_000))
                if ring.owner_of(k.encode()) == node)


def test_server_pair_limits_across_frontends_and_hands_over(two_servers):
    procs, (ha, hb), ring = two_servers
    key_b = _owned(ring, 1, "xproc")
    got = [_throttle(ha, key_b)["allowed"], _throttle(ha, key_b)["allowed"],
           _throttle(hb, key_b)["allowed"], _throttle(ha, key_b)["allowed"]]
    assert got == [True, True, True, False]
    key_a = _owned(ring, 0, "rev")
    assert [_throttle(hb, key_a, burst=2)["allowed"] for _ in range(3)] == [
        True, True, False]
    view = json.loads(_http(ha, "GET", "/health/cluster")[1])
    assert view["mode"] == "ring" and view["epoch"] >= 1
    assert view["vnodes"] == 128 and len(view["peers"]) == 1
    metrics = _http(ha, "GET", "/metrics")[1].decode()
    fwd = [line for line in metrics.splitlines()
           if line.startswith("throttlecrab_cluster_forwarded_total{")]
    assert fwd and int(fwd[0].split()[-1]) >= 3
    # A key of node 1 with one token left, then SIGTERM on node 1: the
    # drain's planned leave hands its range to node 0, which continues
    # the bucket (one more allowed, then denied), with no takeover.
    key_h = _owned(ring, 1, "handover")
    assert [_throttle(hb, key_h)["remaining"] for _ in range(2)] == [2, 1]
    procs[1].send_signal(signal.SIGTERM)
    assert procs[1].wait(timeout=60) == 0
    log = procs[1].stdout.read()
    assert "leaving cluster" in log and "drain complete" in log
    assert [_throttle(ha, key_h)["allowed"] for _ in range(2)] == [True,
                                                                   False]
    view = json.loads(_http(ha, "GET", "/health/cluster")[1])
    assert view["leaves"] == 1 and view["takeovers"] == 0
    assert view["migrated_in"] >= 1


def test_control_plane_registers_the_pump_actuator_as_in_jax():
    """On a ring-mode cluster the control plane's registry holds the
    replica pump's cadence (`cluster.pump_poll_s`) as JAX's does, with
    the same bounds, and moving it retunes only that cluster's pump; the
    sensor bus reads the cluster view's per-node load skew."""
    from throttlecrab_tpu.control import actuators as jax_act
    from throttlecrab_tpu.control.telemetry import SensorBus as JaxBus
    from throttlecrab_tpu_torch.control import actuators as port_act
    from throttlecrab_tpu_torch.control.telemetry import SensorBus

    ports = Ports(2)
    got = []
    for pkg, act, bus_cls in (("jax", jax_act, JaxBus),
                              ("port", port_act, SensorBus)):
        cl = Cluster(ports, [pkg, pkg])
        try:
            a, b = cl.boot(0), cl.boot(1)
            a.cl.rate_limit_batch([f"s:{i}" for i in range(64)], 5, 10, 60,
                                  1, T0)
            cl.quiesce()
            reg = act.build_registry(limiter=a.cl)
            row = (reg.names(), reg.bounds("cluster.pump_poll_s"),
                   reg.get("cluster.pump_poll_s"),
                   reg.apply("cluster.pump_poll_s", 0.3, T0))
            row += (a.cl._pump.POLL_S, b.cl._pump.POLL_S)
            tel = bus_cls(limiter=a.cl).snapshot(T0)
            row += (tel.load_skew,)
            got.append(row)
        finally:
            cl.close()
    assert got[0] == got[1]
    names, bounds, poll, applied, after, other, skew = got[1]
    assert "cluster.pump_poll_s" in names and bounds == (0.05, 5.0)
    assert poll == 0.2 and applied == after == 0.3 and other == 0.2
    assert skew > 0
