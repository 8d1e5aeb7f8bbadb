"""The port's BatchingEngine + HTTP transport against the JAX server's.

Both servers run over a limiter on the CPU (the port's on device="cpu",
the plain version), with the same injected clock, and get the same
`POST /throttle` bodies — valid requests, duplicate keys in one window,
quantity-0 probes, invalid params, negative quantities, malformed JSON,
client deadlines that lapse in the queue, requests after shutdown.  The
HTTP status and the JSON body must be byte-identical.  Both servers'
`Metrics` are built as each server builds them at its default config
(the top-denied leaderboard at 100 keys), and their whole `/metrics`
renders must match (the uptime value aside: two clocks); at the default
config (insight on) their GET /stats documents match too.
`/health` and `/metrics` answer 200 over a real socket.  Every flag of
the JAX server that belongs to a ported module parses, from the command
line and from its environment variable, to the same value in both.
"""

import asyncio
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from throttlecrab_tpu.server import config as jax_config
from throttlecrab_tpu.server.engine import BatchingEngine as JaxEngine
from throttlecrab_tpu.server.http import HttpTransport as JaxHttp
from throttlecrab_tpu.server.metrics import Metrics as JaxMetrics
from throttlecrab_tpu.server import store as jax_store
from throttlecrab_tpu.tpu.limiter import TpuRateLimiter
from throttlecrab_tpu_torch.server import config as port_config
from throttlecrab_tpu_torch.server.engine import BatchingEngine
from throttlecrab_tpu_torch.server.http import HttpTransport
from throttlecrab_tpu_torch.server.metrics import Metrics
from throttlecrab_tpu_torch.server import store as port_store
from throttlecrab_tpu_torch.tpu.limiter import TorchRateLimiter

NS = 1_000_000_000
T0 = 1_753_700_000 * NS


class VirtualClock:
    def __init__(self, start_ns=T0):
        self.now = start_ns

    def __call__(self):
        return self.now


def _render(metrics):
    """The /metrics lines, minus the uptime value (two clocks)."""
    return [
        line for line in metrics.export_prometheus().splitlines()
        if not line.startswith("throttlecrab_uptime_seconds ")
    ]


def _servers(clock, insight=False, **kw):
    """Both servers over a 1024-key limiter.  With `insight`, each
    limiter stores the insight rows and each engine polls an insight tier
    built as its __main__ builds it at the default config (the default
    server's shape)."""
    # Each server's Metrics as its __main__ builds it at the default config.
    jax_metrics = JaxMetrics(
        max_denied_keys=jax_config.Config().max_denied_keys)
    port_metrics = Metrics(
        max_denied_keys=port_config.Config().max_denied_keys)
    jax_lim = TpuRateLimiter(capacity=1024, insight=insight)
    port_lim = TorchRateLimiter(capacity=1024, device="cpu", insight=insight)
    tiers = [None, None]
    if insight:
        cfgs = (jax_config.Config(http=True), port_config.Config(http=True))
        tiers = [
            store.create_insight(cfg, m, lim, None)
            for store, cfg, m, lim in (
                (jax_store, cfgs[0], jax_metrics, jax_lim),
                (port_store, cfgs[1], port_metrics, port_lim),
            )
        ]
    jax_engine = JaxEngine(
        jax_lim, now_fn=clock, metrics=jax_metrics, insight=tiers[0], **kw,
    )
    port_engine = BatchingEngine(
        port_lim, now_fn=clock, metrics=port_metrics, insight=tiers[1], **kw,
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
    """At the default config (insight on): the same bodies, the same
    /metrics (control gauges aside) and the same GET /stats."""
    async def main():
        clock = VirtualClock()
        servers = _servers(clock, insight=True, batch_size=8,
                           max_linger_us=500)
        assert servers[1].engine.limiter.table.state.shape[-1] == 6
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
        rendered = [_render(s.metrics) for s in servers]
        assert rendered[0] == rendered[1]
        assert any(line.startswith("throttlecrab_top_denied_keys{")
                   for line in rendered[1])
        assert "throttlecrab_tpu_insight_polls 0" not in rendered[1]
        stats = [await s._route("GET", "/stats", b"") for s in servers]
        assert stats[0] == stats[1]
        assert json.loads(stats[1][1])["totals"]["denied"] > 0

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


def test_default_deadline_stamped_as_in_jax():
    """`deadline_default_ms` stamps requests that carry no deadline: one
    queued past it answers 504 on both servers, one with its own header
    deadline keeps that deadline."""
    async def main():
        clock = VirtualClock()
        servers = _servers(clock, batch_size=64, max_linger_us=2000,
                           deadline_default_ms=1)
        body = json.dumps(
            {"key": "dd", "max_burst": 2, "count_per_period": 1, "period": 9}
        ).encode()
        hdr = {"x-throttlecrab-deadline-ms": "50"}
        tasks = [
            asyncio.create_task(s._route("POST", "/throttle", body, h))
            for s in servers for h in ({}, hdr)
        ]
        await asyncio.sleep(0)
        clock.now += 2_000_000  # past the default, inside the header's
        got = await asyncio.gather(*tasks)
        for s in servers:
            await s.engine.shutdown()
        return got

    j_default, j_header, p_default, p_header = asyncio.run(main())
    assert (j_default, j_header) == (p_default, p_header)
    assert p_default[0] == 504 and p_header[0] == 200


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


# A value for each ported flag, different from its default.
_FLAG_VALUES = {
    "http_host": "127.0.0.2", "http_port": "18081", "http_backend": "native",
    "grpc_host": "127.0.0.3", "grpc_port": "18071",
    "redis_host": "127.0.0.4", "redis_port": "16380",
    "redis_backend": "native", "store": "adaptive", "store_capacity": "77",
    "store_cleanup_interval": "11", "store_cleanup_probability": "12",
    "store_min_interval": "2", "store_max_interval": "99",
    "store_max_operations": "1234", "buffer_size": "5",
    "max_denied_keys": "5", "log_level": "debug", "batch_size": "64",
    "max_linger_us": "300", "max_scan_depth": "4", "keymap": "python",
    "snapshot_path": "/data/state", "drain_timeout_ms": "5",
    "deadline_default_ms": "5", "front_deny_cache": "17",
    "front_max_pending": "18", "front_max_wait_us": "19",
    "front_peek_frac": "0.5", "supervisor_retries": "7",
    "supervisor_backoff_us": "11", "supervisor_backoff_max_us": "12",
    "supervisor_probe_interval_ms": "13", "supervisor_mode": "fail",
    "faults": "launch:count:2,fetch:transient:0.5", "faults_seed": "9",
    "checkpoint_interval_ms": "250", "checkpoint_dir": "/data/ck",
    "checkpoint_retain": "3", "checkpoint_mode": "full",
    "insight_topk": "8", "insight_sketch": "99", "insight_window_s": "3",
    "insight_poll_ms": "250", "insight_decay_s": "7",
    "insight_prewarm": "5", "insight_hot_denies": "6",
    "insight_shed_weight": "0.25", "profile_dir": "/data/prof",
    "trace_dir": "/data/traces", "trace_windows": "77",
    "trace_mode": "full", "control_tick_ms": "250",
    "control_mode": "hill", "control_target_wait_us": "1234.5",
    "control_w_throughput": "2.5", "control_w_wait": "0.5",
    "control_w_fairness": "0.125",
    "shards": "4", "tenant_max": "8", "tenant_delim": "/",
    "tenant_quota": "0.25",
}
_PORT_FLAGS = [
    (name, env, typ) for name, env, _, typ, _ in port_config._SPEC
    if name != "device" and not name.startswith("cluster_")
]


@pytest.mark.parametrize(
    "name,env,typ", _PORT_FLAGS, ids=[f[0] for f in _PORT_FLAGS]
)
def test_ported_flag_parses_as_in_jax(monkeypatch, name, env, typ):
    """Each flag: its default, its command-line form and its environment
    variable give the same value in both packages."""
    flag = "--" + name.replace("_", "-")
    assert name in {n for n, *_ in jax_config._SPEC}
    base = ["--http"] if name != "http" else ["--redis"]
    if name == "checkpoint_interval_ms":
        base += ["--checkpoint-dir", "/data/ck"]  # the interval needs one
    if name in ("tenant_quota", "tenant_affinity"):
        base += ["--shards", "2"]  # isolation knobs need the mesh
    both = (jax_config.Config, port_config.Config)
    monkeypatch.delenv(env, raising=False)
    got = [getattr(c.from_env_and_args(base), name) for c in both]
    assert got[0] == got[1]
    argv = base + ([flag] if typ is bool else [flag, _FLAG_VALUES[name]])
    got = [getattr(c.from_env_and_args(argv), name) for c in both]
    assert got[0] == got[1]
    monkeypatch.setenv(env, "0" if typ is bool else _FLAG_VALUES[name])
    got = [getattr(c.from_env_and_args(base), name) for c in both]
    assert got[0] == got[1]


@pytest.mark.parametrize("argv", [
    ["--max-denied-keys", "10001"], ["--max-denied-keys", "-1"],
    ["--drain-timeout-ms", "-1"], ["--deadline-default-ms", "-1"],
    [], ["--front-deny-cache", "-1"], ["--front-max-pending", "-1"],
    ["--front-max-wait-us", "-1"], ["--front-peek-frac", "0"],
    ["--front-peek-frac", "1.5"], ["--supervisor-mode", "explode"],
    ["--supervisor-retries", "-1"], ["--supervisor-backoff-us", "-1"],
    ["--supervisor-backoff-max-us", "-1"],
    ["--supervisor-probe-interval-ms", "0"], ["--faults", "nope:persistent"],
    ["--faults", "launch:transient:2"], ["--faults", "launch"],
    ["--checkpoint-interval-ms", "100"],
    ["--checkpoint-dir", "/x", "--checkpoint-interval-ms", "-1"],
    ["--checkpoint-dir", "/x", "--checkpoint-retain", "0"],
    ["--checkpoint-dir", "/x", "--checkpoint-mode", "weekly"],
    ["--insight-topk", "0"], ["--insight-sketch", "0"],
    ["--insight-window-s", "0"], ["--insight-poll-ms", "0"],
    ["--insight-decay-s", "-1"], ["--insight-prewarm", "-1"],
    ["--insight-hot-denies", "0"], ["--insight-shed-weight", "1.5"],
    ["--trace-mode", "tape"], ["--trace-windows", "0"],
    ["--control-mode", "pid"], ["--control-tick-ms", "0"],
    ["--control-target-wait-us", "0"], ["--control-w-wait", "-1"],
    ["--shards", "0"], ["--tenant-max", "-1"],
    ["--shards", "2", "--tenant-max", "1"],
    ["--shards", "2", "--tenant-delim", "::"],
    ["--shards", "2", "--tenant-delim", ""],
    ["--shards", "2", "--tenant-quota", "1.5"],
    ["--shards", "2", "--tenant-quota", "-0.5"],
    ["--tenant-quota", "0.5"], ["--tenant-affinity"],
    ["--shards", "2", "--tenant-max", "0", "--tenant-affinity"],
    ["--shards", "2", "--tenant-max", "0", "--tenant-quota", "0.5"],
    ["--cluster-vnodes", "-1"], ["--cluster-handoff-timeout-ms", "0"],
    ["--cluster-replica-cap", "-1"],
    ["--cluster-nodes", "127.0.0.1:9000", "--cluster-index", "1"],
    ["--cluster-nodes", "127.0.0.1:9000", "--cluster-index", "-1"],
    ["--cluster-nodes", "127.0.0.1"],
    ["--cluster-nodes", "127.0.0.1:90x0,127.0.0.1:9001"],
    ["--cluster-nodes", ":9000"],
], ids=["denied-keys-high", "denied-keys-negative", "drain-negative",
        "deadline-negative", "no-transport", "deny-cache-negative",
        "max-pending-negative", "max-wait-negative", "peek-frac-zero",
        "peek-frac-high", "supervisor-mode", "retries-negative",
        "backoff-negative", "backoff-max-negative", "probe-interval-zero",
        "faults-site", "faults-probability", "faults-shape",
        "checkpoint-interval-no-dir", "checkpoint-interval-negative",
        "checkpoint-retain-zero", "checkpoint-mode", "insight-topk-zero",
        "insight-sketch-zero", "insight-window-zero", "insight-poll-zero",
        "insight-decay-negative", "insight-prewarm-negative",
        "insight-hot-denies-zero", "insight-shed-weight-high",
        "trace-mode", "trace-windows-zero", "control-mode",
        "control-tick-zero", "control-target-wait-zero",
        "control-weight-negative", "shards-zero", "tenant-max-negative",
        "tenant-max-one", "tenant-delim-two-bytes", "tenant-delim-empty",
        "tenant-quota-high", "tenant-quota-negative",
        "tenant-quota-one-device", "tenant-affinity-one-device",
        "tenant-affinity-no-layer", "tenant-quota-no-layer",
        "cluster-vnodes-negative", "cluster-handoff-zero",
        "cluster-replica-cap-negative", "cluster-index-high",
        "cluster-index-negative", "cluster-node-no-port",
        "cluster-node-bad-port", "cluster-node-no-host"])
def test_invalid_flags_refused_as_in_jax(argv):
    for mod in (jax_config, port_config):
        with pytest.raises(mod.ConfigError):
            mod.Config.from_env_and_args(
                argv + (["--grpc"] if argv else [])
            )


_DRAIN_CODE = r"""
import asyncio, os, signal, sys
from throttlecrab_tpu_torch.server import __main__ as entry
from throttlecrab_tpu_torch.server.config import Config
from throttlecrab_tpu_torch.server.engine import BatchingEngine

drains = []
begin = BatchingEngine.begin_drain
BatchingEngine.begin_drain = lambda self: drains.append(1) or begin(self)
cfg = Config.from_env_and_args([
    "--http", "--http-host", "127.0.0.1", "--http-port", "0", "--device",
    "cpu", "--keymap", "python", "--drain-timeout-ms", sys.argv[1],
])
started = asyncio.Event()
built = entry.build_transports
def build(*a):
    started.set()
    return built(*a)
entry.build_transports = build

async def main():
    task = asyncio.create_task(entry.run_server(cfg))
    await started.wait()
    await asyncio.sleep(0.2)
    os.kill(os.getpid(), signal.SIGTERM)
    await asyncio.wait_for(task, 60)

asyncio.run(main())
print("drained", bool(drains))
"""


@pytest.mark.parametrize("budget,drained", [("0", False), ("5000", True)])
def test_sigterm_drain_budget(budget, drained):
    """SIGTERM drains within --drain-timeout-ms; a budget of 0 takes the
    kill path (no drain), as the JAX server does."""
    env = {k: v for k, v in os.environ.items() if not k.startswith("PYTEST")}
    env["PYTHONPATH"] = str(Path(__file__).resolve().parent.parent)
    r = subprocess.run([sys.executable, "-c", _DRAIN_CODE, budget], env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr[-3000:]
    assert r.stdout.split()[-2:] == ["drained", str(drained)]


@pytest.mark.parametrize("insight", [True, False], ids=["default", "off"])
def test_default_limiter_row_width_as_in_jax(monkeypatch, insight):
    """At the default flags both servers store the 6-wide insight rows and
    build an insight tier; THROTTLECRAB_INSIGHT=0 gives 4-wide rows and
    no tier, in both."""
    if not insight:
        monkeypatch.setenv("THROTTLECRAB_INSIGHT", "0")
    argv = ["--http", "--store-capacity", "1024"]
    jax_cfg = jax_config.Config.from_env_and_args(argv)
    port_cfg = port_config.Config.from_env_and_args(
        argv + ["--device", "cpu", "--keymap", "python"])
    jax_lim = jax_store.create_limiter(jax_cfg)
    port_lim = port_store.create_limiter(port_cfg)
    width = 6 if insight else 4
    assert np.asarray(jax_lim.table.state).shape[-1] == width
    assert port_lim.table.state.shape[-1] == width
    tiers = [jax_store.create_insight(jax_cfg, None, jax_lim, None),
             port_store.create_insight(port_cfg, None, port_lim, None)]
    assert [t is not None for t in tiers] == [insight, insight]


# --------------------------------------------------------------------- #
# C7: the JAX server's mesh, tenant, Pallas and cluster flags.


@pytest.mark.parametrize("argv", [
    ["--http", "--pallas-fused"], ["--http", "--shards", "1"],
    ["--http", "--shards", "2", "--tenant-quota", "0.5",
     "--tenant-affinity", "--tenant-max", "16", "--tenant-delim", "/"],
    ["--http", "--shards", "3", "--tenant-max", "0"],
], ids=["pallas-fused", "shards-1", "tenant-flags", "tenant-layer-off"])
def test_mesh_flags_parse_as_in_jax(argv):
    """Command lines of the JAX server that the port refused before it
    had the mesh give the same values in both packages."""
    names = ("shards", "tenant_max", "tenant_delim", "tenant_quota",
             "tenant_affinity", "pallas_fused")
    got = [tuple(getattr(c.from_env_and_args(argv), n) for n in names)
           for c in (jax_config.Config, port_config.Config)]
    assert got[0] == got[1]


def test_mesh_env_builds_the_sharded_limiter_it_names(monkeypatch):
    """THROTTLECRAB_SHARDS=2 THROTTLECRAB_TENANT_QUOTA=0.5
    THROTTLECRAB_PALLAS_FUSED=1: both configs carry all three, and the
    port builds the 2-shard mesh with the quota armed (on CPU shards)
    instead of a single-device limiter without one."""
    for env, value in (("THROTTLECRAB_SHARDS", "2"),
                       ("THROTTLECRAB_TENANT_QUOTA", "0.5"),
                       ("THROTTLECRAB_PALLAS_FUSED", "1")):
        monkeypatch.setenv(env, value)
    cfgs = [c.from_env_and_args(["--http"])
            for c in (jax_config.Config, port_config.Config)]
    for cfg in cfgs:
        assert (cfg.shards, cfg.tenant_quota, cfg.pallas_fused) == (
            2, 0.5, True)
    from throttlecrab_tpu_torch.parallel import ShardedTorchRateLimiter

    cfgs[1].device = "cpu"
    lim = port_store.create_limiter(cfgs[1])
    assert isinstance(lim, ShardedTorchRateLimiter)
    assert lim.n_shards == 2 and lim.tenants.quota_frac == 0.5
    assert "THROTTLECRAB_PALLAS_FUSED" in port_config.list_env_vars_text()


def test_shards_on_missing_cards_refused_like_jax_mesh():
    """--shards N on cuda takes N cards and refuses to shrink the mesh
    (make_mesh's message, as JAX's on a host with fewer chips)."""
    import torch

    from throttlecrab_tpu_torch.parallel import make_mesh

    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    cfg = port_config.Config.from_env_and_args(
        ["--http", "--shards", str(have + 1)])
    err = RuntimeError if have == 0 else ValueError
    with pytest.raises(err, match="cuda|requested a"):
        port_store.create_limiter(cfg)
    if have:
        with pytest.raises(ValueError, match=f"exposes {have}"):
            make_mesh(have + 1)


_CLUSTER_VALUES = {
    "cluster_nodes": "127.0.0.1:9000,127.0.0.1:9001",
    "cluster_index": "1", "cluster_bind_host": "127.0.0.9",
    "cluster_timeout_ms": "250", "cluster_connect_timeout_ms": "250",
    "cluster_breaker_failures": "5", "cluster_breaker_cooldown_ms": "250",
    "cluster_vnodes": "0", "cluster_handoff_timeout_ms": "250",
    "cluster_replica_cap": "10",
}
_CLUSTER_FLAGS = [
    (name, env, typ) for name, env, _, typ, _ in port_config._SPEC
    if name.startswith("cluster_")
]


@pytest.mark.parametrize(
    "name,env,typ", _CLUSTER_FLAGS, ids=[f[0] for f in _CLUSTER_FLAGS]
)
def test_cluster_flag_default_parses_other_values_refused(
        monkeypatch, name, env, typ):
    """Each of the JAX server's 11 cluster flags parses in the port
    exactly as in JAX: at its default, at another value by flag, and at
    that value by environment (the whole Config agrees field by field).
    The name is kept from when the port refused non-default values; the
    cluster tier now takes them all."""
    assert len(_CLUSTER_FLAGS) == 11
    monkeypatch.delenv(env, raising=False)
    assert name in {n for n, *_ in jax_config._SPEC}
    both = (jax_config.Config, port_config.Config)

    def parsed(argv):
        cfgs = [c.from_env_and_args(argv) for c in both]
        shared = [f.name for f in dataclasses.fields(cfgs[0])
                  if f.name.startswith("cluster_")]
        got = [[getattr(c, n) for n in shared] for c in cfgs]
        assert got[0] == got[1], argv
        assert cfgs[0].cluster_node_list() == cfgs[1].cluster_node_list()
        return getattr(cfgs[1], name)

    default = parsed(["--http"])
    if typ is bool:  # store_true at a True default: only env can flip it
        monkeypatch.setenv(env, "0")
        assert parsed(["--http"]) is False and default is True
        return
    flag = "--" + name.replace("_", "-")
    argv = ["--http", flag, _CLUSTER_VALUES[name]]
    if name == "cluster_index":
        argv += ["--cluster-nodes", _CLUSTER_VALUES["cluster_nodes"]]
    assert parsed(argv) == typ(_CLUSTER_VALUES[name]) != default
    monkeypatch.setenv(env, _CLUSTER_VALUES[name])
    assert parsed(argv[:1] + argv[3:]) == typ(_CLUSTER_VALUES[name])
