"""The port stands alone: it imports torch, never jax, and nothing of the
JAX package — and its entry points never fall back to the CPU.

Runs in a fresh interpreter with `sys.modules["jax"] = None` (any jax
import raises), imports every module of throttlecrab_tpu_torch, and
checks that no module named `throttlecrab_tpu` or `throttlecrab_tpu.*`
got loaded (`throttlecrab_tpu_torch` shares the prefix, so the check is
exact); the cluster tier and its ring (parallel/cluster.py, ring.py) and
the load harness (harness/) are among them and a one-node cluster
decides, with no jax; the failure domain, the front tier, the insight tier, crash
durability, record/replay, the control plane and the profiling hook
(faults/, front/, server/supervisor.py, insight/, persist/, replay/,
control/, tpu/profiling.py) and the tier-ladder campaign
(tools/fuzz_wire_tiers.py, which runs a seed) are among them, and no
module touches
`torch.cuda` while it is imported; an insight tier polls and a
checkpoint chain is written and recovered, a recorded trace replays, a
control plane ticks and ranks policies, and a supervised limiter degrades
to its host oracle under an injected fault and re-promotes, with a deny
cache certifying from its results, still with no jax.  Then the device
contract: without a card, asking for `cuda` —
explicitly or by default — raises instead of running on the CPU.  Last,
the native keymap builds (g++, from native/keymap.cpp) and serves a batch,
and the native RESP transport (the wire server built from
native/wire_server.cpp) answers a THROTTLE over a socket, with still no
jax and nothing of the JAX package loaded.  A second interpreter, with
jax, grpc and protobuf all unimportable, boots the server with `--http`
and `--snapshot-path` and `--checkpoint-dir`, and SIGTERM saves the snapshot
and writes the final checkpoint: a server without `--grpc` never needs
grpcio.
"""

import os
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent

_CODE = r"""
import importlib, pkgutil, sys
sys.modules["jax"] = None
import torch
touched = []
_cuda_saved = {}
for _fn in ("is_available", "device_count", "current_device", "init",
            "synchronize", "set_device", "get_device_name"):
    _cuda_saved[_fn] = getattr(torch.cuda, _fn)
    setattr(torch.cuda, _fn,
            lambda *a, _n=_fn, **k: touched.append(_n) or
            _cuda_saved[_n](*a, **k))
import throttlecrab_tpu_torch as pkg
names = [pkg.__name__]
for info in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."):
    names.append(info.name)
for name in names:
    importlib.import_module(name)
assert not touched, ("torch.cuda touched at import", touched)
for _fn, _orig in _cuda_saved.items():
    setattr(torch.cuda, _fn, _orig)
leaked = sorted(
    m for m in sys.modules
    if m == "throttlecrab_tpu" or m.startswith("throttlecrab_tpu.")
)
assert not leaked, leaked
assert sys.modules.get("jax") is None
for name in (
    "throttlecrab_tpu_torch.faults", "throttlecrab_tpu_torch.faults.injector",
    "throttlecrab_tpu_torch.front", "throttlecrab_tpu_torch.front.admission",
    "throttlecrab_tpu_torch.front.deny_cache",
    "throttlecrab_tpu_torch.server.supervisor",
    "throttlecrab_tpu_torch.insight", "throttlecrab_tpu_torch.insight.collector",
    "throttlecrab_tpu_torch.persist", "throttlecrab_tpu_torch.persist.format",
    "throttlecrab_tpu_torch.persist.checkpoint",
    "throttlecrab_tpu_torch.persist.recovery",
    "throttlecrab_tpu_torch.replay", "throttlecrab_tpu_torch.replay.trace",
    "throttlecrab_tpu_torch.replay.recorder",
    "throttlecrab_tpu_torch.replay.player",
    "throttlecrab_tpu_torch.replay.generators",
    "throttlecrab_tpu_torch.replay.__main__",
    "throttlecrab_tpu_torch.control",
    "throttlecrab_tpu_torch.control.telemetry",
    "throttlecrab_tpu_torch.control.actuators",
    "throttlecrab_tpu_torch.control.controllers",
    "throttlecrab_tpu_torch.control.plane",
    "throttlecrab_tpu_torch.control.replayer",
    "throttlecrab_tpu_torch.control.__main__",
    "throttlecrab_tpu_torch.tpu.profiling",
    "throttlecrab_tpu_torch.server.engine",
    "throttlecrab_tpu_torch.server.http",
    "throttlecrab_tpu_torch.server.native_redis",
    "throttlecrab_tpu_torch.server.__main__",
    "throttlecrab_tpu_torch.parallel",
    "throttlecrab_tpu_torch.parallel.sharded",
    "throttlecrab_tpu_torch.parallel.tenants",
    "throttlecrab_tpu_torch.parallel.ring",
    "throttlecrab_tpu_torch.parallel.cluster",
    "throttlecrab_tpu_torch.harness",
    "throttlecrab_tpu_torch.harness.__main__",
    "throttlecrab_tpu_torch.harness.loadgen",
    "throttlecrab_tpu_torch.harness.workload",
    "throttlecrab_tpu_torch.tools.fuzz_wire_tiers",
):
    assert name in names, name
print("imported", len(names))

from throttlecrab_tpu_torch.tools import fuzz_wire_tiers as fz
fz.run_seed(3002, 4, fz.campaign_mesh("cpu"), alternate=True, device="cpu")
assert fz.run_trace_frame_fuzz(6000, 4, device="cpu") == 4
assert fz.run_cluster_frame_fuzz(5000, 4, device="cpu") == 4
assert fz.TOTAL["requests"] > 8 and fz.TOTAL["card_windows"] == 0
assert sys.modules.get("jax") is None
print("the tier-ladder campaign runs without jax")

from throttlecrab_tpu_torch.parallel.cluster import (
    ClusterLimiter, decode_reply, encode_reply)
from throttlecrab_tpu_torch.parallel.ring import HashRing
from throttlecrab_tpu_torch.harness.workload import make_keys
from throttlecrab_tpu_torch.tpu.limiter import TorchRateLimiter
solo = ClusterLimiter(TorchRateLimiter(capacity=64, device="cpu"),
                      ["127.0.0.1:1"], 0, vnodes=16)
res = solo.rate_limit_batch(["a", "b", "a"], 2, 1, 60, 1, 10**18)
assert res.allowed.tolist() == [True, True, True]
frame = encode_reply(res.status, res.allowed, res.limit, res.remaining,
                     res.reset_after_ns, res.retry_after_ns)
assert len(decode_reply(frame[5:])) == 3  # the body after u32 len, u8 op
assert HashRing(["a:1", "b:2"], 8).owner_of(b"k") in (0, 1)
assert len(make_keys("random", 8, 4, seed=1)) == 8
solo.close()
assert sys.modules.get("jax") is None
print("the cluster tier and the harness run without jax")

from throttlecrab_tpu_torch.parallel import ShardedTorchRateLimiter, make_mesh
from throttlecrab_tpu_torch.parallel.tenants import TenantRegistry
from throttlecrab_tpu_torch.tpu import snapshot
mesh_lim = ShardedTorchRateLimiter(
    64, mesh=make_mesh(2, device="cpu"), insight=True,
    tenants=TenantRegistry(max_tenants=4, quota_frac=0.05, affinity=True))
res = mesh_lim.rate_limit_batch(["t:a", "t:b", "t:c", "u:a"], 2, 1, 60, 1,
                                10**18, wire=True)
assert res.status.tolist() == [0, 0, 0, 0]
res = mesh_lim.rate_limit_batch(["t:d", "t:e", "t:f", "t:g"], 2, 1, 60, 1,
                                10**18, wire=True)
assert 5 in res.status.tolist()  # the tenant quota (status 5)
assert len(snapshot.export_state(mesh_lim)[0]) == len(mesh_lim)
assert mesh_lim.table.insight_topk(2)[0].tolist() == [0, 0]
assert sys.modules.get("jax") is None
print("the sharded mesh runs without jax")

import os, tempfile
from throttlecrab_tpu_torch import control, replay
from throttlecrab_tpu_torch.replay.generators import synthesize
from throttlecrab_tpu_torch.replay.player import (
    differential_replay, make_target)
from throttlecrab_tpu_torch.server.config import Config
with tempfile.TemporaryDirectory() as d:
    rec = replay.FlightRecorder(mode="full", out_dir=d)
    replay.arm(rec)
    trace = synthesize("flash-crowd", windows=4, batch=16, key_space=64)
    for w in trace.windows:
        rec.record_window(w.now_ns, w.keys, w.params, w.allowed, w.status)
    replay.maybe_record_event("degrade", "drill")
    replay.disarm()
    loaded = replay.Trace.load(rec.close())
    assert loaded.outcome_vector() == trace.outcome_vector()
    assert differential_replay(
        loaded, make_target("device", loaded, device="cpu")).ok
cfg = Config.from_env_and_args(["--http", "--control", "--control-tick-ms",
                                "1"])
plane = control.create_control_plane(cfg)
assert plane.maybe_tick(10**18) and plane._prev.now_ns == 10**18
assert control.rank(trace, control.default_candidates(2))[0]["rank"] == 1
assert sys.modules.get("jax") is None
print("record/replay and the control plane run without jax")

import tempfile
from throttlecrab_tpu_torch.insight import InsightTier
from throttlecrab_tpu_torch.persist import Checkpointer, recover_into
from throttlecrab_tpu_torch.tpu.limiter import TorchRateLimiter as _TRL
lim = _TRL(capacity=64, device="cpu", insight=True)
ins = InsightTier(limiter=lim, poll_ms=1)
lim.rate_limit_batch(["h"] * 5, 2, 1, 60, 1, 10**18)
assert ins.poll(10**18) and ins.stats()["totals"]["denied"] == 3
with tempfile.TemporaryDirectory() as d:
    Checkpointer(lim, d, interval_ns=1).checkpoint_now(10**18)
    res = recover_into(_TRL(capacity=64, device="cpu"), d, 10**18 + 1)
    assert res.restored == 1
assert sys.modules.get("jax") is None
print("insight poll and checkpoint chain run without jax")

from throttlecrab_tpu_torch import faults
from throttlecrab_tpu_torch.front import DenyCache, FrontTier
from throttlecrab_tpu_torch.server.supervisor import SupervisedLimiter
from throttlecrab_tpu_torch.tpu.limiter import TorchRateLimiter as _TRL
inj = faults.FaultInjector(faults.parse_spec("launch:persistent"))
faults.arm(inj)
sup = SupervisedLimiter(_TRL(capacity=64, device="cpu"), retries=1,
                        probe_interval_ms=1, sleep_fn=lambda s: None)
sup.front = FrontTier(DenyCache(16), None)
t = 10**18
assert sup.rate_limit_batch(["k"], 2, 1, 60, 1, t).allowed[0]
assert sup.state == "degraded" and inj.stats() == {"launch": 2}
inj.heal()
res = sup.rate_limit_batch(["k"], 2, 1, 60, 1, t + 2 * 10**6, wire=True,
                           collect_cur=True)
assert sup.state == "ok" and sup.repromote_count == 1
assert res.allowed[0] and res.cur_ns is not None
faults.disarm()
assert sys.modules.get("jax") is None
print("supervisor and front tier run without jax")

import torch
from throttlecrab_tpu_torch.tpu.limiter import TorchRateLimiter
from throttlecrab_tpu_torch.tpu.table import BucketTable
from throttlecrab_tpu_torch.server.config import Config
from throttlecrab_tpu_torch.server.store import create_limiter
if torch.cuda.is_available():
    print("card present: cuda entry points build")
    assert TorchRateLimiter(capacity=64).table.state.is_cuda
else:
    for make in (
        lambda: TorchRateLimiter(capacity=64),
        lambda: BucketTable(64, device="cuda"),
        lambda: create_limiter(Config(http=True, store_capacity=64)),
        lambda: make_mesh(2),
        lambda: create_limiter(Config(http=True, shards=2)),
    ):
        try:
            make()
        except RuntimeError as e:
            assert "cuda" in str(e)
        else:
            raise AssertionError("cuda requested without a card must raise")
    print("no card: cuda entry points raise")
from throttlecrab_tpu_torch.native import NativeKeyMap
lim = TorchRateLimiter(capacity=64, device="cpu", keymap="native")
assert isinstance(lim.keymap, NativeKeyMap)
res = lim.rate_limit_batch(["a", "b", "a"], 2, 1, 60, 1, 10**18)
assert list(res.allowed) == [True, True, True]
leaked = sorted(
    m for m in sys.modules
    if m == "throttlecrab_tpu" or m.startswith("throttlecrab_tpu.")
)
assert not leaked, leaked
assert sys.modules.get("jax") is None
print("native keymap builds and imports no jax")

import asyncio
from throttlecrab_tpu_torch.server.metrics import Metrics
from throttlecrab_tpu_torch.server.native_redis import NativeRedisTransport

async def throttle_once():
    t = NativeRedisTransport(
        "127.0.0.1", 0,
        TorchRateLimiter(capacity=64, device="cpu", keymap="native"),
        Metrics(), batch_size=16, now_fn=lambda: 10**18,
    )
    await t.start()
    try:
        reader, writer = await asyncio.open_connection(
            "127.0.0.1", t.bound_port)
        writer.write(b"*5\r\n$8\r\nTHROTTLE\r\n$1\r\nk\r\n$1\r\n2\r\n"
                     b"$1\r\n1\r\n$2\r\n60\r\n")
        reply = await asyncio.wait_for(reader.readuntil(b":0\r\n"), 10)
        writer.close()
    finally:
        await t.stop()
    return reply

assert asyncio.run(throttle_once()) == b"*5\r\n:1\r\n:2\r\n:1\r\n:60\r\n:0\r\n"
leaked = sorted(
    m for m in sys.modules
    if m == "throttlecrab_tpu" or m.startswith("throttlecrab_tpu.")
)
assert not leaked, leaked
assert sys.modules.get("jax") is None
print("native RESP transport builds, answers and imports no jax")
print("ok")
"""


def test_port_imports_without_jax_and_never_falls_back():
    env = {
        k: v for k, v in os.environ.items() if not k.startswith("PYTEST")
    }
    env["PYTHONPATH"] = str(REPO)
    r = subprocess.run(
        [sys.executable, "-c", _CODE], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert r.returncode == 0, r.stdout + r.stderr[-3000:]
    assert r.stdout.strip().endswith("ok"), r.stdout


_NO_GRPC_CODE = r"""
import asyncio, os, signal, sys
for name in ("jax", "grpc", "google.protobuf"):
    sys.modules[name] = None
from throttlecrab_tpu_torch.server.__main__ import run_server
from throttlecrab_tpu_torch.server.config import Config

path = sys.argv[1]
cfg = Config.from_env_and_args([
    "--http", "--http-host", "127.0.0.1", "--http-port", "0",
    "--device", "cpu", "--store-capacity", "64", "--snapshot-path", path,
    "--checkpoint-dir", path + ".ck",
])

async def main():
    task = asyncio.create_task(run_server(cfg))
    await asyncio.sleep(1.0)
    os.kill(os.getpid(), signal.SIGTERM)
    await asyncio.wait_for(task, 60)

asyncio.run(main())
assert os.path.exists(path + ".npz")
assert os.path.exists(path + ".ck/ckpt-000000000000-base.tck")
leaked = sorted(m for m in sys.modules if m.startswith(("throttlecrab_tpu.",
                                                       "grpc.")))
assert not leaked, leaked
print("ok")
"""


def test_http_server_boots_and_saves_without_grpc(tmp_path):
    env = {
        k: v for k, v in os.environ.items() if not k.startswith("PYTEST")
    }
    env["PYTHONPATH"] = str(REPO)
    r = subprocess.run(
        [sys.executable, "-c", _NO_GRPC_CODE, str(tmp_path / "state")],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300,
    )
    assert r.returncode == 0, r.stdout + r.stderr[-3000:]
    assert r.stdout.strip().endswith("ok"), r.stdout


def test_new_modules_name_no_jax_package_in_an_import():
    """No module of the port — the mesh's among them — names `jax` or
    `throttlecrab_tpu` in an import statement (docstrings may name the
    counterpart file)."""
    import ast

    pkg = REPO / "throttlecrab_tpu_torch"
    files = sorted(pkg.rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert pkg / "parallel" / "sharded.py" in files
    for path in files:
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            for name in names:
                root = name.split(".")[0]
                assert root not in ("jax", "jaxlib", "throttlecrab_tpu"), (
                    path, name)


_ANALYSIS_CODE = r"""
import sys
sys.modules["jax"] = None
import throttlecrab_tpu_torch.analysis as analysis
import throttlecrab_tpu_torch.analysis.__main__  # the CLI's module
findings = analysis.run_all(sys.argv[1])
assert findings, "the suite checked nothing"
heavy = sorted(m for m in ("torch", "numpy", "jax")
               if sys.modules.get(m) is not None)
assert not heavy, heavy
leaked = sorted(
    m for m in sys.modules
    if m == "throttlecrab_tpu" or m.startswith("throttlecrab_tpu.")
)
assert not leaked, leaked
print("ok")
"""


def test_analysis_stands_alone():
    """The port's invariant suite imports and runs over the repo with
    `sys.modules["jax"] = None` and loads none of torch, numpy, jax or
    the JAX package; no module of it names `throttlecrab_tpu` (nor
    torch, numpy or jax) in an import statement."""
    import ast

    env = {
        k: v for k, v in os.environ.items() if not k.startswith("PYTEST")
    }
    env["PYTHONPATH"] = str(REPO)
    r = subprocess.run(
        [sys.executable, "-c", _ANALYSIS_CODE, str(REPO)], cwd=REPO,
        env=env, capture_output=True, text=True, timeout=120,
    )
    assert r.returncode == 0, r.stdout + r.stderr[-3000:]
    assert r.stdout.strip().endswith("ok"), r.stdout
    files = sorted((REPO / "throttlecrab_tpu_torch" / "analysis").glob("*.py"))
    assert len(files) == 15, files
    for path in files:
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            for name in names:
                assert name.split(".")[0] not in (
                    "throttlecrab_tpu", "torch", "numpy", "jax"), (path, name)
