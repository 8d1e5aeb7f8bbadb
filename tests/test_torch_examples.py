"""The port's examples (`throttlecrab_tpu_torch/examples/`) on the CPU,
against the JAX package's `examples/` of the same names.

Each port example runs with `--cpu` (the plain version); its decision
lines — every line, with the times and rates a line prints masked —
must equal the JAX example's on the same inputs (tolerance: exact).
`access_patterns` and `store_comparison` run at a smaller size, their
module constants shrunk alike on both sides.  `capacity_test`, whose
JAX run recompiles at every growth step (over 10 s here), is held
against the scalar oracle `core/` and the table's doubling rule instead,
and `performance_demo` (which prints only counts and times) against its
counts.  The two clients run against the port's server, booted twice
(once for the port's example, once for the JAX one), and must print the
same lines.  No example does any work when imported, and `grpc_client`
imports without grpcio.
"""

import contextlib
import importlib.util
import io
import os
import pathlib
import re
import signal
import socket
import subprocess
import sys
import time
import urllib.request

import pytest

from throttlecrab_tpu_torch import PeriodicStore, RateLimiter
from throttlecrab_tpu_torch.examples import (
    access_patterns,
    basic,
    batch_tpu,
    byid_launch,
    capacity_test,
    grpc_client,
    http_client,
    performance_demo,
    sharded_mesh,
    store_comparison,
)
from throttlecrab_tpu_torch.tpu.limiter import TorchRateLimiter

REPO = pathlib.Path(__file__).resolve().parent.parent
FIXED_NOW = 1_760_000_000_123_456_789
TIMED = re.compile(
    r" *[\d,]+(\.\d+)? (decisions/s|req/s)|\([\d.]+ (us|ns)/req\)|in [\d.]+s")


def _jax_example(name):
    spec = importlib.util.spec_from_file_location(
        f"jax_example_{name}", REPO / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _stdout(fn, *args):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = fn(*args)
    assert rc in (None, 0)
    return buf.getvalue()


def _decisions(text):
    return [TIMED.sub("#", line) for line in text.splitlines()]


def _run_jax(monkeypatch, mod, argv=("--cpu",)):
    monkeypatch.setattr(sys, "argv", [f"{mod.__name__}.py", *argv])
    return _stdout(mod.main)


@pytest.fixture
def fixed_clock(monkeypatch):
    monkeypatch.setattr(time, "time_ns", lambda: FIXED_NOW)


@pytest.mark.parametrize("name,port", [
    ("basic", basic), ("batch_tpu", batch_tpu), ("byid_launch", byid_launch),
])
def test_example_equals_jax(name, port, fixed_clock, monkeypatch):
    want = _run_jax(monkeypatch, _jax_example(name))
    got = _stdout(port.main, [] if name == "basic" else ["--cpu"])
    assert got == want
    assert got.count("\n") == {"basic": 7, "batch_tpu": 4,
                               "byid_launch": 3}[name]


@pytest.mark.parametrize("name,port,size", [
    ("access_patterns", access_patterns,
     {"N_KEYS": 1000, "BATCH": 128, "BATCHES": 8}),
    ("store_comparison", store_comparison,
     {"N_KEYS": 2000, "BATCH": 128, "BATCHES": 8}),
])
def test_example_decisions_equal_jax_at_small_size(name, port, size,
                                                   monkeypatch):
    jax_mod = _jax_example(name)
    for attr, value in size.items():
        monkeypatch.setattr(jax_mod, attr, value)
        monkeypatch.setattr(port, attr, value)
    want = _decisions(_run_jax(monkeypatch, jax_mod))
    got = _decisions(_stdout(port.main, ["--cpu"]))
    assert got == want and len(got) in (3, 4)
    assert all(line.count("#") == 1 for line in got)


def test_sharded_mesh_decisions_equal_jax(fixed_clock, monkeypatch):
    want = _run_jax(monkeypatch, _jax_example("sharded_mesh")).splitlines()
    got = _stdout(sharded_mesh.main, ["--cpu"]).splitlines()
    assert got[0] == "mesh: 1 shard(s) on ['cpu']"
    # JAX's mesh has 8 virtual CPU devices here, the port's one: the
    # decisions and the global counters do not depend on the split.
    assert got[1:] == want[1:] == ["8192/8192 allowed",
                                   "global allowed=8192 denied=0"]


def _oracle_lines():
    """capacity_test's lines from the scalar oracle: the live and freed
    counts from each key's bucket expiry, the capacity from the table's
    doubling growth."""
    ns, t0 = capacity_test.NS, capacity_test.T0
    oracle = RateLimiter(PeriodicStore())
    cap = 1024
    lines = [f"initial capacity: {cap} slots ({cap * 16 // 1024} KiB HBM)"]
    expiry = {}
    n = 10_240
    for prefix, now in (("burst_key_", t0), ("second_wave_", t0 + 3601 * ns)):
        for i in range(n):
            ok, res = oracle.rate_limit(f"{prefix}{i}", 10, 100, 60, 1, now)
            assert ok
            expiry[f"{prefix}{i}"] = now + res.reset_after_ns
        live = sum(e > now for e in expiry.values())
        before = cap
        while cap < live:
            cap *= 2
        if prefix == "burst_key_":
            lines.append(f"after {n} unique keys: capacity={cap}, "
                         f"live={live}")
            sweep_at = t0 + 3600 * ns
            freed = sum(e <= sweep_at for e in expiry.values())
            expiry = {k: e for k, e in expiry.items() if e > sweep_at}
            lines.append(f"sweep at +1h freed {freed} slots; "
                         f"live={len(expiry)}")
        else:
            lines.append(f"second wave of {n} keys reused slots: capacity "
                         f"{before} -> {cap} (no growth)")
    lines += ["", f"memory model: {cap * 16 // 1024} KiB HBM for {cap} slots "
              "(16 B/slot) + host keymap (~60 B + key bytes per live key)"]
    return lines


def test_capacity_test_equals_the_scalar_oracle():
    got = _stdout(capacity_test.main, ["--cpu"]).splitlines()
    assert got == _oracle_lines()


def test_performance_demo_counts():
    """The demo's two parts at a small size (main's 2,000 scalar launches
    take seconds on the plain version)."""
    limiter = TorchRateLimiter(capacity=1 << 15, keymap="auto", device="cpu")
    got = _decisions(_stdout(performance_demo.demo_scalar, limiter,
                             FIXED_NOW, 50))
    assert got[1:] == ["Scalar API (one device launch per decision)",
                       "-" * 44, "50 decisions # -># #"]
    assert len(limiter) == 150
    got = _decisions(_stdout(performance_demo.demo_batched, limiter,
                             FIXED_NOW, 64, 3))
    assert got[1:] == ["Batch API (64 decisions per launch)", "-" * 44,
                       "192 decisions # -># #"]


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@contextlib.contextmanager
def _server():
    """The port's server on the CPU with HTTP and gRPC on free ports."""
    http_port, grpc_port = _free_port(), _free_port()
    proc = subprocess.Popen(
        [sys.executable, "-m", "throttlecrab_tpu_torch.server", "--http",
         "--http-host", "127.0.0.1", "--http-port", str(http_port), "--grpc",
         "--grpc-host", "127.0.0.1", "--grpc-port", str(grpc_port),
         "--device", "cpu", "--log-level", "warn"],
        cwd=REPO, stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
    try:
        deadline = time.monotonic() + 60
        while True:
            assert proc.poll() is None, "the server exited at boot"
            try:
                urllib.request.urlopen(
                    f"http://127.0.0.1:{http_port}/health", timeout=1)
                break
            except OSError:
                assert time.monotonic() < deadline, "no /health in 60 s"
                time.sleep(0.2)
        yield http_port, grpc_port
    finally:
        proc.send_signal(signal.SIGTERM)
        proc.wait(timeout=60)


def test_clients_equal_jax_against_the_port_server(monkeypatch):
    outs = []
    jax_http, jax_grpc = _jax_example("http_client"), _jax_example(
        "grpc_client")
    for side in ("port", "jax"):
        with _server() as (http_port, grpc_port):
            url, target = f"http://127.0.0.1:{http_port}", \
                f"127.0.0.1:{grpc_port}"
            if side == "port":
                outs.append(_stdout(http_client.main, ["--url", url])
                            + _stdout(grpc_client.main, ["--target", target]))
            else:
                outs.append(
                    _run_jax(monkeypatch, jax_http, ["--url", url])
                    + _run_jax(monkeypatch, jax_grpc, ["--target", target]))
    assert outs[0] == outs[1]
    assert "request 11: DENIED (retry after" in outs[0]
    assert "throttlecrab_requests_total 18" in outs[0]
    assert "request 6: DENIED" in outs[0]


def test_examples_import_without_work_or_grpcio():
    code = (
        "import sys, importlib\n"
        "sys.modules['grpc'] = None\n"
        "import throttlecrab_tpu_torch.examples as ex\n"
        "for name in ('basic', 'batch_tpu', 'byid_launch', "
        "'access_patterns', 'capacity_test', 'store_comparison', "
        "'performance_demo', 'sharded_mesh', 'http_client', "
        "'grpc_client'):\n"
        "    importlib.import_module("
        "f'throttlecrab_tpu_torch.examples.{name}')\n"
        "try:\n"
        "    ex.grpc_client.main(['--target', '127.0.0.1:1'])\n"
        "except ImportError:\n"
        "    print('grpc needed only by main')\n")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=120, cwd=REPO,
                       env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert r.returncode == 0, r.stderr
    assert r.stdout == "grpc needed only by main\n"
