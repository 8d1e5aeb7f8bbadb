"""The port's CI gates and transport driver on the CPU, against the JAX
package's scripts of the same names: `tools/replay_determinism.py`
(`scripts/replay_determinism.py`), `tools/control_determinism.py`
(`scripts/control_determinism.py`) and `tools/run-transport-test.sh`
(`scripts/run-transport-test.sh`).

The replay gate's recording must be the JAX script's byte for byte (its
`record_workload`, loaded by path as tests/test_torch_tier_fuzz.py loads
the campaign), and its count of window launches must be the limiter's
own count of conflict rounds.  The control gate's actuation logs, its
`rank_json` rankings and its PASS line must equal JAX's on the same
trace.  The transport driver must serve a run on the port's server with
no error, and refuse -t grpc / -t all before booting when grpcio cannot
be imported.  Tolerance everywhere: exact equality.
"""

import asyncio
import importlib.util
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

import throttlecrab_tpu.control as jax_control
from throttlecrab_tpu_torch.replay.trace import Trace, Window
from throttlecrab_tpu_torch.tools import control_determinism as port_ctl
from throttlecrab_tpu_torch.tools import replay_determinism as port_rd
from throttlecrab_tpu_torch.tpu.limiter import derive_params, param_rounds

REPO = pathlib.Path(__file__).resolve().parent.parent
DRIVER = REPO / "throttlecrab_tpu_torch" / "tools" / "run-transport-test.sh"
CPU = torch.device("cpu")


def _jax_script(name):
    spec = importlib.util.spec_from_file_location(
        f"jax_{name}", REPO / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("windows", [3, 8])
def test_replay_recording_bytes_equal_jax(windows, tmp_path):
    jax_rd = _jax_script("replay_determinism")
    asyncio.run(jax_rd.record_workload(str(tmp_path / "jax.tctr"), windows))
    asyncio.run(port_rd.record_workload(str(tmp_path / "port.tctr"), windows,
                                        CPU))
    want = (tmp_path / "jax.tctr").read_bytes()
    assert (tmp_path / "port.tctr").read_bytes() == want
    assert len(Trace.load(str(tmp_path / "port.tctr")).windows) == windows


def test_replay_gate_passes_on_cpu(capsys):
    assert port_rd.main(["--cpu", "--windows", "8"]) == 0
    out = capsys.readouterr().out.strip().splitlines()
    assert out == ["PASS: 8 windows / 512 rows — replay x2 byte-identical, "
                   "recorded-equal, oracle-exact"]
    rc, counts, _ = port_rd.run(8, CPU)
    # the plain version launches no kernel; every window is one round
    assert rc == 0 and counts == {"expected_launches": 24, "launches": 0}


def _rounds_by_limiter(window):
    """Conflict rounds as TorchRateLimiter.rate_limit_batch counts them."""
    p = np.asarray(window.params, np.int64)
    em, tol, invalid = derive_params(p[:, 0], p[:, 1], p[:, 2])
    valid = ~invalid & (p[:, 3] >= 0)
    ids = {}
    slots = np.array([ids.setdefault(k, len(ids)) for k in window.keys])
    rounds = param_rounds(np.zeros(len(slots), np.int64), slots,
                          np.flatnonzero(valid), em, tol, p[:, 3])
    return int(rounds[valid].max()) + 1 if valid.any() else 0


@pytest.mark.parametrize("seed", range(6))
def test_conflict_rounds_match_the_limiter(seed):
    rng = np.random.default_rng(seed)
    n = 64
    params = np.stack([
        rng.choice([3, 4, 0], n, p=[0.45, 0.45, 0.1]),  # burst 0 is invalid
        np.full(n, 10), rng.choice([60, 30], n), rng.choice([1, 2], n),
    ], axis=1).astype(np.int64)
    keys = [b"k%d" % k for k in rng.integers(0, 6, n)]
    window = Window(
        now_ns=1, source=0, keys=keys, params=params,
        allowed=np.zeros(n, np.uint8), status=np.zeros(n, np.uint8),
        tenants=np.zeros(n, np.uint16))
    assert port_rd.conflict_rounds(window) == _rounds_by_limiter(window)
    assert port_rd.conflict_rounds(window) > 1


def _spy_control(monkeypatch, module, log):
    """Record every armed run's actuation log and every rank_json."""
    base, base_rank_json = module.ControlReplayer, module.rank_json

    class Spy(base):
        def run(self):
            res = super().run()
            log.append(("log", json.dumps(res.actuation_log, sort_keys=True)))
            return res

    def spy_rank_json(ranking):
        out = base_rank_json(ranking)
        log.append(("rank", out))
        return out

    monkeypatch.setattr(module, "ControlReplayer", Spy)
    monkeypatch.setattr(module, "rank_json", spy_rank_json)


def test_control_gate_equals_jax(monkeypatch, capsys):
    jax_log, port_log = [], []
    _spy_control(monkeypatch, jax_control, jax_log)
    _spy_control(monkeypatch, port_ctl, port_log)
    monkeypatch.setattr(sys, "argv", ["control_determinism.py",
                                      "--windows", "8"])
    assert _jax_script("control_determinism").main() == 0
    want = capsys.readouterr().out
    assert port_ctl.main(["--windows", "8"]) == 0
    got = capsys.readouterr().out
    assert got == want and got.startswith("PASS: 8 windows / 4096 rows")
    # two armed runs, two rankings, one controller-off run
    assert [kind for kind, _ in port_log] == ["log", "log", "rank", "rank",
                                              "log"]
    assert port_log == jax_log
    assert json.loads(port_log[0][1])


def _driver(*args, env=None, timeout=300):
    return subprocess.run(["bash", str(DRIVER), *args], capture_output=True,
                          text=True, timeout=timeout, cwd=REPO, env=env)


def test_transport_driver_serves_http_on_cpu():
    r = _driver("-t", "http", "--cpu", "-T", "2", "-r", "20")
    assert r.returncode == 0, r.stderr[-3000:]
    lines = r.stdout.strip().splitlines()
    assert lines[-1] == "done"
    summary = json.loads(lines[-2])
    assert summary["transport"] == "http"
    assert summary["requests"] == 40 and summary["errors"] == 0
    assert summary["allowed"] + summary["denied"] == 40


@pytest.mark.parametrize("transport", ["grpc", "all"])
def test_transport_driver_refuses_grpc_without_grpcio(transport, tmp_path):
    (tmp_path / "sitecustomize.py").write_text(
        'import sys\nsys.modules["grpc"] = None\n')
    env = dict(os.environ, PYTHONPATH=str(tmp_path))
    r = _driver("-t", transport, "--cpu", env=env, timeout=60)
    assert r.returncode == 2
    assert "grpcio" in r.stderr and r.stdout == ""


def test_transport_driver_rejects_unknown_flags():
    r = _driver("--bogus", timeout=30)
    assert r.returncode == 2 and "unknown arg: --bogus" in r.stderr
    r = _driver("-t", "carrier-pigeon", timeout=30)
    assert r.returncode == 2 and "unknown transport" in r.stderr
