"""The port's tier-ladder differential campaign
(`throttlecrab_tpu_torch/tools/fuzz_wire_tiers.py`) on the CPU, at small
sizes, against the JAX package's campaign (`scripts/fuzz_wire_tiers.py`).

A few seeds of each arm run here, as tests/test_tier_fuzz.py runs the
JAX campaign's: the ladder seeds against the scalar oracle through the
single-device limiter, the wire window and the 2-shard CPU mesh; the
kernel-beside-plain alternation (here both sides are the plain version,
so it checks the twin's plumbing; tests/test_torch_card.py runs the same
seeds on the card); the hot-key deny-cache differential; the two codec
arms; and the full-width arm at a small width.  The same seeds then run
through both packages' campaigns, which must check the same values batch
by batch (tolerance: exact).  Last, a planted defect: with the
cross-launch certificate bookkeeping skipped, the hostile wide seed must
fail.
"""

import ast
import contextlib
import importlib.util
import pathlib
import subprocess
import sys

import numpy as np
import pytest

from throttlecrab_tpu_torch.parallel import sharded as port_sharded
from throttlecrab_tpu_torch.tools import fuzz_wire_tiers as fz
from throttlecrab_tpu_torch.tpu import table as port_table
from throttlecrab_tpu_torch.tpu.limiter import TorchRateLimiter

REPO = pathlib.Path(__file__).resolve().parent.parent

_SPEC = importlib.util.spec_from_file_location(
    "jax_fuzz_wire_tiers", REPO / "scripts" / "fuzz_wire_tiers.py"
)
jax_fz = importlib.util.module_from_spec(_SPEC)
_SPEC.loader.exec_module(jax_fz)

LADDER_SEEDS = [3000, 3001, 3002]  # benign / edges / hostile


@pytest.fixture
def cpu_mesh():
    return fz.campaign_mesh("cpu")


@pytest.mark.parametrize("seed", LADDER_SEEDS)
def test_tier_ladder_fuzz_slice(seed, cpu_mesh):
    before = dict(fz.TOTAL)
    fz.run_seed(seed, steps=8, sharded_mesh=cpu_mesh, device="cpu")
    assert fz.TOTAL["requests"] > before["requests"]
    assert fz.TOTAL["card_windows"] == before["card_windows"]


def _recorder(module, log):
    """Wrap `module`'s check and tier_of to append what each checks."""
    check, tier_of = module.check, module.tier_of
    last = {}

    def rec_tier(handle):
        last["tier"] = tier_of(handle)
        return last["tier"]

    def rec_check(res, want, ctx):
        ok = ~want["bad"]
        log.append((
            ctx, None if ctx.endswith("native-wire") else last.get("tier"),
            *(np.asarray(getattr(res, f))[ok].tolist() for f in (
                "allowed", "remaining", "reset_after_s", "retry_after_s")),
        ))
        return check(res, want, ctx)

    return rec_check, rec_tier


@pytest.mark.parametrize("seed", LADDER_SEEDS)
def test_campaign_checks_what_jax_checks(seed, cpu_mesh, monkeypatch):
    """Both packages' run_seed at one seed, with the 2-shard mesh (JAX's
    composed one, its fused path off): the same (context, tier, allowed,
    remaining, reset_s, retry_s) for every checked batch, exactly."""
    from conftest import require_devices

    monkeypatch.setenv("THROTTLECRAB_PALLAS_FUSED", "0")
    require_devices(2)
    from throttlecrab_tpu.parallel.sharded import make_mesh

    logs = {}
    for name, module, mesh, kw in (
        ("jax", jax_fz, make_mesh(2), {}),
        ("port", fz, cpu_mesh, {"device": "cpu"}),
    ):
        logs[name] = []
        check, tier_of = _recorder(module, logs[name])
        monkeypatch.setattr(module, "check", check)
        monkeypatch.setattr(module, "tier_of", tier_of)
        module.run_seed(seed, 8, mesh, **kw)
    assert len(logs["port"]) > 8
    assert {e[1] for e in logs["port"]} - {None}
    assert logs["port"] == logs["jax"]


@pytest.mark.parametrize("seed", [3100, 3101])  # edges / hostile
def test_alternation_twin_on_cpu(seed, cpu_mesh):
    """alternate=True beside a device="cpu" twin, with the mesh; odd seeds
    arm the insight tier on the single-device limiter (6-wide rows)."""
    before = fz.TOTAL["requests"]
    fz.run_seed(seed, steps=6, sharded_mesh=cpu_mesh, alternate=True,
                insight_single=bool(seed % 2), device="cpu")
    assert fz.TOTAL["requests"] > before


def test_twin_state_check_sees_one_row():
    """same_state fails on one differing row, and hand_over repairs it."""
    a, b = (TorchRateLimiter(capacity=64, device="cpu") for _ in range(2))
    batch = [(["k1", "k2", "k1"], 5, 1, 60, 1, fz.T0)]
    for lim in (a, b):
        lim.dispatch_many(batch, wire=True).fetch()
    fz.same_state(a, b, "equal")
    b.table.state[3, 0] += 1
    with pytest.raises(AssertionError, match="rows differ"):
        fz.same_state(a, b, "one row")
    fz.hand_over(a, b)
    fz.same_state(a, b, "handed over")


def test_hotkey_abuse_deny_cache_slice():
    before = fz.TOTAL["requests"]
    hits = fz.run_hotkey_deny_seed(4000, steps=24, device="cpu")
    assert fz.TOTAL["requests"] > before
    assert hits > 0


@pytest.mark.parametrize("seed", [6000, 6001])
def test_trace_codec_fuzz_slice(seed):
    assert fz.run_trace_frame_fuzz(seed, iters=250, device="cpu") == 250


def test_cluster_frame_fuzz_slice():
    assert fz.run_cluster_frame_fuzz(5000, iters=400, device="cpu") == 400


@pytest.mark.parametrize("seed", LADDER_SEEDS)
def test_wide_seed_at_small_width(seed):
    rec = fz.run_wide_seed(seed, 4, capacity=1 << 12, n_keys=3000, k=2,
                           b=256, device="cpu")
    assert rec["requests"] == 4 * 2 * 256
    assert sum(sum(t.values()) for t in rec["tiers"].values()) == 4
    assert 0 < rec["snapshot"]["restored"] <= rec["snapshot"]["keys"]
    assert rec["rows_gathered"] == rec["snapshot"]["keys"]
    assert rec["row_gather"] == rec["row_scatter"] == rec["launches"] == 0


def _skip_certificate_bookkeeping(monkeypatch):
    """The planted defect: no launch or restore moves tol_hwm, now_hwm or
    the sticky cur_safe."""
    monkeypatch.setattr(port_table.HwmMarksMixin, "note_max_tolerance",
                        lambda self, max_tol: None)
    monkeypatch.setattr(port_table.HwmMarksMixin, "note_launch_now",
                        lambda self, now_ns: None)
    for module in (port_table, port_sharded):
        monkeypatch.setattr(module, "track_cur_safety", lambda *a: None)


@pytest.mark.parametrize("planted", [False, True], ids=["clean", "defect"])
def test_skipped_certificate_bookkeeping_fails_the_hostile_seed(
    planted, monkeypatch
):
    """The hostile wide seed at K = 16 x B = 4096 over 3,000 keys: clean it
    passes; with the bookkeeping skipped, the windows after the fleet's
    reconfiguration ride w32 over TATs written under the old limits, and
    the campaign reports the divergence."""
    expect = contextlib.nullcontext()
    if planted:
        _skip_certificate_bookkeeping(monkeypatch)
        expect = pytest.raises(AssertionError, match="diverged")
    with expect:
        fz.run_wide_seed(3002, 4, capacity=1 << 12, n_keys=3000, device="cpu")


def test_cli_on_cpu_passes_with_every_tier():
    proc = subprocess.run(
        [sys.executable, "-m", "throttlecrab_tpu_torch.tools.fuzz_wire_tiers",
         "--device", "cpu", "--seeds", "3", "--steps", "8"],
        cwd=REPO, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr[-2000:]
    last = proc.stdout.strip().splitlines()[-1]
    assert last.startswith("PASS: ")
    tiers = ast.literal_eval(last.split("tier mix ")[1])
    assert set(tiers) == {"w32", "cur", "planes"}
    assert min(tiers.values()) > 0


def test_cuda_without_a_card_raises():
    """The default device is cuda; without a card every arm raises, and
    nothing falls back to the CPU."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    for call in (
        lambda: fz.main([]),
        lambda: fz.main(["--no-sharded"]),
        lambda: fz.run_hotkey_deny_seed(4000, 2),
        lambda: fz.run_trace_frame_fuzz(6000, 1),
        lambda: fz.run_cluster_frame_fuzz(5000, 1),
        lambda: fz.run_wide_seed(3000, 1, capacity=1 << 12, n_keys=16),
    ):
        with pytest.raises(RuntimeError, match="cuda"):
            call()
