"""The port's kernel-ablation probe (`tools/probe_kernel_ablation.py`) on
the CPU, against the JAX script it ports (`scripts/probe_kernel_ablation.py`,
its functions loaded without running it).

On the CPU every arm runs its plain version, so these tests hold what
the probe decides, prints and counts, not what it times: every body
mode's scan and both output-size variants of (e) equal the JAX script's
own scans on the same numpy inputs, and the kernel arm (the window
kernel's plain version, `kernel.decide_window`) equals JAX's composed
`gcra_scan_packed` in both tiers.  Tolerance: exact (integer outputs and
table state).  The printed lines follow JAX's labels, the report carries
the card line and the launch counts, and without a card asking for cuda
raises.  tests/test_torch_card.py runs the kernel arms on the card.
"""

import json
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from throttlecrab_tpu.tpu.kernel import gcra_scan_packed
from throttlecrab_tpu_torch.tools import card
from throttlecrab_tpu_torch.tools import probe_kernel_ablation as ka
from torch_jax_scripts import load_script

CPU = torch.device("cpu")

# (K, B, cap): distinct slots, and a table smaller than a sub-batch, so
# every sub-batch repeats slots.
SHAPES = [(4, 64, 4096), (3, 128, 64)]
# The kernel arm's table must hold a sub-batch: as small as one.
KERNEL_SHAPES = [(4, 64, 4096), (3, 64, 64)]


def _jax(B):
    return load_script("probe_kernel_ablation", B=B, NOW=ka.NOW)


def _jax_inputs(K, B, cap):
    """The inputs as the JAX script's `run` draws them, line for line."""
    rng = np.random.default_rng(3)
    return (rng.integers(0, cap - 1, (K, B)).astype(np.int32),
            np.full((K, B), 20_000_000, np.int64),
            np.full((K, B), 1_000_000_000, np.int64),
            np.full(K, ka.NOW, np.int64))


def _port_first(arm):
    out = arm()
    return out.numpy(), arm.state.numpy()


def _jax_first(js, scan, K, B, cap):
    state, out = scan(js.make_state(cap),
                      *(jnp.asarray(a) for a in _jax_inputs(K, B, cap)))
    return np.asarray(out), np.asarray(state)


@pytest.mark.parametrize("K,B,cap", SHAPES)
def test_inputs_are_jax_draws(K, B, cap):
    for a, b in zip(ka.inputs(cap, K, B), _jax_inputs(K, B, cap)):
        np.testing.assert_array_equal(a, b)
        assert a.dtype == b.dtype


@pytest.mark.parametrize("mode", ka.MODES)
@pytest.mark.parametrize("K,B,cap", SHAPES)
def test_body_mode_equals_jax_make_scan(K, B, cap, mode):
    js = _jax(B)
    out, state = _port_first(ka.Arm(CPU, cap, K, B, ka.make_scan(mode)))
    j_out, j_state = _jax_first(js, js.make_scan(mode), K, B, cap)
    assert out.dtype == j_out.dtype and out.shape == j_out.shape == (K, B)
    np.testing.assert_array_equal(out, j_out)
    np.testing.assert_array_equal(state, j_state)


@pytest.mark.parametrize("small", [False, True])
@pytest.mark.parametrize("K,B,cap", SHAPES)
def test_output_size_scans_equal_jax(K, B, cap, small):
    js = _jax(B)
    out, state = _port_first(
        ka.Arm(CPU, cap, K, B, ka.make_scan_outsize(small)))
    j_out, j_state = _jax_first(js, js.make_scan_outsize(small), K, B, cap)
    assert out.dtype == j_out.dtype and out.shape == j_out.shape
    assert out.shape == ((K, B) if small else (K, 4, B))
    np.testing.assert_array_equal(out, j_out)
    np.testing.assert_array_equal(state, j_state)


@pytest.mark.parametrize("compact,label", ka.TIERS)
@pytest.mark.parametrize("K,B,cap", KERNEL_SHAPES)
def test_kernel_arm_equals_jax_composed_window(K, B, cap, compact, label):
    js = _jax(B)
    launcher = ka.Launcher()
    out, state = _port_first(ka.kernel_arm(CPU, cap, K, B, launcher, compact))
    assert launcher.count == 1
    slots, em, tol, now = _jax_inputs(K, B, cap)
    j_state, j_out = gcra_scan_packed(
        js.make_state(cap), jnp.asarray(ka.kernel_packed(slots, em, tol)),
        jnp.asarray(now), with_degen=False, compact=compact)
    np.testing.assert_array_equal(out, np.asarray(j_out))
    np.testing.assert_array_equal(state, np.asarray(j_state))


SMALL = dict(cap=4096, K=4, B=64, caps=(1024, 4096), depths=(2, 4))

LABEL = {
    "run": r"cap=2\^[ \d]\d K=[ \d]{3}\d (full|noscatter|nogather|"
           r"elementwise) *: +\d+\.\d\d ms/launch  \( *\d+\.\d\d M dec/s\)",
    "d": r"d\) d2h +\d+ MB first fetch: +\d+\.\d\d ms \( *\d+\.\d MB/s\)",
    "e": r"e\) (i32 full compact|i8 allowed-only ) out= *\d+\.\d MB: +"
         r"\d+\.\d\d ms/launch \( *\d+\.\d\d M dec/s\)",
}


def test_run_prints_jax_labels_and_counts_its_windows():
    lines = []
    report = ka.run(CPU, d2h_mb=(1,), out=lines.append, **SMALL)
    heads = [ln for ln in lines if ln.startswith("---")]
    assert heads[:5] == [
        "--- kernel body ablation (cap=2^12, K=4) ---",
        "--- table size (full, K=4) ---",
        "--- scan depth (full, cap=2^12) ---",
        "--- d2h first-fetch cost by size ---",
        "--- launch cost vs output size (K=4) ---",
    ]
    runs = [ln for ln in lines if re.match(LABEL["run"], ln)]
    assert len(runs) == len(ka.MODES) + 2 + 2
    assert [re.match(LABEL["run"], ln).group(1) for ln in runs[:4]] == list(
        ka.MODES)
    assert sum(bool(re.match(LABEL["d"], ln)) for ln in lines) == 1
    assert sum(bool(re.match(LABEL["e"], ln)) for ln in lines) == 2
    assert sum(ln.startswith("k) ") for ln in lines) == len(ka.TIERS)
    assert all("device not measured" in ln for ln in runs)
    # first + 1 + 4 timed scans per tier; the profiler does not run on cpu
    assert report["launches_counted"] == 6 * len(ka.TIERS)
    assert report["fused_launches_before"] == report["fused_launches_after"]
    assert report["card"] == card.card_line(CPU)
    assert report["ablation"]["full"]["device_ms"] is None
    assert report["d2h"]["1"]["pinned_ms"] is None
    assert set(report["first"]) == set(ka.first_scans(CPU, **SMALL))
    assert report["first"] == ka.first_scans(CPU, **SMALL)


def test_main_checks_its_first_scans_against_the_cpu(monkeypatch, capsys):
    for name, value in (("CAP", 4096), ("K", 3), ("B", 64),
                        ("CAPS", (4096,)), ("DEPTHS", (3,)),
                        ("D2H_MB", (1,))):
        monkeypatch.setattr(ka, name, value)
    assert ka.main(["--cpu", "--check-cpu"]) == 0
    report = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert report["first_equals_cpu"] is True
    assert (report["platform"], report["K"], report["B"]) == ("cpu", 3, 64)
    for key in ("card", "launches_counted", "fused_launches_before",
                "fused_launches_after", "kernel", "outsize", "d2h"):
        assert key in report


def test_check_first_names_the_arm_that_differs():
    a = {"x": {"out": "1", "state": "2"}, "y": {"out": "3", "state": "4"}}
    card.check_first(a, dict(a), "same")
    with pytest.raises(AssertionError, match=r"\['y'\]"):
        card.check_first(a, {**a, "y": {"out": "3", "state": "5"}}, "diff")


def test_device_ms_reads_not_measured_on_the_cpu():
    calls = []
    assert card.device_ms(CPU, lambda: calls.append(1)) == (None, 0)
    assert calls == []


def test_the_probe_asks_for_the_card_by_default():
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ka.main([])
