"""The program's spans in a traced run (`portbench/spans.py`): on the CPU
the host split of the tiny cell, beside the harness's own readings; on
the card the device split, held to the harness's trace.  The card test
skips where there is no CUDA card (decided in the fixture)."""

import math

import pytest

from portbench import run, spans
from portbench.tests.tiny import BENCH, TINY_CONFIG, TINY_MIX, make_root

HOST = {"ids.prepare_ms", "ids.launch_wait_ms", "ids.front_host_ms",
        "ids.window_host_ms", "finish.w32_span_ms"}
DEVICE = {"ids.front_gather_device_ms", "ids.front_segments_device_ms",
          "ids.front_pack_device_ms"}


def recorded(tmp_path, device, seconds, seed=3):
    return spans.record_run(run.run_cell, make_root(tmp_path), "tiny", seed,
                            seconds, device=device, log=lambda *a, **k: None)


def test_the_tiny_cell_recorded_on_the_cpu(tmp_path):
    out = recorded(tmp_path, "cpu", 0.6)
    assert out["correct"], out["compared"]
    # The harness reads what it reads without the recording.
    assert set(out["metrics"]) == {m["name"] for m in BENCH["per_layer"]
                                   if m["source"] != "device_trace"}
    s = out["spans"]
    assert set(s) == HOST | {"launch_ms", "launches_recorded",
                             "launch_shapes", "ids.prepare_upload_share"}
    assert s["launches_recorded"] == out["info"]["launches_timed"]
    # What the prepare spans noted: every launch's shape, and no upload
    # (nothing leaves the host on the CPU).
    assert s["launch_shapes"] == [(TINY_MIX["depth"], TINY_CONFIG["batch"])]
    assert s["ids.prepare_upload_share"] == 0.0
    assert all(s[k] >= 0 for k in HOST)
    staged = s["ids.prepare_ms"] + s["ids.front_host_ms"] \
        + s["ids.window_host_ms"]
    assert staged <= out["metrics"]["ids.dispatch_ms"]["value"]


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the device split reads the card's "
                    "trace")


@pytest.mark.cuda
def test_the_tiny_cell_recorded_on_the_card(card, tmp_path):
    plain = run.run_cell(make_root(tmp_path / "plain"), "tiny", 11, 1.0,
                         True, device="cuda", log=lambda *a, **k: None)
    out = recorded(tmp_path / "spans", "cuda", 1.0, seed=11)
    assert out["correct"], out["compared"]
    s, c = out["spans"], out["spans"]["checks"]
    assert set(s) >= HOST | DEVICE
    # The loop copies the inputs to the card itself: no launch uploads.
    assert s["ids.prepare_upload_share"] == 0.0
    # The annotations were there and none was counted as a record.
    assert c["annotations_skipped"] > 0
    assert c["kernels_a_launch"] == plain["info"]["kernels_a_launch"]
    # Every kernel record falls under one innermost span of the program,
    # the front end's stages and the window span's other records make up
    # the harness's front end, and the twins agree on the clock.
    assert c["kernel_records_outside"] == 0
    assert c["records_in_other_spans"] == []
    assert c["launches_twinned"] == c["launches_traced"]
    assert math.isclose(c["front_by_stage_ms"], c["front_device_ms"],
                        rel_tol=1e-6)
    assert 0 <= c["clock_disagreement_ns"] < 50_000
    gaps = dict(s["idle_gaps"])
    assert any(k.startswith("tc.") for k in gaps)
    idle = out["device"]["window_s"] - out["device"]["busy_s"]
    assert math.isclose(sum(gaps.values()), idle, rel_tol=1e-6,
                        abs_tol=1e-9)
