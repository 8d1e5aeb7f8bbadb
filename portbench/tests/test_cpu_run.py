"""The by-id loop end to end on device="cpu" at a tiny size, against the
reference; then the same run with the timed path broken underneath, and
the controls in the program's place, each of which must come out not
correct.  The harness's look for a card is skipped (`run_cell` is called
directly); the program runs its plain versions."""

import numpy as np
import pytest

from portbench import control, run
from portbench.tests.tiny import (
    BENCH,
    TINY_CONFIG,
    TINY_MIX,
    TINY_STRIDED_MIX,
    make_root,
)

SECONDS = 0.6
# Each fault on the plain mix and on config 3's (strided check).
MIXES = pytest.mark.parametrize("mix", [TINY_MIX, TINY_STRIDED_MIX],
                                ids=["plain", "strided"])


def quiet(*_a, **_k):
    pass


def tiny_run(tmp_path, seed=3, traced=False, config=None, mix=None):
    root = make_root(tmp_path, config=config, mix=mix)
    return run.run_cell(root, "tiny", seed, SECONDS, traced, device="cpu",
                        log=quiet)


def numbers(out):
    return {k: v["value"] for k, v in out["compared"].items()}


@pytest.mark.parametrize("seed", [3, 2**31 + 5])
def test_tiny_run_is_correct(tmp_path, seed):
    out = tiny_run(tmp_path, seed)
    assert out["correct"], out["compared"]
    assert out["info"]["lanes_checked"] > 1000
    assert set(out["metrics"]) == {m["name"] for m in BENCH["end_to_end"]}
    assert list(out)[-1] == "compared"


def test_tiny_traced_run_reports_host_spans(tmp_path):
    out = tiny_run(tmp_path, traced=True)
    assert out["correct"]
    # On the CPU the device metrics have nothing to read and stay out.
    assert set(out["metrics"]) == {m["name"] for m in BENCH["per_layer"]
                                   if m["source"] != "device_trace"}
    assert "finish.w32_ms" in out["metrics"]


def test_tiny_run_in_the_cur_tier_is_correct(tmp_path):
    out = tiny_run(tmp_path, config=dict(TINY_CONFIG, tier="cur"))
    assert out["correct"], out["compared"]


def test_same_seed_same_inputs(tmp_path):
    from portbench import generate
    from portbench.registry import Spec

    spec = Spec(make_root(tmp_path))
    cell = spec.cell("tiny")
    a, b = (generate.Schedule(spec.config(cell), spec.mix(cell), 9)
            for _ in range(2))
    assert all(np.array_equal(x, y) for x, y in zip(a.windows, b.windows))
    assert np.array_equal(generate.check_sample(a)[0],
                          generate.check_sample(b)[0])


# ---- the timed path broken underneath ------------------------------------


@MIXES
def test_a_launch_that_leaves_the_state_unchanged_fails(tmp_path, mix,
                                                        monkeypatch):
    from throttlecrab_tpu_torch.tpu.table import BucketTable

    inner = BucketTable._byid_launch

    def stale(self, *a, **k):
        before = self.state.clone()
        out = inner(self, *a, **k)
        self.state.copy_(before)
        return out

    monkeypatch.setattr(BucketTable, "_byid_launch", stale)
    out = tiny_run(tmp_path, mix=mix)
    assert not out["correct"]
    assert numbers(out)["lanes_wrong"] > 0 and numbers(out)["rows_wrong"] > 0


@MIXES
def test_half_of_each_batch_left_out_fails(tmp_path, mix, monkeypatch):
    from throttlecrab_tpu_torch.tpu.table import BucketTable

    inner = BucketTable.check_many_ids

    def half(self, id_rows, ids, *a, **k):
        ids = np.array(ids)
        ids[:, ids.shape[1] // 2:] = -1  # padding: never decided
        return inner(self, id_rows, ids, *a, **k)

    monkeypatch.setattr(BucketTable, "check_many_ids", half)
    out = tiny_run(tmp_path, mix=mix)
    assert not out["correct"]
    assert numbers(out)["lanes_wrong"] > 0


@MIXES
def test_an_answer_altered_where_it_is_produced_fails(tmp_path, mix,
                                                      monkeypatch):
    from throttlecrab_tpu_torch.tpu import fused

    inner = fused.gcra_scan_packed_fused_acc
    calls = []

    def altered(*a, **k):
        state, acc, out = inner(*a, **k)
        flat = out.reshape(-1)
        lane = (7 * len(calls)) % flat.numel()
        flat[lane] ^= 1  # the allowed bit of one w32 word a launch
        calls.append(lane)
        return state, acc, out

    monkeypatch.setattr(fused, "gcra_scan_packed_fused_acc", altered)
    out = tiny_run(tmp_path, mix=mix)
    assert calls and not out["correct"]
    assert numbers(out)["lanes_wrong"] > 0


# ---- the controls ---------------------------------------------------------


@pytest.mark.parametrize("which", ["subbatch", "launch"])
@pytest.mark.parametrize("seed", [1, 2, 3])
def test_each_control_comes_out_not_correct(tmp_path, which, seed):
    rep = control.run_control(make_root(tmp_path), "tiny", seed, 200, which)
    assert not control.check.correct(rep)
    assert dict((n, v) for n, v, _ in rep["numbers"])["lanes_wrong"] > 0


def test_duplicate_lanes_alone_catch_the_subbatch_control(tmp_path):
    """With no launch compared whole, the lanes of sub-batches that hold
    a sampled key twice, compared in every launch, still find it."""
    mix = dict(TINY_MIX, check=dict(TINY_MIX["check"], stride=1 << 62))
    rep = control.run_control(make_root(tmp_path, mix=mix), "tiny", 1, 200,
                              "subbatch")
    assert rep["launches_compared"] == 0 and rep["lanes_checked"] > 0
    assert dict((n, v) for n, v, _ in rep["numbers"])["lanes_wrong"] > 0
