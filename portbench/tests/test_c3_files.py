"""Config 3's files: the cell `c3-ids-zipf-k1024` is found by name, its
configuration's per-key limits are bench.py's (`chip_smoke.py::
config3_params`) for every one of the 1M ids and fit the w32 tier at
the mix's first instant, and the mix's check strides over the Zipf
head (`hot_sub_stride` 256) when `SampleIndex.compared` picks a
launch's lanes."""

import numpy as np
import pytest

import chip_smoke
from portbench import generate
from portbench.registry import Spec
from portbench.tests.tiny import PKG

CELL = "c3-ids-zipf-k1024"


@pytest.fixture(scope="module")
def files():
    spec = Spec(PKG.parent)
    cell = spec.cell(CELL)
    return cell, spec.config(cell), spec.mix(cell)


def test_the_cell_resolves_by_name(files):
    cell, cfg, mix = files
    assert (cell["config"], cell["traffic"], cell["chips"]) == (
        "c3-1m-zipf", "ids-k1024-p8", 1)
    assert (cfg["name"], cfg["keys"], cfg["batch"], cfg["capacity"],
            cfg["tier"], cfg["reduced"]) == (
        "c3-1m-zipf", 1_000_000, 4096, 1 << 20, "w32", [])
    assert cfg["key_dist"] == {"kind": "zipf", "s": 1.1}
    assert (mix["loop"], mix["depth"], mix["in_flight"], mix["workers"]) == (
        "byid", 1024, 8, 8)


def test_limits_are_config3s_for_every_id(files):
    from throttlecrab_tpu_torch.tpu.limiter import derive_params

    _, cfg, _ = files
    em, tol, invalid = derive_params(*generate.limits(cfg))
    names, em3, tol3 = chip_smoke.config3_params(cfg["keys"])
    assert not invalid.any()
    np.testing.assert_array_equal(em, em3)
    np.testing.assert_array_equal(tol, tol3)
    assert generate.key_names(cfg)[:3] == names[:3]
    assert generate.key_names(cfg)[-1] == names[-1]


def test_the_limits_fit_the_w32_tier(files):
    from throttlecrab_tpu_torch.tpu.kernel import fits_w32_wire
    from throttlecrab_tpu_torch.tpu.limiter import derive_params

    _, cfg, mix = files
    em, tol, _ = derive_params(*generate.limits(cfg))
    ones = np.ones(len(em), np.int64)
    assert fits_w32_wire(ones.astype(bool), em, tol, ones, mix["t0_ns"], 0)


def test_the_check_strides_over_the_head(files):
    _, cfg, mix = files
    assert mix["check"]["hot_sub_stride"] == 256
    # One pool window is enough to see the rule: the populate window
    # first, then launches over the one Zipf window.
    sched = generate.Schedule(cfg, dict(mix, pool=1), 2**31 + 7)
    keys, rule = generate.check_sample(sched)
    assert rule.sub_stride == 256 and rule.strided.sum() == 8 + 24
    index = generate.SampleIndex.build(sched, keys, rule)
    K, w = sched.K, sched.n_pop
    seen = 0
    for i in range(w, w + 4):
        sel = index.compared(i)
        strided = rule.strided[index.lane_key[w][sel]]
        subs = np.unique(index.lane_sub[w][sel][strided])
        assert set(subs.tolist()) <= set(
            generate.compared_subs(i, K, rule).tolist())
        assert len(subs) <= K // 256 * 3
        seen += index.strided_lanes(i, sel)
    assert seen > 0
