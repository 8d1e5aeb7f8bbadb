"""The check's stride over the Zipf head's duplicate lanes
(`hot_sub_stride`): it leaves a mix without it, c2's, compared lane for
lane as before; on a tiny Zipf mix with it the hot and drawn keys'
compared lanes lie in the sub-batches the seed draws, the loop keeps
exactly the lanes the reference answers, the run is correct, and each
control still reads not correct (the faults planted under the timed
path: `test_cpu_run.py`, on this mix too)."""

import json

import numpy as np
import pytest

from portbench import check, control, generate, run
from portbench.loops import byid
from portbench.registry import Spec
from portbench.tests.tiny import PKG, TINY_STRIDED_MIX, make_root

C2_MIX = json.loads((PKG / "traffic" / "ids-k4096.json").read_text())


def quiet(*_a, **_k):
    pass


def built(root, seed):
    spec = Spec(root)
    cell = spec.cell("tiny")
    sched = generate.Schedule(spec.config(cell), spec.mix(cell), seed)
    keys, rule = generate.check_sample(sched)
    return sched, keys, generate.SampleIndex.build(sched, keys, rule)


def old_rule(index, i):
    """The rule before `hot_sub_stride`: every sampled lane of a launch
    compared whole, the duplicate lanes of every other launch."""
    w = index.sched.window_of(i)
    if generate.is_compared(i, index.rule):
        return np.arange(len(index.lanes[w]))
    return np.flatnonzero(index.lane_dup[w])


def test_c2_mix_keeps_its_compared_lanes_on_a_zipf_config(tmp_path):
    sched, _, index = built(make_root(tmp_path, mix=C2_MIX), 5)
    assert not index.rule.strided.any() and index.rule.sub_stride == 1
    for i in range(3 * len(sched.windows)):
        assert np.array_equal(index.compared(i), old_rule(index, i))


def test_c2_cell_keeps_its_compared_lanes():
    """The real c2-ids-uniform cell, over its first launches."""
    spec = Spec(PKG.parent)
    cell = spec.cell("c2-ids-uniform")
    sched = generate.Schedule(spec.config(cell), spec.mix(cell), 2**33 + 1)
    keys, rule = generate.check_sample(sched)
    index = generate.SampleIndex.build(sched, keys, rule)
    assert not rule.strided.any()
    for i in range(len(sched.windows) + 8):
        assert np.array_equal(index.compared(i), old_rule(index, i))


@pytest.mark.parametrize("seed", [1, 2**31 + 9])
def test_hot_lanes_lie_in_the_sub_batches_the_seed_draws(tmp_path, seed):
    sched, keys, index = built(make_root(tmp_path, mix=TINY_STRIDED_MIX),
                               seed)
    rule = index.rule
    assert rule.sub_stride == 4 and 0 < rule.strided.sum() < len(keys)
    drawn, hot = set(), 0
    for i in range(40):
        w = sched.window_of(i)
        sel = index.compared(i)
        subs = generate.compared_subs(i, sched.K, rule)
        drawn.update((i * sched.K + subs).tolist())
        strided = rule.strided[index.lane_key[w]]
        hot_sel = sel[strided[sel]]
        hot += len(hot_sel)
        assert np.isin(index.lane_sub[w][hot_sel], subs).all()
        # Every strided lane the rule reaches in those sub-batches.
        want = strided & np.isin(index.lane_sub[w], subs)
        if not generate.is_compared(i, rule):
            want &= index.lane_dup[w]
        assert np.array_equal(hot_sel, np.flatnonzero(want))
        # The other keys as before: whole launch or duplicates.
        plain = old_rule(index, i)
        assert np.array_equal(sel[~strided[sel]], plain[~strided[plain]])
    assert hot > 0
    # About one sub-batch in four, and not a fixed pattern.
    assert 0.1 < len(drawn) / (40 * sched.K) < 0.45
    assert len({j % sched.K for j in drawn}) > sched.K // 2


def test_loop_and_reference_agree_on_the_compared_lanes(tmp_path):
    sched, keys, index = built(make_root(tmp_path, mix=TINY_STRIDED_MIX), 7)
    loop = byid.Loop(sched, keys, index, "cpu")
    loop.setup()
    try:
        loop.populate()
        loop.run_untimed(30)
    finally:
        loop.close()
    n = loop.n
    lanes, _, _ = check.reference_run(sched, keys, index, n)
    assert set(lanes) == set(loop.kept)
    for i, want in lanes.items():
        assert loop.kept[i].shape == want.shape == (len(index.compared(i)), 4)
        assert np.array_equal(loop.kept[i], want)
    wanted = check.wanted_positions(sched, index, n, len(keys))
    for s, pos in enumerate(wanted):
        for p in pos:
            i, k = divmod(p, sched.K)
            if index.rule.strided[s]:
                assert k in generate.compared_subs(i, sched.K, index.rule)


def test_tiny_strided_run_is_correct(tmp_path):
    out = run.run_cell(make_root(tmp_path, mix=TINY_STRIDED_MIX), "tiny", 3,
                       0.6, False, device="cpu", log=quiet)
    assert out["correct"], out["compared"]
    info = out["info"]
    assert 0 < info["hot_lanes_checked"] < info["lanes_checked"]


@pytest.mark.parametrize("which", ["subbatch", "launch"])
@pytest.mark.parametrize("seed", [1, 2, 3])
def test_each_control_fails_with_the_stride(tmp_path, which, seed):
    rep = control.run_control(make_root(tmp_path, mix=TINY_STRIDED_MIX),
                              "tiny", seed, 200, which)
    assert not control.check.correct(rep)
    assert dict((n, v) for n, v, _ in rep["numbers"])["lanes_wrong"] > 0
    assert rep["hot_lanes_checked"] > 0
