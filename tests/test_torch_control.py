"""The port's control plane (throttlecrab_tpu_torch/control/) against the
JAX package's (throttlecrab_tpu/control/).

Mirrors tests/test_control.py, each case run through both packages over
equal registries: actuator clamps, slew limits, integer rounding and the
bounded log; AIMD convergence under virtual time; hill climbing with
hysteresis and exact reverts; the objective, Jain fairness and the shed
fraction; the plane's cadence, lock plumbing and documents; the kill
switch (a default config builds nothing; a controller-off simulation
equals a plain oracle replay); config validation; and the offline policy
search.  The actuation logs, `stats_json`, `actuation_log_json` and
`rank_json` must be byte-identical to the JAX package's (hypothesis over
Telemetry sequences for the controllers), and so must the `rank` CLI's
output.  Live: a port engine with a control plane ticks, and GET
/control equals the JAX engine's document for the same front, insight
and tick times.  Exact equality throughout (both packages run the same
float operations in the same order).
"""

from __future__ import annotations

import asyncio
import json
import threading

import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from throttlecrab_tpu import control as jax_ctl
from throttlecrab_tpu.front.admission import (
    AdmissionController as JaxAdmission,
)
from throttlecrab_tpu.replay import generators as jax_gen
from throttlecrab_tpu.server.config import Config as JaxConfig
from throttlecrab_tpu_torch import control as port_ctl
from throttlecrab_tpu_torch.front.admission import AdmissionController
from throttlecrab_tpu_torch.replay import generators as port_gen
from throttlecrab_tpu_torch.replay.player import (
    make_target,
    outcome_vector,
    replay,
)
from throttlecrab_tpu_torch.server.config import Config

NS = 1_000_000_000
T0 = 1_753_700_000 * NS
BOTH = (jax_ctl, port_ctl)


class _Box:
    def __init__(self, **kw):
        self.__dict__.update(kw)


def _knob(m, box, attr, lo, hi, max_step, integer=False, name=None):
    return m.Actuator(
        name=name or attr, unit="x", lo=lo, hi=hi, max_step=max_step,
        get=lambda: getattr(box, attr),
        set=lambda v: setattr(box, attr, v),
        integer=integer,
    )


def _tel(m, i, wait_us=0.0, shed=0, served=0, hot=0.0, tenants=None):
    return m.Telemetry(
        now_ns=T0 + i * NS, est_wait_us=wait_us, shed_consume=shed,
        allowed_total=served, hot_concentration=hot,
        tenant_served=tenants or {},
    )


def _on_both(fn):
    """fn(module) for each package; asserts equal results, returns one."""
    got = [fn(m) for m in BOTH]
    assert got[0] == got[1]
    return got[1]


# ------------------------------------------------ actuator registry #


def test_actuator_clamps_to_hard_bounds():
    def run(m):
        box = _Box(v=50.0)
        reg = m.ActuatorRegistry()
        reg.register(_knob(m, box, "v", 10.0, 100.0, 1000.0))
        out = [reg.apply("v", 5000.0, T0), box.v,
               reg.apply("v", -3.0, T0), box.v, reg.clamps]
        return out, list(reg.log)

    out, log = _on_both(run)
    assert out == [100.0, 100.0, 10.0, 10.0, 2]
    assert all(e["clamped"] for e in log)


def test_actuator_rate_limits_per_tick_step():
    def run(m):
        box = _Box(v=50.0)
        reg = m.ActuatorRegistry()
        reg.register(_knob(m, box, "v", 0.0, 1000.0, 10.0))
        return [reg.apply("v", 500.0, T0), reg.apply("v", 0.0, T0),
                reg.actuations]

    assert _on_both(run) == [60.0, 50.0, 2]


def test_actuator_integer_rounds_and_sets_int():
    def run(m):
        box = _Box(v=100)
        reg = m.ActuatorRegistry()
        reg.register(_knob(m, box, "v", 0, 1000, 500, integer=True))
        return reg.apply("v", 123.7, T0), box.v, type(box.v)

    assert _on_both(run) == (124.0, 124, int)


def test_actuator_noop_write_is_not_logged():
    def run(m):
        box = _Box(v=7.0)
        reg = m.ActuatorRegistry()
        reg.register(_knob(m, box, "v", 0.0, 10.0, 5.0))
        return reg.apply("v", 7.0, T0), reg.actuations, len(reg.log)

    assert _on_both(run) == (7.0, 0, 0)


def test_actuation_log_is_bounded():
    assert port_ctl.LOG_CAP == jax_ctl.LOG_CAP

    def run(m):
        box = _Box(v=0.0)
        reg = m.ActuatorRegistry()
        reg.register(_knob(m, box, "v", 0.0, 1e9, 1.0))
        for i in range(m.LOG_CAP + 50):
            reg.apply("v", box.v + 1.0, T0 + i)
        return len(reg.log), reg.actuations, list(reg.log)[0]

    n, total, first = _on_both(run)
    assert n == port_ctl.LOG_CAP and total == port_ctl.LOG_CAP + 50
    assert first["now_ns"] == T0 + 50


@pytest.mark.parametrize("lo,hi,step", [(10.0, 5.0, 1.0), (0.0, 5.0, 0.0)])
def test_registry_rejects_bad_declarations(lo, hi, step):
    msgs = []
    for m in BOTH:
        with pytest.raises(ValueError) as info:
            m.ActuatorRegistry().register(
                _knob(m, _Box(v=0.0), "v", lo, hi, step))
        msgs.append(str(info.value))
    assert msgs[0] == msgs[1]


def test_build_registry_anchors_bounds_to_configured_point():
    def run(m, adm_cls):
        adm = adm_cls(max_pending=10_000, max_wait_us=50_000)
        reg = m.build_registry(admission=adm)
        return (reg.names(), reg.bounds("admission.max_pending"),
                reg.bounds("admission.max_wait_us"),
                reg.apply("admission.max_pending", 10**9, T0),
                json.dumps(reg.snapshot(), sort_keys=True))

    want = run(jax_ctl, JaxAdmission)
    got = run(port_ctl, AdmissionController)
    assert got == want
    assert got[1] == (max(10_000 // 64, 64), 10_000)
    assert got[3] == 10_000


# ------------------------------------------------------------- AIMD #


def _aimd_loop(m, ticks=60):
    box = _Box(bound=100_000)
    reg = m.ActuatorRegistry()
    reg.register(_knob(m, box, "bound", 64, 100_000, 100_000, integer=True,
                       name="admission.max_pending"))
    aimd = m.AIMDController(target_wait_us=5000.0)
    prev, history = None, []
    for i in range(ticks):
        cur = _tel(m, i, wait_us=float(box.bound), shed=i + 1, served=i)
        aimd.tick(prev, cur, reg, T0 + i * NS)
        prev = cur
        history.append(box.bound)
    return history, list(reg.log)


def test_aimd_converges_to_target_band_under_overload():
    history, log = _on_both(_aimd_loop)
    target, step, factor = 5000.0, 256, 0.7
    tail = history[30:]
    assert all((target + step) * factor - step <= b <= target + step
               for b in tail), tail
    assert len(set(tail)) > 1 and log


def test_aimd_additive_increase_only_when_shedding():
    def run(m):
        box = _Box(bound=1000)
        reg = m.ActuatorRegistry()
        reg.register(_knob(m, box, "bound", 64, 100_000, 100_000,
                           integer=True, name="admission.max_pending"))
        aimd = m.AIMDController(target_wait_us=5000.0)
        prev = _tel(m, 0, wait_us=100.0, shed=0, served=10)
        cur = _tel(m, 1, wait_us=100.0, shed=0, served=20)
        aimd.tick(prev, cur, reg, T0)
        first = box.bound
        aimd.tick(cur, _tel(m, 2, wait_us=100.0, shed=5, served=30), reg,
                  T0 + NS)
        return first, box.bound

    assert _on_both(run) == (1000, 1256)


def test_aimd_hot_weight_rises_under_hot_congestion_then_decays():
    def run(m):
        box = _Box(w=0.0)
        reg = m.ActuatorRegistry()
        reg.register(_knob(m, box, "w", 0.0, 1.0, 0.1,
                           name="admission.hot_shed_weight"))
        aimd = m.AIMDController(target_wait_us=5000.0)
        hot = _tel(m, 1, wait_us=50_000.0, hot=0.9)
        out = []
        aimd.tick(None, hot, reg, T0)
        out.append(box.w)
        aimd.tick(hot, _tel(m, 2, wait_us=50_000.0, hot=0.9), reg, T0)
        out.append(box.w)
        aimd.tick(None, _tel(m, 3, wait_us=100.0), reg, T0)
        out.append(box.w)
        return out

    assert _on_both(run) == pytest.approx([0.05, 0.10, 0.07])


def test_aimd_rejects_bad_decrease_factor():
    for m in BOTH:
        with pytest.raises(ValueError):
            m.AIMDController(decrease_factor=1.0)


# ------------------------------------------------------ hill climber #


def _hill_loop(m, x0, score_of, ticks, **kw):
    box = _Box(x=x0)
    reg = m.ActuatorRegistry()
    reg.register(_knob(m, box, "x", 0.0, 10.0, 10.0))
    hill = m.HillClimber(["x"], **kw)
    baselines, last = [], None
    for i in range(ticks):
        hill.tick(score_of(box.x), reg, T0 + i * NS)
        b = hill.stats()["baseline"]
        if b is not None and b != last:
            baselines.append(b)
            last = b
    return baselines, box.x, hill.stats(), list(reg.log)


def test_hill_climbs_to_optimum_with_monotone_baselines():
    baselines, x, stats, _ = _on_both(lambda m: _hill_loop(
        m, 2.0, lambda x: -((x - 7.0) ** 2), 60, step_frac=0.125,
        eval_ticks=2, hysteresis=0.01))
    assert all(b > a for a, b in zip(baselines, baselines[1:]))
    assert stats["accepted"] >= 3 and stats["reverted"] > 0
    assert abs(x - 7.0) <= 1.25 + 1e-9


def test_hill_hysteresis_blocks_noise_and_reverts_exactly():
    _, x, stats, _ = _on_both(lambda m: _hill_loop(
        m, 4.0, lambda x: 1.0, 41, eval_ticks=2, hysteresis=0.01))
    assert stats["accepted"] == 0 and stats["reverted"] > 0
    assert x in {4.0, 4.0 + 1.25, 4.0 - 1.25}


def test_hill_skips_pinned_coordinate_without_burning_a_window():
    def run(m):
        box = _Box(x=10.0, y=5.0)
        reg = m.ActuatorRegistry()
        reg.register(_knob(m, box, "x", 10.0, 10.0, 1.0))
        reg.register(_knob(m, box, "y", 0.0, 10.0, 10.0))
        hill = m.HillClimber(["x", "y"], eval_ticks=1, hysteresis=1e9)
        for i in range(12):
            hill.tick(0.0, reg, T0 + i * NS)
        return list(reg.log)

    log = _on_both(run)
    assert log and all(e["actuator"] == "y" for e in log)


def test_hill_rejects_bad_eval_ticks():
    for m in BOTH:
        with pytest.raises(ValueError):
            m.HillClimber(["x"], eval_ticks=0)


_TEL = st.tuples(
    st.floats(0, 1e6, allow_nan=False),  # est_wait_us
    st.integers(0, 500),                  # new sheds
    st.integers(0, 5000),                 # new served
    st.floats(0, 1, allow_nan=False),    # hot concentration
    st.integers(0, 3 * NS),               # tick gap
)


@settings(max_examples=40, deadline=None)
@given(seq=st.lists(_TEL, min_size=1, max_size=40),
       eval_ticks=st.integers(1, 4))
def test_controllers_actuation_logs_equal_for_any_telemetry(seq,
                                                             eval_ticks):
    """The same Telemetry sequence through both packages' AIMD and hill
    climber over equal registries (the default server's knobs) gives
    byte-identical actuation logs and final knob values."""
    def run(m, adm_cls):
        adm = adm_cls(max_pending=100_000, max_wait_us=20_000)
        box = _Box(capacity=65536, prewarm=64, poll_ns=NS)
        reg = m.build_registry(admission=adm)
        reg.register(_knob(m, box, "capacity", 8192, 262_144, 16384,
                           integer=True, name="deny_cache.capacity"))
        reg.register(_knob(m, box, "prewarm", 0, 4096, 64, integer=True,
                           name="insight.prewarm"))
        aimd = m.AIMDController(target_wait_us=5000.0)
        hill = m.HillClimber(["admission.hot_shed_weight",
                              "deny_cache.capacity", "insight.prewarm"],
                             eval_ticks=eval_ticks)
        obj = m.Objective()
        prev, now, shed, served, scores = None, T0, 0, 0, []
        for wait, d_shed, d_served, hot, gap in seq:
            now += gap
            shed += d_shed
            served += d_served
            cur = m.Telemetry(now_ns=now, est_wait_us=wait,
                              shed_consume=shed, allowed_total=served,
                              hot_concentration=hot)
            score = obj.score(prev, cur)
            scores.append(score)
            aimd.tick(prev, cur, reg, now)
            hill.tick(score, reg, now)
            prev = cur
        return (json.dumps(list(reg.log), sort_keys=True), scores,
                hill.stats(), json.dumps(reg.snapshot(), sort_keys=True))

    assert run(port_ctl, AdmissionController) == run(jax_ctl, JaxAdmission)


# ----------------------------------------------------------- objective #


def test_objective_scores_throughput_wait_fairness():
    def run(m):
        obj = m.Objective()
        base = _tel(m, 0, served=0)
        return [
            obj.score(base, _tel(m, 1, wait_us=0.0, served=1000)),
            obj.score(base, _tel(m, 1, wait_us=50_000.0, served=1000)),
            obj.score(base, _tel(m, 1, served=1000,
                                 tenants={"a": 990, "b": 5, "c": 5})),
            obj.score(base, _tel(m, 1, served=1000,
                                 tenants={"a": 334, "b": 333, "c": 333})),
            obj.score(None, _tel(m, 1, served=10)),
            obj.weights(),
        ]

    fast, slow, unfair, fair, _, _ = _on_both(run)
    assert fast > slow and fair > unfair


def test_jain_fairness_bounds():
    cases = [{}, {"a": 10}, {"a": 5, "b": 5}, {"a": 1000, "b": 1},
             {"a": 0, "b": 3}]
    got = _on_both(lambda m: [m.jain_fairness(c) for c in cases])
    assert got[:3] == [1.0, 1.0, pytest.approx(1.0)]
    assert 0.5 <= got[3] < 0.51


def test_shed_fraction_differences_consecutive_records():
    def run(m):
        prev = _tel(m, 0, shed=10, served=90)
        cur = _tel(m, 1, shed=30, served=150)
        return (m.shed_fraction(prev, cur), m.shed_fraction(None, cur),
                m.shed_fraction(cur, cur))

    assert _on_both(run) == (pytest.approx(0.25), pytest.approx(30 / 180),
                             0.0)


# --------------------------------------------------------- control plane #


class _StubBus:
    def __init__(self, m):
        self.m = m

    def snapshot(self, now_ns, queue_depth=0):
        return _tel(self.m, 0)


class _RecordingLock:
    def __init__(self):
        self.entries = 0
        self._lock = threading.Lock()

    def __enter__(self):
        self.entries += 1
        return self._lock.__enter__()

    def __exit__(self, *exc):
        return self._lock.__exit__(*exc)


def _plane(m, mode="both", tick_ms=1000):
    box = _Box(bound=1000)
    reg = m.ActuatorRegistry()
    reg.register(_knob(m, box, "bound", 64, 100_000, 100_000, integer=True,
                       name="admission.max_pending"))
    return m.ControlPlane(_StubBus(m), reg, mode=mode, tick_ms=tick_ms)


def test_plane_tick_cadence_is_throttled():
    def run(m):
        plane = _plane(m)
        return [plane.maybe_tick(T0), plane.maybe_tick(T0 + NS // 2),
                plane.maybe_tick(T0 + NS), plane.ticks]

    assert _on_both(run) == [True, False, True, 2]


def test_plane_tick_lock_overrides_caller_lock():
    def run(m):
        plane = _plane(m)
        caller, other = _RecordingLock(), _RecordingLock()
        plane.maybe_tick(T0, caller)
        first = caller.entries
        plane.tick_lock = other
        plane.maybe_tick(T0 + 2 * NS, caller)
        return first, caller.entries, other.entries

    assert _on_both(run) == (1, 1, 1)


def test_plane_stats_document_shape():
    def run(m):
        plane = _plane(m, mode="both")
        plane.maybe_tick(T0)
        plane.maybe_tick(T0 + 5 * NS)
        return (plane.stats_json(), plane.actuation_log_json(),
                plane.metric_stats())

    doc, _, metric = _on_both(run)
    doc = json.loads(doc)
    assert doc["control"] == {"enabled": True, "mode": "both",
                              "tick_ms": 1000, "ticks": 2}
    assert set(doc["objective"]["weights"]) == {
        "throughput", "wait", "fairness"}
    assert "admission.max_pending" in doc["actuators"] and "hill" in doc
    assert set(metric) == {"ticks", "actuations", "clamped", "objective",
                           "shed_rate"}


@pytest.mark.parametrize("mode", ["banana", ""])
def test_plane_rejects_unknown_mode(mode):
    for m in BOTH:
        with pytest.raises(ValueError):
            _plane(m, mode=mode)


def test_plane_swallows_a_failing_tick_and_keeps_counting():
    """A sensor failure never reaches the serving path (as in JAX): the
    tick counts, no snapshot is taken, `_prev` stays behind — what the
    card run checks after every tick."""
    class Broken:
        def snapshot(self, now_ns, queue_depth=0):
            raise RuntimeError("sensor down")

    def run(m):
        plane = m.ControlPlane(Broken(), m.ActuatorRegistry())
        return plane.maybe_tick(T0), plane.ticks, plane._prev

    assert _on_both(run) == (True, 1, None)


# ------------------------------------------------ kill switch + config #


def test_default_config_builds_no_control_plane():
    cfg = Config.from_env_and_args(["--http"])
    assert cfg.control is False
    assert port_ctl.create_control_plane(cfg) is None
    assert jax_ctl.create_control_plane(
        JaxConfig.from_env_and_args(["--http"])) is None


def _small_trace(gen=port_gen, windows=24, batch=128, seed=23):
    return gen.synthesize("flash-crowd", windows=windows, batch=batch,
                          key_space=2048, seed=seed)


def test_controller_off_is_bit_identical_to_plain_replay():
    trace = _small_trace()
    off = port_ctl.ControlReplayer(
        trace, port_ctl.Policy(name="static", mode="off")).run()
    plain = outcome_vector(replay(trace, make_target("oracle", trace)))
    assert off.vector() == plain
    assert off.shed == 0 and off.actuations == 0
    assert off.actuation_log == [] and off.final_max_pending == 100_000


def test_armed_controller_tightens_bound_and_caps_wait():
    def run(m, gen):
        trace = _small_trace(gen, windows=32, batch=1024)
        rate = 0.25 * trace.n_rows() / m.ControlReplayer._duration_s(trace)
        off = m.ControlReplayer(trace, m.Policy(name="static", mode="off"),
                                service_rate=rate).run()
        on = m.ControlReplayer(trace, m.Policy(name="aimd", mode="aimd"),
                               service_rate=rate).run()
        return (off.to_dict(), on.to_dict(), on.vector(),
                json.dumps(on.actuation_log, sort_keys=True))

    off, on, vec, log = run(port_ctl, port_gen)
    assert (off, on, vec, log) == run(jax_ctl, jax_gen)
    assert on["actuations"] > 0 and on["shed"] > 0
    assert on["final_max_pending"] < 100_000
    assert on["max_wait_us_seen"] < off["max_wait_us_seen"]


@pytest.mark.parametrize("argv", [
    ["--control-mode", "banana"], ["--control-tick-ms", "0"],
    ["--control-target-wait-us", "0"], ["--control-w-wait", "-1"],
    ["--control-w-throughput", "-0.5"], ["--control-w-fairness", "-2"],
    ["--trace-mode", "tape"], ["--trace-windows", "0"],
])
def test_config_validates_control_and_trace_knobs(argv):
    for cfg in (Config, JaxConfig):
        with pytest.raises(ValueError):
            cfg.from_env_and_args(["--http"] + argv)


def test_create_control_plane_from_config_as_in_jax():
    """The same flags build planes with the same mode, cadence, weights
    and actuators over each package's default front and insight tiers
    (actuator bounds and values included)."""
    from throttlecrab_tpu.server import store as jax_store
    from throttlecrab_tpu.server.metrics import Metrics as JaxMetrics
    from throttlecrab_tpu.tpu.limiter import TpuRateLimiter
    from throttlecrab_tpu_torch.server import store as port_store
    from throttlecrab_tpu_torch.server.metrics import Metrics
    from throttlecrab_tpu_torch.tpu.limiter import TorchRateLimiter

    argv = ["--http", "--control", "--control-mode", "aimd",
            "--control-tick-ms", "250", "--control-w-fairness", "0.25",
            "--front-max-wait-us", "40000"]
    docs = []
    for cfg_cls, store, metrics, lim in (
        (JaxConfig, jax_store, JaxMetrics(),
         TpuRateLimiter(capacity=256, insight=True)),
        (Config, port_store, Metrics(),
         TorchRateLimiter(capacity=256, device="cpu", insight=True)),
    ):
        cfg = cfg_cls.from_env_and_args(argv)
        front = store.create_front_tier(cfg, metrics, lim)
        insight = store.create_insight(cfg, metrics, lim, front)
        plane = store.create_control(cfg, metrics, lim, front, insight,
                                     store.create_cleanup_policy(cfg))
        docs.append((plane.stats_json(),
                     [ln for ln in metrics.export_prometheus().splitlines()
                      if "_control_" in ln]))
    assert docs[0] == docs[1]
    assert "cleanup.interval_ns" in json.loads(docs[1][0])["actuators"]


# ---------------------------------------------------- policy search #


@pytest.mark.parametrize("pattern", port_gen.PATTERNS)
def test_rank_json_byte_identical_to_jax(pattern):
    kw = dict(windows=16, batch=96, key_space=1024, seed=5)
    got = port_ctl.rank_json(port_ctl.rank(
        port_gen.synthesize(pattern, **kw), port_ctl.default_candidates()))
    want = jax_ctl.rank_json(jax_ctl.rank(
        jax_gen.synthesize(pattern, **kw), jax_ctl.default_candidates()))
    assert got == want


def test_rank_is_reproducible_and_complete():
    trace = _small_trace()
    cands = port_ctl.default_candidates(8)
    assert len({p.name for p in cands}) == 8
    r1 = port_ctl.rank(trace, cands)
    assert port_ctl.rank_json(r1) == port_ctl.rank_json(
        port_ctl.rank(trace, cands))
    assert [row["rank"] for row in r1] == list(range(1, 9))
    assert "static" in {row["policy"]["name"] for row in r1}
    scores = [row["score"] for row in r1]
    assert scores == sorted(scores, reverse=True)


def test_rank_of_single_candidates_merges_to_rank():
    """chip_smoke.py ranks one candidate per worker process and merges:
    the merge gives rank()'s bytes, and JAX's."""
    import chip_smoke

    trace = _small_trace(windows=8, batch=64)
    cands = port_ctl.default_candidates(5)
    merged = chip_smoke.merge_rankings(
        [port_ctl.rank(trace, [p]) for p in cands])
    assert port_ctl.rank_json(merged) == port_ctl.rank_json(
        port_ctl.rank(trace, cands))
    jax_trace = jax_gen.synthesize("flash-crowd", windows=8, batch=64,
                                   key_space=2048, seed=23)
    assert port_ctl.rank_json(merged) == jax_ctl.rank_json(jax_ctl.rank(
        jax_trace, jax_ctl.default_candidates(5)))


def test_default_candidates_extend_past_fixed_head():
    got = _on_both(lambda m: [p.describe()
                              for p in m.default_candidates(11)])
    assert len({p["name"] for p in got}) == 11


def test_rank_cli_emits_canonical_json(tmp_path, capsys):
    """`rank --json` and the per-row form print the JAX CLI's bytes."""
    from throttlecrab_tpu.control.__main__ import main as jax_main
    from throttlecrab_tpu_torch.control.__main__ import main as port_main

    path = str(tmp_path / "t.tctr")
    port_gen.save(_small_trace(windows=12, batch=64), path)
    outs = []
    for main in (jax_main, port_main, port_main):
        for extra in (["--json"], ["-k", "3"]):
            assert main(["rank", path] + extra) == 0
            outs.append(capsys.readouterr().out)
    assert outs[0:2] == outs[2:4] == outs[4:6]
    ranking = json.loads(outs[0])
    assert len(ranking) == 8 and ranking[0]["rank"] == 1
    for main in (jax_main, port_main):
        assert main(["simulate", path, "--mode", "aimd", "--log"]) == 0
        outs.append(capsys.readouterr().out)
    assert outs[-1] == outs[-2]
    assert port_main(["rank", str(tmp_path / "missing.tctr")]) == 2


# ------------------------------------------------------------- live #


def test_live_engine_control_document_equals_jax():
    """A port engine and a JAX engine, each with the default front and
    insight tiers and a control plane, decide the same requests under
    one virtual clock; the planes tick at the same times and GET
    /control answers the same document."""
    from throttlecrab_tpu.server import store as jax_store
    from throttlecrab_tpu.server.engine import BatchingEngine as JaxEngine
    from throttlecrab_tpu.server.http import HttpTransport as JaxHttp
    from throttlecrab_tpu.server.metrics import Metrics as JaxMetrics
    from throttlecrab_tpu.server.types import ThrottleRequest as JaxReq
    from throttlecrab_tpu.tpu.limiter import TpuRateLimiter
    from throttlecrab_tpu_torch.server import store as port_store
    from throttlecrab_tpu_torch.server.engine import BatchingEngine
    from throttlecrab_tpu_torch.server.http import HttpTransport
    from throttlecrab_tpu_torch.server.metrics import Metrics
    from throttlecrab_tpu_torch.server.types import ThrottleRequest
    from throttlecrab_tpu_torch.tpu.limiter import TorchRateLimiter

    argv = ["--http", "--control", "--control-tick-ms", "300"]

    async def run(side):
        if side == "jax":
            cfg, store = JaxConfig.from_env_and_args(argv), jax_store
            metrics, lim = JaxMetrics(), TpuRateLimiter(capacity=256,
                                                       insight=True)
            engine_cls, http, req = JaxEngine, JaxHttp, JaxReq
        else:
            cfg, store = Config.from_env_and_args(argv), port_store
            metrics = Metrics()
            lim = TorchRateLimiter(capacity=256, device="cpu", insight=True)
            engine_cls, http, req = BatchingEngine, HttpTransport, \
                ThrottleRequest
        clock = {"now": T0}
        front = store.create_front_tier(cfg, metrics, lim)
        insight = store.create_insight(cfg, metrics, lim, front)
        policy = store.create_cleanup_policy(cfg)
        plane = store.create_control(cfg, metrics, lim, front, insight,
                                     policy)
        engine = engine_cls(lim, batch_size=8, max_linger_us=100,
                            cleanup_policy=policy, metrics=metrics,
                            front=front, insight=insight, control=plane,
                            now_fn=lambda: clock["now"])
        transport = http("127.0.0.1", 0, engine, metrics)
        for step in range(12):
            reqs = [req(f"k:{(step * 8 + i) % 50}", 3, 1, 60, 1)
                    for i in range(8)]
            await asyncio.gather(*[engine.throttle(r) for r in reqs],
                                 return_exceptions=True)
            # Let the flush finish its housekeeping (the tick) before the
            # next requests queue: the tick then reads queue depth 0, and
            # the estimated wait (depth x measured cost) is 0 on both.
            while engine._flush_tasks:
                await asyncio.sleep(0.001)
            clock["now"] += NS // 5
        _, payload, _ = await transport._route("GET", "/control", b"")
        await engine.shutdown()
        return json.loads(payload), plane.ticks

    (want, jax_ticks), (got, ticks) = asyncio.run(run("jax")), asyncio.run(
        run("port"))
    assert ticks == jax_ticks >= 4
    assert got == want
    assert got["control"]["enabled"] and got["control"]["ticks"] == ticks


def test_control_route_disabled_shape():
    from throttlecrab_tpu_torch.server.engine import BatchingEngine
    from throttlecrab_tpu_torch.server.http import HttpTransport
    from throttlecrab_tpu_torch.server.metrics import Metrics
    from throttlecrab_tpu_torch.tpu.limiter import TorchRateLimiter

    async def run():
        engine = BatchingEngine(TorchRateLimiter(capacity=64, device="cpu"))
        transport = HttpTransport("127.0.0.1", 0, engine, Metrics())
        out = await transport._route("GET", "/control", b"")
        await engine.shutdown()
        return out

    assert asyncio.run(run()) == (
        200, b'{"control": {"enabled": false}}', "application/json")
