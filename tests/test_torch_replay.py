"""The port's record/replay (throttlecrab_tpu_torch/replay/) against the
JAX package's (throttlecrab_tpu/replay/).

Mirrors tests/test_replay.py, each case run through both packages:

- **Codec**: for the same records both packages encode the same bytes
  (hypothesis over keys — empty, up to 0xFFFF bytes, not utf-8 — params
  at the i64 extremes, events and injections), each decodes the
  other's, and every malformed fixture raises TraceError in both, with
  the same message.
- **Flight recorder**: the same record_* calls on both packages'
  recorders, ring and full mode, under one clock, dump byte-identical
  files with equal stats(); late capture after close, capture that
  never raises, tenant ids, and capture errors counted in
  `_capture_errors` (a deliberately failing encoder).
- **Record then replay**: a full-mode trace captured by the port's
  BatchingEngine, and one captured by its native RESP driver, replay
  twice to the same outcome vector, equal the recorded outcomes, pass
  differential_replay on a device="cpu" target, and JAX's
  differential_replay on its device target reports the same summary.
  A trace the JAX engine recorded replays in the port and one the port
  recorded replays in JAX, to equal outcome vectors.
- **Synthetic traces**: byte-identical per pattern and seed.
- **Faults**: a chaos run's fired injections land in the trace, and
  injector_from_trace rebuilds the JAX package's fired schedule.
- **Degrade dump, lifecycle events, GET /trace/dump, the CLI**.

The port runs on device="cpu" (the plain version).  Exact equality
throughout: integer math and byte streams.  Left out with the modules
they test (ROADMAP A7, A9): the sharded target and the harness/loadgen
round trips.
"""

from __future__ import annotations

import asyncio
import glob
import json
import os
import socket
import struct
import time

import numpy as np
import pytest
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from throttlecrab_tpu import faults as jax_faults
from throttlecrab_tpu.replay import generators as jax_gen
from throttlecrab_tpu.replay import player as jax_player
from throttlecrab_tpu.replay import recorder as jax_rec
from throttlecrab_tpu.replay import trace as jax_trace
from throttlecrab_tpu_torch import faults as port_faults
from throttlecrab_tpu_torch.replay import generators as port_gen
from throttlecrab_tpu_torch.replay import player as port_player
from throttlecrab_tpu_torch.replay import recorder as port_rec
from throttlecrab_tpu_torch.replay import trace as port_trace

NS = 1_000_000_000
T0 = 1_753_700_000 * NS
I64 = (-(1 << 63), (1 << 63) - 1)
BOTH = (jax_trace, port_trace)


@pytest.fixture(autouse=True)
def _disarm_everything():
    yield
    jax_rec.disarm()
    port_rec.disarm()
    jax_faults.disarm()
    port_faults.disarm()


def _cpu_target(trace):
    return port_player.make_target("device", trace, device="cpu")


# ------------------------------------------------------------ codec #


def test_window_roundtrip_preserves_everything():
    keys = [b"a", b"tenant:zz", b"", b"x" * 300, b"\xff\xfe"]
    params = np.array(
        [[5, 100, 60, 1], [2, 2, 600, 0], [1, 1, 1, 1],
         [3_000_000_000, 1, 1, 1], [I64[0], I64[1], 0, -1]],
        np.int64,
    )
    args = (T0, 7, keys, params, [1, 0, 1, 0, 1], [0, 0, 2, 3, 4],
            [0, 3, 0, 1, 0xFFFF])
    frames = [m.encode_window(*args) for m in BOTH]
    assert frames[0] == frames[1]
    for m in BOTH:
        w = m.decode_window(frames[0][5:])
        assert w.now_ns == T0 and w.source == 7 and w.keys == keys
        np.testing.assert_array_equal(w.params, params)
        assert w.allowed.tolist() == [1, 0, 1, 0, 1]
        assert w.status.tolist() == [0, 0, 2, 3, 4]
        assert w.tenants.tolist() == [0, 3, 0, 1, 0xFFFF]


def test_event_and_injection_roundtrip():
    ev = [m.encode_event(T0, "degrade", "UNAVAILABLE: boom") for m in BOTH]
    inj = [m.encode_injection("launch", "count", 7, 2.0) for m in BOTH]
    assert ev[0] == ev[1] and inj[0] == inj[1]
    for m in BOTH:
        e = m.decode_event(ev[0][5:])
        assert (e.now_ns, e.kind, e.detail) == (
            T0, "degrade", "UNAVAILABLE: boom"
        )
        i = m.decode_injection(inj[0][5:])
        assert (i.site, i.mode, i.index, i.arg) == ("launch", "count", 7, 2.0)


def _writer_bytes(m):
    writer = m.TraceWriter()
    writer.add_event(T0, "cluster-join", "1")
    writer.add_window(
        T0 + 1, m.SOURCE_ENGINE, [b"k"], [[5, 100, 60, 1]], [1], [0]
    )
    writer.add_injection("launch", "transient", 3, 0.5)
    writer.add_window(
        T0 + 2, m.SOURCE_NATIVE, [b"k"], [[5, 100, 60, 1]], [0], [0]
    )
    return writer.to_bytes()


def test_trace_file_roundtrip_and_order():
    data = [_writer_bytes(m) for m in BOTH]
    assert data[0] == data[1]
    for m in BOTH:
        trace = m.Trace.loads(data[0])
        assert [k for k, _ in trace.records] == [2, 1, 3, 1]
        assert len(trace.windows) == 2
        assert trace.injection_schedule() == [
            ("launch", "transient", 3, 0.5)
        ]
        assert trace.outcome_vector() == b"\x01\x00\x00\x00"


_ITEM = st.one_of(
    st.binary(max_size=24),
    st.integers(0xFF00, 0xFFFF).map(lambda n: bytes([n % 251]) * n),
    st.sampled_from([b"", b"\xff", b"\xc3\x28", b"\xed\xa0\x80", b"a:b"]),
)
_I64 = st.integers(*I64)


@settings(max_examples=60, deadline=None,
          suppress_health_check=[HealthCheck.too_slow,
                                 HealthCheck.data_too_large])
@given(
    rows=st.lists(st.tuples(_ITEM, _I64, _I64, _I64, _I64,
                            st.integers(0, 255), st.integers(0, 255),
                            st.integers(0, 0xFFFF)), max_size=6),
    now=_I64,
    source=st.integers(0, 255),
    event=st.tuples(st.text(max_size=20), st.text(max_size=40)),
    injection=st.tuples(st.text(max_size=12), st.text(max_size=12),
                        st.integers(0, (1 << 32) - 1),
                        st.floats(allow_nan=False)),
)
def test_codec_bytes_equal_and_cross_decode(rows, now, source, event,
                                            injection):
    keys = [r[0] for r in rows]
    params = np.array([r[1:5] for r in rows], np.int64).reshape(-1, 4)
    planes = [np.array([r[i] for r in rows], np.int64) for i in (5, 6, 7)]
    data = []
    for m in BOTH:
        w = m.TraceWriter()
        w.add_window(now, source, keys, params, planes[0], planes[1],
                     planes[2])
        w.add_event(now, *event)
        w.add_injection(*injection)
        data.append(w.to_bytes())
    assert data[0] == data[1]
    for m in BOTH:
        trace = m.Trace.loads(data[0])
        (win,) = trace.windows
        assert win.keys == keys and win.now_ns == now
        np.testing.assert_array_equal(win.params, params)
        assert win.tenants.tolist() == planes[2].tolist()
        (ev,) = trace.events
        assert (ev.kind, ev.detail) == event
        assert trace.injection_schedule() == [injection]


def _fixture_trace(m):
    writer = m.TraceWriter()
    writer.add_window(
        T0, m.SOURCE_ENGINE, [b"ab", b"c"],
        [[5, 100, 60, 1], [5, 100, 60, 1]], [1, 1], [0, 0],
    )
    return writer.to_bytes()


def _lie(data):
    lie = bytearray(data)
    struct.pack_into("<I", lie, 6 + 5 + 9, 1 << 30)
    return bytes(lie)


def _kind(data):
    bad = bytearray(data)
    bad[10] = 200
    return bytes(bad)


# Every malformed shape of tests/test_replay.py::test_codec_rejection_fixtures
# (plus a frame over the size cap), as (name, call(module)).
_REJECTIONS = [
    ("bad-magic", lambda m: m.Trace.loads(b"XXXX" + _fixture_trace(m)[4:])),
    ("version", lambda m: m.Trace.loads(
        _fixture_trace(m)[:4] + b"\x63\x00" + _fixture_trace(m)[6:])),
    ("short-header", lambda m: m.Trace.loads(b"TCR")),
    ("truncated-frame-header", lambda m: m.Trace.loads(
        _fixture_trace(m)[:8])),
    ("truncated-body", lambda m: m.Trace.loads(_fixture_trace(m)[:-3])),
    ("unknown-kind", lambda m: m.Trace.loads(_kind(_fixture_trace(m)))),
    ("count-lie", lambda m: m.Trace.loads(_lie(_fixture_trace(m)))),
    ("over-cap", lambda m: m.Trace.loads(
        _fixture_trace(m)[:6] + struct.pack("<IB", m.MAX_FRAME + 1, 1))),
    ("window-trailing", lambda m: m.decode_window(
        m.encode_window(T0, 0, [b"k"], [[5, 100, 60, 1]], [1], [0])[5:]
        + b"\x00")),
    ("window-short", lambda m: m.decode_window(
        m.encode_window(T0, 0, [b"k"], [[5, 100, 60, 1]], [1], [0])[5:-1])),
    ("window-head", lambda m: m.decode_window(b"\x00" * 5)),
    ("event-empty", lambda m: m.decode_event(b"")),
    ("event-string", lambda m: m.decode_event(
        struct.pack("<qH", T0, 9) + b"ab")),
    ("injection-short", lambda m: m.decode_injection(b"\x01")),
    ("event-trailing", lambda m: m.decode_event(
        m.encode_event(T0, "x", "y")[5:] + b"z")),
    ("injection-trailing", lambda m: m.decode_injection(
        m.encode_injection("s", "m", 1)[5:] + b"z")),
    ("oversized-key", lambda m: m.encode_window(
        T0, 0, [b"x" * 70_000], [[5, 100, 60, 1]], [1], [0])),
    ("oversized-string", lambda m: m.encode_event(T0, "k" * 70_000)),
]


@pytest.mark.parametrize("name,call", _REJECTIONS,
                         ids=[r[0] for r in _REJECTIONS])
def test_codec_rejection_fixtures(name, call):
    """Every malformed shape raises the typed TraceError in both
    packages, at the same point (the same message)."""
    messages = []
    for m in BOTH:
        with pytest.raises(m.TraceError) as info:
            call(m)
        messages.append(str(info.value))
    assert messages[0] == messages[1], name


# ------------------------------------------------- flight recorder #


def _clock():
    t = {"now": T0}

    def clock():
        t["now"] += 7
        return t["now"]

    return clock


def _same_calls(rec_jax, rec_port, calls):
    for name, args, kw in calls:
        for rec in (rec_jax, rec_port):
            getattr(rec, name)(*args, **kw)


def _recorders(tmp_path, **kw):
    out = []
    for tag, m in (("jax", jax_rec), ("port", port_rec)):
        d = tmp_path / tag
        path = str(d / "full.tctr") if kw.get("mode") == "full" else None
        out.append(m.FlightRecorder(out_dir=str(d), path=path,
                                    clock=_clock(), **kw))
    return out


def _read(path):
    with open(path, "rb") as f:
        return f.read()


def test_ring_keeps_last_n_windows_and_all_events(tmp_path):
    rec_j, rec_p = _recorders(tmp_path, capacity=4)
    calls = [("record_window", (T0 + i, [f"k{i}"], [[5, 100, 60, 1]],
                                [1], [0]), {}) for i in range(10)]
    calls.insert(3, ("record_event", ("degrade", "boom"), {}))
    calls.insert(5, ("record_injection", ("launch", "count", 2, 1.0), {}))
    calls.append(("record_event", ("repromote", "3 buckets"),
                  {"now_ns": T0 + 99}))
    _same_calls(rec_j, rec_p, calls)
    (pj, nj), (pp, np_) = rec_j.dump(), rec_p.dump()
    assert nj == np_ == 4
    assert _read(pj) == _read(pp)
    assert rec_j.stats() == rec_p.stats()
    trace = port_trace.Trace.load(pp)
    assert [w.keys[0] for w in trace.windows] == [
        b"k6", b"k7", b"k8", b"k9"
    ]
    assert [e.kind for e in trace.events] == ["degrade", "repromote"]
    assert trace.injection_schedule() == [("launch", "count", 2, 1.0)]


def test_full_mode_records_every_window(tmp_path):
    rec_j, rec_p = _recorders(tmp_path, capacity=2, mode="full")
    calls = [("record_window", (T0 + i, [b"k%d" % i, "t:%d" % i],
                                [[5, 100, 60, 1], [2, 3, 4, 0]], [1, 0],
                                [0, 2]), {}) for i in range(9)]
    calls.insert(4, ("record_event", ("degrade", "x"), {}))
    _same_calls(rec_j, rec_p, calls)
    assert rec_j.stats() == rec_p.stats()
    paths = [rec_j.close(), rec_p.close()]
    assert _read(paths[0]) == _read(paths[1])
    assert len(port_trace.Trace.load(paths[1]).windows) == 9


def test_full_mode_default_path_is_per_process(tmp_path):
    rec = port_rec.FlightRecorder(mode="full", out_dir=str(tmp_path))
    rec.record_window(T0, [b"k"], [[5, 100, 60, 1]], [1], [0])
    path = rec.close()
    assert path == os.path.join(str(tmp_path), f"trace-{os.getpid()}.tctr")
    assert port_trace.Trace.load(path).n_rows() == 1


def test_full_mode_late_capture_never_truncates(tmp_path):
    rec_j, rec_p = _recorders(tmp_path, mode="full")
    calls = [("record_window", (T0 + i, [b"k"], [[5, 100, 60, 1]], [1],
                                [0]), {}) for i in range(3)]
    _same_calls(rec_j, rec_p, calls)
    paths = [rec_j.close(), rec_p.close()]
    _same_calls(rec_j, rec_p, [
        ("record_window", (T0 + 9, [b"late"], [[5, 100, 60, 1]], [1], [0]),
         {}),
        ("record_event", ("cluster-reweight", "0:0.5"), {}),
    ])
    assert _read(paths[0]) == _read(paths[1])
    assert len(port_trace.Trace.load(paths[1]).windows) == 3


def test_capture_never_raises_into_serving(tmp_path):
    rec_j, rec_p = _recorders(tmp_path, capacity=4)
    _same_calls(rec_j, rec_p, [(
        "record_window", (T0, [b"x" * 70_000, b"ok"],
                          [[5, 100, 60, 1]] * 2, [1, 1], [0, 0]), {},
    )])
    (pj, _), (pp, n) = rec_j.dump(), rec_p.dump()
    assert n == 1 and _read(pj) == _read(pp)
    w = port_trace.Trace.load(pp).windows[0]
    assert len(w.keys[0]) == 0xFFFF and w.keys[1] == b"ok"


def test_capture_errors_are_counted_not_raised(tmp_path, monkeypatch):
    """A failing capture never reaches the serving path, and it is not
    silent: `_capture_errors` counts it (the counter the card run
    asserts is 0).  A malformed window (params of the wrong shape) and
    a deliberately broken encoder each count one."""
    rec_j, rec_p = _recorders(tmp_path, mode="full")
    _same_calls(rec_j, rec_p, [(
        "record_window", (T0, [b"a", b"b"], [[5, 100, 60]], [1, 1],
                          [0, 0]), {},
    )])
    assert rec_j._capture_errors == rec_p._capture_errors == 1

    def broken(*a, **kw):
        raise RuntimeError("encoder broken on purpose")

    monkeypatch.setattr(port_rec, "encode_window", broken)
    rec_p.record_window(T0, [b"k"], [[5, 100, 60, 1]], [1], [0])
    assert rec_p._capture_errors == 2
    assert rec_p.windows_recorded == 1  # counted before the encode


def test_recorder_derives_tenant_ids(tmp_path):
    rec_j, rec_p = _recorders(tmp_path, capacity=8)
    _same_calls(rec_j, rec_p, [(
        "record_window", (T0, [b"acme:k1", b"globex:k2", b"bare",
                               b"acme:k3", b":lead"],
                          [[5, 100, 60, 1]] * 5, [1] * 5, [0] * 5), {},
    )])
    (pj, _), (pp, _) = rec_j.dump(), rec_p.dump()
    assert _read(pj) == _read(pp)
    w = port_trace.Trace.load(pp).windows[0]
    assert w.tenants[0] == w.tenants[3] != 0
    assert w.tenants[1] not in (0, w.tenants[0])
    assert w.tenants[2] == w.tenants[4] == 0


def test_from_config_and_tenant_delim_default(tmp_path):
    from throttlecrab_tpu.server.config import Config as JaxConfig
    from throttlecrab_tpu_torch.server.config import Config as PortConfig

    assert port_rec.from_config(PortConfig(http=True)) is None
    argv = ["--http", "--trace-dir", str(tmp_path), "--trace-mode", "full",
            "--trace-windows", "9"]
    rj = jax_rec.from_config(JaxConfig.from_env_and_args(argv))
    rp = port_rec.from_config(PortConfig.from_env_and_args(argv))
    assert not hasattr(PortConfig(), "tenant_delim")
    for attr in ("mode", "out_dir", "dump_on_degrade", "_delim"):
        assert getattr(rj, attr) == getattr(rp, attr), attr
    assert rj._ring.maxlen == rp._ring.maxlen == 9


def test_scheduled_injector_multi_firing_per_index():
    fired = []
    for m in (jax_faults, port_faults):
        slept = []
        inj = m.FaultInjector.from_schedule(
            [("launch", "hang", 0, 0.25), ("launch", "transient", 0, 0.9)],
            sleep_fn=slept.append,
        )
        with pytest.raises(m.InjectedDeviceError):
            inj.check("launch")
        assert slept == [0.25]
        fired.append(inj.fired_schedule())
    assert fired[0] == fired[1]
    assert [(m_, i) for _s, m_, i, _a in fired[1]] == [
        ("hang", 0), ("transient", 0)
    ]


def test_scheduled_injector_fires_exact_indexes():
    fired = []
    for m in (jax_faults, port_faults):
        inj = m.FaultInjector.from_schedule(
            [("launch", "count", 1, 0.0), ("launch", "transient", 3, 0.5)]
        )
        for i in range(5):
            if i in (1, 3):
                with pytest.raises(m.InjectedDeviceError):
                    inj.check("launch")
            else:
                inj.check("launch")
        inj.check("fetch")
        fired.append(inj.fired_schedule())
    assert fired[0] == fired[1]
    assert [i[2] for i in fired[1]] == [1, 3]


# ------------------------------------- record -> replay (engine) #


def _engine_keys(n, seed=5):
    """Hot-key abuse: 3/4 of the rows on 4 keys, the rest over 1000."""
    rng = np.random.default_rng(seed)
    hot = rng.integers(0, 4, n)
    cold = rng.integers(4, 1000, n)
    kid = np.where(rng.random(n) < 0.75, hot, cold)
    return [f"user:{k}" for k in kid.tolist()]


async def _drive_engine(side, windows=10, now_step_ns=NS // 2):
    if side == "jax":
        from throttlecrab_tpu.server.engine import BatchingEngine
        from throttlecrab_tpu.server.types import ThrottleRequest
        from throttlecrab_tpu.tpu.limiter import TpuRateLimiter

        limiter = TpuRateLimiter(capacity=2048)
    else:
        from throttlecrab_tpu_torch.server.engine import BatchingEngine
        from throttlecrab_tpu_torch.server.types import ThrottleRequest
        from throttlecrab_tpu_torch.tpu.limiter import TorchRateLimiter

        limiter = TorchRateLimiter(capacity=2048, device="cpu")
    clock = {"now": T0}
    engine = BatchingEngine(limiter, batch_size=32, max_linger_us=200,
                            now_fn=lambda: clock["now"])
    keys = _engine_keys(windows * 32)
    for step in range(windows):
        reqs = [ThrottleRequest(k, 4, 10, 60, 1)
                for k in keys[step * 32: (step + 1) * 32]]
        await asyncio.gather(*[engine.throttle(r) for r in reqs],
                             return_exceptions=True)
        clock["now"] += now_step_ns
    await engine.shutdown()


def _record(side, tmp_path, drive):
    m = jax_rec if side == "jax" else port_rec
    path = str(tmp_path / f"{side}.tctr")
    rec = m.FlightRecorder(mode="full", out_dir=str(tmp_path), path=path)
    m.arm(rec)
    try:
        drive()
    finally:
        rec.close()
        m.disarm()
    assert rec._capture_errors == 0
    return path


def _check_replays(path, n_rows):
    """Replay twice on the port's cpu target, equal to the recorded
    outcomes; differential_replay ok; JAX's summary on its device
    target equal to the port's."""
    trace = port_trace.Trace.load(path)
    assert trace.n_rows() == n_rows
    v1 = port_player.outcome_vector(
        port_player.replay(trace, _cpu_target(trace)))
    v2 = port_player.outcome_vector(
        port_player.replay(trace, _cpu_target(trace)))
    assert v1 == v2, "two replays of one trace diverged"
    assert v1 == trace.outcome_vector(), "replay != recorded outcomes"
    report = port_player.differential_replay(trace, _cpu_target(trace))
    assert report.ok, report.summary()
    want = jax_player.differential_replay(jax_trace.Trace.load(path),
                                          "device")
    assert report.summary() == want.summary()
    return trace


def test_engine_record_then_replay_byte_identical(tmp_path):
    path = _record("port", tmp_path,
                   lambda: asyncio.run(_drive_engine("port")))
    trace = _check_replays(path, 10 * 32)
    assert {w.source for w in trace.windows} == {port_trace.SOURCE_ENGINE}


def test_disarmed_engine_records_nothing(tmp_path):
    assert port_rec.FlightRecorder(capacity=4).windows_recorded == 0
    asyncio.run(_drive_engine("port", windows=2))
    assert port_rec.active_recorder() is None
    assert os.listdir(tmp_path) == []


def test_traces_cross_packages(tmp_path):
    """A trace the JAX engine recorded replays in the port, and one the
    port recorded replays in JAX, to equal outcome vectors (equal to
    what each recorded)."""
    for side in ("jax", "port"):
        path = _record(side, tmp_path,
                       lambda: asyncio.run(_drive_engine(side, windows=6)))
        t_port = port_trace.Trace.load(path)
        t_jax = jax_trace.Trace.load(path)
        got = port_player.outcome_vector(
            port_player.replay(t_port, _cpu_target(t_port)))
        want = jax_player.outcome_vector(
            jax_player.replay(t_jax, jax_player.make_target("device", t_jax)))
        assert got == want == t_port.outcome_vector(), side


def _resp(key, burst, count, period, qty=None):
    parts = [b"THROTTLE", key, b"%d" % burst, b"%d" % count, b"%d" % period]
    if qty is not None:
        parts.append(b"%d" % qty)
    return b"*%d\r\n" % len(parts) + b"".join(
        b"$%d\r\n%s\r\n" % (len(p), p) for p in parts)


def test_native_driver_record_then_replay(tmp_path):
    """The port's native RESP driver records each sub-batch (SOURCE
    NATIVE, raw wire key bytes, invalid params included) and the trace
    replays as the engine's does."""
    from throttlecrab_tpu_torch import native
    from throttlecrab_tpu_torch.server.metrics import Metrics
    from throttlecrab_tpu_torch.server.native_redis import (
        NativeRedisTransport,
    )
    from throttlecrab_tpu_torch.tpu.limiter import TorchRateLimiter

    if not native.wire_available():
        pytest.skip(f"no C++ wire server: {native.wire_build_error()}")
    rng = np.random.default_rng(11)
    kid = rng.integers(0, 40, 400)
    frames = [
        _resp(b"k:%d\xff" % k, 1 + k % 5, 2 + k % 7, 30, int(q))
        for k, q in zip(kid.tolist(), rng.integers(0, 3, 400).tolist())
    ] + [_resp(b"bad", 0, 1, 1)]
    clock = {"now": T0}

    async def run():
        transport = NativeRedisTransport(
            "127.0.0.1", 0,
            TorchRateLimiter(capacity=1024, keymap="native", device="cpu"),
            Metrics(), batch_size=64, max_linger_us=300,
            now_fn=lambda: clock["now"],
        )
        await transport.start()
        try:
            for chunk in range(0, len(frames), 100):
                with socket.create_connection(
                        ("127.0.0.1", transport.bound_port)) as s:
                    part = frames[chunk: chunk + 100]
                    s.sendall(b"".join(part))
                    data = b""
                    while data.count(b"\r\n") < 6 * sum(
                            f != frames[-1] for f in part) + (
                            1 if frames[-1] in part else 0):
                        data += s.recv(1 << 16)
                clock["now"] += NS // 3
        finally:
            await transport.stop()

    path = _record("port", tmp_path, lambda: asyncio.run(run()))
    trace = _check_replays(path, len(frames))
    assert {w.source for w in trace.windows} == {port_trace.SOURCE_NATIVE}
    keys = [k for w in trace.windows for k in w.keys]
    assert sorted(keys) == sorted(
        [b"k:%d\xff" % k for k in kid.tolist()] + [b"bad"])
    assert 2 in np.concatenate([w.status for w in trace.windows])


# -------------------------------------------- differential replay #


def _hostile_trace(m):
    writer = m.TraceWriter()
    rng = np.random.default_rng(23)
    pool = [b"hz:%d" % i for i in range(12)]
    profiles = [
        (1, 5, 30, 1), (5, 100, 60, 0), (3000, 60, 60, 1),
        (0, 10, 60, 1), (4, 10, 60, 1), (2, 2, 600, 1),
    ]
    now = T0
    for _step in range(30):
        n = int(rng.integers(2, 16))
        ks, ps = [], []
        for _ in range(n):
            ks.append(pool[int(rng.integers(len(pool)))])
            ps.append(profiles[int(rng.integers(len(profiles)))])
        writer.add_window(now, m.SOURCE_ENGINE, ks, np.asarray(ps, np.int64),
                          np.zeros(n, np.uint8), np.zeros(n, np.uint8))
        now += int(rng.integers(0, NS))
    return m.Trace.loads(writer.to_bytes())


def test_differential_replay_hostile_patterns_device():
    trace = _hostile_trace(port_trace)
    got = port_player.replay(trace, _cpu_target(trace))
    want = port_player.replay(trace, port_player.make_target("oracle", trace))
    for wi, ((ga, gs), (wa, ws)) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(gs, ws, err_msg=f"window {wi}")
        ok = ws == 0
        np.testing.assert_array_equal(ga[ok], wa[ok], err_msg=f"window {wi}")
    jt = _hostile_trace(jax_trace)
    jax_out = jax_player.replay(jt, jax_player.make_target("device", jt))
    assert (port_player.outcome_vector(got)
            == jax_player.outcome_vector(jax_out))


@pytest.mark.parametrize("pattern", port_gen.PATTERNS)
@pytest.mark.parametrize("seed", [0, 7])
def test_synthetic_trace_bytes_equal(tmp_path, pattern, seed):
    kw = dict(windows=6, batch=48, key_space=512, seed=seed)
    paths = []
    for tag, gen in (("jax", jax_gen), ("port", port_gen)):
        paths.append(gen.save(gen.synthesize(pattern, **kw),
                              str(tmp_path / f"{tag}.tctr")))
    assert _read(paths[0]) == _read(paths[1])
    trace = port_trace.Trace.load(paths[1])
    report = port_player.differential_replay(trace, _cpu_target(trace))
    assert report.ok, report.summary()


def test_generated_trace_saves_and_replays(tmp_path):
    trace = port_gen.synthesize("diurnal", windows=6, batch=32,
                                key_space=256, seed=9)
    path = str(tmp_path / "syn.tctr")
    port_gen.save(trace, path)
    loaded = port_trace.Trace.load(path)
    assert loaded.outcome_vector() == trace.outcome_vector()
    report = port_player.differential_replay(loaded, _cpu_target(loaded))
    assert report.ok, report.summary()


def test_unknown_pattern_and_sharded_target_refused():
    with pytest.raises(port_trace.TraceError):
        port_gen.synthesize("sawtooth")
    with pytest.raises(ValueError, match="ROADMAP A7"):
        port_player.make_target("sharded:2")
    with pytest.raises(ValueError, match="unknown replay target"):
        port_player.make_target("gpu")


def test_device_target_defaults_to_the_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: the default builds there")
    with pytest.raises(RuntimeError, match="cuda"):
        port_player.make_target("device")


# --------------------------------------- deterministic fault replay #


def _chaos_run(side, injector, recorder=None):
    """One degrade -> recover lifecycle under a supervised limiter with
    `injector` armed in `side`'s package; per-window outcome planes."""
    if side == "jax":
        from throttlecrab_tpu.server.supervisor import SupervisedLimiter
        from throttlecrab_tpu.tpu.limiter import TpuRateLimiter

        lim, fm, rm = TpuRateLimiter(capacity=512), jax_faults, jax_rec
    else:
        from throttlecrab_tpu_torch.server.supervisor import SupervisedLimiter
        from throttlecrab_tpu_torch.tpu.limiter import TorchRateLimiter

        lim = TorchRateLimiter(capacity=512, device="cpu")
        fm, rm = port_faults, port_rec
    lim.rate_limit_batch(["__warm__"], 5, 100, 60, 1, T0 - NS)
    sup = SupervisedLimiter(lim, retries=0, probe_interval_ms=1,
                            sleep_fn=lambda s: None)
    keys = [f"cr:{i % 6}" for i in range(8)]
    outcomes = []
    fm.arm(injector)
    if recorder is not None:
        rm.arm(recorder)
    try:
        now = T0
        for _step in range(12):
            res = sup.rate_limit_batch(keys, 3, 10, 60, 1, now)
            outcomes.append((np.asarray(res.allowed, np.uint8).copy(),
                             np.asarray(res.status, np.uint8).copy()))
            if recorder is not None:
                recorder.record_window(now, keys, [[3, 10, 60, 1]] * 8,
                                       res.allowed, res.status)
            now += 10 * NS
        assert sup.state == "ok" and sup.degrade_count >= 1
    finally:
        fm.disarm()
        rm.disarm()
    return outcomes


def test_fault_schedule_replay_reproduces_chaos_run(tmp_path):
    """Both packages run the same chaos run with capture; the traces are
    byte-identical, hold the fired injections and the degrade /
    repromote events, and injector_from_trace rebuilds the JAX
    package's fired schedule, replaying to the same outcomes."""
    live_out, schedules, datas = {}, {}, {}
    for side, fm, rm, pm in (("jax", jax_faults, jax_rec, jax_player),
                             ("port", port_faults, port_rec, port_player)):
        path = str(tmp_path / f"{side}.tctr")
        recorder = rm.FlightRecorder(mode="full", out_dir=str(tmp_path),
                                     path=path, dump_on_degrade=False,
                                     clock=_clock())
        live = fm.FaultInjector(fm.parse_spec("launch:count:2"), seed=11)
        live_out[side] = _chaos_run(side, live, recorder)
        recorder.close()
        datas[side] = _read(path)
        trace = (jax_trace if side == "jax" else port_trace).Trace.load(path)
        assert trace.injection_schedule() == live.fired_schedule()
        kinds = [e.kind for e in trace.events]
        assert "degrade" in kinds and "repromote" in kinds
        replayed = pm.injector_from_trace(trace)
        replay_out = _chaos_run(side, replayed)
        assert (port_player.outcome_vector(replay_out)
                == port_player.outcome_vector(live_out[side]))
        schedules[side] = replayed.fired_schedule()
    assert schedules["jax"] == schedules["port"] != []
    assert (port_player.outcome_vector(live_out["jax"])
            == port_player.outcome_vector(live_out["port"]))
    assert datas["jax"] == datas["port"]


# ------------------------------------------------- dump-on-degrade #


def _wait_for_dump(directory):
    deadline = time.monotonic() + 10
    while time.monotonic() < deadline:
        dumped = glob.glob(os.path.join(directory, "*.tctr"))
        if dumped:
            return dumped
        time.sleep(0.05)
    raise AssertionError("degrade produced no trace dump")


def test_supervisor_degrade_dumps_flight_recorder(tmp_path):
    """A degrade writes a ring dump holding the degrade event and the
    injection that caused it; the dump replays against the oracle with
    no mismatch on the rows it holds."""
    from throttlecrab_tpu_torch.server.supervisor import SupervisedLimiter
    from throttlecrab_tpu_torch.tpu.limiter import TorchRateLimiter

    rec = port_rec.FlightRecorder(capacity=64, out_dir=str(tmp_path))
    port_rec.arm(rec)
    lim = TorchRateLimiter(capacity=256, device="cpu")
    sup = SupervisedLimiter(lim, retries=0, probe_interval_ms=10_000,
                            sleep_fn=lambda s: None)
    keys = ["a", "b", "a", "c"]
    for step in range(3):
        res = sup.rate_limit_batch(keys, 2, 1, 60, 1, T0 + step)
        rec.record_window(T0 + step, keys, [[2, 1, 60, 1]] * 4,
                          res.allowed, res.status)
    port_faults.arm(port_faults.FaultInjector(
        port_faults.parse_spec("launch:count:1"), seed=1))
    res = sup.rate_limit_batch(["k"], 5, 100, 60, 1, T0 + 10)
    assert res.allowed[0] and sup.state == "degraded"
    (path,) = _wait_for_dump(str(tmp_path))
    trace = port_trace.Trace.load(path)
    assert [e.kind for e in trace.events] == ["degrade"]
    assert trace.injections[0].site == "launch"
    assert len(trace.windows) == 3
    report = port_player.differential_replay(
        trace, port_player.make_target("oracle", trace))
    assert report.ok and report.n_compared == 12, report.summary()


# ------------------------------------------------ lifecycle events #


def test_checkpoint_lifecycle_events_as_in_jax(tmp_path):
    from throttlecrab_tpu.persist import Checkpointer as JaxCheckpointer
    from throttlecrab_tpu.persist import recover_into as jax_recover
    from throttlecrab_tpu.tpu.limiter import TpuRateLimiter
    from throttlecrab_tpu_torch.persist import Checkpointer, recover_into
    from throttlecrab_tpu_torch.tpu.limiter import TorchRateLimiter

    events = {}
    for side, make, ck, rec_into, rm in (
        ("jax", lambda: TpuRateLimiter(capacity=256), JaxCheckpointer,
         jax_recover, jax_rec),
        ("port", lambda: TorchRateLimiter(capacity=256, device="cpu"),
         Checkpointer, recover_into, port_rec),
    ):
        d = tmp_path / side
        rec = rm.FlightRecorder(capacity=8, out_dir=str(d / "tr"))
        rm.arm(rec)
        lim = make()
        lim.rate_limit_batch(["a", "b", "c"], 5, 10, 60, 1, T0)
        cp = ck(lim, str(d / "ck"), interval_ns=1)
        cp.checkpoint_now(T0 + 1)
        lim.rate_limit_batch(["a"], 5, 10, 60, 1, T0 + 2)
        cp.note_keys(["a"])
        cp.checkpoint_now(T0 + 3)
        rec_into(make(), str(d / "ck"), T0 + 4)
        path, _ = rec.dump()
        rm.disarm()
        events[side] = [(e.now_ns, e.kind, e.detail)
                        for e in port_trace.Trace.load(path).events]
    assert events["jax"] == events["port"]
    assert [k for _, k, _ in events["port"]] == [
        "checkpoint", "checkpoint", "checkpoint-recovery"
    ]


# ------------------------------------------------ /trace/dump route #


def test_http_trace_dump_route(tmp_path):
    from throttlecrab_tpu.server.engine import BatchingEngine as JaxEngine
    from throttlecrab_tpu.server.http import HttpTransport as JaxHttp
    from throttlecrab_tpu.server.metrics import Metrics as JaxMetrics
    from throttlecrab_tpu.tpu.limiter import TpuRateLimiter
    from throttlecrab_tpu_torch.server.engine import BatchingEngine
    from throttlecrab_tpu_torch.server.http import HttpTransport
    from throttlecrab_tpu_torch.server.metrics import Metrics
    from throttlecrab_tpu_torch.tpu.limiter import TorchRateLimiter

    async def run(engine, transport, rm, d):
        status, payload, ctype = await transport._route(
            "GET", "/trace/dump", b"")
        disarmed = (status, payload, ctype)
        rec = rm.FlightRecorder(capacity=16, out_dir=str(d))
        rm.arm(rec)
        rec.record_window(T0, [b"k"], [[5, 100, 60, 1]], [1], [0])
        status, payload, ctype = await transport._route(
            "GET", "/trace/dump", b"")
        rm.disarm()
        await engine.shutdown()
        doc = json.loads(payload)
        return disarmed, status, ctype, doc

    out = {}
    for side, engine, http, metrics, rm in (
        ("jax", JaxEngine(TpuRateLimiter(capacity=256), batch_size=8,
                          max_linger_us=100, now_fn=lambda: T0),
         JaxHttp, JaxMetrics(), jax_rec),
        ("port", BatchingEngine(TorchRateLimiter(capacity=256, device="cpu"),
                                batch_size=8, max_linger_us=100,
                                now_fn=lambda: T0),
         HttpTransport, Metrics(), port_rec),
    ):
        transport = http("127.0.0.1", 0, engine, metrics)
        out[side] = asyncio.run(run(engine, transport, rm, tmp_path / side))
    (dj, sj, cj, docj), (dp, sp, cp, docp) = out["jax"], out["port"]
    assert dj == dp and dp[1] == b'{"enabled": false}'
    assert (sj, cj) == (sp, cp) == (200, "application/json")
    assert _read(docj["path"]) == _read(docp["path"])
    docj.pop("path"), docp.pop("path")
    assert docj == docp and docp["enabled"] and docp["windows"] == 1


# -------------------------------------------- fault-fired metrics #


def test_faults_injected_total_metric():
    from throttlecrab_tpu_torch.server.metrics import METRIC_NAMES, Metrics

    assert "throttlecrab_tpu_faults_injected_total" in METRIC_NAMES
    m = Metrics()
    assert "throttlecrab_tpu_faults_injected_total 0" in m.export_prometheus()
    inj = port_faults.FaultInjector(port_faults.parse_spec("keymap:count:2"),
                                    seed=3)
    port_faults.arm(inj)
    for _ in range(3):
        try:
            inj.check("keymap")
        except Exception:
            pass
    assert ('throttlecrab_tpu_faults_injected_total{site="keymap"} 2'
            in m.export_prometheus())


# -------------------------------------------------------------- CLI #


def _cli(main, argv, capsys):
    rc = main(argv)
    out = capsys.readouterr().out.strip().splitlines()
    return rc, json.loads(out[-1]) if out else None


def test_cli_json_equals_jax(tmp_path, capsys):
    """synth / info / replay / diff print the JAX package's JSON; the
    port's replay adds the device it ran on."""
    from throttlecrab_tpu.replay.__main__ import main as jax_main
    from throttlecrab_tpu_torch.replay.__main__ import main as port_main

    paths = {s: str(tmp_path / f"{s}.tctr") for s in ("jax", "port")}
    docs = {}
    for side, main in (("jax", jax_main), ("port", port_main)):
        rc, doc = _cli(main, ["synth", "--pattern", "flash-crowd",
                              "--windows", "5", "--batch", "40",
                              "--key-space", "300", "--seed", "4",
                              "-o", paths[side]], capsys)
        assert rc == 0
        doc.pop("path")
        docs[side] = [doc]
        for argv in (["info", paths[side]],
                     ["diff", paths["jax"], paths[side]]):
            rc, doc = _cli(main, argv, capsys)
            assert rc == 0
            docs[side].append(doc)
        target = ["--device", "cpu"] if side == "port" else []
        rc, doc = _cli(main, ["replay", paths[side]] + target, capsys)
        assert rc == 0 and doc["ok"]
        docs[side].append(doc)
    assert _read(paths["jax"]) == _read(paths["port"])
    assert docs["port"][-1].pop("device") == "cpu"
    assert docs["jax"] == docs["port"]
    assert docs["port"][2]["identical"] is True


def test_cli_refuses_sharded_target(tmp_path, capsys):
    from throttlecrab_tpu_torch.replay.__main__ import main

    path = str(tmp_path / "t.tctr")
    port_gen.save(port_gen.synthesize("diurnal", windows=2, batch=8), path)
    capsys.readouterr()
    assert main(["replay", path, "--target", "sharded:2"]) == 2
    assert "ROADMAP A7" in capsys.readouterr().err
