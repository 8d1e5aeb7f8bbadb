"""The port's profiling hook (tpu/profiling.py and the engine's capture of
its first launches, `--profile-dir`), on the CPU.

The JAX package writes an xprof trace there; the port writes a
torch.profiler Chrome trace.  Checked: `trace()` writes a loadable
Chrome trace holding an `annotate` span; an engine with `profile_dir`
captures exactly its first N launches (their named spans are in the
trace, the launches after them are not), writes the trace when the next
launch comes, and stops; shutdown writes a capture that is still open;
and an engine without `profile_dir` never starts the profiler.

The program's spans (`profiling.span`, `recording()`): off, a span is
the shared no-op that takes no timestamp, calls no `record_function`
and allocates nothing, and `annotate` outside a capture is that no-op
too; a recording of a `device="cpu"` by-id launch holds its seven
spans once each, nested as the launch runs them; a host finish on
another thread is recorded with that thread and its CPU time; the w32
finish notes its words and whether the native pass decoded them, and
moves `kernel.FINISH_W32_NATIVE_WORDS` by as many; under a
profiler the recording thread's spans have twins, and every span lands
on the profiler's clock.
"""

import asyncio
import glob
import json
import os
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from throttlecrab_tpu_torch import native, spans
from throttlecrab_tpu_torch.server.engine import BatchingEngine
from throttlecrab_tpu_torch.server.types import ThrottleRequest
from throttlecrab_tpu_torch.tpu import kernel, profiling
from throttlecrab_tpu_torch.tpu.kernel import finish_w32
from throttlecrab_tpu_torch.tpu.limiter import TorchRateLimiter, derive_params
from throttlecrab_tpu_torch.tpu.table import BucketTable, _uploaded

REPO = Path(__file__).resolve().parent.parent
NS = 1_000_000_000
T0 = 1_753_700_000 * NS


def _spans(path, name):
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    return sum(1 for e in events if e.get("name") == name)


def test_trace_writes_chrome_trace_with_annotations(tmp_path):
    import torch

    with profiling.trace(str(tmp_path)) as session:
        with profiling.annotate("tc_span"):
            torch.ones(8).sum()
    assert os.path.dirname(session.path) == str(tmp_path)
    assert _spans(session.path, "tc_span") == 1


async def _windows(engine, clock, n):
    """`n` windows of 8 requests, one launch each, awaited in turn."""
    for step in range(n):
        reqs = [ThrottleRequest(f"k{step}:{i}", 5, 10, 60, 1)
                for i in range(8)]
        await asyncio.gather(*[engine.throttle(r) for r in reqs])
        clock["now"] += NS


def test_engine_profiles_first_launches_then_stops(tmp_path):
    clock = {"now": T0}
    profile_dir = str(tmp_path / "prof")

    async def run():
        engine = BatchingEngine(
            TorchRateLimiter(capacity=256, device="cpu"), batch_size=8,
            max_linger_us=100, now_fn=lambda: clock["now"],
            profile_dir=profile_dir, profile_launches=3,
        )
        await _windows(engine, clock, 3)
        assert engine._profile is not None  # still capturing
        assert glob.glob(os.path.join(profile_dir, "*.json")) == []
        await _windows(engine, clock, 3)  # the 4th launch stops it
        assert engine._profile is None and engine._launch_pool is None
        await engine.shutdown()

    asyncio.run(run())
    (path,) = glob.glob(os.path.join(profile_dir, "trace-*.json"))
    # The engine decides a window through dispatch_many: the first three
    # launches' spans, and none of the later ones.
    assert _spans(path, "gcra_dispatch") == 3


def test_engine_shutdown_writes_an_open_capture(tmp_path):
    clock = {"now": T0}

    async def run():
        engine = BatchingEngine(
            TorchRateLimiter(capacity=256, device="cpu"), batch_size=8,
            max_linger_us=100, now_fn=lambda: clock["now"],
            profile_dir=str(tmp_path), profile_launches=50,
        )
        await _windows(engine, clock, 2)
        await engine.shutdown()
        assert engine._profile is None

    asyncio.run(run())
    (path,) = glob.glob(os.path.join(str(tmp_path), "trace-*.json"))
    assert _spans(path, "gcra_dispatch") == 2


def test_engine_without_profile_dir_never_profiles(tmp_path):
    clock = {"now": T0}

    async def run():
        engine = BatchingEngine(
            TorchRateLimiter(capacity=256, device="cpu"), batch_size=8,
            max_linger_us=100, now_fn=lambda: clock["now"],
        )
        await _windows(engine, clock, 2)
        assert engine._profile is None and engine._launch_pool is None
        await engine.shutdown()

    asyncio.run(run())


# ---- the program's spans ---------------------------------------------------

BYID = {  # span -> its parent in one by-id launch
    "tc.ids.launch": None,
    "tc.ids.prepare": "tc.ids.launch",
    "tc.ids.front": "tc.ids.launch",
    "tc.ids.front.gather": "tc.ids.front",
    "tc.ids.front.segments": "tc.ids.front",
    "tc.ids.front.pack": "tc.ids.front",
    "tc.ids.window": "tc.ids.launch",
}


def _byid_table(n_ids=20):
    """A cpu table with resident id rows, and one K=4 x B=16 launch's ids
    (a few repeated within a sub-batch, one padding lane) and times."""
    table = BucketTable(64, device="cpu")
    em, tol, _ = derive_params(np.full(n_ids, 5), np.full(n_ids, 10),
                               np.full(n_ids, 60))
    rows = table.upload_id_rows(np.arange(n_ids), em, tol)
    ids = np.random.default_rng(0).integers(0, n_ids, (4, 16), np.int32)
    ids[0, 3] = -1
    now = T0 + np.arange(4, dtype=np.int64) * 1_000_000
    return table, rows, ids, now


def _launch(table, rows, ids, now):
    return table.check_many_ids(rows, ids, now, 1, with_degen=False,
                                compact="w32")


def _no_clock_no_twin(monkeypatch):
    def fail(*_a, **_k):
        raise AssertionError("an off span reached the clock or profiler")

    class Clock:
        perf_counter_ns = thread_time_ns = staticmethod(fail)

    monkeypatch.setattr(profiling, "record_function", fail)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", fail)
    monkeypatch.setattr(spans, "time", Clock)


def test_an_off_span_is_the_shared_noop(monkeypatch):
    _no_clock_no_twin(monkeypatch)
    assert profiling.span("tc.x") is profiling.OFF
    assert profiling.span("tc.x", 7) is profiling.OFF
    with profiling.span("tc.x") as bound:
        assert bound is None
    # The instrumented paths run with nothing recording.
    table, rows, ids, now = _byid_table()
    finish_w32(_launch(table, rows, ids, now).numpy())
    assert table.launch_seq == 1

    def spans():
        for _ in range(10_000):
            with profiling.span("tc.x", 3):
                pass

    spans()
    before = sys.getallocatedblocks()
    spans()
    assert sys.getallocatedblocks() - before < 100


def test_the_host_layers_record_without_torch():
    """native.py (the keymap under tpu/limiter.py) takes its spans from
    a module that loads no torch, so it imports without the device
    backend."""
    code = ("import sys; import throttlecrab_tpu_torch.native as n; "
            "from throttlecrab_tpu_torch import spans; "
            "assert n.span is spans.span; "
            "assert 'torch' not in sys.modules, 'torch'; "
            "assert not any(m.startswith('throttlecrab_tpu_torch.tpu') "
            "for m in sys.modules), 'tpu'")
    subprocess.run([sys.executable, "-c", code], check=True, cwd=REPO)


def test_annotate_outside_a_capture_is_the_noop(monkeypatch):
    _no_clock_no_twin(monkeypatch)
    assert profiling.annotate("gcra_dispatch") is profiling.OFF
    with profiling.annotate("gcra_dispatch") as bound:
        assert bound is None


def test_recording_one_cpu_by_id_launch():
    table, rows, ids, now = _byid_table()
    _launch(table, rows, ids, now)  # launch 1, not recorded
    with profiling.recording() as rec:
        _launch(table, rows, ids, now)
    spans = {s.name: s for s in rec.spans}
    assert sorted(s.name for s in rec.spans) == sorted(BYID)
    me = threading.get_ident()
    for name, parent in BYID.items():
        s = spans[name]
        assert s.thread == me and s.launch == 2
        assert (s.parent.name if s.parent else None) == parent
        if s.parent is not None:
            assert s.parent.start <= s.start <= s.end <= s.parent.end
        inner = sum(c.end - c.start for c in rec.spans if c.parent is s)
        assert s.end - s.start - inner >= 0
    outer = spans["tc.ids.launch"]
    assert 0 <= outer.cpu <= outer.end - outer.start
    assert all(s.cpu is None for s in rec.spans if s is not outer)
    # Nothing leaves the host on the CPU.
    assert spans["tc.ids.prepare"].attrs == {"K": 4, "B": 16,
                                             "upload": False}
    with profiling.recording() as rec:
        _launch(table, rows, torch.as_tensor(ids), torch.as_tensor(now))
    (prep,) = [s for s in rec.spans if s.name == "tc.ids.prepare"]
    assert prep.attrs["upload"] is False and prep.launch == 3


def test_an_upload_is_a_copy_onto_a_device():
    """The prepare span's `upload`: a conversion that copied an input
    onto a device from elsewhere (the meta device stands in for a
    card), and not one that found it there or stayed on the host."""
    host = np.arange(4, dtype=np.int32)
    on_dev = torch.as_tensor(host).to("meta")
    assert _uploaded(host, on_dev)
    assert _uploaded(torch.as_tensor(host), on_dev)
    assert not _uploaded(on_dev, on_dev.to(torch.int32))
    assert not _uploaded(host, torch.as_tensor(host))


def _finish_raw_work():
    """finish_raw of a cur launch's output on the native keymap (built
    with g++), as a call to make on another thread."""
    lim = TorchRateLimiter(capacity=64, device="cpu", keymap="native")
    km = lim.keymap
    km.intern([b"k%d" % i for i in range(8)])
    em, tol, _ = derive_params(np.full(8, 5), np.full(8, 10), np.full(8, 60))
    rows = lim.table.upload_id_rows(km.resolve_all(), em, tol, keymap=km)
    ids = np.arange(8, dtype=np.int32)[None]
    cur2 = lim.table.check_many_ids(rows, ids, np.array([T0]), 1,
                                    with_degen=False, compact="cur")
    return lambda: km.finish_raw(ids[0], em, tol, 1, cur2.numpy()[0], T0)


@pytest.mark.parametrize("tier", ["w32", "raw"])
def test_a_finish_on_another_thread_is_its_own(tier):
    if tier == "w32":
        table, rows, ids, now = _byid_table()
        words = _launch(table, rows, ids, now).numpy().reshape(-1)
        work = lambda: finish_w32(words)  # noqa: E731
    else:
        work = _finish_raw_work()
    seen = {}

    def worker():
        seen["thread"] = threading.get_ident()
        work()

    with profiling.recording() as rec:
        t = threading.Thread(target=worker)
        t.start()
        t.join(timeout=60)
    assert not t.is_alive()
    (s,) = rec.spans
    assert s.name == f"tc.finish.{tier}" and s.thread == seen["thread"]
    assert s.parent is None and s.launch is None
    assert 0 <= s.cpu <= s.end - s.start


def test_the_w32_finish_notes_its_words_and_path():
    table, rows, ids, now = _byid_table()
    words = _launch(table, rows, ids, now).numpy().reshape(-1)
    before = kernel.FINISH_W32_NATIVE_WORDS
    with profiling.recording() as rec:
        finish_w32(words)
    (s,) = rec.spans
    assert s.name == "tc.finish.w32"
    lib = native.get_finish_lib()
    assert s.attrs == {"words": words.size, "native": lib is not None}
    moved = words.size if lib is not None else 0
    assert kernel.FINISH_W32_NATIVE_WORDS - before == moved


def test_one_recording_at_a_time():
    with profiling.recording():
        with pytest.raises(RuntimeError):
            with profiling.recording():
                pass
    assert profiling.span("tc.x") is profiling.OFF


def test_spans_on_the_profiler_clock():
    table, rows, ids, now = _byid_table()
    _launch(table, rows, ids, now)  # the first record_function is slow
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with profiling.recording() as rec:
            for _ in range(3):
                words = _launch(table, rows, ids, now).numpy().reshape(-1)
            t = threading.Thread(target=finish_w32, args=(words,))
            t.start()
            t.join(timeout=60)
    clock = rec.on_profiler_clock(prof.profiler.kineto_results.events())
    twins = clock["twins"]
    assert len(twins) == 3 * len(BYID)
    assert {s.name for _, _, s in twins} == set(BYID)
    assert clock["disagreement_ns"] >= 0
    at = {id(s): (a, b) for s, a, b in clock["spans"]}
    for s, a, b in clock["spans"]:
        assert b - a >= 0
        if s.name == "tc.finish.w32":  # no twin: moved by the offset
            assert (a, b) == (s.start + clock["offset_ns"],
                              s.end + clock["offset_ns"])
        elif s.parent is not None:  # a twin lies inside its parent's
            pa, pb = at[id(s.parent)]
            assert pa <= a <= b <= pb
    # Outside a capture nothing has a twin to be read by.
    with profiling.recording() as rec:
        _launch(table, rows, ids, now)
    with pytest.raises(RuntimeError):
        rec.on_profiler_clock([])
