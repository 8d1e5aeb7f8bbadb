"""The port's profiling hook (tpu/profiling.py and the engine's capture of
its first launches, `--profile-dir`), on the CPU.

The JAX package writes an xprof trace there; the port writes a
torch.profiler Chrome trace.  Checked: `trace()` writes a loadable
Chrome trace holding an `annotate` span; an engine with `profile_dir`
captures exactly its first N launches (their named spans are in the
trace, the launches after them are not), writes the trace when the next
launch comes, and stops; shutdown writes a capture that is still open;
and an engine without `profile_dir` never starts the profiler.
"""

import asyncio
import glob
import json
import os

from throttlecrab_tpu_torch.server.engine import BatchingEngine
from throttlecrab_tpu_torch.server.types import ThrottleRequest
from throttlecrab_tpu_torch.tpu import profiling
from throttlecrab_tpu_torch.tpu.limiter import TorchRateLimiter

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
