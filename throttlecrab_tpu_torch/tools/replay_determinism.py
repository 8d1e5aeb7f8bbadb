"""Replay-determinism gate: record a short workload through the real
batching engine with the flight recorder armed, then replay the captured
trace twice against fresh limiters and byte-diff the outcome vectors.

The counterpart of the JAX package's `scripts/replay_determinism.py`
(run by its CI), with its three contracts, each a hard failure:

1. two replays of one trace are byte-identical (determinism);
2. the replayed outcomes are byte-identical to the *recorded* outcomes
   (capture fidelity: the trace really carries the decisions made);
3. the replayed outcomes match the scalar oracle row-for-row
   (differential: replay drift vs the ground-truth engine is a bug).

The workload is recorded on, and the `device` target replays on, the
card unless `--cpu` asks for the plain version.  On the card a fourth
contract holds: `fused.LAUNCHES` moves by exactly the window launches
the three replays make — one per conflict round of each replayed
window (a key whose params change inside a window starts a new round).

    python -m throttlecrab_tpu_torch.tools.replay_determinism
        [--windows N] [--cpu]
"""

from __future__ import annotations

import argparse
import asyncio
import os
import sys
import tempfile

import numpy as np

from ..tpu import fused
from .card import pick_device, sync

NS = 1_000_000_000
T0 = 1_753_700_000 * NS


async def record_workload(trace_path: str, windows: int, device) -> None:
    from ..harness.workload import make_keys
    from ..replay.recorder import FlightRecorder, arm, disarm
    from ..server.engine import BatchingEngine
    from ..server.types import ThrottleRequest
    from ..tpu.limiter import TorchRateLimiter

    recorder = FlightRecorder(
        mode="full", out_dir=os.path.dirname(trace_path),
        path=trace_path,
    )
    arm(recorder)
    try:
        clock = {"now": T0}
        engine = BatchingEngine(
            TorchRateLimiter(capacity=4096, device=device),
            batch_size=64,
            max_linger_us=200,
            now_fn=lambda: clock["now"],
        )
        keys = make_keys("hotkey-abuse", windows * 64, 2000, seed=11)
        for step in range(windows):
            reqs = [
                ThrottleRequest(k, 4, 10, 60, 1)
                for k in keys[step * 64: (step + 1) * 64]
            ]
            await asyncio.gather(
                *[engine.throttle(r) for r in reqs],
                return_exceptions=True,
            )
            clock["now"] += NS // 2
        await engine.shutdown()
    finally:
        recorder.close()
        disarm()


def conflict_rounds(window) -> int:
    """Window launches one replay of `window` makes: its valid rows'
    largest count of param runs on one key (0 with no valid row)."""
    from ..tpu.limiter import derive_params

    p = np.asarray(window.params, np.int64)
    _, _, invalid = derive_params(p[:, 0], p[:, 1], p[:, 2])
    ok = ~invalid & (p[:, 3] >= 0)
    runs: dict = {}
    for key, row, valid in zip(window.keys, map(tuple, p), ok):
        if not valid:
            continue
        last, n = runs.get(key, (None, 0))
        runs[key] = (row, n + (row != last))
    return max((n for _, n in runs.values()), default=0)


def check(trace, dev):
    """The three contracts (and on the card the fourth) over `trace`;
    returns (error or None, {"launches": ..., "expected_launches": ...})."""
    from ..replay.player import (
        differential_replay,
        make_target,
        outcome_vector,
        replay,
    )

    counts = {"expected_launches": 3 * sum(
        conflict_rounds(w) for w in trace.windows)}
    sync(dev)
    before = fused.LAUNCHES
    v1 = outcome_vector(replay(trace, make_target("device", trace,
                                                  device=dev)))
    v2 = outcome_vector(replay(trace, make_target("device", trace,
                                                  device=dev)))
    if v1 != v2:
        return "FAIL: two replays diverged byte-wise", counts
    if v1 != trace.outcome_vector():
        return "FAIL: replayed outcomes differ from recorded outcomes", counts
    report = differential_replay(
        trace, make_target("device", trace, device=dev))
    if not report.ok:
        for m in (report.vs_oracle + report.vs_recorded)[:16]:
            print(str(m), file=sys.stderr)
        return "FAIL: differential replay mismatches", counts
    sync(dev)
    counts["launches"] = fused.LAUNCHES - before
    if dev.type == "cuda" and counts["launches"] != counts[
            "expected_launches"]:
        return (f"FAIL: {counts['launches']} window launches for "
                f"{counts['expected_launches']} conflict rounds"), counts
    return None, counts


def run(windows, dev):
    """Record `windows` windows on `dev`, then check the trace: (exit
    code, launch counts, the PASS or FAIL line)."""
    from ..replay.trace import Trace

    with tempfile.TemporaryDirectory() as d:
        trace_path = os.path.join(d, "ci.tctr")
        asyncio.run(record_workload(trace_path, windows, dev))
        trace = Trace.load(trace_path)
    if not trace.windows:
        return 1, {}, "FAIL: recorder captured no windows"
    error, counts = check(trace, dev)
    if error:
        return 1, counts, error
    return 0, counts, (
        f"PASS: {len(trace.windows)} windows / {trace.n_rows()} rows "
        "— replay x2 byte-identical, recorded-equal, oracle-exact"
    )


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--windows", type=int, default=24)
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args(argv)
    dev = pick_device(args.cpu)
    rc, counts, line = run(args.windows, dev)
    if rc:
        print(line, file=sys.stderr)
        return rc
    if dev.type == "cuda":
        print(f"{dev}: {counts['launches']} window launches for "
              f"{counts['expected_launches']} conflict rounds over 3 "
              "replays", file=sys.stderr)
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
