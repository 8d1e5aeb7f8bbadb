"""The program's own spans in a traced run of a by-id cell, reduced.

    python3 -m portbench.spans --workload NAME --seed N --seconds S

Runs the cell once as `python3 -m portbench.run --trace 1` does, with
the port's span recording (`throttlecrab_tpu_torch/tpu/profiling.py`,
`recording()`) on around the window, and prints the run's result line
with a `spans` object beside its metrics: the by-id launch split by
program stage on the host (`tc.ids.prepare`, `tc.ids.front`,
`tc.ids.window`, the wait inside `tc.ids.launch`), the front end's
device time by stage, the host finish's own span, the window's idle
time split by the program's innermost spans before the harness's
labels, and the checks that hold the split to the harness's readings.

The reductions (`host_split`, `device_split`, `idle_gaps`, and the
filter `program_annotation` that `trace.Tracer.records` needs) work on
a Recording, the profiler's events and the loop's window record alone,
for the harness to call once it records the program's spans itself.
The runner here (`record_run`, `main`, and `SpanTracer`) is temporary:
the benchmark does not run it, and reading the spans there takes edits
to `run.py`, `loops/byid.py` and `trace.py` (PERF.md section 7).  The
`benchmark` change that makes them, and adds the per-layer entries
these readings feed, deletes the runner rather than keeping it beside
`run.py`.  Meanwhile it stands in for those edits in one process:
- the loop's window runs inside `recording()` when traced;
- the profiler session keeps its events for the reduction, and its
  `records()` drops the `tc.*` spans' annotations on the device's
  timeline (as `trace.py` skips `ids.dispatch`'s): a `record_function`
  range shows there too, over the kernels it queued, and counted as a
  record it would change `kernels_a_launch`, `ids.front_device_ms`,
  `ids_window_roofline` and `device.idle`.

A program without the recording (the parent of the commit that added
it) leaves the `spans` object out and exits 0.
"""

from __future__ import annotations

import bisect
import statistics
import sys

from . import trace
from .trace import COPY, WINDOW, _clip, _minus, _union

PROGRAM = "tc."
# The dispatching thread's stages, innermost first where they nest, then
# the pool's: the order in which they take the window's idle time.
STAGES = ("tc.ids.prepare", "tc.ids.front.gather", "tc.ids.front.segments",
          "tc.ids.front.pack", "tc.ids.front", "tc.ids.window",
          "tc.ids.launch", "tc.finish.w32", "tc.finish.raw")
FRONT = ("tc.ids.front.gather", "tc.ids.front.segments", "tc.ids.front.pack")


def program_annotation(name: str) -> bool:
    """Whether a record on the device's timeline is a program span's
    annotation (the `record_function` range over the kernels the span
    queued), not a record of the card's work."""
    return name.startswith(PROGRAM)


class SpanTracer(trace.Tracer):
    """The harness's profiler session, keeping its events and dropping
    the program's annotations from its device records (temporary: see
    the module's docstring)."""

    def records(self):
        if not hasattr(self, "kept"):
            self.events = list(self.prof.profiler.kineto_results.events())
            dev, dispatch = super().records()
            kept = [r for r in dev if not program_annotation(r[2])]
            self.annotations = len(dev) - len(kept)
            self.kept = kept, dispatch
        return self.kept


def _mean_ms(values, n):
    return sum(values) / n / 1e6 if n else None


def host_split(rec) -> dict:
    """Mean ms a launch of each host stage's wall time, and of the time
    the dispatching thread waited inside the launch (wall minus its CPU
    time); the finish's mean ms a call."""
    launches = [s for s in rec.spans if s.name == "tc.ids.launch"]
    n = len(launches)
    walls = {}
    for s in rec.spans:
        walls.setdefault(s.name, []).append(s.end - s.start)
    out = {
        "ids.prepare_ms": _mean_ms(walls.get("tc.ids.prepare", []), n),
        "ids.launch_wait_ms": _mean_ms(
            [s.end - s.start - s.cpu for s in launches], n),
        "ids.front_host_ms": _mean_ms(walls.get("tc.ids.front", []), n),
        "ids.window_host_ms": _mean_ms(walls.get("tc.ids.window", []), n),
    }
    fin = walls.get("tc.finish.w32", [])
    out["finish.w32_span_ms"] = _mean_ms(fin, len(fin))
    out["launch_ms"] = _mean_ms(walls.get("tc.ids.launch", []), n)
    out["launches_recorded"] = n
    # What the prepare spans noted: the launches' shapes, and the share
    # that uploaded an input to the card themselves (which waits for the
    # stream; the loop copies its inputs itself, so 0).
    prep = [s.attrs for s in rec.spans if s.name == "tc.ids.prepare"]
    if prep:
        out["launch_shapes"] = sorted({(a["K"], a["B"]) for a in prep})
        out["ids.prepare_upload_share"] = \
            100.0 * sum(a["upload"] for a in prep) / len(prep)
    return {k: v for k, v in out.items() if v is not None}


def _innermost(twins, starts, at, h):
    """The innermost twinned span open at host time h, or None."""
    i = bisect.bisect_right(starts, h) - 1
    s = twins[i][2] if i >= 0 else None
    while s is not None and at[id(s)][1] < h:
        s = s.parent
    return s


def device_split(rec, tracer, win, red) -> dict:
    """The front end's device ms a launch by stage: every kernel record
    given, through the CUDA call that queued it, to the innermost
    program span on the dispatching thread that the call ran in; the
    window's idle time by innermost program span, then by the harness's
    labels; and the checks."""
    clock = rec.on_profiler_clock(tracer.events)
    twins = clock["twins"]
    starts = [a for a, _, _ in twins]
    at = {id(s): (a, b) for s, a, b in clock["spans"]}
    by_stage, outside, kernels = {}, 0, 0
    dev, dispatch = tracer.records()
    for a, b, name, h in dev:
        if name.startswith(COPY):
            continue
        s = _innermost(twins, starts, at, h) if h is not None else None
        if s is None:
            outside += 1
            continue
        kernels += 1
        key = "window_kernel" if (s.name == "tc.ids.window"
                                  and WINDOW in name) else s.name
        by_stage[key] = by_stage.get(key, 0) + (b - a)
    n = sum(1 for _, _, s in twins if s.name == "tc.ids.launch")
    out = {f"ids.front_{st.rsplit('.', 1)[1]}_device_ms":
           by_stage.get(st, 0) / n / 1e6 for st in FRONT}
    window_other = by_stage.get("tc.ids.window", 0) / n / 1e6
    out["checks"] = {
        "launches_twinned": n,
        "launches_traced": len(red["front_ms"]),
        "kernel_records_in_spans": kernels,
        "kernel_records_outside": outside,
        "kernels_a_launch": red["kernels_a_launch"],
        "annotations_skipped": tracer.annotations,
        "window_records_not_kernel_ms": window_other,
        "front_by_stage_ms": sum(out.values()) + window_other,
        "front_device_ms": float(red["front_ms"].mean()),
        "records_in_other_spans": sorted(
            k for k in by_stage
            if k not in FRONT + ("tc.ids.window", "window_kernel")),
        "clock_offset_ns": clock["offset_ns"],
        "clock_disagreement_ns": clock["disagreement_ns"],
        "clock_slack_ns": clock["slack_ns"],
    }
    out["idle_gaps"] = idle_gaps(clock, dev, dispatch, win)
    return out


def idle_gaps(clock, dev, dispatch, win):
    """[(label, seconds)]: the window's idle time on the device split by
    the program's innermost spans (in STAGES' order), then by the
    harness's labels over what they leave (`trace.idle_by_host`, the
    stages' share counted as busy; the pool's spans moved by the
    program's clock offset), then "other"; its total is trace.reduce's
    window_s - busy_s."""
    off = statistics.median(s[0] - h * 1e9
                            for s, h in zip(dispatch, win["dispatch"][:, 0]))
    lo, hi = win["t_start"] * 1e9 + off, win["t_end"] * 1e9 + off
    busy = [(a, b) for a, b in
            _union(_clip([(a, b) for a, b, _, _ in dev], lo, hi))]
    spans = clock["spans"]
    kids = {}
    for s, a, b in spans:
        if s.parent is not None:
            kids.setdefault(id(s.parent), []).append((a, b))
    own = {}  # stage -> its spans' time outside their children
    for s, a, b in spans:
        rest = _minus(a, b, _union(kids.get(id(s), [])))
        own.setdefault(s.name, []).extend(rest)
    out, taken = [], []
    for name in STAGES:
        if name not in own:
            continue
        free = _union(busy + taken)
        took = [part for a, b in _union(_clip(own[name], lo, hi))
                for part in _minus(a, b, free)]
        out.append((name, sum(b - a for a, b in took) / 1e9))
        taken += took
    fin = win["finish"]
    moved = clock["offset_ns"]
    host = {
        "ids.dispatch": list(dispatch),
        "finish.fetch": [(a * 1e9 + moved, b * 1e9 + moved)
                         for a, b, _ in fin],
        "finish.w32": [(b * 1e9 + moved, c * 1e9 + moved)
                       for _, b, c in fin],
    }
    out += trace.idle_by_host(_union(busy + taken), lo, hi, host)
    return sorted(out, key=lambda kv: -kv[1])


def record_run(run_cell, root, workload, seed, seconds, device="cuda",
               log=print) -> dict:
    """One traced run of the cell through `run_cell` (`run.run_cell`)
    with the window recorded: its result line plus `spans`, left out
    where the program has no recording."""
    from .loops import byid

    try:
        from throttlecrab_tpu_torch.tpu.profiling import recording
    except ImportError:
        recording = None
    kept = {}
    window, tracer, reduce = byid.Loop.window, trace.Tracer, trace.reduce

    def recorded_window(loop, secs):
        if recording is None or not loop.traced:
            return window(loop, secs)
        with recording() as kept["rec"]:
            kept["win"] = window(loop, secs)
        return kept["win"]

    class Kept(SpanTracer):
        def __init__(self):
            super().__init__()
            kept["tracer"] = self

    def kept_reduce(*a):
        kept["red"] = reduce(*a)
        return kept["red"]

    byid.Loop.window, trace.Tracer, trace.reduce = (recorded_window, Kept,
                                                    kept_reduce)
    try:
        out = run_cell(root, workload, seed, seconds, True, device=device,
                       log=log)
    finally:
        byid.Loop.window, trace.Tracer, trace.reduce = window, tracer, reduce
    if "rec" not in kept:
        return out
    out["spans"] = host_split(kept["rec"])
    if "red" in kept:
        out["spans"].update(device_split(kept["rec"], kept["tracer"],
                                         kept["win"], kept["red"]))
    return out


def main(argv=None) -> int:
    """`run.main` with --trace 1, each run recorded (its set-up of the
    caches and its checks of the card and the imports included)."""
    from . import run

    inner = run.run_cell
    run.run_cell = lambda root, workload, seed, seconds, _traced, **kw: \
        record_run(inner, root, workload, seed, seconds, **kw)
    args = list(sys.argv[1:] if argv is None else argv)
    return run.main(args + ["--trace", "1"])


if __name__ == "__main__":
    sys.exit(main())
