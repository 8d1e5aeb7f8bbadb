"""The program's own spans: stages of its work, recorded on demand.

`span(name)` marks a stage (the by-id launch and its front end in
`tpu/table.py` / `tpu/kernel.py`, the host finish in `kernel.finish_w32`
and `native.py` `finish_raw`; names start with `tc.`).  It records only
inside `recording()`: otherwise it returns the shared no-op `OFF` after
one module-level check, and takes no time, calls nothing and allocates
nothing.  While recording, every thread's spans are kept in memory with
their thread, parent and launch, on the host's `perf_counter_ns` clock;
each thread's outermost span also keeps the thread's CPU time, so wall
minus CPU is the time the thread waited.  If a `torch.profiler` capture
is running when the recording starts, the starting thread's spans also
enter `record_function`: their twins lie on the profiler's clock, the
CUDA work they queue carries them, and `Recording.on_profiler_clock`
moves every span (other threads' too) onto that clock by the offset the
twins show.

Nothing here imports torch until a recording meets a running capture,
so the host layers (`native.py`) use it without loading the device
backend.  `tpu/profiling.py` re-exports it beside its capture hooks.

Usage:
    with torch.profiler.profile(...) as prof:
        with recording() as rec:
            table.check_many_ids(...)
    clock = rec.on_profiler_clock(prof.profiler.kineto_results.events())
"""

from __future__ import annotations

import sys
import threading
import time
from contextlib import contextmanager


def capturing() -> bool:
    """Whether a `torch.profiler` capture is running (never where torch
    has not been imported)."""
    if "torch" not in sys.modules:
        return False
    from torch.autograd import _profiler_enabled

    return _profiler_enabled()


class _Off:
    """The span when nothing records: `with` binds None."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


OFF = _Off()

_REC = None  # the Recording being made; span()'s one check
_STACKS = threading.local()  # .open: each thread's open spans, innermost last


class Span:
    """One recorded span.  `start` / `end` are `perf_counter_ns`; `cpu`
    is the thread's CPU ns inside it, kept for a thread's outermost span
    (None on the others); `launch` is the launch it belongs to (given to
    the outermost span of a launch, inherited by its children); `attrs`
    holds what the code inside noted about the work."""

    __slots__ = ("name", "thread", "parent", "launch", "start", "end",
                 "cpu", "attrs", "_rec", "_twin", "_cpu0")

    def __init__(self, rec, name: str, launch) -> None:
        self._rec, self.name, self.launch = rec, name, launch
        self.cpu = self._twin = None
        self.attrs = {}

    def __enter__(self):
        try:
            stack = _STACKS.open
        except AttributeError:
            stack = _STACKS.open = []
        self.parent = stack[-1] if stack else None
        if self.launch is None and self.parent is not None:
            self.launch = self.parent.launch
        self.thread = threading.get_ident()
        if self.thread == self._rec.twin_thread:
            from torch.autograd.profiler import record_function

            self._twin = record_function(self.name)
            self._twin.__enter__()
        stack.append(self)
        self.start = time.perf_counter_ns()
        if self.parent is None:
            self._cpu0 = time.thread_time_ns()
        return self

    def __exit__(self, *exc):
        if self.parent is None:
            self.cpu = time.thread_time_ns() - self._cpu0
        self.end = time.perf_counter_ns()
        _STACKS.open.pop()
        if self._twin is not None:
            self._twin.__exit__(None, None, None)
            self._twin = None
        self._rec.spans.append(self)
        return False


def span(name: str, launch=None):
    """A stage of the program's work, recorded inside `recording()`;
    `launch` names the launch an outermost span belongs to.  Off, the
    shared no-op (`with span(...) as s` binds None), so code that notes
    attributes tests `s is not None` first."""
    rec = _REC
    if rec is None:
        return OFF
    return Span(rec, name, launch)


class Recording:
    """The spans one `recording()` kept, in the order they ended."""

    def __init__(self) -> None:
        self.spans = []
        # The thread whose spans get profiler twins: the one that
        # started the recording, if a capture was running then.
        self.twin_thread = threading.get_ident() if capturing() else None

    def on_profiler_clock(self, events) -> dict:
        """Every span on the profiler's clock, from the capture's events
        (`prof.profiler.kineto_results.events()`): `spans` [(span,
        start_ns, end_ns)] in `self.spans`' order, a twinned span at its
        twin's own times and every other moved by `offset_ns` (profiler
        clock minus `perf_counter_ns`); `disagreement_ns`, how far the
        twins are from admitting one offset (0 when they do: the clocks
        agree) and `slack_ns`, how widely they admit it; `twins`
        [(start_ns, end_ns, span)] by start.  Raises unless each twinned
        span has exactly one twin."""
        from torch.autograd import DeviceType

        mine = [s for s in self.spans if s.thread == self.twin_thread]
        if not mine:
            raise RuntimeError("no twinned spans: start the recording on "
                               "the profiler's thread while it captures")
        names = {s.name for s in mine}
        seen = {}
        for e in events:
            if e.device_type() == DeviceType.CPU and e.name() in names:
                seen.setdefault(e.name(), []).append(e)
        pairs = []
        for name in names:
            ours = sorted((s for s in mine if s.name == name),
                          key=lambda s: s.start)
            theirs = sorted(seen.get(name, []), key=lambda e: e.start_ns())
            if len(ours) != len(theirs):
                raise RuntimeError(f"{len(ours)} {name} spans recorded, "
                                   f"{len(theirs)} twins captured")
            pairs.extend(zip(ours, theirs))
        # A twin opens before its span and closes after it, so each pair
        # bounds the offset: e.start - s.start <= offset <= e.end - s.end.
        low = max(e.start_ns() - s.start for s, e in pairs)
        high = min(e.end_ns() - s.end for s, e in pairs)
        offset = (low + high) // 2
        at = {id(s): (e.start_ns(), e.end_ns()) for s, e in pairs}
        spans = [(s,) + at.get(id(s), (s.start + offset, s.end + offset))
                 for s in self.spans]
        return {
            "spans": spans,
            "offset_ns": offset,
            "disagreement_ns": max(low - high, 0),
            "slack_ns": max(high - low, 0),
            "twins": sorted((at[id(s)] + (s,) for s, _ in pairs),
                            key=lambda t: t[0]),
        }


@contextmanager
def recording():
    """Record every thread's spans until the block ends; yields the
    Recording.  One at a time: a second raises."""
    global _REC
    if _REC is not None:
        raise RuntimeError("a recording is already running")
    rec = _REC = Recording()
    try:
        yield rec
    finally:
        _REC = None
