"""Profiling and tracing hooks.

The port of `throttlecrab_tpu/tpu/profiling.py`.  The JAX package wraps
the JAX profiler (an xprof trace); the port wraps `torch.profiler` and
writes a Chrome trace (`chrome://tracing`, Perfetto) instead: host
activity, and on a card the CUDA activity too (kernel launches and the
kernels themselves, from every thread of the process).

Two kinds of span:

- `annotate(name)` names a stretch of a `torch.profiler` capture
  (`trace`, `ProfileSession`, the server's `--profile-dir`).  Outside a
  capture it is a shared no-op and costs one check.  The profiler keeps
  the spans of the thread that started it only, so a caller that wants
  its launch spans in the trace starts, launches and stops on one
  thread (the engine runs its profiled launches on one).
- `span(name)` marks a stage of the program's own work (names start
  with `tc.`) and records only inside `recording()`, from every
  thread; off, it is the same shared no-op.  Its recorder lives in
  `throttlecrab_tpu_torch/spans.py`, which the host layers import
  without torch, and is re-exported here.

Usage:
    from throttlecrab_tpu_torch.tpu import profiling

    with profiling.trace("/tmp/tc-trace"):     # host (+ card) timeline
        with profiling.annotate("gcra_batch"):
            table.check_batch(...)

    with torch.profiler.profile(...) as prof:  # the program's stages
        with profiling.recording() as rec:
            table.check_many_ids(...)
    clock = rec.on_profiler_clock(prof.profiler.kineto_results.events())

The server exposes the capture as `THROTTLECRAB_PROFILE_DIR`: when set,
the engine records a trace of the first N launches after startup.
"""

from __future__ import annotations

import os
from contextlib import contextmanager
from typing import Optional

from torch.autograd import _profiler_enabled
from torch.autograd.profiler import record_function

from ..spans import OFF, recording, span  # noqa: F401


class ProfileSession:
    """One `torch.profiler` capture written as a Chrome trace into
    `log_dir` (`trace-{pid}-{n}.json`, n counting this process's
    captures).  CPU activity always; CUDA activity when a card is
    present."""

    _count = 0

    def __init__(self, log_dir: str) -> None:
        self.log_dir = log_dir
        self.path: Optional[str] = None
        self._prof = None

    def start(self) -> None:
        import torch
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(ProfilerActivity.CUDA)
        self._prof = profile(activities=activities)
        self._prof.start()

    def stop(self) -> str:
        """Stop the capture and write the trace; returns its path."""
        prof, self._prof = self._prof, None
        prof.stop()
        ProfileSession._count += 1
        os.makedirs(self.log_dir, exist_ok=True)
        self.path = os.path.join(
            self.log_dir,
            f"trace-{os.getpid()}-{ProfileSession._count}.json",
        )
        prof.export_chrome_trace(self.path)
        return self.path


@contextmanager
def trace(log_dir: str):
    """Capture a `torch.profiler` Chrome trace into `log_dir`."""
    session = ProfileSession(log_dir)
    session.start()
    try:
        yield session
    finally:
        session.stop()


def annotate(name: str):
    """Named span for a capture's host timeline (`record_function`); the
    shared no-op outside a `torch.profiler` capture."""
    if not _profiler_enabled():
        return OFF
    return record_function(name)
