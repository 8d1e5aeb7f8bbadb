"""Profiling / tracing hooks.

The port of `throttlecrab_tpu/tpu/profiling.py`.  The JAX package wraps
the JAX profiler (an xprof trace); the port wraps `torch.profiler` and
writes a Chrome trace (`chrome://tracing`, Perfetto) instead: host
activity, and on a card the CUDA activity too (kernel launches and the
kernels themselves, from every thread of the process).  Host-side spans
(`annotate`) are recorded on the thread that started the capture, so a
caller that wants its launch spans in the trace starts, launches and
stops on one thread (the engine runs its profiled launches on one).

Usage:
    from throttlecrab_tpu_torch.tpu.profiling import trace, annotate

    with trace("/tmp/tc-trace"):        # host (+ card) timeline
        engine_work()

    with annotate("gcra_batch"):        # names a span inside a trace
        table.check_batch(...)

The server exposes this as `THROTTLECRAB_PROFILE_DIR`: when set, the
engine records a trace of the first N launches after startup.
"""

from __future__ import annotations

import os
from contextlib import contextmanager
from typing import Optional


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
    """Named span for host timelines (no-op outside a trace)."""
    from torch.profiler import record_function

    return record_function(name)
