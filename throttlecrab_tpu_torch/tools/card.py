"""What the launch-cost tools share: the device a run asks for, the
card's name and power limit (printed beside every number they time), a
drain of the card's queue, and the host-clock timer of the JAX
package's `scripts/profile_launch.py`."""

from __future__ import annotations

import subprocess
import threading
import time

import torch

from ..tpu.table import resolve_device


def pick_device(cpu: bool) -> torch.device:
    """`cuda` unless `cpu`; asking for cuda without a card raises."""
    return resolve_device("cpu" if cpu else None)


def card_line(dev: torch.device) -> str:
    """The card's `nvidia-smi --query-gpu=name,power.limit` line, or a
    note that the run is on the host."""
    if dev.type != "cuda":
        return "cpu (no card: host times only)"
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader", f"--id={dev.index or 0}"],
        check=True, capture_output=True, text=True,
    ).stdout.strip()


def sync(dev: torch.device) -> None:
    """Wait for the card's queue to drain (nothing to wait for on cpu)."""
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def timeit(fn, warm=3, iters=10):
    """(median, max) seconds of fn() on the host clock after `warm`
    untimed calls; fn must end with its work done (a sync or a fetch)."""
    for _ in range(warm):
        fn()
    ts = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn()
        ts.append(time.perf_counter() - t0)
    ts.sort()
    return ts[len(ts) // 2], ts[-1]


def event_ms(dev: torch.device, fn, n=10) -> float:
    """ms per fn() call between two CUDA events around `n` calls (fn
    queues work and does not wait for it), after one warm call."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize(dev)
    return start.elapsed_time(end) / n


def device_ms(dev: torch.device, fn, n=10):
    """(ms of card time, kernels) per fn() call from torch.profiler's CUDA
    kernel records over `n` calls after one warm call; (None, 0) when the
    profiler records no kernel on this machine."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize(dev)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize(dev)
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not kernels:
        return None, 0
    return (sum(e.device_time_total for e in kernels) / n / 1e3,
            len(kernels) / n)


class WindowCount:
    """Windows handed to tables on the card, counted at each table's launch
    entry point (BucketTable.check_many_packed: one window; a mesh's
    ShardedBucketTable._launch: one per shard) — what `fused.LAUNCHES`
    must move by.  A table on the CPU runs the plain version and is left
    alone."""

    def __init__(self) -> None:
        self.windows = 0
        self._lock = threading.Lock()

    def watch(self, limiter):
        """Wrap `limiter`'s table on this instance; returns `limiter`."""
        table = limiter.table
        if table.device.type != "cuda":
            return limiter
        if hasattr(table, "shards"):
            name, per_call = "_launch", len(table.shards)
        else:
            name, per_call = "check_many_packed", 1
        inner = getattr(table, name)

        def counted(*args, **kwargs):
            with self._lock:  # the launch counter's += is not atomic
                self.windows += per_call
                return inner(*args, **kwargs)

        setattr(table, name, counted)
        return limiter
