"""What the launch-cost tools share: the device a run asks for, the
card's name and power limit (printed beside every number they time), a
drain of the card's queue, the host-clock timer of the JAX package's
`scripts/profile_launch.py`, the card's own time from torch.profiler,
and digests of a scan's first output and table state (what a run on
the card is held to against the same scan on the CPU)."""

from __future__ import annotations

import hashlib
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


def device_times(dev: torch.device, calls: dict, n=2) -> dict:
    """{key: (ms of card time, records) per call of `calls[key]()`}: the
    sum of torch.profiler's CUDA records (kernels and copies) over `n`
    calls of each, after one warm call of each; (None, 0), "not
    measured", on the cpu.

    All calls share ONE profiler session.  On the card a process's later
    sessions lose records (whole sessions or part of one, more the more
    sessions came before; PERF.md §7), while its first session has been
    seen whole.  A marker kernel (`torch.cuda._sleep`) goes before every
    call and after the last, so the session's records, in stream order,
    split into one run per call.  The `n` runs of one key must hold the
    same number of records, and at least one: otherwise a record was lost
    and this raises, so a dropped profile never reads as a number, nor as
    a missing one."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    if dev.type != "cuda":
        return {key: (None, 0) for key in calls}
    for fn in calls.values():
        fn()
    torch.cuda.synchronize(dev)

    def mark():
        torch.cuda._sleep(1)

    # The card's records only: recording every host op as well would
    # multiply the session's cost for a composed scan's ~50,000 launches.
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for fn in calls.values():
            for _ in range(n):
                mark()
                fn()
        mark()
        torch.cuda.synchronize(dev)
    records = sorted((e.start_ns(), e.duration_ns(), e.name())
                     for e in prof.profiler.kineto_results.events()
                     if e.device_type() == DeviceType.CUDA)
    if not records:
        raise RuntimeError("torch.profiler recorded nothing on the card")
    runs, run = [], None
    for _, ns, name in records:
        if name == records[0][2]:  # the first record is a marker
            if run is not None:
                runs.append(run)
            run = []
        else:
            run.append(ns)
    if len(runs) != n * len(calls):
        raise RuntimeError(f"torch.profiler recorded {len(runs) + 1} of "
                           f"{n * len(calls) + 1} marker kernels")
    out = {}
    for i, key in enumerate(calls):
        mine = runs[i * n:(i + 1) * n]
        counts = {len(r) for r in mine}
        if len(counts) != 1 or not mine[0]:
            raise RuntimeError(
                f"torch.profiler lost records of {key!r}: {n} calls "
                f"recorded {[len(r) for r in mine]}")
        out[key] = (sum(map(sum, mine)) / n / 1e6, len(mine[0]))
    return out


def device_ms(dev: torch.device, fn, n=10):
    """(ms of card time, records) per fn() call: `device_times` of one
    call."""
    return device_times(dev, {"fn": fn}, n)["fn"]


def digest(t: torch.Tensor) -> str:
    """sha256 of a tensor's dtype, shape and bytes, taken on the host."""
    a = t.detach().contiguous().cpu()
    h = hashlib.sha256(f"{a.dtype}{tuple(a.shape)}".encode())
    h.update(a.numpy().tobytes())
    return h.hexdigest()


def first_record(out: torch.Tensor, state: torch.Tensor, rows=None) -> dict:
    """Digests of a scan's first output and of the table state after it;
    `rows` limits the state to its first rows (the real slots, where the
    composed version and the kernel treat the scratch tail differently)."""
    return {"out": digest(out),
            "state": digest(state if rows is None else state[:rows])}


def check_first(got: dict, want: dict, what: str) -> None:
    """Raise unless two {arm: first_record} maps are equal arm for arm."""
    bad = sorted(k for k in set(got) | set(want) if got.get(k) != want.get(k))
    if bad:
        raise AssertionError(f"{what}: first scans differ in {bad}")


class Deferred:
    """Lines kept in order until the card's times are in, then printed:
    each a string, or a callable that makes one."""

    def __init__(self, out=print) -> None:
        self.out = out
        self.items = []

    def __call__(self, item) -> None:
        self.items.append(item)

    def flush(self) -> None:
        for item in self.items:
            self.out(item() if callable(item) else item)
        self.items.clear()


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
