"""The traced run's device records, reduced.

One torch.profiler session covers the whole measured window: a
process's later sessions lose records on the card, its first has been
seen whole (`throttlecrab_tpu_torch/tools/card.py::device_times`, whose
method this follows).  Each device record is given to the launch whose
`check_many_ids` call queued it: the CUDA runtime call that queued a
record carries its correlation id and lies inside that launch's
dispatch span.  (`device_times` splits its records by marker kernels
instead; over a pipelined window a marker's record was once placed 38
records late, PERF.md section 6.)  Every launch must show the same
number of kernel records, or a record was lost and the run fails.

The profiler places the card's records and the dispatching thread's
spans on one clock.  The pool's spans (fetch, finish) are taken on the
host clock and moved onto it by the offset between the two clocks that
the dispatch spans give.
"""

from __future__ import annotations

import bisect
import statistics

import numpy as np

COPY = "Memcpy"
WINDOW = "window_kernel"
HOST_LABELS = ("ids.dispatch", "finish.fetch", "finish.w32")


class Tracer:
    """The profiler session around a window."""

    def __init__(self) -> None:
        from torch.profiler import ProfilerActivity, profile

        self.prof = profile(
            activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])

    def __enter__(self):
        self.prof.__enter__()
        return self

    def __exit__(self, *exc):
        return self.prof.__exit__(*exc)

    def records(self):
        """(device records [(start_ns, end_ns, name, host_ns)] sorted,
        dispatch spans [(start_ns, end_ns)] sorted), on the profiler's
        clock; host_ns is when the runtime call that queued the record
        ran (None where no call was recorded)."""
        from torch.autograd import DeviceType

        dev, spans, calls = [], [], {}
        for e in self.prof.profiler.kineto_results.events():
            span = (e.start_ns(), e.start_ns() + e.duration_ns())
            if e.name() == "ids.dispatch":
                # The span also shows on the device's timeline, as an
                # annotation over the kernels it queued: not a record.
                if e.device_type() == DeviceType.CPU:
                    spans.append(span)
            elif e.device_type() == DeviceType.CUDA:
                dev.append(span + (e.name(), e.correlation_id()))
            elif e.name().startswith("cu"):  # a CUDA API call (cuda*, cu*)
                calls[e.correlation_id()] = span[0]
        dev = sorted((a, b, n, calls.get(c)) for a, b, n, c in dev)
        spans.sort()
        return dev, spans


def _census(runs):
    """How many launches show each count of kernel records, and which
    names the launches of an odd count have more or fewer of."""
    from collections import Counter

    def names(r):
        return Counter(n[:60] for _, _, n, _ in r if not n.startswith(COPY))

    by_count = Counter(sum(names(r).values()) for r in runs)
    usual = max(by_count, key=by_count.get)
    ref = next(names(r) for r in runs if sum(names(r).values()) == usual)
    odd = [names(r) for r in runs if sum(names(r).values()) != usual][:3]
    return {"launches_by_count": dict(by_count),
            "odd_vs_usual": [dict((n - ref) + Counter(
                {k: -v for k, v in (ref - n).items()})) for n in odd]}


def _union(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _clip(intervals, lo, hi):
    return [(max(a, lo), min(b, hi)) for a, b in intervals
            if min(b, hi) > max(a, lo)]


def reduce(dev, spans, win, n_launches):
    """Per-launch device ms (front end, window kernel), the busy union in
    the window, the top device operations and the idle gaps by what the
    host was doing.  `win` is the loop's window record (host clock, s)."""
    if not dev:
        raise RuntimeError("torch.profiler recorded nothing on the card")
    if len(spans) != n_launches:
        raise RuntimeError(f"{len(spans)} dispatch spans traced for "
                           f"{n_launches} launches")
    starts = [a for a, _ in spans]
    runs = [[] for _ in spans]
    for rec in dev:
        h = rec[3]
        i = bisect.bisect_right(starts, h) - 1 if h is not None else -1
        if i >= 0 and h <= spans[i][1]:
            runs[i].append(rec)
    front, window, counts = [], [], set()
    for r in runs:
        kernels = [(a, b, n) for a, b, n, _ in r if not n.startswith(COPY)]
        counts.add(len(kernels))
        window.append(sum(b - a for a, b, n in kernels if WINDOW in n) / 1e6)
        front.append(sum(b - a for a, b, n in kernels if WINDOW not in n)
                     / 1e6)
    if len(counts) != 1 or 0 in counts:
        raise RuntimeError("torch.profiler lost records: kernel records a "
                           f"launch {_census(runs)}")
    # Host clock (s) -> profiler clock (ns), from the dispatch spans.
    host_d = win["dispatch"]
    off = statistics.median(s[0] - h * 1e9 for s, h in zip(spans, host_d[:, 0]))
    lo, hi = win["t_start"] * 1e9 + off, win["t_end"] * 1e9 + off
    ops = [(a, b, n) for a, b, n, _ in dev]
    busy = _union(_clip([(a, b) for a, b, _ in ops], lo, hi))
    busy_ns = sum(b - a for a, b in busy)
    by_name = {}
    for a, b, n in ops:
        if b > lo and a < hi:
            by_name[n] = by_name.get(n, 0.0) + (min(b, hi) - max(a, lo)) / 1e9
    fin = win["finish"]
    host = {
        "ids.dispatch": [(a, b) for a, b in spans],
        "finish.fetch": [(a * 1e9 + off, b * 1e9 + off) for a, b, _ in fin],
        "finish.w32": [(b * 1e9 + off, c * 1e9 + off) for _, b, c in fin],
    }
    return {
        "front_ms": np.asarray(front),
        "window_ms": np.asarray(window),
        "kernels_a_launch": counts.pop(),
        "busy_s": busy_ns / 1e9,
        "window_s": (hi - lo) / 1e9,
        "device_ops": sorted(by_name.items(), key=lambda kv: -kv[1])[:10],
        "idle_gaps": idle_by_host(busy, lo, hi, host),
    }


def idle_by_host(busy, lo, hi, host):
    """[(label, seconds)]: the window's idle time on the device, split by
    what the host was doing, in the order of HOST_LABELS (the dispatching
    thread first); "other" where none of them ran."""
    idle = []
    t = lo
    for a, b in busy:
        if a > t:
            idle.append((t, a))
        t = max(t, b)
    if hi > t:
        idle.append((t, hi))
    left = idle
    out = []
    for label in HOST_LABELS:
        cover = _union(_clip(host[label], lo, hi))
        took, rest = 0.0, []
        for a, b in left:
            for c, d in _overlaps(cover, a, b):
                took += d - c
            rest.extend(_minus(a, b, cover))
        out.append((label, took / 1e9))
        left = rest
    out.append(("other", sum(b - a for a, b in left) / 1e9))
    return sorted(out, key=lambda kv: -kv[1])


def _overlaps(cover, a, b):
    i = max(bisect.bisect_left(cover, [a, a]) - 1, 0)
    while i < len(cover) and cover[i][0] < b:
        c, d = max(cover[i][0], a), min(cover[i][1], b)
        if d > c:
            yield c, d
        i += 1


def _minus(a, b, cover):
    out, t = [], a
    for c, d in _overlaps(cover, a, b):
        if c > t:
            out.append((t, c))
        t = max(t, d)
    if b > t:
        out.append((t, b))
    return out
