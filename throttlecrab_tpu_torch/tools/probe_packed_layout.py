"""Compare packed request layouts for the decision scan on the card.

The counterpart of the JAX package's `scripts/probe_packed_layout.py`,
with its arms, sizes and printed labels, at K = 64 x B = 4096 on a
2^21-slot table (`default_rng(3)` slots, one set of parameters, every
lane valid and last of its segment):

  - row-major [K, B, 9] (`kernel.pack_requests`, the rows of JAX's
    `pack_rowmajor`), uploaded with each call, through the port's
    composed decide `kernel.decide_window` (JAX: `gcra_scan_packed`);
  - field-major [K, 9, B], uploaded with each call, through the probe's
    own scan, which builds each sub-batch's `_gcra_body` batch from the
    field rows p[0..8] (JAX: `scan_fieldmajor`);
  - the eight request arrays unpacked and resident on the device,
    through a probe-owned loop of `_gcra_body` over their k-th rows (the
    port has no unpacked scan; JAX: `gcra_scan`);

each in the 4-plane tier without the degenerate machinery, each timed as
JAX's `bench` times it: "fetched" (every output fetched before the next
call) and "queued" (n calls, then every output fetched).  The composed
arms are eager torch ops, so each line adds the card's own time per call
from torch.profiler (`card.device_times`: one session for every arm,
after the host timings; the upload's copy is among its records).  Beside them, the kernel arm: the port's window kernel
`fused.fused_window` on the row-major buffer, the only layout it reads,
one launch a call; on the card `fused.LAUNCHES` must move by exactly the
windows counted.

The card is the default device; `--cpu` runs everything on the host
(the card's clock then reads "not measured", as null).  `--check-cpu`
decides the first call of every arm again on the CPU and fails unless
its output and table state equal the run's.

    python -m throttlecrab_tpu_torch.tools.probe_packed_layout [--cpu]
        [--check-cpu]

Prints the device and the card's name and power limit on stderr, JAX's
labels on stdout, and one JSON report as the last line.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from ..tpu import fused, row_ops
from ..tpu.kernel import _gcra_body, _join, decide_window
from ..tpu.table import BucketTable
from .card import (
    card_line,
    check_first,
    device_times,
    first_record,
    pick_device,
    sync,
)
from .probe_kernel_ablation import inputs, kernel_packed

B, K, CAP = 4096, 64, 1 << 21
N_CALLS = 6
ARMS = ("row-major", "field-major", "unpacked", "kernel")
LABELS = {
    "row-major": "row-major  [K,B,9] numpy arg ",
    "field-major": "field-major [K,9,B] numpy arg",
    "unpacked": "unpacked 8-array, resident   ",
    "kernel": "fused_window [K,B,9] numpy arg",
}


def scan_fieldmajor(state, packed, now):
    """packed: i32[K, 9, B], field-major; the 4-plane outputs i32[K, 4, B],
    the state updated in place."""
    outs = []
    for k in range(packed.shape[0]):
        p = packed[k]
        batch = (
            p[0],
            p[1].to(torch.int64),
            (p[2] & 1) != 0,
            _join(p[3], p[4]),
            _join(p[5], p[6]),
            _join(p[7], p[8]),
            (p[2] & 2) != 0,
            now[k],
        )
        out, _ = _gcra_body(state, batch, rowops=row_ops.PLAIN,
                            with_degen=False, compact=True)
        outs.append(out)
    return torch.stack(outs)


def scan_unpacked(state, slots, rank, is_last, emission, tolerance, quantity,
                  valid, now):
    """The eight request arrays [K, B] (now i64[K]) decided sub-batch by
    sub-batch, as JAX's `gcra_scan` (rank widened to i64 first)."""
    rank = rank.to(torch.int64)
    outs = []
    for k in range(slots.shape[0]):
        out, _ = _gcra_body(
            state, (slots[k], rank[k], is_last[k], emission[k], tolerance[k],
                    quantity[k], valid[k], now[k]),
            rowops=row_ops.PLAIN, with_degen=False, compact=True)
        outs.append(out)
    return torch.stack(outs)


class Launcher:
    """The kernel arm's windows, counted where they are launched."""

    def __init__(self) -> None:
        self.count = 0

    def window(self, state, packed, now):
        self.count += 1
        out, _ = fused.fused_window(state, packed, now, with_degen=False,
                                    compact=True)
        return out


def make_arms(dev, K=K, B=B, cap=CAP):
    """{arm: (table, call)}: each arm's fresh table and its call, which
    decides the window once and returns its output on the device; and the
    kernel arm's launcher."""
    slots, em, tol, now = inputs(cap, K, B)
    pk_row = kernel_packed(slots, em, tol)
    pk_field = np.ascontiguousarray(pk_row.transpose(0, 2, 1))
    launcher = Launcher()
    tables = {arm: BucketTable(cap, device=dev) for arm in ARMS}
    resident = [torch.from_numpy(a).to(dev) for a in (
        slots, np.zeros((K, B), np.int32), np.ones((K, B), bool), em, tol,
        np.ones((K, B), np.int64), np.ones((K, B), bool), now)]
    sync(dev)

    def up(a):
        return torch.from_numpy(a).to(dev)

    calls = {
        "row-major": lambda: decide_window(
            tables["row-major"].state, up(pk_row), up(now),
            with_degen=False, compact=True)[0],
        "field-major": lambda: scan_fieldmajor(
            tables["field-major"].state, up(pk_field), up(now)),
        "unpacked": lambda: scan_unpacked(tables["unpacked"].state,
                                          *resident),
        "kernel": lambda: launcher.window(
            tables["kernel"].state, up(pk_row), up(now)),
    }
    return {arm: (tables[arm], calls[arm]) for arm in ARMS}, launcher


def bench(fn, n=N_CALLS):
    """JAX's `bench`: two untimed calls, then `n` calls each fetched before
    the next ("fetched"), then `n` calls queued and fetched after
    ("queued").  The record's card time is filled in later (`run`)."""
    fn().cpu()
    fn().cpu()
    t0 = time.perf_counter()
    for _ in range(n):
        fn().cpu()
    dt_b = (time.perf_counter() - t0) / n
    t0 = time.perf_counter()
    outs = [fn() for _ in range(n)]
    for o in outs:
        o.cpu()
    dt_q = (time.perf_counter() - t0) / n
    return {"fetched_ms": dt_b * 1e3, "queued_ms": dt_q * 1e3,
            "device_ms": None, "kernels_per_call": 0}


def line(label, rec, K, B):
    """JAX's label line of one arm, then the card's column."""
    dt_q = rec["queued_ms"] / 1e3
    dev = ("device not measured" if rec["device_ms"] is None else
           f"device {rec['device_ms']:8.3f} ms/call in "
           f"{rec['kernels_per_call']:.0f} records")
    return (f"{label}: fetched {rec['fetched_ms']:8.2f} ms  queued "
            f"{rec['queued_ms']:8.2f} ms  ({K * B / dt_q / 1e6:6.2f} M "
            f"dec/s queued)  {dev}")


def _first(arm, table, call):
    out = call()
    # The composed version writes a denied lane's row into the scratch
    # tail and the kernel leaves it: the kernel arm's real slots count.
    rows = table.capacity if arm == "kernel" else None
    return first_record(out, table.state, rows)


def run(dev, K=K, B=B, cap=CAP, n=N_CALLS, profiled=2, out=print):
    """Every arm on `dev`, then the card's time of `profiled` more calls of
    each in one profiler session (`card.device_times`), then the lines in
    JAX's order; returns the report, whose "first" maps each arm to its
    first call's digests."""
    card = card_line(dev)
    print(f"device: {dev} ({card})", file=sys.stderr, flush=True)
    report = {"device": str(dev), "platform": dev.type, "card": card,
              "B": B, "K": K, "cap": cap, "first": {}, "arms": {}}
    t_run = time.perf_counter()
    before = fused.LAUNCHES
    arms, launcher = make_arms(dev, K, B, cap)
    for arm in ARMS:
        table, call = arms[arm]
        report["first"][arm] = _first(arm, table, call)
        report["arms"][arm] = bench(call, n)
    times = device_times(dev, {arm: arms[arm][1] for arm in ARMS}, profiled)
    for arm in ARMS:
        rec = report["arms"][arm]
        rec["device_ms"], rec["kernels_per_call"] = times[arm]
        out(line(LABELS[arm], rec, K, B))
    sync(dev)
    report["launches_counted"] = launcher.count
    report["fused_launches_before"] = before
    report["fused_launches_after"] = fused.LAUNCHES
    report["seconds"] = time.perf_counter() - t_run
    if dev.type == "cuda" and fused.LAUNCHES - before != launcher.count:
        raise AssertionError(
            f"fused.LAUNCHES moved by {fused.LAUNCHES - before}, the probe "
            f"launched {launcher.count} windows")
    return report


def first_scans(dev, K=K, B=B, cap=CAP):
    """Every arm's first call alone on `dev`: {arm: first_record}, keyed as
    `run`'s report["first"]."""
    arms, _ = make_arms(dev, K, B, cap)
    return {arm: _first(arm, *arms[arm]) for arm in ARMS}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--check-cpu", action="store_true")
    args = ap.parse_args(argv)
    sizes = dict(K=K, B=B, cap=CAP)
    report = run(pick_device(args.cpu), n=N_CALLS, **sizes)
    if args.check_cpu:
        want = first_scans(torch.device("cpu"), **sizes)
        check_first(report["first"], want,
                    "probe_packed_layout against device='cpu'")
        report["first_equals_cpu"] = True
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    sys.exit(main())
