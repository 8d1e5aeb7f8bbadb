"""Ablate the decision scan to attribute a window's cost on the card.

The counterpart of the JAX package's `scripts/probe_kernel_ablation.py`,
with its axes, sizes, section order and printed labels:

  - the scan body, `full` / `noscatter` / `nogather` / `elementwise`
    (the probe's own simplified GCRA over `tpu/sat.py`'s helpers, at
    cap 2^21, K = 64, B = 4096);
  - table capacity 2^16 / 2^18 / 2^21 and scan depth K = 16 / 64 / 256,
    on the `full` body;
  - (d) the first fetch of a fresh `x * 3 + 1` output of 1, 4 and 16 MB,
    by `.cpu()`, and into a pinned buffer (as `probe_d2h.py` adds);
  - (e) launch cost against output size: the i8 allowed-only output
    against the stacked i32[4, B] one.

JAX jits each scan into one program; here the composed bodies are eager
torch ops, so a K = 64 scan is thousands of small launches and the host
clock mostly counts torch's cost per op.  Every scan therefore prints
two columns: JAX's host-clock ms/launch (each launch's output fetched),
and the card's own time per scan, torch.profiler's device records summed
(`card.device_times`: one session for every arm, after the host
timings).  Read the ablation from the second.

Beside the composed bodies, the kernel arm: the same slots, emission and
tolerance packed with `kernel.pack_requests` (rank 0, `is_last` and
`valid` set, quantity 1, as `profile_launch.make_payload` draws them),
decided by the port's own window kernel `fused.fused_window`, one launch
a scan, in the `w32` tier and in the 4-plane tier (`compact=True`): the
port's own output-size axis beside (e).  The probe counts the windows it
hands the kernel; on the card `fused.LAUNCHES` must move by exactly that
count, or the run fails.

JAX donates the table to each scan; here each scan updates it in place.
The card is the default device; `--cpu` runs everything on the host
(the kernel arm then runs the kernel's plain version, and the card's
clocks read "not measured", as null).  `--check-cpu` decides the first
scan of every arm again on the CPU and fails unless its output and table
state equal the run's.

    python -m throttlecrab_tpu_torch.tools.probe_kernel_ablation [--cpu]
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

from ..tpu import fused
from ..tpu.kernel import EMPTY_EXPIRY, pack_requests, pack_state, unpack_state
from ..tpu.sat import div_trunc, sat_add, sat_sub
from .card import (
    Deferred,
    card_line,
    check_first,
    device_times,
    first_record,
    pick_device,
    sync,
)

B = 4096
NOW = 1_753_000_000_000_000_000
MODES = ("full", "noscatter", "nogather", "elementwise")
CAP, K = 1 << 21, 64
CAPS = (1 << 16, 1 << 18, 1 << 21)
DEPTHS = (16, 64, 256)
D2H_MB = (1, 4, 16)
#: The kernel arm's tiers: (compact argument, label).
TIERS = (("w32", "w32 wire words"), (True, "i32 4-plane"))


def make_state(cap, dev):
    """A fresh table of `cap` rows: TAT 0, expiry EMPTY_EXPIRY."""
    return pack_state(
        torch.zeros(cap, dtype=torch.int64, device=dev),
        torch.full((cap,), EMPTY_EXPIRY, dtype=torch.int64, device=dev),
    )


def body(state, batch, mode):
    """One sub-batch of the probe's simplified GCRA; updates `state` in
    place (unless the mode drops the scatter) and returns i32[B] allowed
    bits."""
    slots, emission, tolerance, now = batch
    N = state.shape[0]
    s = torch.clamp(slots, 0, N - 1)
    if mode in ("full", "noscatter"):
        stored_tat, stored_exp = unpack_state(state.index_select(0, s))
    else:  # nogather / elementwise
        stored_tat = slots.to(torch.int64) * 1_000
        stored_exp = torch.full_like(stored_tat, EMPTY_EXPIRY)
    live = stored_exp > now
    inc = emission
    t0 = torch.where(
        live, torch.maximum(stored_tat, sat_sub(now, tolerance)),
        sat_sub(now, emission),
    )
    num = sat_sub(sat_add(now, tolerance), t0)
    m_raw = torch.clamp(div_trunc(num, inc), min=0)
    allowed = m_raw >= 1
    tat_fin = sat_add(t0, inc)
    expiry_fin = sat_add(tat_fin, tolerance)
    if mode in ("full", "nogather"):
        # Lanes of one sub-batch that share a slot read the same stored
        # row with the same parameters, so they write identical rows:
        # the in-place copy is as deterministic as JAX's .at[].set.
        rows = pack_state(tat_fin, expiry_fin)
        state.index_copy_(0, s.to(torch.int64), rows)
    return allowed.to(torch.int32)


def make_scan(mode):
    """The K-deep scan of `body`: (state, slots, emission, tolerance, now)
    -> i32[K, B], the state updated in place."""

    def scan(state, slots, emission, tolerance, now):
        return torch.stack([
            body(state, (slots[k], emission[k], tolerance[k], now[k]), mode)
            for k in range(slots.shape[0])
        ])

    return scan


def make_scan_outsize(small_out):
    """(e)'s scan: the `full` body with its output as i8[B] allowed bits
    (`small_out`) or the stacked i32[4, B]."""

    def scan(state, slots, emission, tolerance, now):
        outs = []
        for k in range(slots.shape[0]):
            out = body(state, (slots[k], emission[k], tolerance[k], now[k]),
                       "full")
            if small_out:
                out = out.to(torch.int8)
            else:
                out = torch.stack([out, out + 1, out + 2, out + 3])
            outs.append(out)
        return torch.stack(outs)

    return scan


def inputs(cap, K, B=B):
    """JAX's inputs for one run, drawn from `default_rng(3)` in its order:
    (slots, emission, tolerance, now) as numpy arrays."""
    rng = np.random.default_rng(3)
    return (
        rng.integers(0, cap - 1, (K, B)).astype(np.int32),
        np.full((K, B), 20_000_000, np.int64),
        np.full((K, B), 1_000_000_000, np.int64),
        np.full(K, NOW, np.int64),
    )


class Launcher:
    """The kernel arm's windows, counted where they are launched."""

    def __init__(self) -> None:
        self.count = 0

    def scan(self, packed, compact):
        """A scan of the window kernel over one packed buffer: (state,
        slots, emission, tolerance, now) -> output, as `make_scan`'s."""

        def scan(state, slots, emission, tolerance, now):
            self.count += 1
            out, _ = fused.fused_window(state, packed, now, with_degen=False,
                                        compact=compact)
            return out

        return scan


def kernel_packed(slots, emission, tolerance):
    """The kernel arm's request rows: rank 0, `is_last` and `valid` set,
    quantity 1 (numpy i32[K, B, 9])."""
    ones = np.ones(slots.shape, bool)
    return pack_requests(slots, np.zeros(slots.shape, np.int32), ones,
                         emission, tolerance, np.ones(slots.shape, np.int64),
                         ones)


class Arm:
    """One scan over its own fresh table on `dev`."""

    def __init__(self, dev, cap, K, B, scan, rows=None):
        self.dev, self.K, self.B = dev, K, B
        self.state = make_state(cap, dev)
        self.args = [torch.from_numpy(a).to(dev) for a in inputs(cap, K, B)]
        self._scan = scan
        self.rows = rows  # the state rows its first record covers

    def __call__(self):
        return self._scan(self.state, *self.args)

    def first(self):
        """The first scan: (its output, its first_record)."""
        out = self()
        return out, first_record(out, self.state, self.rows)


def kernel_arm(dev, cap, K, B, launcher, compact):
    slots, em, tol, _ = inputs(cap, K, B)
    packed = torch.from_numpy(kernel_packed(slots, em, tol)).to(dev)
    # The composed version writes a denied lane's row into the scratch
    # tail and the kernel leaves it: the real slots are compared.
    return Arm(dev, cap, K, B, launcher.scan(packed, compact), rows=cap - B)


def timed(arm, n=4):
    """JAX's `run`: the first scan, one more, then `n` timed scans each
    fetching its output.  Returns (record, first_record, last output);
    the record's card time is filled in later (`run`)."""
    out, first = arm.first()
    out.cpu()
    arm().cpu()
    t0 = time.perf_counter()
    for _ in range(n):
        out = arm()
        out.cpu()
    dt = (time.perf_counter() - t0) / n
    rec = {"ms": dt * 1e3, "decisions_per_s": arm.K * arm.B / dt,
           "device_ms": None, "kernels_per_scan": 0}
    return rec, first, out


def _device_col(rec):
    if rec["device_ms"] is None:
        return "device not measured"
    return (f"device {rec['device_ms']:8.3f} ms/scan in "
            f"{rec['kernels_per_scan']:.0f} records")


def _log2(n):
    return n.bit_length() - 1


def run_line(cap, K, B, mode, rec):
    """JAX's label line of one run, then the card's column."""
    dt = rec["ms"] / 1e3
    return (f"cap=2^{_log2(cap):2d} K={K:4d} {mode:11s}: "
            f"{dt * 1e3:8.2f} ms/launch  ({K * B / dt / 1e6:7.2f} M dec/s)"
            f"  {_device_col(rec)}")


def d2h_first_fetch(dev, mb, pinned=False):
    """(d): seconds per first fetch of four fresh `x * 3 + 1` outputs of
    `mb` MB (distinct lengths, as in JAX), settled by a sync first."""
    n_el = mb * (1 << 20) // 4
    outs = [torch.arange(n_el + i, dtype=torch.int32).to(dev) * 3 + 1
            for i in range(4)]
    dsts = ([torch.empty(o.shape, dtype=o.dtype, pin_memory=True)
             for o in outs] if pinned else None)
    sync(dev)
    t0 = time.perf_counter()
    for i, o in enumerate(outs):
        if pinned:
            dsts[i].copy_(o, non_blocking=True)
        else:
            o.cpu()
    sync(dev)
    return (time.perf_counter() - t0) / len(outs)


def run(dev, cap=CAP, K=K, B=B, caps=CAPS, depths=DEPTHS, d2h_mb=D2H_MB,
        n=4, profiled=2, out=print):
    """Every section on `dev`, then the card's time of `profiled` more
    scans of every arm in one profiler session (`card.device_times`), then
    the lines in JAX's order; returns the report, whose "first" maps each
    arm to its first scan's digests."""
    card = card_line(dev)
    print(f"device: {dev} ({card})", file=sys.stderr, flush=True)
    report = {"device": str(dev), "platform": dev.type, "card": card,
              "B": B, "K": K, "cap": cap, "first": {}}
    first = report["first"]
    t_run = time.perf_counter()
    before = fused.LAUNCHES
    launcher = Launcher()
    out = Deferred(out)
    arms = {}

    def timed_arm(section, key, arm, line):
        rec, first[f"{section}/{key}"], last = timed(arm, n)
        arms[f"{section}/{key}"] = (arm, rec)
        out(lambda: line(rec, last))
        report.setdefault(section, {})[key] = rec

    def one(section, key, c, k, scan, line):
        timed_arm(section, key, Arm(dev, c, k, B, scan), line)

    out(f"--- kernel body ablation (cap=2^{_log2(cap)}, K={K}) ---")
    for mode in MODES:
        one("ablation", mode, cap, K, make_scan(mode),
            lambda r, _, m=mode: run_line(cap, K, B, m, r))
    out(f"--- table size (full, K={K}) ---")
    for c in caps:
        one("capacity", f"2^{_log2(c)}", c, K, make_scan("full"),
            lambda r, _, c=c: run_line(c, K, B, "full", r))
    out(f"--- scan depth (full, cap=2^{_log2(cap)}) ---")
    for k in depths:
        one("depth", str(k), cap, k, make_scan("full"),
            lambda r, _, k=k: run_line(cap, k, B, "full", r))

    out("--- d2h first-fetch cost by size ---")
    report["d2h"] = {}
    for mb in d2h_mb:
        dt = d2h_first_fetch(dev, mb)
        out(f"d) d2h {mb:3d} MB first fetch: {dt * 1e3:8.2f} ms "
            f"({mb / dt:6.1f} MB/s)")
        rec = {"ms": dt * 1e3, "pinned_ms": None}
        if dev.type == "cuda":
            dt = d2h_first_fetch(dev, mb, pinned=True)
            rec["pinned_ms"] = dt * 1e3
            out(f"d) d2h {mb:3d} MB pinned fetch: {dt * 1e3:8.2f} ms "
                f"({mb / dt:6.1f} MB/s)")
        else:
            out(f"d) d2h {mb:3d} MB pinned fetch: not measured (no card)")
        report["d2h"][str(mb)] = rec

    out(f"--- launch cost vs output size (K={K}) ---")

    def size_line(label, tag="e"):
        def line(rec, last):
            dt = rec["ms"] / 1e3
            rec["out_bytes"] = last.numel() * last.element_size()
            mb = rec["out_bytes"] / 1e6
            return (f"{tag}) {label:16s} out={mb:5.1f} MB: "
                    f"{dt * 1e3:8.2f} ms/launch ({K * B / dt / 1e6:6.2f} M "
                    f"dec/s)  {_device_col(rec)}")
        return line

    for small in (False, True):
        label = "i8 allowed-only" if small else "i32 full compact"
        one("outsize", label, cap, K, make_scan_outsize(small),
            size_line(label))

    out(f"--- the window kernel fused_window at the same shape "
        f"(cap=2^{_log2(cap)}, K={K}) ---")
    for compact, label in TIERS:
        timed_arm("kernel", label,
                  kernel_arm(dev, cap, K, B, launcher, compact),
                  size_line(label, "k"))

    times = device_times(dev, {key: arm for key, (arm, _) in arms.items()},
                         profiled)
    for key, (_, rec) in arms.items():
        rec["device_ms"], rec["kernels_per_scan"] = times[key]
    out.flush()
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


def first_scans(dev, cap=CAP, K=K, B=B, caps=CAPS, depths=DEPTHS):
    """Every arm's first scan alone on `dev`: {arm: first_record}, keyed
    as `run`'s report["first"]."""
    arms = {f"ablation/{m}": (cap, K, make_scan(m)) for m in MODES}
    arms.update({f"capacity/2^{_log2(c)}": (c, K, make_scan("full"))
                 for c in caps})
    arms.update({f"depth/{k}": (cap, k, make_scan("full")) for k in depths})
    for small in (False, True):
        label = "i8 allowed-only" if small else "i32 full compact"
        arms[f"outsize/{label}"] = (cap, K, make_scan_outsize(small))
    got = {key: Arm(dev, c, k, B, scan).first()[1]
           for key, (c, k, scan) in arms.items()}
    launcher = Launcher()
    for compact, label in TIERS:
        got[f"kernel/{label}"] = kernel_arm(dev, cap, K, B, launcher,
                                            compact).first()[1]
    return got


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--check-cpu", action="store_true")
    args = ap.parse_args(argv)
    sizes = dict(cap=CAP, K=K, B=B, caps=CAPS, depths=DEPTHS)
    report = run(pick_device(args.cpu), d2h_mb=D2H_MB, **sizes)
    if args.check_cpu:
        want = first_scans(torch.device("cpu"), **sizes)
        check_first(report["first"], want,
                    "probe_kernel_ablation against device='cpu'")
        report["first_equals_cpu"] = True
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    sys.exit(main())
