"""Attribute the by-id scan's device time on the card.

The counterpart of the JAX package's `scripts/probe_byid_ablation.py`,
with its modes, sizes and printed labels: requests pre-staged on the
card as 8-byte words (R = 4 blocks of K = 256 x B = 4096 from
`default_rng(5)`, ids uniform over 1M resident id rows), a 2^21-slot
table, and each scan's output reduced to one sum (one fetch per timing
block).  The body is ablated:

  full         the port's composed decide (`kernel._gcra_body`, no
               degenerate machinery, the "cur" tier) on rows gathered
               from the id table
  noidrow      the same decide with the parameters synthesized from the
               id (slot = id): no id-row gather
  nostate      the probe's hand-rolled body with the stored row
               synthesized: no state gather
  noscatter    the hand-rolled body without its write-back
  elementwise  neither state gather nor write-back

then a width ablation of `full` over id rows 8 and 5 columns wide
(`kernel.pack_id_rows(..., width=w)`).  The hand-rolled bodies copy
JAX's arithmetic as written: a floor division, plain (wrapping)
subtractions, and a scatter that sends lanes that did not write to the
scratch rows N - B + lane.

JAX's `THROTTLECRAB_PALLAS=1` routes the state rows of `full` and
`noidrow` through its Pallas row kernels.  Here `THROTTLECRAB_PALLAS=1`
or `--row-kernels` routes them through the port's CUDA row kernels
(`tpu/row_ops.py`) in place of their plain versions (`row_ops.PLAIN`);
the other modes never move rows through either, as in JAX.  On the card
`row_ops.GATHER_LAUNCHES` and `SCATTER_LAUNCHES` must then move by K for
every scan of `full` and `noidrow`, and by 0 for every other scan, or
the run fails.

The composed bodies are eager torch ops (thousands of launches a scan),
so beside JAX's host-clock columns each line prints the card's own time
per scan from torch.profiler (`card.device_times`: one session for every
arm, after the host timings); read the ablation from that column.  Last, the kernel arm: the port's by-id serving front end
`kernel.byid_window` expands the same staged words into packed rows and
the window kernel `fused.fused_window` decides them, one launch a scan;
on the card `fused.LAUNCHES` must move by exactly the windows counted.

The card is the default device; `--cpu` runs everything on the host
(the card's clocks then read "not measured", as null).  `--check-cpu`
decides the first scan of every arm again on the CPU and fails unless
its output and table state equal the run's.

    python -m throttlecrab_tpu_torch.tools.probe_byid_ablation [--cpu]
        [--row-kernels] [--check-cpu]

Prints the device, the row route and the card's name and power limit
on stderr, JAX's labels on stdout, and one JSON report as the last line.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

from ..tpu import fused, kernel, row_ops
from ..tpu.kernel import (
    _U32,
    EMPTY_EXPIRY,
    _gcra_body,
    _join,
    _to_i32,
    pack_id_rows,
    pack_state,
    unpack_state,
)
from .card import (
    Deferred,
    card_line,
    check_first,
    device_times,
    first_record,
    pick_device,
    sync,
)
from .probe_kernel_ablation import make_state

B = 4096
K = 256
N_IDS = 1_000_000
CAP = 1 << 21
NOW = 1_753_000_000_000_000_000
R = 4
MODES = ("full", "noidrow", "nostate", "noscatter", "elementwise")
ROW_MODES = ("full", "noidrow")  # the modes whose rows take the switch
WIDTHS = (8, 5)


def make_scan(mode, rowops=row_ops.PLAIN):
    """The K-deep scan of one mode: (state, id_rows, words, now) ->
    i64[K, B] "cur" words, the state updated in place.  `rowops` moves
    the state rows of `full` and `noidrow`."""

    def step(state, id_rows, w, now_k):
        n_ids = id_rows.shape[0]
        meta = w >> 32
        idx = torch.clamp(_to_i32(w & _U32), 0, n_ids - 1)
        if mode == "noidrow":
            # synthesize params arithmetically; slot = id
            slots = idx
            em = 20_000_000 + (idx.to(torch.int64) % 977) * 1000
            tol = em * 7
        else:
            rows = id_rows.index_select(0, idx)
            slots = rows[:, 0]
            em = _join(rows[:, 1], rows[:, 2])
            tol = _join(rows[:, 3], rows[:, 4])
        rank = meta & 0x3FFF
        is_last = (meta & (1 << 14)) != 0
        valid = (meta & (1 << 15)) != 0
        if mode in ROW_MODES:
            batch = (slots, rank, is_last, em, tol,
                     torch.ones_like(w), valid, now_k)
            out, _ = _gcra_body(state, batch, rowops=rowops,
                                with_degen=False, compact="cur")
            return out
        # hand-rolled reduced bodies for attribution
        N = state.shape[0]
        s = torch.clamp(slots, 0, N - 1)
        if mode in ("nostate", "elementwise"):
            stored_tat = slots.to(torch.int64) * 1_000
            stored_exp = torch.full_like(stored_tat, EMPTY_EXPIRY)
        else:
            stored_tat, stored_exp = unpack_state(state.index_select(0, s))
        live = valid & (stored_exp > now_k)
        inc = em
        # Plain subtractions, as the JAX body writes them (they wrap).
        t0 = torch.where(
            live,
            torch.maximum(stored_tat, now_k - tol),
            now_k - em,
        )
        num = now_k + tol - t0
        # JAX's `//` floors.
        m_raw = torch.clamp(
            torch.div(num, torch.clamp(inc, min=1), rounding_mode="floor"),
            min=0)
        allowed = (rank < m_raw) & valid
        cur = torch.where(allowed, t0 + (rank + 1) * inc, t0 + m_raw * inc)
        out = cur * 2 + allowed.to(torch.int64)
        if mode in ("noscatter", "elementwise"):
            return out
        tat_fin = t0 + torch.minimum(m_raw, rank + 1) * inc
        rows_w = pack_state(tat_fin, tat_fin + tol)
        wrote = (m_raw >= 1) & valid & is_last
        b = w.shape[0]
        scratch = N - b + torch.arange(b, dtype=torch.int32, device=w.device)
        # Lanes that share a slot write identical rows (same stored row,
        # same parameters), so the copy is deterministic.
        state.index_copy_(0, torch.where(wrote, s, scratch).to(torch.int64),
                          rows_w)
        return out

    def scan(state, id_rows, words, now):
        return torch.stack([step(state, id_rows, words[k], now[k])
                            for k in range(words.shape[0])])

    return scan


class Launcher:
    """The kernel arm's windows, counted where they are launched."""

    def __init__(self) -> None:
        self.count = 0

    def scan(self, state, id_rows, words, now):
        """The by-id serving route: the front end packs the words' rows,
        the window kernel decides them."""
        self.count += 1
        packed = kernel.byid_window(id_rows, words, 1)
        out, _ = fused.fused_window(state, packed, now, with_degen=False,
                                    compact="cur")
        return out


def id_params(n_ids):
    """JAX's resident id rows: (slots, emission, tolerance), slot = id."""
    kid = np.arange(n_ids, dtype=np.int64)
    em = 20_000_000 + (kid % 977) * 1000
    return np.arange(n_ids, dtype=np.int32), em, em * 7


def stage(rng, n_ids, K, B):
    """One block of request words: uniform ids, rank 0, is_last and valid
    (duplicates are rare at 1M ids)."""
    ids = rng.integers(0, n_ids, (K, B)).astype(np.int64)
    meta = (1 << 14) | (1 << 15)
    return (np.int64(meta) << 32) | ids


def arm_words(n_ids=N_IDS, K=K, B=B, r=R):
    """Every arm's R staged blocks, drawn from one `default_rng(5)` in
    JAX's order (each mode, then each width), then the kernel arm's:
    [(arm, [words numpy i64[K, B]] * r)]."""
    rng = np.random.default_rng(5)
    arms = [(f"mode/{m}", m) for m in MODES]
    arms += [(f"width/{w}", "full") for w in WIDTHS]
    arms.append(("kernel/fused_window", None))
    return [(arm, [stage(rng, n_ids, K, B) for _ in range(r)])
            for arm, _ in arms]


class Run:
    """One arm on `dev`: its scan, its fresh table, its id rows and its
    staged words, with the scans it made and the row-kernel launches
    they made counted."""

    def __init__(self, dev, scan, id_rows, words, cap, K):
        self.dev = dev
        self._scan = scan
        self.state = make_state(cap, dev)
        self.id_rows = id_rows
        self.staged = [torch.from_numpy(w).to(dev) for w in words]
        self.now = torch.full((K,), NOW, dtype=torch.int64, device=dev)
        self.scans = 0
        self.rows = {"row_gather": 0, "row_scatter": 0}

    def __call__(self, i=0):
        self.scans += 1
        g0, s0 = row_ops.GATHER_LAUNCHES, row_ops.SCATTER_LAUNCHES
        out = self._scan(self.state, self.id_rows, self.staged[i], self.now)
        self.rows["row_gather"] += row_ops.GATHER_LAUNCHES - g0
        self.rows["row_scatter"] += row_ops.SCATTER_LAUNCHES - s0
        return out

    def first(self, rows=None):
        out = self()
        return out, first_record(out, self.state, rows)


def timed(run, rows=None):
    """JAX's timing: the first scan (and its fetched sum), then one scan
    per staged block, each output summed on the device, one fetch at the
    end.  Returns (record, first_record); the record's card time is
    filled in later (`run`)."""
    out, first = run.first(rows)
    out.sum().item()
    t0 = time.perf_counter()
    checks = [run(i).sum() for i in range(len(run.staged))]
    sum(checks).item()
    dt = (time.perf_counter() - t0) / len(run.staged)
    return {"ms": dt * 1e3, "device_ms": None, "kernels_per_scan": 0}, first


def line(label, rec, K, B):
    """JAX's label line of one scan, then the card's column."""
    dt = rec["ms"] / 1e3
    dev = ("device not measured" if rec["device_ms"] is None else
           f"device {rec['device_ms']:8.3f} ms/scan in "
           f"{rec['kernels_per_scan']:.0f} records")
    return (f"{label}: {dt * 1e3:8.2f} ms/launch  "
            f"({dt / K * 1e3:6.3f} ms/batch, {K * B / dt / 1e6:6.2f} M "
            f"dec/s)  {dev}")


def row_route(row_kernels):
    """The module that moves `full`'s and `noidrow`'s rows."""
    return row_ops if row_kernels else row_ops.PLAIN


def _arms(dev, row_kernels, n_ids, K, B, cap, r):
    """([(arm, label, make)] in JAX's order, then the kernel arm, where
    `make()` builds the arm's `Run` on a fresh table; the kernel arm's
    launcher)."""
    slots, em, tol = id_params(n_ids)
    id_rows = {w: torch.from_numpy(pack_id_rows(slots, em, tol, width=w))
               .to(dev) for w in WIDTHS}
    rowops = row_route(row_kernels)
    launcher = Launcher()
    out = []
    for arm, words in arm_words(n_ids, K, B, r):
        kind, name = arm.split("/")
        if kind == "mode":
            scan, rows, label = make_scan(name, rowops), id_rows[8], name
        elif kind == "width":
            scan, rows = make_scan("full", rowops), id_rows[int(name)]
            label = f"width {name}"
        else:
            scan, rows, label = launcher.scan, id_rows[8], name
        out.append((arm, label, lambda s=scan, i=rows, w=words:
                    Run(dev, s, i, w, cap, K)))
    return out, launcher


def _real_rows(arm, cap, B):
    # The composed version writes a denied lane's row into the scratch
    # tail and the kernel leaves it: the real slots are compared.
    return cap - B if arm.startswith("kernel/") else None


def run(dev, row_kernels=False, n_ids=N_IDS, K=K, B=B, cap=CAP, r=R,
        profiled=2, out=print):
    """Every mode, the width ablation and the kernel arm on `dev`, then the
    card's time of `profiled` more scans of each in one profiler session
    (`card.device_times`), then the lines in JAX's order; returns the
    report, whose "first" maps each arm to its first scan's digests."""
    card = card_line(dev)
    print(f"device: {dev}  pallas={os.environ.get('THROTTLECRAB_PALLAS', '0')}"
          f"  row_kernels={int(row_kernels)}  ({card})", file=sys.stderr,
          flush=True)
    report = {"device": str(dev), "platform": dev.type, "card": card,
              "B": B, "K": K, "n_ids": n_ids, "cap": cap, "R": r,
              "row_kernels": row_kernels, "first": {}, "scans": {},
              "row_launches": {}}
    t_run = time.perf_counter()
    before = fused.LAUNCHES
    arms, launcher = _arms(dev, row_kernels, n_ids, K, B, cap, r)
    out = Deferred(out)
    runs = {}
    for arm, label, make in arms:
        if arm == "width/8":
            out("--- id-row width (full) ---")
        elif arm.startswith("kernel/"):
            out(f"--- the by-id front end and the window kernel (K={K}) ---")
        scan_run = make()
        rec, report["first"][arm] = timed(scan_run, _real_rows(arm, cap, B))
        runs[arm] = (scan_run, rec)
        label = (f"{label:12s}" if arm.startswith(("mode/", "kernel/"))
                 else f"{label}     ")
        out(lambda label=label, rec=rec: line(label, rec, K, B))
        report.setdefault(arm.split("/")[0], {})[arm.split("/")[1]] = rec
    times = device_times(dev, {arm: r for arm, (r, _) in runs.items()},
                         profiled)
    sync(dev)
    for arm, (scan_run, rec) in runs.items():
        rec["device_ms"], rec["kernels_per_scan"] = times[arm]
    out.flush()
    for arm, (scan_run, rec) in runs.items():
        report["scans"][arm] = scan_run.scans
        report["row_launches"][arm] = scan_run.rows
        routed = (row_kernels and dev.type == "cuda"
                  and not arm.startswith("kernel/")
                  and (arm.startswith("width/") or arm[5:] in ROW_MODES))
        want = K * scan_run.scans if routed else 0
        if dev.type == "cuda" and set(scan_run.rows.values()) != {want}:
            raise AssertionError(
                f"{arm}: row launches {scan_run.rows} for {scan_run.scans} "
                f"scans, expected {want} each")
    report["launches_counted"] = launcher.count
    report["fused_launches_before"] = before
    report["fused_launches_after"] = fused.LAUNCHES
    report["seconds"] = time.perf_counter() - t_run
    if dev.type == "cuda" and fused.LAUNCHES - before != launcher.count:
        raise AssertionError(
            f"fused.LAUNCHES moved by {fused.LAUNCHES - before}, the probe "
            f"launched {launcher.count} windows")
    return report


def first_scans(dev, row_kernels=False, n_ids=N_IDS, K=K, B=B, cap=CAP,
                r=R):
    """Every arm's first scan alone on `dev`: {arm: first_record}, keyed
    as `run`'s report["first"]."""
    arms, _ = _arms(dev, row_kernels, n_ids, K, B, cap, r)
    return {arm: make().first(_real_rows(arm, cap, B))[1]
            for arm, _, make in arms}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--row-kernels", action="store_true",
                    help="move full's and noidrow's state rows with the "
                         "CUDA row kernels (as THROTTLECRAB_PALLAS=1)")
    ap.add_argument("--check-cpu", action="store_true")
    args = ap.parse_args(argv)
    row_kernels = (args.row_kernels
                   or os.environ.get("THROTTLECRAB_PALLAS", "0") == "1")
    sizes = dict(n_ids=N_IDS, K=K, B=B, cap=CAP, r=R)
    report = run(pick_device(args.cpu), row_kernels=row_kernels, **sizes)
    if args.check_cpu:
        want = first_scans(torch.device("cpu"), **sizes)
        check_first(report["first"], want,
                    "probe_byid_ablation against device='cpu'")
        report["first_equals_cpu"] = True
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    sys.exit(main())
