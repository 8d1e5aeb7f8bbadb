"""Probe how the card queues copies and decision windows.

The counterpart of the JAX package's `scripts/probe_async.py`: its three
questions, asked of the card through torch, with its printed labels:

  a) does `.to(dev, non_blocking=True)` return before the 8 MB copy
     completes?  Asked of a pageable and of a pinned (page-locked)
     source: the card's driver can only copy asynchronously from pinned
     memory, which torch offers and JAX's API does not;
  b) do N back-to-back `fused_window` launches queue (one wait ==
     latency + N x device time) or serialise (N x latency)?  With
     device-resident inputs (b), with an upload per launch (b2), and
     with the host numpy buffer handed straight to the serving route
     (b3: `BucketTable.check_many_packed` makes the copy);
  c) how does the window's time scale with its depth K?

The launches are the port's `fused_window` on the packed i32[K, B, 9]
buffer (the port has no unpacked route), `with_degen=False`,
`compact=True`, as JAX's `gcra_scan(..., compact=True)`.  The card is
the default device; `--cpu` runs the plain version on the host, where a
copy is a memcpy and (a) reads "not measured" for the pinned source.

    python -m throttlecrab_tpu_torch.tools.probe_async [--cpu]
"""

from __future__ import annotations

import sys
import time

import numpy as np
import torch

from ..tpu import fused
from ..tpu.kernel import pack_requests
from ..tpu.table import BucketTable
from .card import card_line, pick_device, sync
from .profile_launch import make_payload

B, CAP = 4096, 1 << 21


def probe_put(dev, n_el=2_000_000):
    """(a): {source: (ms to return, ms to done)} for an n_el i32 upload
    from a pageable and (on a card) a pinned host tensor."""
    res = {}
    sources = {"pageable": torch.ones(n_el, dtype=torch.int32)}
    if dev.type == "cuda":
        sources["pinned"] = sources["pageable"].pin_memory()
    for name, src in sources.items():
        src.to(dev, non_blocking=True)
        sync(dev)
        t0 = time.perf_counter()
        x = src.to(dev, non_blocking=True)
        t_ret = time.perf_counter() - t0
        sync(dev)
        t_done = time.perf_counter() - t0
        del x
        res[name] = (t_ret * 1e3, t_done * 1e3)
    return res


class Windows:
    """Window launches on one table, counted where they are made."""

    def __init__(self, dev, cap=CAP):
        self.dev = dev
        self.table = BucketTable(cap, device=dev)
        self.count = 0

    def resident(self, packed_t, now_t):
        self.count += 1
        return fused.fused_window(self.table.state, packed_t, now_t,
                                  with_degen=False, compact=True)[0]

    def served(self, packed, now):
        self.count += 1
        return self.table.check_many_packed(packed, now, with_degen=False,
                                            compact=True)


def queue_depth(win, mode, n, packed, now):
    """(b): (dispatch ms, total ms) of n launches then one fetch of the
    last output; `mode` is "resident", "h2d" or "numpy"."""
    dev = win.dev
    if mode == "resident":
        packed_t = torch.from_numpy(packed).to(dev)
        now_t = torch.from_numpy(now).to(dev)
        sync(dev)
    t0 = time.perf_counter()
    outs = []
    for _ in range(n):
        if mode == "resident":
            outs.append(win.resident(packed_t, now_t))
        elif mode == "h2d":
            outs.append(win.resident(torch.from_numpy(packed).to(dev),
                                     torch.from_numpy(now).to(dev)))
        else:
            outs.append(win.served(packed, now))
    t_disp = time.perf_counter() - t0
    outs[-1].cpu()
    return t_disp * 1e3, (time.perf_counter() - t0) * 1e3


def depth_scaling(win, rng, K, b=B, reps=3):
    """(c): ms per blocked launch at depth K (after one untimed launch)."""
    pay = make_payload(rng, K, b, win.table.capacity)
    packed_t = torch.from_numpy(pack_requests(*pay[:7])).to(win.dev)
    now_t = torch.from_numpy(pay[7]).to(win.dev)
    win.resident(packed_t, now_t)
    sync(win.dev)
    t0 = time.perf_counter()
    for _ in range(reps):
        win.resident(packed_t, now_t)
        sync(win.dev)
    return (time.perf_counter() - t0) / reps * 1e3


def run(dev, b=B, cap=CAP, depths=(16, 64, 128), seed=3, out=print):
    """Every probe on `dev`; returns {"launches": windows launched,
    "fused_launches": what fused.LAUNCHES moved by}."""
    before = fused.LAUNCHES
    out(f"device: {dev} ({card_line(dev)})")
    rng = np.random.default_rng(seed)
    for name, (t_ret, t_done) in probe_put(dev).items():
        out(f"a) .to(dev, non_blocking=True) 8MB {name}: returns in "
            f"{t_ret:.3f} ms, done in {t_done:.3f} ms")
    if dev.type != "cuda":
        out("a) pinned source: not measured (no card)")

    win = Windows(dev, cap)
    pay = make_payload(rng, 16, b, cap)
    packed, now = pack_requests(*pay[:7]), pay[7]
    queue_depth(win, "resident", 1, packed, now)  # first build and load
    for label, mode, ns in (
        ("b) {n} launches (device-resident inputs):", "resident",
         (1, 2, 4, 8)),
        ("b2) {n} launches (h2d per launch):      ", "h2d", (1, 4, 8)),
        ("b3) {n} launches (numpy args direct):   ", "numpy", (1, 4, 8)),
    ):
        for n in ns:
            t_disp, t_all = queue_depth(win, mode, n, packed, now)
            out(f"{label.format(n=n)} dispatch {t_disp:7.3f} ms, total "
                f"{t_all:7.3f} ms  ({t_all / n:6.3f} ms/launch)")
    for K in depths:
        dt = depth_scaling(win, rng, K, b)
        out(f"c) window K={K:4d}: {dt:7.3f} ms/launch blocked "
            f"({K * b / dt / 1e3:6.2f} M dec/s)")
    sync(dev)
    moved = fused.LAUNCHES - before
    if dev.type == "cuda" and moved != win.count:
        raise AssertionError(f"fused.LAUNCHES moved by {moved}, the probe "
                             f"launched {win.count} windows")
    return {"launches": win.count, "fused_launches": moved}


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    run(pick_device("--cpu" in argv))
    return 0


if __name__ == "__main__":
    sys.exit(main())
