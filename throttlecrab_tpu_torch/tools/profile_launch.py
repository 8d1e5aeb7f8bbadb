"""Decompose the per-launch cost of the port's decision path on the card.

The counterpart of the JAX package's `scripts/profile_launch.py`, with
its flags, its steps, its printed labels and its report keys:

  1. ping            — a scalar op + `.item()` (launch + fetch round
                       trip), and the op + `torch.cuda.synchronize()`
                       without the fetch
  2. h2d transfer    — JAX's 8 request arrays, each
                       `torch.from_numpy(a).to(dev)`, then a sync; and
                       "one fused buffer": the packed i32[K, B, 9]
                       buffer of `kernel.pack_requests`, the one copy the
                       port's serving route makes.  Both again from
                       page-locked (pinned) host memory.
  3. device compute  — `fused.fused_window` on a device-resident packed
                       buffer, `with_degen=False`, `compact=True` (the
                       4-plane tier of JAX's `gcra_scan(..., compact=True)`),
                       then a sync; beside the host clock, the card's
                       own time from torch.profiler and from CUDA events
  4. d2h fetch       — `.cpu()` of the i32[K, 4, B] output.  Every `.cpu()`
                       copies: torch keeps no host copy of a device
                       tensor, so JAX's note that a second fetch of one
                       array is served from a host cache does not carry
                       over.  Also into a pinned buffer.
  5. end-to-end      — the port's serving shape, as
                       `BucketTable.check_many_packed` does it: host
                       pack, one copy, one launch, one fetch
  5b. pipelined      — launch N+1 before fetching N's output

The one structural difference: JAX's `gcra_scan` takes the 8 request
arrays unpacked, and the port has no unpacked route — its kernel reads
the packed buffer — so steps 3 and 5 launch on the packed buffer and
step 2 times both uploads.

Defaults as in JAX: B = 4096, K = 16, a 2^21-slot table (BASELINE
config 3's table order).  The card is the default device; `--cpu` runs
the kernel's plain version on the host (pinned copies and the card's
clocks then read "not measured", as null).  `--trace DIR` writes a
torch.profiler Chrome trace of four end-to-end launches (where JAX
writes an xprof) through `tpu/profiling.trace`.

    python -m throttlecrab_tpu_torch.tools.profile_launch [--cpu]
        [--trace DIR] [--batch B] [--depth K]

Prints the steps on stderr and one JSON report on stdout: JAX's keys,
plus the device, the card's name and power limit, `fused.LAUNCHES`
before and after, and the window launches the script counted itself
(on the card the two must agree, or the run fails).
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from ..tpu import fused
from ..tpu.kernel import pack_requests
from ..tpu.table import BucketTable
from .card import card_line, device_ms, event_ms, pick_device, sync, timeit

CAP = 1 << 21
NOW = 1_753_000_000_000_000_000


def make_payload(rng, K, B, cap=CAP):
    """JAX's input payload, drawn in its order: (slots, rank, is_last,
    emission, tolerance, quantity, valid, now)."""
    return (
        rng.integers(0, cap - 1, (K, B)).astype(np.int32),
        np.zeros((K, B), np.int32),
        np.ones((K, B), bool),
        np.full((K, B), 20_000_000, np.int64),
        np.full((K, B), 1_000_000_000, np.int64),
        np.ones((K, B), np.int64),
        np.ones((K, B), bool),
        np.full(K, NOW, np.int64),
    )


class Launcher:
    """The window launches of one run, counted where they are made."""

    def __init__(self, table: BucketTable) -> None:
        self.table = table
        self.count = 0

    def compute(self, packed_t, now_t):
        """Step 3: one window on device-resident inputs."""
        self.count += 1
        out, _ = fused.fused_window(
            self.table.state, packed_t, now_t, with_degen=False, compact=True
        )
        return out

    def serve(self, payload):
        """Step 5's launch: host pack, one copy, one launch (the route of
        BucketTable.check_many_packed); the output stays on the card."""
        self.count += 1
        packed = pack_requests(*payload[:7])
        return self.table.check_many_packed(
            packed, payload[7], with_degen=False, compact=True
        )


def first_window(dev, B=4096, K=16, cap=CAP, seed=3):
    """Step 3's first window on a fresh table: (output, table state after
    it) on the host, from the payload the profile draws for `seed`."""
    payload = make_payload(np.random.default_rng(seed), K, B, cap)
    launcher = Launcher(BucketTable(cap, device=dev))
    packed_t = torch.from_numpy(pack_requests(*payload[:7])).to(dev)
    out = launcher.compute(packed_t, torch.from_numpy(payload[7]).to(dev))
    return out.cpu(), launcher.table.state.cpu()


def profile(dev, B=4096, K=16, cap=CAP, trace_dir=None, seed=3, log=None):
    """Run every step on `dev`; returns (report, first) with `first` the
    (output, state) of step 3's first window on the fresh table."""
    log = log or (lambda line: print(line, file=sys.stderr, flush=True))
    card = card_line(dev)
    log(f"device: {dev} ({card})")
    rng = np.random.default_rng(seed)
    report = {"device": str(dev), "platform": dev.type, "card": card,
              "B": B, "K": K, "cap": cap}
    cuda = dev.type == "cuda"

    # ---- 1. ping ------------------------------------------------------
    one = torch.ones((), dtype=torch.int32, device=dev)
    (one + 1).item()
    p50, _ = timeit(lambda: (one + 1).item())
    report["ping_ms"] = p50 * 1e3
    log(f"1. ping (scalar op + fetch):      {p50 * 1e3:8.3f} ms")

    def op_sync():
        one + 1
        sync(dev)

    p50, _ = timeit(op_sync)
    report["ping_noblockfetch_ms"] = p50 * 1e3
    log(f"   ping (sync, no .item()):       {p50 * 1e3:8.3f} ms")

    # ---- input payload --------------------------------------------------
    payload = make_payload(rng, K, B, cap)
    nbytes = sum(a.nbytes for a in payload)
    report["h2d_bytes"] = nbytes
    packed = pack_requests(*payload[:7])
    report["h2d_fused_bytes"] = packed.nbytes + payload[7].nbytes
    host = [torch.from_numpy(a) for a in payload]
    host_fused = [torch.from_numpy(packed), host[7]]

    # ---- 2. h2d transfer ----------------------------------------------
    def upload(tensors, non_blocking=False):
        arrs = [t.to(dev, non_blocking=non_blocking) for t in tensors]
        sync(dev)
        return arrs

    p50, _ = timeit(lambda: upload(host))
    report["h2d_ms"] = p50 * 1e3
    log(f"2. h2d transfer ({nbytes / 1e6:.2f} MB, 8 arrays): "
        f"{p50 * 1e3:8.3f} ms")
    p50, _ = timeit(lambda: upload(host_fused))
    report["h2d_fused_ms"] = p50 * 1e3
    log(f"   h2d one packed buffer ({report['h2d_fused_bytes'] / 1e6:.2f} "
        f"MB): {p50 * 1e3:8.3f} ms")
    report["h2d_pinned_ms"] = report["h2d_fused_pinned_ms"] = None
    if cuda:
        pin = [t.pin_memory() for t in host]
        pin_fused = [t.pin_memory() for t in host_fused]
        p50, _ = timeit(lambda: upload(pin, non_blocking=True))
        report["h2d_pinned_ms"] = p50 * 1e3
        log(f"   h2d 8 arrays, pinned:          {p50 * 1e3:8.3f} ms")
        p50, _ = timeit(lambda: upload(pin_fused, non_blocking=True))
        report["h2d_fused_pinned_ms"] = p50 * 1e3
        log(f"   h2d packed buffer, pinned:     {p50 * 1e3:8.3f} ms")

    # ---- 3. device compute (inputs resident, output not fetched) ------
    before = fused.LAUNCHES
    launcher = Launcher(BucketTable(cap, device=dev))
    packed_t, now_t = upload(host_fused)
    first_out = launcher.compute(packed_t, now_t)
    first = (first_out.to("cpu", copy=True),
             launcher.table.state.to("cpu", copy=True))

    def compute():
        out = launcher.compute(packed_t, now_t)
        sync(dev)
        return out

    p50, p99 = timeit(compute)
    report["compute_ms"] = p50 * 1e3
    report["compute_p99_ms"] = p99 * 1e3
    log(f"3. device compute (window x{K}):   {p50 * 1e3:8.3f} ms (host clock)")
    report["compute_event_ms"] = report["compute_device_ms"] = None
    report["compute_kernels_per_call"] = None
    if cuda:
        report["compute_event_ms"] = event_ms(
            dev, lambda: launcher.compute(packed_t, now_t))
        report["compute_device_ms"], report["compute_kernels_per_call"] = (
            device_ms(dev, compute))
        log(f"   CUDA events {report['compute_event_ms']:.4f} ms, profiler "
            f"{report['compute_device_ms']} ms in "
            f"{report['compute_kernels_per_call']} kernel(s) per call")

    # ---- 4. d2h fetch ---------------------------------------------------
    out = compute()
    report["d2h_bytes"] = out.numel() * out.element_size()
    p50, _ = timeit(lambda: out.to("cpu", copy=True))
    report["d2h_ms"] = p50 * 1e3
    log(f"4. d2h fetch ({report['d2h_bytes'] / 1e6:.2f} MB planes out): "
        f"{p50 * 1e3:8.3f} ms")
    report["d2h_pinned_ms"] = None
    if cuda:
        dst = torch.empty(out.shape, dtype=out.dtype, pin_memory=True)

        def fetch_pinned():
            dst.copy_(out, non_blocking=True)
            sync(dev)

        p50, _ = timeit(fetch_pinned)
        report["d2h_pinned_ms"] = p50 * 1e3
        log(f"   d2h into a pinned buffer:      {p50 * 1e3:8.3f} ms")

    # ---- 5. end-to-end: pack + h2d + compute + fetch -------------------
    def end_to_end():
        return launcher.serve(payload).cpu()

    p50, p99 = timeit(end_to_end)
    report["e2e_ms"] = p50 * 1e3
    report["e2e_p99_ms"] = p99 * 1e3
    rate = K * B / p50
    report["e2e_decisions_per_s"] = rate
    log(f"5. end-to-end launch:             {p50 * 1e3:8.3f} ms "
        f"({rate / 1e6:.2f} M decisions/s)")

    # ---- 5b. pipelined: launch N+1 before fetching N's output ----------
    def pipelined(n_launch=8):
        pending = None
        t0 = time.perf_counter()
        for _ in range(n_launch):
            out = launcher.serve(payload)
            if pending is not None:
                pending.cpu()
            pending = out
        pending.cpu()
        return (time.perf_counter() - t0) / n_launch

    pipelined(2)
    per = min(pipelined() for _ in range(3))
    report["pipelined_ms"] = per * 1e3
    report["pipelined_decisions_per_s"] = K * B / per
    log(f"5b. pipelined launch:             {per * 1e3:8.3f} ms "
        f"({K * B / per / 1e6:.2f} M decisions/s)")

    if trace_dir:
        from ..tpu.profiling import trace

        with trace(trace_dir) as session:
            for _ in range(4):
                end_to_end()
        log(f"torch.profiler trace written to {session.path}")
        report["trace_dir"] = trace_dir
        report["trace_path"] = session.path

    sync(dev)
    report["launches_counted"] = launcher.count
    report["fused_launches_before"] = before
    report["fused_launches_after"] = fused.LAUNCHES
    if cuda and fused.LAUNCHES - before != launcher.count:
        raise AssertionError(
            f"fused.LAUNCHES moved by {fused.LAUNCHES - before}, the "
            f"script launched {launcher.count} windows")
    return report, first


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--trace", default=None)
    ap.add_argument("--batch", type=int, default=4096)
    ap.add_argument("--depth", type=int, default=16)
    args = ap.parse_args(argv)
    report, _ = profile(pick_device(args.cpu), B=args.batch, K=args.depth,
                        trace_dir=args.trace)
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    sys.exit(main())
