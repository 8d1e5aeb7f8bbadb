"""Do the card's uploads and fetches overlap?  Measure h2d / d2h overlap.

The counterpart of the JAX package's `scripts/probe_duplex.py`, with its
flags and its report:

  1. h2d alone      — N uploads of M MB, then a sync.
  2. d2h alone      — N fetches of M MB (never-fetched device tensors).
  3. h2d ∥ d2h      — both at once, from two threads, each on its own
                      CUDA stream.

On a full-duplex link the concurrent wall time is about max(h2d, d2h);
on a serialised one about h2d + d2h.  Each run is made twice: from and
into pageable host memory, and from and into pinned (page-locked)
buffers with `non_blocking=True` copies.  The card overlaps a copy with
other work only from pinned memory on a stream of its own, so the probe
shows both cases.  The card is the default device; `--cpu` runs the
pageable case on the host (memcpy on both sides) and reads "not
measured" for the pinned one.

    python -m throttlecrab_tpu_torch.tools.probe_duplex [--cpu] [--mb M]
        [--n N]
"""

from __future__ import annotations

import sys
import time
from concurrent.futures import ThreadPoolExecutor
from contextlib import nullcontext

import torch

from .card import card_line, pick_device, sync


def arg(argv, flag: str, default: int) -> int:
    if flag in argv:
        return int(argv[argv.index(flag) + 1])
    return default


class Duplex:
    """Host buffers, device tensors and one stream per direction."""

    def __init__(self, dev, mb, pinned):
        self.dev = dev
        self.n_el = mb * (1 << 20) // 4
        self.pinned = pinned
        cuda = dev.type == "cuda"
        self.up_stream = torch.cuda.Stream(dev) if cuda else None
        self.down_stream = torch.cuda.Stream(dev) if cuda else None

    def _on(self, stream):
        if stream is None:
            return nullcontext()
        return torch.cuda.stream(stream)

    def _host(self, t):
        return t.pin_memory() if self.pinned else t

    def host_buffers(self, n):
        return [
            self._host(torch.arange(self.n_el, dtype=torch.int32) + 7 * i)
            for i in range(n)
        ]

    def fresh_device_outputs(self, n):
        """n distinct never-fetched device tensors and a host destination
        for each, written once so no first-touch page fault lands in the
        timed copy."""
        outs = [
            torch.arange(self.n_el, dtype=torch.int32).to(self.dev) * 3 + i
            for i in range(n)
        ]
        dsts = [self._host(torch.zeros(self.n_el, dtype=torch.int32))
                for _ in range(n)]
        sync(self.dev)
        return outs, dsts

    def run_h2d(self, bufs):
        t = time.perf_counter()
        with self._on(self.up_stream):
            put = [b.to(self.dev, non_blocking=self.pinned) for b in bufs]
            if self.up_stream is not None:
                self.up_stream.synchronize()
        t = time.perf_counter() - t
        del put
        return t

    def run_d2h(self, outs_dsts):
        outs, dsts = outs_dsts
        t = time.perf_counter()
        with self._on(self.down_stream):
            for o, d in zip(outs, dsts):
                d.copy_(o, non_blocking=self.pinned)
            if self.down_stream is not None:
                self.down_stream.synchronize()
        return time.perf_counter() - t


def report(label, secs, mbytes, out):
    out(f"{label:<18} {secs * 1e3:8.3f} ms   {mbytes / secs:9.1f} MB/s")


def both(pool, d, bufs, outs):
    """Seconds for the uploads and the fetches run at once, one thread
    each."""
    t = time.perf_counter()
    f_up = pool.submit(d.run_h2d, bufs)
    f_down = pool.submit(d.run_d2h, outs)
    f_up.result(), f_down.result()
    return time.perf_counter() - t


def measure(dev, mb, n, pinned, out=print):
    """One case; returns {"h2d", "d2h", "both": seconds, "ratio"}."""
    d = Duplex(dev, mb, pinned)
    with ThreadPoolExecutor(2) as pool:
        # Warm-up: one throwaway round of each, and of both at once on
        # the pool's two threads (their first CUDA calls are not timed).
        d.run_h2d(d.host_buffers(n))
        d.run_d2h(d.fresh_device_outputs(n))
        both(pool, d, d.host_buffers(n), d.fresh_device_outputs(n))
        total_mb = mb * n
        t_up = d.run_h2d(d.host_buffers(n))
        report("h2d alone", t_up, total_mb, out)
        t_down = d.run_d2h(d.fresh_device_outputs(n))
        report("d2h alone", t_down, total_mb, out)
        # Both sides prepared first, so no setup is timed.
        outs = d.fresh_device_outputs(n)
        bufs = d.host_buffers(n)
        t_both = both(pool, d, bufs, outs)
    report("h2d ∥ d2h", t_both, 2 * total_mb, out)
    serial = t_up + t_down
    overlap = max(t_up, t_down)
    out(f"serialized-link prediction {serial * 1e3:.3f} ms, full-duplex "
        f"prediction {overlap * 1e3:.3f} ms, measured {t_both * 1e3:.3f} ms")
    ratio = (t_both - overlap) / max(serial - overlap, 1e-9)
    out(f"serialization ratio {ratio:.2f}  "
        "(1.0 = fully serialized, 0.0 = full duplex)")
    return {"h2d": t_up, "d2h": t_down, "both": t_both, "ratio": ratio}


def run(dev, mb=8, n=6, out=print):
    """Both cases on `dev`: {"pageable": ..., "pinned": ... or None}."""
    out(f"device: {dev} ({card_line(dev)})  ({mb} MB x {n} buffers per "
        "stream)")
    res = {}
    for pinned in (False, True):
        name = "pinned" if pinned else "pageable"
        if pinned and dev.type != "cuda":
            out(f"\n{name}: not measured (no card)")
            res[name] = None
            continue
        out(f"\n{name} host memory:")
        res[name] = measure(dev, mb, n, pinned, out)
    return res


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    run(pick_device("--cpu" in argv), mb=arg(argv, "--mb", 8),
        n=arg(argv, "--n", 6))
    return 0


if __name__ == "__main__":
    sys.exit(main())
