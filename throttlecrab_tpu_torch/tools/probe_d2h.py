"""Time every device->host fetch strategy torch offers, on the card.

The counterpart of the JAX package's `scripts/probe_d2h.py`, which times
every fetch strategy the JAX API offers; here each is mapped onto what
torch offers, under JAX's labels a)-h):

  a) serial `.cpu()`                        (JAX: serial np.asarray)
  b) `.copy_(src, non_blocking=True)` into
     pinned buffers, then one event sync    (copy_to_host_async, then asarray)
  c) one fetch of the whole list: the
     outputs stacked on the card, one `.cpu()` (jax.device_get(list))
  d) a 4-thread pool of `.cpu()`
  e) 16 x 1 MB against 1 x 16 MB
  f) i8 against i32 at equal bytes
  g) the 4 KB latency floor
  h) a fetch of a ready output while a chain of 200 `x * 3 + 1` ops
     runs, then the chain's own fetch

Each output is `x * 3 + 1` (a torch op, not a kernel of the port) of a
fresh upload, settled with a sync and a 0.3 s pause before the timed
fetch, as in JAX.  JAX's `timed` deletes a name it never bound and so
stops at its first strategy; this one runs them all.  The card is the
default device; `--cpu` runs on the host, where a fetch is a memcpy and
(b) reads "not measured".

    python -m throttlecrab_tpu_torch.tools.probe_d2h [--cpu]
"""

from __future__ import annotations

import sys
import time
from concurrent.futures import ThreadPoolExecutor

import torch

from .card import card_line, pick_device, sync

N, MB = 4, 4


def mk(x):
    return x * 3 + 1


def fresh_outputs(dev, n, mb, dtype=torch.int32):
    """n distinct never-fetched device tensors of `mb` MB each."""
    size = torch.empty((), dtype=dtype).element_size()
    n_el = int(mb * (1 << 20)) // size
    outs = []
    for i in range(n):
        seed = (torch.arange(n_el, dtype=torch.int32) % 100 + i).to(dev)
        outs.append(mk(seed).to(dtype))
    sync(dev)  # settle the compute; not a fetch
    time.sleep(0.3)
    return outs


def timed(label, fn, outs, out=print):
    """Time fn(outs) and print MB/s; returns seconds."""
    t0 = time.perf_counter()
    fn(outs)
    dt = time.perf_counter() - t0
    total_mb = sum(o.numel() * o.element_size() for o in outs) / 1e6
    out(f"{label:34s}: {dt * 1e3:8.3f} ms total "
        f"({total_mb:6.1f} MB, {total_mb / dt:9.1f} MB/s)")
    return dt


def serial(outs):
    return [o.cpu() for o in outs]


def pinned_async(dsts):
    """The strategy of (b), with its pinned destinations allocated before
    the timed call (a page-locked allocation costs milliseconds)."""

    def fetch(outs):
        for d, o in zip(dsts, outs):
            d.copy_(o, non_blocking=True)
        done = torch.cuda.Event()
        done.record()
        done.synchronize()
        return dsts

    return fetch


def stacked(outs):
    return torch.stack(outs).cpu()


def threads(outs):
    with ThreadPoolExecutor(4) as ex:
        return list(ex.map(lambda o: o.cpu(), outs))


def run(dev, n=N, mb=MB, chain=200, out=print):
    """Every strategy on `dev`; returns {label: seconds}."""
    out(f"device: {dev} ({card_line(dev)})")
    res = {}
    res["a"] = timed("a) serial .cpu()", serial, fresh_outputs(dev, n, mb),
                     out)
    if dev.type == "cuda":
        outs = fresh_outputs(dev, n, mb)
        dsts = [torch.empty(o.shape, dtype=o.dtype, pin_memory=True)
                for o in outs]
        res["b"] = timed("b) non_blocking into pinned, 1 sync",
                         pinned_async(dsts), outs, out)
    else:
        out("b) non_blocking into pinned, 1 sync: not measured (no card)")
    res["c"] = timed("c) torch.stack(list).cpu()", stacked,
                     fresh_outputs(dev, n, mb), out)
    res["d"] = timed("d) 4-thread .cpu()", threads, fresh_outputs(dev, n, mb),
                     out)
    res["e16"] = timed("e) 16 x 1 MB serial", serial,
                       fresh_outputs(dev, 4 * n, mb / 4), out)
    res["e1"] = timed("e) 1 x 16 MB", serial, fresh_outputs(dev, 1, n * mb),
                      out)
    res["f"] = timed("f) i8 same bytes serial", serial,
                     fresh_outputs(dev, n, mb, torch.int8), out)
    small = fresh_outputs(dev, 4, 4096 / (1 << 20))
    t0 = time.perf_counter()
    for o in small:
        o.cpu()
    dt = time.perf_counter() - t0
    res["g"] = dt
    out(f"g) 4 x 4 KB serial              : {dt * 1e3:8.3f} ms total "
        f"({dt / 4 * 1e3:6.3f} ms each)")
    # h) does a fetch of a ready output wait for a long chain queued
    # after it?
    x = torch.arange(1 << 20, dtype=torch.int32).to(dev)
    ready = mk(torch.arange(1 << 22, dtype=torch.int32).to(dev))
    sync(dev)
    time.sleep(0.3)
    for _ in range(chain):
        x = mk(x)
    t0 = time.perf_counter()
    ready.cpu()
    dt_r = time.perf_counter() - t0
    t0 = time.perf_counter()
    x.cpu()
    dt_c = time.perf_counter() - t0
    res["h_ready"], res["h_chain"] = dt_r, dt_c
    out(f"h) fetch ready-while-busy: {dt_r * 1e3:.3f} ms; "
        f"then chain drain: {dt_c * 1e3:.3f} ms")
    return res


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    run(pick_device("--cpu" in argv))
    return 0


if __name__ == "__main__":
    sys.exit(main())
