"""Time the w32 tier's host finish (`tpu/kernel.py` `finish_w32`) on the
host, one way of decoding against another, with threads finishing side
by side as the by-id caller's pool does:

  numpy         the numpy expression finish_w32 ran before its native
                pass: shifts and masks, each plane a fresh array
  numpy_out     the same shifts and masks written with `out=` into the
                pooled planes finish_w32 hands out (ufuncs release the
                GIL as the native pass does)
  native_fresh  the native pass (csrc/finish_w32.cpp) into a fresh
                (4, n) array a call
  native        finish_w32 itself: the native pass into pooled planes

Each of `--threads` threads decodes its own `--words` words `--rounds`
times, holding each result until its next call as a finish worker does;
the line of an arm gives the median and p90 ms a call over all calls and
the wall seconds of the whole arm.  `--served` times instead one
served sub-batch (`--words` words, one thread) as `dispatch_many` and
`dispatch_wire_window` decode it, `np.stack(finish_w32(...))`, in us a
call, numpy against native.

    python -m throttlecrab_tpu_torch.tools.probe_finish_w32 \\
        [--words 4194304] [--threads 8] [--rounds 40] [--served]
"""

from __future__ import annotations

import argparse
import statistics
import threading
import time

import numpy as np

from .. import native
from ..tpu import kernel
from ..tpu.kernel import W32_REM_MAX, W32_RESET_MAX, W32_RETRY_MAX


def numpy_finish(words):
    u = np.ascontiguousarray(words, np.int32).view(np.uint32)
    return (
        (u & 1).astype(np.int32),
        ((u >> 1) & np.uint32(W32_REM_MAX)).astype(np.int32),
        ((u >> 11) & np.uint32(W32_RESET_MAX)).astype(np.int32),
        ((u >> 22) & np.uint32(W32_RETRY_MAX)).astype(np.int32),
    )


def numpy_out_finish(words):
    """The numpy expression, each plane written in place into the pooled
    (4, n) buffer (no temporaries: shift into the plane, then mask it)."""
    w = np.ascontiguousarray(words, np.int32)
    u = w.view(np.uint32)
    out = kernel._w32_planes(w.shape)
    p = out.view(np.uint32)
    np.bitwise_and(u, np.uint32(1), out=p[0])
    for row, at, top in ((1, 1, W32_REM_MAX), (2, 11, W32_RESET_MAX),
                         (3, 22, W32_RETRY_MAX)):
        np.right_shift(u, np.uint32(at), out=p[row])
        np.bitwise_and(p[row], np.uint32(top), out=p[row])
    return tuple(out)


def native_fresh_finish(words):
    w = np.ascontiguousarray(words, np.int32)
    out = np.empty((4,) + w.shape, np.int32)
    native.get_finish_lib().tk_finish_w32(
        w.ctypes.data, w.size, W32_REM_MAX, W32_RESET_MAX, W32_RETRY_MAX,
        out.ctypes.data)
    return tuple(out)


ARMS = {
    "numpy": numpy_finish,
    "numpy_out": numpy_out_finish,
    "native_fresh": native_fresh_finish,
    "native": kernel.finish_w32,
}


def words_for(n, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(-(1 << 31), 1 << 31, n, dtype=np.int64).astype(
        np.int32)


def run_arm(fn, inputs, rounds):
    """(ms of every call, wall seconds) of len(inputs) threads, each
    decoding its own words `rounds` times."""
    times, go = [], threading.Barrier(len(inputs) + 1)
    lock = threading.Lock()

    def worker(words):
        mine, held = [], None
        go.wait()
        for _ in range(rounds):
            t = time.perf_counter()
            got = fn(words)
            mine.append((time.perf_counter() - t) * 1e3)
            held = got  # dropped at the next call, as a worker does
        del held
        with lock:
            times.extend(mine)

    threads = [threading.Thread(target=worker, args=(w,)) for w in inputs]
    for th in threads:
        th.start()
    go.wait()
    t0 = time.perf_counter()
    for th in threads:
        th.join()
    return times, time.perf_counter() - t0


def check_arms(n):
    words = words_for(min(n, 1 << 16), 1)
    want = numpy_finish(words)
    for name, fn in ARMS.items():
        got = fn(words)
        if not all(np.array_equal(g, w) for g, w in zip(got, want)):
            raise AssertionError(f"arm {name} decodes differently")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--words", type=int, default=1 << 22)
    ap.add_argument("--threads", type=int, default=8)
    ap.add_argument("--rounds", type=int, default=40)
    ap.add_argument("--served", action="store_true")
    args = ap.parse_args(argv)
    if native.get_finish_lib() is None:
        print(f"no native finish: {native.finish_build_error()}")
        return 2
    check_arms(args.words)
    if args.served:
        words = words_for(args.words, 2)
        for name in ("numpy", "native"):
            fn = ARMS[name]
            for _ in range(50):
                np.stack(fn(words))
            us = []
            for _ in range(args.rounds):
                t = time.perf_counter()
                np.stack(fn(words))
                us.append((time.perf_counter() - t) * 1e6)
            print(f"served {name:6s} n={args.words}: median "
                  f"{statistics.median(us):.2f} us a sub-batch "
                  f"(min {min(us):.2f}, {args.rounds} calls)")
        return 0
    inputs = [words_for(args.words, 10 + t) for t in range(args.threads)]
    for name, fn in ARMS.items():
        run_arm(fn, inputs, 2)  # the pool holds the arm's buffers after
        times, wall = run_arm(fn, inputs, args.rounds)
        q = statistics.quantiles(times, n=10)
        print(f"{name:12s} n={args.words} threads={args.threads}: median "
              f"{statistics.median(times):.2f} ms a call, p90 {q[-1]:.2f}, "
              f"wall {wall:.2f} s for {len(times)} calls")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
