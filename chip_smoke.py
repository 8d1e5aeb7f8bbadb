#!/usr/bin/env python3
"""Smoke test of the PyTorch/H100 port on one CUDA card.

    python3 chip_smoke.py

Five phases, each printing its results; any failure raises and the script
exits nonzero without its last line:

1. card: the card's name and power limit (nvidia-smi), and the build of
   the decision-window kernel from csrc/ (nvcc, timed);
2. kernel vs plain: the CUDA kernel (tpu/fused.py) against its plain
   torch version (tpu/kernel.py) on the card, at the serving shape
   (N = 2^20 + 2^16 rows, K = 16 sub-batches of B = 4096) on hostile
   windows — duplicates, degenerate lanes, invalid lanes, edge-valued
   tolerances — over two consecutive windows, for all five output tiers
   x row widths 4 and 6.  Tolerance: exact equality (integer math) on
   valid-lane outputs, real-slot state, expired-hit counts and insight
   totals;
3. main path at full size: TorchRateLimiter(capacity=2^20) on cuda under
   BASELINE config 3 traffic (1M keys, Zipf-1.1, batch 4096, per-key
   heterogeneous params) through dispatch_many(wire=True), K = 16
   batches per window, plus a window with quantity-0 probes (the exact
   path), then a sweep; the same traffic replayed on device="cpu" must
   give identical results and state, and the kernel's launch counter,
   zeroed just before, must have moved;
4. server: `python -m throttlecrab_tpu_torch.server --http` on cuda
   answers 5 POST /throttle for one key (burst 3, 1 per hour) as
   allowed x3 (remaining 2, 1, 0) then denied x2, answers /health and
   /metrics, and exits 0 on SIGTERM;
5. times, beside the card's name and power limit: the kernel's and the
   plain version's time per window at K=16, B=4096, W=4 and W=6 in the
   w32 tier (CUDA events), and phase 3's end-to-end decisions/s.

The line before the last is the {"kernels": [...]} record; the last line
is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import signal
import socket
import subprocess
import sys
import time
import urllib.request

NS = 1_000_000_000
T0 = 1_753_700_000 * NS
HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3, NVIDIA data sheet
SECTOR = 32  # bytes the memory system moves for one scattered row
K, B = 16, 4096  # the serving window: max_scan_depth x batch_size
CAPACITY = 1 << 20
TIERS = [(False, True), (True, True), (True, False), ("cur", False),
         ("w32", False)]


def ptxas_summary(log: str) -> list:
    """One line per kernel instantiation from nvcc's -Xptxas -v report:
    registers, stack frame and spills."""
    import re

    lines, name = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            mangled = m.group(1)
            d = re.search(r"decide_kernelILi(\d)ELb(\d)ELi(\d)E", mangled)
            s = re.search(r"scatter_kernelILi(\d)E", mangled)
            tier = ("False", "True", "cur", "w32")
            name = (
                f"decide W={d.group(1)} with_degen={d.group(2) == '1'} "
                f"tier={tier[int(d.group(3))]}" if d
                else f"scatter W={s.group(1)}" if s else mangled
            )
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores",
                      line)
        if m and name:
            frame = f"stack {m.group(1)} B, spill stores {m.group(2)} B"
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            lines.append(f"{name}: {m.group(1)} registers, {frame}")
            name = None
    return sorted(lines)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout.strip()


# ---- hostile windows (phase 2) ------------------------------------------ #


def segments(slots, valid):
    """Vectorised duplicate-key structure of one sub-batch: (rank,
    is_last, first) per lane, `first` the lane opening its segment.
    Invalid lanes are segments of their own (rank 0, is_last)."""
    import numpy as np

    n = len(slots)
    lane = np.arange(n)
    key = np.where(valid, slots.astype(np.int64), -1 - lane)
    order = np.argsort(key, kind="stable")
    sk = key[order]
    start = np.r_[True, sk[1:] != sk[:-1]]
    run_start = np.maximum.accumulate(np.where(start, lane, 0))
    rank = np.empty(n, np.int32)
    rank[order] = lane - run_start
    is_last = np.empty(n, bool)
    is_last[order] = np.r_[sk[1:] != sk[:-1], True]
    first = np.empty(n, np.int64)
    first[order] = order[run_start]
    return rank, is_last, first


def hostile_window(rng, k, b, cap, degen):
    """(packed i32[k, b, 9], now i64[k], valid bool[k, b]): half the lanes
    on a hot set of 512 slots (long duplicate segments), degenerate params
    when `degen`, 10 % invalid lanes, edge-valued tolerances."""
    import numpy as np

    from throttlecrab_tpu_torch.tpu.kernel import pack_requests

    hot = rng.integers(0, cap, 512)
    slots = np.where(
        rng.random((k, b)) < 0.5,
        hot[rng.integers(0, 512, (k, b))],
        rng.integers(0, cap, (k, b)),
    ).astype(np.int32)
    if degen:
        em = rng.choice([0, 1, 1000, NS, 7 * NS, 1 << 62], (k, b))
        tol = rng.choice(
            [0, 5, NS, 100 * NS, (1 << 61) + 7, -(3 * NS), (1 << 63) - 1,
             -(1 << 63)], (k, b),
        )
        q = rng.choice([0, 1, 2, 50], (k, b))
    else:
        em = rng.choice([1, 1000, NS, 7 * NS], (k, b))
        tol = rng.choice([1, 5, NS, 100 * NS, (1 << 61) - 1], (k, b))
        q = rng.choice([1, 2, 50], (k, b))
    em, tol, q = (np.asarray(a, np.int64) for a in (em, tol, q))
    valid = rng.random((k, b)) < 0.9
    rank = np.zeros((k, b), np.int32)
    is_last = np.ones((k, b), bool)
    for j in range(k):
        rank[j], is_last[j], first = segments(slots[j], valid[j])
        em[j], tol[j], q[j] = em[j][first], tol[j][first], q[j][first]
    now = T0 + np.sort(rng.integers(0, 100 * NS, k)).astype(np.int64)
    return pack_requests(slots, rank, is_last, em, tol, q, valid), now, valid


def hostile_state(rng, rows, cap, width, device):
    """Table rows to start from: empty, live, expired, immortal (I64_MAX
    expiry), TATs near 2^62, and deny counts in the 6-wide layout."""
    import numpy as np
    import torch

    from throttlecrab_tpu_torch.tpu.kernel import (
        EMPTY_EXPIRY,
        _split_cols,
        pack_state,
    )

    kind = rng.integers(0, 5, rows)
    kind[cap:] = 0
    tat = np.where(kind == 0, 0, T0 + rng.integers(-200 * NS, 200 * NS, rows))
    tat = np.where(kind == 4, (1 << 62) - rng.integers(0, 1 << 40, rows), tat)
    exp = np.select(
        [kind == 0, kind == 1, kind == 2, kind == 3],
        [EMPTY_EXPIRY, tat + 100 * NS, T0 - NS, (1 << 63) - 1],
        tat + 50 * NS,
    )
    st = pack_state(torch.from_numpy(tat), torch.from_numpy(exp))
    if width > 4:
        deny = rng.integers(0, 1 << 40, rows)
        deny[cap:] = 0
        st = torch.cat([st, _split_cols(torch.from_numpy(deny))], -1)
    return st.to(device)


def window_step(side, width, st, acc, ins, p, n, **kw):
    """One window through the kernel ("kernel") or its plain version."""
    from throttlecrab_tpu_torch.tpu import fused, kernel

    if width > 4:
        fn = (fused.gcra_scan_packed_fused_ins if side == "kernel"
              else kernel.gcra_scan_packed_ins)
        _, acc, ins, out = fn(st, acc, ins, p, n, **kw)
    else:
        fn = (fused.gcra_scan_packed_fused_acc if side == "kernel"
              else kernel.gcra_scan_packed_acc)
        _, acc, out = fn(st, acc, p, n, **kw)
    return acc, ins, out


def max_abs_err(a, b, mask):
    """Largest |a - b| over masked lanes, exact for int64 values."""
    import numpy as np

    mask = np.broadcast_to(mask, a.shape)
    differ = (a != b) & mask
    if not differ.any():
        return 0
    return max(abs(int(x) - int(y)) for x, y in zip(a[differ], b[differ]))


def compare_kernel_plain(device, k, b, cap, seed=0):
    """Phase 2; returns the largest valid-lane output difference."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    n_rows = cap + (1 << 16)
    windows = {
        degen: [hostile_window(rng, k, b, cap, degen) for _ in range(2)]
        for degen in (True, False)
    }
    worst = 0
    for width in (4, 6):
        base = hostile_state(rng, n_rows, cap, width, device)
        for compact, with_degen in TIERS:
            sides = ("kernel", "plain")
            st = {s: base.clone() for s in sides}
            acc = {s: torch.zeros((), dtype=torch.int64, device=device)
                   for s in sides}
            ins = {s: torch.zeros(2, dtype=torch.int64, device=device)
                   for s in sides}
            for packed, now, valid in windows[with_degen]:
                p = torch.from_numpy(packed).to(device)
                n = torch.from_numpy(now).to(device)
                out = {}
                for s in sides:
                    acc[s], ins[s], out[s] = window_step(
                        s, width, st[s], acc[s], ins[s], p, n,
                        with_degen=with_degen, compact=compact,
                    )
                if device.type == "cuda":
                    torch.cuda.synchronize()
                mask = valid if compact in ("cur", "w32") else valid[:, None]
                err = max_abs_err(
                    out["kernel"].cpu().numpy(), out["plain"].cpu().numpy(),
                    mask,
                )
                worst = max(worst, err)
                same = (
                    torch.equal(st["kernel"][:cap], st["plain"][:cap]),
                    int(acc["kernel"]) == int(acc["plain"]),
                    torch.equal(ins["kernel"], ins["plain"]),
                )
                if err or not all(same):
                    raise AssertionError(
                        f"kernel != plain (width={width}, {compact=}, "
                        f"{with_degen=}): max_abs_err={err}, "
                        f"state/n_exp/ins identical={same}"
                    )
            print(f"  identical: width={width} compact={compact!r} "
                  f"with_degen={with_degen} n_exp={int(acc['kernel'])}")
    return worst


# ---- BASELINE config 3 traffic (phase 3) --------------------------------- #


def config3_windows(rng, n_keys, n_windows, k, b, probe_window):
    """Lists of dispatch_many batches: Zipf-1.1 key draws over `n_keys`,
    per-key (burst, count, period) derived from the key id as bench.py
    does, one timestamp per batch; window `probe_window` turns every
    40th key into a quantity-0 probe (the exact path)."""
    import numpy as np

    p = np.arange(1, n_keys + 1, dtype=np.float64) ** -1.1
    cdf = np.cumsum(p / p.sum())
    windows = []
    now = T0
    for w in range(n_windows):
        batches = []
        for _ in range(k):
            kid = np.minimum(
                np.searchsorted(cdf, rng.random(b)), n_keys - 1
            ).astype(np.int64)
            q = np.ones(b, np.int64)
            if w == probe_window:
                q[kid % 40 == 0] = 0
            batches.append((
                [f"bench:key:{i}" for i in kid.tolist()],
                5 + kid % 60, 50 + kid % 1000, 30 + kid % 120, q, now,
            ))
            now += int(rng.integers(100_000, 2_000_000))
        windows.append(batches)
    return windows


def run_main_path(limiter, windows):
    """Drive the windows through dispatch_many(wire=True) + fetch; returns
    (results, per-window seconds, host clock; fetch waits for the
    device)."""
    results, seconds, tiers, split = [], [], [], []
    for batches in windows:
        t = time.perf_counter()
        handle = limiter.dispatch_many(batches, wire=True)
        t_dispatch = time.perf_counter() - t
        results.append(handle.fetch())
        seconds.append(time.perf_counter() - t)
        split.append((t_dispatch, seconds[-1] - t_dispatch))
        tiers.append(
            "w32" if handle._w32 else "cur" if handle._cur else "planes"
        )
    print(f"  output tiers by window: {tiers}")
    print("  per window ms (dispatch = host prep + enqueue, fetch = wait + "
          "unpack): " + ", ".join(
              f"{d * 1e3:.1f}+{f * 1e3:.1f}" for d, f in split))
    return results, seconds


def assert_same_results(got, want):
    import numpy as np

    for w, (rs_a, rs_b) in enumerate(zip(got, want)):
        for j, (a, b) in enumerate(zip(rs_a, rs_b)):
            for f in ("allowed", "limit", "remaining", "reset_after_s",
                      "retry_after_s", "status"):
                if not np.array_equal(getattr(a, f), getattr(b, f)):
                    raise AssertionError(f"window {w} batch {j}: {f} differs")


# ---- server (phase 4) ---------------------------------------------------- #


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def http(port, method, path, body=None, timeout=30):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=body, method=method,
        headers={"Content-Type": "application/json"} if body else {},
    )
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return r.status, r.read()


def check_server(extra_env=None):
    import os

    port = free_port()
    env = dict(os.environ, **(extra_env or {}))
    proc = subprocess.Popen(
        [sys.executable, "-m", "throttlecrab_tpu_torch.server", "--http",
         "--http-host", "127.0.0.1", "--http-port", str(port)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    )
    try:
        deadline = time.monotonic() + 180
        while True:
            if proc.poll() is not None:
                raise AssertionError(
                    f"server exited {proc.returncode}:\n{proc.stdout.read()}"
                )
            try:
                if http(port, "GET", "/health", timeout=2) == (200, b"OK"):
                    break
            except OSError:
                pass
            if time.monotonic() > deadline:
                raise AssertionError("server did not come up in 180 s")
            time.sleep(0.25)
        body = json.dumps({"key": "smoke:1", "max_burst": 3,
                           "count_per_period": 1, "period": 3600}).encode()
        answers = [json.loads(http(port, "POST", "/throttle", body)[1])
                   for _ in range(5)]
        for a in answers:
            print(f"  {a}")
        allowed = [a["allowed"] for a in answers]
        remaining = [a["remaining"] for a in answers]
        if allowed != [True, True, True, False, False] or (
            remaining[:3] != [2, 1, 0]
        ):
            raise AssertionError(f"unexpected answers {answers}")
        status, text = http(port, "GET", "/metrics")
        if status != 200 or b"throttlecrab_requests_allowed 3" not in text:
            raise AssertionError("/metrics did not count the requests")
        print(f"  /health 200 OK, /metrics 200 ({len(text)} bytes)")
        proc.send_signal(signal.SIGTERM)
        rc = proc.wait(timeout=60)
        if rc != 0:
            raise AssertionError(f"server exited {rc} on SIGTERM")
        print("  server exited 0 on SIGTERM")
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


# ---- timing (phase 5) ---------------------------------------------------- #


def time_windows(fn, n_warm, n_timed):
    """ms per call of fn() from CUDA events around n_timed calls."""
    import torch

    for _ in range(n_warm):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n_timed):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n_timed


def bound_ms(k, b, width_out_bytes):
    """The least time for one window: every packed request row read once,
    one 32-byte sector per gathered and per scattered table row, the
    outputs and per-sub-batch counts written once, at the HBM rate.  The
    integer work (a few hundred operations per lane) is far below the
    card's rate, so bytes bound it."""
    moved = (
        k * b * 36  # packed request rows
        + k * 8  # now
        + 2 * k * b * SECTOR  # gathered and scattered table rows
        + k * b * width_out_bytes  # outputs
        + k * 8  # n_exp
    )
    return moved / HBM_BYTES_PER_S * 1e3


def timing_window(device, width, rng):
    """A certified (w32-tier) window at K x B over a full-size table of
    width `width`: (state, packed, now) on the card."""
    import numpy as np
    import torch

    from throttlecrab_tpu_torch.tpu import kernel
    from throttlecrab_tpu_torch.tpu.limiter import derive_params

    state = hostile_state(rng, CAPACITY + (1 << 16), CAPACITY, width, device)
    slots = rng.integers(0, CAPACITY, (K, B)).astype(np.int32)
    rank = np.zeros((K, B), np.int32)
    is_last = np.ones((K, B), bool)
    for j in range(K):
        rank[j], is_last[j], _ = segments(slots[j], np.ones(B, bool))
    kid = slots.astype(np.int64)
    em, tol, _ = derive_params(5 + kid % 60, 50 + kid % 1000, 30 + kid % 120)
    packed = torch.from_numpy(kernel.pack_requests(
        slots, rank, is_last, em, tol, np.ones((K, B), np.int64),
        np.ones((K, B), bool),
    )).to(device)
    now = torch.arange(K, dtype=torch.int64, device=device) * 1000 + T0
    return state, packed, now


def time_kernel(device, rng, rounds=3):
    """{width: (kernel ms, plain ms)} per w32 window, the medians of
    `rounds` rounds that alternate the widths."""
    import numpy as np

    from throttlecrab_tpu_torch.tpu import fused, kernel

    inputs = {w: timing_window(device, w, rng) for w in (4, 6)}
    samples = {w: ([], []) for w in inputs}
    for _ in range(rounds):
        for w, (state, packed, now) in inputs.items():
            for fn, n_warm, n_timed, out in (
                (fused.fused_window, 5, 50, samples[w][0]),
                (kernel.decide_window, 1, 3, samples[w][1]),
            ):
                out.append(time_windows(
                    lambda fn=fn, st=state, p=packed, n=now: fn(
                        st, p, n, with_degen=False, compact="w32"),
                    n_warm, n_timed,
                ))
    for w, (k_ms, p_ms) in samples.items():
        print(f"  W={w} rounds: kernel {[round(x, 4) for x in k_ms]} ms, "
              f"plain {[round(x, 2) for x in p_ms]} ms")
    return {
        w: (float(np.median(k_ms)), float(np.median(p_ms)))
        for w, (k_ms, p_ms) in samples.items()
    }


# ---- main ---------------------------------------------------------------- #


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False — this "
              "smoke test needs a CUDA card", file=sys.stderr)
        return 2
    import numpy as np

    from throttlecrab_tpu_torch.tpu import fused
    from throttlecrab_tpu_torch.tpu.limiter import TorchRateLimiter

    device = torch.device("cuda")
    card = card_line()
    print(f"[1] card: {card}")
    t = time.perf_counter()
    lib = fused.build()
    print(f"[1] built {lib.name} in {time.perf_counter() - t:.1f} s "
          "(0 when this checkout had built it already)")
    for line in ptxas_summary(lib.with_suffix(".log").read_text()):
        print(f"  ptxas: {line}")

    print(f"[2] kernel vs plain on the card: K={K} B={B} "
          f"N={CAPACITY + (1 << 16)}")
    worst = compare_kernel_plain(device, K, B, CAPACITY)

    print("[3] main path: TorchRateLimiter(capacity=2^20) on cuda, "
          "BASELINE config 3 traffic")
    rng = np.random.default_rng(3)
    n_windows, probe_window = 10, 9
    windows = config3_windows(rng, 1_000_000, n_windows, K, B, probe_window)
    limiter = TorchRateLimiter(capacity=CAPACITY)
    fused.LAUNCHES = 0
    got, seconds = run_main_path(limiter, windows)
    freed = limiter.sweep(windows[-1][-1][-1] + 3600 * NS)
    torch.cuda.synchronize()
    launches = fused.LAUNCHES
    if launches == 0:
        raise AssertionError("the main path never launched the kernel")
    if not limiter.table.state.is_cuda:
        raise AssertionError("the table left the card")
    decisions = sum(len(b[0]) for w in windows for b in w)
    steady = seconds[1:probe_window]
    steady_decisions = K * B * len(steady)
    rate = steady_decisions / sum(steady)
    lat = np.percentile(np.asarray(steady) * 1e3, [50, 99])
    print(f"  {decisions} decisions in {n_windows} windows, "
          f"{launches} kernel windows launched, sweep freed {freed}")
    print(f"  dispatch_many+fetch: {rate:.0f} decisions/s over "
          f"{len(steady)} steady windows of {K * B}; window latency "
          f"p50 {lat[0]:.2f} ms p99 {lat[1]:.2f} ms ({card})")
    ref = TorchRateLimiter(capacity=CAPACITY, device="cpu")
    want, _ = run_main_path(ref, windows)
    assert_same_results(got, want)
    if ref.sweep(windows[-1][-1][-1] + 3600 * NS) != freed:
        raise AssertionError("sweep freed counts differ")
    if not torch.equal(limiter.table.state[:CAPACITY].cpu(),
                       ref.table.state[:CAPACITY]):
        raise AssertionError("table state differs from the cpu replay")
    print("  identical to the device='cpu' replay (results, sweep, state)")

    print("[4] server on cuda")
    check_server()

    print(f"[5] times per window, K={K} B={B} w32 tier ({card})")
    times = time_kernel(device, np.random.default_rng(5))
    for width, (k_ms, p_ms) in times.items():
        print(f"  W={width}: kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms, "
              f"bound {bound_ms(K, B, 4):.4f} ms (medians)")

    print(f"card: {card_line()}")
    print(json.dumps({"kernels": [{
        "name": "fused_window",
        "route": "cuda",
        "source": "throttlecrab_tpu_torch/csrc/fused_window.cu",
        "replaces": "throttlecrab_tpu/tpu/pallas_fused.py:656",
        "launches": launches,
        "max_abs_err": worst,
        "ms": times[4][0],
        "plain_ms": times[4][1],
        "bound_ms": bound_ms(K, B, 4),
        "bound_by": "bytes",
        "library_ms": None,
        "identical": worst == 0,
        "shape": f"K={K} B={B} W=4 w32",
        "w6_ms": times[6][0],
        "w6_plain_ms": times[6][1],
        "main_path_decisions_per_s": rate,
        "card": card,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
