#!/usr/bin/env python3
"""Smoke test of the PyTorch/H100 port on one CUDA card.

    python3 chip_smoke.py

Fourteen phases, each printing its results; any failure raises and the
script exits nonzero without its last line:

1. card: the card's name and power limit (nvidia-smi), and the builds of
   the kernel libraries from csrc/ (one nvcc per source, started
   together, timed), with ptxas's registers/stack/spills per kernel;
2. kernel vs plain: the decision-window kernel (tpu/fused.py) against its
   plain torch version (tpu/kernel.py) on the card, at the serving N
   (2^20 + 2^16 rows) for all 12 kernel instantiations (row widths 4
   and 6 x six output tiers): at K = 16 sub-batches of B = 4096 on two
   consecutive hostile windows — duplicates, degenerate lanes, invalid
   lanes, edge-valued tolerances — then on cross-block windows at B =
   4096, 1, 4097 and 65536 (one slot over every lane of every sub-batch;
   one slot at lanes 0 and B-1 of every sub-batch).  Tolerance: exact
   equality (integer math) on valid-lane outputs, real-slot state,
   expired-hit counts and insight totals;
3. serving path at full size: TorchRateLimiter(capacity=2^20) on cuda
   under BASELINE config 3 traffic (1M keys, Zipf-1.1, batch 4096,
   per-key heterogeneous params) through dispatch_many(wire=True), K = 16
   batches per window, plus a window with quantity-0 probes (the exact
   path), then a sweep; the same traffic replayed on device="cpu" must
   give identical results and state, and the kernel's launch counter,
   zeroed just before, must have moved;
4. server: `python -m throttlecrab_tpu_torch.server` on cuda with the
   reference's `--buffer-size`, `--max-denied-keys 10`,
   `--drain-timeout-ms`, `--deadline-default-ms` and `--snapshot-path`,
   on `--http --redis` (asyncio transports), then with `--http-backend
   native --redis-backend native` (the C++ wire server).  Each boot
   answers 5 POST /throttle for one key (burst 3, 1 per hour) as allowed
   x3 (remaining 2, 1, 0) then denied x2; RESP PING -> +PONG, 5
   THROTTLE for another key -> :1 x3 (remaining 2, 1, 0) then :0 x2,
   QUIT -> +OK and a close; one key over both transports shares one
   bucket; /health and /metrics (which counts both transports' requests
   and lists both denied keys under throttlecrab_top_denied_keys)
   answer; the default flags build the launch supervisor (state ok) and
   the front tier (each key's second denial comes from the deny cache);
   2 of a third key's 3 are taken, and SIGTERM gives exit 0 and saves
   the snapshot.  A second boot on the same path, with `--faults
   launch:count:1`, answers that key's third request with remaining 0
   and denies its fourth, and its /metrics shows one supervisor retry
   and one injected launch fault.  The default server runs the insight
   tier (6-wide rows): after a poll, GET /stats counts the boot's 14
   requests (9 allowed, 5 denied, the deny cache's among them).  The
   native backend then boots with `--checkpoint-dir D
   --checkpoint-interval-ms 200`, exhausts a key, waits for two
   generations after it (/health carries the checkpoint age), is
   SIGKILLed and boots again on D: the key is still denied and /metrics
   counts one recovery.  Each backend also boots with `--control
   --control-tick-ms 100 --trace-dir D`: on asyncio, GET /control shows
   the plane enabled, ticking, with the default front and insight tiers'
   actuators, /metrics counts its ticks, and GET /trace/dump writes a
   ring dump; the native backend adds `--trace-mode full` and SIGTERM
   closes the trace; each file replays on cuda with ok through `python
   -m throttlecrab_tpu_torch.replay replay`;
5. row kernels vs plain: row_gather / row_scatter (tpu/row_ops.py)
   against index_select / index_copy_ at N = 2^21 + 2^16, B = 4096,
   W = 4 and 6, rows 0 and N-1 included.  Tolerance: exact equality;
6. by-id launch path at bench.py's shape: TorchRateLimiter(capacity=2^21,
   keymap="native") on cuda, 1M interned keys with config-3 per-key
   params, every key populated once, then Zipf-1.1 windows of K = 64 x
   B = 4096 through check_many_byid (host words + finish_ids),
   check_many_ids (finish_raw) and check_many_ids20 (w32 + finish_w32);
   the counters, zeroed just before, must count exactly one
   decision-window launch per window and no row-kernel launch, and the
   same traffic on device="cpu" must give identical wire values,
   real-slot state and expired hits.  Then one more ids window through
   the composed scan kernel.gcra_scan_ids_acc on a copy of the table,
   whose rows move through the row kernels (their counters, zeroed just
   before, must count K each), must decide as the table's route; and one
   ids window under the profiler (kernel records, device ms, idle share,
   the largest records by name);
7. dispatch_wire_window: phase 3's traffic as native wire frames through
   TorchRateLimiter(keymap="native") on cuda, against its device="cpu"
   replay; the decision-window kernel's counter, zeroed just before, must
   have moved;
8. times, beside the card's name and power limit: the decision-window
   kernel's and its plain version's time per window at K=16, B=4096,
   W=4 and W=6 in the w32 tier (CUDA events, the profiler's device time
   and its kernel records per call, which must all be the window kernel
   and at most one per call, and the wrapper's host time per call), and
   each row kernel's, its plain version's and the library call's time
   per launch at B=4096 (CUDA events, profiler, host time per call);
   phases 3, 6 and 7's decisions/s come from the host clock;
9. native RESP server at full width: a NativeRedisTransport in process
   over TorchRateLimiter(capacity=2^20, keymap="native") on cuda, batch
   4096, max_scan_depth 16, answers phase 3's traffic (1M keys,
   Zipf-1.1, per-key params, quantity 1; 10 windows' worth, 655,360
   THROTTLE commands) pipelined over 8 connections by client
   subprocesses, then a further 2 windows' worth under the profiler.  A
   recording subclass keeps every window's frames, cookies, timestamp
   and fetched results in dispatch order; every command must get a *5
   reply, each connection's bytes must equal what a device="cpu"
   replay of the recorded windows gives its requests, the table state
   the replay's, and the counters (zeroed just before) must show one
   decision-window launch per window, every window on the
   dispatch_wire_window route.  Prints replies/s on the clients' clock,
   decisions per launch, the driver's median ms per window and seconds
   over the run for each part (wait in ws_next_batch, capture,
   dispatch_wire_window, fetch, ws_respond) and its busy share,
   phase 7's in-process rate, and the profiled stretch's device time and
   idle share;
10. snapshot at full size, with the python keymap and then the native
   one: TorchRateLimiter(capacity=2^20) on cuda holds all 1M config-3
   keys and decides one phase-3 window; save_snapshot gathers the live
   rows with row_gather (the counter, zeroed just before, must read
   ceil(1M / 65,536) = 16) and load_snapshot into a fresh cuda limiter
   scatters them with row_scatter (16); a device="cpu" limiter loads the
   same file.  Per-key tat/expiry of the original and both restores, and
   the restores' certificates, must be equal; the row kernels at B =
   65,536 equal their plain versions; the next phase-3 window decides
   identically on the original and the cuda restore.  Prints the
   export / gather / write / load / scatter ms (host clock), then each
   row kernel's, its plain version's and the library call's time per
   launch at B = 65,536, W = 4 and 6, beside the bound;
11. failure domain and front tier at full width.  (a) A SupervisedLimiter
   (3 retries, probe every 1,000 ms) over TorchRateLimiter(capacity=2^20)
   on cuda holding all 1M config-3 keys decides 10 config-3 windows
   (K=16 x B=4096, one timestamp per window, as the server stamps
   one) through dispatch_many: 2 clean; one under
   `launch:count:2` and one under `fetch:count:1`, both absorbed (state
   ok); one under `launch:persistent`, which degrades to the host oracle
   (the row_gather counter, zeroed just before, must read
   ceil(1M / 65,536) = 16); 2 from the oracle (the window-kernel counter
   must not move); then, healed and past the probe interval, one window
   whose recovery makes exactly one probe window launch and re-promotes
   the host-mutated keys with ceil(mutated / 65,536) row_scatter
   launches (both read at the front tier's on_restore hook); then 2 on
   the card.  Every wire field of every window, and each key's
   tat/expiry from export_state (both lapsed, or equal), must equal an
   uninterrupted, unsupervised device="cpu" run of the same traffic.  A
   ring-mode flight recorder is armed over the drill (each sub-batch
   captured): the degrade records its event and writes its dump, which
   holds the injections of launch:count:2 and fetch:count:1 in firing
   order and replays on a host oracle seeded with the populated table
   with 0 mismatches against its recorded outcomes; the recovery records
   its event.
   Prints retries, the ms in each state, the degrade's export and seed
   ms, the oracle's decisions/s and the re-promotion's ms.  (b) Phase
   9's harness over a FrontTier with the default knobs (deny cache
   65,536, admission at 100,000 pending): 98,304 config-3 THROTTLEs
   pipelined over 8 connections (fewer than the admission bound, so
   nothing may be shed); every connection's bytes and the table state
   must equal a no-front device="cpu" replay of the captured batches in
   dispatch order, the deny cache must serve hits, and window launches
   must not exceed windows.  The same commands also run twice through
   the same harness without a front tier, alternating with the two
   front runs (off, on, off, on), each run on a fresh limiter and
   checked the same way.  Prints the hits and the replies/s of every
   run, with and without the front, beside phase 9's;
12. insight tier at full width: TorchRateLimiter(capacity=2^20,
   keymap="native", insight=True) on cuda holding the 1M config-3 keys,
   a default FrontTier and an InsightTier at its defaults (top-K 64,
   sketch 4,096, prewarm 64, hot at 100 denials); 10 config-3 windows
   (K=16 x B=4096, one timestamp per window, 1.001 s apart) through
   dispatch_wire_window, each window's rows observed into the deny
   cache, a poll after each, one decay.  Every wire field and cur value,
   the insight totals, each poll's top-K (ids in order), the sketch,
   stats_json, metric_stats, the prewarmed keys, the concentration and
   the deny cache's order must equal a device="cpu" run; the window
   counter, zeroed just before, must read 10; no poll may fail.  Prints
   the poll's ms split (totals fetch, top-K, slot->key resolve), the
   decay's ms, and dispatch_wire_window decisions/s on the W=6 table and
   a W=4 one, alternately;
13. checkpoint and recovery at 1M keys: a Checkpointer over phase 12's
   limiter writes a base, then a delta after each 3 windows (twice),
   under a lock as the serving drivers hold it; each generation must
   launch row_gather ceil(live / 65,536) times.  recover_into a fresh
   cuda limiter (row_scatter ceil(restored / 65,536) times) and a cpu
   one: per-key tat/expiry equal the source's live rows, certificates
   equal, and the next window decides identically on all three.  Then a
   delta torn by `snapshot:truncate`: recovery falls back exactly one
   generation.  Prints per generation the export (under the lock),
   encode, write and fsync ms and the bytes, and the recovery ms;
14. record, replay and control at full width: phase 9's 655,360 config-3
   THROTTLEs (a fresh Zipf draw) through phase 9's in-process
   NativeRedisTransport over TorchRateLimiter(capacity=2^20,
   keymap="native", insight=True) on cuda, empty at the start, with the
   default server's FrontTier and InsightTier, a full-mode
   FlightRecorder and a ControlPlane (mode both, 100 ms ticks) armed.
   The recorder must count 0 capture errors, the trace's rows must equal
   the commands sent, every tick must take its snapshot, and every
   actuation must lie in its bounds and step.  The trace is replayed
   with differential_replay on a make_target("device", capacity=2^20)
   on cuda: 0 mismatches against the oracle and the recording, one
   window-kernel launch per window (counter zeroed just before), an
   outcome vector equal to a device="cpu" replay's, and each key's
   tat/expiry equal to the live limiter's (both lapsed, or equal).  The
   offline policy search then ranks default_candidates() on the trace,
   one candidate per worker process, after the replays were timed, so
   nothing else runs beside them.  Prints replies/s with the
   recorder and the plane armed beside phase 9's, the trace's bytes,
   the ignored statuses, replay decisions/s on cuda, cpu and the oracle,
   ticks, actuations, ms per tick and the top three policies.

The line before the last is the {"kernels": [...]} record; the last line
is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import functools
import json
import multiprocessing
import os
import re
import signal
import socket
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request
from concurrent.futures import ProcessPoolExecutor

NS = 1_000_000_000
T0 = 1_753_700_000 * NS
HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3, NVIDIA data sheet
SECTOR = 32  # bytes the memory system moves for one scattered row
K, B = 16, 4096  # the serving window: max_scan_depth x batch_size
CAPACITY = 1 << 20
BYID_K = 64  # bench.py's by-id depth off the TPU
BYID_CAPACITY = 1 << 21
N_KEYS = 1_000_000
TIERS = [(False, True), (True, True), (False, False), (True, False),
         ("cur", False), ("w32", False)]
CROSS_BLOCK_B = (4096, 1, 4097, 65536)  # batch widths of the cross-block windows
REGISTERS_PER_SM = 65536
FUSED_THREADS = 256  # threads per block of the decision-window kernel


def ptxas_summary(log: str) -> dict:
    """{kernel instantiation: (registers, stack bytes, spill store bytes,
    spill load bytes)} from nvcc's -Xptxas -v report."""
    kernels, name, frame = {}, None, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            mangled = m.group(1)
            d = re.search(r"window_kernelILi(\d)ELb(\d)ELi(\d)E", mangled)
            s = re.search(r"(scatter|gather)_kernelILi(\d)E", mangled)
            tier = ("False", "True", "cur", "w32")
            name = (
                f"window W={d.group(1)} with_degen={d.group(2) == '1'} "
                f"tier={tier[int(d.group(3))]}" if d
                else f"{s.group(1)} W={s.group(2)}" if s else mangled
            )
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m and name:
            frame = tuple(int(x) for x in m.groups())
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            kernels[name] = (int(m.group(1)),) + frame
            name = None
    return dict(sorted(kernels.items()))


def check_ptxas(name, kernels, threads):
    """Print each instantiation's report; fail on a stack frame, a spill,
    or more registers than `threads` threads can hold on one SM."""
    bad = []
    for kname, (regs, stack, st, ld) in kernels.items():
        print(f"  ptxas {name}: {kname}: {regs} registers, stack {stack} B, "
              f"spill stores {st} B, spill loads {ld} B")
        if stack or st or ld or regs * threads > REGISTERS_PER_SM:
            bad.append(kname)
    if bad:
        raise AssertionError(f"{name}: stack, spills or more registers "
                             f"than {threads} threads fit in {bad}")


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


def hostile_window(rng, k, b, cap, degen, slots=None):
    """(packed i32[k, b, 9], now i64[k], valid bool[k, b]): half the lanes
    on a hot set of 512 slots (long duplicate segments), or `slots`
    i32[k, b] when given; degenerate params when `degen`, 10 % invalid
    lanes, edge-valued tolerances."""
    import numpy as np

    from throttlecrab_tpu_torch.tpu.kernel import pack_requests

    if slots is None:
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


def cross_block_windows(rng, k, b, cap, degen):
    """Two windows whose duplicate segments span the kernel's blocks:
    every lane of every sub-batch on one slot, and one slot at lanes 0
    and b-1 of every sub-batch (the other lanes elsewhere)."""
    import numpy as np

    hot = int(rng.integers(0, cap))
    edge = rng.integers(0, cap, (k, b))
    edge[edge == hot] = (hot + 1) % cap
    edge[:, 0] = edge[:, -1] = hot
    return [hostile_window(rng, k, b, cap, degen, slots=s.astype(np.int32))
            for s in (np.full((k, b), hot), edge)]


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


def compare_kernel_plain(device, k, b, cap, seed=0, cross=False):
    """Phase 2 at one (k, b): two hostile windows, or the cross-block
    windows when `cross`; returns the largest valid-lane output
    difference."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    n_rows = cap + (1 << 16)
    windows = {
        degen: cross_block_windows(rng, k, b, cap, degen) if cross else
        [hostile_window(rng, k, b, cap, degen) for _ in range(2)]
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
            print(f"  identical: B={b} {'cross-block ' if cross else ''}"
                  f"width={width} compact={compact!r} "
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


def resp_frame(*parts) -> bytes:
    out = b"*%d\r\n" % len(parts)
    for part in parts:
        data = part.encode()
        out += b"$%d\r\n%s\r\n" % (len(data), data)
    return out


def resp_reply(sock) -> bytes:
    """One RESP reply (a line, or a *5 array of integer lines)."""
    data = b""
    while not data.endswith(b"\r\n") or (
        data.startswith(b"*5") and data.count(b"\r\n") < 6
    ):
        chunk = sock.recv(4096)
        if not chunk:
            break
        data += chunk
    return data


def throttle_body(key, burst):
    return json.dumps({"key": key, "max_burst": burst,
                       "count_per_period": 1, "period": 3600}).encode()


def boot_server(backend, extra=()):
    """Start `python -m throttlecrab_tpu_torch.server` on cuda with HTTP
    and RESP on `backend` ("python" or "native") plus `extra` flags, and
    wait for /health; returns (process, http port, redis port)."""
    http_port, redis_port = free_port(), free_port()
    proc = subprocess.Popen(
        [sys.executable, "-m", "throttlecrab_tpu_torch.server", "--http",
         "--http-host", "127.0.0.1", "--http-port", str(http_port),
         "--http-backend", backend, "--redis", "--redis-host", "127.0.0.1",
         "--redis-port", str(redis_port), "--redis-backend", backend,
         *extra],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    )
    deadline = time.monotonic() + 180
    while True:
        if proc.poll() is not None:
            raise AssertionError(
                f"server exited {proc.returncode}:\n{proc.stdout.read()}"
            )
        try:
            status, body = http(http_port, "GET", "/health", timeout=2)
            # "OK", or "OK checkpoint_age_s=..." with checkpoints armed.
            if status == 200 and body.split(b" ")[0] == b"OK":
                return proc, http_port, redis_port
        except OSError:
            pass
        if time.monotonic() > deadline:
            proc.kill()
            raise AssertionError("server did not come up in 180 s")
        time.sleep(0.25)


def stop_server(proc) -> str:
    """SIGTERM; the server must exit 0.  Returns its log."""
    proc.send_signal(signal.SIGTERM)
    out, _ = proc.communicate(timeout=60)
    if proc.returncode != 0:
        raise AssertionError(f"server exited {proc.returncode} on SIGTERM:"
                             f"\n{out}")
    return out


def wait_metrics(http_port, want):
    """/metrics once it holds every line of `want` (the native /metrics is
    a snapshot pushed once a second)."""
    deadline = time.monotonic() + 10
    while True:
        status, text = http(http_port, "GET", "/metrics")
        if status == 200 and all(w in text for w in want):
            return text
        if time.monotonic() > deadline:
            raise AssertionError(f"/metrics lacks {want}:\n{text.decode()}")
        time.sleep(0.25)


# The reference server's flags the port serves since it closed fault C1.
SERVER_FLAGS = ("--buffer-size", "1000", "--max-denied-keys", "10",
                "--drain-timeout-ms", "5000", "--deadline-default-ms",
                "60000")


def check_server(backend, snapshot_path):
    """Phase 4, on `backend` ("python" or "native"): one boot with both
    transports, the reference's flags and `--snapshot-path`; then a
    second boot on the same path, which must continue the first's
    buckets."""
    extra = SERVER_FLAGS + ("--snapshot-path", snapshot_path)
    proc, http_port, redis_port = boot_server(backend, extra)
    try:
        answers = [json.loads(http(http_port, "POST", "/throttle",
                                   throttle_body("smoke:1", 3))[1])
                   for _ in range(5)]
        print(f"  HTTP: {answers[0]} ... {answers[-1]}")
        allowed = [a["allowed"] for a in answers]
        remaining = [a["remaining"] for a in answers]
        if allowed != [True, True, True, False, False] or (
            remaining[:3] != [2, 1, 0]
        ):
            raise AssertionError(f"unexpected answers {answers}")
        with socket.create_connection(("127.0.0.1", redis_port), 30) as sock:
            def resp(*parts):
                sock.sendall(resp_frame(*parts))
                return resp_reply(sock)

            if resp("PING") != b"+PONG\r\n":
                raise AssertionError("PING did not answer +PONG")
            replies = [resp("THROTTLE", "smoke:r", "3", "1", "3600")
                       for _ in range(5)]
            print(f"  RESP: {replies[0]!r} ... {replies[-1]!r}")
            heads = [r.split(b"\r\n")[1] for r in replies]
            rem = [r.split(b"\r\n")[3] for r in replies[:3]]
            if heads != [b":1"] * 3 + [b":0"] * 2 or rem != [
                b":2", b":1", b":0"
            ]:
                raise AssertionError(f"unexpected RESP answers {replies}")
            # One key over both transports: one bucket of burst 2.
            shared = [
                resp("THROTTLE", "smoke:both", "2", "1", "3600")[:8],
                json.loads(http(http_port, "POST", "/throttle",
                                throttle_body("smoke:both", 2))[1]
                           )["allowed"],
                resp("THROTTLE", "smoke:both", "2", "1", "3600")[:8],
            ]
            if shared != [b"*5\r\n:1\r\n", True, b"*5\r\n:0\r\n"]:
                raise AssertionError(f"transports do not share a bucket: "
                                     f"{shared}")
            if resp("QUIT") != b"+OK\r\n" or sock.recv(16) != b"":
                raise AssertionError("QUIT did not answer +OK and close")
        print("  RESP PING/THROTTLE/QUIT as expected; one key shares one "
              "bucket over RESP and HTTP")
        text = wait_metrics(http_port, (
            b'transport="http"} 6', b'transport="redis"} 7',
            b"throttlecrab_requests_allowed 8",
            b'throttlecrab_top_denied_keys{key="smoke:1",rank=',
            b'throttlecrab_top_denied_keys{key="smoke:r",rank=',
        ))
        top = [line for line in text.decode().splitlines()
               if line.startswith("throttlecrab_top_denied_keys{")]
        print(f"  /health 200 OK, /metrics 200 ({len(text)} bytes, counts "
              f"both transports; top denied {top})")
        # Default flags build the supervisor and the front tier: each
        # key's second denial is served from the deny cache.
        hits = re.search(rb"throttlecrab_tpu_front_deny_hits (\d+)", text)
        if (b"throttlecrab_tpu_engine_state 0" not in text or hits is None
                or int(hits.group(1)) < 1):
            raise AssertionError("default flags built no supervisor or no "
                                 f"deny cache:\n{text.decode()}")
        print(f"  supervisor state ok, deny-cache hits {int(hits.group(1))}")
        check_stats(http_port)
        snap = [json.loads(http(http_port, "POST", "/throttle",
                                throttle_body("smoke:snap", 3))[1])
                for _ in range(2)]
        if [a["remaining"] for a in snap] != [2, 1]:
            raise AssertionError(f"unexpected answers {snap}")
        log = stop_server(proc)
        if "saved" not in log:
            raise AssertionError(f"no snapshot saved on SIGTERM:\n{log}")
        print("  server exited 0 on SIGTERM and saved its snapshot: "
              + next(line for line in log.splitlines() if "saved" in line))
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    # The second boot also arms one injected launch fault: the supervisor
    # absorbs it with one retry and the answers do not change.
    proc, http_port, _ = boot_server(
        backend, extra + ("--faults", "launch:count:1"))
    try:
        after = [json.loads(http(http_port, "POST", "/throttle",
                                 throttle_body("smoke:snap", 3))[1])
                 for _ in range(2)]
        if [(a["allowed"], a["remaining"]) for a in after] != [
            (True, 0), (False, 0)
        ]:
            raise AssertionError(f"the second boot did not continue the "
                                 f"snapshot's bucket: {after}")
        wait_metrics(http_port, (
            b"throttlecrab_tpu_supervisor_retries 1",
            b'throttlecrab_tpu_faults_injected_total{site="launch"} 1',
            b"throttlecrab_tpu_engine_state 0",
        ))
        print("  --faults launch:count:1: answers unchanged, /metrics shows "
              "1 supervisor retry and 1 injected launch fault")
        log = stop_server(proc)
        print("  second boot on the snapshot: the key's third request "
              "answered remaining 0, its fourth denied; "
              + next(line for line in log.splitlines() if "restored" in line))
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


def check_stats(http_port):
    """The default server runs the insight tier: once a poll has run
    after the last of the 13 requests above (its cadence is 1 s), GET
    /stats counts them all — 8 allowed, 5 denied (the deny cache's hits
    among them) — plus one more allowed request sent to drive that
    poll."""
    time.sleep(1.1)
    status, _ = http(http_port, "POST", "/throttle",
                     throttle_body("smoke:stats", 3))
    deadline = time.monotonic() + 10
    while True:
        status, body = http(http_port, "GET", "/stats")
        doc = json.loads(body) if status == 200 and body else {}
        if doc.get("totals", {}).get("allowed") == 9:
            break
        if time.monotonic() > deadline:
            raise AssertionError(f"/stats never counted the requests: {doc}")
        time.sleep(0.25)
    top = {d["key"] for d in doc["top_denied"]}
    if (doc["totals"] != {"allowed": 9, "denied": 5,
                          "deny_rate": round(5 / 14, 6)}
            or doc["insight"]["poll_failures"] != 0
            or not {"smoke:1", "smoke:r"} <= top
            or doc["front_path"]["denied"] < 1):
        raise AssertionError(f"unexpected /stats: {doc}")
    print(f"  /stats: totals {doc['totals']}, deny-cache denials "
          f"{doc['front_path']['denied']}, top denied "
          f"{sorted(top)}, polls {doc['insight']['polls']}, 0 poll failures")


def metric_value(http_port, name):
    text = http(http_port, "GET", "/metrics")[1].decode()
    for line in text.splitlines():
        if line.startswith(name + " "):
            return float(line.split()[1])
    raise AssertionError(f"/metrics has no {name}")


def check_checkpoint_restart(backend, ckdir):
    """Phase 4's crash drill: boot with `--checkpoint-dir` and a 200 ms
    interval, exhaust a key, wait until two generations follow it (at
    least two intervals; /health carries the checkpoint suffix), SIGKILL
    the server and boot it again on the same directory: the key must
    still be denied and the boot must count one recovery."""
    flags = ("--checkpoint-dir", ckdir, "--checkpoint-interval-ms", "200")
    gen = "throttlecrab_tpu_checkpoint_generation"
    proc, http_port, _ = boot_server(backend, flags)
    try:
        answers = [json.loads(http(http_port, "POST", "/throttle",
                                   throttle_body("smoke:kill", 2))[1]
                              )["allowed"] for _ in range(3)]
        if answers != [True, True, False]:
            raise AssertionError(f"unexpected answers {answers}")
        g0 = metric_value(http_port, gen)
        t0 = time.monotonic()
        i = 0
        while metric_value(http_port, gen) < g0 + 2:
            if time.monotonic() - t0 > 30:
                raise AssertionError("checkpoint generations stalled")
            # Each window drives the throttled tick.
            http(http_port, "POST", "/throttle",
                 throttle_body(f"smoke:tick{i}", 2))
            i += 1
            time.sleep(0.25)
        waited = time.monotonic() - t0
        health = http(http_port, "GET", "/health")[1]
        if not health.startswith(b"OK checkpoint_age_s="):
            raise AssertionError(f"/health lacks the suffix: {health}")
        proc.send_signal(signal.SIGKILL)
        proc.wait(timeout=30)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    proc, http_port, _ = boot_server(backend, flags)
    try:
        after = json.loads(http(http_port, "POST", "/throttle",
                                throttle_body("smoke:kill", 2))[1])
        if after["allowed"]:
            raise AssertionError(f"the key was allowed after the SIGKILL "
                                 f"restart: {after}")
        wait_metrics(http_port,
                     (b"throttlecrab_tpu_checkpoint_recoveries_total 1",))
        print(f"  --checkpoint-dir, 200 ms: {waited:.2f} s to 2 generations "
              f"past the exhausted key, /health {health.decode()!r}; "
              "SIGKILL and reboot on the chain: the key is still denied, "
              "1 recovery")
        stop_server(proc)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


# The control plane's actuators over the default front and insight tiers.
CONTROL_ACTUATORS = {"admission.hot_shed_weight", "admission.max_pending",
                     "deny_cache.capacity", "insight.poll_ns",
                     "insight.prewarm"}


def replay_cli(path):
    """`python -m throttlecrab_tpu_torch.replay replay PATH` on cuda: its
    JSON summary, which must be ok (exit 0)."""
    r = subprocess.run(
        [sys.executable, "-m", "throttlecrab_tpu_torch.replay", "replay",
         path], capture_output=True, text=True, timeout=300)
    doc = json.loads(r.stdout.strip().splitlines()[-1]) if r.stdout else {}
    if r.returncode != 0 or not doc.get("ok") or doc.get("device") != "cuda":
        raise AssertionError(f"replay of {path} exited {r.returncode}: "
                             f"{r.stdout}{r.stderr[-3000:]}")
    return doc


def check_control_trace(backend, trace_dir):
    """Phase 4's record/replay and control boot on `backend`: `--control
    --control-tick-ms 100 --trace-dir D` (and `--trace-mode full` on the
    native backend, whose HTTP answers neither /control nor /trace/dump).
    Asyncio: GET /control shows the plane ticking with the default
    tiers' actuators, /metrics counts its ticks, and GET /trace/dump
    writes a ring dump; native: SIGTERM closes the full-mode trace.
    Either file must replay on cuda through the replay CLI."""
    t_boot = time.perf_counter()
    flags = ("--control", "--control-tick-ms", "100", "--trace-dir",
             trace_dir)
    if backend == "native":
        flags += ("--trace-mode", "full")
    proc, http_port, redis_port = boot_server(backend, flags)
    try:
        for i in range(4):
            http(http_port, "POST", "/throttle", throttle_body("smoke:c", 3))
            time.sleep(0.15)
        with socket.create_connection(("127.0.0.1", redis_port), 30) as sock:
            for _ in range(3):
                sock.sendall(resp_frame("THROTTLE", "smoke:c", "3", "1",
                                        "3600"))
                resp_reply(sock)
        if backend == "python":
            doc = json.loads(http(http_port, "GET", "/control")[1])
            ctl = doc["control"]
            if (not ctl["enabled"] or ctl["ticks"] < 1
                    or not CONTROL_ACTUATORS <= set(doc["actuators"])):
                raise AssertionError(f"unexpected /control: {doc}")
            ticks = metric_value(http_port, "throttlecrab_tpu_control_ticks")
            if ticks < 1:
                raise AssertionError("/metrics counts no control tick")
            dump = json.loads(http(http_port, "GET", "/trace/dump")[1])
            if not dump["enabled"] or dump["windows"] < 1:
                raise AssertionError(f"unexpected /trace/dump: {dump}")
            path = dump["path"]
            print(f"  --control --control-tick-ms 100: GET /control enabled, "
                  f"{ctl['ticks']} ticks, actuators "
                  f"{sorted(doc['actuators'])}; /metrics control ticks "
                  f"{ticks:.0f}; GET /trace/dump wrote {dump['windows']} "
                  "windows")
        stop_server(proc)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    if backend == "native":
        path = os.path.join(trace_dir, f"trace-{proc.pid}.tctr")
    doc = replay_cli(path)
    # 7 requests for one key of burst 3: the asyncio engine answers the
    # last 3 (denials the deny cache certified) before a window, so its
    # windows hold 4 rows; the native drivers capture every row.
    want = 4 if backend == "python" else 7
    if doc["rows"] != want:
        raise AssertionError(f"the trace holds {doc['rows']} rows, "
                             f"expected {want}")
    what = "the ring dump" if backend == "python" else \
        "the full-mode trace SIGTERM closed"
    print(f"  {what} replays on cuda through the replay CLI: {doc}; boot, "
          f"requests, SIGTERM and replay {time.perf_counter() - t_boot:.1f} s")


# ---- timing (phase 8) ---------------------------------------------------- #


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


def profile_device(fn, n=1, detail=False):
    """(wall ms, device ms, {kernel name: device ms}, kernels) per call of
    fn() over `n` calls, from torch.profiler's CUDA kernel records (every
    kernel the calls launched, ctypes-launched ones included), recorded
    in the step after a warm-up step of `n` calls; device ms is None when
    the profiler records no kernel on this machine.  With `detail`, also
    {kernel name: records} and the number of kernel-launch API records."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1,
                                   repeat=1)) as prof:
        for _ in range(n):  # warm-up step: traced, not recorded
            fn()
        torch.cuda.synchronize()
        prof.step()
        t = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t) * 1e3 / n
        prof.step()
    events = prof.events()
    # The schedule's step annotation also shows on the device timeline.
    kernels = [e for e in events if e.device_type == DeviceType.CUDA
               and not e.name.startswith("ProfilerStep")]
    by_name, counts = {}, {}
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.device_time_total
        counts[e.name] = counts.get(e.name, 0) + 1
    api = sum(1 for e in events if "LaunchKernel" in e.name
              and e.device_type != DeviceType.CUDA)
    result = (
        wall,
        sum(by_name.values()) / n / 1e3 if kernels else None,
        {k: v / n / 1e3 for k, v in by_name.items()},
        len(kernels) / n,
    )
    return result + (counts, api) if detail else result


def bound_ms(k, b, width_out_bytes, rows):
    """The least time for one window: every packed request row read once,
    one 32-byte sector read and one written for each of the `rows`
    distinct table rows the window touches (counted from the run's
    slots), the outputs and per-sub-batch counts written once, at the HBM
    rate.  The integer work (a few hundred operations per lane) is far
    below the card's rate, so bytes bound it."""
    moved = (
        k * b * 36  # packed request rows
        + k * 8  # now
        + 2 * rows * SECTOR  # table rows, read and written once each
        + k * b * width_out_bytes  # outputs
        + k * 8  # n_exp
    )
    return moved / HBM_BYTES_PER_S * 1e3


def byid_bound_ms(ids, width_out_bytes):
    """The least time for one by-id window of raw ids i32[K, B]: the ids
    read once, one 32-byte sector for each distinct valid id's resident
    id row, one sector read and one written for its table row (one slot
    per interned id), the outputs and per-sub-batch counts written once,
    at the HBM rate.  The packed rows are the front end's intermediate,
    not the function's input, so they are not counted."""
    import numpy as np

    k, b = ids.shape
    distinct = int(np.unique(ids[ids >= 0]).size)
    moved = (
        k * b * 4  # ids
        + k * 8  # now
        + 3 * distinct * SECTOR  # id rows read; table rows read, written
        + k * b * width_out_bytes  # outputs
        + k * 8  # n_exp
    )
    return moved / HBM_BYTES_PER_S * 1e3, distinct


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


def host_us_per_call(fn, n=200):
    """µs of host time per fn() call, back to back, before the device is
    waited for (the wrapper's own cost when the device keeps up)."""
    import torch

    fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(n):
        fn()
    host = (time.perf_counter() - t) / n * 1e6
    torch.cuda.synchronize()
    return host


def time_kernel(device, rng, rounds=3):
    """{width: {"ms", "plain_ms", "device_ms", "plain_device_ms",
    "kernels_per_call", "host_us"}} per w32 window: CUDA-event medians of
    `rounds` rounds that alternate the widths, then the profiler's device
    time and kernel count per call, then the wrapper's host time."""
    import numpy as np

    from throttlecrab_tpu_torch.tpu import fused, kernel

    inputs = {w: timing_window(device, w, rng) for w in (4, 6)}
    calls = {
        w: {side: (lambda fn=fn, st=state, p=packed, n=now: fn(
            st, p, n, with_degen=False, compact="w32"))
            for side, fn in (("kernel", fused.fused_window),
                             ("plain", kernel.decide_window))}
        for w, (state, packed, now) in inputs.items()
    }
    samples = {w: ([], []) for w in inputs}
    for _ in range(rounds):
        for w, call in calls.items():
            samples[w][0].append(time_windows(call["kernel"], 5, 50))
            samples[w][1].append(time_windows(call["plain"], 1, 3))
    for w, (k_ms, p_ms) in samples.items():
        print(f"  W={w} rounds: kernel {[round(x, 4) for x in k_ms]} ms, "
              f"plain {[round(x, 2) for x in p_ms]} ms")
    result = {}
    for w, call in calls.items():
        n = 20
        _, k_dev, _, k_count, names, api = profile_device(
            call["kernel"], n, detail=True)
        p_dev = profile_device(call["plain"], 2)[1]
        print(f"  W={w} profiler: {n} fused_window calls, kernel records "
              f"{names}, {api} kernel-launch API records")
        # Every record must be the window kernel (no fill, no second
        # kernel) and there may be no more than one per call.  The
        # profiler can drop records late in a long run, so fewer than
        # one per call is reported, not failed.
        if k_dev is not None and (
            len(names) != 1 or "window_kernel" not in next(iter(names))
            or k_count > 1 or api > n
        ):
            raise AssertionError(f"fused_window W={w}: kernel records "
                                 f"{names}, {api} launch records for {n} "
                                 "calls; expected the window kernel once "
                                 "per call")
        result[w] = {
            "ms": float(np.median(samples[w][0])),
            "plain_ms": float(np.median(samples[w][1])),
            "device_ms": k_dev,
            "plain_device_ms": p_dev,
            "kernels_per_call": k_count if k_dev is not None else None,
            "launch_api_per_call": api / n,
            "host_us": host_us_per_call(call["kernel"]),
            "rows": int(inputs[w][1][..., 0].unique().numel()),
        }
    return result


def time_row_kernels(device, rng, b=B, n=BYID_CAPACITY + (1 << 16),
                     rounds=3):
    """{(name, W): {"kernel"|"plain"|"library": ms, "device_"...: ms,
    "host_us_"...: µs}} per launch of `b` rows over a table of `n` rows
    (phase 8: B=4096 over the by-id table; phase 10: the snapshot's
    65,536 over the serving table): CUDA-event medians of `rounds` rounds that
    alternate kernel, plain version and library call, then the
    profiler's device time, then the host time per call of the kernel's
    wrapper and of the library call.  Each call takes the next of 8 index
    sets, so consecutive launches do not find each other's rows in L2."""
    import itertools

    import numpy as np

    from throttlecrab_tpu_torch.tpu import row_ops

    samples = {}
    for w in (4, 6):
        table, _, rows = row_case(rng, n, b, w, device)
        idxs = [row_case_idx(rng, n, b, device) for _ in range(8)]
        longs = [i.long() for i in idxs]
        nxt = itertools.cycle(range(8)).__next__
        fns = {
            ("row_gather", "kernel"): lambda: row_ops.row_gather(
                table, idxs[nxt()]),
            ("row_gather", "plain"): lambda: row_ops.row_gather_plain(
                table, idxs[nxt()]),
            ("row_gather", "library"): lambda: table.index_select(
                0, longs[nxt()]),
            ("row_scatter", "kernel"): lambda: row_ops.row_scatter(
                table, idxs[nxt()], rows),
            ("row_scatter", "plain"): lambda: row_ops.row_scatter_plain(
                table, idxs[nxt()], rows),
            ("row_scatter", "library"): lambda: table.index_copy_(
                0, longs[nxt()], rows),
        }
        for _ in range(rounds):
            for (name, side), fn in fns.items():
                samples.setdefault((name, w), {}).setdefault(
                    side, []).append(time_windows(fn, 10, 200))
        for (name, side), fn in fns.items():
            samples[(name, w)].setdefault(
                "device_" + side, []).append(profile_device(fn, 100)[1])
        for (name, side), fn in fns.items():
            if side != "plain":
                samples[(name, w)]["host_us_" + side] = [host_us_per_call(fn)]
    for (name, w), by_side in samples.items():
        print(f"  {name} W={w} rounds (ms per launch): " + ", ".join(
            f"{side} {[x if x is None else round(x, 5) for x in v]}"
            for side, v in
            by_side.items()))
    return {
        key: {side: None if None in v else float(np.median(v))
              for side, v in by_side.items()}
        for key, by_side in samples.items()
    }


def row_bound_ms(b, w):
    """The least time for one row launch: per row one 32-byte table
    sector, the 4-byte index and the 4W-byte row on the dense side, at
    the HBM rate (the same for gather and scatter)."""
    return b * (SECTOR + 4 + 4 * w) / HBM_BYTES_PER_S * 1e3


# ---- row kernels vs plain (phase 5) --------------------------------------- #


def row_case_idx(rng, n, b, device):
    """`b` unique row indices in [0, n), rows 0 and n-1 among them."""
    import numpy as np
    import torch

    idx = rng.choice(n, b, replace=False).astype(np.int32)
    if 0 not in idx:
        idx[0] = 0
    if n - 1 not in idx:
        idx[1] = n - 1
    return torch.from_numpy(idx).to(device)


def row_case(rng, n, b, w, device):
    """(table i32[n, w], idx i32[b] unique, rows i32[b, w]) on `device`."""
    import numpy as np
    import torch

    i32 = (-(1 << 31), (1 << 31) - 1)
    table = torch.from_numpy(
        rng.integers(*i32, (n, w)).astype(np.int32)).to(device)
    rows = torch.from_numpy(
        rng.integers(*i32, (b, w)).astype(np.int32)).to(device)
    return table, row_case_idx(rng, n, b, device), rows


def compare_row_kernels(device, rng):
    """Phase 5; returns {name: largest difference} over both widths."""
    import torch

    from throttlecrab_tpu_torch.tpu import row_ops

    n = BYID_CAPACITY + (1 << 16)
    worst = {"row_gather": 0, "row_scatter": 0}
    for w in (4, 6):
        table, idx, rows = row_case(rng, n, B, w, device)
        got = row_ops.row_gather(table, idx)
        want = row_ops.row_gather_plain(table, idx)
        t_kernel, t_plain = table.clone(), table.clone()
        row_ops.row_scatter(t_kernel, idx, rows)
        row_ops.row_scatter_plain(t_plain, idx, rows)
        torch.cuda.synchronize()
        errs = {
            "row_gather": max_abs_err(got.cpu().numpy(),
                                      want.cpu().numpy(), True),
            "row_scatter": max_abs_err(t_kernel.cpu().numpy(),
                                       t_plain.cpu().numpy(), True),
        }
        for name, err in errs.items():
            worst[name] = max(worst[name], err)
            if err:
                raise AssertionError(f"{name} W={w}: max_abs_err={err}")
        print(f"  identical: W={w} N={n} B={B} (gather rows, scattered "
              "table)")
    return worst


# ---- by-id launch path (phase 6) ------------------------------------------ #


def config3_params(n_keys):
    """(keys as bytes, em i64, tol i64): bench.py's key names and config 3's
    per-key (burst, count, period) derived from the key id."""
    import numpy as np

    from throttlecrab_tpu_torch.tpu.limiter import derive_params

    kid = np.arange(n_keys, dtype=np.int64)
    em, tol, invalid = derive_params(5 + kid % 60, 50 + kid % 1000,
                                     30 + kid % 120)
    assert not invalid.any()
    return [b"bench:key:%d" % i for i in range(n_keys)], em, tol


def byid_plan(rng, n_keys, per_variant=3):
    """[(variant, ids i32[K*B])]: every key once ("populate", -1 padded),
    then `per_variant` Zipf-1.1 windows for each of byid, ids, ids20."""
    import numpy as np

    per = BYID_K * B
    plan = []
    order = rng.permutation(n_keys).astype(np.int32)
    for start in range(0, n_keys, per):
        ids = np.full(per, -1, np.int32)
        chunk = order[start:start + per]
        ids[: len(chunk)] = chunk
        plan.append(("populate", ids))
    p = np.arange(1, n_keys + 1, dtype=np.float64) ** -1.1
    cdf = np.cumsum(p / p.sum())
    for variant in ("byid", "ids", "ids20"):
        for _ in range(per_variant):
            ids = np.minimum(np.searchsorted(cdf, rng.random(per)),
                             n_keys - 1).astype(np.int32)
            plan.append((variant, ids))
    return plan


def run_byid(device, keys, em, tol, plan):
    """Drive the plan through a native-keymap limiter on `device`: intern
    and resolve every key, upload the id rows, then per window prepare
    the stream, launch, fetch and finish.  Returns (limiter, id rows,
    wire i32[K*B, 4] per window, valid lanes per window, seconds per
    window, (prep, launch, fetch, finish) seconds per window)."""
    import numpy as np

    from throttlecrab_tpu_torch.tpu.kernel import (
        finish_w32,
        fits_w32_wire,
        pack_ids20,
    )
    from throttlecrab_tpu_torch.tpu.limiter import TorchRateLimiter

    lim = TorchRateLimiter(capacity=BYID_CAPACITY, keymap="native",
                           device=device)
    km, table = lim.keymap, lim.table
    km.intern(keys)
    rows = table.upload_id_rows(km.resolve_all(strict=True), em, tol,
                                keymap=km)
    if not fits_w32_wire(np.ones(len(em), bool), em, tol,
                         np.ones(len(em), np.int64), T0, table.tol_hwm,
                         table.now_hwm):
        raise AssertionError("config 3 params do not fit the w32 tier")
    cert = dict(quantity=1, with_degen=False)
    wires, valids, seconds, splits = [], [], [], []
    now = T0
    for variant, ids in plan:
        nows = np.full(BYID_K, now, np.int64)
        t = [time.perf_counter()]
        if variant == "byid":
            words, n_bad = km.assemble_ids(ids, B)
            if n_bad:
                raise AssertionError(f"assemble_ids: {n_bad} bad ids")
            t.append(time.perf_counter())
            out = table.check_many_byid(rows, words.reshape(BYID_K, B),
                                        nows, compact="cur", **cert)
            t.append(time.perf_counter())
            out = out.cpu().numpy()
            t.append(time.perf_counter())
            wire = km.finish_ids(words, em, tol, 1, out, now)
        elif variant == "ids20":
            stream = pack_ids20(ids.reshape(BYID_K, B))
            t.append(time.perf_counter())
            out = table.check_many_ids20(rows, stream, nows, compact="w32",
                                         **cert)
            t.append(time.perf_counter())
            out = out.cpu().numpy()
            t.append(time.perf_counter())
            wire = np.stack(finish_w32(out.reshape(-1)), 1)
        else:
            t.append(time.perf_counter())
            out = table.check_many_ids(rows, ids.reshape(BYID_K, B), nows,
                                       compact="cur", **cert)
            t.append(time.perf_counter())
            out = out.cpu().numpy()
            t.append(time.perf_counter())
            wire = km.finish_raw(ids, em, tol, 1, out, now)
        t.append(time.perf_counter())
        seconds.append(t[-1] - t[0])
        splits.append(tuple(b - a for a, b in zip(t, t[1:])))
        wires.append(wire)
        valids.append(ids >= 0)
        now += int(2e6)
    return lim, rows, wires, valids, seconds, splits


def composed_scan_check(lim, rows):
    """One more Zipf ids window two ways on phase 6's cuda table: through
    check_many_ids (the window kernel) and through the composed scan
    kernel.gcra_scan_ids_acc on a copy of the table, whose rows move
    through the row kernels.  Fails unless outputs (valid lanes),
    real-slot state and expired hits agree; returns the row kernels'
    launches during the composed scan (counters zeroed just before)."""
    import numpy as np
    import torch

    from throttlecrab_tpu_torch.tpu import kernel, row_ops

    table = lim.table
    ids = byid_plan(np.random.default_rng(61), N_KEYS, 1)[-2][1]
    ids = ids.reshape(BYID_K, B)
    now = np.full(BYID_K, T0 + 5 * NS, np.int64)
    state = table.state.clone()
    acc = torch.zeros((), dtype=torch.int64, device=state.device)
    hits = table.expired_hits()
    cert = dict(with_degen=False, compact="cur")
    row_ops.GATHER_LAUNCHES = row_ops.SCATTER_LAUNCHES = 0
    state, acc, want = kernel.gcra_scan_ids_acc(
        state, acc, rows.rows_checked(), torch.from_numpy(ids).to(
            state.device), torch.from_numpy(now).to(state.device), 1, **cert)
    torch.cuda.synchronize()
    launches = {"row_gather": row_ops.GATHER_LAUNCHES,
                "row_scatter": row_ops.SCATTER_LAUNCHES}
    if set(launches.values()) != {BYID_K}:
        raise AssertionError(f"composed scan row launches {launches}, "
                             f"expected {BYID_K} each")
    got = table.check_many_ids(rows, ids, now, 1, **cert)
    valid = torch.from_numpy(ids >= 0).to(state.device)
    if not torch.equal(got[valid], want[valid]):
        raise AssertionError("the composed scan's outputs differ from the "
                             "window kernel's")
    if not torch.equal(table.state[:BYID_CAPACITY], state[:BYID_CAPACITY]):
        raise AssertionError("the composed scan's state differs from the "
                             "window kernel's")
    if table.expired_hits() - hits != int(acc):
        raise AssertionError("the composed scan's expired hits differ")
    return launches


def summarize_profile(wall, device, by_name, n_kernels, top=0):
    """A profile_device result as a record: wall and device ms, the
    device's idle share of the wall time, the window kernel's and the row
    kernels' shares of the device time and, with `top`, the largest
    device records by name."""
    if device is None:
        return {"wall_ms": wall, "device_ms": "not measured"}
    # The row kernels' own names; torch's index kernels (e.g.
    # at::native::vectorized_gather_kernel) are not counted.
    rows = sum(v for k, v in by_name.items()
               if re.search(r"\)::(gather|scatter)_kernel<", k))
    window = sum(v for k, v in by_name.items() if "window_kernel" in k)
    record = {
        "wall_ms": round(wall, 3),
        "device_ms": round(device, 3),
        "idle_share": round(1 - device / wall, 4),
        "kernels": int(n_kernels),
        "window_kernel_ms": round(window, 4),
        "row_kernels_ms": round(rows, 4),
    }
    if top:
        largest = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        record["largest_ms"] = [[k[:90], round(v, 4)] for k, v in largest]
    return record


def profile_byid_window(lim, keys, em, tol):
    """One more Zipf window through check_many_ids (phase 6's limiter,
    after its comparison) under the profiler: (record, ids i32[K, B])."""
    import numpy as np

    km, table = lim.keymap, lim.table
    rows = table.upload_id_rows(km.resolve_all(strict=True), em, tol)
    ids = byid_plan(np.random.default_rng(66), len(keys), 1)[-2][1]
    now = np.full(BYID_K, T0 + 10 * NS, np.int64)

    def window():
        out = table.check_many_ids(rows, ids.reshape(BYID_K, B), now,
                                   quantity=1, with_degen=False,
                                   compact="cur")
        km.finish_raw(ids, em, tol, 1, out.cpu().numpy(), int(now[0]))

    record = summarize_profile(*profile_device(window), top=8)
    return record, ids.reshape(BYID_K, B)


def byid_rates(plan, seconds):
    """{variant: decisions/s} over each variant's windows after its first
    (host clock: dispatch, device, fetch and finish)."""
    per_variant = {}
    for (variant, ids), sec in zip(plan, seconds):
        per_variant.setdefault(variant, []).append((int((ids >= 0).sum()),
                                                    sec))
    return {
        v: sum(n for n, _ in runs[1:]) / sum(s for _, s in runs[1:])
        for v, runs in per_variant.items() if len(runs) > 1
    }


# ---- dispatch_wire_window (phase 7) -------------------------------------- #


def wire_frames(windows):
    """Phase 3's windows as native wire frames: [(frames, now_ns)], each
    frame (key_blob, offsets i64[n+1], params i64[n, 4]) and one
    timestamp per window (the window's last)."""
    import numpy as np

    out = []
    for batches in windows:
        frames = []
        for keys, burst, count, period, q, _now in batches:
            kb = [k.encode() for k in keys]
            offsets = np.zeros(len(kb) + 1, np.int64)
            np.cumsum([len(k) for k in kb], out=offsets[1:])
            params = np.stack([burst, count, period, q], 1).astype(np.int64)
            frames.append((b"".join(kb), offsets, params))
        out.append((frames, batches[-1][-1]))
    return out


def run_wire(limiter, frame_windows):
    """dispatch_wire_window + fetch per window; (results, seconds)."""
    results, seconds, tiers = [], [], []
    for frames, now in frame_windows:
        t = time.perf_counter()
        handle = limiter.dispatch_wire_window(frames, now)
        if handle is None:
            raise AssertionError("dispatch_wire_window fell back")
        results.append(handle.fetch())
        seconds.append(time.perf_counter() - t)
        tiers.append("w32" if handle._w32 else
                     "cur" if handle._finish is not None else "planes")
    print(f"  output tiers by window: {tiers}")
    return results, seconds


# ---- native RESP server (phase 9) ---------------------------------------- #


RESP_CONNS = 8  # client connections, each its own subprocess
RESP_WINDOWS = 10  # windows' worth of commands in the measured run
RESP_PROFILED_WINDOWS = 2  # ... and in the profiled run after it
SPLIT = ("wait", "capture", "dispatch", "fetch", "respond")

# A RESP client that sends its pre-encoded commands pipelined (a sender
# thread) while it counts the "*5" replies (a 3-byte carry across recv
# chunks), then writes what it received to a file and its clock to
# stdout.  It starts sending when the go file appears.
RESP_CLIENT = r"""
import json, os, socket, sys, threading, time
src, dst, port, n, go = sys.argv[1:6]
n = int(n)
data = open(src, "rb").read()
sock = socket.create_connection(("127.0.0.1", int(port)))
while not os.path.exists(go):
    time.sleep(0.001)
start = time.monotonic()
def send():
    view = memoryview(data)
    for i in range(0, len(data), 1 << 16):
        sock.sendall(view[i:i + (1 << 16)])
sender = threading.Thread(target=send)
sender.start()
chunks, count, carry = [], 0, b""
while count < n:
    chunk = sock.recv(1 << 20)
    if not chunk:
        break
    chunks.append(chunk)
    count += (carry + chunk).count(b"*5\r\n")
    carry = chunk[-3:]
end = time.monotonic()
sender.join()
sock.close()
open(dst, "wb").write(b"".join(chunks))
print(json.dumps({"start": start, "end": end, "replies": count}))
"""


def resp_commands(rng, n):
    """`n` THROTTLE commands of phase 3's traffic with quantity 1: Zipf-1.1
    key ids over N_KEYS, per-key (burst, count, period) from the id.
    Returns (key ids i64[n], RESP frames as a list of bytes)."""
    import numpy as np

    p = np.arange(1, N_KEYS + 1, dtype=np.float64) ** -1.1
    cdf = np.cumsum(p / p.sum())
    kid = np.minimum(np.searchsorted(cdf, rng.random(n)),
                     N_KEYS - 1).astype(np.int64)
    cache = {}

    def encode(k):
        key = b"bench:key:%d" % k
        args = [b"%d" % v for v in (5 + k % 60, 50 + k % 1000, 30 + k % 120)]
        return b"*5\r\n$8\r\nTHROTTLE\r\n" + b"".join(
            b"$%d\r\n%s\r\n" % (len(a), a) for a in [key, *args])

    frames = []
    for k in kid.tolist():
        f = cache.get(k)
        if f is None:
            f = cache[k] = encode(k)
        frames.append(f)
    return kid, frames


def run_resp_clients(port, kid, frames, tmp, tag):
    """Send the commands over RESP_CONNS connections (command i on
    connection i % RESP_CONNS), one client subprocess each, all started
    by one go file; returns [(key ids, received bytes, clock record)]
    per connection."""
    import os

    procs = []
    go = os.path.join(tmp, f"{tag}.go")
    try:
        for c in range(RESP_CONNS):
            src = os.path.join(tmp, f"{tag}{c}.in")
            dst = os.path.join(tmp, f"{tag}{c}.out")
            with open(src, "wb") as f:
                f.write(b"".join(frames[c::RESP_CONNS]))
            n = len(frames[c::RESP_CONNS])
            procs.append((c, dst, subprocess.Popen(
                [sys.executable, "-c", RESP_CLIENT, src, dst, str(port),
                 str(n), go],
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
        time.sleep(0.5)  # the clients connect, then wait for the go file
        open(go, "w").close()
        out = []
        for c, dst, proc in procs:
            stdout, stderr = proc.communicate(timeout=300)
            if proc.returncode != 0:
                raise AssertionError(f"RESP client {c} exited "
                                     f"{proc.returncode}: {stderr[-2000:]}")
            with open(dst, "rb") as f:
                out.append((kid[c::RESP_CONNS], f.read(),
                            json.loads(stdout)))
        return out
    finally:
        for _, _, proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()


def recording_transport(limiter, metrics=None, front=None):
    """A NativeRedisTransport (over `front` when given) that records, in
    dispatch order, each window's captured frames (`full`), the frames
    it sent to the device, cookies, timestamp and fetched results, and
    the driver's seconds per part (SPLIT) of each window."""
    from throttlecrab_tpu_torch.server.metrics import Metrics
    from throttlecrab_tpu_torch.server.native_redis import (
        NativeRedisTransport,
    )

    class Recording(NativeRedisTransport):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            self.windows = []
            self._parts = dict.fromkeys(SPLIT, 0.0)

        def _timed(self, part, fn, *a):
            t = time.perf_counter()
            out = fn(*a)
            self._parts[part] += time.perf_counter() - t
            return out

        def _next_batch(self, linger_us):
            return self._timed("wait", super()._next_batch, linger_us)

        def _capture(self, n):
            return self._timed("capture", super()._capture, n)

        def _respond_one(self, *a):
            return self._timed("respond", super()._respond_one, *a)

        def _decide_frames(self, frames, now_ns):
            self._record.update(frames=frames, now_ns=now_ns)
            results, seq = super()._decide_frames(frames, now_ns)
            self._record["results"] = results
            return results, seq

        def _decide_window(self, batches):
            self._record = {"cookies": [(b[3], b[4]) for b in batches],
                            "full": [b[:3] for b in batches]}
            super()._decide_window(batches)
            self._record["split"] = self._parts
            self.windows.append(self._record)
            self._parts = dict.fromkeys(SPLIT, 0.0)

    class TimedLimiter:
        """The limiter with dispatch_wire_window and each handle's fetch
        timed into the window being recorded."""

        def __init__(self, inner):
            self._inner = inner

        def __getattr__(self, name):
            return getattr(self._inner, name)

        def __len__(self):
            return len(self._inner)

        def dispatch_wire_window(self, frames, now_ns, collect_cur=False):
            handle = transport._timed(
                "dispatch", self._inner.dispatch_wire_window, frames, now_ns,
                collect_cur)
            if handle is not None:
                fetch = handle.fetch
                handle.fetch = lambda: transport._timed("fetch", fetch)
            return handle

    transport = Recording("127.0.0.1", 0, TimedLimiter(limiter),
                          metrics or Metrics(), batch_size=B,
                          max_scan_depth=K, front=front)
    return transport


def profile_stretch(run):
    """torch.profiler around run(): its record (summarize_profile)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t) * 1e3
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    by_name = {}
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.device_time_total / 1e3
    return summarize_profile(wall, sum(by_name.values()) if kernels else None,
                             by_name, len(kernels), top=4)


def resp_expected(windows, replay):
    """{cookie: [reply bytes...]} in dispatch order from the replay's
    results, and {cookie: [key bytes...]} from the recorded frames."""
    import numpy as np

    replies, keys = {}, {}
    for w, results in zip(windows, replay):
        for (blob, offsets, _p), (gen, fd), res in zip(
            w["full"], w["cookies"], results
        ):
            if (res.status != 0).any():
                raise AssertionError("a RESP request failed validation")
            rows = np.stack([res.allowed.astype(np.int64), res.limit,
                             res.remaining, res.reset_after_s,
                             res.retry_after_s], 1).tolist()
            for i, (g, f) in enumerate(zip(gen.tolist(), fd.tolist())):
                replies.setdefault((g, f), []).append(
                    b"*5\r\n:%d\r\n:%d\r\n:%d\r\n:%d\r\n:%d\r\n"
                    % tuple(rows[i]))
                keys.setdefault((g, f), []).append(
                    blob[offsets[i]:offsets[i + 1]])
    return replies, keys


def check_resp_replies(runs, windows, replay):
    """Each connection's bytes against the replay: the connection's
    cookie is the one whose recorded keys are the keys it sent."""
    replies, keys = resp_expected(windows, replay)
    by_keys = {tuple(v): c for c, v in keys.items()}
    if len(by_keys) != len(runs):
        raise AssertionError(f"{len(by_keys)} connections recorded, "
                             f"{len(runs)} clients ran")
    for kid, got, clock in runs:
        cookie = by_keys.get(tuple(b"bench:key:%d" % k for k in kid.tolist()))
        if cookie is None:
            raise AssertionError("a client's commands were not dispatched "
                                 "in the order it sent them")
        if clock["replies"] != len(kid):
            raise AssertionError(f"{clock['replies']} *5 replies for "
                                 f"{len(kid)} commands")
        if got != b"".join(replies[cookie]):
            raise AssertionError("a connection's replies differ from the "
                                 "device='cpu' replay")


def run_native_resp(card, wire_rate):
    """Phase 9; returns its record for the kernels line."""
    import asyncio
    import tempfile

    import numpy as np
    import torch

    from throttlecrab_tpu_torch.server import native_redis
    from throttlecrab_tpu_torch.tpu import fused
    from throttlecrab_tpu_torch.tpu.limiter import TorchRateLimiter

    t_phase = time.perf_counter()
    rng = np.random.default_rng(9)
    n_main = RESP_WINDOWS * K * B
    traffic = [resp_commands(rng, n_main),
               resp_commands(rng, RESP_PROFILED_WINDOWS * K * B)]
    limiter = TorchRateLimiter(capacity=CAPACITY, keymap="native")
    transport = recording_transport(limiter)
    loop = asyncio.new_event_loop()
    loop.run_until_complete(transport.start())
    try:
        with tempfile.TemporaryDirectory() as tmp:
            fused.LAUNCHES = 0
            native_redis.WIRE_WINDOWS = native_redis.EXACT_WINDOWS = 0
            native_redis.DISPATCH_ERRORS = 0
            runs = run_resp_clients(transport.bound_port, *traffic[0], tmp,
                                    "main")
            n_measured = len(transport.windows)
            profiled = []
            profile = profile_stretch(lambda: profiled.extend(
                run_resp_clients(transport.bound_port, *traffic[1], tmp,
                                 "profiled")))
            torch.cuda.synchronize()
            routes = (fused.LAUNCHES, native_redis.WIRE_WINDOWS,
                      native_redis.EXACT_WINDOWS,
                      native_redis.DISPATCH_ERRORS)
    finally:
        loop.run_until_complete(transport.stop())
        loop.close()
    windows = transport.windows
    print(f"  {len(windows)} windows ({n_measured} in the measured run): "
          f"fused_window launches, wire windows, exact windows, dispatch "
          f"exceptions = {routes}")
    if routes != (len(windows), len(windows), 0, 0):
        raise AssertionError(f"expected one launch per window, all on the "
                             f"dispatch_wire_window route: {routes}")
    if not limiter.table.state.is_cuda:
        raise AssertionError("the table left the card")
    ref = TorchRateLimiter(capacity=CAPACITY, keymap="native", device="cpu")
    replay = []
    for w in windows:
        handle = ref.dispatch_wire_window(w["frames"], w["now_ns"])
        if handle is None:
            raise AssertionError("the cpu replay left the wire route")
        replay.append(handle.fetch())
    assert_same_results([w["results"] for w in windows], replay)
    check_resp_replies(runs + profiled, windows, replay)
    if not torch.equal(limiter.table.state[:CAPACITY].cpu(),
                       ref.table.state[:CAPACITY]):
        raise AssertionError("table state differs from the cpu replay")
    clocks = [c for _, _, c in runs]
    span = max(c["end"] for c in clocks) - min(c["start"] for c in clocks)
    rate = n_main / span
    measured = windows[:n_measured]
    split = {part: float(np.median([w["split"][part] for w in measured])
                         * 1e3) for part in SPLIT}
    # Seconds per part summed over the measured run (the first window's
    # wait began before the clients started, so it is left out): the
    # driver's busy share of the clients' span is everything but the
    # wait.
    totals = {part: float(sum(w["split"][part] for w in measured))
              for part in SPLIT}
    totals["wait"] -= measured[0]["split"]["wait"]
    busy = (sum(totals.values()) - totals["wait"]) / span
    per_launch = n_main / n_measured
    print(f"  identical to the device='cpu' replay: every connection's "
          f"replies (byte for byte), fetched results, table state")
    print(f"  {n_main} commands over {RESP_CONNS} connections in "
          f"{span:.3f} s: {rate:.0f} replies/s (clients' clock), "
          f"{per_launch:.0f} decisions per launch; phase 7 in process "
          f"{wire_rate:.0f} decisions/s; median ms per window {split}; "
          f"seconds per part over the run {totals}, the driver busy "
          f"{busy:.1%} of the span ({card})")
    print(f"  profiled run ({RESP_PROFILED_WINDOWS * K * B} commands, "
          f"{len(windows) - n_measured} windows): {profile} ({card})")
    print(f"  phase 9 took {time.perf_counter() - t_phase:.1f} s (traffic, "
          "serving, cpu replay and checks)")
    return {
        "resp_launches": routes[0],
        "resp_windows": len(windows),
        "resp_replies_per_s": rate,
        "resp_window_ms": split,
        "resp_driver_s": totals,
        "resp_driver_busy_share": busy,
        "resp_decisions_per_launch": per_launch,
        "resp_profile": profile,
    }


# ---- snapshot at full size (phase 10) ------------------------------------ #


def populate_config3(limiter, n_keys, now):
    """Every config-3 key once (bench.py's names, per-key params derived
    from the key id, quantity 1), K batches of B per dispatch_many."""
    import numpy as np

    batches = []
    for lo in range(0, n_keys, B):
        kid = np.arange(lo, min(lo + B, n_keys), dtype=np.int64)
        batches.append(([f"bench:key:{i}" for i in kid.tolist()],
                        5 + kid % 60, 50 + kid % 1000, 30 + kid % 120,
                        np.ones(len(kid), np.int64), now))
    for w in range(0, len(batches), K):
        limiter.dispatch_many(batches[w:w + K], wire=True).fetch()


def keyed_state(limiter):
    """{key: (tat, expiry)} through the snapshot's export (row gathers;
    callers read the launch counters before this)."""
    from throttlecrab_tpu_torch.tpu import snapshot

    keys, _, _, tat, exp, _, _ = snapshot.export_state(limiter)
    return dict(zip(keys, zip(tat.tolist(), exp.tolist())))


def certificates(limiter):
    t = limiter.table
    return bool(t.cur_safe), int(t.tol_hwm), int(t.now_hwm)


def timed_sync(fn, sink):
    """fn wrapped to add its seconds, the card waited for, to sink[0]."""
    import torch

    def run(*a):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn(*a)
        torch.cuda.synchronize()
        sink[0] += time.perf_counter() - t
        return out
    return run


def run_snapshot(keymap, windows, tmp):
    """Phase 10 for one keymap: populate 1M keys on cuda, decide a config-3
    window, save (16 row_gather launches), restore into a fresh cuda
    limiter (16 row_scatter launches) and a cpu one; per-key state and
    certificates must agree, and the next window must decide identically
    on the original and the cuda restore.  Returns the launch counts and
    the host-clock split of the save and the restore."""
    import numpy as np
    import torch

    from throttlecrab_tpu_torch.tpu import row_ops, snapshot
    from throttlecrab_tpu_torch.tpu.limiter import TorchRateLimiter

    orig = TorchRateLimiter(capacity=CAPACITY, keymap=keymap)
    populate_config3(orig, N_KEYS, T0)
    orig.dispatch_many(windows[0], wire=True).fetch()
    now = windows[0][-1][-1]
    path = f"{tmp}/config3_{keymap}"
    gather_s, scatter_s = [0.0], [0.0]
    gather_fn, scatter_fn = snapshot.gather_rows, snapshot.scatter_rows
    snapshot.gather_rows = timed_sync(gather_fn, gather_s)
    snapshot.scatter_rows = timed_sync(scatter_fn, scatter_s)
    try:
        torch.cuda.synchronize()
        row_ops.GATHER_LAUNCHES = row_ops.SCATTER_LAUNCHES = 0
        t = time.perf_counter()
        payload = snapshot.export_snapshot_payload(orig)
        t_export = time.perf_counter() - t
        gathers = row_ops.GATHER_LAUNCHES
        t = time.perf_counter()
        saved = snapshot.write_snapshot_payload(payload, path)
        t_write = time.perf_counter() - t
        restored = TorchRateLimiter(capacity=CAPACITY, keymap=keymap)
        torch.cuda.synchronize()
        t = time.perf_counter()
        n_cuda = snapshot.load_snapshot(restored, path, now)
        torch.cuda.synchronize()
        t_load = time.perf_counter() - t
        scatters = row_ops.SCATTER_LAUNCHES
    finally:
        snapshot.gather_rows, snapshot.scatter_rows = gather_fn, scatter_fn
    want = -(-N_KEYS // row_ops.MAX_BATCH)
    if saved != N_KEYS or n_cuda != N_KEYS:
        raise AssertionError(f"saved {saved}, restored {n_cuda} of {N_KEYS}")
    if (gathers, scatters) != (want, want):
        raise AssertionError(f"{gathers} row_gather and {scatters} "
                             f"row_scatter launches; expected {want} each")
    if not restored.table.state.is_cuda:
        raise AssertionError("the restored table left the card")
    on_cpu = TorchRateLimiter(capacity=CAPACITY, keymap=keymap, device="cpu")
    if snapshot.load_snapshot(on_cpu, path, now) != N_KEYS:
        raise AssertionError("the cpu restore lost keys")
    want_state = dict(zip(payload["keys"], zip(payload["tat"].tolist(),
                                               payload["expiry"].tolist())))
    for name, lim in (("cuda", restored), ("cpu", on_cpu)):
        if keyed_state(lim) != want_state:
            raise AssertionError(f"the {name} restore's per-key state "
                                 "differs from the original's")
    if certificates(restored) != certificates(on_cpu):
        raise AssertionError(
            f"certificates differ: original {certificates(orig)}, cuda "
            f"restore {certificates(restored)}, cpu restore "
            f"{certificates(on_cpu)}")
    # The row kernels at the path's shape against their plain versions.
    idx = torch.from_numpy(np.asarray(payload["slots"][:row_ops.MAX_BATCH],
                                      np.int32)).cuda()
    err = {"row_gather": max_abs_err(
        row_ops.row_gather(orig.table.state, idx).cpu().numpy(),
        row_ops.row_gather_plain(orig.table.state, idx).cpu().numpy(),
        True)}
    rows = orig.table.state[:row_ops.MAX_BATCH].flip(0).contiguous()
    a, b = orig.table.state.clone(), orig.table.state.clone()
    row_ops.row_scatter(a, idx, rows)
    row_ops.row_scatter_plain(b, idx, rows)
    err["row_scatter"] = max_abs_err(a.cpu().numpy(), b.cpu().numpy(), True)
    if any(err.values()):
        raise AssertionError(f"row kernels differ from plain at B=65536: "
                             f"{err}")
    got = [orig.dispatch_many(windows[1], wire=True).fetch()]
    want_next = [restored.dispatch_many(windows[1], wire=True).fetch()]
    assert_same_results(got, want_next)
    if keyed_state(orig) != keyed_state(restored):
        raise AssertionError("state after the next window differs")
    print(f"  keymap={keymap}: saved and restored {N_KEYS} keys; "
          f"{gathers} row_gather + {scatters} row_scatter launches; cuda and "
          f"cpu restores equal the original key for key, certificates "
          f"{certificates(restored)}; the next window decides identically")
    split = {"export_ms": t_export * 1e3, "gather_ms": gather_s[0] * 1e3,
             "write_ms": t_write * 1e3, "load_ms": t_load * 1e3,
             "scatter_ms": scatter_s[0] * 1e3}
    print("  ms (host clock): " + ", ".join(
        f"{k[:-3]} {v:.1f}" for k, v in split.items())
        + f"; file {os.path.getsize(path + '.npz')} bytes")
    return {"row_gather": gathers, "row_scatter": scatters}, err, split


# ---- failure domain and front tier (phase 11) ---------------------------- #


DRILL_WINDOWS = 10  # 2 clean, 2 absorbed faults, degrade, 2 oracle, 3 card
PROBE_INTERVAL_MS = 1000  # the supervisor's default
# The supervisor's states over the drill, each entry stamped once.
DRILL_STATES = ["ok", "retrying", "ok", "retrying", "ok", "retrying",
                "degraded", "recovering", "ok"]
FRONT_WINDOWS_OF_B = 24  # phase 11b's commands: 24 x 4096 = 98,304


class StateClock:
    """The supervisor's state transitions on the host clock: wraps its
    two state writers, so every entry into a state is stamped."""

    def __init__(self, sup):
        self.log = [(sup.state, time.perf_counter())]
        set_state, cas_state = sup._set_state, sup._cas_state

        def set_(state):
            set_state(state)
            self._note(sup.state)

        def cas(expect, state):
            cas_state(expect, state)
            self._note(sup.state)

        sup._set_state, sup._cas_state = set_, cas

    def _note(self, state):
        if state != self.log[-1][0]:
            self.log.append((state, time.perf_counter()))

    def ms_in_states(self):
        """[(state, ms)] in order; the last state runs to now."""
        stamps = self.log + [(None, time.perf_counter())]
        return [(a, (tb - ta) * 1e3)
                for (a, ta), (_, tb) in zip(stamps, stamps[1:])]


def drill_windows(rng):
    """Phase 3's config-3 traffic, DRILL_WINDOWS windows of K x B with
    quantity 1, each window stamped with one timestamp (its last batch's),
    as the server's engine and native driver stamp a window; the last
    three are moved past the probe interval.  (The supervisor probes and
    re-promotes at a window's last timestamp, as the JAX one does, so a
    window whose earlier batches carry earlier timestamps can see a
    bucket the re-promotion dropped as lapsed: ROADMAP C5.)"""
    windows = config3_windows(rng, N_KEYS, DRILL_WINDOWS, K, B, -1)
    shift = (PROBE_INTERVAL_MS + 100) * 1_000_000
    return [
        [(*b[:5], w[-1][5] + (shift if i >= 7 else 0)) for b in w]
        for i, w in enumerate(windows)
    ]


def wait_for_file(pattern, seconds=30):
    import glob

    deadline = time.monotonic() + seconds
    while True:
        found = glob.glob(pattern)
        if found:
            return found
        if time.monotonic() > deadline:
            raise AssertionError(f"no file matches {pattern}")
        time.sleep(0.05)


def check_degrade_dump(rec, path, seeded, card):
    """Phase 11a's flight recorder: the dump the degrade wrote holds the
    degrade event and the injections in firing order, and its windows
    replay on a host oracle seeded with the table the ring started from
    (the populated 1M keys) with 0 mismatches against the recorded
    outcomes; after the drill the recorder also holds the recovery's
    event."""
    from throttlecrab_tpu_torch.replay import player
    from throttlecrab_tpu_torch.replay.trace import Trace, decode_event
    from throttlecrab_tpu_torch.server.supervisor import HostOracle

    trace = Trace.load(path)
    kinds = [e.kind for e in trace.events]
    fired = [(i.site, i.mode, i.index) for i in trace.injections]
    if kinds != ["degrade"] or fired[:3] != [
        ("launch", "count", 0), ("launch", "count", 1),
        ("fetch", "count", 0),
    ] or {f[1] for f in fired[3:]} != {"persistent"}:
        raise AssertionError(f"degrade dump: events {kinds}, injections "
                             f"{fired}")
    oracle = HostOracle(bytes_keys=True)
    keys, tats, exps = seeded
    oracle.seed(keys, tats, exps)
    t = time.perf_counter()
    got = player.replay(trace, oracle)
    replay_s = time.perf_counter() - t
    sink = []
    compared = player.compare_outcomes(
        trace, got, player.recorded_outcomes(trace), "recorded", sink)
    if sink or compared != trace.n_rows() or trace.n_rows() < 4 * K * B:
        raise AssertionError(f"degrade dump replay: {len(sink)} mismatches "
                             f"over {compared} of {trace.n_rows()} rows: "
                             f"{[str(m) for m in sink[:4]]}")
    after = [decode_event(frame[5:]).kind for _, frame in rec._events]
    if after != ["degrade", "repromote"] or rec._capture_errors:
        raise AssertionError(f"recorder after the drill: events {after}, "
                             f"{rec._capture_errors} capture errors")
    print(f"  flight recorder (ring): the degrade dumped "
          f"{len(trace.windows)} windows ({trace.n_rows()} rows), the "
          f"degrade event and injections {fired[:3]} + "
          f"{len(fired) - 3} persistent, in firing order; replayed on a "
          f"host oracle seeded with the populated table: 0 mismatches over "
          f"{compared} rows in {replay_s:.1f} s; the recovery's event "
          f"follows; 0 capture errors ({card})")
    return {"dump_windows": len(trace.windows), "dump_rows": trace.n_rows(),
            "dump_replay_s": replay_s, "dump_injections": len(fired)}


def run_drill(card):
    """Phase 11a: the launch supervisor over the 1M-key cuda limiter,
    against an uninterrupted, unsupervised device="cpu" run of the same
    traffic, with a ring-mode flight recorder armed.  Returns its record
    for the kernels line."""
    import shutil
    import tempfile

    import numpy as np
    import torch

    from throttlecrab_tpu_torch import faults, replay
    from throttlecrab_tpu_torch.server import supervisor as sup_mod
    from throttlecrab_tpu_torch.tpu import fused, row_ops, snapshot
    from throttlecrab_tpu_torch.tpu.limiter import TorchRateLimiter

    windows = drill_windows(np.random.default_rng(11))
    limiter = TorchRateLimiter(capacity=CAPACITY)
    populate_config3(limiter, N_KEYS, T0)
    # The table the recorder's ring starts from, for the dump's replay.
    seed_keys, _, _, seed_tat, seed_exp, _, _ = snapshot.export_state(limiter)
    seeded = ([k.encode() for k in seed_keys], seed_tat.tolist(),
              seed_exp.tolist())
    dump_dir = tempfile.mkdtemp()
    rec = replay.FlightRecorder(capacity=1024, out_dir=dump_dir)
    sup = sup_mod.SupervisedLimiter(
        limiter, retries=3, probe_interval_ms=PROBE_INTERVAL_MS)
    clock = StateClock(sup)
    split = {"export": [0.0], "seed": [0.0], "bulk_insert": [0.0]}
    mutated = []
    export_fn, seed_fn = snapshot.export_state, sup_mod.HostOracle.seed
    bulk_fn = snapshot._bulk_insert
    snapshot.export_state = timed_sync(export_fn, split["export"])
    sup_mod.HostOracle.seed = lambda self, *a: timed_sync(
        lambda: seed_fn(self, *a), split["seed"])()

    def bulk(lim, keys, tats, exps):
        mutated.append(len(keys))
        return timed_sync(bulk_fn, split["bulk_insert"])(lim, keys, tats,
                                                         exps)

    snapshot._bulk_insert = bulk

    class RepromoteProbe:
        """Stands in for the front tier: the supervisor calls on_restore
        right after the re-promotion's bulk insert, so the counters read
        here cover exactly the probe and the re-promotion."""

        seen = None

        def on_restore(self):
            RepromoteProbe.seen = (fused.LAUNCHES, row_ops.SCATTER_LAUNCHES)

    got, seconds, steps = [], [], []

    def window(w, label):
        t = time.perf_counter()
        got.append(sup.dispatch_many(windows[w], wire=True).fetch())
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t)
        steps.append((label, sup.state, sup.retry_count))
        # Capture each sub-batch as a serving driver does.
        for b, r in zip(windows[w], got[-1]):
            rec.record_window(b[5], b[0], np.stack(b[1:5], 1), r.allowed,
                              r.status)

    replay.arm(rec)
    try:
        window(0, "clean")
        window(1, "clean")
        faults.arm(faults.FaultInjector(faults.parse_spec("launch:count:2")))
        window(2, "launch:count:2")
        if (sup.state, sup.retry_count) != ("ok", 2):
            raise AssertionError(f"launch:count:2 not absorbed: {steps}")
        faults.arm(faults.FaultInjector(faults.parse_spec("fetch:count:1")))
        window(3, "fetch:count:1")
        if (sup.state, sup.retry_count) != ("ok", 3):
            raise AssertionError(f"fetch:count:1 not absorbed: {steps}")
        injector = faults.FaultInjector(
            faults.parse_spec("launch:persistent"))
        faults.arm(injector)
        torch.cuda.synchronize()
        row_ops.GATHER_LAUNCHES = 0
        window(4, "launch:persistent")
        degrade_gathers = row_ops.GATHER_LAUNCHES
        want_gathers = -(-N_KEYS // row_ops.MAX_BATCH)
        if sup.state != "degraded" or degrade_gathers != want_gathers:
            raise AssertionError(
                f"degrade: state {sup.state}, {degrade_gathers} row_gather "
                f"launches, expected {want_gathers}")
        (dump_path,) = wait_for_file(os.path.join(dump_dir, "*.tctr"))
        fused.LAUNCHES = 0
        t = time.perf_counter()
        window(5, "degraded")
        window(6, "degraded")
        oracle_rate = 2 * K * B / (time.perf_counter() - t)
        if fused.LAUNCHES != 0:
            raise AssertionError(f"{fused.LAUNCHES} window launches while "
                                 "serving from the host oracle")
        injector.heal()
        sup.front = RepromoteProbe()
        fused.LAUNCHES = row_ops.SCATTER_LAUNCHES = 0
        t = time.perf_counter()
        window(7, "healed, past the probe interval")
        recover_ms = (time.perf_counter() - t) * 1e3
        after_recover = fused.LAUNCHES
        window(8, "card")
        window(9, "card")
    finally:
        faults.disarm()
        replay.disarm()
        snapshot.export_state, sup_mod.HostOracle.seed = export_fn, seed_fn
        snapshot._bulk_insert = bulk_fn
    try:
        dump = check_degrade_dump(rec, dump_path, seeded, card)
    finally:
        shutil.rmtree(dump_dir, ignore_errors=True)
    want_scatters = -(-mutated[0] // row_ops.MAX_BATCH) if mutated else -1
    if RepromoteProbe.seen != (1, want_scatters) or after_recover != 2 or (
            sup.state, sup.degrade_count, sup.repromote_count) != (
                "ok", 1, 1):
        raise AssertionError(
            f"recovery: (probe launches, scatters) at re-promotion "
            f"{RepromoteProbe.seen}, expected (1, {want_scatters}); "
            f"{after_recover} window launches with the window; state "
            f"{sup.state}, degrades {sup.degrade_count}, re-promotions "
            f"{sup.repromote_count}")
    # The timings come from wrappers patched over the names _degrade and
    # _try_recover import when they run, and over the state writers: a
    # wrapper that never ran leaves its time at 0 or a state unseen.
    states = [st for st, _ in clock.log]
    if len(mutated) != 1 or min(v[0] for v in split.values()) <= 0 or \
            states != DRILL_STATES:
        raise AssertionError(f"the drill's probes missed a step: {split}, "
                             f"{len(mutated)} bulk inserts, states {states}")
    if fused.LAUNCHES != 4 or not limiter.table.state.is_cuda:
        raise AssertionError(f"{fused.LAUNCHES} window launches over the "
                             "recovery and two card windows, expected 4")
    ref = TorchRateLimiter(capacity=CAPACITY, device="cpu")
    populate_config3(ref, N_KEYS, T0)
    want = [ref.dispatch_many(w, wire=True).fetch() for w in windows]
    assert_same_results(got, want)
    final = keyed_state(sup)
    if final.pop(sup_mod.PROBE_KEY, None) is None:
        raise AssertionError("the recovery probe's key is not in the table")
    # A bucket whose TTL lapsed is absent to every decision: the
    # re-promotion skips host buckets that lapsed while degraded (as the
    # JAX supervisor does), so such a key keeps its older, also lapsed,
    # device row.  Every other key's tat/expiry must be equal.
    now = windows[-1][-1][-1]
    want_state = keyed_state(ref)
    lapsed = 0
    for key, (tat, exp) in want_state.items():
        have = final.get(key)
        if have == (tat, exp):
            continue
        if have is not None and have[1] <= now and exp <= now:
            lapsed += 1
            continue
        raise AssertionError(f"{key}: tat/expiry {have} after the drill, "
                             f"{(tat, exp)} in the uninterrupted cpu run")
    if len(final) != len(want_state):
        raise AssertionError("the drill's table holds other keys")
    states = clock.ms_in_states()
    print(f"  windows (step, state after, retries so far): {steps}")
    print(f"  every wire field of the {DRILL_WINDOWS} windows and the final "
          f"per-key tat/expiry of {N_KEYS} keys equal the uninterrupted "
          f"device='cpu' run (the probe key aside; {lapsed} keys lapsed in "
          "both, with different lapsed rows)")
    print(f"  retries {sup.retry_count}; degrade: {degrade_gathers} "
          f"row_gather launches, export {split['export'][0] * 1e3:.1f} ms, "
          f"oracle seed {split['seed'][0] * 1e3:.1f} ms; host oracle "
          f"{oracle_rate:.0f} decisions/s; recovery: 1 probe window launch, "
          f"{mutated[0]} host-mutated keys re-promoted by "
          f"{RepromoteProbe.seen[1]} row_scatter launches in "
          f"{split['bulk_insert'][0] * 1e3:.1f} ms, the recovering window "
          f"{recover_ms:.1f} ms ({card})")
    print("  ms in each state, in order: " + ", ".join(
        f"{st} {ms:.1f}" for st, ms in states))
    print("  ms per window: " + ", ".join(f"{x * 1e3:.1f}" for x in seconds))
    return {
        "retries": sup.retry_count,
        "degrade_row_gather_launches": degrade_gathers,
        "repromote_row_scatter_launches": RepromoteProbe.seen[1],
        "repromoted_keys": mutated[0],
        "lapsed_keys": lapsed,
        "probe_window_launches": RepromoteProbe.seen[0],
        "export_ms": split["export"][0] * 1e3,
        "seed_ms": split["seed"][0] * 1e3,
        "bulk_insert_ms": split["bulk_insert"][0] * 1e3,
        "recovering_window_ms": recover_ms,
        "oracle_decisions_per_s": oracle_rate,
        "ms_in_states": states,
        "window_ms": [x * 1e3 for x in seconds],
        **dump,
    }


def serve_front_resp(kid, frames, tmp, tag, with_front):
    """One run of 11b's commands through phase 9's harness on a fresh
    cuda limiter, over a default FrontTier or none, checked against a
    no-front device="cpu" replay of the captured batches; returns
    (replies/s on the clients' clock, deny-cache hits, launches,
    windows, shed)."""
    import asyncio

    import torch

    from throttlecrab_tpu_torch.server.config import Config
    from throttlecrab_tpu_torch.server.metrics import Metrics
    from throttlecrab_tpu_torch.server.store import create_front_tier
    from throttlecrab_tpu_torch.tpu import fused
    from throttlecrab_tpu_torch.tpu.limiter import TorchRateLimiter

    limiter = TorchRateLimiter(capacity=CAPACITY, keymap="native")
    metrics = Metrics()
    front = None
    if with_front:
        front = create_front_tier(Config(), metrics, limiter)
        if front.deny_cache.capacity != 65536 or (
                front.admission.max_pending != 100_000):
            raise AssertionError("the front tier's defaults changed")
    transport = recording_transport(limiter, metrics, front)
    loop = asyncio.new_event_loop()
    loop.run_until_complete(transport.start())
    try:
        fused.LAUNCHES = 0
        runs = run_resp_clients(transport.bound_port, kid, frames, tmp, tag)
        torch.cuda.synchronize()
        launches = fused.LAUNCHES
    finally:
        loop.run_until_complete(transport.stop())
        loop.close()
    windows = transport.windows
    ref = TorchRateLimiter(capacity=CAPACITY, keymap="native", device="cpu")
    replay = []
    for w in windows:
        handle = ref.dispatch_wire_window(w["full"], w["now_ns"])
        if handle is None:
            raise AssertionError("the cpu replay left the wire route")
        replay.append(handle.fetch())
    check_resp_replies(runs, windows, replay)
    if not torch.equal(limiter.table.state[:CAPACITY].cpu(),
                       ref.table.state[:CAPACITY]):
        raise AssertionError("table state differs from the no-front replay")
    hits = front.deny_cache.hits if front else 0
    shed = (front.admission.shed_peek + front.admission.shed_consume
            if front else 0)
    if front is None and launches != len(windows):
        raise AssertionError(f"{launches} launches for {len(windows)} "
                             "windows without a front tier")
    if front is not None and (hits <= 0 or not 0 < launches <= len(windows)):
        raise AssertionError(f"{hits} deny-cache hits, {launches} launches "
                             f"for {len(windows)} windows")
    clocks = [c for _, _, c in runs]
    span = max(c["end"] for c in clocks) - min(c["start"] for c in clocks)
    return len(kid) / span, hits, launches, len(windows), shed


def run_front_resp(card, resp_rate):
    """Phase 11b: phase 9's harness over a FrontTier with the default
    knobs (deny cache 65,536, admission at 100,000 pending), and the same
    commands without a front tier, alternately (off, on, off, on).
    Returns its record for the kernels line."""
    import tempfile

    import numpy as np

    n = FRONT_WINDOWS_OF_B * B
    kid, frames = resp_commands(np.random.default_rng(12), n)
    runs = {False: [], True: []}
    with tempfile.TemporaryDirectory() as tmp:
        for i, with_front in enumerate((False, True, False, True)):
            runs[with_front].append(serve_front_resp(
                kid, frames, tmp, f"front{i}", with_front))
    off = [r[0] for r in runs[False]]
    on = [r[0] for r in runs[True]]
    _, hits, launches, n_windows, shed = runs[True][-1]
    print(f"  {n} commands over {RESP_CONNS} connections, 4 runs: every "
          "connection's bytes and the table state equal the no-front "
          "device='cpu' replay of the captured batches")
    print(f"  with the default front tier: deny-cache hits {hits} "
          f"({hits / n:.1%} of requests), {shed} shed, {launches} window "
          f"launches for {n_windows} windows (last run); replies/s "
          f"(clients' clock) without the front {off}, with it {on}: "
          f"front / no-front {sum(on) / sum(off):.3f}; phase 9's "
          f"{resp_rate:.0f} at 655,360 commands in this run ({card})")
    return {
        "front_deny_hits": hits,
        "front_requests": n,
        "front_windows": n_windows,
        "front_launches": launches,
        "front_shed": shed,
        "front_replies_per_s": on,
        "front_off_replies_per_s": off,
        "front_on_over_off": sum(on) / sum(off),
    }


# ---- record, replay and control (phase 14) ------------------------------- #


class TimedTarget:
    """A replay target with its rate_limit_batch calls timed (each fetches
    its result to the host, so the card's work is inside) and its
    (allowed, status) planes kept for the outcome vector."""

    def __init__(self, inner):
        self.inner = inner
        self.seconds = 0.0
        self.outcomes = []

    def __getattr__(self, name):
        return getattr(self.inner, name)

    def rate_limit_batch(self, *a, **kw):
        import numpy as np

        t = time.perf_counter()
        res = self.inner.rate_limit_batch(*a, **kw)
        self.seconds += time.perf_counter() - t
        self.outcomes.append((np.asarray(res.allowed, np.uint8),
                              np.asarray(res.status, np.uint8)))
        return res


def merge_rankings(parts):
    """One ranking from control.rank's rankings of disjoint candidate
    sets: ordered as rank() orders them (score descending, ties on the
    policy name) and numbered again."""
    rows = sorted((r for part in parts for r in part),
                  key=lambda r: (-r["score"], r["policy"]["name"]))
    return [{**r, "rank": i + 1} for i, r in enumerate(rows)]


def state_mismatches(live, replayed, now):
    """Keys whose tat/expiry differ between two {bytes key: (tat, expiry)}
    maps, a bucket lapsed at `now` (or absent) on both sides aside."""
    bad = []
    for key in live.keys() | replayed.keys():
        a, b = live.get(key), replayed.get(key)
        if a == b:
            continue
        if (a is None or a[1] <= now) and (b is None or b[1] <= now):
            continue
        bad.append((key, a, b))
    return bad


def run_record_replay(card, resp_rate):
    """Phase 14: phase 9's 655,360 RESP commands through a native
    transport over the default server's tiers (W=6 insight table, the
    default FrontTier and InsightTier) with a full-mode flight recorder
    and a control plane (mode both, 100 ms ticks) armed; then the trace
    replayed differentially on the card, on the cpu and on the scalar
    oracle, and ranked by the offline policy search.  Returns its record
    for the kernels line."""
    import asyncio
    import tempfile
    from collections import Counter

    import numpy as np
    import torch

    from throttlecrab_tpu_torch import control, replay
    from throttlecrab_tpu_torch.replay import player
    from throttlecrab_tpu_torch.server import native_redis
    from throttlecrab_tpu_torch.server.config import Config
    from throttlecrab_tpu_torch.server.metrics import Metrics
    from throttlecrab_tpu_torch.server.store import (
        create_cleanup_policy,
        create_control,
        create_front_tier,
        create_insight,
    )
    from throttlecrab_tpu_torch.tpu import fused
    from throttlecrab_tpu_torch.tpu.limiter import TorchRateLimiter

    t_phase = time.perf_counter()
    n = RESP_WINDOWS * K * B
    kid, frames = resp_commands(np.random.default_rng(14), n)
    cfg = Config(http=True, control=True, control_tick_ms=100)
    metrics = Metrics(max_denied_keys=cfg.max_denied_keys)
    limiter = TorchRateLimiter(capacity=CAPACITY, keymap="native",
                               insight=cfg.insight)
    front = create_front_tier(cfg, metrics, limiter)
    insight = create_insight(cfg, metrics, limiter, front)
    plane = create_control(cfg, metrics, limiter, front, insight,
                           create_cleanup_policy(cfg))
    ticks = []  # (now_ns, snapshot taken for this tick, ms)
    tick = plane.tick

    def checked_tick(now_ns, queue_depth=0):
        t = time.perf_counter()
        ran = tick(now_ns, queue_depth=queue_depth)
        if ran:
            ticks.append((now_ns, plane._prev is not None
                          and plane._prev.now_ns == now_ns,
                          (time.perf_counter() - t) * 1e3))
        return ran

    plane.tick = checked_tick
    tmp = tempfile.mkdtemp()
    path = os.path.join(tmp, "phase14.tctr")
    rec = replay.FlightRecorder(mode="full", out_dir=tmp, path=path)
    transport = native_redis.NativeRedisTransport(
        "127.0.0.1", 0, limiter, metrics, batch_size=B, max_scan_depth=K,
        front=front, insight=insight, control=plane)
    # The capture's cost: the driver's seconds in its recorder hook, per
    # window.
    capture_s = []
    record_fn = transport._maybe_record

    def timed_record(*a):
        t = time.perf_counter()
        record_fn(*a)
        capture_s.append(time.perf_counter() - t)

    transport._maybe_record = timed_record
    loop = asyncio.new_event_loop()
    loop.run_until_complete(transport.start())
    replay.arm(rec)
    try:
        native_redis.DISPATCH_ERRORS = 0
        runs = run_resp_clients(transport.bound_port, kid, frames, tmp,
                                "p14")
    finally:
        loop.run_until_complete(transport.stop())
        loop.close()
        replay.disarm()
    rec.close()
    torch.cuda.synchronize()
    clocks = [c for _, _, c in runs]
    span = max(c["end"] for c in clocks) - min(c["start"] for c in clocks)
    rate = n / span
    if any(c["replies"] != len(k) for k, _, c in runs):
        raise AssertionError("a client missed replies")
    if rec._capture_errors or native_redis.DISPATCH_ERRORS:
        raise AssertionError(f"{rec._capture_errors} capture errors, "
                             f"{native_redis.DISPATCH_ERRORS} dispatch "
                             "errors")
    if not ticks or not all(ok for _, ok, _ in ticks):
        raise AssertionError(f"control ticks without a snapshot: {ticks}")
    reg = plane.registry
    for e in reg.log:
        a = reg._actuators[e["actuator"]]
        if not (a.lo <= e["new"] <= a.hi
                and abs(e["new"] - e["old"]) <= a.max_step):
            raise AssertionError(f"actuation out of its bounds: {e}")
    trace_bytes = os.path.getsize(path)
    t = time.perf_counter()
    trace = replay.Trace.load(path)
    load_s = time.perf_counter() - t
    keys = [k for w in trace.windows for k in w.keys]
    sent = Counter(b"bench:key:%d" % k for k in kid.tolist())
    params = np.concatenate([w.params for w in trace.windows])
    tkid = np.array([int(k[10:]) for k in keys], np.int64)
    want_params = np.stack([5 + tkid % 60, 50 + tkid % 1000,
                            30 + tkid % 120, np.ones_like(tkid)], 1)
    if Counter(keys) != sent or not np.array_equal(params, want_params):
        raise AssertionError("the trace's rows differ from the commands "
                             "sent")
    status = np.concatenate([w.status for w in trace.windows])
    ignored = {s: int((status == s).sum()) for s in
               player.DEFAULT_IGNORE_STATUSES}
    capture = {"total_s": sum(capture_s),
               "share_of_span": sum(capture_s) / span,
               "median_ms_per_window": float(np.median(capture_s)) * 1e3,
               "us_per_row": sum(capture_s) / n * 1e6}
    print(f"  {n} commands over {RESP_CONNS} connections in {span:.3f} s: "
          f"{rate:.0f} replies/s with the recorder and the control plane "
          f"armed (phase 9, neither: {resp_rate:.0f}); capture (the "
          f"driver's recorder hook) {capture['total_s']:.3f} s over "
          f"{len(capture_s)} windows, {capture['share_of_span']:.1%} of the "
          f"span, median {capture['median_ms_per_window']:.1f} ms per "
          f"window, {capture['us_per_row']:.3f} µs per row; trace "
          f"{trace_bytes} bytes, {len(trace.windows)} windows, rows equal "
          f"the commands sent, loaded in {load_s:.2f} s; 0 capture errors; "
          f"ignored statuses (3, 4, 6) {ignored} ({card})")
    # Every key keeps its params, so each window is one conflict round:
    # one rate_limit_batch call, one window-kernel launch.
    target = TimedTarget(player.make_target("device", trace,
                                            capacity=CAPACITY))
    torch.cuda.synchronize()
    fused.LAUNCHES = 0
    t = time.perf_counter()
    report = player.differential_replay(trace, target)
    diff_s = time.perf_counter() - t
    torch.cuda.synchronize()
    launches = fused.LAUNCHES
    if not report.ok or launches != len(trace.windows):
        bad = report.vs_oracle + report.vs_recorded
        raise AssertionError(f"cuda replay: {report.summary()}, {launches} "
                             f"window launches for {len(trace.windows)} "
                             f"windows; {[str(m) for m in bad[:4]]}")
    cpu = TimedTarget(player.make_target("device", trace, capacity=CAPACITY,
                                         device="cpu"))
    player.replay(trace, cpu)
    vec = player.outcome_vector(target.outcomes)
    if vec != player.outcome_vector(cpu.outcomes) or \
            vec != trace.outcome_vector():
        raise AssertionError("the cuda replay's outcome vector differs from "
                             "the cpu replay's or the recording")
    now = trace.windows[-1].now_ns
    live = keyed_state(limiter)
    replayed = {k.encode("utf-8", "surrogateescape"): v
                for k, v in keyed_state(target.inner).items()}
    bad = state_mismatches(live, replayed, now)
    if bad:
        raise AssertionError(f"{len(bad)} keys' tat/expiry differ between "
                             f"the live limiter and the replay: {bad[:4]}")
    # The offline policy search, after the replays have been timed: one
    # candidate per spawned process, merged as rank() orders them.
    cands = control.default_candidates()
    t_rank = time.perf_counter()
    with ProcessPoolExecutor(
            max_workers=min(len(cands), max((os.cpu_count() or 2) - 1, 1)),
            mp_context=multiprocessing.get_context("spawn")) as pool:
        ranking = merge_rankings(pool.map(
            functools.partial(control.rank, trace), [[p] for p in cands]))
    rank_s = time.perf_counter() - t_rank
    rows = trace.n_rows()
    rates = {"cuda": rows / target.seconds, "cpu": rows / cpu.seconds,
             "oracle": rows / (diff_s - target.seconds)}
    tick_ms = float(np.median([ms for _, _, ms in ticks]))
    top3 = [(r["policy"]["name"], r["score"]) for r in ranking[:3]]
    print(f"  differential_replay on cuda: {report.summary()}; "
          f"{launches} window launches for {len(trace.windows)} windows; "
          f"outcome vector equal to the cpu replay's and the recording; "
          f"{len(live)} live keys' tat/expiry equal the replay's (lapsed "
          f"aside)")
    print(f"  replay decisions/s: cuda {rates['cuda']:.0f}, cpu "
          f"{rates['cpu']:.0f}, oracle {rates['oracle']:.0f} ({card})")
    print(f"  control plane: {plane.ticks} ticks, all with a snapshot, "
          f"median {tick_ms:.3f} ms per tick; {reg.actuations} actuations "
          f"({reg.clamps} clamped), each inside its bounds and step; rank "
          f"over {len(ranking)} candidates in {rank_s:.1f} s, top three "
          f"{top3}; phase {time.perf_counter() - t_phase:.1f} s ({card})")
    import shutil

    shutil.rmtree(tmp, ignore_errors=True)
    return {
        "replay_launches": launches,
        "replay_windows": len(trace.windows),
        "replay_summary": report.summary(),
        "replay_ignored_statuses": ignored,
        "replay_decisions_per_s": rates,
        "record_replies_per_s": rate,
        "record_capture": capture,
        "trace_bytes": trace_bytes,
        "control_ticks": plane.ticks,
        "control_actuations": reg.actuations,
        "control_tick_ms": tick_ms,
        "rank_top3": top3,
    }


# ---- main ---------------------------------------------------------------- #


# ---- insight tier and crash durability (phases 12 and 13) --------------- #


INSIGHT_WINDOWS = 10  # phase 12's windows
POLL_STEP_NS = 1_001_000_000  # one window per default poll_ms, and 1 ms
RATE_WINDOWS = 6  # phase 12's W=6 / W=4 rate windows, each width
DELTA_WINDOWS = 3  # phase 13's windows before each delta


def stamped_frames(rng, n, start):
    """n config-3 windows as native wire frames, each window stamped with
    one timestamp, POLL_STEP_NS after the previous one's."""
    windows = config3_windows(rng, N_KEYS, n, K, B, -1)
    return wire_frames([
        [(*b[:5], start + w * POLL_STEP_NS) for b in win]
        for w, win in enumerate(windows)
    ])


def frame_keys(frames):
    """Every request's key bytes, in dispatch order."""
    return [blob[offsets[i]:offsets[i + 1]]
            for blob, offsets, _ in frames for i in range(len(offsets) - 1)]


def observe_frames(front, frames, results, now):
    """Feed one decided window to the deny cache as the native driver's
    _observe_plan does (keys are bytes, the native keymap's identity)."""
    rows = []
    for (blob, offsets, params), res in zip(frames, results):
        ok = res.status == 0
        allowed = (res.allowed != 0) & ok
        cur = (res.cur_ns.tolist() if res.cur_ns is not None
               else [None] * len(ok))
        for i, p in enumerate(params.tolist()):
            rows.append((blob[offsets[i]:offsets[i + 1]], *p,
                         bool(allowed[i]), cur[i] if ok[i] else None))
    front.observe_window(rows, now, front.next_seq())


def drain_ms(split):
    """{name: ms} of timed_sync sinks, which restart from 0."""
    out = {}
    for name, sink in split.items():
        out[name], sink[0] = sink[0] * 1e3, 0.0
    return out


def run_insight(device, frame_windows):
    """Phase 12 on one device: the 1M-key native limiter with the insight
    rows, a default FrontTier and an InsightTier at its defaults; each
    window through dispatch_wire_window (cur tier), its rows observed into
    the deny cache, then one poll; one decay at the end.  Returns what
    the two devices must agree on, the timings and the limiter."""
    import torch

    from throttlecrab_tpu_torch.front import (
        AdmissionController,
        DenyCache,
        FrontTier,
    )
    from throttlecrab_tpu_torch.insight import InsightTier
    from throttlecrab_tpu_torch.tpu import fused
    from throttlecrab_tpu_torch.tpu.limiter import TorchRateLimiter

    lim = TorchRateLimiter(capacity=CAPACITY, keymap="native", insight=True,
                           device=device)
    populate_config3(lim, N_KEYS, T0)
    front = FrontTier(DenyCache(65536), AdmissionController(
        max_pending=100_000, max_wait_us=0, peek_frac=0.9), bytes_keys=True)
    tier = InsightTier(limiter=lim, front=front)
    split = {"fetch": [0.0], "topk": [0.0], "resolve": [0.0]}
    log = {"topk": [], "prewarm": [], "stats": [], "metric": [],
           "results": []}
    table = lim.table
    counts_fn, topk_fn = table.insight_counts, table.insight_topk
    table.insight_counts = timed_sync(counts_fn, split["fetch"])
    timed_topk = timed_sync(topk_fn, split["topk"])

    def topk(k):
        out = timed_topk(k)
        log["topk"].append([out[0].tolist(), out[1].tolist()])
        return out

    table.insight_topk = topk
    tier._resolver.keys_for = timed_sync(tier._resolver.keys_for,
                                         split["resolve"])
    prewarm_fn = front.prewarm

    def prewarm(keys):
        keys = list(keys)
        n = prewarm_fn(keys)
        log["prewarm"].append((keys, n))
        return n

    front.prewarm = prewarm
    torch.cuda.synchronize()
    fused.LAUNCHES = 0
    polls = []
    for frames, now in frame_windows:
        results = lim.dispatch_wire_window(frames, now,
                                           collect_cur=True).fetch()
        log["results"].append(results)
        observe_frames(front, frames, results, now)
        t = time.perf_counter()
        if not tier.maybe_poll(now):
            raise AssertionError("the insight poll was not due")
        polls.append({"ms": (time.perf_counter() - t) * 1e3,
                      **drain_ms(split)})
        log["stats"].append(tier.stats_json(state="ok"))
        log["metric"].append(tier.metric_stats())
    torch.cuda.synchronize()
    launches = fused.LAUNCHES
    decay_s = [0.0]
    timed_sync(table.insight_decay, decay_s)()
    decay_ms = decay_s[0] * 1e3
    log["ins_counts"] = table.insight_counts()
    log["sketch"] = tier.sketch.top_with_error(4096)
    log["concentration"] = front.admission.hot_concentration
    log["cache_order"] = list(front.deny_cache._entries)
    log["column"] = [a.tolist() for a in topk_fn(64)]
    return {"log": log, "polls": polls, "decay_ms": decay_ms,
            "launches": launches, "tier": tier, "limiter": lim}


def compare_insight(got, want):
    """Phase 12's cuda run's log against its cpu run's, field by field."""
    import numpy as np

    for w, (a, b) in enumerate(zip(got["results"], want["results"])):
        assert_same_results([a], [b])
        for j, (ra, rb) in enumerate(zip(a, b)):
            same = (ra.cur_ns is None and rb.cur_ns is None) or (
                ra.cur_ns is not None and rb.cur_ns is not None
                and np.array_equal(ra.cur_ns, rb.cur_ns))
            if not same:
                raise AssertionError(f"window {w} batch {j}: cur_ns differs")
    for name in ("topk", "prewarm", "stats", "metric", "ins_counts",
                 "sketch", "concentration", "cache_order", "column"):
        if got[name] != want[name]:
            raise AssertionError(f"phase 12: {name} differs from the cpu run")


def time_insight_widths(on, rng, start):
    """dispatch_wire_window on the W=6 limiter `on` and a fresh W=4 one
    holding the same keys, window by window alternately; decisions/s of
    each over the windows after its first."""
    import torch

    from throttlecrab_tpu_torch.tpu.limiter import TorchRateLimiter

    off = TorchRateLimiter(capacity=CAPACITY, keymap="native")
    populate_config3(off, N_KEYS, T0)
    frames = stamped_frames(rng, RATE_WINDOWS, start)
    seconds = {6: [], 4: []}
    for window, now in frames:
        for width, lim in ((6, on), (4, off)):
            torch.cuda.synchronize()
            t = time.perf_counter()
            lim.dispatch_wire_window(window, now).fetch()
            seconds[width].append(time.perf_counter() - t)
    del off
    return {w: K * B * (len(s) - 1) / sum(s[1:]) for w, s in seconds.items()}


def run_checkpoint(source, frame_windows, tmp, now0):
    """Phase 13: a Checkpointer over phase 12's 1M-key cuda limiter writes
    a base, then a delta after each DELTA_WINDOWS windows (twice), under a
    limiter lock as the serving drivers hold it; recover_into a fresh cuda
    limiter and a cpu one; the next window decides identically on all
    three; then a torn delta (snapshot:truncate) and a recovery that falls
    back exactly one generation.  Returns the per-generation record."""
    import torch

    from throttlecrab_tpu_torch import faults
    from throttlecrab_tpu_torch.persist import (
        MANIFEST_NAME,
        Checkpointer,
        recover_into,
    )
    from throttlecrab_tpu_torch.persist import checkpoint as ck_mod
    from throttlecrab_tpu_torch.persist import format as fmt_mod
    from throttlecrab_tpu_torch.tpu import row_ops
    from throttlecrab_tpu_torch.tpu.limiter import TorchRateLimiter

    split = {name: [0.0] for name in ("export", "encode", "write", "fsync")}
    saved = (ck_mod.export_snapshot_payload, ck_mod.encode_checkpoint,
             ck_mod.write_file_durable, fmt_mod.fsync_with_faults)
    ck_mod.export_snapshot_payload = timed_sync(saved[0], split["export"])
    ck_mod.encode_checkpoint = timed_sync(saved[1], split["encode"])
    ck_mod.write_file_durable = timed_sync(saved[2], split["write"])
    fmt_mod.fsync_with_faults = timed_sync(saved[3], split["fsync"])
    lock = threading.Lock()
    ck = Checkpointer(source, tmp, interval_ns=1)
    gens = []
    per_gather = row_ops.MAX_BATCH

    def generation(now):
        torch.cuda.synchronize()
        row_ops.GATHER_LAUNCHES = 0
        rows = ck.checkpoint_now(now, lock=lock)
        torch.cuda.synchronize()
        live = len(source)
        if row_ops.GATHER_LAUNCHES != -(-live // per_gather):
            raise AssertionError(
                f"generation {ck.last_generation}: {row_ops.GATHER_LAUNCHES}"
                f" row_gather launches for {live} live keys")
        ms = drain_ms(split)
        gens.append({"generation": ck.last_generation, "rows": rows,
                     "row_gather": row_ops.GATHER_LAUNCHES,
                     "bytes": ck.last_bytes, **ms})

    def decide(windows):
        for frames, now in windows:
            source.dispatch_wire_window(frames, now).fetch()
            ck.note_keys(frame_keys(frames))
        return now

    try:
        generation(now0)
        now = now0
        for d in range(2):
            now = decide(frame_windows[d * DELTA_WINDOWS:
                                       (d + 1) * DELTA_WINDOWS])
            generation(now)
        # Recovery restores the rows still live at its `now` (the chain's
        # TTL sweep); the source holds its lapsed ones until a sweep.
        want = {k: v for k, v in keyed_state(source).items() if v[1] > now}
        restored = TorchRateLimiter(capacity=CAPACITY, keymap="native",
                                    insight=True)
        torch.cuda.synchronize()
        row_ops.SCATTER_LAUNCHES = 0
        t = time.perf_counter()
        res = recover_into(restored, tmp, now)
        torch.cuda.synchronize()
        recovery_ms = (time.perf_counter() - t) * 1e3
        scatters = row_ops.SCATTER_LAUNCHES
        if scatters != -(-res.restored // per_gather):
            raise AssertionError(f"{scatters} row_scatter launches for "
                                 f"{res.restored} restored keys")
        on_cpu = TorchRateLimiter(capacity=CAPACITY, keymap="native",
                                  insight=True, device="cpu")
        t = time.perf_counter()
        res_cpu = recover_into(on_cpu, tmp, now)
        cpu_recovery_ms = (time.perf_counter() - t) * 1e3
        if (res.chain, res.restored) != (res_cpu.chain, res_cpu.restored) or (
                res.chain != [0, 1, 2]):
            raise AssertionError(f"recoveries differ: {res} / {res_cpu}")
        for name, lim in (("cuda", restored), ("cpu", on_cpu)):
            if keyed_state(lim) != want:
                raise AssertionError(f"the {name} recovery's per-key state "
                                     "differs from the source's")
        if certificates(restored) != certificates(on_cpu):
            raise AssertionError(
                f"certificates differ: cuda {certificates(restored)}, cpu "
                f"{certificates(on_cpu)}")
        frames, next_now = frame_windows[2 * DELTA_WINDOWS]
        outs = [lim.dispatch_wire_window(frames, next_now).fetch()
                for lim in (source, restored, on_cpu)]
        assert_same_results([outs[1]], [outs[0]])
        assert_same_results([outs[2]], [outs[0]])
        del on_cpu
        # A torn newest delta: the writer raises, the torn file stands
        # under its final name; without the manifest's hint the scan meets
        # it and falls back exactly one generation.
        ck.note_keys(frame_keys(frames))
        faults.arm(faults.FaultInjector(
            faults.parse_spec("snapshot:truncate:0.5")))
        try:
            ck.checkpoint_now(next_now, lock=lock)
        except OSError:
            pass
        else:
            raise AssertionError("the truncate fault did not tear the write")
        finally:
            faults.disarm()
        drain_ms(split)
        os.remove(os.path.join(tmp, MANIFEST_NAME))
        fallback = TorchRateLimiter(capacity=CAPACITY, keymap="native",
                                    insight=True)
        res_torn = recover_into(fallback, tmp, now)
        if (res_torn.generation, res_torn.corrupt_skipped,
                res_torn.restored) != (res.generation, 1, res.restored):
            raise AssertionError(f"torn-delta recovery: {res_torn}")
    finally:
        (ck_mod.export_snapshot_payload, ck_mod.encode_checkpoint,
         ck_mod.write_file_durable, fmt_mod.fsync_with_faults) = saved
    return {"generations": gens, "restored": res.restored,
            "row_scatter": scatters, "recovery_ms": recovery_ms,
            "cpu_recovery_ms": cpu_recovery_ms,
            "torn_fallback_generation": res_torn.generation}


def build_kernels():
    """Phase 1's builds: one nvcc per kernel source, all started together
    (threads wait on the compilers); {library: (path, seconds)}."""
    from throttlecrab_tpu_torch.tpu import fused, row_ops

    built, errors = {}, []

    def run(name, build):
        t = time.perf_counter()
        try:
            built[name] = (build(), time.perf_counter() - t)
        except Exception as e:  # re-raised in the main thread
            errors.append(e)

    threads = [threading.Thread(target=run, args=a) for a in (
        ("fused_window", fused.build), ("row_ops", row_ops.build))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    return built


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False — this "
              "smoke test needs a CUDA card", file=sys.stderr)
        return 2
    import numpy as np

    from throttlecrab_tpu_torch.tpu import fused, row_ops
    from throttlecrab_tpu_torch.tpu.limiter import TorchRateLimiter

    device = torch.device("cuda")
    card = card_line()
    print(f"[1] card: {card}")
    ptxas = {}
    for name, (lib, sec) in build_kernels().items():
        print(f"[1] built {lib.name} in {sec:.1f} s (0 when this checkout "
              "had built it already)")
        ptxas[name] = ptxas_summary(lib.with_suffix(".log").read_text())
        check_ptxas(name, ptxas[name], FUSED_THREADS)
    if len(ptxas["fused_window"]) != 12:
        raise AssertionError(f"{len(ptxas['fused_window'])} decision-window "
                             "instantiations built, expected 12")

    print(f"[2] kernel vs plain on the card: K={K} B={B} "
          f"N={CAPACITY + (1 << 16)}, then cross-block windows at "
          f"B={CROSS_BLOCK_B}")
    worst = compare_kernel_plain(device, K, B, CAPACITY)
    for seed, b in enumerate(CROSS_BLOCK_B, 1):
        worst = max(worst, compare_kernel_plain(device, K, b, CAPACITY,
                                                seed=seed, cross=True))

    print("[3] serving path: TorchRateLimiter(capacity=2^20) on cuda, "
          "BASELINE config 3 traffic")
    rng = np.random.default_rng(3)
    n_windows, probe_window = 10, 9
    windows = config3_windows(rng, N_KEYS, n_windows, K, B, probe_window)
    limiter = TorchRateLimiter(capacity=CAPACITY)
    fused.LAUNCHES = 0
    got, seconds = run_main_path(limiter, windows)
    freed = limiter.sweep(windows[-1][-1][-1] + 3600 * NS)
    torch.cuda.synchronize()
    launches = fused.LAUNCHES
    if launches == 0:
        raise AssertionError("the serving path never launched the kernel")
    if not limiter.table.state.is_cuda:
        raise AssertionError("the table left the card")
    decisions = sum(len(b[0]) for w in windows for b in w)
    steady = seconds[1:probe_window]
    rate = K * B * len(steady) / sum(steady)
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
    del limiter, ref

    for backend in ("python", "native"):
        print(f"[4] server on cuda, --http --redis on the {backend} "
              f"transports, {' '.join(SERVER_FLAGS)} --snapshot-path")
        with tempfile.TemporaryDirectory() as tmp:
            check_server(backend, f"{tmp}/state")
            if backend == "native":
                check_checkpoint_restart(backend, f"{tmp}/chain")
            check_control_trace(backend, f"{tmp}/traces")

    print("[5] row kernels vs plain on the card: "
          f"N={BYID_CAPACITY + (1 << 16)} B={B} W=4,6")
    row_worst = compare_row_kernels(device, np.random.default_rng(4))

    print(f"[6] by-id path: TorchRateLimiter(capacity=2^21, keymap='native')"
          f" on cuda, {N_KEYS} keys, config 3 params, K={BYID_K} B={B}")
    keys, em, tol = config3_params(N_KEYS)
    plan = byid_plan(np.random.default_rng(6), N_KEYS)
    fused.LAUNCHES = 0
    row_ops.GATHER_LAUNCHES = row_ops.SCATTER_LAUNCHES = 0
    lim_g, rows_g, wires_g, valids, sec_g, split_g = run_byid(
        device, keys, em, tol, plan)
    torch.cuda.synchronize()
    byid_launches = fused.LAUNCHES
    byid_row_launches = {"row_gather": row_ops.GATHER_LAUNCHES,
                         "row_scatter": row_ops.SCATTER_LAUNCHES}
    if byid_launches != len(plan) or any(byid_row_launches.values()):
        raise AssertionError(
            f"{byid_launches} decision-window launches and row launches "
            f"{byid_row_launches} for {len(plan)} by-id windows; expected "
            "one window launch per window and no row launch")
    if not lim_g.table.state.is_cuda:
        raise AssertionError("the by-id table left the card")
    print(f"  {len(plan)} windows ({[v for v, _ in plan]}): "
          f"{byid_launches} decision-window launches, row launches "
          f"{byid_row_launches}")
    print("  seconds per window: " + ", ".join(f"{x:.3f}" for x in sec_g))
    print("  ms per window, prep+launch+fetch+finish: " + ", ".join(
        "+".join(f"{x * 1e3:.1f}" for x in sp) for sp in split_g))
    lim_c, _, wires_c, _, sec_c, _ = run_byid("cpu", keys, em, tol, plan)
    for w, (a, b, v) in enumerate(zip(wires_g, wires_c, valids)):
        if not np.array_equal(a[v], b[v]):
            raise AssertionError(f"by-id window {w} ({plan[w][0]}) differs "
                                 "from the cpu replay")
    if not torch.equal(lim_g.table.state[:BYID_CAPACITY].cpu(),
                       lim_c.table.state[:BYID_CAPACITY]):
        raise AssertionError("by-id table state differs from the cpu replay")
    if lim_g.table.expired_hits() != lim_c.table.expired_hits():
        raise AssertionError("by-id expired-hit counts differ")
    byid_rate = byid_rates(plan, sec_g)
    byid_split = {
        part: float(np.median([sp[i] for sp in split_g[1:]]) * 1e3)
        for i, part in enumerate(("prep", "launch", "fetch", "finish"))
    }
    print("  identical to the device='cpu' replay (wire values, state, "
          "expired hits)")
    del lim_c
    composed_launches = composed_scan_check(lim_g, rows_g)
    print("  one more ids window: the composed scan (row kernels, "
          f"{composed_launches}) on a copy of the table decides as the "
          "window kernel (outputs, state, expired hits)")
    byid_profile, profiled_ids = profile_byid_window(lim_g, keys, em, tol)
    byid_bound, byid_rows = byid_bound_ms(profiled_ids, 8)
    byid_kernel_bound = bound_ms(BYID_K, B, 8, byid_rows)
    print(f"  one more ids window under the profiler: {byid_profile}; "
          f"{byid_rows} distinct ids; bound {byid_bound:.6f} ms for the "
          f"window, {byid_kernel_bound:.6f} ms for its window kernel")
    print("  decisions/s (host clock, windows after each variant's first): "
          + ", ".join(f"{v} {r:.0f}" for v, r in byid_rate.items())
          + " on cuda; cpu replay " + ", ".join(
              f"{v} {r:.0f}" for v, r in byid_rates(plan, sec_c).items())
          + f"; median ms per window on cuda {byid_split} ({card})")
    del lim_g

    print("[7] dispatch_wire_window: phase 3's traffic as native frames")
    frame_windows = wire_frames(windows)
    wire_lim = TorchRateLimiter(capacity=CAPACITY, keymap="native")
    fused.LAUNCHES = 0
    wire_got, wire_sec = run_wire(wire_lim, frame_windows)
    torch.cuda.synchronize()
    wire_launches = fused.LAUNCHES
    if wire_launches == 0:
        raise AssertionError("dispatch_wire_window never launched the kernel")
    wire_steady = wire_sec[1:probe_window]
    wire_rate = K * B * len(wire_steady) / sum(wire_steady)
    wire_ref = TorchRateLimiter(capacity=CAPACITY, keymap="native",
                                device="cpu")
    wire_want, _ = run_wire(wire_ref, frame_windows)
    assert_same_results(wire_got, wire_want)
    if not torch.equal(wire_lim.table.state[:CAPACITY].cpu(),
                       wire_ref.table.state[:CAPACITY]):
        raise AssertionError("wire-window state differs from the cpu replay")
    print(f"  identical to the device='cpu' replay; {wire_launches} kernel "
          f"windows; {wire_rate:.0f} decisions/s over {len(wire_steady)} "
          f"steady windows vs dispatch_many {rate:.0f} (phase 3) ({card})")
    _frames, now = frame_windows[1]
    wire_profile = summarize_profile(*profile_device(
        lambda: wire_lim.dispatch_wire_window(_frames, now + NS).fetch()))
    print(f"  one more window under the profiler: {wire_profile} "
          f"({wire_profile.get('kernels')} kernels, idle share "
          f"{wire_profile.get('idle_share')})")
    del wire_lim, wire_ref

    print(f"[8] times ({card})")
    times = time_kernel(device, np.random.default_rng(5))
    for width, t in times.items():
        print(f"  fused_window W={width}: kernel {t['ms']:.4f} ms, plain "
              f"{t['plain_ms']:.4f} ms, bound "
              f"{bound_ms(K, B, 4, t['rows']):.5f} ms "
              f"per K={K} w32 window (CUDA-event medians); device time "
              f"(profiler) kernel {t['device_ms']} ms in "
              f"{t['kernels_per_call']} kernel per call, plain "
              f"{t['plain_device_ms']} ms; wrapper host time "
              f"{t['host_us']:.1f} µs per call")
    row_times = time_row_kernels(device, np.random.default_rng(8))
    for (name, w), t in row_times.items():
        print(f"  {name} W={w}: kernel {t['kernel']:.5f} ms, plain "
              f"{t['plain']:.5f} ms, library {t['library']:.5f} ms, bound "
              f"{row_bound_ms(B, w):.6f} ms per launch at B={B} (medians); "
              f"device time (profiler) kernel {t['device_kernel']} ms, "
              f"plain {t['device_plain']} ms, library "
              f"{t['device_library']} ms; host time per call kernel "
              f"{t['host_us_kernel']:.1f} µs, library "
              f"{t['host_us_library']:.1f} µs")

    print(f"[9] native RESP server: NativeRedisTransport over "
          f"TorchRateLimiter(capacity=2^20, keymap='native') on cuda, "
          f"batch {B}, max_scan_depth {K}, {RESP_CONNS} client processes")
    resp = run_native_resp(card, wire_rate)

    print(f"[10] snapshot at full size: save and restore {N_KEYS} config-3 "
          f"keys through the row kernels, python and native keymaps "
          f"({card})")
    snap_launches = {"row_gather": 0, "row_scatter": 0}
    snap_err = {"row_gather": 0, "row_scatter": 0}
    snap_ms = {}
    with tempfile.TemporaryDirectory() as tmp:
        for keymap in ("python", "native"):
            counts, err, split = run_snapshot(keymap, windows, tmp)
            for name in snap_launches:
                snap_launches[name] += counts[name]
                snap_err[name] = max(snap_err[name], err[name])
            snap_ms[keymap] = split
    snap_b = row_ops.MAX_BATCH
    snap_times = time_row_kernels(device, np.random.default_rng(10), b=snap_b,
                                  n=CAPACITY + (1 << 16))
    for (name, w), t in snap_times.items():
        print(f"  {name} W={w}: kernel {t['kernel']:.5f} ms, plain "
              f"{t['plain']:.5f} ms, library {t['library']:.5f} ms, bound "
              f"{row_bound_ms(snap_b, w):.6f} ms per launch at B={snap_b} "
              f"(medians); device time (profiler) kernel "
              f"{t['device_kernel']} ms, plain {t['device_plain']} ms, "
              f"library {t['device_library']} ms; host time per call "
              f"kernel {t['host_us_kernel']:.1f} µs, library "
              f"{t['host_us_library']:.1f} µs")

    print(f"[11a] failure domain at full width: SupervisedLimiter over "
          f"TorchRateLimiter(capacity=2^20) on cuda, {N_KEYS} config-3 "
          f"keys, K={K} B={B}; launch and fetch faults, a degrade to the "
          f"host oracle and a re-promotion ({card})")
    drill = run_drill(card)
    print(f"[11b] front tier over native RESP: phase 9's harness with the "
          f"default deny cache and admission, {FRONT_WINDOWS_OF_B * B} "
          f"config-3 THROTTLEs, and the same without a front tier, "
          f"alternately ({card})")
    front_resp = run_front_resp(card, resp["resp_replies_per_s"])

    print(f"[12] insight tier at full width: TorchRateLimiter(capacity=2^20,"
          f" keymap='native', insight=True) on cuda, {N_KEYS} config-3 keys, "
          f"a default FrontTier and InsightTier; {INSIGHT_WINDOWS} windows "
          f"of K={K} x B={B} through dispatch_wire_window, a poll after "
          f"each, one decay; against the same on device='cpu' ({card})")
    start = T0 + 10 * NS
    ins_frames = stamped_frames(np.random.default_rng(12), INSIGHT_WINDOWS,
                                start)
    t = time.perf_counter()
    ins_cuda = run_insight("cuda", ins_frames)
    ins_cuda_s = time.perf_counter() - t
    if ins_cuda["tier"].poll_failures != 0:
        raise AssertionError(f"{ins_cuda['tier'].poll_failures} insight poll "
                             "failures on the card")
    if ins_cuda["launches"] != INSIGHT_WINDOWS:
        raise AssertionError(f"{ins_cuda['launches']} window launches for "
                             f"{INSIGHT_WINDOWS} insight windows")
    if ins_cuda["limiter"].table.state.shape[-1] != 6:
        raise AssertionError("the insight table is not 6 wide")
    t = time.perf_counter()
    ins_cpu = run_insight("cpu", ins_frames)
    ins_cpu_s = time.perf_counter() - t
    compare_insight(ins_cuda["log"], ins_cpu["log"])
    del ins_cpu
    log = ins_cuda["log"]
    tier = ins_cuda["tier"]
    poll_split = {
        part: float(np.median([p.get(part, 0.0) for p in
                               ins_cuda["polls"][1:]]))
        for part in ("ms", "fetch", "topk", "resolve")
    }
    print(f"  {INSIGHT_WINDOWS} windows, {ins_cuda['launches']} W=6 window "
          f"launches, {tier.polls} polls, 0 failures; ins_counts "
          f"{log['ins_counts']}; top-K, sketch ({len(tier.sketch)} keys), "
          f"stats_json, metric_stats, prewarmed keys "
          f"({sum(n for _, n in log['prewarm'])} refreshed over "
          f"{len(log['prewarm'])} polls), concentration "
          f"{log['concentration']:.6f}, wire fields and cur: identical to "
          f"the cpu run")
    print(f"  poll ms (median after the first; fetch = totals, topk = top-K"
          f" on the card, resolve = slot->key): {poll_split}; the first "
          f"poll {ins_cuda['polls'][0]}; decay "
          f"{ins_cuda['decay_ms']:.3f} ms; run {ins_cuda_s:.1f} s on cuda, "
          f"{ins_cpu_s:.1f} s on cpu ({card})")
    width_rates = time_insight_widths(
        ins_cuda["limiter"], np.random.default_rng(120),
        start + INSIGHT_WINDOWS * POLL_STEP_NS)
    print(f"  dispatch_wire_window decisions/s, alternately: W=6 (insight) "
          f"{width_rates[6]:.0f}, W=4 {width_rates[4]:.0f} over "
          f"{RATE_WINDOWS - 1} windows each ({card})")

    print(f"[13] checkpoint and recovery at {N_KEYS} keys: a Checkpointer "
          f"over phase 12's cuda limiter writes a base, then a delta after "
          f"each {DELTA_WINDOWS} windows (twice); recover_into fresh cuda "
          f"and cpu limiters; a torn delta ({card})")
    ck_start = start + (INSIGHT_WINDOWS + RATE_WINDOWS) * POLL_STEP_NS
    ck_frames = stamped_frames(np.random.default_rng(13),
                               2 * DELTA_WINDOWS + 1, ck_start)
    with tempfile.TemporaryDirectory() as tmp:
        t = time.perf_counter()
        chain = run_checkpoint(ins_cuda["limiter"], ck_frames, tmp,
                               ck_start - POLL_STEP_NS)
        chain_s = time.perf_counter() - t
    ins_launches = ins_cuda["launches"]
    first_poll = ins_cuda["polls"][0]
    insight_decay_ms = ins_cuda["decay_ms"]
    del ins_cuda
    for g in chain["generations"]:
        print("  generation {generation}: {rows} rows, {bytes} bytes, "
              "{row_gather} row_gather launches; ms export (under the lock)"
              " {export:.1f}, encode {encode:.1f}, write {write:.1f} (of "
              "it fsync {fsync:.1f})".format(**g))
    print(f"  recovered {chain['restored']} keys (chain [0, 1, 2]) with "
          f"{chain['row_scatter']} row_scatter launches in "
          f"{chain['recovery_ms']:.1f} ms on cuda, "
          f"{chain['cpu_recovery_ms']:.1f} ms on cpu; per-key state equals "
          f"the source and the cpu recovery, certificates equal; the next "
          f"window decides identically on all three; after a torn delta "
          f"the recovery falls back to generation "
          f"{chain['torn_fallback_generation']}; phase {chain_s:.1f} s "
          f"({card})")

    print(f"[14] record, replay and control at full width: phase 9's "
          f"{RESP_WINDOWS * K * B} commands through a native transport over "
          f"TorchRateLimiter(capacity=2^20, keymap='native', insight=True) "
          f"on cuda with the default tiers, a full-mode flight recorder and "
          f"a control plane (both, 100 ms); the trace replayed on cuda, cpu "
          f"and the oracle; rank ({card})")
    record = run_record_replay(card, resp["resp_replies_per_s"])

    print(f"card: {card_line()}")
    kernels = [{
        "name": "fused_window",
        "route": "cuda",
        "source": "throttlecrab_tpu_torch/csrc/fused_window.cu",
        "replaces": "throttlecrab_tpu/tpu/pallas_fused.py:656",
        "launches": launches,
        "max_abs_err": worst,
        "ms": times[4]["ms"],
        "plain_ms": times[4]["plain_ms"],
        "bound_ms": bound_ms(K, B, 4, times[4]["rows"]),
        "bound_by": "bytes",
        "library_ms": None,
        "identical": worst == 0,
        "shape": f"K={K} B={B} W=4 w32",
        "w6_ms": times[6]["ms"],
        "w6_plain_ms": times[6]["plain_ms"],
        "w6_bound_ms": bound_ms(K, B, 4, times[6]["rows"]),
        "device_ms": times[4]["device_ms"],
        "plain_device_ms": times[4]["plain_device_ms"],
        "w6_device_ms": times[6]["device_ms"],
        "kernels_per_call": times[4]["kernels_per_call"],
        "w6_kernels_per_call": times[6]["kernels_per_call"],
        "launch_api_per_call": times[4]["launch_api_per_call"],
        "host_us_per_call": times[4]["host_us"],
        "ptxas": {k: v[0] for k, v in ptxas["fused_window"].items()},
        "cross_block_b": list(CROSS_BLOCK_B),
        "main_path_decisions_per_s": rate,
        "wire_window_launches": wire_launches,
        "wire_window_decisions_per_s": wire_rate,
        "wire_window_profile": wire_profile,
        "byid_window_launches": byid_launches,
        "byid_windows": len(plan),
        "byid_shape": f"K={BYID_K} B={B} W=4 cur/w32",
        "byid_distinct_ids": byid_rows,
        "byid_bound_ms": byid_bound,
        "byid_kernel_bound_ms": byid_kernel_bound,
        "byid_decisions_per_s": byid_rate,
        "byid_window_ms": byid_split,
        "byid_window_profile": byid_profile,
        **resp,
        "supervisor_probe_launches": drill["probe_window_launches"],
        "supervisor_drill": drill,
        **front_resp,
        "insight_window_launches": ins_launches,
        "insight_windows": INSIGHT_WINDOWS,
        "insight_w6_decisions_per_s": width_rates[6],
        "insight_w4_decisions_per_s": width_rates[4],
        "insight_poll_ms": poll_split,
        "insight_first_poll_ms": first_poll,
        "insight_decay_ms": insight_decay_ms,
        **record,
        "card": card,
    }]
    for name, replaces in (("row_gather", "pallas_ops.py:128"),
                           ("row_scatter", "pallas_ops.py:162")):
        t4, t6 = snap_times[(name, 4)], snap_times[(name, 6)]
        b4, b6 = row_times[(name, 4)], row_times[(name, 6)]
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": "throttlecrab_tpu_torch/csrc/row_ops.cu",
            "replaces": f"throttlecrab_tpu/tpu/{replaces}",
            "path": "snapshot " + ("save (export)" if name == "row_gather"
                                   else "restore (bulk insert)")
                    + ", phase 10, python and native keymaps",
            "launches": snap_launches[name],
            "max_abs_err": max(snap_err[name], row_worst[name]),
            "ms": t4["kernel"],
            "plain_ms": t4["plain"],
            "bound_ms": row_bound_ms(snap_b, 4),
            "bound_by": "bytes",
            "library_ms": t4["library"],
            "identical": snap_err[name] == row_worst[name] == 0,
            "shape": f"B={snap_b} W=4 N={CAPACITY + (1 << 16)} per launch",
            "w6_ms": t6["kernel"],
            "w6_plain_ms": t6["plain"],
            "w6_library_ms": t6["library"],
            "w6_bound_ms": row_bound_ms(snap_b, 6),
            "device_ms": t4["device_kernel"],
            "plain_device_ms": t4["device_plain"],
            "library_device_ms": t4["device_library"],
            "w6_device_ms": t6["device_kernel"],
            "host_us_per_call": t4["host_us_kernel"],
            "library_host_us_per_call": t4["host_us_library"],
            "snapshot_ms": snap_ms,
            "composed_scan_launches": composed_launches[name],
            "supervisor_path": "degrade export (phase 11a)"
                               if name == "row_gather" else
                               "re-promotion bulk insert (phase 11a)",
            "supervisor_launches": drill[
                "degrade_row_gather_launches" if name == "row_gather"
                else "repromote_row_scatter_launches"],
            "checkpoint_path": "checkpoint generations (phase 13)"
                               if name == "row_gather" else
                               "checkpoint recovery (phase 13)",
            "checkpoint_launches": (
                [g["row_gather"] for g in chain["generations"]]
                if name == "row_gather" else chain["row_scatter"]),
            "checkpoint_ms": chain,
            "b4096": {
                "ms": b4["kernel"], "plain_ms": b4["plain"],
                "library_ms": b4["library"],
                "bound_ms": row_bound_ms(B, 4),
                "device_ms": b4["device_kernel"],
                "library_device_ms": b4["device_library"],
                "w6_ms": b6["kernel"], "w6_device_ms": b6["device_kernel"],
                "host_us_per_call": b4["host_us_kernel"],
                "shape": f"B={B} W=4 N={BYID_CAPACITY + (1 << 16)}",
            },
            "card": card,
        })
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
