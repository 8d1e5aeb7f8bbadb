#!/usr/bin/env python3
"""Smoke test of the PyTorch/H100 port on one CUDA card.

    python3 chip_smoke.py

Twenty phases, each printing its results; any failure raises and the
script exits nonzero without its last line:

1. card: the card's name and power limit (nvidia-smi), and the builds of
   the kernel libraries from csrc/ (one nvcc per source, started
   together, timed: the decision window, the row kernels and the by-id
   front end), with ptxas's registers/stack/spills per kernel;
2. kernel vs plain: the decision-window kernel (tpu/fused.py) against its
   plain torch version (tpu/kernel.py) on the card, at the serving N
   (2^20 + 2^16 rows) for all 12 kernel instantiations (row widths 4
   and 6 x six output tiers): at K = 16 sub-batches of B = 4096 on two
   consecutive hostile windows — duplicates, degenerate lanes, invalid
   lanes, edge-valued tolerances — then on cross-block windows at B =
   4096, 1, 4097 and 65536 (one slot over every lane of every sub-batch;
   one slot at lanes 0 and B-1 of every sub-batch), then on the one-block
   schedule at K = 64 x B = 256: two hostile windows, and two in which
   every sub-batch takes the slots of the one before in another order
   (256 distinct slots; 256 lanes over 128 slots).  Tolerance: exact
   equality (integer math) on valid-lane outputs, real-slot state,
   expired-hit counts and insight totals.  fused.BLOCK_LAUNCHES, zeroed
   just before, must equal the windows of B <= 256, and the device's
   forwarded-lane count must move by the count the packed rows give;
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
   against their plain versions (index_select / index_copy_) at N =
   2^21 + 2^16, W = 4 and 6, at the edge batches B = 1, 2, 255, 256,
   257, 4096, 42,240 and 42,241 (where the W=6 scatter goes to two rows
   a lane), one row short of the last whole block below 65,536 of the
   tile the largest batches pick, at it and past it, 65,535 and 65,536,
   with the scatter's rows on a 16-byte boundary (and at W=6 also 8
   bytes off it) and the first index even and odd; at B = 65,536 with
   rows 0 and N-1; and with indices -1, N and 2^31-1 at the first, a
   middle and the last of 4,097 rows (a zero row, a dropped write).
   Tolerance: exact equality;
6. by-id launch path at bench.py's shape: TorchRateLimiter(capacity=2^21,
   keymap="native") on cuda, 1M interned keys with config-3 per-key
   params, every key populated once, then Zipf-1.1 windows of K = 64 x
   B = 4096 through check_many_byid (host words + finish_ids),
   check_many_ids (finish_raw) and check_many_ids20 (w32 + finish_w32);
   the counters, zeroed just before, must count exactly one
   decision-window launch per window and no row-kernel launch, and one
   front-end kernel launch (tpu/ids_front.py) per window of raw ids
   (populate, ids, ids20) and no window of plain front-end ops, and the
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
   kernel's and its plain version's time per window at K=16, B=4096
   (the cluster schedule) and K=16, B=256 (the one-block schedule), W=4
   and W=6 in the w32 tier (CUDA events, the profiler's device time and
   its kernel records per call, which must all be the window kernel of
   the batch's schedule and at most one per call, and the wrapper's host
   time per call), and
   each row kernel's, its plain version's and the library call's time
   per launch at B=4096 (CUDA events; profiler device time with L2 warm,
   and with L2 cold, 128 MB read before each launch, for kernel and
   library call; host time per call), each beside its share of
   row_bound_ms and the sector-counted bound; then the by-id front end
   (tools/probe_ids_front.py) at both benchmark cells' shapes (c2: K=4,096
   x B=256 over 10,000 uniform keys; c3: K=1,024 x B=4,096 over 1M
   Zipf-1.1 keys), the kernel and its plain version (kernel.ids_window's
   torch ops) on the card in alternating processes of their own (kernel,
   plain, plain, kernel a shape): device ms a window (profiler) and CUDA
   events, beside the bound (ids, id-row sectors and packed rows at the
   HBM rate), each kernel run's first window equal to the plain one's;
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
   launch at B = 65,536, W = 4 and 6, warm and cold as in phase 8,
   beside the bounds;
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
   ticks, actuations, ms per tick and the top three policies;
15. the mesh at BASELINE config 5's width: ShardedTorchRateLimiter over
   make_mesh(devices=[cuda:0] * 8) (8 shards as slices of the card, as
   the v5e-8 has 8 devices), 2^20 slots per shard, native keymaps,
   insight rows, a 65-id tenant registry; 64 tenants x 100,000 keys
   (b"t{i}:k{j}", config 3's per-key params) every key once, then 4
   Zipf-1.1 windows, K = 16 x B = 4,096 through dispatch_many(wire=True),
   window by window beside TorchRateLimiter(capacity=2^23,
   keymap="native", insight=True) on cuda: identical results every
   window, identical insight totals, per-tenant counters summing to the
   totals, exactly 8 window launches per mesh window (counter zeroed
   before each) and no row launch, the mesh top-10's counts equal the
   single device's and each resolved key's count its single-device
   count.  Prints decisions/s, p50/p99 window ms and the host split
   (route, resolve, pack, launch, other prep, fetch) of both, and one
   profiled window of each.  Then a snapshot saved and loaded on the
   mesh (row_gather / row_scatter launches per shard = ceil(n_d /
   65,536), every key back on its shard with its tat/expiry), one
   checkpoint generation (gathers per shard) recovered onto a 1-shard
   and an 8-shard mesh (scatters per shard, state equal).  The quota: a
   fresh mesh with tenant affinity and quota 0.125 takes the same
   population; t0 sprays 50,000 fresh keys among the other tenants'
   Zipf traffic and 256 lanes a batch of its own existing keys: status 5
   on exactly the fresh keys past its quota (131,072 - 100,000 slots
   of headroom), nowhere else, counted by tenant_stats, no growth; the
   first spray window on CPU shards loaded from the mesh's export gives
   identical results.  The server with --shards beyond the card count
   exits nonzero with make_mesh's message, --shards 1 --pallas-fused
   boots and answers; phase 14's trace replays through sharded:1 on
   cuda and sharded:8 on cpu with 0 mismatches;
16. the cluster (parallel/cluster.py): (a) three in-process nodes, each
   TorchRateLimiter(capacity=2^20, keymap="native", insight=True) on the
   card under ClusterLimiter(vnodes=128, replicate=True) with its
   ClusterServer on its own event-loop thread, take 48 config-3 batches
   of 4,096 round robin over the three frontends beside one
   TorchRateLimiter(capacity=2^20) given the same batches: identical
   results and statuses batch by batch, and window launches (the
   counter read around each cluster call) equal to the sub-batches the
   owners decided (each node's limiter calls, one per owner per batch).
   Then node 2 is killed (its successors absorb their replica rows on
   first use: row_scatter), rejoins fresh (each peer's export_state:
   row_gather; the migrates installed: row_scatter) and node 1 leaves
   (its export, each receiver's reconcile export and insert), 12
   batches after each step: no client failure, every row outside the
   killed range equal to the single-device limiter's, an exhausted key
   of the killed range still denied, and row_gather / row_scatter
   launches equal to the sum of ceil(rows / 65,536) over the exports and
   inserts each step made.  Prints decisions/s through the cluster and
   on the single limiter, the median ms per batch, and per step the
   keys moved and ms.  (b) two `python -m throttlecrab_tpu_torch.server
   --cluster-nodes ... --redis-backend native` processes on the card: a
   key of node 1 is limited across both HTTP frontends, the harness
   (`python -m throttlecrab_tpu_torch.harness perf-test`) drives each
   node over RESP and HTTP with no error (replies/s, p50, p99),
   /health/cluster shows the epoch and the peer, /metrics counts
   forwards, SIGTERM on node 1 drains with a planned leave and exits 0,
   and node 0 continues that node's bucket.
17. the static invariant suite: `python -m throttlecrab_tpu_torch.analysis
   --strict --json` over this checkout in a subprocess (its twelve
   checkers over the port's Python, its CUDA sources in csrc/ and the
   shared native/*.cpp); prints the finding count, the waived count, the
   seconds per checker, the suite's and the phase's wall time beside the
   card, and whether it imported torch, numpy or jax.  Any unwaived
   finding, stale or violated waiver, heavy import or nonzero exit
   fails the run.
18. the tier-ladder campaign (tools/fuzz_wire_tiers.py) on the card
   against the scalar oracle RateLimiter(PeriodicStore()): (a) the JAX
   campaign's CI run, 24 seeds x 10 steps of benign, edges and hostile
   streams (w32-edge params, poison tolerances, quantity-0 probes, param
   churn, sweeps, clock regressions, a snapshot round trip) through
   dispatch_many on python and native keymaps, dispatch_wire_window, and
   a 2-shard mesh as two slices of the card; (b) seeds 3100 and 3101
   (the insight tier's 6-wide rows) beside a device="cpu" twin of each
   limiter, the card's kernel against the plain version, states equal
   after every window and handed across on alternate steps; (c) 24
   hot-key seeds through BatchingEngine with the deny cache on and off;
   (d) 6 seeds of each codec arm (host-only); (e) the wide arm at
   BASELINE config 3's width (2^20 slots, native keymap, 1M keys,
   Zipf-1.1, K = 16 x B = 4096, 12 windows, every third through the wire
   window, a mid-run snapshot round trip, then a fleet-wide limit change)
   for seeds 3000-3002.  Prints requests, windows, tier mix, window
   launches against windows decided on the card, row launches against
   rows moved and the oracle's seconds per arm, beside the card.  Any
   divergence, a tier never ridden, a window launch count off the windows
   decided, or row launches other than ceil(rows / 65,536) per round
   trip fails the run.
19. the drivers beside the package (tools/ and examples/): (a)
   tools/profile_launch.py at its default shape (K = 16 x B = 4096 on a
   2^21-slot table) with a torch.profiler trace, in a process of its own
   (a fresh CUDA context and profiler; its step-3 device time must not
   be null): ping, h2d of the 8
   request arrays and of the one packed buffer (pageable and pinned),
   the window's compute (host clock, CUDA events, profiler), d2h of the
   4-plane output (pageable and pinned), end to end and pipelined; its
   first window's output and table state must equal a device="cpu" run
   of the same payload; (b) the transfer probes (probe_async,
   probe_d2h, probe_duplex) at the JAX probes' sizes; (c) the 1-device
   mesh probe; (d) the replay gate (24 windows recorded through the
   BatchingEngine on the card, replayed twice and against the oracle);
   then, at once, (e) the control gate in a process of its own, (f) the
   transport driver, tools/run-transport-test.sh -t http and -t redis
   with --native -T 4 -r 200 --warm 64 (its fixed ports must be free; 0
   errors), and (g) every example but grpc_client (no grpcio on the
   card's machine) as a subprocess on the card, http_client against a
   server booted for it: exit 0 and the decision lines the CPU tests
   hold equal to the JAX examples'.  fused.LAUNCHES must move by exactly
   the windows (a)-(d) count themselves.
20. the ablation probes at the JAX scripts' sizes, each `python -m
   throttlecrab_tpu_torch.tools.<probe>` in a process of its own: probe_kernel_ablation (the body's four modes at cap 2^21, K = 64,
   B = 4096; capacity 2^16-2^21; K = 16-256; first fetches of 1-16 MB,
   pageable and pinned; the output-size pair; the window kernel in the
   w32 and 4-plane tiers), probe_byid_ablation (five modes and id rows 8
   and 5 wide at K = 256 x B = 4096 over 1M id rows and 2^21 slots, then
   the by-id front end and the window kernel), once on the plain row
   route and once with --row-kernels, and probe_packed_layout (row-major,
   field-major, unpacked and the window kernel at K = 64).  Each must
   exit 0 and print every JAX label with the card's device time beside
   it (none null; one profiler session a process, every call's records
   counted between marker kernels); with --check-cpu each arm's first
   scan (output and table state) must equal the same scan on
   device="cpu"; fused.LAUNCHES must move by
   exactly the windows the probe counts (18, 8, 8, 18); on the row-kernel
   run row_gather and row_scatter must each move by K = 256 per scan of
   full, noidrow and both widths and by 0 elsewhere (0 everywhere on the
   plain run), and its first scans must equal the plain run's.

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
from concurrent.futures import ProcessPoolExecutor, ThreadPoolExecutor

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
CROSS_BLOCK_B = (4096, 1, 4097, 65536)  # widths of the cross-block windows
BLOCK_K, BLOCK_B = 64, 256  # phase 2's one-block windows
REGISTERS_PER_SM = 65536
FUSED_THREADS = 256  # threads per block of the decision-window kernel
FRONT_THREADS = 512  # the largest block of the by-id front-end kernel


def ptxas_summary(log: str) -> dict:
    """{kernel instantiation: (registers, stack bytes, spill store bytes,
    spill load bytes)} from nvcc's -Xptxas -v report."""
    kernels, name, frame = {}, None, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            mangled = m.group(1)
            d = re.search(r"(block_)?window_kernelILi(\d)ELb(\d)ELi(\d)E",
                          mangled)
            s = re.search(r"(scatter|gather)_kernelILi(\d)ELi(\d)ELi(\d)E",
                          mangled)
            f = re.search(r"ids_front_kernelILi(\d+)ELi(\d+)E", mangled)
            tier = ("False", "True", "cur", "w32")
            name = (
                f"{d.group(1) or ''}window W={d.group(2)} "
                f"with_degen={d.group(3) == '1'} "
                f"tier={tier[int(d.group(4))]}" if d
                else f"{s.group(1)} W={s.group(2)} part={s.group(3)} "
                f"steps={s.group(4)}" if s
                else f"ids_front threads={f.group(1)} items={f.group(2)}"
                if f else mangled
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


def reuse_windows(rng, k, b, cap, degen):
    """Two windows in which every sub-batch takes the slots of the one
    before in another order, so most rows the one-block schedule
    prefetches are stale and come from the previous sub-batch's writes
    in shared memory: b distinct slots, and b lanes over b // 2 slots
    (duplicate segments whose is_last lane moves every sub-batch)."""
    import numpy as np

    windows = []
    for n_slots in (b, max(1, b // 2)):
        pool = rng.permutation(cap)[:n_slots]
        base = np.r_[pool, pool[rng.integers(0, n_slots, b - n_slots)]]
        slots = np.stack([rng.permutation(base) for _ in range(k)])
        windows.append(hostile_window(rng, k, b, cap, degen,
                                      slots=slots.astype(np.int32)))
    return windows


def forwarded_count(packed, n_rows):
    """Lanes the one-block schedule forwards in a window: those of
    sub-batch k >= 1 whose row sub-batch k-1 wrote (a valid is_last
    lane's slot, or lane i's scratch row n_rows - b + i)."""
    import numpy as np

    from throttlecrab_tpu_torch.tpu.kernel import (
        PACK_FLAG_IS_LAST,
        PACK_FLAG_VALID,
    )

    k, b = packed.shape[:2]
    slot = np.clip(packed[..., 0].astype(np.int64), 0, n_rows - 1)
    flags = packed[..., 2]
    writes_slot = ((flags & PACK_FLAG_IS_LAST) != 0) & (
        (flags & PACK_FLAG_VALID) != 0)
    target = np.where(writes_slot, slot, n_rows - b + np.arange(b))
    return sum(int(np.isin(slot[j], target[j - 1]).sum())
               for j in range(1, k))


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


def compare_kernel_plain(device, k, b, cap, seed=0, kind="hostile"):
    """Phase 2 at one (k, b): two windows of `kind` — "hostile",
    "cross" (cross_block_windows) or "reuse" (reuse_windows).  Returns
    the largest valid-lane output difference, the kernel windows the
    one-block schedule took (all of them when b <= 256, else none), and
    the lanes it forwarded, counted from the packed rows."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    n_rows = cap + (1 << 16)
    make = {"hostile": lambda *a: [hostile_window(rng, *a) for _ in range(2)],
            "cross": lambda *a: cross_block_windows(rng, *a),
            "reuse": lambda *a: reuse_windows(rng, *a)}[kind]
    windows = {degen: make(k, b, cap, degen) for degen in (True, False)}
    block = b <= FUSED_THREADS
    block_windows = forwarded = 0
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
                if block:
                    block_windows += 1
                    forwarded += forwarded_count(packed, n_rows)
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
            print(f"  identical: K={k} B={b} {kind} width={width} "
                  f"compact={compact!r} with_degen={with_degen} "
                  f"n_exp={int(acc['kernel'])}")
    return worst, block_windows, forwarded


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


def timing_window(device, width, rng, b=B):
    """A certified (w32-tier) window at K x b over a full-size table of
    width `width`: (state, packed, now) on the card."""
    import numpy as np
    import torch

    from throttlecrab_tpu_torch.tpu import kernel
    from throttlecrab_tpu_torch.tpu.limiter import derive_params

    state = hostile_state(rng, CAPACITY + (1 << 16), CAPACITY, width, device)
    slots = rng.integers(0, CAPACITY, (K, b)).astype(np.int32)
    rank = np.zeros((K, b), np.int32)
    is_last = np.ones((K, b), bool)
    for j in range(K):
        rank[j], is_last[j], _ = segments(slots[j], np.ones(b, bool))
    kid = slots.astype(np.int64)
    em, tol, _ = derive_params(5 + kid % 60, 50 + kid % 1000, 30 + kid % 120)
    packed = torch.from_numpy(kernel.pack_requests(
        slots, rank, is_last, em, tol, np.ones((K, b), np.int64),
        np.ones((K, b), bool),
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


def time_kernel(device, rng, b=B, rounds=3):
    """{width: {"ms", "plain_ms", "device_ms", "plain_device_ms",
    "kernels_per_call", "host_us"}} per w32 window of K x b: CUDA-event
    medians of `rounds` rounds that alternate the widths, then the
    profiler's device time and kernel count per call, then the wrapper's
    host time."""
    import numpy as np

    from throttlecrab_tpu_torch.tpu import fused, kernel

    inputs = {w: timing_window(device, w, rng, b) for w in (4, 6)}
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
        print(f"  B={b} W={w} rounds: kernel "
              f"{[round(x, 4) for x in k_ms]} ms, "
              f"plain {[round(x, 2) for x in p_ms]} ms")
    result = {}
    for w, call in calls.items():
        n = 20
        _, k_dev, _, k_count, names, api = profile_device(
            call["kernel"], n, detail=True)
        p_dev = profile_device(call["plain"], 2)[1]
        print(f"  B={b} W={w} profiler: {n} fused_window calls, kernel "
              f"records {names}, {api} kernel-launch API records")
        # Every record must be the window kernel of the batch's schedule
        # (no fill, no second kernel) and there may be no more than one
        # per call.  The profiler can drop records late in a long run, so
        # fewer than one per call is reported, not failed.
        want = ("block_window_kernel" if b <= FUSED_THREADS
                else "window_kernel")
        if k_dev is not None and (
            len(names) != 1 or want not in next(iter(names))
            or (b > FUSED_THREADS and "block_" in next(iter(names)))
            or k_count > 1 or api > n
        ):
            raise AssertionError(f"fused_window B={b} W={w}: kernel "
                                 f"records {names}, {api} launch records "
                                 f"for {n} calls; expected {want} once "
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


FLUSH_BYTES = 128 << 20  # read before each cold launch: 2.5x the L2


def l2_flusher(device):
    """A call that reads FLUSH_BYTES on the card (a sum over a buffer
    written once here), evicting from L2 whatever the launches before it
    left there.  A read leaves clean lines, so the timed launch pays no
    write-back of the flush's own lines when it evicts them."""
    import torch

    buf = torch.ones(FLUSH_BYTES // 4, dtype=torch.int32, device=device)
    return lambda: buf.sum()


def cold_device_ms(fn, flush, n=30):
    """Device ms per fn() call with L2 flushed before each call: the
    profiler's records of fn's kernels (every record but those of the
    kernels a flush alone launches); None when the profiler records no
    kernel on this machine."""
    flush_names = set(profile_device(flush, 2)[2])

    def step():
        flush()
        fn()

    _, dev, by_name, _ = profile_device(step, n)
    if dev is None:
        return None
    mine = [v for k, v in by_name.items() if k not in flush_names]
    if not mine:
        raise AssertionError(f"no kernel but the flush's in {by_name}")
    return sum(mine)


def time_row_kernels(device, rng, b=B, n=BYID_CAPACITY + (1 << 16),
                     rounds=3):
    """{(name, W): {side: ms}} per launch of `b` rows over a table of `n`
    rows (phase 8: B=4096 over the by-id table; phase 10: the snapshot's
    65,536 over the serving table), the sides "kernel", "plain" and
    "library": CUDA-event medians of `rounds` rounds that alternate
    kernel, plain version and library call; "device_" + side, the
    profiler's device time with L2 warm (the table fits in L2 and stays
    there between launches); "cold_" + side (kernel and library call),
    device time with FLUSH_BYTES read before each launch, medians of
    `rounds` rounds that alternate the two; "host_us_" + side, the host
    time per call of the kernel's wrapper and of the library call, in
    µs; "sector_bound", row_sector_bound_ms of the index sets.  Each call
    takes the next of 8 index sets, so consecutive launches do not find
    each other's rows in L2."""
    import itertools

    import numpy as np

    from throttlecrab_tpu_torch.tpu import row_ops

    flush = l2_flusher(device)
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
        cold = [(key, fn) for key, fn in fns.items() if key[1] != "plain"]
        for r in range(rounds):
            for (name, side), fn in cold[::1 - 2 * (r % 2)]:
                samples[(name, w)].setdefault("cold_" + side, []).append(
                    cold_device_ms(fn, flush))
        for (name, side), fn in cold:
            samples[(name, w)]["host_us_" + side] = [host_us_per_call(fn)]
        sector = float(np.mean([row_sector_bound_ms(i.cpu().numpy(), w)
                                for i in idxs]))
        for name in ("row_gather", "row_scatter"):
            samples[(name, w)]["sector_bound"] = [sector]
    for (name, w), by_side in samples.items():
        print(f"  {name} W={w} rounds (ms per launch): " + ", ".join(
            f"{side} {[x if x is None else round(x, 5) for x in v]}"
            for side, v in by_side.items()))
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


def row_sector_bound_ms(idx, w):
    """The least time for one row launch over the rows at `idx` (i32[b],
    in range), counted in sectors: every distinct 32-byte table sector
    those rows touch, plus the 4-byte index and the 4W-byte row on the
    dense side, at the HBM rate.  A W=6 row at its 24-byte pitch spans
    two sectors when it starts 16 or 24 bytes into one (rows 1 and 2
    mod 4), 1.5 sectors a row on average, where row_bound_ms counts
    one; a W=4 row is half a sector, and two rows of one sector count
    once."""
    import numpy as np

    start = idx.astype(np.int64) * 4 * w
    sectors = np.unique(np.concatenate(
        [start // SECTOR, (start + 4 * w - 1) // SECTOR]))
    return ((sectors.size * SECTOR + idx.size * (4 + 4 * w))
            / HBM_BYTES_PER_S * 1e3)


def row_times_line(t, b, w, bound_b):
    """Phase 8's and 10's line for one (name, W) of time_row_kernels:
    each device time beside its share of row_bound_ms."""
    bound = row_bound_ms(bound_b, w)

    def share(ms):
        return "not measured" if ms is None else f"{bound / ms:.1%}"

    return (f"kernel {t['kernel']:.5f} ms, plain {t['plain']:.5f} ms, "
            f"library {t['library']:.5f} ms per launch at B={b} (CUDA-event "
            f"medians); device time (profiler), L2 warm: kernel "
            f"{t['device_kernel']} ms ({share(t['device_kernel'])} of the "
            f"bound), plain {t['device_plain']} ms, library "
            f"{t['device_library']} ms ({share(t['device_library'])}); L2 "
            f"cold: kernel {t['cold_kernel']} ms "
            f"({share(t['cold_kernel'])}), library {t['cold_library']} ms "
            f"({share(t['cold_library'])}); bound {bound:.6f} ms "
            f"(sector-counted {t['sector_bound']:.6f} ms); host time per "
            f"call kernel {t['host_us_kernel']:.1f} µs, library "
            f"{t['host_us_library']:.1f} µs")


def row_shares(t4, t6, b, side):
    """{"w4_warm", "w4_cold", "w6_warm", "w6_cold": share of row_bound_ms
    that `side`'s device time reaches (None where not measured)} from
    time_row_kernels' entries for one kernel at W = 4 and 6."""
    out = {}
    for w, t in ((4, t4), (6, t6)):
        for temp, key in (("warm", "device_"), ("cold", "cold_")):
            ms = t[key + side]
            out[f"w{w}_{temp}"] = (None if ms is None
                                   else row_bound_ms(b, w) / ms)
    return out


# ---- row kernels vs plain (phase 5) --------------------------------------- #


# Phase 5's batches: one row, one partial warp step, around 256, the
# by-id batch, the W=6 scatter's step from one row a lane to two, "edge"
# (one short of the last whole block below 65,536 of the tile the largest
# batches pick, at it and past it), the largest.  ROW_BIG_BLOCK_ROWS is
# that tile's rows per block (tests/test_torch_row_tile.py pins it).
ROW_EDGE_B = (1, 2, 255, 256, 257, 4096, 42_240, 42_241, "edge-1", "edge",
              "edge+1", 65_535, 65_536)
ROW_BIG_BLOCK_ROWS = {4: 256, 6: 80}
# The scatter's rows' bytes past a 16-byte boundary that each width takes.
ROW_OFFSETS = {4: (0,), 6: (0, 8)}


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


def row_edge_batches(width):
    """[(label, b)] of ROW_EDGE_B for `width`-wide rows."""
    per = ROW_BIG_BLOCK_ROWS[width]
    edge = ((1 << 16) - 1) // per * per
    return [(str(label), label) if isinstance(label, int) else
            (label, edge + {"edge-1": -1, "edge": 0, "edge+1": 1}[label])
            for label in ROW_EDGE_B]


def dense_view(shape, offset, device):
    """An int32 tensor of `shape` whose data starts `offset` bytes past a
    16-byte boundary: a view into a larger buffer."""
    import math

    import torch

    n = math.prod(shape)
    raw = torch.empty(n + 4, dtype=torch.int32, device=device)
    skip = ((offset - raw.data_ptr()) % 16) // 4
    view = raw[skip:skip + n].view(shape)
    assert view.data_ptr() % 16 == offset
    return view


def row_error(a, b):
    """Largest |a - b| over two int32 tensors on one device (0 if equal)."""
    if a.shape == b.shape and bool((a == b).all()):
        return 0
    return int((a.long() - b.long()).abs().max())


def check_row_case(table, idx, rows):
    """One phase 5 case on the card: {name: largest difference from the
    plain version} of the wrappers' launches.  The plain version runs on
    the in-range indices: an index outside the table gives a zero row or
    no write."""
    import torch

    from throttlecrab_tpu_torch.tpu import row_ops

    keep = (idx >= 0) & (idx < table.shape[0])
    want = torch.zeros_like(rows)
    want[keep] = row_ops.row_gather_plain(table, idx[keep])
    err = {"row_gather": row_error(row_ops.row_gather(table, idx), want)}
    want = row_ops.row_scatter_plain(table.clone(), idx[keep], rows[keep])
    got = row_ops.row_scatter(table.clone(), idx, rows)
    err["row_scatter"] = row_error(got, want)
    return err


def compare_row_kernels(device, rng):
    """Phase 5; returns ({name: largest difference} over every case, the
    number of cases)."""
    import numpy as np
    import torch

    n = BYID_CAPACITY + (1 << 16)
    worst = {"row_gather": 0, "row_scatter": 0}
    cases = 0
    i32 = (-(1 << 31), (1 << 31) - 1)

    def check(table, idx, rows, what):
        nonlocal cases
        err = check_row_case(table, idx, rows)
        for name, e in err.items():
            worst[name] = max(worst[name], e)
            if e:
                raise AssertionError(f"{name} {what}: max_abs_err={e}")
        cases += 1

    for w in (4, 6):
        table = torch.from_numpy(
            rng.integers(*i32, (n, w)).astype(np.int32)).to(device)
        perm = rng.permutation(n).astype(np.int32)
        parity = [np.flatnonzero(perm[:256] % 2 == p) for p in (0, 1)]
        batches = row_edge_batches(w)
        for label, b in batches:
            for offset in ROW_OFFSETS[w]:
                rows = dense_view((b, w), offset, device)
                rows.copy_(torch.from_numpy(
                    rng.integers(*i32, (b, w)).astype(np.int32)))
                for first in (0, 1):
                    start = int(rng.choice(parity[first]))
                    idx = torch.from_numpy(perm[start:start + b]).to(device)
                    check(table, idx, rows,
                          f"W={w} b={label} ({b}) offset {offset} "
                          f"first row {'odd' if first else 'even'}")
        rows = torch.from_numpy(
            rng.integers(*i32, (1 << 16, w)).astype(np.int32)).to(device)
        check(table, row_case_idx(rng, n, 1 << 16, device), rows,
              f"W={w} b=65536 with rows 0 and N-1")
        b = 4097
        for bad in (-1, n, i32[1]):
            idx_np = perm[:b].copy()
            idx_np[[0, b // 2, b - 1]] = bad
            idx = torch.from_numpy(idx_np).to(device)
            rows = torch.from_numpy(
                rng.integers(*i32, (b, w)).astype(np.int32)).to(device)
            check(table, idx, rows, f"W={w} index {bad}")
        torch.cuda.synchronize()
        print(f"  identical: W={w} N={n}, B in {batches} x the scatter's "
              f"rows {ROW_OFFSETS[w]} bytes off 16 x even/odd first rows, "
              f"and indices -1, N, 2^31-1 at B=4097 (zero rows, dropped "
              f"writes)")
    return worst, cases


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


# ---- the by-id front end's times (phase 8) ------------------------------- #


FRONT_SHAPES = ("c2", "c3")  # tools/probe_ids_front.py SHAPES


def front_probe(arm, shape):
    """One run of tools/probe_ids_front.py in a process of its own: its
    JSON record."""
    r = subprocess.run(
        [sys.executable, "-m", "throttlecrab_tpu_torch.tools.probe_ids_front",
         "--arm", arm, "--shape", shape], capture_output=True, text=True,
        timeout=600, cwd=os.path.dirname(os.path.abspath(__file__)))
    if r.returncode != 0:
        raise AssertionError(f"probe_ids_front --arm {arm} --shape {shape} "
                             f"exited {r.returncode}:\n{r.stdout[-3000:]}\n"
                             f"{r.stderr[-3000:]}")
    return json.loads(r.stdout.strip().splitlines()[-1])


def time_front(card):
    """The front-end kernel and its plain version at both cells'
    shapes, alternating in fresh processes (kernel, plain, plain,
    kernel a shape): {shape: {arm: [records]}}.  Each kernel run's first
    window must equal the plain version's."""
    out = {}
    for shape in FRONT_SHAPES:
        runs = {"kernel": [], "plain": []}
        for arm in ("kernel", "plain", "plain", "kernel"):
            rec = front_probe(arm, shape)
            if not rec["same_as_plain"]:
                raise AssertionError(f"front-end {arm} run at {shape}: the "
                                     "packed window differs from the plain "
                                     "version's")
            runs[arm].append(rec)
            print(f"  ids_front {arm} {shape} K={rec['K']} B={rec['B']}: "
                  f"device {rec['device_ms']:.4f} ms in "
                  f"{rec['records_a_call']} records a window, events "
                  f"{rec['event_ms']:.4f} ms, bound {rec['bound_ms']:.5f} ms "
                  f"({card})", flush=True)
        out[shape] = runs
    return out


def front_summary(runs):
    """Medians of a shape's kernel and plain runs."""
    import statistics

    def med(arm, key):
        return statistics.median(r[key] for r in runs[arm])

    return {"device_ms": med("kernel", "device_ms"),
            "plain_device_ms": med("plain", "device_ms"),
            "ms": med("kernel", "event_ms"),
            "plain_ms": med("plain", "event_ms"),
            "bound_ms": runs["kernel"][0]["bound_ms"],
            "records_a_call": runs["kernel"][0]["records_a_call"],
            "plain_records_a_call": runs["plain"][0]["records_a_call"],
            "shape": f"K={runs['kernel'][0]['K']} B={runs['kernel'][0]['B']}"}


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
    for the kernels line and the trace (phase 15 replays it)."""
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
    }, trace


# ---- the mesh (phase 15) ------------------------------------------------- #


MESH_SHARDS = 8  # BASELINE config 5's v5e-8 device count
MESH_TENANTS = 64
MESH_KEYS_PER_TENANT = 100_000
MESH_CAPACITY = 1 << 20  # slots per shard
MESH_SINGLE_CAPACITY = 1 << 23  # the single-device twin's and 1 shard's
MESH_STEADY_WINDOWS = 4
MESH_SPRAY = 50_000  # fresh keys t0 sprays in phase 15's quota run
MESH_SPRAY_WINDOWS = 2
MESH_QUOTA = 0.125  # of each shard's slots, per tenant
MESH_TOPK = 10
MESH_T0 = T0 + 100_000 * NS  # after every earlier phase's clock
MESH_SPLIT = ("route", "resolve", "pack", "launch", "other_prep", "fetch")


def mesh_batch(ids, now, spray=None):
    """One dispatch_many batch of phase 15: keys b"t{tenant}:k{j}" for key
    ids (tenant = id // 100,000), config 3's per-key (burst, count,
    period) from the id, quantity 1; `spray` marks lanes whose key is
    t0's fresh b"t0:x{j}" (j = the id) instead."""
    import numpy as np

    per = MESH_KEYS_PER_TENANT
    if spray is None:
        keys = [b"t%d:k%d" % (g // per, g % per) for g in ids.tolist()]
    else:
        keys = [b"t0:x%d" % g if s else b"t%d:k%d" % (g // per, g % per)
                for g, s in zip(ids.tolist(), spray.tolist())]
    return (keys, 5 + ids % 60, 50 + ids % 1000, 30 + ids % 120,
            np.ones(len(ids), np.int64), now)


def mesh_windows(rng, n_keys):
    """Phase 15's traffic: every key once in a random order (the
    population), then MESH_STEADY_WINDOWS windows of Zipf-1.1 draws over
    the keys (ranks through a fixed permutation, so the hot keys spread
    over tenants); K batches of B per window, one timestamp per window.
    Returns (population windows, steady windows, the Zipf sampler)."""
    import numpy as np

    ids = rng.permutation(n_keys).astype(np.int64)
    batches = [ids[lo:lo + B] for lo in range(0, n_keys, B)]
    now = MESH_T0
    population = []
    for w in range(0, len(batches), K):
        population.append([mesh_batch(b, now) for b in batches[w:w + K]])
        now += 1_000_000
    p = np.arange(1, n_keys + 1, dtype=np.float64) ** -1.1
    cdf = np.cumsum(p / p.sum())
    perm = rng.permutation(n_keys).astype(np.int64)

    def zipf(n):
        return perm[np.minimum(np.searchsorted(cdf, rng.random(n)),
                               n_keys - 1)]

    steady = []
    for _ in range(MESH_STEADY_WINDOWS):
        now += 50_000_000
        steady.append([mesh_batch(zipf(B), now) for _ in range(K)])
    return population, steady, zipf, now


def spray_windows(rng, zipf, now):
    """Phase 15's quota traffic: MESH_SPRAY_WINDOWS windows in which t0
    sprays MESH_SPRAY fresh keys (b"t0:x{j}") evenly over the batches,
    256 lanes a batch draw t0's existing keys, and the rest is the other
    tenants' Zipf traffic.  Returns (windows, per-window per-batch lane
    kinds: 0 other tenant, 1 t0 existing, 2 t0 fresh)."""
    import numpy as np

    per = MESH_KEYS_PER_TENANT
    n_batches = MESH_SPRAY_WINDOWS * K
    fresh = np.array_split(np.arange(MESH_SPRAY, dtype=np.int64), n_batches)
    windows, kinds = [], []
    for w in range(MESH_SPRAY_WINDOWS):
        now += 50_000_000
        batches, kw = [], []
        for j in range(K):
            f = fresh[w * K + j]
            own = rng.integers(0, per, 256).astype(np.int64)
            other = zipf(B - len(f) - len(own))
            other = np.where(other < per, other + per, other)
            ids = np.concatenate([f, own, other])
            kind = np.concatenate([np.full(len(f), 2), np.ones(len(own)),
                                   np.zeros(len(other))]).astype(np.int8)
            order = rng.permutation(B)
            ids, kind = ids[order], kind[order]
            batches.append(mesh_batch(ids, now, spray=kind == 2))
            kw.append(kind)
        windows.append(batches)
        kinds.append(kw)
    return windows, kinds, now


class PartTimer:
    """Host seconds per named part, accumulated by wrapping callables."""

    def __init__(self):
        self.acc = dict.fromkeys(MESH_SPLIT, 0.0)
        self._undo = []

    def wrap(self, obj, attr, part):
        fn = getattr(obj, attr)
        acc = self.acc

        def timed(*a, **kw):
            t = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                acc[part] += time.perf_counter() - t
        had = attr in vars(obj)
        setattr(obj, attr, timed)
        self._undo.append((obj, attr, fn, had))

    def take(self):
        out = dict(self.acc)
        for part in self.acc:
            self.acc[part] = 0.0
        return out

    def restore(self):
        for obj, attr, fn, had in reversed(self._undo):
            if had:
                setattr(obj, attr, fn)
            else:  # an instance's wrapper over its class's method
                delattr(obj, attr)
        self._undo = []


def split_timer(lim):
    """A PartTimer over one limiter's host parts: routing (sharded only),
    keymap resolves, request packing, the launch call (host-to-device
    copy + kernel enqueue, asynchronous), measured per window."""
    from throttlecrab_tpu_torch.parallel import sharded
    from throttlecrab_tpu_torch.tpu import limiter as limiter_mod

    timer = PartTimer()
    if hasattr(lim, "keymaps"):
        timer.wrap(lim, "_route", "route")
        for km in lim.keymaps:
            timer.wrap(km, "resolve", "resolve")
        timer.wrap(sharded, "pack_requests", "pack")
        timer.wrap(lim.table, "_launch", "launch")
    else:
        timer.wrap(lim.keymap, "resolve", "resolve")
        timer.wrap(limiter_mod, "pack_requests", "pack")
        timer.wrap(lim.table, "check_many_packed", "launch")
    return timer


def mesh_limiter(device, capacity=None, shards=None, **tenant_kw):
    """ShardedTorchRateLimiter of phase 15: `shards` slices of one device
    (`device` repeated in the mesh), native keymaps, insight rows, the
    tenant layer at 65 tenants (id 0 is the overflow bucket, so each of
    the 64 gets its own id)."""
    from throttlecrab_tpu_torch.parallel import (
        ShardedTorchRateLimiter,
        make_mesh,
    )
    from throttlecrab_tpu_torch.parallel.tenants import TenantRegistry

    return ShardedTorchRateLimiter(
        capacity or MESH_CAPACITY,
        mesh=make_mesh(devices=[device] * (shards or MESH_SHARDS)),
        keymap="native", insight=True,
        tenants=TenantRegistry(max_tenants=MESH_TENANTS + 1, delim=":",
                               **tenant_kw))


def same_results(a_list, b_list, where):
    import numpy as np

    for j, (a, b) in enumerate(zip(a_list, b_list)):
        for f in ("allowed", "limit", "remaining", "reset_after_s",
                  "retry_after_s", "status"):
            if not np.array_equal(getattr(a, f), getattr(b, f)):
                raise AssertionError(f"{where} batch {j}: {f} differs")


def sorted_export(keys, shard, tat, exp):
    """An export's columns as arrays sorted by key: (keys S, shard, tat,
    expiry)."""
    import numpy as np

    k = np.array(keys, dtype="S")
    order = np.argsort(k, kind="stable")
    return k[order], shard[order], tat[order], exp[order]


def export_arrays(limiter):
    """sorted_export of an export through the snapshot path (row
    gathers)."""
    from throttlecrab_tpu_torch.tpu import snapshot

    keys, _, shard, tat, exp, _, _ = snapshot.export_state(limiter)
    return sorted_export(keys, shard, tat, exp)


def same_export(a, b, where, shards=True):
    import numpy as np

    names = ("keys", "shard", "tat", "expiry")
    for i, name in enumerate(names):
        if name == "shard" and not shards:
            continue
        if not np.array_equal(a[i], b[i]):
            raise AssertionError(f"{where}: {name} differs")


class ShardLaunches:
    """Row-kernel launches per shard: wraps row_ops.row_gather /
    row_scatter (the snapshot module calls them through the module) to
    note which shard's state each launch wrote or read, by data pointer.
    The kernels' own counters count the launches; this only attributes
    them."""

    def __init__(self, limiters):
        from throttlecrab_tpu_torch.tpu import row_ops

        self._row_ops = row_ops
        self._orig = (row_ops.row_gather, row_ops.row_scatter)
        self.seen = {"row_gather": [], "row_scatter": []}

        def note(name, fn):
            def run(table, *a):
                self.seen[name].append(table.data_ptr())
                return fn(table, *a)
            return run
        row_ops.row_gather = note("row_gather", self._orig[0])
        row_ops.row_scatter = note("row_scatter", self._orig[1])

    def take(self, name, limiter):
        """Launches of `name` since the last take, per shard of
        `limiter`; the launch counter must agree."""
        ptrs = [s.state.data_ptr() for s in limiter.table.shards]
        got = [0] * len(ptrs)
        for p in self.seen[name]:
            got[ptrs.index(p)] += 1
        self.seen[name] = []
        return got

    def close(self):
        self._row_ops.row_gather, self._row_ops.row_scatter = self._orig


def per_shard_chunks(limiter):
    """ceil(n_d / 65,536) per shard: the row launches one export or
    restore of every live key must make."""
    from throttlecrab_tpu_torch.tpu import row_ops

    return [-(-len(km) // row_ops.MAX_BATCH) for km in limiter.keymaps]


def run_mesh(card, trace, device="cuda"):
    """Phase 15: the mesh at BASELINE config 5's width.  Returns its
    record for the kernels line."""
    import numpy as np
    import torch

    from throttlecrab_tpu_torch.insight.collector import (
        ShardedSlotKeyResolver,
        SlotKeyResolver,
    )
    from throttlecrab_tpu_torch.persist import Checkpointer, recover_into
    from throttlecrab_tpu_torch.replay import player
    from throttlecrab_tpu_torch.tpu import fused, kernel, row_ops, snapshot
    from throttlecrab_tpu_torch.tpu.limiter import (
        STATUS_TENANT_QUOTA,
        TorchRateLimiter,
    )

    t_phase = time.perf_counter()
    n_keys = MESH_TENANTS * MESH_KEYS_PER_TENANT
    rng = np.random.default_rng(15)
    t = time.perf_counter()
    population, steady, zipf, now = mesh_windows(rng, n_keys)
    traffic_s = time.perf_counter() - t
    mesh = mesh_limiter(device)
    single = TorchRateLimiter(capacity=MESH_SINGLE_CAPACITY, keymap="native",
                              device=device, insight=True)
    state_mb = sum(s.state.numel() * 4 for s in mesh.table.shards) / 2**20
    print(f"  {n_keys} keys ({MESH_TENANTS} tenants x "
          f"{MESH_KEYS_PER_TENANT}), {len(population)} population windows + "
          f"{len(steady)} Zipf windows of K={K} x B={B} (traffic built in "
          f"{traffic_s:.1f} s); mesh state {state_mb:.0f} MiB on "
          f"{MESH_SHARDS} shards of {device}")

    # Sharded against single-device, window by window, alternately.
    timers = {"mesh": split_timer(mesh), "single": split_timer(single)}
    seconds = {"mesh": [], "single": []}
    splits = {"mesh": [], "single": []}
    mesh_launches = []
    row0 = (row_ops.GATHER_LAUNCHES, row_ops.SCATTER_LAUNCHES)
    t_drive = time.perf_counter()
    for w, batches in enumerate(population + steady):
        out = {}
        for name, lim in (("mesh", mesh), ("single", single)):
            if device == "cuda":
                torch.cuda.synchronize()
            fused.LAUNCHES = 0
            t = time.perf_counter()
            handle = lim.dispatch_many(batches, wire=True)
            t_disp = time.perf_counter() - t
            t = time.perf_counter()
            out[name] = handle.fetch()
            t_fetch = time.perf_counter() - t
            seconds[name].append(t_disp + t_fetch)
            parts = timers[name].take()
            parts["other_prep"] = t_disp - sum(
                parts[p] for p in ("route", "resolve", "pack", "launch"))
            parts["fetch"] = t_fetch
            splits[name].append(parts)
            if name == "mesh":
                mesh_launches.append(fused.LAUNCHES)
        same_results(out["mesh"], out["single"], f"mesh window {w}")
    drive_s = time.perf_counter() - t_drive
    for timer in timers.values():
        timer.restore()
    if (row_ops.GATHER_LAUNCHES, row_ops.SCATTER_LAUNCHES) != row0:
        raise AssertionError("row kernels launched while deciding")
    if any(n != MESH_SHARDS for n in mesh_launches):
        raise AssertionError(f"window launches per mesh window "
                             f"{sorted(set(mesh_launches))}, expected "
                             f"{MESH_SHARDS}")
    if len(mesh) != n_keys or len(single) != n_keys:
        raise AssertionError(f"{len(mesh)} / {len(single)} keys held")
    if mesh.table.insight_counts() != single.table.insight_counts():
        raise AssertionError("insight totals differ: "
                             f"{mesh.table.insight_counts()} vs "
                             f"{single.table.insight_counts()}")
    stats = mesh.tenant_stats()
    if (sum(s["allowed"] for s in stats.values()),
            sum(s["denied"] for s in stats.values())) != (
            mesh.total_allowed, mesh.total_denied):
        raise AssertionError("per-tenant counters do not sum to the totals")
    if len(stats) != MESH_TENANTS:
        raise AssertionError(f"{len(stats)} tenants counted")
    decisions = sum(len(b[0]) for w in population + steady for b in w)
    print(f"  {decisions} decisions in {len(mesh_launches)} windows: "
          f"identical valid-lane results on the mesh and the single-device "
          f"TorchRateLimiter(capacity=2^23) (insight totals "
          f"{mesh.table.insight_counts()} both; per-tenant counters of "
          f"{len(stats)} tenants sum to them); {sum(mesh_launches)} window "
          f"launches, {MESH_SHARDS} per mesh window; 0 row launches; "
          f"{drive_s:.1f} s for both")
    steady_ix = range(len(population), len(population) + len(steady))
    report = {}
    for name in ("mesh", "single"):
        sec = [seconds[name][i] for i in steady_ix][1:]
        lat = np.percentile(np.asarray(sec) * 1e3, [50, 99])
        split = {p: float(np.median([splits[name][i][p] for i in
                                     steady_ix][1:]) * 1e3)
                 for p in MESH_SPLIT}
        pop = seconds[name][1:len(population)]
        report[name] = {
            "decisions_per_s": K * B * len(sec) / sum(sec),
            "population_decisions_per_s": K * B * len(pop) / sum(pop),
            "window_ms_p50": float(lat[0]), "window_ms_p99": float(lat[1]),
            "split_ms": split,
        }
        print(f"  {name}: Zipf windows {report[name]['decisions_per_s']:.0f}"
              f" decisions/s, window p50 {lat[0]:.2f} ms p99 {lat[1]:.2f} ms;"
              f" population {report[name]['population_decisions_per_s']:.0f}"
              f" decisions/s; median host ms per window {split} ({card})")

    # One more Zipf window on both under the profiler (twice each: the
    # profiler's warm-up step and its recorded step), still in lockstep.
    prof_window = [mesh_batch(zipf(B), now + 10_000_000) for _ in range(K)]
    last = {}
    for name, lim in (("mesh", mesh), ("single", single)):
        def run(lim=lim, name=name):
            last[name] = lim.dispatch_many(prof_window, wire=True).fetch()
        if device == "cuda":
            report[name]["profile"] = summarize_profile(
                *profile_device(run), top=3)
        else:
            run()
            run()
        print(f"  {name}: one more window under the profiler: "
              f"{report[name].get('profile')}")
    same_results(last["mesh"], last["single"], "profiled window")

    # Mesh-global top-K against the single device's.
    mv, mi = mesh.table.insight_topk(MESH_TOPK)
    sv, si = single.table.insight_topk(MESH_TOPK)
    if mv.tolist() != sv.cpu().tolist():
        raise AssertionError(f"top-K counts {mv.tolist()} vs "
                             f"{sv.cpu().tolist()}")
    mkeys = ShardedSlotKeyResolver(mesh).keys_for(mi.tolist())
    skeys = SlotKeyResolver(single.keymap).keys_for(si.cpu().tolist())
    deny_1 = kernel.unpack_deny(single.table.state).cpu()
    slot_of = {}
    for k in mkeys:
        if k is None:
            raise AssertionError("a mesh top-K id resolves to no key")
        slot_of[k] = None
    for k, s in single.keymap.items():
        if k in slot_of:
            slot_of[k] = s
    if [int(deny_1[slot_of[k]]) for k in mkeys] != mv.tolist():
        raise AssertionError("a mesh top-K key's count differs from its "
                             "single-device count")
    print(f"  top-{MESH_TOPK}: counts {mv.tolist()} on both; mesh keys "
          f"{[k.decode() for k in mkeys[:4]]}..., single "
          f"{[k.decode() for k in skeys[:4]]}...; every mesh key's count "
          "equals its single-device count")
    del single

    # Restart paths on the 8-shard mesh: a snapshot saved and loaded, a
    # checkpoint generation recovered onto 1 shard and onto 8.  Config
    # 3's buckets lapse within seconds, so the restores run as of the
    # population's first timestamp, where every key is live: all of them
    # restore.
    shards = ShardLaunches([mesh])
    restart = {}
    try:
        with tempfile.TemporaryDirectory() as tmp:
            want_chunks = per_shard_chunks(mesh)
            g0 = row_ops.GATHER_LAUNCHES
            t = time.perf_counter()
            payload = snapshot.export_snapshot_payload(mesh)
            export_ms = (time.perf_counter() - t) * 1e3
            save = shards.take("row_gather", mesh)
            if save != want_chunks or \
                    row_ops.GATHER_LAUNCHES - g0 != sum(want_chunks):
                raise AssertionError(f"snapshot save: row_gather per shard "
                                     f"{save}, expected {want_chunks}")
            t = time.perf_counter()
            snapshot.write_snapshot_payload(payload, f"{tmp}/mesh")
            write_ms = (time.perf_counter() - t) * 1e3
            before = sorted_export(*(payload[c] for c in (
                "keys", "shard", "tat", "expiry")))
            del payload
            loaded = mesh_limiter(device)
            s0 = row_ops.SCATTER_LAUNCHES
            t = time.perf_counter()
            snapshot.load_snapshot(loaded, f"{tmp}/mesh.npz", MESH_T0)
            load_ms = (time.perf_counter() - t) * 1e3
            load = shards.take("row_scatter", loaded)
            if load != per_shard_chunks(loaded) or \
                    row_ops.SCATTER_LAUNCHES - s0 != sum(load):
                raise AssertionError(f"snapshot load: row_scatter per shard "
                                     f"{load}, expected "
                                     f"{per_shard_chunks(loaded)}")
            same_export(before, export_arrays(loaded), "snapshot load")
            shards.take("row_gather", loaded)
            if int(loaded.table.deny.sum()) != 0:
                raise AssertionError("restored keys carry deny heat")
            del loaded
            restart["snapshot"] = {
                "export_ms": export_ms, "write_ms": write_ms,
                "load_ms": load_ms, "row_gather_per_shard": save,
                "row_scatter_per_shard": load}
            print(f"  snapshot of {n_keys} keys: export (gathers) "
                  f"{export_ms:.0f} ms with row_gather per shard {save}, "
                  f"write {write_ms:.0f} ms; load {load_ms:.0f} ms with "
                  f"row_scatter per shard {load}; every key back on its "
                  f"shard with its tat/expiry ({card})")

            ck = Checkpointer(mesh, f"{tmp}/chain", interval_ns=1,
                              now_fn=lambda: now)
            t = time.perf_counter()
            ck.checkpoint_now(now)
            ck_ms = (time.perf_counter() - t) * 1e3
            gen = shards.take("row_gather", mesh)
            if gen != want_chunks:
                raise AssertionError(f"checkpoint: row_gather per shard "
                                     f"{gen}, expected {want_chunks}")
            restart["checkpoint"] = {"ms": ck_ms,
                                     "row_gather_per_shard": gen}
            for n_shards, cap in ((1, MESH_SINGLE_CAPACITY),
                                  (MESH_SHARDS, MESH_CAPACITY)):
                target = mesh_limiter(device, capacity=cap, shards=n_shards)
                t = time.perf_counter()
                res = recover_into(target, f"{tmp}/chain", MESH_T0)
                rec_ms = (time.perf_counter() - t) * 1e3
                got = shards.take("row_scatter", target)
                if res.restored != n_keys or got != per_shard_chunks(target):
                    raise AssertionError(
                        f"recovery onto {n_shards} shards: {res.restored} "
                        f"keys, row_scatter per shard {got}")
                same_export(before, export_arrays(target),
                            f"recovery onto {n_shards}",
                            shards=n_shards == MESH_SHARDS)
                shards.take("row_gather", target)
                restart[f"recover_{n_shards}"] = {
                    "ms": rec_ms, "row_scatter_per_shard": got}
                del target
            print(f"  checkpoint generation {ck_ms:.0f} ms with row_gather "
                  f"per shard {gen}; recovered onto 1 shard in "
                  f"{restart['recover_1']['ms']:.0f} ms (row_scatter "
                  f"{restart['recover_1']['row_scatter_per_shard']}) and "
                  f"onto {MESH_SHARDS} in "
                  f"{restart[f'recover_{MESH_SHARDS}']['ms']:.0f} ms "
                  f"({restart[f'recover_{MESH_SHARDS}']['row_scatter_per_shard']}"
                  f"); per-key state equal ({card})")
    finally:
        shards.close()
    del mesh, before

    # The quota: tenant-affine routing, 0.125 of each shard per tenant.
    qlim = mesh_limiter(device, quota_frac=MESH_QUOTA, affinity=True)
    for batches in population:
        qlim.dispatch_many(batches, wire=True).fetch()
    cap = qlim.table.capacity
    grown = cap != MESH_CAPACITY
    spray, kinds, now = spray_windows(rng, zipf, now)
    headroom = int(MESH_QUOTA * cap) - MESH_KEYS_PER_TENANT
    want_refused = MESH_SPRAY - max(headroom, 0)
    if want_refused <= 0:
        raise AssertionError("the spray does not reach t0's quota")
    cpu_q = mesh_limiter("cpu", quota_frac=MESH_QUOTA, affinity=True)
    keys_, _, _, tat_, exp_, _, _ = snapshot.export_state(qlim)
    snapshot._bulk_insert(cpu_q, keys_, tat_, exp_)
    del keys_, tat_, exp_
    refused = 0
    for w, batches in enumerate(spray):
        got = qlim.dispatch_many(batches, wire=True).fetch()
        if w == 0:
            same_results(got, cpu_q.dispatch_many(batches, wire=True)
                         .fetch(), "spray window on cpu shards")
        for res, kind in zip(got, kinds[w]):
            five = res.status == STATUS_TENANT_QUOTA
            if (res.status[kind != 2] != 0).any() or \
                    (res.status[kind == 2][~five[kind == 2]] != 0).any():
                raise AssertionError("status 5 outside t0's fresh keys, or "
                                     "another error status")
            refused += int(five.sum())
    if qlim.table.capacity != cap:
        raise AssertionError("the spray grew the table")
    rejections = qlim.tenant_stats()["t0"]["quota_rejections"]
    if refused != want_refused or rejections != want_refused:
        raise AssertionError(f"{refused} lanes / {rejections} rejections of "
                             f"status 5, expected {want_refused}")
    tenants_per_shard = np.bincount(
        [qlim.shard_of(b"t%d" % i + b":") for i in range(MESH_TENANTS)],
        minlength=MESH_SHARDS).tolist()
    quota = {"refused": refused, "expected": want_refused,
             "capacity_per_shard": cap, "grew": grown,
             "tenants_per_shard": tenants_per_shard}
    print(f"  quota {MESH_QUOTA} with affinity: tenants per shard "
          f"{tenants_per_shard}, capacity per shard {cap} (grew: {grown}); "
          f"t0 sprayed {MESH_SPRAY} fresh keys: {refused} refused with "
          f"status 5 (expected {want_refused}), t0's existing keys and every "
          f"other tenant decided (status 0); tenant_stats counts "
          f"{rejections} rejections; the first spray window on cpu shards "
          f"gave identical statuses and results")
    del qlim, cpu_q

    # The server: --shards beyond the cards refuses with make_mesh's
    # message; --shards 1 --pallas-fused serves.
    have = torch.cuda.device_count() if device == "cuda" else 0
    if device == "cuda":
        r = subprocess.run(
            [sys.executable, "-m", "throttlecrab_tpu_torch.server", "--http",
             "--http-host", "127.0.0.1", "--http-port", str(free_port()),
             "--shards", str(have + 1), "--device", "cuda"],
            capture_output=True, text=True, timeout=300)
        msg = (f"requested a {have + 1}-device mesh but the backend exposes "
               f"{have}")
        if r.returncode == 0 or msg not in r.stdout + r.stderr:
            raise AssertionError(f"--shards {have + 1}: exit {r.returncode}"
                                 f"\n{(r.stdout + r.stderr)[-2000:]}")
        proc, http_port, _ = boot_server(
            "python", ("--shards", "1", "--pallas-fused"))
        try:
            status, body = http(http_port, "POST", "/throttle",
                                throttle_body("mesh:k", 3))
            if status != 200 or not json.loads(body)["allowed"]:
                raise AssertionError(f"--shards 1 --pallas-fused: {status} "
                                     f"{body!r}")
        finally:
            stop_server(proc)
        print(f"  server: --shards {have + 1} on cuda exits "
              f"{r.returncode} with \"{msg}\"; --shards 1 --pallas-fused "
              "boots and answers")

    # The phase-14 trace through the mesh targets.
    replays = {}
    for name, kw in (("sharded:1", {"device": device}),
                     (f"sharded:{MESH_SHARDS}", {"device": "cpu"})):
        target = player.make_target(name, trace, **kw)
        fused.LAUNCHES = 0
        t = time.perf_counter()
        rep = player.differential_replay(trace, target)
        sec = time.perf_counter() - t
        if not rep.ok:
            raise AssertionError(f"{name} replay: {rep.summary()}")
        replays[name] = {"summary": rep.summary(), "seconds": sec,
                         "launches": fused.LAUNCHES,
                         "device": kw["device"]}
        print(f"  replay of phase 14's trace through {name} on "
              f"{kw['device']}: {rep.summary()}, {fused.LAUNCHES} window "
              f"launches, {sec:.1f} s (oracle included)")
    print(f"  phase {time.perf_counter() - t_phase:.1f} s ({card})")
    return {
        "mesh_shards": MESH_SHARDS,
        "mesh_windows": len(mesh_launches),
        "mesh_window_launches": sum(mesh_launches),
        "mesh": report,
        "mesh_topk_counts": mv.tolist(),
        "mesh_restart": restart,
        "mesh_quota": quota,
        "mesh_replays": replays,
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
    from throttlecrab_tpu_torch.tpu import fused, ids_front, row_ops

    built, errors = {}, []

    def run(name, build):
        t = time.perf_counter()
        try:
            built[name] = (build(), time.perf_counter() - t)
        except Exception as e:  # re-raised in the main thread
            errors.append(e)

    threads = [threading.Thread(target=run, args=a) for a in (
        ("fused_window", fused.build), ("row_ops", row_ops.build),
        ("ids_front", ids_front.build))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    return built


# ---- the cluster (phase 16) ---------------------------------------------- #


CLUSTER_NODES = 3
CLUSTER_CAPACITY = 1 << 20  # per node, the default server's table
CLUSTER_VNODES = 128  # the default --cluster-vnodes
CLUSTER_STEADY = 48  # config-3 batches of B through the 3 frontends
CLUSTER_STEP = 12  # batches after each lifecycle step
ROW_CHUNK = 65_536  # row_ops.MAX_BATCH: rows per row-kernel launch


class ClusterNode:
    """One in-process node of phase 16: a 1M-key native limiter with the
    insight rows (the default server's W=6) on the card, its
    ClusterLimiter in ring mode with replication, and its ClusterServer
    on a dedicated event-loop thread.  The nodes share the card's context
    and default stream; each node's device_lock serializes its table.
    `decided[index]` counts the sub-batches this node decides as owner
    (its limiter's rate_limit_batch calls); the pump's submissions,
    flushes, sends and the frames applied here are counted for
    quiesce()."""

    def __init__(self, index, nodes, device, decided, mu):
        import asyncio

        from throttlecrab_tpu_torch.parallel.cluster import (
            ClusterLimiter,
            ClusterServer,
        )
        from throttlecrab_tpu_torch.tpu.limiter import TorchRateLimiter

        self.index = index
        self.limiter = TorchRateLimiter(
            capacity=CLUSTER_CAPACITY, keymap="native", device=device,
            insight=True)
        decide = self.limiter.rate_limit_batch

        def counted(*a, **k):
            with mu:
                decided[index] += 1
            return decide(*a, **k)
        self.limiter.rate_limit_batch = counted
        # Replicas are held for every row a node can own, so a takeover
        # continues each key from its last replicated decision.
        self.cl = ClusterLimiter(
            self.limiter, nodes, index, vnodes=CLUSTER_VNODES,
            replicate=True, io_timeout_s=120.0, handoff_timeout_s=120.0,
            replica_cap=CLUSTER_CAPACITY)
        self.submitted = self.flushed = 0
        self.sent = {}
        self.applied = {}
        pump, cl = self.cl._pump, self.cl
        submit, flush = pump.submit, cl._flush_replicas
        push, apply = cl._push_replica_rows, cl.apply_replica

        def counted_submit(entry):
            with mu:
                self.submitted += 1
            submit(entry)

        def counted_flush(entries):
            try:
                flush(entries)
            finally:
                with mu:
                    self.flushed += len(entries)

        def counted_push(dest, *a):
            ok = push(dest, *a)
            if ok:
                with mu:
                    self.sent[dest] = self.sent.get(dest, 0) + 1
            return ok

        def counted_apply(origin, *a):
            try:
                apply(origin, *a)
            finally:
                with mu:
                    self.applied[origin] = self.applied.get(origin, 0) + 1
        pump.submit = counted_submit
        cl._flush_replicas = counted_flush
        cl._push_replica_rows = counted_push
        cl.apply_replica = counted_apply
        port = int(nodes[index].rpartition(":")[2])
        self.srv = ClusterServer("127.0.0.1", port, cl.local, cl.device_lock,
                                 cluster=cl)
        self.loop = asyncio.new_event_loop()
        self.thread = threading.Thread(target=self._run, daemon=True,
                                       name=f"cluster-node{index}")
        self.thread.start()
        asyncio.run_coroutine_threadsafe(self.srv.start(),
                                         self.loop).result(timeout=30)

    def _run(self):
        import asyncio

        asyncio.set_event_loop(self.loop)
        self.loop.run_forever()

    def kill(self):
        """Hard stop: listener down, pump stopped, sockets dropped."""
        import asyncio

        asyncio.run_coroutine_threadsafe(self.srv.stop(),
                                         self.loop).result(timeout=30)
        self.cl.close()
        self.loop.call_soon_threadsafe(self.loop.stop)
        self.thread.join(timeout=30)


def wait_until(cond, what, seconds=120):
    deadline = time.monotonic() + seconds
    while not cond():
        if time.monotonic() > deadline:
            raise AssertionError(f"timed out waiting for {what}")
        time.sleep(0.002)


def quiesce(nodes):
    """Every replica entry submitted has been flushed, and every replica
    frame sent to a live node has been applied there."""
    live = {n.index: n for n in nodes if n is not None}

    def done():
        for n in live.values():
            if n.submitted != n.flushed + n.cl.replica_drops:
                return False
            for dest, k in list(n.sent.items()):
                if dest in live and live[dest].applied.get(n.index, 0) < k:
                    return False
        return True
    wait_until(done, "the replica frames to land")


def join_node(node, nodes):
    """announce_join_all, then wait until every peer's migrate landed."""
    node.cl.announce_join_all()
    wait_until(lambda: not node.cl._pending_from, "the handoff gates")
    for n in nodes:
        if n is not None:
            wait_until(lambda n=n: not n.cl._pending_from,
                       "the handoff gates")


class RowCounter:
    """Counts the row kernels' expected launches on the cluster's paths:
    every export_state gathers ceil(live / 65,536) chunks and every
    _bulk_insert scatters ceil(rows / 65,536); the wrappers also time
    each call, with the rows it moved."""

    def __init__(self, device):
        from throttlecrab_tpu_torch.tpu import snapshot

        self.snapshot = snapshot
        self.device = device
        self.orig = (snapshot.export_state, snapshot._bulk_insert)
        self.gathers, self.scatters = 0, 0
        self.exports, self.inserts = [], []
        self.mu = threading.Lock()
        export, insert = self.orig

        def counted_export(limiter):
            t = time.perf_counter()
            out = export(limiter)
            n = len(out[0])
            with self.mu:
                self.gathers += -(-n // ROW_CHUNK)
                self.exports.append((n, (time.perf_counter() - t) * 1e3))
            return out

        def counted_insert(limiter, keys, tats, exps):
            t = time.perf_counter()
            out = insert(limiter, keys, tats, exps)
            with self.mu:
                self.scatters += -(-len(keys) // ROW_CHUNK)
                self.inserts.append((len(keys),
                                     (time.perf_counter() - t) * 1e3))
            return out
        snapshot.export_state = counted_export
        snapshot._bulk_insert = counted_insert

    def take(self):
        """(expected gathers, expected scatters, exports, inserts) since
        the last take, then zero."""
        with self.mu:
            out = (self.gathers, self.scatters, self.exports, self.inserts)
            self.gathers, self.scatters = 0, 0
            self.exports, self.inserts = [], []
        return out

    def close(self):
        self.snapshot.export_state, self.snapshot._bulk_insert = self.orig


CLUSTER_FIELDS = ("allowed", "limit", "remaining", "reset_after_ns",
                  "retry_after_ns", "status")


def run_cluster_in_process(card, device="cuda"):
    """Phase 16a: three nodes on the card against the single-device
    limiter, then kill, rejoin and leave."""
    import numpy as np
    import torch

    from throttlecrab_tpu_torch.parallel.ring import HashRing, batch_crc32
    from throttlecrab_tpu_torch.tpu import fused, row_ops
    from throttlecrab_tpu_torch.tpu.limiter import TorchRateLimiter

    rng = np.random.default_rng(16)
    n_batches = CLUSTER_STEADY + 3 * CLUSTER_STEP
    traffic = [b for w in config3_windows(rng, N_KEYS, n_batches, 1, B, -1)
               for b in w]
    nodes_spec = [f"127.0.0.1:{free_port()}" for _ in range(CLUSTER_NODES)]
    ring = HashRing(nodes_spec, CLUSTER_VNODES)
    mu = threading.Lock()
    decided = [0] * CLUSTER_NODES
    rows = RowCounter(device)
    nodes = [None] * CLUSTER_NODES
    single = TorchRateLimiter(capacity=CLUSTER_CAPACITY, keymap="native",
                              device=device, insight=True)
    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    record = {}
    try:
        t = time.perf_counter()
        for i in range(CLUSTER_NODES):
            nodes[i] = ClusterNode(i, nodes_spec, device, decided, mu)
        for node in nodes:
            join_node(node, nodes)
        boot_ms = (time.perf_counter() - t) * 1e3

        tainted = set()  # keys whose state the takeover re-derived

        def drive(batches, via, where, exact_all):
            """Each batch through a frontend, then the same batch through
            the single-device limiter; returns counts and timings."""
            out = {"cluster_s": 0.0, "single_s": 0.0, "batch_ms": [],
                   "window_launches": 0, "decided": 0, "expected": 0,
                   "rows": 0, "tainted_mismatches": 0}
            for i, batch in enumerate(batches):
                node = nodes[via[i % len(via)]]
                l0, d0 = fused.LAUNCHES, sum(decided)
                t0 = time.perf_counter()
                got = node.cl.rate_limit_batch(*batch)
                sync()
                dt = time.perf_counter() - t0
                out["cluster_s"] += dt
                out["batch_ms"].append(dt * 1e3)
                out["window_launches"] += fused.LAUNCHES - l0
                out["decided"] += sum(decided) - d0
                if exact_all:
                    owners = ring.owners_of(batch_crc32(
                        [k.encode() for k in batch[0]]))
                    out["expected"] += len(np.unique(owners))
                t0 = time.perf_counter()
                want = single.rate_limit_batch(*batch)
                sync()
                out["single_s"] += time.perf_counter() - t0
                if (got.status != 0).any():
                    raise AssertionError(
                        f"{where}: {(got.status != 0).sum()} client "
                        "failures")
                keep = np.array([k not in tainted for k in batch[0]])
                for f in CLUSTER_FIELDS:
                    a, b = getattr(got, f), getattr(want, f)
                    if (a[keep] != b[keep]).any():
                        raise AssertionError(
                            f"{where} batch {i}: {f} differs from the "
                            "single-device limiter")
                    out["tainted_mismatches"] += int((a != b).sum())
                out["rows"] += len(batch[0])
            return out

        # Steady state: all three up.
        steady = drive(traffic[:CLUSTER_STEADY], [0, 1, 2], "steady", True)
        if steady["decided"] != steady["expected"]:
            raise AssertionError(
                f"{steady['decided']} owner sub-batches decided, "
                f"{steady['expected']} owners in the batches")
        if device == "cuda" and steady["window_launches"] != steady[
                "decided"]:
            raise AssertionError(
                f"{steady['window_launches']} window launches for "
                f"{steady['decided']} owner-decided sub-batches")
        record["steady"] = steady
        cursor = CLUSTER_STEADY

        # An exhausted key of node 2's range: burst 2, four hits.
        hot = next(k for k in (f"cluster:hot:{i}" for i in range(10_000))
                   if ring.owner_of(k.encode()) == 2)
        hot_batch = ([hot], np.array([2]), np.array([2]), np.array([600]),
                     np.array([1]))
        now = int(traffic[cursor - 1][5])
        for j in range(4):
            a = nodes[2].cl.rate_limit_batch(*hot_batch, now + j)
            b = single.rate_limit_batch(*hot_batch, now + j)
            if a.allowed.tolist() != b.allowed.tolist():
                raise AssertionError("hot key differs from the single")
        if a.allowed[0]:
            raise AssertionError("hot key not exhausted")

        def step_record(name, batches, via, exact_all, t_step):
            g0, r0 = row_ops.GATHER_LAUNCHES, row_ops.SCATTER_LAUNCHES
            out = drive(batches, via, name, exact_all)
            sync()
            gathers, scatters, exports, inserts = rows.take()
            out["row_gather"] = row_ops.GATHER_LAUNCHES - g0 + t_step[0]
            out["row_scatter"] = row_ops.SCATTER_LAUNCHES - r0 + t_step[1]
            out["expected_row_gather"] = gathers + t_step[2]
            out["expected_row_scatter"] = scatters + t_step[3]
            out["exports"] = t_step[4] + exports
            out["inserts"] = t_step[5] + inserts
            if device == "cuda" and (
                out["row_gather"] != out["expected_row_gather"]
                or out["row_scatter"] != out["expected_row_scatter"]
            ):
                raise AssertionError(
                    f"{name}: row launches {out['row_gather']} gather / "
                    f"{out['row_scatter']} scatter, expected "
                    f"{out['expected_row_gather']} / "
                    f"{out['expected_row_scatter']}")
            if device == "cuda" and out["window_launches"] != out[
                    "decided"]:
                raise AssertionError(
                    f"{name}: {out['window_launches']} window launches for "
                    f"{out['decided']} owner-decided sub-batches")
            return out

        def lifecycle(fn):
            """Run one membership change; its row launches and the
            expected ones until now."""
            quiesce(nodes)
            rows.take()
            g0, r0 = row_ops.GATHER_LAUNCHES, row_ops.SCATTER_LAUNCHES
            t = time.perf_counter()
            fn()
            ms = (time.perf_counter() - t) * 1e3
            sync()
            gathers, scatters, exports, inserts = rows.take()
            return ms, (row_ops.GATHER_LAUNCHES - g0,
                        row_ops.SCATTER_LAUNCHES - r0, gathers, scatters,
                        exports, inserts)

        # Kill node 2: its range fails over to its ring successors, who
        # absorb their replica rows on first use (row_scatter).
        dead_keys = {k for b in traffic[:cursor] for k in b[0]
                     if ring.owner_of(k.encode()) == 2}

        def kill():
            nodes[2].kill()
            nodes[2] = None
        kill_ms, t_kill = lifecycle(kill)
        tainted |= dead_keys
        batches = traffic[cursor:cursor + CLUSTER_STEP]
        cursor += CLUSTER_STEP
        t = time.perf_counter()
        kill_rec = step_record("kill", batches, [0, 1], False, t_kill)
        a = nodes[0].cl.rate_limit_batch(*hot_batch, now + 10)
        b = single.rate_limit_batch(*hot_batch, now + 10)
        if a.status[0] != 0 or a.allowed[0] or b.allowed[0]:
            raise AssertionError("takeover re-allowed the exhausted key")
        kill_rec["takeover_rows"] = sum(n for n, _ in kill_rec["inserts"])
        kill_rec["takeover_ms"] = [ms for _, ms in kill_rec["inserts"]]
        kill_rec["takeovers"] = sum(n.cl.takeover_count for n in nodes
                                    if n is not None)
        if kill_rec["takeovers"] < 1 or kill_rec[
                "expected_row_scatter"] < 1:
            raise AssertionError(f"no takeover after the kill: {kill_rec}")
        record["kill"] = kill_rec

        # Rejoin node 2 (fresh): each peer exports its table (row_gather)
        # and migrates node 2's range back, installed with row_scatter.
        def rejoin():
            # A fresh incarnation counts from zero on both sides.
            for n in nodes:
                if n is not None:
                    n.sent.pop(2, None)
                    n.applied.pop(2, None)
            nodes[2] = ClusterNode(2, nodes_spec, device, decided, mu)
            join_node(nodes[2], nodes)
        rejoin_ms, t_rejoin = lifecycle(rejoin)
        batches = traffic[cursor:cursor + CLUSTER_STEP]
        cursor += CLUSTER_STEP
        rejoin_rec = step_record("rejoin", batches, [2, 0, 1], False,
                                 t_rejoin)
        rejoin_rec["ms"] = rejoin_ms
        rejoin_rec["migrated_in"] = nodes[2].cl.migrated_in
        a = nodes[2].cl.rate_limit_batch(*hot_batch, now + 20)
        if a.status[0] != 0 or a.allowed[0]:
            raise AssertionError("rejoin lost the exhausted key's state")
        single.rate_limit_batch(*hot_batch, now + 20)
        if rejoin_rec["migrated_in"] < 1 or rejoin_rec[
                "expected_row_gather"] < 1:
            raise AssertionError(f"no migrate back: {rejoin_rec}")
        record["rejoin"] = rejoin_rec

        # Planned leave of node 1: its whole table streams out
        # (row_gather), each receiver reconciles against its own table
        # (row_gather) and installs the rows (row_scatter).
        left = []
        leave_ms, t_leave = lifecycle(lambda: left.append(
            nodes[1].cl.leave()))
        if left != [True]:
            raise AssertionError("planned leave did not ack")
        quiesce(nodes)
        batches = traffic[cursor:cursor + CLUSTER_STEP]
        cursor += CLUSTER_STEP
        leave_rec = step_record("leave", batches, [0, 2, 1], False, t_leave)
        leave_rec["ms"] = leave_ms
        leave_rec["keys"] = len(nodes[1].limiter)
        leave_rec["leaves"] = nodes[0].cl.cluster_view()["leaves"]
        if leave_rec["leaves"] < 1:
            raise AssertionError("the survivors saw no leave")
        record["leave"] = leave_rec
        record["kill_ms"] = kill_ms
        record["boot_ms"] = boot_ms
        record["keys_per_node"] = [len(n.limiter) for n in nodes]
        record["replica_rows"] = [n.cl.cluster_view()["replica_rows"]
                                  for n in nodes]
    finally:
        rows.close()
        for n in nodes:
            if n is not None:
                try:
                    n.kill()
                except Exception:
                    pass
    return record


def cluster_server(index, nodes, http_port, redis_port):
    """`python -m throttlecrab_tpu_torch.server` as node `index` of
    `nodes` on the card: asyncio HTTP, native RESP."""
    return subprocess.Popen(
        [sys.executable, "-m", "throttlecrab_tpu_torch.server", "--http",
         "--http-host", "127.0.0.1", "--http-port", str(http_port),
         "--redis", "--redis-host", "127.0.0.1", "--redis-port",
         str(redis_port), "--redis-backend", "native",
         "--cluster-nodes", ",".join(nodes), "--cluster-index", str(index),
         "--cluster-bind-host", "127.0.0.1"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def wait_healthy(proc, http_port, seconds=180):
    deadline = time.monotonic() + seconds
    while True:
        if proc.poll() is not None:
            raise AssertionError(f"cluster node exited {proc.returncode}:"
                                 f"\n{proc.stdout.read()}")
        try:
            if http(http_port, "GET", "/health", timeout=2)[1] == b"OK":
                return
        except OSError:
            pass
        if time.monotonic() > deadline:
            raise AssertionError("cluster node did not come up")
        time.sleep(0.25)


def harness_run(transport, port, key_space, tag):
    """`python -m throttlecrab_tpu_torch.harness perf-test` against one
    node; its JSON summary."""
    flag = "--redis-port" if transport == "redis" else "--port"
    r = subprocess.run(
        [sys.executable, "-m", "throttlecrab_tpu_torch.harness", "perf-test",
         "--transport", transport, flag, str(port), "--workers", "16",
         "--requests", "500", "--key-space", str(key_space),
         "--key-pattern", "zipfian", "--seed", str(tag)],
        capture_output=True, text=True, timeout=600)
    if r.returncode != 0:
        raise AssertionError(f"harness {transport}: rc {r.returncode}\n"
                             f"{r.stderr[-2000:]}")
    out = json.loads(r.stdout.strip().splitlines()[-1])
    if out["errors"]:
        raise AssertionError(f"harness {transport}: {out}")
    return out


def run_cluster_servers(card):
    """Phase 16b: two server processes on the card as one cluster."""
    from throttlecrab_tpu_torch.parallel.ring import HashRing

    rpc = [free_port(), free_port()]
    http_ports = [free_port(), free_port()]
    redis_ports = [free_port(), free_port()]
    nodes = [f"127.0.0.1:{p}" for p in rpc]
    ring = HashRing(nodes, CLUSTER_VNODES)
    procs = []
    out = {}
    try:
        t = time.perf_counter()
        for i in (0, 1):
            procs.append(cluster_server(i, nodes, http_ports[i],
                                        redis_ports[i]))
        for p, port in zip(procs, http_ports):
            wait_healthy(p, port)
        wait_until(lambda: all(
            not json.loads(http(p, "GET", "/health/cluster")[1])[
                "pending_handoffs"] for p in http_ports), "the handoffs")
        out["boot_s"] = time.perf_counter() - t

        def hit(port, key, burst=3):
            return json.loads(http(port, "POST", "/throttle",
                                   throttle_body(key, burst))[1])
        key1 = next(k for k in (f"xproc:{i}" for i in range(10_000))
                    if ring.owner_of(k.encode()) == 1)
        seq = [hit(http_ports[0], key1)["allowed"],
               hit(http_ports[0], key1)["allowed"],
               hit(http_ports[1], key1)["allowed"],
               hit(http_ports[0], key1)["allowed"]]
        if seq != [True, True, True, False]:
            raise AssertionError(f"limit across frontends: {seq}")
        out["harness"] = {
            "redis_node0": harness_run("redis", redis_ports[0], 100_000, 1),
            "http_node1": harness_run("http", http_ports[1], 100_000, 2),
            "redis_node1": harness_run("redis", redis_ports[1], 100_000, 3),
            "http_node0": harness_run("http", http_ports[0], 100_000, 4),
        }
        view = json.loads(http(http_ports[0], "GET", "/health/cluster")[1])
        if view["mode"] != "ring" or view["epoch"] < 1 or nodes[1] not in (
                view["peers"]):
            raise AssertionError(f"/health/cluster: {view}")
        metrics = http(http_ports[0], "GET", "/metrics")[1].decode()
        fwd = [int(line.split()[-1]) for line in metrics.splitlines()
               if line.startswith("throttlecrab_cluster_forwarded_total{")]
        if not fwd or fwd[0] < 1:
            raise AssertionError("/metrics counts no forwards")
        out["forwarded_total"] = fwd[0]
        out["epoch"] = view["epoch"]
        # SIGTERM on node 1 mid-bucket: the drain's planned leave hands
        # its range to node 0, which continues the bucket.
        key_h = next(k for k in (f"handover:{i}" for i in range(10_000))
                     if ring.owner_of(k.encode()) == 1)
        rem = [hit(http_ports[1], key_h)["remaining"] for _ in range(2)]
        if rem != [2, 1]:
            raise AssertionError(f"handover key: {rem}")
        t = time.perf_counter()
        log = stop_server(procs[1])
        out["leave_s"] = time.perf_counter() - t
        if "leaving cluster" not in log or "drain complete" not in log:
            raise AssertionError(f"no planned leave in the log:\n{log}")
        seq = [hit(http_ports[0], key_h)["allowed"] for _ in range(2)]
        if seq != [True, False]:
            raise AssertionError(f"survivor lost the migrated bucket: {seq}")
        view = json.loads(http(http_ports[0], "GET", "/health/cluster")[1])
        if view["leaves"] != 1 or view["takeovers"] != 0:
            raise AssertionError(f"after the leave: {view}")
        out["migrated_in"] = view["migrated_in"]
        stop_server(procs[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=30)
    return out


def run_cluster(card):
    """Phase 16: the cluster tier on the card.  Returns its record."""
    t = time.perf_counter()
    rec = run_cluster_in_process(card)
    in_s = time.perf_counter() - t
    st = rec["steady"]
    rate = st["rows"] / st["cluster_s"]
    single_rate = st["rows"] / st["single_s"]
    med = sorted(st["batch_ms"])[len(st["batch_ms"]) // 2]
    print(f"  3 nodes x 2^20 (W=6, native keymaps) on one card, "
          f"{st['rows']} config-3 decisions through 3 frontends: "
          f"{rate:.0f} decisions/s through the cluster vs {single_rate:.0f} "
          f"on the single-device limiter, identical batch by batch; median "
          f"{med:.2f} ms per 4096-row batch (forwards included); "
          f"{st['window_launches']} window launches = {st['decided']} owner "
          f"sub-batches ({card})")
    for name in ("kill", "rejoin", "leave"):
        r = rec[name]
        moved = {"kill": r.get("takeover_rows"),
                 "rejoin": r.get("migrated_in"),
                 "leave": r.get("keys")}[name]
        print(f"  {name}: {moved} keys moved, {r.get('ms', rec['kill_ms']):.1f}"
              f" ms; exports {[n for n, _ in r['exports']]} rows "
              f"({[round(ms, 1) for _, ms in r['exports']]} ms), inserts "
              f"{[n for n, _ in r['inserts']]} rows "
              f"({[round(ms, 1) for _, ms in r['inserts']]} ms); row_gather "
              f"{r['row_gather']} (expected {r['expected_row_gather']}), "
              f"row_scatter {r['row_scatter']} (expected "
              f"{r['expected_row_scatter']}); {r['window_launches']} window "
              f"launches = {r['decided']} owner sub-batches; 0 client "
              f"failures; {r['tainted_mismatches']} rows of the killed "
              f"range differ from the single-device limiter")
    t = time.perf_counter()
    srv = run_cluster_servers(card)
    srv_s = time.perf_counter() - t
    for name, h in srv["harness"].items():
        print(f"  server {name}: {h['rps']} replies/s, p50 {h['p50_ms']} ms, "
              f"p99 {h['p99_ms']} ms, {h['allowed']} allowed / "
              f"{h['denied']} denied / 0 errors ({card})")
    print(f"  2 server nodes: a key of node 1 limited across both "
          f"frontends; {srv['forwarded_total']} forwards counted; SIGTERM "
          f"on node 1: planned leave in {srv['leave_s']:.1f} s, exit 0, "
          f"the survivor continues its bucket ({srv['migrated_in']} keys "
          f"migrated in); phase 16a {in_s:.1f} s, 16b {srv_s:.1f} s")
    return {"cluster": rec, "cluster_servers": srv,
            "cluster_decisions_per_s": rate,
            "cluster_single_decisions_per_s": single_rate,
            "cluster_median_batch_ms": med,
            "cluster_phase_s": {"in_process": in_s, "servers": srv_s}}


# ---- the static invariant suite (phase 17) ------------------------------- #


def run_invariants(card):
    """Run the port's invariant suite over the tree this script sits in,
    in a subprocess, and fail on any finding, stale or violated waiver,
    heavy import or nonzero exit.  Returns the suite's JSON report."""
    root = os.path.dirname(os.path.abspath(__file__))
    t0 = time.monotonic()
    proc = subprocess.run(
        [sys.executable, "-m", "throttlecrab_tpu_torch.analysis", "--strict",
         "--json", "--root", root],
        cwd=root, capture_output=True, text=True, timeout=300,
    )
    wall = time.monotonic() - t0
    try:
        report = json.loads(proc.stdout)
    except ValueError:
        raise AssertionError(
            f"the invariant suite printed no report (exit "
            f"{proc.returncode}): {proc.stderr[-2000:]}") from None
    imported = {m: report[f"{m}_imported"] for m in ("torch", "numpy", "jax")}
    print(f"  {len(report['findings'])} unwaived finding(s), "
          f"{report['waived']} waived, {len(report['stale_waivers'])} stale "
          f"or violated waiver(s); torch_imported {imported['torch']}, "
          f"numpy_imported {imported['numpy']}, jax_imported "
          f"{imported['jax']}")
    print(f"  seconds per checker: {json.dumps(report['checker_s'])}")
    print(f"  suite {report['elapsed_s']:.3f} s, phase wall {wall:.3f} s "
          f"({card})")
    for f in report["findings"]:
        print(f"  {f['path']}:{f['line']}: {f['code']} [{f['symbol']}] "
              f"{f['message']}")
    if (proc.returncode != 0 or report["findings"]
            or report["stale_waivers"] or any(imported.values())):
        raise AssertionError(
            f"the invariant suite failed (exit {proc.returncode}): "
            f"{proc.stderr[-2000:]}")
    return report


# ---- the tier-ladder campaign (phase 18) ---------------------------------- #


CAMPAIGN_SEEDS = 24  # the JAX campaign's CI run: --seeds 24 --steps 10
CAMPAIGN_STEPS = 10
ALTERNATE_SEEDS = (3100, 3101)  # edges (4-wide) and hostile (insight, 6-wide)
ALTERNATE_STEPS = 6
HOTKEY_SEEDS = 24
CODEC_SEEDS = 6  # the codec arms touch no card: fewer than the CI run's 24
WIDE_SEEDS = (3000, 3001, 3002)  # benign, edges, hostile
WIDE_WINDOWS = 12  # the oracle: ~0.7 s a window of K x B on the card host


def campaign_arm(fz, name, fn):
    """Run one arm of the campaign; returns (fn's value, the arm's record:
    what TOTAL moved by, and seconds with the card drained)."""
    import torch

    mark = dict(fz.TOTAL, tiers=dict(fz.TOTAL["tiers"]))
    t = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    rec = {key: fz.TOTAL[key] - mark[key] for key in fz.TOTAL
           if key != "tiers"}
    rec["tiers"] = {t: fz.TOTAL["tiers"][t] - mark["tiers"][t]
                    for t in fz.TOTAL["tiers"]}
    rec["seconds"] = time.perf_counter() - t
    if rec["launches"] != rec["card_windows"]:
        raise AssertionError(f"phase 18 {name}: {rec['launches']} window "
                             f"launches for {rec['card_windows']} windows "
                             "decided on the card")
    print(f"  {name}: {rec['requests']} requests, {rec['windows']} windows, "
          f"tiers {rec['tiers']}; {rec['launches']} window launches = "
          f"{rec['card_windows']} windows on the card; row_gather "
          f"{rec['row_gather']} / row_scatter {rec['row_scatter']} launches "
          f"for {rec['rows_gathered']} / {rec['rows_scattered']} rows; oracle "
          f"{rec['oracle_s']:.2f} s of {rec['seconds']:.2f} s")
    return out, rec


def run_campaign(card):
    """Phase 18: the port's tier-ladder campaign on the card against the
    scalar oracle.  Returns its record; any divergence, a tier the phase
    never rode, or a launch count off by one fails the run."""
    from throttlecrab_tpu_torch.tools import fuzz_wire_tiers as fz

    t_phase = time.perf_counter()
    mesh = fz.campaign_mesh("cuda")
    arms = {}
    _, arms["ladder"] = campaign_arm(fz, "ladder", lambda: [
        fz.run_seed(3000 + s, CAMPAIGN_STEPS, mesh)
        for s in range(CAMPAIGN_SEEDS)])
    _, arms["alternate"] = campaign_arm(fz, "alternate", lambda: [
        fz.run_seed(s, ALTERNATE_STEPS, mesh, alternate=True,
                    insight_single=bool(s % 2)) for s in ALTERNATE_SEEDS])
    hits, arms["hotkey"] = campaign_arm(fz, "hotkey", lambda: [
        fz.run_hotkey_deny_seed(4000 + s, CAMPAIGN_STEPS * 2)
        for s in range(HOTKEY_SEEDS)])
    _, arms["cluster_frames"] = campaign_arm(fz, "cluster_frames", lambda: [
        fz.run_cluster_frame_fuzz(5000 + s, CAMPAIGN_STEPS * 40)
        for s in range(CODEC_SEEDS)])
    _, arms["trace_frames"] = campaign_arm(fz, "trace_frames", lambda: [
        fz.run_trace_frame_fuzz(6000 + s, CAMPAIGN_STEPS * 20)
        for s in range(CODEC_SEEDS)])
    wide, arms["wide"] = campaign_arm(fz, "wide", lambda: [
        fz.run_wide_seed(s, WIDE_WINDOWS) for s in WIDE_SEEDS])
    for rec in wide:
        snap = rec["snapshot"]
        want = [-(-n // ROW_CHUNK) for n in (snap["keys"], snap["restored"])]
        if [rec["row_gather"], rec["row_scatter"]] != want:
            raise AssertionError(f"phase 18 wide seed {rec['seed']}: row "
                                 f"launches {rec['row_gather']}, "
                                 f"{rec['row_scatter']}; expected {want}")
        print(f"  wide seed {rec['seed']} ({rec['profile']}): "
              f"{rec['requests']} requests in {rec['windows']} windows of "
              f"K={rec['k']} x B={rec['b']}; tiers {rec['tiers']} "
              f"({rec['wire_refused']} wire windows handed back); snapshot "
              f"of {snap['keys']} keys, {snap['restored']} restored: "
              f"row_gather {rec['row_gather']}, row_scatter "
              f"{rec['row_scatter']} (expected {want}); {rec['launches']} "
              f"window launches = {rec['card_windows']} windows on the card; "
              f"oracle {rec['oracle_s']:.2f} s of {rec['seconds']:.2f} s")
    tiers = {t: sum(a["tiers"][t] for a in arms.values())
             for t in fz.TOTAL["tiers"]}
    if min(tiers.values()) == 0:
        raise AssertionError(f"phase 18 rode no window of a tier: {tiers}")
    if sum(hits) == 0:
        raise AssertionError("phase 18: the deny cache never served")
    seconds = time.perf_counter() - t_phase
    oracle_s = sum(a["oracle_s"] for a in arms.values())
    print(f"  tier mix {tiers}; deny-cache hits {sum(hits)}; "
          f"{sum(a['requests'] for a in arms.values())} requests over "
          f"{sum(a['windows'] for a in arms.values())} windows, 0 divergences;"
          f" oracle {oracle_s:.1f} s = {oracle_s / seconds:.3f} of the phase's "
          f"{seconds:.1f} s ({card})")
    return {"arms": arms, "wide": wide, "tiers": tiers, "seconds": seconds,
            "oracle_share": oracle_s / seconds, "deny_hits": sum(hits)}


# ---- launch cost, gates, transport driver, examples (phase 19) ---------- #


TRANSPORT_PORTS = (58080, 58070, 58060)  # run-transport-test.sh's ports
TRANSPORT_RUNS = ("http", "redis")  # the card's machine has no grpcio
TRANSPORT_ARGS = ("--native", "-T", "4", "-r", "200", "--warm", "64")


def example_lines(device):
    """{example: fragments its stdout must hold, in order}: the decision
    lines, which the CPU tests hold equal to the JAX examples' (a line
    that prints a time or a rate contributes only its decision part)."""
    return {
        "basic": [
            *(f"request {i}: allowed=True remaining={4 - i} "
              "retry_after=0.000s" for i in range(5)),
            *(f"request {i}: allowed=False remaining=0 retry_after=0.600s"
              for i in (5, 6)),
        ],
        "batch_tpu": [
            "batch 1: 4096/4096 allowed",
            "hot key: 10/64 allowed (burst 10 → first 10: True)",
            "sweep freed 4097 slots, 0 live",
            "heterogeneous batch: 1024/1024 allowed",
        ],
        "byid_launch": [
            "decided 4096 requests: 4096 allowed; remaining[0..4] = "
            "[10, 13, 15, 21]",
            "hot key: 12/64 allowed (burst 12,",
            "ids20+w32 (6.5 B/request): 4096 allowed; reset_s[0..4] = "
            "[4, 1, 8, 0]",
        ],
        "capacity_test": [
            "initial capacity: 1024 slots (16 KiB HBM)",
            "after 10240 unique keys: capacity=16384, live=10240",
            "sweep at +1h freed 10240 slots; live=0",
            "second wave of 10240 keys reused slots: capacity 16384 -> "
            "16384 (no growth)",
            "memory model: 256 KiB HBM for 16384 slots (16 B/slot)",
        ],
        "access_patterns": [
            "sequential:", "(65536 allowed, 10000 live keys)",
            "random:", "(65536 allowed, 9988 live keys)",
            "hot_key:", "(65536 allowed, 5369 live keys)",
            "zipfian:", "(31912 allowed, 6236 live keys)",
        ],
        "store_comparison": [
            "periodic:", "23 sweeps, 42570 slots reclaimed, 1933 live",
            "probabilistic:", "48 sweeps, 44620 slots reclaimed, 996 live",
            "adaptive:", "47 sweeps, 44620 slots reclaimed, 996 live",
        ],
        "performance_demo": ["\n2000 decisions in ",
                             f"\n{64 * 4096} decisions in "],
        "sharded_mesh": [
            "mesh: 1 shard(s) on ['cuda:0']" if device == "cuda"
            else "mesh: 1 shard(s) on ['cpu']",
            "8192/8192 allowed", "global allowed=8192 denied=0",
        ],
        "http_client": [
            *(f"request {i + 1:2d}: allowed  remaining={9 - i}"
              for i in range(10)),
            "request 11: DENIED (retry after ", "request 12: DENIED (retry",
            "user:1: allowed=True remaining=2",
            "user:2: allowed=True remaining=2",
            "user:1: allowed=True remaining=1",
            "request 1: allowed=True remaining=5",
            "request 2: allowed=True remaining=0",
            "request 3: allowed=False remaining=0",
            "/health -> OK", "throttlecrab_requests_total 18",
        ],
    }


def check_fragments(name, out, fragments):
    at = 0
    for frag in fragments:
        i = out.find(frag, at)
        if i < 0:
            raise AssertionError(f"example {name}: {frag!r} missing after "
                                 f"offset {at} of its output:\n{out}")
        at = i + len(frag)


def run_example(name, device, url=None):
    """`python -m throttlecrab_tpu_torch.examples.<name>` in a process of
    its own: (stdout, seconds); a nonzero exit fails the run."""
    args = ["--url", url] if url else []
    if device == "cpu" and name not in ("basic", "http_client"):
        args.append("--cpu")
    t = time.perf_counter()
    r = subprocess.run(
        [sys.executable, "-m", f"throttlecrab_tpu_torch.examples.{name}",
         *args], capture_output=True, text=True, timeout=600,
        cwd=os.path.dirname(os.path.abspath(__file__)))
    if r.returncode != 0:
        raise AssertionError(f"example {name} exited {r.returncode}:\n"
                             f"{r.stdout}\n{r.stderr[-3000:]}")
    return r.stdout, time.perf_counter() - t


def run_http_client(device):
    """The http_client example against a server booted for it."""
    proc, http_port, _ = boot_server(
        "python", () if device == "cuda" else ("--device", "cpu"))
    try:
        return run_example("http_client", device,
                           url=f"http://127.0.0.1:{http_port}")
    finally:
        stop_server(proc)


def check_ports_free(ports):
    """Raise unless each port can be bound as the servers bind it
    (SO_REUSEADDR: a closed connection's TIME_WAIT does not count)."""
    for port in ports:
        with socket.socket() as s:
            s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            try:
                s.bind(("0.0.0.0", port))
            except OSError:
                raise AssertionError(
                    f"port {port} is taken (a server of an earlier phase "
                    "still running?): the transport driver serves on "
                    f"{ports}") from None


def run_transport_driver(transport, device):
    """tools/run-transport-test.sh -t `transport` with TRANSPORT_ARGS; its
    harness summaries (0 errors each) and seconds."""
    root = os.path.dirname(os.path.abspath(__file__))
    check_ports_free(TRANSPORT_PORTS)
    env = dict(os.environ, PATH=os.path.dirname(sys.executable) + os.pathsep
               + os.environ.get("PATH", ""))
    t = time.perf_counter()
    r = subprocess.run(
        ["bash", os.path.join(root, "throttlecrab_tpu_torch", "tools",
                              "run-transport-test.sh"), "-t", transport,
         *TRANSPORT_ARGS, *(["--cpu"] if device == "cpu" else [])],
        capture_output=True, text=True, timeout=600, env=env, cwd=root)
    seconds = time.perf_counter() - t
    lines = r.stdout.strip().splitlines()
    if r.returncode != 0 or not lines or lines[-1] != "done":
        raise AssertionError(f"run-transport-test.sh -t {transport} exited "
                             f"{r.returncode}:\n{r.stdout}\n"
                             f"{r.stderr[-3000:]}")
    summaries = [json.loads(line) for line in lines if line.startswith("{")]
    for summary in summaries:
        if summary["errors"] or summary["transport"] != transport:
            raise AssertionError(f"run-transport-test.sh -t {transport}: "
                                 f"{summary}")
    if len(summaries) != 1:
        raise AssertionError(f"run-transport-test.sh -t {transport} printed "
                             f"{len(summaries)} summaries")
    return summaries[0], seconds


def run_control_gate():
    r = subprocess.run(
        [sys.executable, "-m", "throttlecrab_tpu_torch.tools."
         "control_determinism"], capture_output=True, text=True, timeout=600,
        cwd=os.path.dirname(os.path.abspath(__file__)))
    if r.returncode != 0 or not r.stdout.startswith("PASS: "):
        raise AssertionError(f"control gate exited {r.returncode}:\n"
                             f"{r.stdout}\n{r.stderr[-3000:]}")
    return r.stdout.strip()


def profile_launch_child(device):
    """Phase 19a: tools/profile_launch.py at its default shape with a
    trace on `device`, then step 3's first window again on the CPU.
    Returns (report, fused.LAUNCHES moved, first window equal, seconds of
    the cpu window)."""
    import torch

    from throttlecrab_tpu_torch.tools import profile_launch as pl
    from throttlecrab_tpu_torch.tpu import fused

    def say(line):
        print(f"  {line}", flush=True)

    with tempfile.TemporaryDirectory() as tmp:
        before = fused.LAUNCHES
        t = time.perf_counter()
        report, (out, state) = pl.profile(torch.device(device),
                                          trace_dir=tmp, log=say)
        moved = fused.LAUNCHES - before
        if not os.path.getsize(report["trace_path"]):
            raise AssertionError("profile_launch wrote an empty trace")
        report["seconds"] = time.perf_counter() - t
    t = time.perf_counter()
    want_out, want_state = pl.first_window("cpu")
    equal = torch.equal(out, want_out) and torch.equal(state, want_state)
    return report, moved, equal, time.perf_counter() - t


def run_tools(card, device="cuda"):
    """Phase 19: the launch-cost profile and its probes, the 1-device mesh
    probe, both determinism gates, the transport driver and every example,
    on `device`.  Returns the phase's record for the kernels line."""
    import torch

    from throttlecrab_tpu_torch.tools import (
        probe_async,
        probe_d2h,
        probe_duplex,
        probe_sharded_1dev,
        replay_determinism,
    )
    from throttlecrab_tpu_torch.tpu import fused

    t_phase = time.perf_counter()
    dev = torch.device(device)
    rec = {"launches": {}, "counted": {}}

    def say(line):
        print(f"  {line}", flush=True)

    # (a) the launch-cost profile at its full default shape, with a trace,
    # in a process of its own: a fresh CUDA context and profiler, where
    # late in this process the profiler recorded no kernel for step 3.
    if device == "cuda":
        with ProcessPoolExecutor(
                1, mp_context=multiprocessing.get_context("spawn")) as pool:
            report, moved, equal, cpu_s = pool.submit(
                profile_launch_child, device).result()
    else:
        report, moved, equal, cpu_s = profile_launch_child(device)
    rec["launches"]["profile_launch"] = moved
    rec["counted"]["profile_launch"] = report["launches_counted"]
    if not equal:
        raise AssertionError("profile_launch step 3's first window differs "
                             "from the device='cpu' run")
    if device == "cuda" and report["compute_device_ms"] is None:
        raise AssertionError("profile_launch step 3's device time is null")
    say(f"step 3's first window (K=16 x B=4096, 2^21 slots): output and "
        f"state equal the device='cpu' run ({cpu_s:.1f} s on the host); "
        f"{moved} window launches = {report['launches_counted']} counted; "
        f"device {report['compute_device_ms']} ms a window, in a process of "
        f"its own ({card})")
    rec["profile_launch"] = report

    # (b) the transfer probes at JAX's default sizes.
    before = fused.LAUNCHES
    counts = probe_async.run(dev, out=say)
    rec["launches"]["probe_async"] = fused.LAUNCHES - before
    rec["counted"]["probe_async"] = counts["launches"]
    rec["probe_d2h_ms"] = {k: v * 1e3 for k, v in
                           probe_d2h.run(dev, out=say).items()}
    rec["probe_duplex"] = probe_duplex.run(dev, out=say)

    # (c) the 1-device mesh probe.
    before = fused.LAUNCHES
    report1, counts = probe_sharded_1dev.run(dev)
    rec["launches"]["probe_sharded_1dev"] = fused.LAUNCHES - before
    rec["counted"]["probe_sharded_1dev"] = counts["windows"]
    say(f"probe_sharded_1dev: {json.dumps(report1)}")
    if not (report1["sharded_1dev_ok"] and report1["plain_ok"]):
        raise AssertionError("probe_sharded_1dev would exit 1")

    # (d) the replay gate on the device.
    before = fused.LAUNCHES
    t = time.perf_counter()
    rc, counts, line = replay_determinism.run(24, dev)
    if rc:
        raise AssertionError(f"replay gate: {line}")
    rec["launches"]["replay_determinism"] = counts["launches"]
    rec["counted"]["replay_determinism"] = counts["expected_launches"]
    rec["replay_gate_all_launches"] = fused.LAUNCHES - before
    say(f"replay gate: {line}; {counts['launches']} window launches in the "
        f"3 replays for {counts['expected_launches']} conflict rounds "
        f"({rec['replay_gate_all_launches']} with the recording), "
        f"{time.perf_counter() - t:.1f} s")
    if device == "cuda" and rec["launches"] != rec["counted"]:
        raise AssertionError(f"window launches {rec['launches']} differ from "
                             f"the counts {rec['counted']}")

    # (e)-(g) the control gate and every example, in processes of their
    # own while the transport driver runs its two servers in turn.
    t = time.perf_counter()
    with ThreadPoolExecutor(6) as pool:
        control = pool.submit(run_control_gate)
        examples = {name: pool.submit(run_example, name, device)
                    for name in example_lines(device) if name != "http_client"}
        examples["http_client"] = pool.submit(run_http_client, device)
        rec["transport_driver"] = {}
        for transport in TRANSPORT_RUNS:
            summary, seconds = run_transport_driver(transport, device)
            rec["transport_driver"][transport] = {**summary,
                                                  "seconds": seconds}
            say(f"run-transport-test.sh -t {transport} "
                f"{' '.join(TRANSPORT_ARGS)}: {summary['requests']} requests,"
                f" 0 errors, {summary['rps']} replies/s, p50 "
                f"{summary['p50_ms']} ms, p99 {summary['p99_ms']} ms, "
                f"{seconds:.1f} s with the boot")
        say(f"control gate: {control.result()}")
        rec["example_s"] = {}
        for name, fragments in example_lines(device).items():
            stdout, seconds = examples[name].result()
            check_fragments(name, stdout, fragments)
            rec["example_s"][name] = seconds
    say("examples exit 0 with their decision lines: "
        + ", ".join(f"{n} {s:.1f} s" for n, s in rec["example_s"].items())
        + f"; (e)-(g) wall {time.perf_counter() - t:.1f} s")
    rec["seconds"] = time.perf_counter() - t_phase
    say(f"phase {rec['seconds']:.1f} s ({card})")
    return rec


# Phase 20: each probe in a process of its own, the by-id probe once on
# the plain row route and once on the row kernels.  The row-kernel run's
# first scans are held to the plain run's, which --check-cpu holds to
# the cpu's.
ABLATION_RUNS = (
    ("probe_kernel_ablation", ("--check-cpu",)),
    ("probe_byid_ablation", ("--check-cpu",)),
    ("probe_byid_ablation", ("--row-kernels",)),
    ("probe_packed_layout", ("--check-cpu",)),
)
# JAX's label lines, one regex per line each probe must print.
ABLATION_LABELS = {
    "probe_kernel_ablation": [
        rf"cap=2\^21 K=  64 {m:11s}: +\d+\.\d\d ms/launch  \( *\d+\.\d\d M "
        r"dec/s\)  device +\d+\.\d+ ms/scan"
        for m in ("full", "noscatter", "nogather", "elementwise")
    ] + [
        rf"cap=2\^{c} K=  64 full       : " for c in (16, 18, 21)
    ] + [
        rf"cap=2\^21 K={k:4d} full       : " for k in (16, 64, 256)
    ] + [
        rf"d\) d2h +{mb} MB (first|pinned) fetch: +\d+\.\d\d ms"
        for mb in (1, 4, 16)
    ] + [
        r"e\) i32 full compact out= +\d+\.\d MB: .*device +\d",
        r"e\) i8 allowed-only  out= +\d+\.\d MB: .*device +\d",
        r"k\) w32 wire words   out= +\d+\.\d MB: .*device +\d",
        r"k\) i32 4-plane      out= +\d+\.\d MB: .*device +\d",
    ],
    "probe_byid_ablation": [
        rf"{m:12s}: +\d+\.\d\d ms/launch  \( *\d+\.\d{{3}} ms/batch, *"
        r"\d+\.\d\d M dec/s\)  device +\d+\.\d+ ms/scan"
        for m in ("full", "noidrow", "nostate", "noscatter", "elementwise",
                  "width 8", "width 5", "fused_window")
    ],
    "probe_packed_layout": [
        rf"{re.escape(label)}: fetched +\d+\.\d\d ms  queued +\d+\.\d\d ms"
        r"  \( *\d+\.\d\d M dec/s queued\)  device +\d+\.\d+ ms/call"
        for label in ("row-major  [K,B,9] numpy arg ",
                      "field-major [K,9,B] numpy arg",
                      "unpacked 8-array, resident   ",
                      "fused_window [K,B,9] numpy arg")
    ],
}
# Window launches each probe makes (what it must count itself): per
# timed arm the first scan, the untimed and timed ones, then the
# profiler's warm call and its profiled calls.
ABLATION_WINDOWS = {
    "probe_kernel_ablation": 2 * (1 + 1 + 4 + 1 + 2),  # two tiers
    "probe_byid_ablation": 1 + 4 + 1 + 2,  # first, R = 4, profiler
    "probe_packed_layout": 1 + 2 + 6 + 6 + 1 + 2,
}
BYID_SCANS = 1 + 4 + 1 + 2  # every by-id arm's scans
BYID_DEPTH = 256
BYID_ROW_ARMS = ("mode/full", "mode/noidrow", "width/8", "width/5")


def ablation_device_times(name, report):
    """{arm: device ms} of every composed mode and kernel arm a report
    carries."""
    sections = {
        "probe_kernel_ablation": ("ablation", "capacity", "depth",
                                  "outsize", "kernel"),
        "probe_byid_ablation": ("mode", "width", "kernel"),
        "probe_packed_layout": ("arms",),
    }[name]
    return {f"{sec}/{arm}": rec["device_ms"] for sec in sections
            for arm, rec in report[sec].items()}


def run_ablation_probe(name, args):
    """One probe in a process of its own; returns (its report, its stdout
    lines, seconds)."""
    t = time.perf_counter()
    r = subprocess.run(
        [sys.executable, "-m", f"throttlecrab_tpu_torch.tools.{name}",
         *args], capture_output=True, text=True, timeout=900,
        cwd=os.path.dirname(os.path.abspath(__file__)))
    seconds = time.perf_counter() - t
    if r.returncode != 0:
        raise AssertionError(f"{name} {' '.join(args)} exited "
                             f"{r.returncode}:\n{r.stdout[-3000:]}\n"
                             f"{r.stderr[-3000:]}")
    lines = r.stdout.strip().splitlines()
    for line in r.stderr.strip().splitlines()[-2:] + lines[:-1]:
        print(f"    {line}", flush=True)
    return json.loads(lines[-1]), lines[:-1], seconds


def run_ablation(card):
    """Phase 20: the three ablation probes at the JAX scripts' sizes, each
    in a process of its own.  Returns the phase's record."""
    rec = {"reports": {}, "seconds": {}, "fused_launches": {},
           "row_launches": {}}
    t_phase = time.perf_counter()
    for name, args in ABLATION_RUNS:
        tag = " ".join((name,) + args)
        print(f"  {tag}", flush=True)
        report, lines, seconds = run_ablation_probe(name, args)
        for pattern in ABLATION_LABELS[name]:
            if not any(re.match(pattern, line) for line in lines):
                raise AssertionError(f"{tag}: no line matches {pattern!r}")
        if ("--check-cpu" in args
                and report.get("first_equals_cpu") is not True):
            raise AssertionError(f"{tag}: first scans not held to the cpu")
        moved = (report["fused_launches_after"]
                 - report["fused_launches_before"])
        want = ABLATION_WINDOWS[name]
        if not moved == report["launches_counted"] == want:
            raise AssertionError(
                f"{tag}: fused.LAUNCHES moved by {moved}, the probe counted "
                f"{report['launches_counted']} windows, expected {want}")
        nulls = [arm for arm, ms in ablation_device_times(name, report).items()
                 if ms is None]
        if nulls:
            raise AssertionError(f"{tag}: no device time for {nulls}")
        if name == "probe_byid_ablation":
            rows = "--row-kernels" in args
            for arm, moves in report["row_launches"].items():
                if report["scans"][arm] != BYID_SCANS:
                    raise AssertionError(f"{tag}: {arm} made "
                                         f"{report['scans'][arm]} scans")
                want_rows = (BYID_DEPTH * BYID_SCANS
                             if rows and arm in BYID_ROW_ARMS else 0)
                if set(moves.values()) != {want_rows}:
                    raise AssertionError(f"{tag}: {arm} row launches {moves},"
                                         f" expected {want_rows} each")
            rec["row_launches"][tag] = {
                kind: sum(m[kind] for m in report["row_launches"].values())
                for kind in ("row_gather", "row_scatter")}
        rec["reports"][tag] = report
        rec["seconds"][tag] = seconds
        rec["fused_launches"][tag] = moved
        print(f"  {tag}: exit 0 in {seconds:.1f} s, every label, {moved} "
              f"window launches = "
              f"{report['launches_counted']} counted, no null device time "
              f"({card})", flush=True)
    plain = rec["reports"]["probe_byid_ablation --check-cpu"]["first"]
    kern = rec["reports"]["probe_byid_ablation --row-kernels"]["first"]
    differ = [arm for arm in BYID_ROW_ARMS if plain[arm] != kern[arm]]
    if differ:
        raise AssertionError(f"the row kernels' first scans differ from the "
                             f"plain row route's in {differ}")
    print(f"  the row-kernel arm's first scans ({', '.join(BYID_ROW_ARMS)}) "
          f"equal the plain route's on the card; row launches "
          f"{rec['row_launches']}", flush=True)
    rec["phase_s"] = time.perf_counter() - t_phase
    print(f"  phase {rec['phase_s']:.1f} s ({card})", flush=True)
    return rec


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False — this "
              "smoke test needs a CUDA card", file=sys.stderr)
        return 2
    import numpy as np

    from throttlecrab_tpu_torch.tpu import fused, ids_front, row_ops
    from throttlecrab_tpu_torch.tpu.limiter import TorchRateLimiter

    device = torch.device("cuda")
    card = card_line()
    print(f"[1] card: {card}")
    ptxas = {}
    for name, (lib, sec) in build_kernels().items():
        print(f"[1] built {lib.name} in {sec:.1f} s (0 when this checkout "
              "had built it already)")
        ptxas[name] = ptxas_summary(lib.with_suffix(".log").read_text())
        check_ptxas(name, ptxas[name],
                    FRONT_THREADS if name == "ids_front" else FUSED_THREADS)
    # 12 instantiations (2 widths x 6 tiers) of each schedule's kernel
    if len(ptxas["fused_window"]) != 24:
        raise AssertionError(f"{len(ptxas['fused_window'])} decision-window "
                             "instantiations built, expected 24")
    # gather and scatter at (W, part, steps) (4, 4, 1) and (6, 2, 1), and
    # the scatter at (6, 2, 2)
    if len(ptxas["row_ops"]) != 5:
        raise AssertionError(f"{len(ptxas['row_ops'])} row-kernel "
                             "instantiations built, expected 5")
    # the front end's blocks (ids_front.cuh front_geometry)
    if len(ptxas["ids_front"]) != 4:
        raise AssertionError(f"{len(ptxas['ids_front'])} front-end "
                             "instantiations built, expected 4")

    print(f"[2] kernel vs plain on the card: K={K} B={B} "
          f"N={CAPACITY + (1 << 16)}, then cross-block windows at "
          f"B={CROSS_BLOCK_B}, then the one-block schedule at "
          f"K={BLOCK_K} B={BLOCK_B}: hostile windows and windows that "
          "reuse the previous sub-batch's slots")
    cases = [(K, B, 0, "hostile")]
    cases += [(K, b, seed, "cross")
              for seed, b in enumerate(CROSS_BLOCK_B, 1)]
    cases += [(BLOCK_K, BLOCK_B, 7, "hostile"), (BLOCK_K, BLOCK_B, 8, "reuse")]
    fused.BLOCK_LAUNCHES = 0
    fwd_before = fused.forwarded_lanes(device)
    worst = block_windows = forwarded = 0
    for k, b, seed, kind in cases:
        err, n_block, n_fwd = compare_kernel_plain(device, k, b, CAPACITY,
                                                   seed=seed, kind=kind)
        worst, block_windows = max(worst, err), block_windows + n_block
        forwarded += n_fwd
    block_launches = fused.BLOCK_LAUNCHES
    block_forwarded = fused.forwarded_lanes(device) - fwd_before
    if block_launches != block_windows or block_forwarded != forwarded:
        raise AssertionError(
            f"{block_launches} one-block launches and {block_forwarded} "
            f"forwarded lanes; expected the {block_windows} windows of "
            f"B <= {FUSED_THREADS} and the {forwarded} lanes the packed "
            "rows give")
    print(f"  one-block schedule: {block_launches} launches (the windows "
          f"of B <= {FUSED_THREADS}), {block_forwarded} lanes forwarded, "
          "as counted from the packed rows")

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
          f"N={BYID_CAPACITY + (1 << 16)} W=4,6, B={ROW_EDGE_B}, the "
          f"scatter's rows {ROW_OFFSETS} bytes off 16 by width, "
          "out-of-range indices")
    row_worst, row_cases = compare_row_kernels(device,
                                               np.random.default_rng(4))

    print(f"[6] by-id path: TorchRateLimiter(capacity=2^21, keymap='native')"
          f" on cuda, {N_KEYS} keys, config 3 params, K={BYID_K} B={B}")
    keys, em, tol = config3_params(N_KEYS)
    plan = byid_plan(np.random.default_rng(6), N_KEYS)
    fused.LAUNCHES = 0
    row_ops.GATHER_LAUNCHES = row_ops.SCATTER_LAUNCHES = 0
    ids_front.LAUNCHES = ids_front.PLAIN_WINDOWS = 0
    lim_g, rows_g, wires_g, valids, sec_g, split_g = run_byid(
        device, keys, em, tol, plan)
    torch.cuda.synchronize()
    byid_launches = fused.LAUNCHES
    front_launches = (ids_front.LAUNCHES, ids_front.PLAIN_WINDOWS)
    raw_windows = sum(1 for v, _ in plan if v != "byid")
    if front_launches != (raw_windows, 0):
        raise AssertionError(
            f"front-end kernel launches and plain windows {front_launches} "
            f"for {raw_windows} windows of raw ids; expected one launch a "
            "window and no plain window")
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
          f"{byid_row_launches}, front-end kernel launches "
          f"{front_launches[0]} (plain windows {front_launches[1]})")
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
    block_times = time_kernel(device, np.random.default_rng(11), b=BLOCK_B)
    for b, schedule, by_width in ((B, "cluster", times),
                                  (BLOCK_B, "one-block", block_times)):
        for width, t in by_width.items():
            print(f"  fused_window {schedule} B={b} W={width}: kernel "
                  f"{t['ms']:.4f} ms, plain {t['plain_ms']:.4f} ms, bound "
                  f"{bound_ms(K, b, 4, t['rows']):.5f} ms "
                  f"per K={K} w32 window (CUDA-event medians); device time "
                  f"(profiler) kernel {t['device_ms']} ms in "
                  f"{t['kernels_per_call']} kernel per call, plain "
                  f"{t['plain_device_ms']} ms; wrapper host time "
                  f"{t['host_us']:.1f} µs per call")
    row_times = time_row_kernels(device, np.random.default_rng(8))
    for (name, w), t in row_times.items():
        print(f"  {name} W={w}: {row_times_line(t, B, w, B)}")
    front_times = time_front(card)

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
    # 5 rounds, as row_ab.py: a cold median of 3 read two outlier records
    snap_times = time_row_kernels(device, np.random.default_rng(10), b=snap_b,
                                  n=CAPACITY + (1 << 16), rounds=5)
    for (name, w), t in snap_times.items():
        print(f"  {name} W={w}: {row_times_line(t, snap_b, w, snap_b)}")

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
    record, trace14 = run_record_replay(card, resp["resp_replies_per_s"])

    print(f"[15] the mesh at BASELINE config 5's width: "
          f"ShardedTorchRateLimiter over {MESH_SHARDS} shards of the card "
          f"(capacity 2^20 each, native keymaps, insight, "
          f"{MESH_TENANTS} tenants x {MESH_KEYS_PER_TENANT} keys) against "
          f"TorchRateLimiter(capacity=2^23); restarts, the quota, the "
          f"server's --shards, the trace through sharded:D ({card})")
    mesh = run_mesh(card, trace14)
    del trace14

    print(f"[16] the cluster: 3 in-process nodes of "
          f"TorchRateLimiter(capacity=2^20, keymap='native', insight=True) "
          f"on the card under ClusterLimiter(vnodes={CLUSTER_VNODES}, "
          f"replicate=True), BASELINE config 3 traffic against the "
          f"single-device limiter, then kill, rejoin and leave; 2 server "
          f"processes as one cluster driven by the harness ({card})")
    cluster = run_cluster(card)
    crec = cluster["cluster"]
    cluster_steps = ("steady", "kill", "rejoin", "leave")

    print("[17] the static invariant suite over this checkout "
          "(python -m throttlecrab_tpu_torch.analysis --strict --json)")
    run_invariants(card)

    print(f"[18] the tier-ladder campaign on the card against the scalar "
          f"oracle: {CAMPAIGN_SEEDS} ladder seeds x {CAMPAIGN_STEPS} steps "
          f"through dispatch_many, the wire window and a 2-shard mesh of the "
          f"card; seeds {ALTERNATE_SEEDS} beside their cpu twins; "
          f"{HOTKEY_SEEDS} hot-key deny-cache seeds; {CODEC_SEEDS} seeds of "
          f"each codec arm; wide seeds {WIDE_SEEDS} at 2^20 slots, "
          f"{N_KEYS} keys, {WIDE_WINDOWS} windows of K={K} x B={B} ({card})")
    campaign = run_campaign(card)
    campaign_rows = {name: sum(a[name] for a in campaign["arms"].values())
                     for name in ("row_gather", "row_scatter", "rows_gathered",
                                  "rows_scattered")}

    print(f"[19] launch cost, gates, transport driver and examples: "
          f"tools/profile_launch.py at K={K} x B={B} on 2^21 slots with a "
          f"trace, the three transfer probes, the 1-device mesh probe, the "
          f"replay gate on cuda and the control gate, "
          f"run-transport-test.sh -t {' / '.join(TRANSPORT_RUNS)} "
          f"{' '.join(TRANSPORT_ARGS)}, the ten examples but grpc_client "
          f"({card})")
    tools = run_tools(card)
    prof = tools["profile_launch"]

    print(f"[20] the ablation probes at the JAX scripts' sizes, each in a "
          f"process of its own: probe_kernel_ablation (cap 2^21, K=64), "
          f"probe_byid_ablation (K={BYID_DEPTH} x B={B}, 1M id rows; plain "
          f"rows, then the row kernels), probe_packed_layout (K=64 x B={B})"
          f" ({card})")
    ablation = run_ablation(card)
    abl_fused = ablation["fused_launches"]
    abl_rows = ablation["row_launches"]["probe_byid_ablation --row-kernels"]

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
        "block": {
            "kernel": "block_window_kernel",
            "launches": block_launches,
            "forwarded_lanes": block_forwarded,
            "checked_shape": f"K={BLOCK_K} B={BLOCK_B}",
            "ms": block_times[4]["ms"],
            "plain_ms": block_times[4]["plain_ms"],
            "bound_ms": bound_ms(K, BLOCK_B, 4, block_times[4]["rows"]),
            "device_ms": block_times[4]["device_ms"],
            "plain_device_ms": block_times[4]["plain_device_ms"],
            "kernels_per_call": block_times[4]["kernels_per_call"],
            "host_us_per_call": block_times[4]["host_us"],
            "w6_ms": block_times[6]["ms"],
            "w6_bound_ms": bound_ms(K, BLOCK_B, 4, block_times[6]["rows"]),
            "w6_device_ms": block_times[6]["device_ms"],
            "shape": f"K={K} B={BLOCK_B} W=4 w32",
        },
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
        "byid_front_launches": front_launches[0],
        "byid_front_plain_windows": front_launches[1],
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
        "mesh_window_launches": mesh["mesh_window_launches"],
        "mesh_windows": mesh["mesh_windows"],
        "mesh_shards": mesh["mesh_shards"],
        "mesh": mesh["mesh"],
        "mesh_topk_counts": mesh["mesh_topk_counts"],
        "mesh_quota": mesh["mesh_quota"],
        "mesh_replays": mesh["mesh_replays"],
        "cluster_window_launches": {
            step: crec[step]["window_launches"] for step in cluster_steps},
        "cluster_owner_subbatches": {
            step: crec[step]["decided"] for step in cluster_steps},
        "cluster_decisions_per_s": cluster["cluster_decisions_per_s"],
        "cluster_single_decisions_per_s":
            cluster["cluster_single_decisions_per_s"],
        "cluster_median_batch_ms": cluster["cluster_median_batch_ms"],
        "cluster_servers": cluster["cluster_servers"],
        "cluster_phase_s": cluster["cluster_phase_s"],
        "campaign_window_launches": {
            name: a["launches"] for name, a in campaign["arms"].items()},
        "campaign_card_windows": {
            name: a["card_windows"] for name, a in campaign["arms"].items()},
        "campaign_tiers": campaign["tiers"],
        "campaign_s": campaign["seconds"],
        "campaign_oracle_share": campaign["oracle_share"],
        "tools_window_launches": tools["launches"],
        "tools_counted_windows": tools["counted"],
        "launch_cost": {key: prof[key] for key in (
            "ping_ms", "ping_noblockfetch_ms", "h2d_bytes", "h2d_ms",
            "h2d_pinned_ms", "h2d_fused_bytes", "h2d_fused_ms",
            "h2d_fused_pinned_ms", "compute_ms", "compute_p99_ms",
            "compute_event_ms", "compute_device_ms",
            "compute_kernels_per_call", "d2h_bytes", "d2h_ms",
            "d2h_pinned_ms", "e2e_ms", "e2e_p99_ms", "e2e_decisions_per_s",
            "pipelined_ms", "pipelined_decisions_per_s")},
        "duplex": tools["probe_duplex"],
        "d2h_probe_ms": tools["probe_d2h_ms"],
        "transport_driver": tools["transport_driver"],
        "tools_phase_s": tools["seconds"],
        "ablation_path": "phase 20: each ablation probe's kernel arm, one "
                         "window a scan (probe_byid_ablation twice: plain "
                         "rows, then --row-kernels)",
        "ablation_launches": abl_fused,
        "ablation_device_ms": {
            tag: ablation_device_times(tag.split()[0], report)
            for tag, report in ablation["reports"].items()},
        "ablation_s": ablation["seconds"],
        "card": card,
    }]
    kernels.append({
        "name": "ids_front",
        "route": "cuda",
        "source": "throttlecrab_tpu_torch/csrc/ids_front.cu",
        "replaces": None,
        "why": "the by-id front end, composed ops in the JAX package",
        "launches": front_launches[0],
        "identical": all(r["same_as_plain"] for runs in front_times.values()
                         for r in runs["kernel"]),
        "bound_by": "bytes",
        "library_ms": None,
        "ptxas": {k: v[0] for k, v in ptxas["ids_front"].items()},
        "shapes": {shape: front_summary(runs)
                   for shape, runs in front_times.items()},
        "card": card,
    })
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
            "w6_library_device_ms": t6["device_library"],
            "cold_device_ms": t4["cold_kernel"],
            "cold_library_device_ms": t4["cold_library"],
            "w6_cold_device_ms": t6["cold_kernel"],
            "w6_cold_library_device_ms": t6["cold_library"],
            "share_of_bound": row_shares(t4, t6, snap_b, "kernel"),
            "library_share_of_bound": row_shares(t4, t6, snap_b, "library"),
            "sector_bound_ms": {"w4": t4["sector_bound"],
                                "w6": t6["sector_bound"]},
            "phase5_cases": row_cases,
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
            "mesh_path": "sharded snapshot save and checkpoint generation "
                         "(phase 15)" if name == "row_gather" else
                         "sharded snapshot load and recoveries onto 1 and "
                         f"{MESH_SHARDS} shards (phase 15)",
            "mesh_launches_per_shard": {
                part: v[f"{name}_per_shard"]
                for part, v in mesh["mesh_restart"].items()
                if f"{name}_per_shard" in v},
            "mesh_restart_ms": mesh["mesh_restart"],
            "cluster_path": "export_state on join / rejoin / leave and the "
                            "migrate reconcile (phase 16)"
                            if name == "row_gather" else
                            "_bulk_insert of migrates and the takeover's "
                            "replica absorb (phase 16)",
            "cluster_launches": {
                step: {"launches": crec[step][name],
                       "expected": crec[step][f"expected_{name}"]}
                for step in cluster_steps[1:]},
            "cluster_moves": {
                step: crec[step]["exports" if name == "row_gather"
                                 else "inserts"]
                for step in cluster_steps[1:]},
            "campaign_path": "the campaign's snapshot round trips (phase 18)",
            "campaign_launches": campaign_rows[name],
            "campaign_rows": campaign_rows[
                "rows_gathered" if name == "row_gather" else "rows_scattered"],
            "ablation_path": "phase 20: probe_byid_ablation --row-kernels, "
                             f"K={BYID_DEPTH} launches per scan of full, "
                             "noidrow and both widths",
            "ablation_launches": abl_rows[name],
            "b4096": {
                "ms": b4["kernel"], "plain_ms": b4["plain"],
                "library_ms": b4["library"],
                "bound_ms": row_bound_ms(B, 4),
                "device_ms": b4["device_kernel"],
                "library_device_ms": b4["device_library"],
                "w6_ms": b6["kernel"], "w6_device_ms": b6["device_kernel"],
                "w6_library_device_ms": b6["device_library"],
                "cold_device_ms": b4["cold_kernel"],
                "cold_library_device_ms": b4["cold_library"],
                "w6_cold_device_ms": b6["cold_kernel"],
                "w6_cold_library_device_ms": b6["cold_library"],
                "share_of_bound": row_shares(b4, b6, B, "kernel"),
                "sector_bound_ms": {"w4": b4["sector_bound"],
                                    "w6": b6["sector_bound"]},
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
