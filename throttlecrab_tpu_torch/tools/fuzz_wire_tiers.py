"""Differential fuzz campaign of the port: the compact output-tier ladder
(w32 / cur / 4-plane) against the scalar oracle, through every dispatch
path, on the card.

The counterpart of the JAX package's `scripts/fuzz_wire_tiers.py`: the
same arms under the same names, drawing from the numpy generator in the
same order, so a seed is the same stream in both packages.  It aims at
the tier certificates and the host state they carry from one launch to
the next (`tol_hwm`, `now_hwm` and the sticky `cur_safe` of
`tpu/table.py`):

  - params straddling the w32 field bounds (burst near 500-2100,
    tolerance near the 2047 s reset budget, retry near 1023 s);
  - big-tolerance keys that bump tol_hwm mid-stream and force later
    small-tol traffic down a tier;
  - tol >= 2^61 poison keys (cur_safe) mixed into the same stream;
  - degenerate probes (quantity 0), invalid lanes, duplicate segments,
    per-key param churn;
  - clock regressions (now stepping backward: the now_hwm guard);
  - mid-stream sweeps and snapshot save/restore (hwm recovery from
    restored TATs);

against TorchRateLimiter.dispatch_many (native and python keymaps),
dispatch_wire_window (native prep + agg certificate) and the 2-shard
mesh, every valid request held against the scalar oracle
`RateLimiter(PeriodicStore())` of `core/` with the documented wire
truncation (seconds, i32 saturation).

Every arm takes `device`: "cuda" (the default; without a card it
raises) or "cpu" (the plain versions).  On a card each window the
campaign hands a table is counted, and `fused.LAUNCHES` must move by
exactly that count; each snapshot round trip must launch `row_gather`
and `row_scatter` ceil(rows / 65,536) times.  `run_seed(...,
alternate=True)` decides every window twice, on `device` and on a
device="cpu" twin (the kernel beside its plain version), holds both to
the oracle and to each other's state, and hands the state one side wrote
to the other on alternate steps.  `run_wide_seed` is the full-width arm:
BASELINE config 3's deployment (1M keys, Zipf-1.1, K = 16 batches of
4096 per window, a 2^20-slot native-keymap table) under the seed's
parameter profile.

    python -m throttlecrab_tpu_torch.tools.fuzz_wire_tiers \
        [--seeds N] [--steps M] [--no-sharded] [--device cuda|cpu]

Exit 0 and a one-line tally on success; raises on the first divergence.
"""

from __future__ import annotations

import argparse
import asyncio
import os
import struct
import sys
import tempfile
import time

import numpy as np
import torch

from throttlecrab_tpu_torch.core import CellError, PeriodicStore, RateLimiter
from throttlecrab_tpu_torch.front import DenyCache, FrontTier
from throttlecrab_tpu_torch.harness.workload import make_keys
from throttlecrab_tpu_torch.parallel.cluster import (
    FRAME_DECODERS,
    OP_DROUTE_BATCH,
    OP_JOIN,
    OP_LEAVE,
    OP_MIGRATE,
    OP_REPLICA,
    OP_RING,
    OP_RING_STATE,
    OP_ROUTE_BATCH,
    OP_THROTTLE_BATCH,
    OP_THROTTLE_REPLY,
    ClusterProtocolError,
    encode_batch,
    encode_droute,
    encode_join,
    encode_leave,
    encode_reply,
    encode_ring,
    encode_route,
    encode_rows,
)
from throttlecrab_tpu_torch.parallel.sharded import (
    ShardedTorchRateLimiter,
    make_mesh,
)
from throttlecrab_tpu_torch.replay.trace import (
    _DECODERS,
    Trace,
    TraceError,
    TraceWriter,
)
from throttlecrab_tpu_torch.server.engine import BatchingEngine
from throttlecrab_tpu_torch.server.types import ThrottleRequest
from throttlecrab_tpu_torch.tools.card import WindowCount
from throttlecrab_tpu_torch.tpu import fused, row_ops
from throttlecrab_tpu_torch.tpu.limiter import TorchRateLimiter
from throttlecrab_tpu_torch.tpu.snapshot import load_snapshot, save_snapshot
from throttlecrab_tpu_torch.tpu.table import resolve_device

NS = 1_000_000_000
T0 = 1_753_700_000 * NS
I32_MAX = (1 << 31) - 1

#: The campaign's tally.  `requests`, `windows` and `tiers` are the JAX
#: campaign's; the rest count what the card did: windows handed to a
#: table on the card, `fused.LAUNCHES` moved, row-kernel launches and the
#: rows they moved in snapshot round trips, and seconds in the oracle.
TOTAL = {
    "requests": 0, "windows": 0, "tiers": {"w32": 0, "cur": 0, "planes": 0},
    "card_windows": 0, "launches": 0, "row_gather": 0, "row_scatter": 0,
    "rows_gathered": 0, "rows_scattered": 0, "oracle_s": 0.0,
}

# The wide arm's quantity-0 probes, per request on hostile seeds: a probe
# beside a plain request of the same key in one batch is a mid-batch
# parameter change (one more conflict round), so at Zipf-1.1 over 4096
# lanes the rate is kept low enough that the hot keys see a few.
WIDE_PROBE_P = 0.002


def draw_params(rng, profile):
    """One key's (burst, count, period).

    `profile` shapes the seed's traffic: "benign" stays inside the w32
    certificate (so whole streams ride the 4 B tier and its cross-launch
    bookkeeping), "edges" hugs the field bounds, "hostile" mixes in
    cur-only, poison (tol >= 2^61) and degenerate keys so the ladder
    keeps stepping down mid-stream.
    """
    r = rng.random()
    if profile == "benign":
        # em <= 1 s (count >= period) and burst <= 400 keeps tol within
        # ~400 s: comfortably inside every w32 field bound.
        period = int(rng.integers(1, 600))
        count = period * int(rng.integers(1, 120))
        return (int(rng.integers(2, 400)), count, period)
    if profile == "edges":
        if r < 0.6:
            # em = 1 s exactly; burst sweeps across the w32 reset
            # boundary (tol ~ 1024 s is where tol + hwm crosses 2047).
            period = int(rng.integers(1, 120))
            return (int(rng.integers(400, 2300)), period, period)
        period = int(rng.integers(1, 600))
        count = period * int(rng.integers(1, 120))
        return (int(rng.integers(2, 400)), count, period)
    # hostile
    if r < 0.25:
        return (int(rng.integers(2, 200)), int(rng.integers(1, 1000)),
                int(rng.integers(1, 600)))
    if r < 0.45:   # cur tier only (reset far past 2047 s)
        return (int(rng.integers(3000, 100_000)), 60, 60)
    if r < 0.58:   # tol >= 2^61 poison (4-plane + sticky cur_safe)
        return (3_000_000_000, 1, 1)
    if r < 0.72:   # degen material: burst 1 (tol 0)
        return (1, int(rng.integers(1, 50)), int(rng.integers(1, 60)))
    return (int(rng.integers(2, 50)), int(rng.integers(1, 3000)),
            int(rng.choice([1, 10, 60, 3600])))


def draw_params_many(rng, profile, n):
    """(burst, count, period) i64[n] each: `draw_params`'s distributions
    for `n` keys at once (the wide arm's million keys)."""
    r = rng.random(n)
    period = rng.integers(1, 600, n)
    safe = (rng.integers(2, 400, n), period * rng.integers(1, 120, n), period)
    if profile == "benign":
        return safe
    if profile == "edges":
        p1 = rng.integers(1, 120, n)
        edge = (rng.integers(400, 2300, n), p1, p1)
        return tuple(np.where(r < 0.6, e, s) for e, s in zip(edge, safe))
    classes = (
        (rng.integers(2, 200, n), rng.integers(1, 1000, n),
         rng.integers(1, 600, n)),
        (rng.integers(3000, 100_000, n), np.full(n, 60), np.full(n, 60)),
        (np.full(n, 3_000_000_000), np.ones(n, np.int64), np.ones(n, np.int64)),
        (np.ones(n, np.int64), rng.integers(1, 50, n), rng.integers(1, 60, n)),
        (rng.integers(2, 50, n), rng.integers(1, 3000, n),
         rng.choice([1, 10, 60, 3600], n)),
    )
    pick = np.searchsorted([0.25, 0.45, 0.58, 0.72], r, side="right")
    return tuple(
        np.choose(pick, [c[f] for c in classes]).astype(np.int64)
        for f in range(3)
    )


def oracle_wire(oracle, keys, burst, count, period, qty, now_ns):
    t = time.perf_counter()
    n = len(keys)
    out = {
        "allowed": np.zeros(n, bool),
        "remaining": np.zeros(n, np.int64),
        "reset_s": np.zeros(n, np.int64),
        "retry_s": np.zeros(n, np.int64),
        "bad": np.zeros(n, bool),
    }
    for i in range(n):
        try:
            a, r = oracle.rate_limit(
                keys[i] if isinstance(keys[i], str) else keys[i].decode(),
                int(burst[i]), int(count[i]), int(period[i]), int(qty[i]),
                now_ns,
            )
        except CellError:
            out["bad"][i] = True
            continue
        out["allowed"][i] = a
        out["remaining"][i] = min(r.remaining, I32_MAX)
        out["reset_s"][i] = min(r.reset_after_ns // NS, I32_MAX)
        out["retry_s"][i] = min(r.retry_after_ns // NS, I32_MAX)
    TOTAL["oracle_s"] += time.perf_counter() - t
    return out


def check(res, want, ctx):
    ok = ~want["bad"]
    if not (np.asarray(res.status)[ok] == 0).all():
        raise AssertionError(f"{ctx}: unexpected status on valid lanes")
    for name, got in (
        ("allowed", np.asarray(res.allowed)),
        ("remaining", np.asarray(res.remaining)),
        ("reset_s", np.asarray(res.reset_after_s)),
        ("retry_s", np.asarray(res.retry_after_s)),
    ):
        g, w = got[ok], want[name][ok]
        if not (g == w).all():
            i = int(np.nonzero(g != w)[0][0])
            raise AssertionError(
                f"{ctx}: {name} diverged at valid lane {i}: "
                f"got {g[i]} want {w[i]}"
            )


def tier_of(handle):
    """The output tier a window handle of either limiter rode."""
    if getattr(handle, "_w32", False) or getattr(handle, "_tier", None) == "w32":
        return "w32"
    if (getattr(handle, "_cur", False) or getattr(handle, "_now_list", None)
            or getattr(handle, "_finish", None) is not None):
        return "cur"
    return "planes"


# ------------------------------------------------------------------ #
# what the card did


class _CardWindows(WindowCount):
    """A WindowCount whose count is TOTAL["card_windows"]; its lock also
    serialises the counted launches of limiters that decide on executor
    threads (the hot-key arm's two engines)."""

    @property
    def windows(self) -> int:
        return TOTAL["card_windows"]

    @windows.setter
    def windows(self, value: int) -> None:
        TOTAL["card_windows"] = value


#: watch(limiter): count in TOTAL["card_windows"] every window `limiter`
#: hands its table on the card (WindowCount.watch); returns `limiter`.
watch = _CardWindows().watch


class _Launches:
    """`fused.LAUNCHES` held against the windows handed to the card since
    construction."""

    def __init__(self) -> None:
        self.launches0 = fused.LAUNCHES
        self.windows0 = TOTAL["card_windows"]

    def check(self, ctx) -> None:
        launches = fused.LAUNCHES - self.launches0
        windows = TOTAL["card_windows"] - self.windows0
        if launches != windows:
            raise AssertionError(
                f"{ctx}: fused.LAUNCHES moved by {launches} for {windows} "
                "windows decided on the card"
            )

    def close(self, ctx) -> None:
        self.check(ctx)
        TOTAL["launches"] += fused.LAUNCHES - self.launches0


def _snapshot_round_trip(lim, make, path, now):
    """Save `lim`, restore into `make()` at `now`; on a card the row
    kernels must have launched ceil(rows / MAX_BATCH) times each way.
    Returns the restored limiter."""
    on_card = lim.table.device.type == "cuda"
    g0, s0 = row_ops.GATHER_LAUNCHES, row_ops.SCATTER_LAUNCHES
    saved = save_snapshot(lim, path)
    lim2 = make()
    load_snapshot(lim2, path + ".npz", now_ns=now)
    restored = len(lim2)
    gathers = row_ops.GATHER_LAUNCHES - g0
    scatters = row_ops.SCATTER_LAUNCHES - s0
    want = [-(-n // row_ops.MAX_BATCH) if on_card else 0
            for n in (saved, restored)]
    if [gathers, scatters] != want:
        raise AssertionError(
            f"snapshot of {saved} keys, {restored} restored: {gathers} "
            f"row_gather and {scatters} row_scatter launches, expected "
            f"{want[0]} and {want[1]}"
        )
    TOTAL["row_gather"] += gathers
    TOTAL["row_scatter"] += scatters
    TOTAL["rows_gathered"] += saved
    TOTAL["rows_scattered"] += restored
    return lim2


# ------------------------------------------------------------------ #
# the kernel beside its plain version (alternate=True)


def _tables(limiter):
    table = limiter.table
    return table.shards if hasattr(table, "shards") else [table]


def _expired_hits(limiter):
    if hasattr(limiter.table, "shards"):
        return limiter.total_expired_hits
    return limiter.table.expired_hits()


def same_state(a, b, ctx):
    """`a`'s table against its twin `b`'s: real-slot rows (each shard's),
    expired hits, insight totals, the w32 marks and `cur_safe`."""
    for name in ("tol_hwm", "now_hwm", "cur_safe"):
        va, vb = getattr(a.table, name), getattr(b.table, name)
        if va != vb:
            raise AssertionError(f"{ctx}: {name} {va} != twin's {vb}")
    for name, va, vb in (
        ("expired hits", _expired_hits(a), _expired_hits(b)),
        ("insight totals", a.table.insight_counts(), b.table.insight_counts()),
    ):
        if va != vb:
            raise AssertionError(f"{ctx}: {name} {va} != twin's {vb}")
    for d, (ta, tb) in enumerate(zip(_tables(a), _tables(b))):
        cap = ta.capacity
        if cap != tb.capacity or not torch.equal(
            ta.state[:cap].cpu(), tb.state[:cap].cpu()
        ):
            raise AssertionError(f"{ctx}: table {d}'s rows differ from the "
                                 "twin's")


def hand_over(src, dst):
    """Copy every row `src` wrote into `dst`'s table: `dst` decides the
    next window from them."""
    for ts, td in zip(_tables(src), _tables(dst)):
        td.state.copy_(ts.state)


class _Pair:
    """A limiter and, under alternate=True, its device="cpu" twin: each
    window goes to both, both results are held to the oracle, and the
    states must agree after every window."""

    def __init__(self, make, make_twin=None):
        self._makes = [make] + ([make_twin] if make_twin else [])
        self.sides = [watch(make())] + (
            [make_twin()] if make_twin else [])

    @property
    def main(self):
        return self.sides[0]

    def dispatch(self, ctx, fn):
        """`fn(limiter)` -> a window handle, or None, on each side.
        Returns (the main side's handle, each side's fetched results), or
        (None, None) when the window was refused."""
        handles = [fn(lim) for lim in self.sides]
        if len({h is None for h in handles}) != 1:
            raise AssertionError(f"{ctx}: the twin took another path")
        if handles[0] is None:
            return None, None
        tiers = {tier_of(h) for h in handles}
        if len(tiers) != 1:
            raise AssertionError(f"{ctx}: tiers differ from the twin's {tiers}")
        results = [h.fetch() for h in handles]
        if len(self.sides) == 2:
            same_state(self.sides[0], self.sides[1], ctx)
        return handles[0], results

    def sweep(self, now):
        for lim in self.sides:
            lim.sweep(now)

    def hand_over(self, step):
        """After an even step the plain version's rows go to the card
        side, after an odd one the kernel's rows to the twin."""
        if len(self.sides) == 2:
            src, dst = self.sides[::-1] if step % 2 == 0 else self.sides
            hand_over(src, dst)

    def restore(self, d, now):
        """Each side through a snapshot round trip into a fresh limiter."""
        self.sides = [
            _snapshot_round_trip(lim, make, os.path.join(d, f"fz{side}"), now)
            for side, (lim, make) in enumerate(zip(self.sides, self._makes))
        ]
        watch(self.sides[0])
        if len(self.sides) == 2:
            same_state(self.sides[0], self.sides[1], "snapshot restore")


def check_sides(results, wants, ctx):
    """Every side's per-batch results against the oracle's `wants`."""
    for side, got in enumerate(results):
        for g, want in zip(got, wants):
            check(g, want, ctx + (" twin" if side else ""))


def _wire_frame(keys, burst, count, period, qty):
    enc = [k.encode() for k in keys]
    offs = np.cumsum([0] + [len(k) for k in enc]).astype(np.int64)
    return (b"".join(enc), offs, np.stack([burst, count, period, qty], axis=1))


def campaign_mesh(device="cuda"):
    """The campaign's 2-shard mesh: two CPU shards, two cards where there
    are two, else two slices of the one card."""
    dev = resolve_device(device)
    if dev.type == "cpu" or torch.cuda.device_count() >= 2:
        return make_mesh(2, device=dev.type)
    return make_mesh(devices=[dev, dev])


def run_seed(seed, steps, sharded_mesh, alternate=False,
             insight_single=False, device="cuda"):
    """One differential seed.

    `alternate=True` runs a device="cpu" twin of each limiter beside it
    (on a card: the hand kernel beside its plain version): both stay
    pinned to the scalar oracle request by request, their states are
    equal after every window, and on alternate steps the state one side
    wrote is copied into the other's table, so the kernel continues from
    rows the plain version wrote and the reverse.
    `insight_single=True` arms the insight tier (INS_WIDTH rows) on the
    single-device limiter too, so the alternation covers both row widths
    of the kernel.
    """
    resolve_device(device)
    launches = _Launches()
    rng = np.random.default_rng(seed)
    native = bool(seed % 2)

    def single(dev):
        return lambda: TorchRateLimiter(
            capacity=512, keymap="native" if native else "python",
            insight=insight_single, device=dev,
        )

    try:
        lim = _Pair(single(device), single("cpu") if alternate else None)
    except RuntimeError:
        native = False
        lim = _Pair(single(device), single("cpu") if alternate else None)
    if sharded_mesh is not None:
        # Odd seeds run the mesh with the insight tier armed (INS_WIDTH
        # shard rows), even seeds the 4-wide layout.
        def sharded(mesh):
            return lambda: ShardedTorchRateLimiter(
                capacity_per_shard=256, mesh=mesh, insight=bool(seed % 2),
            )

        shl = _Pair(
            sharded(sharded_mesh),
            sharded(make_mesh(sharded_mesh.n_shards, device="cpu"))
            if alternate else None,
        )
    else:
        shl = None
    oracle = RateLimiter(PeriodicStore())
    oracle_sh = RateLimiter(PeriodicStore())

    profile = ("benign", "edges", "hostile")[seed % 3]
    pool = [f"z{seed}x{i}" for i in range(int(rng.integers(4, 14)))]
    params = {k: draw_params(rng, profile) for k in pool}
    now = T0
    # Clock regressions must never cross a sweep or snapshot-restore
    # point: both drop entries expired AS OF that moment (as the
    # reference's retain-based cleanup does), while the bare-store
    # oracle expires on read and would "resurrect" them at an earlier
    # timestamp.  The engine is right; the comparison must respect the
    # drop point.
    floor_now = 0
    for step in range(steps):
        # Occasional param churn, sweeps, clock moves (incl. regression).
        if rng.random() < 0.15:
            k = pool[rng.integers(len(pool))]
            params[k] = draw_params(rng, profile)
        if rng.random() < 0.12:
            jump = int(rng.integers(1, 7200)) * NS
            now += jump
            lim.sweep(now)
            if shl is not None:
                shl.sweep(now)
            floor_now = now
        # The oracle expires on read; only engines need explicit sweeps.
        n = int(rng.integers(2, 28))
        ks = [pool[rng.integers(len(pool))] for _ in range(n)]
        b = np.array([params[k][0] for k in ks], np.int64)
        c = np.array([params[k][1] for k in ks], np.int64)
        p = np.array([params[k][2] for k in ks], np.int64)
        # Quantity-0 probes appear in bursts on hostile streams only
        # (a single probe anywhere in a window forfeits the fast tiers).
        probe_p = 0.10 if profile == "hostile" else 0.0
        q = np.array(
            [0 if rng.random() < probe_p else 1 for _ in ks], np.int64
        )
        # windows of 1-3 batches through dispatch_many; each batch may
        # move the clock forward a little, or REGRESS it (now_hwm).
        batches = []
        wnow = now
        for _ in range(int(rng.integers(1, 4))):
            if rng.random() < 0.1:
                wnow = max(floor_now, wnow - int(rng.integers(1, 3 * NS)))
            batches.append((ks, b, c, p, q, wnow))
            wnow += int(rng.integers(0, NS))

        for pair, orc, where in ((lim, oracle, "single"),
                                 (shl, oracle_sh, "sharded")):
            if pair is None:
                continue
            ctx = f"seed{seed} step{step} {where}"
            h, results = pair.dispatch(
                ctx, lambda m: m.dispatch_many(batches, wire=True))
            TOTAL["tiers"][tier_of(h)] += 1
            check_sides(results, [oracle_wire(orc, *bt) for bt in batches],
                        ctx)
            TOTAL["requests"] += sum(len(bt[0]) for bt in batches)
            TOTAL["windows"] += 1
        now = wnow
        launches.check(f"seed{seed} step{step}")

        # Native wire window (agg certificate) every few steps.
        if native and step % 3 == 0 and hasattr(
            lim.main.keymap, "prepare_batch"
        ):
            ctx = f"seed{seed} step{step} native-wire"
            frame = _wire_frame(ks, b, c, p, q)
            hw, results = lim.dispatch(
                ctx, lambda m: m.dispatch_wire_window([frame], now))
            if hw is not None:
                check_sides(results,
                            [oracle_wire(oracle, ks, b, c, p, q, now)], ctx)
                TOTAL["requests"] += len(ks)
                TOTAL["windows"] += 1
            launches.check(ctx)
            now += int(rng.integers(0, NS))

        # Mid-stream snapshot round trip (hwm recovery) occasionally.
        if step == steps // 2 and rng.random() < 0.5:
            with tempfile.TemporaryDirectory() as d:
                lim.restore(d, now)
                floor_now = now
        lim.hand_over(step)
        if shl is not None:
            shl.hand_over(step)
    launches.close(f"seed{seed}")


def run_hotkey_deny_seed(seed, steps, device="cuda"):
    """Hot-key abuse traffic (harness workload `hotkey-abuse`) through
    the front tier's deny cache: every per-request decision (status,
    allowed, limit, remaining, reset, retry) must be identical with the
    cache on and off, across param churn, clock jumps and sweeps.  The
    cache must also actually serve (hits > 0), or the equality is
    vacuous.  Returns the deny-cache hit count."""
    resolve_device(device)
    launches = _Launches()
    rng = np.random.default_rng(seed)
    clock = {"now": T0}
    window = 24
    keys = make_keys("hotkey-abuse", steps * window, 2000, seed=seed)
    # Tight limits with slow emission so the hot keys saturate fast and
    # stay denied across windows: the deny cache's serving regime.
    key_params = {
        k: (int(rng.integers(2, 6)), int(rng.integers(1, 5)),
            int(rng.integers(10, 90)))
        for k in set(keys)
    }

    def norm(r):
        if isinstance(r, Exception):
            return (type(r).__name__, str(r))
        return (r.allowed, r.limit, r.remaining, r.reset_after,
                r.retry_after)

    async def run():
        front = FrontTier(DenyCache(4096), None)
        eng_on = BatchingEngine(
            watch(TorchRateLimiter(capacity=512, device=device)),
            batch_size=32, max_linger_us=200,
            now_fn=lambda: clock["now"], front=front,
        )
        eng_off = BatchingEngine(
            watch(TorchRateLimiter(capacity=512, device=device)),
            batch_size=32, max_linger_us=200,
            now_fn=lambda: clock["now"],
        )
        for step in range(steps):
            if rng.random() < 0.10:  # param churn on a random key
                k = keys[int(rng.integers(len(keys)))]
                key_params[k] = (
                    int(rng.integers(2, 6)), int(rng.integers(1, 5)),
                    int(rng.integers(10, 90)),
                )
            reqs = []
            for k in keys[step * window : (step + 1) * window]:
                burst, count, period = key_params[k]
                q = 0 if rng.random() < 0.02 else 1
                reqs.append(ThrottleRequest(k, burst, count, period, q))
            got_on, got_off = await asyncio.gather(
                asyncio.gather(
                    *[eng_on.throttle(r) for r in reqs],
                    return_exceptions=True,
                ),
                asyncio.gather(
                    *[eng_off.throttle(r) for r in reqs],
                    return_exceptions=True,
                ),
            )
            for i, (a, b) in enumerate(zip(got_on, got_off)):
                if norm(a) != norm(b):
                    raise AssertionError(
                        f"hotkey seed{seed} step{step} row {i} "
                        f"({reqs[i]}): cache-on {norm(a)} != "
                        f"cache-off {norm(b)}"
                    )
            TOTAL["requests"] += 2 * len(reqs)
            TOTAL["windows"] += 2
            clock["now"] += int(rng.integers(0, 3 * NS))
            if rng.random() < 0.06:  # expiry jump: vacate buckets
                clock["now"] += int(rng.integers(120, 600)) * NS
        await eng_on.shutdown()
        await eng_off.shutdown()
        return front.deny_cache.hits

    hits = asyncio.run(run())
    launches.close(f"hotkey seed{seed}")
    return hits


def run_cluster_frame_fuzz(seed, iters, device="cuda"):
    """Malformed-frame hardening for every cluster wire op: random
    truncations, byte flips and splices of valid frames must either
    decode cleanly or raise the typed ClusterProtocolError, never
    OverflowError/MemoryError/IndexError/struct.error, and never size
    an allocation from an attacker-controlled count.  Host-only: the
    card is not touched.

    The mutation corpus is keyed off cluster.FRAME_DECODERS, with one
    maker arm per OP_* constant.  A new op that lands without an arm
    here fails both the sync check below and, structurally, the
    port's wire-surface checker (analysis/wire_surface.py).  Returns
    the number of frames exercised."""
    resolve_device(device)
    rng = np.random.default_rng(seed)

    def mk_keys(n):
        return [
            bytes(rng.integers(0, 256, int(rng.integers(0, 40)),
                               dtype=np.uint8))
            for _ in range(n)
        ]

    def mk_params(n):
        return [
            tuple(int(x) for x in rng.integers(-(2**40), 2**40, 4))
            for _ in range(n)
        ]

    def mk_rows(op):
        n = int(rng.integers(0, 12))
        return encode_rows(
            op, int(rng.integers(0, 8)), int(rng.integers(0, 2**32)),
            mk_keys(n),
            rng.integers(-(2**62), 2**62, n),
            rng.integers(-(2**62), 2**62, n),
        )

    def mk_ring(op):
        return encode_ring(
            op, int(rng.integers(0, 2**32)),
            rng.random(int(rng.integers(0, 8))).tolist(),
        )

    def mk_batch(_op):
        n = int(rng.integers(0, 12))
        return encode_batch(
            mk_keys(n), mk_params(n), int(rng.integers(0, 2**62))
        )

    def mk_route(_op):
        n = int(rng.integers(0, 12))
        return encode_route(
            mk_keys(n), mk_params(n), int(rng.integers(0, 2**62)),
            int(rng.integers(0, 8)),
        )

    def mk_droute(_op):
        n = int(rng.integers(0, 12))
        return encode_droute(
            mk_keys(n), mk_params(n), int(rng.integers(0, 2**62)),
            int(rng.integers(0, 8)),
            rng.integers(-(2**62), 2**62, n),
        )

    def mk_reply(_op):
        n = int(rng.integers(0, 12))
        return encode_reply(
            rng.integers(0, 7, n), rng.integers(0, 2, n),
            rng.integers(-(2**62), 2**62, n),
            rng.integers(-(2**62), 2**62, n),
            rng.integers(0, 2**62, n), rng.integers(0, 2**62, n),
        )

    makers = {
        OP_THROTTLE_BATCH: mk_batch,
        OP_THROTTLE_REPLY: mk_reply,
        OP_MIGRATE: mk_rows,
        OP_RING: mk_ring,
        OP_JOIN: lambda _op: encode_join(int(rng.integers(0, 256))),
        OP_RING_STATE: mk_ring,
        OP_REPLICA: mk_rows,
        OP_ROUTE_BATCH: mk_route,
        OP_LEAVE: lambda _op: encode_leave(
            int(rng.integers(0, 256)), int(rng.integers(0, 2**32))
        ),
        OP_DROUTE_BATCH: mk_droute,
    }
    missing = set(FRAME_DECODERS) - set(makers)
    extra = set(makers) - set(FRAME_DECODERS)
    if missing or extra:
        raise SystemExit(
            f"fuzz arms out of sync with FRAME_DECODERS: "
            f"missing={sorted(missing)} extra={sorted(extra)}"
        )

    ops = sorted(makers)
    done = 0
    for _ in range(iters):
        op = ops[int(rng.integers(len(ops)))]
        frame = makers[op](op)
        decoder = FRAME_DECODERS[op][1]
        body = bytearray(frame[5:])  # strip the header, as the server does
        mode = rng.random()
        if mode < 0.35 and len(body):          # truncate
            body = body[: int(rng.integers(0, len(body)))]
        elif mode < 0.7 and len(body):         # flip bytes
            for _ in range(int(rng.integers(1, 4))):
                body[int(rng.integers(len(body)))] = int(
                    rng.integers(256)
                )
        elif mode < 0.85:                      # append garbage
            body += bytes(
                rng.integers(0, 256, int(rng.integers(1, 16)),
                             dtype=np.uint8)
            )
        try:
            decoder(bytes(body))
        except ClusterProtocolError:
            pass  # the typed rejection the wire contract promises
        done += 1
        TOTAL["requests"] += 1
    return done


def run_trace_frame_fuzz(seed, iters, device="cuda"):
    """Malformed-frame hardening for the record/replay trace codec
    (replay/trace.py): random truncations, byte flips, splices and
    explicit count-vs-size lies over valid traces must either decode
    cleanly or raise the typed TraceError, never struct.error/
    IndexError/MemoryError, and never size an allocation from an
    attacker-controlled count (a trace file is untrusted input: it may
    come off a crashed node or a bug report).  Host-only.  Returns the
    number of mutated inputs exercised."""
    resolve_device(device)
    rng = np.random.default_rng(seed)
    # Table-driven off the codec's own kind->decoder registry, so a new
    # REC_* kind is fuzzed the moment it is wired into _DECODERS.
    frame_decoders = tuple(fn for _, fn in sorted(_DECODERS.items()))
    done = 0
    for _ in range(iters):
        writer = TraceWriter()
        for _w in range(int(rng.integers(1, 4))):
            n = int(rng.integers(0, 10))
            keys = [
                bytes(rng.integers(0, 256, int(rng.integers(0, 24)),
                                   dtype=np.uint8))
                for _ in range(n)
            ]
            writer.add_window(
                int(rng.integers(0, 2**62)), int(rng.integers(0, 32)),
                keys,
                rng.integers(-(2**40), 2**40, (n, 4)),
                rng.integers(0, 2, n), rng.integers(0, 6, n),
                rng.integers(0, 2**16, n),
            )
        if rng.random() < 0.5:
            writer.add_event(
                int(rng.integers(0, 2**62)), "degrade", "x" * 5
            )
        if rng.random() < 0.5:
            writer.add_injection(
                "launch", "count", int(rng.integers(0, 1000)), 1.5
            )
        data = bytearray(writer.to_bytes())
        mode = rng.random()
        if mode < 0.30 and len(data) > 6:          # truncate
            data = data[: int(rng.integers(6, len(data)))]
        elif mode < 0.60 and len(data) > 6:        # flip bytes
            for _ in range(int(rng.integers(1, 5))):
                data[int(rng.integers(6, len(data)))] = int(
                    rng.integers(256)
                )
        elif mode < 0.75:                          # append garbage
            data += bytes(
                rng.integers(0, 256, int(rng.integers(1, 24)),
                             dtype=np.uint8)
            )
        elif mode < 0.9 and len(data) >= 6 + 5 + 13:
            # Explicit count-vs-size lie: overwrite the first window
            # frame's n field with a huge value.
            struct.pack_into(
                "<I", data, 6 + 5 + 9, int(rng.integers(2**20, 2**31))
            )
        try:
            Trace.loads(bytes(data))
        except TraceError:
            pass  # the typed rejection the trace contract promises
        # Bare frame bodies through each decoder (no file header).
        body = bytes(data[6:])
        dec = frame_decoders[int(rng.integers(len(frame_decoders)))]
        try:
            dec(body[: int(rng.integers(0, max(len(body), 1) + 1))])
        except TraceError:
            pass
        done += 1
        TOTAL["requests"] += 1
    return done


# ------------------------------------------------------------------ #
# the full-width arm


def run_wide_seed(seed, windows, *, capacity=1 << 20, n_keys=1_000_000,
                  k=16, b=4096, device="cuda"):
    """The ladder at full width: BASELINE config 3's deployment, a
    `capacity`-slot TorchRateLimiter with the native keymap, `n_keys`
    keys drawn Zipf-1.1, `windows` windows of `k` batches of `b`, every
    key's (burst, count, period) drawn from the seed's profile.  Each
    window may churn the hottest keys' params, jump the clock and sweep
    (as a config-4 deployment sweeps between windows), and regress the
    clock inside itself; every third window goes through
    dispatch_wire_window.  In mid-run one snapshot round trip moves every
    live row through the row kernels, and then every key is reconfigured
    to benign limits (a fleet-wide limit change), so the later windows
    read state written under the old limits.  Every valid lane is held
    against the scalar oracle.  Returns the arm's record."""
    resolve_device(device)
    t_arm = time.perf_counter()
    launches = _Launches()
    mark = dict(TOTAL, tiers=dict(TOTAL["tiers"]))
    rng = np.random.default_rng(seed)
    profile = ("benign", "edges", "hostile")[seed % 3]
    burst, count, period = draw_params_many(rng, profile, n_keys)
    cdf = np.cumsum(np.arange(1, n_keys + 1, dtype=np.float64) ** -1.1)
    cdf /= cdf[-1]

    def zipf(m):
        return np.minimum(np.searchsorted(cdf, rng.random(m)), n_keys - 1)

    def make():
        return watch(TorchRateLimiter(capacity=capacity, keymap="native",
                                      device=device))

    lim = make()
    oracle = RateLimiter(PeriodicStore())
    probe_p = WIDE_PROBE_P if profile == "hostile" else 0.0
    # Windows and the tiers they rode, by path; "wire_refused" counts
    # wire windows dispatch_wire_window handed back (a mid-batch param
    # change), which then go through dispatch_many.
    tiers = {path: {"w32": 0, "cur": 0, "planes": 0}
             for path in ("dispatch_many", "wire")}
    refused = 0
    snap = None
    now = T0
    floor_now = 0
    for w in range(windows):
        if rng.random() < 0.15:  # param churn on hot keys
            hot = zipf(256)
            burst[hot], count[hot], period[hot] = draw_params_many(
                rng, profile, len(hot))
        if rng.random() < 0.12:
            now += int(rng.integers(1, 7200)) * NS
            lim.sweep(now)
            floor_now = now
        wire = w % 3 == 2
        if wire and rng.random() < 0.1:
            now = max(floor_now, now - int(rng.integers(1, 3 * NS)))
        batches = []
        wnow = now
        for _ in range(k):
            kid = zipf(b)
            q = np.where(rng.random(b) < probe_p, 0, 1).astype(np.int64)
            if not wire and rng.random() < 0.1:
                wnow = max(floor_now, wnow - int(rng.integers(1, 3 * NS)))
            batches.append(([f"w{seed}:{i}" for i in kid.tolist()],
                            burst[kid], count[kid], period[kid], q,
                            now if wire else wnow))
            if not wire:
                wnow += int(rng.integers(0, NS))
        handle = None
        if wire:
            handle = lim.dispatch_wire_window(
                [_wire_frame(*bt[:5]) for bt in batches], now)
            refused += handle is None
        path = "wire"
        if handle is None:
            handle = lim.dispatch_many(batches, wire=True)
            path = "dispatch_many"
        tiers[path][tier_of(handle)] += 1
        TOTAL["tiers"][tier_of(handle)] += 1
        got = handle.fetch()
        for j, (bt, g) in enumerate(zip(batches, got)):
            check(g, oracle_wire(oracle, *bt), f"wide seed{seed} window{w} "
                  f"batch{j}")
            TOTAL["requests"] += len(bt[0])
        TOTAL["windows"] += 1
        now = wnow
        launches.check(f"wide seed{seed} window{w}")
        if w == windows // 2:
            live = len(lim)
            with tempfile.TemporaryDirectory() as d:
                lim = _snapshot_round_trip(lim, make, os.path.join(d, "wide"),
                                           now)
            snap = {"keys": live, "restored": len(lim)}
            floor_now = now
            # The fleet is reconfigured to benign limits: the windows
            # after this one fit the fast tiers by their own params, while
            # the hot keys' stored TATs still run as far ahead as their
            # old limits let them.  Only the certificates' cross-launch
            # marks (restored with the snapshot) keep those windows exact.
            burst, count, period = draw_params_many(rng, "benign", n_keys)
            probe_p = 0.0
    launches.close(f"wide seed{seed}")
    return {
        "seed": seed, "profile": profile, "windows": windows, "k": k, "b": b,
        "tiers": tiers, "wire_refused": refused, "snapshot": snap,
        **{key: TOTAL[key] - mark[key] for key in (
            "requests", "card_windows", "launches", "row_gather",
            "row_scatter", "rows_gathered", "rows_scattered", "oracle_s")},
        "seconds": time.perf_counter() - t_arm,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seeds", type=int, default=24)
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--no-sharded", action="store_true")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    dev = args.device

    mesh = None if args.no_sharded else campaign_mesh(dev)
    for s in range(args.seeds):
        run_seed(3000 + s, args.steps, mesh, device=dev)
        print(
            f"seed {3000 + s} ok: {TOTAL['requests']} requests, "
            f"tiers {TOTAL['tiers']}",
            file=sys.stderr, flush=True,
        )
    # Deny-cache differential: one hot-key abuse seed per ladder seed.
    for s in range(args.seeds):
        hits = run_hotkey_deny_seed(4000 + s, args.steps * 2, device=dev)
        print(
            f"hotkey seed {4000 + s} ok: {hits} deny-cache hits",
            file=sys.stderr, flush=True,
        )
    # Cluster wire hardening: mutated frames must fail typed.
    for s in range(args.seeds):
        n = run_cluster_frame_fuzz(5000 + s, args.steps * 40, device=dev)
        print(
            f"cluster-frame seed {5000 + s} ok: {n} frames",
            file=sys.stderr, flush=True,
        )
    # Record/replay trace hardening: mutated traces must fail typed.
    for s in range(args.seeds):
        n = run_trace_frame_fuzz(6000 + s, args.steps * 20, device=dev)
        print(
            f"trace-frame seed {6000 + s} ok: {n} inputs",
            file=sys.stderr, flush=True,
        )
    print(
        f"PASS: {TOTAL['requests']} differential requests over "
        f"{TOTAL['windows']} windows; tier mix {TOTAL['tiers']}"
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
