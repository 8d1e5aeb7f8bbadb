"""The system under test, driven on its by-id launch path: one interned
key universe with resident id rows, K-deep windows of raw key ids
through `BucketTable.check_many_ids`, `in_flight` launches queued, each
fetched and finished on a pool of `workers` threads (bench.py's
`run_byid` / `_timed_trials`, over the port's API).

The caller keeps its id windows in pinned host memory and copies each
launch's ids and sub-batch times to the card without blocking
(`non_blocking=True`), then hands `check_many_ids` the device tensors,
as bench.py's `device_put` does on the TPU: the program's own upload of
host arrays waits for the stream to drain, which would leave one launch
in flight whatever the pipeline's depth.

The harness hands the program key names, limits and id windows, and
takes back finished wire values, its table rows at the sampled keys'
slots and its launch counters.  Nothing else of the program is read.
"""

from __future__ import annotations

import contextlib
import threading
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from .. import generate


def _annotate(traced: bool, name: str):
    """A span the profiler records (the dispatching thread's only: the
    profiler does not record other threads' spans, so the workers' are
    placed by the host clock)."""
    if not traced:
        return contextlib.nullcontext()
    from torch.profiler import record_function

    return record_function(name)


class Loop:
    """Set up the limiter for one cell, then run launches through it."""

    def __init__(self, sched, keys, index, device) -> None:
        self.sched, self.keys, self.index = sched, keys, index
        self.device = device
        self.mix = sched.mix
        self.tier = sched.cfg["tier"]
        if self.tier not in ("w32", "cur"):
            raise ValueError(f"unknown output tier {self.tier!r}")
        self.n = 0  # launches made
        self.kept = {}  # launch -> i32[compared lanes, 4]
        self.host = {"dispatch": [], "finish": []}  # host-clock spans
        self._lock = threading.Lock()
        self.traced = False

    # ---- set-up ---------------------------------------------------------

    def setup(self) -> None:
        from throttlecrab_tpu_torch.tpu import fused, row_ops
        from throttlecrab_tpu_torch.tpu.kernel import fits_w32_wire
        from throttlecrab_tpu_torch.tpu.limiter import (
            TorchRateLimiter,
            derive_params,
        )

        self.fused, self.row_ops = fused, row_ops
        cfg = self.sched.cfg
        lim = TorchRateLimiter(capacity=cfg["capacity"], keymap="native",
                               device=self.device)
        self.limiter, km, table = lim, lim.keymap, lim.table
        if km.intern(generate.key_names(cfg)) != 0:
            raise RuntimeError("the keymap did not intern from id 0")
        burst, count, period = generate.limits(cfg)
        self.em, self.tol, invalid = derive_params(burst, count, period)
        if invalid.any():
            raise ValueError("the configuration holds invalid limits")
        self.slots = km.resolve_all(strict=True)
        self.rows = table.upload_id_rows(self.slots, self.em, self.tol,
                                         keymap=km)
        if self.tier == "w32" and not fits_w32_wire(
                np.ones(len(self.em), bool), self.em, self.tol,
                np.ones(len(self.em), np.int64), self.sched.t0,
                table.tol_hwm, table.now_hwm):
            raise ValueError("the configuration's limits do not fit the "
                             "w32 tier: give it \"tier\": \"cur\"")
        self.staged = None
        if table.device.type == "cuda":
            import torch

            self.staged = [torch.from_numpy(w).pin_memory()
                           for w in self.sched.windows]
            self.now_ring = [torch.empty(self.sched.K, dtype=torch.int64)
                             .pin_memory()
                             for _ in range(2 * int(self.mix["in_flight"]))]
            self.out_ring = [None] * len(self.now_ring)
        self.pool = ThreadPoolExecutor(max_workers=int(self.mix["workers"]))

    def close(self) -> None:
        self.pool.shutdown(wait=True)

    def launch_counts(self) -> tuple:
        """(window-kernel launches, row-kernel launches) the program has
        counted so far."""
        r = self.row_ops
        return self.fused.LAUNCHES, r.GATHER_LAUNCHES + r.SCATTER_LAUNCHES

    # ---- one launch -----------------------------------------------------

    def _finish(self, i, out, now):
        from throttlecrab_tpu_torch.tpu.kernel import finish_w32

        t0 = time.perf_counter()
        if isinstance(out, tuple):  # a pinned buffer and its copy's event
            out[1].synchronize()
            words = out[0].numpy()
        else:
            words = out.cpu().numpy()
        t1 = time.perf_counter()
        if self.tier == "w32":
            planes = finish_w32(words.reshape(-1))
        else:
            ids = self.sched.ids(i)
            planes = np.concatenate([
                self.limiter.keymap.finish_raw(
                    ids[k], self.em, self.tol, 1, words[k], int(now[k]))
                for k in range(len(now))]).T
        t2 = time.perf_counter()
        sel = self.index.lanes[self.sched.window_of(i)][
            self.index.compared(i)]
        if len(sel):
            kept = np.stack([np.asarray(p, np.int32)[sel] for p in planes], 1)
            with self._lock:
                self.kept[i] = kept
        return t0, t1, t2

    def _inputs(self, i):
        """Launch i's ids and sub-batch times as the program gets them:
        on the card, copied from pinned memory without blocking.  Launch
        i rewrites the time buffer of launch i - 2*in_flight; launch
        i - in_flight has been fetched before launch i is dispatched, so
        every copy queued before it is done."""
        ids, now = self.sched.ids(i), self.sched.now(i)
        if self.staged is None:
            return ids, now
        dev = self.limiter.table.device
        buf = self.now_ring[i % len(self.now_ring)]
        buf.numpy()[:] = now
        return (self.staged[self.sched.window_of(i)].to(dev, non_blocking=True),
                buf.to(dev, non_blocking=True))

    def _fetch(self, i, out):
        """Queue the copy of launch i's output into a pinned buffer behind
        the launch, with an event the pool waits on.  The event blocks
        its waiter instead of spinning: three workers spinning on the
        card take the cores the dispatching thread needs.  Launch i
        reuses the buffer of launch i - 2*in_flight, finished before
        launch i - in_flight returned."""
        if self.staged is None:
            return out
        import torch

        ring = self.out_ring
        j = i % len(ring)
        if ring[j] is None or ring[j].shape != out.shape:
            ring[j] = torch.empty(out.shape, dtype=out.dtype, pin_memory=True)
        ring[j].copy_(out, non_blocking=True)
        done = torch.cuda.Event(blocking=True)
        done.record()
        return ring[j], done

    def dispatch(self):
        """Queue launch `self.n` and hand its fetch and finish to the
        pool; returns the pool's future."""
        i, now = self.n, self.sched.now(self.n)
        ts = time.perf_counter()
        with _annotate(self.traced, "ids.dispatch"):
            ids_in, now_in = self._inputs(i)
            out = self._fetch(i, self.limiter.table.check_many_ids(
                self.rows, ids_in, now_in, 1, with_degen=False,
                compact=self.tier))
        self.host["dispatch"].append((ts, time.perf_counter()))
        self.n += 1
        return self.pool.submit(self._finish, i, out, now)

    def _done(self, fut):
        spans = fut.result()
        self.host["finish"].append(spans)
        return spans[2]

    def run_untimed(self, n: int) -> None:
        """`n` launches through the same pipeline, then drained."""
        pending = deque()
        for _ in range(n):
            if len(pending) >= int(self.mix["in_flight"]):
                self._done(pending.popleft())
            pending.append(self.dispatch())
        while pending:
            self._done(pending.popleft())

    def populate(self) -> None:
        """Every key once (the populate launches), so that the table holds
        the whole universe before the window."""
        self.run_untimed(self.sched.n_pop)

    def window(self, seconds: float) -> dict:
        """Closed loop for `seconds`: keep `in_flight` launches queued.
        Returns each timed launch's dispatch start and end of finish, and
        the window's bounds, all on the host clock."""
        depth = int(self.mix["in_flight"])
        pending, ends = deque(), []
        for s in self.host.values():
            s.clear()
        t_start = time.perf_counter()
        t_end = t_start + seconds
        while time.perf_counter() < t_end:
            if len(pending) >= depth:
                ends.append(self._done(pending.popleft()))
            pending.append(self.dispatch())
        while pending:
            ends.append(self._done(pending.popleft()))
        dispatch = np.asarray(self.host["dispatch"])
        return {"t_start": t_start, "t_end": t_end,
                "starts": dispatch[:, 0], "ends": np.asarray(ends),
                "dispatch": dispatch,
                "finish": np.asarray(self.host["finish"])}

    # ---- what the check reads -------------------------------------------

    def sampled_rows(self):
        """(tat i64[S], expiry i64[S]) of the sampled keys: the program's
        table rows at their slots."""
        import torch

        from throttlecrab_tpu_torch.tpu.kernel import unpack_state

        slots = torch.as_tensor(self.slots[self.keys].astype(np.int64))
        state = self.limiter.table.state
        tat, exp = unpack_state(state[slots.to(state.device)])
        return tat.cpu().numpy(), exp.cpu().numpy()
