"""Micro-batching engine: the reference actor's replacement.

The counterpart of `throttlecrab_tpu/server/engine.py`.  The reference
serializes every request through one channel into a single-threaded actor
(`actor.rs:102-236`); here requests from the transports append to a
pending queue with a future, and a flush (the batch filling, or a linger
deadline) stamps each window with one server-side timestamp, decides it
in one device launch, and completes every future.  `batch_size` and
`max_linger_us` are the throughput/latency knob pair.

Decisions run on a worker thread, one window at a time under
`limiter_lock` (the actor's sequential-state guarantee), so the event
loop keeps accepting requests while the device works; with
`dispatch_many` the flush double-buffers: window N+1 is dispatched
before window N's results are fetched.

Housekeeping runs between windows: the insight tier's throttled poll
(insight/), the control plane's throttled tick (control/), the
checkpointer's throttled tick (persist/; decided keys are marked dirty
first), and cleanup, where the engine consults a `CleanupPolicy`
(tpu/cleanup.py) and triggers the expiry sweep.  With a flight recorder
armed (replay/), every decided window is captured, off the event loop;
with `profile_dir`, the first launches run under a `torch.profiler`
capture (tpu/profiling.py).

With a front tier (front/) a request first consults the exact deny cache
(a provable repeat denial answers without a launch), then admission
control (OverloadError when shed); decided windows feed the cache back.
Launch supervision lives in the limiter wrapper (server/supervisor.py):
a launch exception reaching this engine means the supervisor already
retried transient faults and either degraded to the host oracle (then
no exception arrives) or classified the failure as deterministic, so
failing the window's futures is the terminal answer.  `health_state()`
surfaces the supervisor's state machine (GET /health).
"""

from __future__ import annotations

import asyncio
import logging
import threading
import time
from collections import deque
from typing import Optional

from ..front import OverloadError  # re-exported for the transports
from ..replay.recorder import active_recorder
from ..replay.trace import SOURCE_ENGINE
from ..tpu.cleanup import CleanupPolicy, feed_expired_hits
from ..tpu.limiter import (
    STATUS_DEADLINE,
    STATUS_INTERNAL,
    STATUS_INVALID_PARAMS,
    STATUS_NEGATIVE_QUANTITY,
    STATUS_OK,
    STATUS_TENANT_QUOTA,
)
from ..tpu.profiling import annotate
from .supervisor import supervisor_state
from .types import ThrottleRequest, ThrottleResponse

__all__ = [
    "BatchingEngine", "DeadlineError", "OverloadError", "ThrottleError",
]

log = logging.getLogger("throttlecrab.engine")

STATUS_MESSAGES = {
    STATUS_NEGATIVE_QUANTITY: "quantity cannot be negative",
    STATUS_INVALID_PARAMS: "invalid rate limit parameters",
    STATUS_INTERNAL: "internal error",
    STATUS_TENANT_QUOTA: "tenant capacity quota exceeded",
    STATUS_DEADLINE: "deadline exceeded",
}


class ThrottleError(Exception):
    """Per-request validation failure, mapped by each transport to its
    protocol's error shape (the reference returns 500 JSON)."""


class DeadlineError(ThrottleError):
    """The request outlived its client deadline while queued: shed before
    device dispatch (HTTP 504)."""


class BatchingEngine:
    """Coalesces transport requests into device windows."""

    def __init__(
        self,
        limiter,
        batch_size: int = 4096,
        max_linger_us: int = 200,
        cleanup_policy: Optional[CleanupPolicy] = None,
        metrics=None,
        now_fn=None,
        max_scan_depth: int = 16,
        front=None,
        deadline_default_ms: int = 0,
        insight=None,
        checkpointer=None,
        control=None,
        profile_dir: Optional[str] = None,
        profile_launches: int = 50,
    ) -> None:
        """`limiter` is a TorchRateLimiter, or its SupervisedLimiter (or
        any object with rate_limit_batch + sweep).  `now_fn` injects time
        for tests (time is an input, never ambient).  `max_scan_depth`
        caps the backlog sub-batches decided per launch.  `front` is an
        optional front.FrontTier: requests pass its deny cache and
        admission control before they reach the pending queue.
        `deadline_default_ms` > 0 stamps a deadline on requests that
        carry none.  `insight` is an optional insight.InsightTier: the
        engine drives its throttled device poll between flushes (on the
        executor, under the limiter lock) and serves its document on GET
        /stats.  `checkpointer` is an optional persist.Checkpointer:
        decided windows mark their keys dirty and the same housekeeping
        step drives its throttled tick.  `control` is an optional
        control.ControlPlane: the same step drives its throttled tick
        (on the executor, under the limiter lock) and GET /control serves
        its document.  `profile_dir` captures the first
        `profile_launches` launches with torch.profiler."""
        import inspect

        self.limiter = limiter
        self.front = front
        self.insight = insight
        self.checkpointer = checkpointer
        self.control = control
        # Optional torch.profiler capture of the first N launches.  While
        # it runs, the launches run on one dedicated thread that also
        # starts and stops the capture: the profiler records host spans
        # of the thread that started it only.
        self._profile_dir = profile_dir
        self._profile_remaining = profile_launches if profile_dir else 0
        self._profile = None  # tpu.profiling.ProfileSession while on
        self._launch_pool = None  # its thread; None: the loop's executor
        # Serializes device access across worker threads.
        self.limiter_lock = threading.Lock()
        # A deny cache certifies entries from the exact observed TAT
        # (result.cur_ns): ask limiters that can give it for it.
        want_cur = front is not None and front.deny_cache is not None

        def wire_kw(fn):
            # Serving wants the wire fast path where the limiter has it.
            try:
                params = inspect.signature(fn).parameters
            except (TypeError, ValueError):
                return {}
            kw = {"wire": True} if "wire" in params else {}
            if want_cur and "collect_cur" in params:
                kw["collect_cur"] = True
            return kw

        self._wire_kw = wire_kw(limiter.rate_limit_batch)
        self._wire_many_kw = wire_kw(getattr(limiter, "rate_limit_many", None))
        self.batch_size = batch_size
        self.max_linger_s = max_linger_us / 1e6
        self.cleanup_policy = cleanup_policy
        self.metrics = metrics
        self.now_fn = now_fn or time.time_ns
        self.max_scan_depth = max_scan_depth
        self.deadline_default_ms = int(deadline_default_ms)
        #: A ClusterLimiter advertises this: forwards carry each row's
        #: remaining deadline budget to the owning node.
        self._limiter_takes_deadlines = bool(
            getattr(limiter, "accepts_deadlines", False)
        )
        # The flush pops whole windows from the left while transports
        # append on the right.
        self._pending: deque = deque()
        self._flush_handle: Optional[asyncio.TimerHandle] = None
        self._flush_lock = asyncio.Lock()
        self._closed = False
        #: Draining (graceful shutdown): new requests shed with
        #: OverloadError while queued ones still resolve.
        self._draining = False
        # Strong refs: the loop only weakly references tasks.
        self._flush_tasks: set = set()

    # ------------------------------------------------------------------ #

    async def throttle(self, request: ThrottleRequest) -> ThrottleResponse:
        """Decide one request; resolves when its window comes back.

        With a front tier, a provably exact repeat denial returns from
        the deny cache at once (no queue slot, no launch; hits bypass
        admission, they never occupy the queue it protects), else
        admission control may shed the request with OverloadError."""
        if self._closed:
            raise ThrottleError("engine is shut down")
        if self._draining:
            if self.metrics is not None:
                self.metrics.record_drain_shed()
            raise OverloadError("server draining")
        if request.deadline_ns is None and self.deadline_default_ms > 0:
            request.deadline_ns = (
                self.now_fn() + self.deadline_default_ms * 1_000_000
            )
        front = self.front
        if front is not None:
            hit = front.lookup(
                request.key, request.max_burst, request.count_per_period,
                request.period, request.quantity, self.now_fn(),
            )
            if hit is not None:
                return ThrottleResponse(
                    allowed=False,
                    limit=hit.limit,
                    remaining=hit.remaining,
                    reset_after=hit.reset_after_s,
                    retry_after=hit.retry_after_s,
                )
            if not front.admit(len(self._pending), request.quantity == 0):
                raise OverloadError()
            # Until this request's result is observed, same-key lookups
            # must miss (it may mutate the bucket).
            front.begin_inflight(request.key)
        loop = asyncio.get_running_loop()
        fut: asyncio.Future = loop.create_future()
        self._pending.append((request, fut))
        if len(self._pending) == self.batch_size:
            # Threshold crossing: one flush task drains everything.
            self._schedule_flush(loop)
        elif self._flush_handle is None:
            self._flush_handle = loop.call_later(
                self.max_linger_s, self._linger_fired, loop
            )
        return await fut

    def _linger_fired(self, loop) -> None:
        self._flush_handle = None
        if self._pending:
            self._schedule_flush(loop)

    def _schedule_flush(self, loop) -> None:
        if self._flush_handle is not None:
            self._flush_handle.cancel()
            self._flush_handle = None
        task = loop.create_task(self._flush())
        self._flush_tasks.add(task)
        task.add_done_callback(self._flush_tasks.discard)

    @staticmethod
    def _columns(window, now_ns):
        """One sub-batch of a window as the limiter's batch tuple."""
        return (
            [r.key for r, _ in window],
            [r.max_burst for r, _ in window],
            [r.count_per_period for r, _ in window],
            [r.period for r, _ in window],
            [r.quantity for r, _ in window],
            now_ns,
        )

    async def _flush(self) -> None:
        """Decide everything pending, in arrival order.

        A backlog deeper than one batch drains up to max_scan_depth
        batches per launch.  With the limiter's dispatch/fetch split the
        loop double-buffers: window N+1 is dispatched while the device
        still runs window N, and only then are N's results fetched."""
        can_scan = hasattr(self.limiter, "rate_limit_many")
        can_async = hasattr(self.limiter, "dispatch_many")
        async with self._flush_lock:
            if not can_async:
                while self._pending:
                    windows = self._take_windows(can_scan)
                    if len(windows) > 1:
                        await self._decide_many(windows)
                    elif windows:
                        await self._decide(windows[0])
                return

            loop = asyncio.get_running_loop()
            in_flight = None  # (windows, handle, now_ns, seq)
            while self._pending or in_flight is not None:
                windows = self._take_windows(can_scan)
                launched = None
                if windows:
                    now_ns = self.now_fn()
                    self._profile_tick()
                    dl_kw = self._deadline_many_kw(windows)

                    def do_dispatch(ws=windows, t=now_ns, dk=dl_kw):
                        with self.limiter_lock, annotate("gcra_dispatch"):
                            # The deny cache's dispatch-order stamp, under
                            # the lock that orders launches.
                            return self._next_seq(), self.limiter.dispatch_many(
                                [self._columns(w, t) for w in ws],
                                **self._wire_many_kw,
                                **dk,
                            )

                    try:
                        seq, handle = await loop.run_in_executor(
                            self._launch_pool, do_dispatch
                        )
                        launched = (windows, handle, now_ns, seq)
                    except Exception as exc:
                        self._fail_windows(windows, exc)

                if in_flight is not None:
                    await self._fetch_complete(in_flight)
                in_flight = launched

    def _take_windows(self, can_scan: bool) -> list:
        """Pop up to max_scan_depth x batch_size pending requests, chunked
        into batch-sized windows (arrival order preserved).  Requests
        whose client deadline already lapsed are shed HERE, before any
        device dispatch, with DeadlineError."""
        if not self._pending:
            return []
        n_batches = (
            min(
                max(len(self._pending) // self.batch_size, 1),
                self.max_scan_depth,
            )
            if can_scan
            else 1
        )
        take = min(n_batches * self.batch_size, len(self._pending))
        flat = [self._pending.popleft() for _ in range(take)]
        if any(r.deadline_ns is not None for r, _ in flat):
            now_ns = self.now_fn()
            live = []
            shed = []
            for r, fut in flat:
                if r.deadline_ns is not None and r.deadline_ns <= now_ns:
                    shed.append((r, fut))
                else:
                    live.append((r, fut))
            if shed and self.metrics is not None:
                self.metrics.record_deadline_shed(len(shed))
            front = self.front
            if shed and front is not None and front.deny_cache is not None:
                # The rows never reach a launch: release their holds.
                front.release_window([
                    k for r, _ in shed
                    if (k := front._norm_key(r.key)) is not None
                ])
            for _, fut in shed:
                if not fut.done():
                    fut.set_exception(
                        DeadlineError(STATUS_MESSAGES[STATUS_DEADLINE])
                    )
            flat = live
        return [
            flat[i : i + self.batch_size]
            for i in range(0, len(flat), self.batch_size)
        ]

    def _next_seq(self) -> int:
        return self.front.next_seq() if self.front is not None else 0

    def _fail_windows(self, windows, exc) -> None:
        front = self.front
        if front is not None and front.deny_cache is not None:
            # The launch may have COMMITTED before the failure (a fetch
            # error lands here too): release the holds and drop the keys'
            # cached denials and write records.
            front.fail_window([r.key for w in windows for r, _ in w])
        for window in windows:
            for _, fut in window:
                if not fut.done():
                    fut.set_exception(ThrottleError(str(exc)))

    async def _finish_windows(self, windows, results, now_ns, seq,
                              elapsed) -> None:
        """Resolve the futures of decided windows, feed the front tier,
        then account."""
        front = self.front
        observe = front is not None and front.deny_cache is not None
        total = 0
        for window, result in zip(windows, results):
            total += len(window)
            self._complete(window, result)
            if observe:
                self._observe_window(window, result, now_ns, seq)
        if self.checkpointer is not None:
            # Every decided key is dirty for the next checkpoint delta
            # (a host-side set insert; the device loop is untouched).
            self.checkpointer.note_keys(r.key for w in windows for r, _ in w)
        await self._maybe_record(windows, results, now_ns)
        if front is not None:
            front.record_launch(total, elapsed)
        if self.metrics is not None:
            self.metrics.record_launch(total)
        await self._maybe_sweep(now_ns, total)

    def _record_windows(self, windows, results, now_ns) -> None:
        """Flight-recorder capture (replay/): one call per decided
        window — runs on the executor, off the event loop."""
        rec = active_recorder()
        if rec is None:
            return
        for window, result in zip(windows, results):
            rec.record_window(
                now_ns,
                [r.key for r, _ in window],
                [
                    (r.max_burst, r.count_per_period, r.period, r.quantity)
                    for r, _ in window
                ],
                result.allowed,
                result.status,
                source=SOURCE_ENGINE,
            )

    async def _maybe_record(self, windows, results, now_ns) -> None:
        """Per-batch capture hook: one None check when disarmed; armed
        captures hop to the executor so trace encoding never runs on the
        event loop."""
        if active_recorder() is None:
            return
        loop = asyncio.get_running_loop()
        await loop.run_in_executor(
            None, self._record_windows, windows, results, now_ns
        )

    def _observe_window(self, window, result, now_ns, seq) -> None:
        """Feed one decided window's rows to the deny cache in arrival
        order: allowed rows invalidate and refresh write records, denied
        rows may certify entries, every row releases its hold."""
        front = self.front
        cur = getattr(result, "cur_ns", None)
        status_l = result.status.tolist()
        allowed_l = result.allowed.tolist()
        cur_l = cur.tolist() if cur is not None else None
        if cur_l is not None or hasattr(result, "reset_after_s"):
            # Bulk: a row's cur_ns is None off the cur tier (allowed rows
            # still invalidate, denials cannot certify); a non-OK row
            # rides along as an uncertifiable denial to release its hold.
            rows = []
            for i, (r, _) in enumerate(window):
                k = front._norm_key(r.key)
                if k is None:
                    continue  # begin_inflight was a no-op for it too
                ok = status_l[i] == STATUS_OK
                rows.append((
                    k, r.max_burst, r.count_per_period, r.period,
                    r.quantity, ok and bool(allowed_l[i]),
                    cur_l[i] if (ok and cur_l is not None) else None,
                ))
            front.observe_window(rows, now_ns, seq)
            return
        # Nanosecond planes: the exact TAT comes from reset/retry, per row.
        for i, (r, _) in enumerate(window):
            try:
                if status_l[i] != STATUS_OK:
                    continue
                front.observe(
                    r.key, r.max_burst, r.count_per_period, r.period,
                    r.quantity, now_ns, bool(allowed_l[i]), seq,
                    reset_after_ns=int(result.reset_after_ns[i]),
                    retry_after_ns=int(result.retry_after_ns[i]),
                )
            finally:
                front.end_inflight(r.key)

    def _deadline_many_kw(self, windows) -> dict:
        """Per-window deadline columns for a deadline-aware limiter (a
        ClusterLimiter: forwards carry the remaining budget, so a
        hop-chained request cannot outlive its client).  An empty dict,
        the unchanged call, when the limiter takes none or no request in
        the flush carries one."""
        if not self._limiter_takes_deadlines:
            return {}
        if not any(
            r.deadline_ns is not None for w in windows for r, _ in w
        ):
            return {}
        return {
            "deadlines": [
                [r.deadline_ns or 0 for r, _ in w] for w in windows
            ]
        }

    async def _fetch_complete(self, in_flight) -> None:
        """Fetch an in-flight launch's results and resolve its futures."""
        windows, handle, now_ns, seq = in_flight
        loop = asyncio.get_running_loop()
        t_fetch = time.monotonic()
        try:
            results = await loop.run_in_executor(None, handle.fetch)
        except Exception as exc:
            self._fail_windows(windows, exc)
            return
        await self._finish_windows(windows, results, now_ns, seq,
                                   time.monotonic() - t_fetch)

    async def _decide_many(self, windows) -> None:
        """Backlog path: K sub-batches, one launch, shared timestamp."""
        now_ns = self.now_fn()
        loop = asyncio.get_running_loop()
        self._profile_tick()
        dl_kw = self._deadline_many_kw(windows)

        def launch():
            with self.limiter_lock, annotate("gcra_scan_decide"):
                return self._next_seq(), self.limiter.rate_limit_many(
                    [self._columns(w, now_ns) for w in windows],
                    **self._wire_many_kw,
                    **dl_kw,
                )

        t0 = time.monotonic()
        try:
            seq, results = await loop.run_in_executor(
                self._launch_pool, launch
            )
        except Exception as exc:
            self._fail_windows(windows, exc)
            return
        await self._finish_windows(windows, results, now_ns, seq,
                                   time.monotonic() - t0)

    async def _decide(self, batch) -> None:
        """One batch, one launch."""
        now_ns = self.now_fn()
        loop = asyncio.get_running_loop()
        self._profile_tick()
        dl_kw = {}
        if self._limiter_takes_deadlines and any(
            r.deadline_ns is not None for r, _ in batch
        ):
            dl_kw = {"deadlines_ns": [r.deadline_ns or 0 for r, _ in batch]}

        def launch():
            with self.limiter_lock, annotate("gcra_batch_decide"):
                return self._next_seq(), self.limiter.rate_limit_batch(
                    *self._columns(batch, now_ns), **self._wire_kw, **dl_kw
                )

        t0 = time.monotonic()
        try:
            seq, result = await loop.run_in_executor(
                self._launch_pool, launch
            )
        except Exception as exc:  # internal failure fails the whole batch
            self._fail_windows([batch], exc)
            return
        await self._finish_windows([batch], [result], now_ns, seq,
                                   time.monotonic() - t0)

    @staticmethod
    def _complete(batch, result) -> None:
        """Resolve each request's future from its batch-result row."""
        wire = hasattr(result, "reset_after_s")
        for i, (_, fut) in enumerate(batch):
            if fut.done():
                continue
            status = int(result.status[i])
            if status == STATUS_TENANT_QUOTA:
                # A capacity condition, not a server fault: the protocol
                # overload status (HTTP 503 / gRPC RESOURCE_EXHAUSTED /
                # RESP -ERR), so clients can tell "tenant over quota,
                # back off" from a 500-class error.
                fut.set_exception(
                    OverloadError(STATUS_MESSAGES[STATUS_TENANT_QUOTA])
                )
            elif status == STATUS_DEADLINE:
                fut.set_exception(
                    DeadlineError(STATUS_MESSAGES[STATUS_DEADLINE])
                )
            elif status != STATUS_OK:
                fut.set_exception(
                    ThrottleError(
                        STATUS_MESSAGES.get(status, "internal error")
                    )
                )
            elif wire:
                # The wire tiers are already whole seconds.
                fut.set_result(
                    ThrottleResponse(
                        allowed=bool(result.allowed[i]),
                        limit=int(result.limit[i]),
                        remaining=int(result.remaining[i]),
                        reset_after=int(result.reset_after_s[i]),
                        retry_after=int(result.retry_after_s[i]),
                    )
                )
            else:
                fut.set_result(
                    ThrottleResponse.from_ns(
                        allowed=bool(result.allowed[i]),
                        limit=int(result.limit[i]),
                        remaining=int(result.remaining[i]),
                        reset_after_ns=int(result.reset_after_ns[i]),
                        retry_after_ns=int(result.retry_after_ns[i]),
                    )
                )

    # ------------------------------------------------------------------ #

    async def _maybe_sweep(self, now_ns: int, n_ops: int) -> None:
        loop = asyncio.get_running_loop()
        insight = self.insight
        if insight is not None and insight.poll_due(now_ns):
            # Throttled insight poll (~1/s): the totals fetch and the
            # top-K wait for the card, so it runs on the executor, under
            # the lock that serializes device access.
            await loop.run_in_executor(
                None, insight.maybe_poll, now_ns, self.limiter_lock
            )
        control = self.control
        if control is not None and control.tick_due(now_ns):
            # Throttled control tick: sensor snapshot + feedback step,
            # off the event loop under the limiter lock (on a card the
            # insight sensors fetch device totals).
            depth = len(self._pending)
            await loop.run_in_executor(
                None,
                lambda: control.maybe_tick(
                    now_ns, self.limiter_lock, queue_depth=depth
                ),
            )
        checkpointer = self.checkpointer
        if checkpointer is not None and checkpointer.tick_due(now_ns):
            # Throttled checkpoint write: the device export runs under
            # the limiter lock, encode + CRC + fsync outside it, all off
            # the event loop.
            await loop.run_in_executor(
                None, checkpointer.maybe_tick, now_ns, self.limiter_lock
            )
        policy = self.cleanup_policy
        if policy is None:
            return
        # All policy state moves under limiter_lock.  The expired-hit
        # drain is a blocking device->host fetch (throttled to ~1/s):
        # when one is due it runs on the executor, never on the loop.
        with self.limiter_lock:
            policy.record_ops(n_ops)
            fetch_due = getattr(policy, "uses_expired_signal", False) and (
                getattr(self.limiter, "expired_hits_fetch_due", None)
                is not None
                and self.limiter.expired_hits_fetch_due(now_ns)
            )
            n_hits = 0
            if not fetch_due:
                n_hits = feed_expired_hits(policy, self.limiter, now_ns)
            live = len(self.limiter)
            capacity = getattr(self.limiter, "total_capacity", 1 << 62)
            should = fetch_due or policy.should_clean(now_ns, live, capacity)
        if n_hits and self.metrics is not None:
            self.metrics.record_expired_hits(n_hits)
        if not should:
            return

        def locked_policy_step():
            drained = 0
            with self.limiter_lock:
                live_now = live
                if fetch_due:
                    drained += feed_expired_hits(policy, self.limiter, now_ns)
                    live_now = len(self.limiter)
                    if not policy.should_clean(now_ns, live_now, capacity):
                        return None, drained
                else:
                    # Attribute hits already counted on-device to the
                    # window this sweep closes.
                    drained += feed_expired_hits(
                        policy, self.limiter, now_ns, force=True
                    )
                freed = self.limiter.sweep(now_ns)
                policy.after_sweep(now_ns, freed, live_now)
                return freed, drained

        freed, drained = await loop.run_in_executor(None, locked_policy_step)
        if freed is not None and self.front is not None:
            # Swept buckets are gone even for a later regressed clock:
            # drop the deny-cache entries they backed.
            self.front.on_sweep(now_ns)
        if self.metrics is not None:
            if drained:
                self.metrics.record_expired_hits(drained)
            if freed is not None:
                self.metrics.record_sweep(freed)

    def _profile_tick(self) -> None:
        """Start/stop the torch.profiler capture around the first N
        launches (called on the event loop before each launch; the
        capture starts and stops on the launches' own thread)."""
        if self._profile_remaining <= 0:
            if self._profile is not None:
                self._stop_profile()
            return
        if self._profile is None:
            from concurrent.futures import ThreadPoolExecutor

            from ..tpu.profiling import ProfileSession

            self._profile = ProfileSession(self._profile_dir)
            self._launch_pool = ThreadPoolExecutor(
                1, thread_name_prefix="tk-profile"
            )
            self._launch_pool.submit(self._profile.start)
        self._profile_remaining -= 1

    def _stop_profile(self):
        """Queue the capture's stop behind the profiled launches on their
        thread; returns the future of the written trace's path."""
        session, pool = self._profile, self._launch_pool
        self._profile = self._launch_pool = None

        def stop():
            try:
                path = session.stop()
            except Exception:  # a capture that never started included
                log.exception("profiler capture failed")
                return None
            log.info("profiler trace of the first launches: %s", path)
            return path

        fut = pool.submit(stop)
        pool.shutdown(wait=False)
        return fut

    def health_state(self) -> str:
        """The state for GET /health: the supervisor's "ok" | "retrying"
        | "degraded" | "recovering" ("ok" for an unsupervised limiter),
        or "draining" / "shutdown"."""
        if self._closed:
            return "shutdown"
        if self._draining:
            return "draining"
        return supervisor_state(self.limiter)

    def begin_drain(self) -> None:
        """New requests shed with OverloadError, /health says "draining",
        queued requests keep resolving with real decisions."""
        self._draining = True

    async def drain(self) -> None:
        """Graceful half of shutdown: stop taking requests, then flush
        everything already queued with real decisions."""
        self.begin_drain()
        if self._flush_handle is not None:
            self._flush_handle.cancel()
            self._flush_handle = None
        await self._flush()

    async def shutdown(self) -> None:
        """Flush outstanding requests and refuse new ones."""
        self._closed = True
        if self._flush_handle is not None:
            self._flush_handle.cancel()
            self._flush_handle = None
        await self._flush()
        if self._profile is not None:
            await asyncio.wrap_future(self._stop_profile())
