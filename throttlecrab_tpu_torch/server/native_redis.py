"""Native RESP transport: C++ epoll wire layer + Python device driver.

The port's counterpart of `throttlecrab_tpu/server/native_redis.py`.  The
C++ side (`native/wire_server.cpp`, built by `native.get_wire_lib`) owns
the sockets: accept, RESP parsing, PING/QUIT and protocol errors answered
inline, THROTTLE requests queued.  This module runs the *driver thread*:
it blocks in `ws_next_batch` (a ctypes call, so the GIL is released while
it waits), drains a backlog of full batches into one window, decides the
window with `TorchRateLimiter.dispatch_wire_window` (one C++
`tk_prepare_batch` per frame, one launch of the decision-window kernel
on the card), and hands the 5-integer results back to C++ for
serialization.  The per-request Python cost is zero; a window costs one
dispatch and one fetch, and one `ws_respond` per batch in it.

Same command semantics and hardening as the asyncio transport (redis.py);
the two are interchangeable via `--redis-backend {python,native}`.

With a front tier (front/, shared with the asyncio engine) each captured
frame first passes the deny cache and admission control: hits get their
exact denial, shed rows the overload status (`-ERR server overloaded`,
HTTP 503), and only the remaining rows are compacted into the frames the
device decides; their results feed the cache back.  A supervised limiter
(server/supervisor.py) returns None from `dispatch_wire_window` while
degraded, and the exact path below then decides on the wrapper, which
routes it to the host oracle.

After each window the driver captures it into the flight recorder when
one is armed (replay/), and runs the insight tier's throttled poll, the
control plane's throttled tick and the checkpointer's throttled tick
(insight/, control/, persist/; shared with the asyncio engine), as the
engine's housekeeping step does.

Shared state: pass the same limiter (and `limiter_lock`) used by the
asyncio engine so limits hold across every transport; the lock serializes
device access between the engine's executor thread and this driver.

`WIRE_WINDOWS`, `EXACT_WINDOWS` and `DISPATCH_ERRORS` count, over every
driver in the process, the windows decided through
`dispatch_wire_window`, the windows the exact path
(`rate_limit_many` / `rate_limit_batch`) decided, and the exceptions
raised while deciding a window.
"""

from __future__ import annotations

import ctypes
import inspect
import logging
import threading
import time
from typing import Optional

import numpy as np
import torch

from ..front import STATUS_OVERLOADED
from ..native import get_wire_lib
from ..replay.recorder import active_recorder
from ..replay.trace import SOURCE_NATIVE
from ..tpu.cleanup import feed_expired_hits
from ..tpu.limiter import (
    STATUS_DEADLINE,
    STATUS_INTERNAL,
    WireBatchResult,
    limiter_uses_bytes_keys,
)
from .metrics import merge_cluster_stats
from .supervisor import supervisor_state

log = logging.getLogger("throttlecrab.redis.native")

NS_PER_SEC = 1_000_000_000

#: Windows decided through limiter.dispatch_wire_window (one launch each).
WIRE_WINDOWS = 0
#: Windows decided by the exact path (a conflict, a full table, or a
#: failure before the wire dispatch launched).
EXACT_WINDOWS = 0
#: Exceptions raised while deciding a window, before or after a launch.
DISPATCH_ERRORS = 0
_count_lock = threading.Lock()


def _count(wire: int = 0, exact: int = 0, errors: int = 0) -> None:
    global WIRE_WINDOWS, EXACT_WINDOWS, DISPATCH_ERRORS
    with _count_lock:
        WIRE_WINDOWS += wire
        EXACT_WINDOWS += exact
        DISPATCH_ERRORS += errors


class NativeRedisTransport:
    """RESP on the C++ wire server; drop-in for RedisTransport."""

    name = "redis"
    PROTOCOL = 0  # wire_server.cpp: 0 = RESP, 1 = HTTP

    def __init__(
        self,
        host: str,
        port: int,
        limiter,
        metrics,
        batch_size: int = 4096,
        max_linger_us: int = 200,
        cleanup_policy=None,
        limiter_lock: Optional[threading.Lock] = None,
        now_fn=None,
        max_scan_depth: int = 16,
        front=None,
        insight=None,
        checkpointer=None,
        control=None,
    ) -> None:
        lib = get_wire_lib()
        if lib is None:
            raise RuntimeError("native wire server unavailable (no g++?)")
        self._lib = lib
        self.host = host
        self.port = port
        self.limiter = limiter
        self.metrics = metrics
        # The front tier, shared with the asyncio engine, so a denial
        # cached on one transport serves (and is invalidated by) all.
        self.front = front
        # The insight tier and the checkpointer, shared with the asyncio
        # engine: this driver thread drives the throttled poll and tick
        # after each window and pushes the /stats snapshot.
        self.insight = insight
        self.checkpointer = checkpointer
        # The control plane, shared with the asyncio engine: this driver
        # thread drives its throttled tick right after the insight poll.
        self.control = control
        # Ask for the observed-TAT plane (the cur tier) only when a deny
        # cache is attached (see engine.py).
        def cur_kw(method_name):
            if front is None or front.deny_cache is None:
                return {}
            try:
                params = inspect.signature(
                    getattr(limiter, method_name)
                ).parameters
            except (AttributeError, TypeError, ValueError):
                return {}
            return {"collect_cur": True} if "collect_cur" in params else {}

        self._collect_cur_kw = cur_kw("dispatch_wire_window")
        self._collect_cur_many_kw = cur_kw("rate_limit_many")
        self._collect_cur_batch_kw = cur_kw("rate_limit_batch")
        self.batch_size = batch_size
        self.max_linger_us = max_linger_us
        self.max_scan_depth = max_scan_depth
        self.cleanup_policy = cleanup_policy
        self.limiter_lock = limiter_lock or threading.Lock()
        self.now_fn = now_fn or time.time_ns
        self._h = lib.ws_create()
        self._driver: Optional[threading.Thread] = None
        self._running = False
        self.bound_port: Optional[int] = None
        # Reusable batch buffers.  key_buf must exceed the wire layer's
        # per-connection frame cap (64 KB) so any single accepted key fits
        # — ws_next_batch's progress guarantee depends on it.
        B = batch_size
        self._key_buf = ctypes.create_string_buffer(B * 256 + (128 << 10))
        self._offsets = np.zeros(B + 1, np.int64)
        # Stride 5: the wire layer appends a remaining-deadline-budget
        # column (ns; 0 = none, negative = expired at pop).
        self._params = np.zeros(5 * B, np.int64)
        self._cookie_gen = np.zeros(B, np.uint64)
        self._cookie_fd = np.zeros(B, np.int32)
        # Graceful drain: once set, /health (HTTP protocol) reports
        # "draining" so balancers stop routing here while the driver
        # keeps answering already-queued requests.
        self._draining = False

    # ------------------------------------------------------------------ #

    async def start(self) -> None:
        rc = self._lib.ws_start(
            self._h, self.host.encode(), self.port, self.PROTOCOL
        )
        if rc != 0:
            raise OSError(
                f"native {self.name} transport failed to bind {self.host}:"
                f"{self.port}"
            )
        self.bound_port = self._lib.ws_port(self._h)
        self._running = True
        self._driver = threading.Thread(
            target=self._drive, name=f"tk-native-{self.name}", daemon=True
        )
        self._driver.start()
        log.info(
            "native %s transport listening on %s:%d",
            self.name, self.host, self.bound_port,
        )

    async def serve_forever(self) -> None:
        import asyncio

        while self._running:
            await asyncio.sleep(0.5)
            if self._driver is not None and not self._driver.is_alive():
                raise RuntimeError(f"native {self.name} driver thread died")

    async def drain(self) -> None:
        """Graceful-drain hook: advertise "draining" on /health (HTTP
        protocol) so balancers stop routing here.  The listener stays
        up and the driver keeps answering queued requests — the C++
        wire layer has no accept gate, so the health flip is the
        routing signal; stop() drops connections afterwards."""
        self._draining = True
        if self.PROTOCOL == 1:
            body = b"draining"
            self._lib.ws_set_health(self._h, body, len(body))

    async def stop(self) -> None:
        import asyncio

        self._running = False
        loop = asyncio.get_running_loop()
        # ws_stop is the poison pill: it flips the C++ running flag and
        # notifies the queue condvar, so a driver parked in
        # ws_next_batch (whose wait predicate includes !running) wakes
        # immediately instead of sleeping out its linger timeout.  It
        # also joins the IO thread — up to ~1 s of epoll_wait — so it
        # runs on the executor, never the event loop.
        await loop.run_in_executor(None, self._lib.ws_stop, self._h)
        driver = self._driver
        if driver is not None:
            await loop.run_in_executor(None, driver.join, 5)
            if driver.is_alive():
                # Most likely wedged inside a device launch (the one
                # block ws_stop cannot interrupt).  Leak it loudly —
                # and skip ws_destroy, which would free wire state the
                # thread may still touch.
                log.warning(
                    "native %s driver thread did not exit within 5 s "
                    "(stuck in a device launch?); leaking the thread "
                    "and its wire handle instead of corrupting state",
                    self.name,
                )
                self._leaked = True

    def __del__(self):
        h = getattr(self, "_h", None)
        if h and not getattr(self, "_leaked", False):
            self._lib.ws_destroy(h)
            self._h = None

    # ------------------------------------------------------------------ #

    def _next_batch(self, linger_us: int) -> int:
        return self._lib.ws_next_batch(
            self._h,
            linger_us,
            self.batch_size,
            self._key_buf,
            len(self._key_buf),
            self._offsets.ctypes.data_as(ctypes.c_void_p),
            self._params.ctypes.data_as(ctypes.c_void_p),
            self._cookie_gen.ctypes.data_as(ctypes.c_void_p),
            self._cookie_fd.ctypes.data_as(ctypes.c_void_p),
        )

    def _capture(self, n: int):
        """Snapshot the reusable batch buffers into a per-batch frame:
        (key_blob, offsets, params[n, 4], cookie_gen, cookie_fd,
        budgets[n]) — params is the exact shape dispatch_wire_window
        consumes (the deadline column is split off as `budgets`), with
        keys derived lazily only on the exact path."""
        offsets = self._offsets[: n + 1].copy()
        # Copy only the used prefix, not the whole reusable buffer.
        blob = ctypes.string_at(self._key_buf, int(offsets[n]))
        params5 = self._params[: 5 * n].reshape(n, 5)
        params = params5[:, :4].copy()
        budgets = params5[:, 4].copy()
        return (
            blob,
            offsets,
            params,
            self._cookie_gen[:n].copy(),
            self._cookie_fd[:n].copy(),
            budgets,
        )

    def _keys_of(self, blob, offsets):
        keys = [
            blob[offsets[i] : offsets[i + 1]]
            for i in range(len(offsets) - 1)
        ]
        if not limiter_uses_bytes_keys(self.limiter):
            # Match the identity the str-keyed transports use, so one
            # client key maps to one bucket across HTTP/RESP.
            # surrogateescape keeps arbitrary bytes unique and lossless.
            keys = [k.decode("utf-8", "surrogateescape") for k in keys]
        return keys

    def _drive(self) -> None:
        """The decide loop: block for a batch; when a full batch arrives
        (backlog — e.g. pipelined clients), drain up to max_scan_depth
        further batches without lingering and decide the whole window in
        ONE device launch, exactly like the asyncio engine's backlog
        path."""
        # A cluster node's table is its local limiter's.
        dev = getattr(self.limiter, "local", self.limiter)
        state = getattr(getattr(dev, "table", None), "state", None)
        if state is not None and state.is_cuda:
            # This thread launches the window kernel on the current
            # stream of the table's card (a tensor's device has an index).
            torch.cuda.set_device(state.device)
        B = self.batch_size
        can_scan = hasattr(self.limiter, "rate_limit_many")
        self._push_metrics()
        last_metrics = time.monotonic()
        while self._running:
            try:
                if (
                    self.PROTOCOL == 1
                    and time.monotonic() - last_metrics > 1.0
                ):
                    self._push_metrics()
                    last_metrics = time.monotonic()
                n = self._next_batch(self.max_linger_us)
                if n <= 0:
                    continue
                batches = [self._capture(int(n))]
                while (
                    can_scan
                    and n == B
                    and len(batches) < self.max_scan_depth
                ):
                    n = self._next_batch(0)
                    if n <= 0:
                        break
                    batches.append(self._capture(int(n)))
                self._decide_window(batches)
            except Exception:
                log.exception("native %s driver error", self.name)
                if not self._running:
                    return

    def _front_filter(self, batch, now_ns, depth):
        """Run one captured frame through the front tier BEFORE batch
        prep: deny-cache hits get their exact denial, admission-shed rows
        the overload status, and only the surviving misses are compacted
        into a (blob, offsets, params) frame for the device.  The cache
        is consulted first: a hit never occupies the queue admission
        protects.  Miss keys are marked in-flight until observed.  Rows
        whose deadline budget expired before pop are shed first (status
        6): the client stopped waiting."""
        blob, offsets, params, _gen, _fd, budgets = batch
        n = len(offsets) - 1
        front = self.front
        admission = front.admission
        status_pre = np.zeros(n, np.uint8)
        hit_vals = np.zeros((n, 5), np.int64)
        q_col = params[:, 3].tolist()
        miss_pos: list = []
        miss_keys: list = []
        miss_norm: list = []
        if front.deny_cache is not None:
            raw = [blob[offsets[i] : offsets[i + 1]] for i in range(n)]
            # The cache's key identity is the keymap's: bytes for the
            # native keymap (no copy), decoded like the transports do
            # for a str-keyed one.
            if front.bytes_keys:
                norm = raw
            else:
                norm = [k.decode("utf-8", "surrogateescape") for k in raw]
            # One lock and one computation per distinct (key, params, q);
            # misses are marked in-flight until _observe_plan releases
            # them.
            rows, _ = front.lookup_window(
                norm, params[:, 0], params[:, 1], params[:, 2],
                params[:, 3], now_ns,
            )
            shed_norm: list = []
            for i in range(n):
                if budgets[i] < 0:
                    status_pre[i] = STATUS_DEADLINE
                    if rows[i] is None:
                        # Marked in-flight but never observed: release.
                        shed_norm.append(norm[i])
                    continue
                hit = rows[i]
                if hit is not None:
                    status_pre[i] = 255  # marker: row served from cache
                    hit_vals[i] = (
                        0, hit[0], hit[1], hit[2] // NS_PER_SEC,
                        hit[3] // NS_PER_SEC,
                    )
                    continue
                if admission is not None and not front.admit(
                    depth, q_col[i] == 0
                ):
                    status_pre[i] = STATUS_OVERLOADED
                    shed_norm.append(norm[i])
                    continue
                miss_pos.append(i)
                miss_keys.append(raw[i])
                miss_norm.append(norm[i])
            if shed_norm:
                front.release_window(shed_norm)
        else:
            # Admission only: no key slices or decodes are needed.
            for i in range(n):
                if budgets[i] < 0:
                    status_pre[i] = STATUS_DEADLINE
                elif admission is not None and not front.admit(
                    depth, q_col[i] == 0
                ):
                    status_pre[i] = STATUS_OVERLOADED
                else:
                    miss_pos.append(i)
            if len(miss_pos) != n:
                miss_keys = [
                    blob[offsets[i] : offsets[i + 1]] for i in miss_pos
                ]
        plan = self._plan(batch, status_pre, np.asarray(miss_pos, np.int64),
                          miss_keys)
        plan["hit_vals"] = hit_vals
        plan["miss_norm"] = miss_norm
        return plan

    def _deadline_plan(self, batch):
        """No-front twin of _front_filter for a batch carrying expired
        rows: expired budgets answer status 6 (`-ERR deadline exceeded`,
        HTTP 504), live rows compact into the device frame."""
        blob, offsets, _params, _gen, _fd, budgets = batch
        expired = budgets < 0
        status_pre = np.where(expired, STATUS_DEADLINE, 0).astype(np.uint8)
        miss_idx = np.flatnonzero(~expired)
        keys = [blob[offsets[i] : offsets[i + 1]] for i in miss_idx]
        return self._plan(batch, status_pre, miss_idx, keys)

    @staticmethod
    def _plan(batch, status_pre, miss_idx, miss_keys):
        """The plan _merge_plan consumes: the rows at `miss_idx` (keys
        `miss_keys`, needed only when not every row goes) compacted into
        one device frame, None when no row goes."""
        blob, offsets, params = batch[:3]
        n = len(offsets) - 1
        m = len(miss_idx)
        if m == n:
            miss_frame = (blob, offsets, params)
            miss_params = params
        elif m:
            offsets_m = np.zeros(m + 1, np.int64)
            np.cumsum([len(k) for k in miss_keys], out=offsets_m[1:])
            miss_params = np.ascontiguousarray(params[miss_idx])
            miss_frame = (b"".join(miss_keys), offsets_m, miss_params)
        else:
            miss_frame = None
            miss_params = None
        return {
            "n": n,
            "status_pre": status_pre,
            "hit_vals": None,
            "miss_idx": miss_idx,
            "miss_norm": [],
            "miss_frame": miss_frame,
            "miss_params": miss_params,
        }

    @staticmethod
    def _merge_plan(plan, res):
        """Fold a miss sub-frame's device results back into the full
        frame beside cached hits and shed rows; returns the
        WireBatchResult-shaped object _respond_one serializes."""
        n = plan["n"]
        out = np.zeros((n, 5), np.int64)
        status = plan["status_pre"].copy()
        served = status == 255  # cache-hit marker: status OK on the wire
        if bool(served.any()):
            out[served] = plan["hit_vals"][served]
            status[served] = 0
        mi = plan["miss_idx"]
        if len(mi):
            if res is None:
                status[mi] = STATUS_INTERNAL
            else:
                status[mi] = res.status
                out[mi, 0] = res.allowed
                out[mi, 1] = res.limit
                out[mi, 2] = res.remaining
                out[mi, 3] = res.reset_after_s
                out[mi, 4] = res.retry_after_s
        return WireBatchResult(
            allowed=out[:, 0], limit=out[:, 1], remaining=out[:, 2],
            reset_after_s=out[:, 3], retry_after_s=out[:, 4],
            status=status,
        )

    def _observe_plan(self, plan, res, now_ns, seq) -> None:
        """Feed the miss rows' decisions to the deny cache and release
        their in-flight holds, in bulk (the native twin of
        engine._observe_window)."""
        front = self.front
        norm = plan["miss_norm"]
        if res is None:
            # Post-launch failure: the writes may have committed, so drop
            # the keys' cached denials and write records with the holds.
            front.deny_cache.fail_window(norm)
            return
        cur = getattr(res, "cur_ns", None)
        status = res.status.tolist()
        allowed_col = res.allowed.tolist()
        cur_l = cur.tolist() if cur is not None else None
        params_l = plan["miss_params"].tolist()
        rows = []
        for i, key in enumerate(norm):
            ok = status[i] == 0
            # Without the exact observed TAT (cur tier) a denial cannot
            # certify, but an allowed row must still invalidate.
            c = cur_l[i] if (ok and cur_l is not None) else None
            p = params_l[i]
            rows.append((key, p[0], p[1], p[2], p[3],
                         ok and bool(allowed_col[i]), c))
        front.observe_window(rows, now_ns, seq)

    def _decide_frames(self, frames, now_ns):
        """Decide a window of (blob, offsets, params) frames on the
        device; returns (results, seq): one WireBatchResult (or None
        after a post-launch failure) per frame, and the deny cache's
        dispatch-order stamp."""
        if not frames:
            return [], 0
        results = None
        seq = 0
        front = self.front
        # Fast path: hand the raw wire frames to the fully native prep —
        # one C++ call per frame validates, derives the GCRA params, and
        # writes the packed launch rows (limiter.dispatch_wire_window).
        wire_dispatch = getattr(self.limiter, "dispatch_wire_window", None)
        handle = None
        if wire_dispatch is not None:
            try:
                with self.limiter_lock:
                    # Dispatch-order stamp under the lock that orders
                    # launches across transports.
                    seq = front.next_seq() if front is not None else 0
                    handle = wire_dispatch(
                        frames, now_ns, **self._collect_cur_kw
                    )
            except Exception:
                # Failed BEFORE any launch committed state: the exact
                # path below may safely re-decide.
                log.exception("native wire dispatch failed")
                _count(errors=1)
                handle = None
        if handle is not None:
            _count(wire=1)
            try:
                results = handle.fetch()
            except Exception:
                # The launch already mutated the bucket table — the
                # decisions are committed even though we cannot read
                # them.  Re-deciding would debit every bucket twice, so
                # answer internal errors instead of falling back.
                log.exception("native wire fetch failed (post-launch)")
                _count(errors=1)
                results = [None] * len(frames)
        if results is None:
            _count(exact=1)
            try:
                with self.limiter_lock:
                    seq = front.next_seq() if front is not None else 0
                    # wire=True: whole-second outputs straight off the
                    # device — the RESP/HTTP reply units.
                    windows = [
                        (
                            self._keys_of(b, o),
                            p[:, 0], p[:, 1], p[:, 2], p[:, 3],
                            now_ns,
                        )
                        for b, o, p in frames
                    ]
                    if (
                        hasattr(self.limiter, "rate_limit_many")
                        and len(windows) > 1
                    ):
                        results = self.limiter.rate_limit_many(
                            windows, wire=True, **self._collect_cur_many_kw
                        )
                    else:
                        results = [
                            self.limiter.rate_limit_batch(
                                *w, wire=True, **self._collect_cur_batch_kw
                            )
                            for w in windows
                        ]
            except Exception:
                log.exception("native %s decide failed", self.name)
                _count(errors=1)
                results = [None] * len(frames)
        return results, seq

    def _decide_window(self, batches) -> None:
        now_ns = self.now_fn()
        front = self.front
        use_front = front is not None and (
            front.deny_cache is not None or front.admission is not None
        )
        n_expired = sum(int((b[5] < 0).sum()) for b in batches)
        if use_front:
            depth = int(self._lib.ws_queue_depth(self._h))
            plans = [self._front_filter(b, now_ns, depth) for b in batches]
            frames = [
                p["miss_frame"] for p in plans
                if p["miss_frame"] is not None
            ]
        elif n_expired:
            plans = [self._deadline_plan(b) for b in batches]
            frames = [
                p["miss_frame"] for p in plans
                if p["miss_frame"] is not None
            ]
        else:
            plans = None
            frames = [(b, o, p) for b, o, p, _, _, _ in batches]
        if n_expired and self.metrics is not None:
            self.metrics.record_deadline_shed(n_expired)
        launched_n = sum(len(f[1]) - 1 for f in frames)
        t0 = time.monotonic()
        results, seq = self._decide_frames(frames, now_ns)
        if frames and front is not None:
            front.record_launch(launched_n, time.monotonic() - t0)
        any_launch = bool(frames)
        if plans is not None:
            # Re-align the miss rows' results with their plans, observe
            # them, and merge hits, shed rows and decisions per frame.
            merged = []
            it = iter(results)
            for plan in plans:
                res = (
                    next(it) if plan["miss_frame"] is not None else None
                )
                if front is not None and front.deny_cache is not None:
                    self._observe_plan(plan, res, now_ns, seq)
                merged.append(self._merge_plan(plan, res))
            results = merged
        self._maybe_record(batches, results, now_ns)
        # Metrics: ONE aggregated record for the whole window — it was
        # one device launch (record_batch bumps device_launches, so
        # per-sub-batch calls would overcount launches by up to
        # max_scan_depth and wreck the coalescing ratio).
        tot_allowed = tot_denied = tot_errors = 0
        denied_keys: list = []
        track_denied = (
            self.metrics is not None
            and self.metrics.top_denied is not None
        )
        for (blob, offsets, _p, gen, fd, _b), res in zip(batches, results):
            n_a, n_d, n_e, dk = self._respond_one(
                blob, offsets, gen, fd, res, track_denied
            )
            tot_allowed += n_a
            tot_denied += n_d
            tot_errors += n_e
            denied_keys.extend(dk)
            # A merged plan is never None: a window answered wholly from
            # the deny cache still counts its requests (launches=0).
            any_launch = any_launch or res is not None
        if self.insight is not None:
            # Throttled (~1/s) insight poll; this driver thread may block
            # on the card, as its decide launches do.
            self.insight.maybe_poll(now_ns, self.limiter_lock)
        if self.control is not None:
            # Throttled control tick, same discipline.  The native wire
            # layer holds its own pending queue device-side of this
            # driver, so depth 0 is the honest engine-queue reading —
            # admission's EWMA wait still carries the launch-cost signal.
            self.control.maybe_tick(now_ns, self.limiter_lock)
        if self.checkpointer is not None:
            if frames:
                # Launched rows mark dirty for the next delta (the
                # delta matches keys on their canonical bytes).
                self.checkpointer.note_keys(
                    k for b, o, _p in frames for k in self._keys_of(b, o)
                )
            # Throttled checkpoint write: device export under
            # limiter_lock, encode + fsync outside it.
            self.checkpointer.maybe_tick(now_ns, self.limiter_lock)
        if self.metrics is not None and (any_launch or tot_errors):
            self.metrics.record_batch(
                self.name,
                n_allowed=tot_allowed,
                n_denied=tot_denied,
                n_errors=tot_errors,
                denied_keys=denied_keys,
                # Only requests that actually rode the launch count
                # toward the batching/coalescing gauges.
                batch=launched_n,
                launches=1 if frames else 0,
            )
        self._maybe_sweep(now_ns, sum(len(b[1]) - 1 for b in batches))

    def _maybe_record(self, batches, results, now_ns) -> None:
        """Flight-recorder capture (replay/): the native twin of the
        engine's — per-batch, already off any event loop (this is the
        driver thread), one None check when disarmed.  A sub-batch that
        never launched is recorded with the internal-error status its
        requests were answered with."""
        rec = active_recorder()
        if rec is None:
            return
        for (blob, offsets, params, _gen, _fd, _budgets), res in zip(
            batches, results
        ):
            n = len(offsets) - 1
            keys = [blob[offsets[i]: offsets[i + 1]] for i in range(n)]
            if res is None:
                allowed = np.zeros(n, np.uint8)
                status = np.full(n, STATUS_INTERNAL, np.uint8)
            else:
                allowed = res.allowed
                status = res.status
            rec.record_window(
                now_ns, keys, params.reshape(n, 4), allowed, status,
                source=SOURCE_NATIVE,
            )

    def _respond_one(
        self, blob, offsets, cookie_gen, cookie_fd, res, track_denied
    ):
        """Serialize one sub-batch's replies; returns (n_allowed,
        n_denied, n_errors, denied_keys) for the caller's aggregate
        (the keys only when `track_denied`)."""
        n = len(offsets) - 1
        results = np.zeros(5 * n, np.int64)
        if res is None:
            status = np.full(n, STATUS_INTERNAL, np.uint8)
        else:
            status = np.ascontiguousarray(res.status, np.uint8)
            out = results.reshape(n, 5)
            out[:, 0] = res.allowed
            out[:, 1] = res.limit
            out[:, 2] = res.remaining
            out[:, 3] = res.reset_after_s
            out[:, 4] = res.retry_after_s
        cookie_gen = np.ascontiguousarray(cookie_gen)
        cookie_fd = np.ascontiguousarray(cookie_fd)
        self._lib.ws_respond(
            self._h,
            n,
            cookie_gen.ctypes.data_as(ctypes.c_void_p),
            cookie_fd.ctypes.data_as(ctypes.c_void_p),
            results.ctypes.data_as(ctypes.c_void_p),
            status.ctypes.data_as(ctypes.c_void_p),
        )
        ok = status == 0
        allowed_mask = results.reshape(n, 5)[:, 0] != 0
        if track_denied:
            denied_keys = [
                blob[offsets[i]:offsets[i + 1]].decode("utf-8", "replace")
                for i in np.flatnonzero(~allowed_mask & ok)
            ]
        else:
            denied_keys = []
        return (
            int((allowed_mask & ok).sum()),
            int((~allowed_mask & ok).sum()),
            int((~ok).sum()),
            denied_keys,
        )

    def _push_metrics(self) -> None:
        """GET /metrics, GET /health and GET /stats are served from these
        snapshots (HTTP protocol; the wire layer answers all three
        without a Python round-trip — pushed once per second from the
        drive loop)."""
        if self.PROTOCOL != 1:
            return
        if self.metrics is not None:
            text = self.metrics.export_prometheus().encode()
            self._lib.ws_set_metrics(self._h, text, len(text))
        # "OK" while serving, else the supervisor's state name, or
        # "draining" after drain().
        state = "draining" if self._draining else supervisor_state(
            self.limiter)
        body = b"OK" if state == "ok" else state.encode()
        if self.checkpointer is not None:
            # The last checkpoint's age rides /health only when
            # durability is armed (the bare "OK" is a wire contract).
            body += b" " + self.checkpointer.health_suffix().encode()
        self._lib.ws_set_health(self._h, body, len(body))
        if self.insight is not None:
            # A cluster node folds its membership view into the snapshot
            # (the helper the python HTTP route uses too).
            stats = merge_cluster_stats(
                self.insight.stats_json(state=state), self.limiter
            ).encode()
            self._lib.ws_set_stats(self._h, stats, len(stats))

    def _maybe_sweep(self, now_ns: int, n_ops: int) -> None:
        """Policy state is shared with the asyncio engine — all policy
        interaction happens under limiter_lock (see engine._maybe_sweep)."""
        policy = self.cleanup_policy
        if policy is None:
            return
        n_hits = 0
        with self.limiter_lock:
            policy.record_ops(n_ops)
            # Did the throttled drain just hit the device?  Then the
            # pre-sweep force drain below would be a redundant second
            # blocking fetch (same lock hold, nothing launched between).
            fetched = getattr(
                self.limiter, "expired_hits_fetch_due", lambda t: False
            )(now_ns)
            n_hits += feed_expired_hits(policy, self.limiter, now_ns)
            live = len(self.limiter)
            capacity = getattr(self.limiter, "total_capacity", 1 << 62)
            if not policy.should_clean(now_ns, live, capacity):
                freed = None
            else:
                # Attribute on-device hits to the window this sweep
                # closes (see engine._maybe_sweep); this driver thread
                # already sweeps inline, so the blocking fetch is
                # acceptable here.
                if not fetched:
                    n_hits += feed_expired_hits(
                        policy, self.limiter, now_ns, force=True
                    )
                freed = self.limiter.sweep(now_ns)
                policy.after_sweep(now_ns, freed, live)
        if freed is not None and self.front is not None:
            # Swept buckets are gone even for a later regressed clock:
            # drop the deny-cache entries they backed.
            self.front.on_sweep(now_ns)
        if self.metrics is not None:
            if n_hits:
                self.metrics.record_expired_hits(n_hits)
            if freed is not None:
                self.metrics.record_sweep(freed)
