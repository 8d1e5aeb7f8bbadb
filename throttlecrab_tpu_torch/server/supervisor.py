"""Failure-domain supervision: retry, degrade, re-promote.

The port of `throttlecrab_tpu/server/supervisor.py`.  The serving
stack's single point of hardware failure is the device; without this
module a launch error fails the whole batch (the engine's launch
except-branch).  The reference's actor survives because it never leaves
the host; this is the device-side equivalent — a supervised launch path
with an explicit state machine:

    ok → retrying → degraded → recovering → ok

* **retrying** — a launch raised a *transient* (UNAVAILABLE-shaped)
  error; retry with bounded exponential backoff.  Deterministic errors
  (bad params, keymap capacity) are never retried — retrying cannot
  fix them and would triple the latency of every poisoned batch.
* **degraded** — transient retries exhausted: the device is declared
  down.  The bucket table is snapshotted host-side (tpu/snapshot.py
  ``export_state``: the ``row_gather`` kernel on a card) into a
  ``core/`` scalar-GCRA oracle over a
  MapStore — the CPU fallback the core layer exists to be — and every
  decision continues with bit-identical GCRA semantics at host
  throughput.  The front tier's deny cache stays valid: the oracle
  continues from the exact TATs the cache was certified against.
* **recovering** — a probe launch (reserved key, quantity-0 free
  probe, one decision-window launch) succeeded: host-mutated buckets
  are bulk-inserted back into the device table (snapshot
  ``_bulk_insert``: the ``row_scatter`` kernel on a card), the deny
  cache is
  invalidated through the existing ``on_restore`` hook (the restore
  rewrote bucket state), and the state returns to ok.  Keys untouched
  while degraded keep their device rows — the oracle was seeded from
  them, so nothing is lost or double-counted in either direction.

``SupervisedLimiter`` duck-types the limiter API the batching engine
and the native wire drivers consume, so wrapping the device limiter
once supervises every transport (they all share the same limiter and
``limiter_lock``; all supervised calls run inside that lock, which is
what serializes state transitions with decisions).

The classifier keys on the message markers the JAX package keys on, and
on nothing else.  A CUDA fault is sticky (the context is lost), so
retrying or probing the same process cannot bring the card back — yet
two real CUDA runtime messages do carry a marker ("CUDA-capable
device(s) is/are busy or unavailable", "MPS client failed to connect
..."). So when the wrapped table lives on a card, only an injected fault
(faults/injector.py ``InjectedDeviceError``, ``UNAVAILABLE``-shaped)
earns a retry or a degrade; any other error re-raises, as a
deterministic one does, and never reaches the host oracle.  Off the
card the JAX package's classification holds unchanged.
"""

from __future__ import annotations

import logging
import threading
from typing import Optional

import numpy as np

from ..core.store.mapstore import MapStore
from ..faults import InjectedDeviceError

log = logging.getLogger("throttlecrab.supervisor")

NS_PER_SEC = 1_000_000_000
I32_MAX = (1 << 31) - 1

STATE_OK = "ok"
STATE_RETRYING = "retrying"
STATE_DEGRADED = "degraded"
STATE_RECOVERING = "recovering"
#: /metrics gauge encoding of the state machine.
STATE_GAUGE = {
    STATE_OK: 0,
    STATE_RETRYING: 1,
    STATE_DEGRADED: 2,
    STATE_RECOVERING: 3,
}

#: The reserved key the recovery probe decides (quantity-0 free probe:
#: consumes nothing; one keymap slot is the total footprint).
PROBE_KEY = "__throttlecrab_supervisor_probe__"

TRANSIENT = "transient"
DETERMINISTIC = "deterministic"

#: Message fragments that mark a device/runtime error as transient —
#: the JAX package's list, unchanged (the strings its runtime and gRPC
#: put on a lost or flapping device).  Injected
#: faults (faults/injector.py) produce the same shapes on purpose, so
#: chaos tests exercise this exact classifier.
_TRANSIENT_MARKERS = (
    "UNAVAILABLE",
    "DEADLINE_EXCEEDED",
    "DEADLINE EXCEEDED",
    "ABORTED",
    "CONNECTION RESET",
    "SOCKET CLOSED",
    "FAILED TO CONNECT",
    "DEVICE OR RESOURCE BUSY",
)


def classify_exception(exc: BaseException) -> str:
    """TRANSIENT (retry may help) vs DETERMINISTIC (it cannot).

    Validation errors, keymap capacity exhaustion and other logic
    errors re-raise on every attempt; only infrastructure-shaped
    failures (lost device, reset socket, deadline) earn a retry.
    """
    if isinstance(exc, (ConnectionError, TimeoutError)):
        return TRANSIENT
    msg = str(exc).upper()
    if any(marker in msg for marker in _TRANSIENT_MARKERS):
        return TRANSIENT
    return DETERMINISTIC


def _on_card(limiter) -> bool:
    """Whether `limiter`'s bucket table lives on a CUDA device."""
    device = getattr(getattr(limiter, "table", None), "device", None)
    return getattr(device, "type", None) == "cuda"


def supervisor_of(limiter):
    """The SupervisedLimiter inside `limiter`'s wrapper chain, or None
    (walks ClusterLimiter.local)."""
    seen = 0
    while limiter is not None and seen < 4:
        if isinstance(limiter, SupervisedLimiter):
            return limiter
        limiter = getattr(limiter, "local", None)
        seen += 1
    return None


def supervisor_state(limiter) -> str:
    """The serving state for /health: "ok" when unsupervised."""
    sup = supervisor_of(limiter)
    return sup.state if sup is not None else STATE_OK


# ------------------------------------------------------------------ #
# Host oracle: the core/ scalar engine behind the batch API.


class _OracleStore(MapStore):
    """MapStore without an inline cleanup policy: the supervisor sweeps
    explicitly through the engine's cleanup path."""

    def _maybe_cleanup(self, now_ns: int) -> None:
        pass

    @property
    def data(self):
        return self._data


class HostOracle:
    """The ``core/`` scalar GCRA limiter shaped like the batch API.

    Decisions are bit-identical to the device kernel by construction —
    the scalar path *is* the repo's differential-test oracle.  Keys are
    normalized exactly like the device keymap (str→bytes when the
    keymap is bytes-keyed) so one client key stays one bucket across
    the degrade/re-promote boundary.
    """

    def __init__(self, bytes_keys: bool = False, insight=None) -> None:
        from ..core.rate_limiter import RateLimiter

        self.bytes_keys = bytes_keys
        #: Insight tier (L3.75): decided rows feed it so /stats totals
        #: stay truthful while the device accumulators are frozen.
        self.insight = insight
        self.store = _OracleStore()
        self._rl = RateLimiter(self.store)
        #: Keys whose buckets the host wrote (allowed decisions) — the
        #: exact set re-promotion must push back to the device.
        self.mutated: set = set()

    def _norm(self, key):
        if self.bytes_keys and isinstance(key, str):
            return key.encode()
        return key

    def seed(self, keys, tats, expiries) -> int:
        """Install exported device rows as the oracle's starting state."""
        data = self.store.data
        for key, tat, exp in zip(keys, tats, expiries):
            data[self._norm(key)] = (int(tat), int(exp))
        return len(keys)

    def export_mutated(self, now_ns: int):
        """(keys, tats, expiries) of live host-written buckets — what
        re-promotion bulk-inserts back into the device table."""
        keys, tats, exps = [], [], []
        data = self.store.data
        for key in self.mutated:
            entry = data.get(key)
            if entry is None:
                continue
            tat, exp = entry
            if exp is not None and exp <= now_ns:
                continue  # TTL lapsed while degraded: nothing to restore
            keys.append(key)
            tats.append(int(tat))
            exps.append(int(exp))
        return keys, tats, exps

    def rate_limit_batch(
        self, keys, max_burst, count_per_period, period, quantity,
        now_ns: int, wire: bool = False, collect_cur: bool = False,
    ):
        """One shared-timestamp batch through the scalar engine, row by
        row in arrival order (the actor semantics the kernel reproduces
        with segment ranks)."""
        from ..core.errors import (
            InternalError,
            InvalidRateLimit,
            NegativeQuantity,
        )
        from ..tpu.limiter import (
            STATUS_INTERNAL,
            STATUS_INVALID_PARAMS,
            STATUS_NEGATIVE_QUANTITY,
            BatchResult,
            WireBatchResult,
        )

        n = len(keys)
        mb = np.broadcast_to(np.asarray(max_burst, np.int64), (n,))
        cp = np.broadcast_to(np.asarray(count_per_period, np.int64), (n,))
        pd = np.broadcast_to(np.asarray(period, np.int64), (n,))
        qt = np.broadcast_to(np.asarray(quantity, np.int64), (n,))

        allowed = np.zeros(n, bool)
        limit = np.zeros(n, np.int64)
        remaining = np.zeros(n, np.int64)
        reset_ns = np.zeros(n, np.int64)
        retry_ns = np.zeros(n, np.int64)
        status = np.zeros(n, np.uint8)
        for i in range(n):
            key = self._norm(keys[i])
            try:
                ok, res = self._rl.rate_limit(
                    key, int(mb[i]), int(cp[i]), int(pd[i]), int(qt[i]),
                    now_ns,
                )
            except NegativeQuantity:
                status[i] = STATUS_NEGATIVE_QUANTITY
                continue
            except InvalidRateLimit:
                status[i] = STATUS_INVALID_PARAMS
                continue
            except InternalError:
                status[i] = STATUS_INTERNAL
                continue
            allowed[i] = ok
            limit[i] = res.limit
            remaining[i] = res.remaining
            reset_ns[i] = res.reset_after_ns
            retry_ns[i] = res.retry_after_ns
            if ok:
                self.mutated.add(key)

        if self.insight is not None:
            # Degraded-mode accounting: the host path reports its OK rows
            # so /stats stays truthful while the device is down.
            ok_rows = np.flatnonzero(status == 0)
            self.insight.record_host_rows(
                [self._norm(keys[int(i)]) for i in ok_rows],
                allowed[ok_rows].tolist(),
            )

        if wire:
            # The wire truncation every transport emits (seconds,
            # i32-clamped) — identical to the cluster forwarder's
            # host-side conversion and the compact kernel output.
            return WireBatchResult(
                allowed=allowed,
                limit=limit,
                remaining=np.minimum(remaining, I32_MAX),
                reset_after_s=np.minimum(reset_ns // NS_PER_SEC, I32_MAX),
                retry_after_s=np.minimum(retry_ns // NS_PER_SEC, I32_MAX),
                status=status,
            )
        return BatchResult(
            allowed=allowed,
            limit=limit,
            remaining=remaining,
            reset_after_ns=reset_ns,
            retry_after_ns=retry_ns,
            status=status,
        )

    def rate_limit_many(
        self, batches, wire: bool = False, collect_cur: bool = False
    ) -> list:
        return [
            self.rate_limit_batch(*batch, wire=wire) for batch in batches
        ]

    def sweep(self, now_ns: int) -> int:
        return self.store._sweep(now_ns)

    def __len__(self) -> int:
        return len(self.store)


# ------------------------------------------------------------------ #


class SupervisedLimiter:
    """The device limiter behind the failure-domain state machine.

    Duck-types the limiter API (rate_limit_batch / rate_limit_many /
    dispatch_many / dispatch_wire_window / sweep / __len__ — each of
    the optional methods offered only when the wrapped limiter offers
    it); everything else delegates to the wrapped limiter.  All decide
    paths must run under the caller's ``limiter_lock`` — the same
    contract the unwrapped limiter already has — which is what makes
    state transitions atomic with respect to decisions.
    """

    def __init__(
        self,
        inner,
        retries: int = 3,
        backoff_us: int = 2000,
        backoff_max_us: int = 50_000,
        probe_interval_ms: int = 1000,
        mode: str = "degrade",
        metrics=None,
        front=None,
        insight=None,
        sleep_fn=None,
    ) -> None:
        import inspect
        import time

        self.insight = insight
        self.inner = inner
        self.retries = max(int(retries), 0)
        self.backoff_s = max(backoff_us, 0) / 1e6
        self.backoff_max_s = max(backoff_max_us, backoff_us, 0) / 1e6
        self.probe_interval_ns = max(probe_interval_ms, 1) * 1_000_000
        self.mode = mode  # "degrade" | "fail"
        self.metrics = metrics
        self.front = front
        self._sleep = sleep_fn or time.sleep
        self._on_card = _on_card(inner)
        self._mu = threading.Lock()  # supervisor state (health reads race)
        self._state = STATE_OK
        self._oracle: Optional[HostOracle] = None
        self._last_probe_ns = 0
        # Diagnostics, mirrored into /metrics by the server.
        self.retry_count = 0
        self.degrade_count = 0
        self.repromote_count = 0
        #: Capacity-change hooks (the JAX server wires these to the
        #: cluster tier's schedule_reweight; the port has no cluster
        #: tier yet, so its server sets neither): a node whose device
        #: died serves from the host oracle at a fraction of device
        #: throughput, so it announces a reduced ring weight and its
        #: neighbours absorb the difference; re-promotion restores it.
        #: Called UNDER the limiter lock, so hooks must only schedule
        #: work (never take cluster locks inline).
        self.on_degrade = None
        self.on_repromote = None

        def params_of(fn):
            try:
                return inspect.signature(fn).parameters
            except (TypeError, ValueError):
                return {}

        self._batch_kw = {
            p
            for p in ("wire", "collect_cur")
            if p in params_of(inner.rate_limit_batch)
        }
        # Offer each optional API only when the wrapped limiter offers
        # it — the engine and the native drivers feature-detect with
        # hasattr, and advertising an API the inner can't back would
        # silently change which path they pick.
        if hasattr(inner, "rate_limit_many"):
            self._many_kw = {
                p
                for p in ("wire", "collect_cur")
                if p in params_of(inner.rate_limit_many)
            }
            self.rate_limit_many = self._rate_limit_many
        if hasattr(inner, "dispatch_many"):
            self._dispatch_kw = {
                p
                for p in ("wire", "collect_cur")
                if p in params_of(inner.dispatch_many)
            }
            self.dispatch_many = self._dispatch_many
        if hasattr(inner, "dispatch_wire_window"):
            self._wire_window_kw = {
                p
                for p in ("collect_cur",)
                if p in params_of(inner.dispatch_wire_window)
            }
            self.dispatch_wire_window = self._dispatch_wire_window
        if hasattr(inner, "expired_hits_fetch_due"):
            self.expired_hits_fetch_due = self._expired_hits_fetch_due
        if hasattr(inner, "take_expired_hits"):
            self.take_expired_hits = self._take_expired_hits

    # -- state ---------------------------------------------------------- #

    @property
    def state(self) -> str:
        return self._state

    @property
    def degraded(self) -> bool:
        return self._state in (STATE_DEGRADED, STATE_RECOVERING)

    def _set_state(self, state: str) -> None:
        with self._mu:
            self._state = state

    def _cas_state(self, expect, state: str) -> None:
        """Transition only from `expect` (tuple of states): the lock-free
        fetch path runs concurrently with dispatch-side transitions, and
        an unconditional write could undo a concurrent degrade (flipping
        DEGRADED back to OK would orphan the oracle and its mutations)."""
        with self._mu:
            if self._state in expect:
                self._state = state

    def export_degraded_state(self):
        """(keys, tats, expiries) of the host oracle while degraded,
        else None — snapshot.export_state consults this so a shutdown
        snapshot taken mid-outage captures the freshest state."""
        oracle = self._oracle
        if not self.degraded or oracle is None:
            return None
        data = oracle.store.data
        keys = list(data.keys())
        tats = [data[k][0] for k in keys]
        exps = [
            data[k][1] if data[k][1] is not None else (1 << 62)
            for k in keys
        ]
        return keys, tats, exps

    def __getattr__(self, name):
        # Everything not supervised (keymap, table, total_capacity,
        # keymaps, ...) belongs to the wrapped limiter.
        return getattr(self.inner, name)

    def __len__(self) -> int:
        if self.degraded and self._oracle is not None:
            return len(self._oracle)
        return len(self.inner)

    # -- supervised call core ------------------------------------------- #

    def _transient(self, exc) -> bool:
        """Whether a retry, and after it the degrade, may help: the JAX
        classification, except that on a card only an injected fault
        qualifies (a real CUDA error is sticky; see the module doc)."""
        if classify_exception(exc) != TRANSIENT:
            return False
        return not self._on_card or isinstance(exc, InjectedDeviceError)

    def _note_retry(self, exc, attempt) -> None:
        self.retry_count += 1
        if self.metrics is not None:
            self.metrics.record_supervisor_retry()
        log.warning(
            "transient device fault (attempt %d/%d): %s",
            attempt + 1, self.retries + 1, exc,
        )

    def _supervised(self, device_fn, host_fn, now_ns):
        """Run a device operation under the state machine.

        ok/retrying: try the device, retrying transient faults with
        bounded exponential backoff; exhaustion degrades (mode
        "degrade") or re-raises (mode "fail").  degraded: serve from
        the host oracle, probing the device on the configured cadence
        (driven by the caller's now_ns, so virtual-time tests control
        it).  Deterministic errors always raise — they are the
        request's fault, not the device's.
        """
        if self.degraded:
            if self._probe_due(now_ns):
                self._try_recover(now_ns)
            if self.degraded:
                return host_fn()
            # fall through: recovered, decide on the device
        delay = self.backoff_s
        last_exc = None
        for attempt in range(self.retries + 1):
            try:
                out = device_fn()
                self._cas_state((STATE_RETRYING,), STATE_OK)
                return out
            except Exception as exc:
                if not self._transient(exc):
                    raise
                last_exc = exc
                self._cas_state((STATE_OK, STATE_RETRYING), STATE_RETRYING)
                self._note_retry(exc, attempt)
                if attempt < self.retries:
                    if delay > 0:
                        self._sleep(delay)
                    delay = min(delay * 2, self.backoff_max_s)
        # Transient retries exhausted: the device is down.
        if self.mode != "degrade":
            raise last_exc
        self._degrade(now_ns, last_exc)
        if host_fn is None:
            # dispatch_wire_window has no direct host form — the caller
            # sees the degraded state and takes its documented fallback.
            return None
        return host_fn()

    def _degrade(self, now_ns: int, exc) -> None:
        from ..tpu.limiter import limiter_uses_bytes_keys
        from ..tpu.snapshot import export_state

        log.error(
            "device failure persists after %d retries; degrading to "
            "the host scalar oracle: %s", self.retries + 1, exc,
        )
        oracle = HostOracle(
            bytes_keys=limiter_uses_bytes_keys(self.inner),
            insight=self.insight,
        )
        try:
            keys, _slots, _shard, tats, exps, _cap, _d = export_state(
                self.inner
            )
            n = oracle.seed(keys, tats, exps)
            log.info("host oracle seeded with %d live buckets", n)
        except Exception:
            # The same dead device that forced the degrade can refuse
            # the table fetch: soft state — start empty rather than
            # shed traffic (snapshot.py's stale-snapshot contract).
            log.exception(
                "host-side table snapshot failed; host oracle starts "
                "empty (soft state)"
            )
        self._oracle = oracle
        self._last_probe_ns = now_ns
        self.degrade_count += 1
        if self.metrics is not None:
            self.metrics.record_supervisor_degrade()
        self._set_state(STATE_DEGRADED)
        # (The JAX package stamps the flight recorder here; the port has
        # no recorder yet.)
        if self.on_degrade is not None:
            try:
                self.on_degrade()
            except Exception:
                log.exception("on_degrade hook failed")

    def _probe_due(self, now_ns: int) -> bool:
        return now_ns - self._last_probe_ns >= self.probe_interval_ns

    def _try_recover(self, now_ns: int) -> bool:
        """Probe the device; on success re-promote the host state."""
        self._set_state(STATE_RECOVERING)
        self._last_probe_ns = now_ns
        try:
            kw = {"wire": True} if "wire" in self._batch_kw else {}
            self.inner.rate_limit_batch(
                [PROBE_KEY], 1, 1, 1, 0, now_ns, **kw
            )
        except Exception as exc:
            log.info("device probe failed; staying degraded: %s", exc)
            self._set_state(STATE_DEGRADED)
            return False
        try:
            from ..tpu.snapshot import _bulk_insert

            keys, tats, exps = self._oracle.export_mutated(now_ns)
            if keys:
                _bulk_insert(self.inner, keys, tats, exps)
            if self.front is not None:
                # The bulk insert rewrote bucket state out from under
                # any cached denials.
                self.front.on_restore()
        except Exception:
            # Retry the whole promotion at the next probe: the mutated
            # set keeps accumulating, and re-inserting a key twice
            # writes the same (or newer) state — idempotent.
            log.exception("re-promotion failed; staying degraded")
            self._set_state(STATE_DEGRADED)
            return False
        log.info(
            "device recovered; re-promoted %d host-mutated buckets",
            len(keys),
        )
        self._oracle = None
        self.repromote_count += 1
        if self.metrics is not None:
            self.metrics.record_supervisor_repromote()
        self._set_state(STATE_OK)
        if self.on_repromote is not None:
            try:
                self.on_repromote()
            except Exception:
                log.exception("on_repromote hook failed")
        return True

    # -- the limiter API ------------------------------------------------ #

    def _kw(self, allowed, wire, collect_cur):
        kw = {}
        if "wire" in allowed:
            kw["wire"] = wire
        if "collect_cur" in allowed:
            kw["collect_cur"] = collect_cur
        return kw

    def rate_limit_batch(
        self, keys, max_burst, count_per_period, period, quantity,
        now_ns: int, wire: bool = False, collect_cur: bool = False,
    ):
        kw = self._kw(self._batch_kw, wire, collect_cur)
        return self._supervised(
            lambda: self.inner.rate_limit_batch(
                keys, max_burst, count_per_period, period, quantity,
                now_ns, **kw,
            ),
            lambda: self._oracle.rate_limit_batch(
                keys, max_burst, count_per_period, period, quantity,
                now_ns, wire=wire,
            ),
            now_ns,
        )

    def _rate_limit_many(
        self, batches, wire: bool = False, collect_cur: bool = False
    ) -> list:
        if not batches:
            return []
        kw = self._kw(self._many_kw, wire, collect_cur)
        now_ns = batches[-1][5]
        return self._supervised(
            lambda: self.inner.rate_limit_many(batches, **kw),
            lambda: self._oracle.rate_limit_many(batches, wire=wire),
            now_ns,
        )

    def _dispatch_many(
        self, batches, wire: bool = False, collect_cur: bool = False
    ):
        from ..tpu.limiter import _ReadyLaunch

        if not batches:
            return _ReadyLaunch([])
        kw = self._kw(self._dispatch_kw, wire, collect_cur)
        now_ns = batches[-1][5]
        out = self._supervised(
            lambda: self.inner.dispatch_many(batches, **kw),
            lambda: _ReadyLaunch(
                self._oracle.rate_limit_many(batches, wire=wire)
            ),
            now_ns,
        )
        if isinstance(out, _ReadyLaunch):
            return out
        return _SupervisedHandle(self, out)

    def _dispatch_wire_window(
        self, frames, now_ns: int, collect_cur: bool = False
    ):
        # Degraded (and degrade-on-exhaustion): return None — the
        # native driver's documented fallback re-decides the window
        # through rate_limit_many/rate_limit_batch on THIS wrapper,
        # which routes it to the host oracle.  Preparation is
        # idempotent, so the re-decide is safe (the device never
        # committed anything).
        if self.degraded:
            if self._probe_due(now_ns):
                self._try_recover(now_ns)
            if self.degraded:
                return None
        kw = (
            {"collect_cur": collect_cur}
            if "collect_cur" in self._wire_window_kw
            else {}
        )
        try:
            out = self._supervised(
                lambda: self.inner.dispatch_wire_window(
                    frames, now_ns, **kw
                ),
                None,
                now_ns,
            )
        except Exception:
            if not self.degraded:
                raise
            return None  # just degraded: fall back to the host path
        if out is None or self.degraded:
            # None also covers the inner dispatcher's own fallbacks
            # (python keymap, mid-batch param change, full table).
            return None
        return _SupervisedHandle(self, out)

    def supervised_fetch(self, fetch_fn):
        """Retry a deferred fetch through the same classifier.

        Decisions are committed on-device before any fetch, and a
        fetch is a read — retrying it can never double-count, so
        transient fetch faults are absorbed exactly like launch
        faults.  Exhaustion re-raises: the window's futures fail (the
        results are unreadable), and the *next launch* drives the
        degrade decision under the limiter lock, where the state
        machine is allowed to transition.
        """
        delay = self.backoff_s
        for attempt in range(self.retries + 1):
            try:
                out = fetch_fn()
                # CAS: this thread holds no limiter_lock, and a plain
                # write could undo a dispatch thread's concurrent
                # transition into DEGRADED.
                self._cas_state((STATE_RETRYING,), STATE_OK)
                return out
            except Exception as exc:
                if not self._transient(exc):
                    raise
                self._cas_state((STATE_OK, STATE_RETRYING), STATE_RETRYING)
                self._note_retry(exc, attempt)
                if attempt >= self.retries:
                    raise
                if delay > 0:
                    self._sleep(delay)
                delay = min(delay * 2, self.backoff_max_s)

    def sweep(self, now_ns: int) -> int:
        if self.degraded and self._oracle is not None:
            return self._oracle.sweep(now_ns)
        return self.inner.sweep(now_ns)

    def _expired_hits_fetch_due(self, now_ns: int, *a, **kw) -> bool:
        if self.degraded:
            return False  # no device to fetch from
        return self.inner.expired_hits_fetch_due(now_ns, *a, **kw)

    def _take_expired_hits(self, now_ns: int, *a, **kw) -> int:
        if self.degraded:
            return 0
        return self.inner.take_expired_hits(now_ns, *a, **kw)


class _SupervisedHandle:
    """Wraps a dispatch handle so deferred fetches ride the classifier."""

    def __init__(self, supervisor: SupervisedLimiter, handle) -> None:
        self._sup = supervisor
        self._handle = handle

    def fetch(self):
        return self._sup.supervised_fetch(self._handle.fetch)
