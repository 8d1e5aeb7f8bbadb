"""Exact negative-decision cache: GCRA denials answered without the engine.

GCRA makes an *exact* deny cache possible where generic response caching
cannot be: a denial does not mutate the bucket, so once a key is denied
for `(params, quantity)` at stored TAT `S`, every identical request is
provably denied — with closed-form decayed `remaining`/`reset`/`retry`
fields — until the earliest of

  * ``allow_at = S + inc - tol``   (the deny window ends),
  * ``S + tol``                    (the request's own clamp horizon:
                                    past it the oracle clamps the stored
                                    TAT and the closed form changes),
  * the bucket's true expiry       (past it the engine sees an absent
                                    key and first-touch semantics apply),
  * any *allowed* decision for the key (the one thing that writes).

Everything here is plain Python integers; the oracle is
`core/rate_limiter.py` and every served field reproduces its math (and
therefore the kernel's, which is validated against it) bit for bit:

    tat_eff   = S                      (unclamped inside the window)
    remaining = max((now + tol - S) // em, 0)
    reset     = S + tol - now
    retry     = S + inc - tol - now

Exactness discipline — an entry is created only when ALL of:

  * the key's **last allowed write was observed with its exact new TAT**
    (the limiter's compact="cur" tier exposes it host-side for free, and
    the full-ns result planes recover it from `reset_after_ns`); the
    denial's observed TAT must equal it.  This rules out foreign state
    (snapshot restores, writes that predate the front tier) and the
    stored-vs-first-touch ambiguity;
  * the writing request's tolerance is known, so the bucket's *true*
    expiry `tat + tol_write` is known — a later denial under different
    params must not outlive the writer's TTL;
  * every quantity involved sits far below i64 saturation (< 2^61), so
    the reference's saturating arithmetic degenerates to plain ints.

Anything that fails a check simply misses to the engine: the cache can
only ever be *conservative*, never wrong.

Concurrency: one lock guards all state (the asyncio engine's event loop,
its executor threads, and the native wire driver all touch the cache).
Observations are ordered by a dispatch-time sequence number so a slow
fetch on one transport can never overwrite a newer write record from
another with stale state.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass

NS_PER_SEC = 1_000_000_000

# All cached quantities must sit far below i64 saturation so the
# reference's sat_add/sat_sub/wrap_u64 pipeline reduces to plain int
# math.  2^61 ns is ~73 years — nothing a real rate limit reaches.
_BOUND = 1 << 61
_I32_MAX = (1 << 31) - 1


@dataclass(frozen=True)
class DenyHit:
    """A cache-served denial, in exact nanoseconds (transports truncate
    to whole seconds exactly like `ThrottleResponse.from_ns`)."""

    limit: int
    remaining: int
    reset_after_ns: int
    retry_after_ns: int

    @property
    def reset_after_s(self) -> int:
        return self.reset_after_ns // NS_PER_SEC

    @property
    def retry_after_s(self) -> int:
        return self.retry_after_ns // NS_PER_SEC


class _Entry:
    __slots__ = ("tat", "emission", "tolerance", "increment", "limit",
                 "expiry")

    def __init__(self, tat, emission, tolerance, increment, limit, expiry):
        self.tat = tat
        self.emission = emission
        self.tolerance = tolerance
        self.increment = increment
        self.limit = limit
        self.expiry = expiry  # the bucket's true expiry (writer's TTL)


# A key's last observed allowed write is a plain (tat, tol, seq) tuple:
# exact new TAT + the writer's tolerance (=> true expiry), guarded by
# dispatch order.  A tuple, not a class — one record is allocated per
# engine-decided allowed row, on the serving path.
_REC_TAT, _REC_TOL, _REC_SEQ = 0, 1, 2


def _derive_scalar(max_burst: int, count_per_period: int, period: int):
    """(emission_ns, tolerance_ns) via the limiter's exact pipeline, or
    None for invalid params — scalar wrapper over tpu.limiter
    derive_params so cached math can never drift from the kernel's."""
    from ..tpu.limiter import derive_params

    emission, tolerance, invalid = derive_params(
        [max_burst], [count_per_period], [period]
    )
    if bool(invalid[0]):
        return None
    return int(emission[0]), int(tolerance[0])


def _column(col):
    """Normalize one bulk-lookup param column to a plain-int sequence.
    numpy arrays convert wholesale (C-level, plain ints out); anything
    else passes through — stray np.int64 elements in a list still hash
    and compare equal to the int-keyed entries, just slower."""
    tolist = getattr(col, "tolist", None)
    return tolist() if tolist is not None else col


# Serving traffic reuses a handful of parameter triples across millions
# of requests; the numpy round trip per observe() would dominate the
# cache's own cost.  Bound the memo so hostile param churn cannot grow
# it without limit.
_MEMO_CAP = 4096


class DenyCache:
    """Bounded O(1) map from (key, params, quantity) to an exact deny
    window, plus the per-key last-write records that certify entries."""

    def __init__(self, capacity: int = 65536) -> None:
        if capacity <= 0:
            raise ValueError("deny cache capacity must be positive")
        self.capacity = capacity
        self._lock = threading.Lock()
        # (key, (mb, cpp, period, q)) -> _Entry, insertion-ordered for
        # O(1) FIFO eviction at capacity.
        self._entries: dict = {}
        # key -> set of param tuples with live entries (O(1) invalidation).
        self._by_key: dict = {}
        # key -> (tat, tol, seq) write record (bounded to `capacity`
        # keys, FIFO-ish eviction).
        self._records: dict = {}
        # key -> in-flight engine request count: while any same-key
        # request is being decided, lookups must miss (the in-flight
        # request may be allowed and mutate the bucket under us).
        self._inflight: dict = {}
        self._seq = 0
        # (mb, cpp, period) -> (emission, tolerance) | None, memoized.
        self._param_memo: dict = {}
        # Raw counters; the FrontTier facade mirrors them into Metrics.
        self.hits = 0
        self.stale_evictions = 0

    def _derive(self, mb, cpp, period):
        """Memoized _derive_scalar (callers hold self._lock)."""
        k = (mb, cpp, period)
        try:
            return self._param_memo[k]
        except KeyError:
            pass
        if len(self._param_memo) >= _MEMO_CAP:
            self._param_memo.clear()
        d = self._param_memo[k] = _derive_scalar(mb, cpp, period)
        return d

    # ------------------------------------------------------------------ #

    def __len__(self) -> int:
        return len(self._entries)

    def next_seq(self) -> int:
        """Dispatch-order stamp: call once per launch window, *before*
        dispatch, and pass to observe() so late-arriving results from a
        concurrent transport can't roll a write record backwards."""
        with self._lock:
            self._seq += 1
            return self._seq

    def begin_inflight(self, key) -> None:
        with self._lock:
            self._inflight[key] = self._inflight.get(key, 0) + 1

    def end_inflight(self, key) -> None:
        with self._lock:
            n = self._inflight.get(key, 0) - 1
            if n <= 0:
                self._inflight.pop(key, None)
            else:
                self._inflight[key] = n

    # ------------------------------------------------------------------ #

    def lookup(self, key, max_burst, count_per_period, period, quantity,
               now_ns):
        """Serve an exact denial, or None (engine decides).

        Misses when no entry, when any same-key request is in flight, or
        when `now_ns` has left the proven window (stale entries evict)."""
        if now_ns < 0:
            # Pre-epoch clocks take the oracle's normalize_now_ns
            # wall-clock fallback — not reproducible here; let the
            # engine decide.
            return None
        k = (key, (int(max_burst), int(count_per_period), int(period),
                   int(quantity)))
        with self._lock:
            e = self._entries.get(k)
            if e is None:
                return None
            if key in self._inflight:
                return None
            allow_at = e.tat + e.increment - e.tolerance
            horizon = min(allow_at, e.tat + e.tolerance, e.expiry)
            if now_ns >= horizon:
                self._evict(k)
                self.stale_evictions += 1
                return None
            room = now_ns + e.tolerance - e.tat
            remaining = room // e.emission if room >= 0 else 0
            self.hits += 1
            return DenyHit(
                limit=e.limit,
                remaining=remaining,
                reset_after_ns=e.tat + e.tolerance - now_ns,
                retry_after_ns=allow_at - now_ns,
            )

    def lookup_window(self, keys, max_burst, count_per_period, period,
                      quantity, now_ns, mark_inflight: bool = True):
        """Bulk lookup for one serving window (shared timestamp): one
        lock acquisition and one exact-denial computation per *distinct*
        (key, params, q) combo — under abuse traffic a window repeats a
        handful of combos thousands of times, so the common row costs a
        single dict probe instead of the full per-call path.

        The window memo is exact BECAUSE the timestamp is shared: a
        served denial is identical for every repeat (denials don't
        mutate), and once a combo misses, its repeats must keep missing
        (the miss row is about to reach the engine and may mutate the
        bucket) — the memo's miss sentinel is the in-window equivalent
        of the in-flight guard.

        `max_burst`/`count_per_period`/`period`/`quantity` are per-row
        sequences; `keys` is a sequence of normalized keys.  Returns
        (rows, n_hits) where rows[i] is None for engine-bound rows or a
        (limit, remaining, reset_after_ns, retry_after_ns) tuple.  With
        `mark_inflight` (the serving default), every missing key is
        marked in-flight before returning — callers MUST release each
        one (observe_window/end_inflight) after the engine decides."""
        n = len(keys)
        out = [None] * n
        if now_ns < 0:
            if mark_inflight:
                for key in keys:
                    self.begin_inflight(key)
            return out, 0
        _MISS = False  # sentinel distinct from any hit tuple
        memo: dict = {}
        memo_get = memo.get
        entries_get = self._entries.get
        inflight = self._inflight
        n_hits = 0
        stale = 0
        # Normalize the param columns ONCE: numpy's C-level tolist()
        # yields plain ints (~12 ns/element), where per-row indexing +
        # int() in the loop costs ~an order of magnitude more — at 90 %
        # hit rates this loop IS the serving path's cost.
        mb_c = _column(max_burst)
        cpp_c = _column(count_per_period)
        per_c = _column(period)
        q_c = _column(quantity)
        # Serving windows routinely share ONE param config across every
        # row (per-route limits); verifying that is one C-level count()
        # pass per column (~15 ns/element), and it collapses the hot
        # loop to a bare key-string dict probe — no per-row tuple
        # allocation at all.  A non-uniform window (the wire protocol
        # allows per-request params) takes the general per-row path.
        uniform = False
        if n > 32:
            try:
                uniform = (
                    mb_c.count(mb_c[0]) == n
                    and cpp_c.count(cpp_c[0]) == n
                    and per_c.count(per_c[0]) == n
                    and q_c.count(q_c[0]) == n
                )
            except (AttributeError, TypeError):
                uniform = False
        inflight_get = inflight.get
        with self._lock:
            if uniform:
                pq = (mb_c[0], cpp_c[0], per_c[0], q_c[0])
                for i, key in enumerate(keys):
                    r = memo_get(key)
                    if r is None:
                        kt = (key, pq)
                        e = entries_get(kt)
                        r = _MISS
                        if e is not None and key not in inflight:
                            tat = e.tat
                            tol = e.tolerance
                            allow_at = tat + e.increment - tol
                            horizon = min(allow_at, tat + tol, e.expiry)
                            if now_ns >= horizon:
                                self._evict(kt)
                                stale += 1
                            else:
                                room = now_ns + tol - tat
                                r = (
                                    e.limit,
                                    room // e.emission if room >= 0 else 0,
                                    tat + tol - now_ns,
                                    allow_at - now_ns,
                                )
                        memo[key] = r
                        if r is _MISS and mark_inflight:
                            inflight[key] = inflight_get(key, 0) + 1
                    elif r is _MISS and mark_inflight:
                        inflight[key] = inflight_get(key, 0) + 1
                    if r is not _MISS:
                        out[i] = r
                        n_hits += 1
                self.hits += n_hits
                self.stale_evictions += stale
                return out, n_hits
            for i, (key, mb, cpp, per, q) in enumerate(
                zip(keys, mb_c, cpp_c, per_c, q_c)
            ):
                kt = (key, (mb, cpp, per, q))
                r = memo_get(kt)
                if r is None:
                    e = entries_get(kt)
                    r = _MISS
                    if e is not None and key not in inflight:
                        tat = e.tat
                        tol = e.tolerance
                        allow_at = tat + e.increment - tol
                        horizon = min(allow_at, tat + tol, e.expiry)
                        if now_ns >= horizon:
                            self._evict(kt)
                            stale += 1
                        else:
                            room = now_ns + tol - tat
                            r = (
                                e.limit,
                                room // e.emission if room >= 0 else 0,
                                tat + tol - now_ns,
                                allow_at - now_ns,
                            )
                    memo[kt] = r
                    if r is _MISS and mark_inflight:
                        inflight[key] = inflight_get(key, 0) + 1
                elif r is _MISS and mark_inflight:
                    inflight[key] = inflight_get(key, 0) + 1
                if r is not _MISS:
                    out[i] = r
                    n_hits += 1
            self.hits += n_hits
            self.stale_evictions += stale
        return out, n_hits

    # ------------------------------------------------------------------ #

    def observe_window(self, rows, now_ns, seq) -> None:
        """Bulk observe for one decided window: one lock acquisition for
        all rows, releasing each row's in-flight hold (the bulk twin of
        observe + end_inflight).  `rows` is an iterable of (key,
        max_burst, count_per_period, period, quantity, allowed, cur_ns)
        tuples in arrival order; cur_ns may be None (allowed rows then
        invalidate without certifying; denied rows are skipped)."""
        now_ns = int(now_ns)
        inflight = self._inflight
        inflight_get = inflight.get
        inflight_pop = inflight.pop
        records = self._records
        records_get = records.get
        records_pop = records.pop
        by_key_pop = self._by_key.pop
        entries_pop = self._entries.pop
        derive = self._derive
        now_ok = 0 <= now_ns < _BOUND
        cap = self.capacity
        # Rows should carry plain Python ints (callers .tolist() their
        # result planes); stray numpy scalars still hash/compare equal,
        # just slower.  The allowed branch is _observe_allowed inlined:
        # under abuse traffic the engine's miss stream is dominated by
        # allowed cold-tail rows, so this loop body IS the observe
        # path's cost.
        with self._lock:
            for key, mb, cpp, period, q, allowed, cur_ns in rows:
                if allowed:
                    # The one mutating outcome: cached denials die.
                    s = by_key_pop(key, None)
                    if s is not None:
                        for pq in s:
                            entries_pop((key, pq), None)
                    rec = records_get(key)
                    if rec is not None and seq < rec[_REC_SEQ]:
                        pass  # stale cross-transport observation
                    elif q < 1 or cur_ns is None or not now_ok:
                        # Unquantified / uncertified write: poison.
                        records_pop(key, None)
                    else:
                        derived = derive(mb, cpp, period)
                        if derived is not None:
                            em, tol = derived
                            if (
                                0 < em < _BOUND
                                and 0 <= tol < _BOUND
                                and 0 <= cur_ns < _BOUND
                            ):
                                # Pop-then-reinsert: a refreshed key
                                # moves to the dict's end so FIFO
                                # eviction tracks last-write age, not
                                # first-insertion — hot keys must not
                                # be the first evicted.
                                records_pop(key, None)
                                records[key] = (cur_ns, tol, seq)
                                if len(records) > cap:
                                    records_pop(next(iter(records)))
                            else:
                                records_pop(key, None)
                elif cur_ns is not None:
                    self._observe_denied(
                        key, int(mb), int(cpp), int(period), int(q),
                        now_ns, seq, cur_ns, None, None,
                    )
                m = inflight_get(key, 0) - 1
                if m <= 0:
                    inflight_pop(key, None)
                else:
                    inflight[key] = m

    def release_window(self, keys) -> None:
        """Release in-flight holds for rows that never reached a launch
        (shed rows): the bulk twin of end_inflight.  For rows whose
        launch may have COMMITTED before the failure, use fail_window —
        a plain release would leave entries/records that an unobserved
        write has invalidated."""
        inflight = self._inflight
        with self._lock:
            for key in keys:
                m = inflight.get(key, 0) - 1
                if m <= 0:
                    inflight.pop(key, None)
                else:
                    inflight[key] = m

    def fail_window(self, keys) -> None:
        """A launch failed after its writes may have committed (e.g. a
        post-launch fetch error): release each row's in-flight hold AND
        conservatively drop the key's cached denials and write record —
        an unobserved allow may have moved the TAT, so neither can
        certify exactness any longer."""
        inflight = self._inflight
        records_pop = self._records.pop
        with self._lock:
            for key in keys:
                m = inflight.get(key, 0) - 1
                if m <= 0:
                    inflight.pop(key, None)
                else:
                    inflight[key] = m
                self._invalidate_key(key)
                records_pop(key, None)

    # ------------------------------------------------------------------ #

    def observe(self, key, max_burst, count_per_period, period, quantity,
                now_ns, allowed, seq, cur_ns=None, reset_after_ns=None,
                retry_after_ns=None) -> None:
        """Feed one engine-decided OK result, in arrival order.

        `cur_ns` is the request's exact observed TAT when the launch
        used the compact="cur" tier (new TAT for allowed rows, effective
        TAT for denied rows); full-ns results recover the same values
        from `reset_after_ns`/`retry_after_ns` instead.  Rows offering
        neither still invalidate on allowed — they just can't certify."""
        q = int(quantity)
        now_ns = int(now_ns)
        mb = int(max_burst)
        cpp = int(count_per_period)
        period = int(period)
        with self._lock:
            if allowed:
                self._observe_allowed(
                    key, mb, cpp, period, q, now_ns, seq, cur_ns,
                    reset_after_ns,
                )
            else:
                self._observe_denied(
                    key, mb, cpp, period, q, now_ns, seq, cur_ns,
                    reset_after_ns, retry_after_ns,
                )

    def _observe_allowed(self, key, mb, cpp, period, q, now_ns, seq,
                         cur_ns, reset_after_ns):
        # The one mutating outcome: every cached denial for the key dies.
        self._invalidate_key(key)
        rec = self._records.get(key)
        if rec is not None and seq < rec[_REC_SEQ]:
            return  # stale cross-transport observation; record is newer
        if q < 1:
            # A quantity-0 probe may or may not refresh the TTL on a
            # given backend; an unquantified write poisons the record.
            self._records.pop(key, None)
            return
        derived = self._derive(mb, cpp, period)
        if derived is None:
            return
        em, tol = derived
        if not (0 < em < _BOUND and 0 <= tol < _BOUND
                and 0 <= now_ns < _BOUND):
            self._records.pop(key, None)
            return
        if cur_ns is not None:
            tat = int(cur_ns)
        elif reset_after_ns is not None and 0 < int(reset_after_ns) < _BOUND:
            # allowed => current_tat = new_tat and reset = new_tat+tol-now
            tat = now_ns + int(reset_after_ns) - tol
        else:
            self._records.pop(key, None)
            return
        if not 0 <= tat < _BOUND:
            self._records.pop(key, None)
            return
        # Pop-then-reinsert so FIFO eviction tracks last-write age —
        # a refreshed hot key must not stay parked at the front of
        # the eviction queue.
        self._records.pop(key, None)
        self._records[key] = (tat, tol, seq)
        while len(self._records) > self.capacity:
            self._records.pop(next(iter(self._records)))

    def _observe_denied(self, key, mb, cpp, period, q, now_ns, seq,
                        cur_ns, reset_after_ns, retry_after_ns):
        if not 1 <= q <= _I32_MAX:
            # q=0 denials are no-ops; q > i32::MAX could push `remaining`
            # past where the wire tiers saturate and the ns planes don't.
            return
        rec = self._records.get(key)
        if rec is None:
            return  # last write not observed exactly: can't certify
        derived = self._derive(mb, cpp, period)
        if derived is None:
            return
        em, tol = derived
        if not (0 < em < _BOUND and 0 < tol < _BOUND
                and 0 <= now_ns < _BOUND):
            return
        inc = em * q
        if inc >= _BOUND:
            return
        if cur_ns is not None:
            tat = int(cur_ns)
        elif (
            reset_after_ns is not None
            and retry_after_ns is not None
            and 0 < int(reset_after_ns) < _BOUND
            and 0 < int(retry_after_ns) < _BOUND
            # Both planes must reconstruct the SAME TAT or something
            # saturated/clamped along the way.
            and now_ns + int(reset_after_ns) - tol
            == now_ns + int(retry_after_ns) - inc + tol
        ):
            tat = now_ns + int(reset_after_ns) - tol
        else:
            return
        if tat != rec[_REC_TAT]:
            return  # an unobserved write intervened (or first touch)
        rec_tol = rec[_REC_TOL]
        if not 0 <= tat < _BOUND or rec_tol >= _BOUND:
            return
        if now_ns >= tat + inc - tol:
            return  # inconsistent with a denial; refuse
        k = (key, (mb, cpp, period, q))
        if k not in self._entries and len(self._entries) >= self.capacity:
            self._evict(next(iter(self._entries)))
        self._entries.pop(k, None)
        self._entries[k] = _Entry(
            tat, em, tol, inc, int(mb), tat + rec_tol
        )
        self._by_key.setdefault(key, set()).add(k[1])

    # ------------------------------------------------------------------ #

    def _evict(self, k) -> None:
        self._entries.pop(k, None)
        key, pq = k
        s = self._by_key.get(key)
        if s is not None:
            s.discard(pq)
            if not s:
                del self._by_key[key]

    def _invalidate_key(self, key) -> None:
        s = self._by_key.pop(key, None)
        if s is not None:
            for pq in s:
                self._entries.pop((key, pq), None)

    def invalidate_key(self, key) -> None:
        with self._lock:
            self._invalidate_key(key)

    def prewarm(self, keys) -> int:
        """Refresh confirmed-hot keys against FIFO eviction (the
        insight tier's feedback loop): every live entry and write
        record for `keys` moves to the END of its eviction queue, so
        under cache pressure the hottest abuse keys — the ones the
        cache pays off most for — are the last evicted.  Exactness is
        untouched: nothing is created, only re-ordered; a key with no
        certified state is a no-op.  Returns the number of refreshed
        keys."""
        n = 0
        with self._lock:
            records = self._records
            entries = self._entries
            for key in keys:
                touched = False
                rec = records.pop(key, None)
                if rec is not None:
                    records[key] = rec
                    touched = True
                for pq in self._by_key.get(key, ()):
                    k = (key, pq)
                    e = entries.pop(k, None)
                    if e is not None:
                        entries[k] = e
                        touched = True
                if touched:
                    n += 1
        return n

    def on_sweep(self, now_ns: int) -> int:
        """Expiry sweep ran on the table at `now_ns`: drop every entry
        whose bucket it vacated (the slot is gone even for a later
        regressed clock).  Returns the eviction count."""
        with self._lock:
            dead = [
                k for k, e in self._entries.items() if e.expiry <= now_ns
            ]
            for k in dead:
                self._evict(k)
            for key in [
                key for key, r in self._records.items()
                if r[_REC_TAT] + r[_REC_TOL] <= now_ns
            ]:
                self._records.pop(key, None)
            self.stale_evictions += len(dead)
            return len(dead)

    def clear(self) -> None:
        """Full invalidation: snapshot restore / param-surface changes —
        anything that rewrites bucket state out from under the cache."""
        with self._lock:
            self._entries.clear()
            self._by_key.clear()
            self._records.clear()
