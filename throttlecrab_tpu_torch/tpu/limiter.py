"""TorchRateLimiter: the batched GCRA engine on PyTorch.

The counterpart of `throttlecrab_tpu/tpu/limiter.py`: requests arrive as
whole batches, string keys are resolved to table slots on the host, GCRA
parameters are derived with the reference's exact f64 pipeline, and every
decision window runs through one launch of the decision-window kernel
against the bucket table on the card.  `keymap="native"` resolves keys
in C++ (`native.py`) and adds `dispatch_wire_window`, the fully native
batch preparation of wire frames.

Exactness notes vs the scalar contract:

- Per-request validation errors are reported in `status` instead of
  raising, so one bad request does not fail its batchmates.
- Duplicate keys in one batch are serialized with exact arrival-order
  semantics (see kernel.py).  A key whose parameters change mid-batch is
  split into consecutive param-runs processed as sub-rounds.
- `now_ns` is one server-side timestamp per batch; the scalar-compat
  wrapper applies the pre-epoch clock-skew fallback per call.
- Emission intervals are clamped to i64::MAX ns.

Fault sites (faults/, at the JAX limiter's places): "keymap" after the
first key resolve, "launch" after the host prep and before anything is
enqueued on the stream or written to the table's certificate marks (so
a retried launch never applies a window twice), and "fetch" at the top
of each deferred fetch, which reads the same device output again on a
retry.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np

from ..core.errors import InternalError, InvalidRateLimit, NegativeQuantity
from ..faults import maybe_fail
from ..core.rate_limiter import RateLimitResult, normalize_now_ns
from .kernel import (
    PACK_WIDTH,
    cur_wire_safe,
    finish_cur,
    finish_w32,
    fits_w32_wire,
    fits_w32_wire_agg,
    pack_requests,
)
from ..native import (
    PREP_BIGTOL,
    PREP_CONFLICT,
    PREP_DEGEN,
    PREP_FULL,
    NativeKeyMap,
    native_available,
)
from .keymap import PyKeyMap
from .sat import I64_MAX
from .table import BucketTable

STATUS_OK = 0
STATUS_NEGATIVE_QUANTITY = 1
STATUS_INVALID_PARAMS = 2
STATUS_INTERNAL = 3
# Request needed a NEW table slot but its tenant is at its slot-capacity
# quota (sharded mesh with the tenant layer, parallel/tenants.py).
STATUS_TENANT_QUOTA = 5
# Request outlived its client deadline: shed host-side before device
# dispatch (server/engine.py).
STATUS_DEADLINE = 6


def segment_info(slots, mask):
    """Per-request duplicate-key structure for the kernel: for each
    masked-in request its key's occurrence number (`rank`) and whether
    it is the key's final occurrence (`is_last`)."""
    n = len(slots)
    rank = np.zeros(n, np.int32)
    is_last = np.ones(n, bool)
    state: dict = {}
    for i in np.flatnonzero(mask):
        sl = int(slots[i])
        st = state.get(sl)
        if st is None:
            state[sl] = [1, i]
        else:
            rank[i] = st[0]
            st[0] += 1
            is_last[st[1]] = False
            st[1] = i
    return rank, is_last


@dataclass
class BatchResult:
    """Per-request outcomes of one batch (numpy arrays, length B).

    `cur_ns` (optional) is each request's exact observed TAT, populated
    when the launch rode the compact="cur" tier with `collect_cur=True`;
    None elsewhere (invalid lanes carry garbage: gate on status)."""

    allowed: np.ndarray
    limit: np.ndarray
    remaining: np.ndarray
    reset_after_ns: np.ndarray
    retry_after_ns: np.ndarray
    status: np.ndarray
    cur_ns: Optional[np.ndarray] = None


@dataclass
class WireBatchResult:
    """Per-request outcomes in wire units: reset/retry in whole seconds,
    remaining saturated at i32::MAX — what every transport emits."""

    allowed: np.ndarray
    limit: np.ndarray
    remaining: np.ndarray
    reset_after_s: np.ndarray
    retry_after_s: np.ndarray
    status: np.ndarray
    cur_ns: Optional[np.ndarray] = None


# Segment arithmetic on the certified path multiplies inc by at most the
# batch size; certifying inc * MAX_SEGMENT < 2^62 lets the kernel use
# plain multiplies there.
MAX_SEGMENT = BucketTable.SCRATCH
_MUL_SAFE = float(1 << 62)


def has_degenerate(valid, emission, tolerance, quantity) -> bool:
    """True when any valid request needs the kernel's exact path:
    quantity-0 probes, burst-1 (tolerance 0), zero emission, a
    wrapped-negative tolerance, or an increment big enough that segment
    arithmetic could overflow i64.  Certified per batch, so correctness
    never depends on traffic shape."""
    big_inc = (
        emission.astype(np.float64)
        * np.maximum(quantity, 1).astype(np.float64)
        * float(MAX_SEGMENT)
        >= _MUL_SAFE
    )
    return bool(
        np.any(
            valid
            & (
                (emission == 0)
                | (tolerance <= 0)
                | (quantity == 0)
                | big_inc
            )
        )
    )


def prepare_batch(n, max_burst, count_per_period, period, quantity):
    """Broadcast request params to length n, validate, derive GCRA params.
    Returns (max_burst, quantity, emission, tolerance, status, valid)."""
    max_burst = np.broadcast_to(np.asarray(max_burst, np.int64), (n,))
    count_per_period = np.broadcast_to(
        np.asarray(count_per_period, np.int64), (n,)
    )
    period = np.broadcast_to(np.asarray(period, np.int64), (n,))
    quantity = np.broadcast_to(np.asarray(quantity, np.int64), (n,))

    status = np.zeros(n, np.uint8)
    emission, tolerance, invalid = derive_params(
        max_burst, count_per_period, period
    )
    status[invalid] = STATUS_INVALID_PARAMS
    status[quantity < 0] = STATUS_NEGATIVE_QUANTITY
    valid = status == STATUS_OK
    return max_burst, quantity, emission, tolerance, status, valid


def param_rounds(rounds, slots, positions, emission, tolerance, quantity):
    """Assign arrival-order param-run rounds into `rounds` at `positions`:
    round r holds each key's r-th maximal run of identical (emission,
    tolerance, quantity)."""
    state: dict = {}
    for i in positions:
        sl = int(slots[i])
        p = (int(emission[i]), int(tolerance[i]), int(quantity[i]))
        st = state.get(sl)
        if st is None:
            state[sl] = [p, 0]
        elif st[0] == p:
            rounds[i] = st[1]
        else:
            st[0] = p
            st[1] += 1
            rounds[i] = st[1]
    return rounds


def limiter_uses_bytes_keys(limiter) -> bool:
    """Whether a limiter's host keymap stores bytes keys (native backend)
    or str keys (python backend).  Transports that receive raw bytes must
    match the identity str-keyed transports use, or one client key
    becomes two buckets.  Works across TorchRateLimiter (.keymap) and the
    sharded limiter (._bytes_keys)."""
    km = getattr(limiter, "keymap", None)
    if km is not None:
        return bool(getattr(km, "BYTES_KEYS", False))
    return bool(getattr(limiter, "_bytes_keys", False))


def sequential_fallback(batches, decide_fn, error_result_fn, wire,
                        **decide_kw):
    """Decide a window batch-by-batch when one window cannot express it (a
    key changed parameters mid-batch).  Errors are isolated per batch:
    earlier batches' decisions are committed and delivered; later batches
    after a failure return all-internal-error results."""
    out = []
    failed = False
    for b in batches:
        if failed:
            out.append(error_result_fn(len(b[0]), wire=wire))
            continue
        try:
            out.append(decide_fn(*b, wire=wire, **decide_kw))
        except Exception:
            failed = True
            out.append(error_result_fn(len(b[0]), wire=wire))
    return out


class ScalarCompatMixin:
    """Scalar `rate_limit` (the reference library API) over a batch engine:
    raising validation errors, the pre-epoch clock fallback, and one
    request per batch."""

    def rate_limit(
        self, key, max_burst: int, count_per_period: int, period: int,
        quantity: int, now_ns: int,
    ):
        if quantity < 0:
            raise NegativeQuantity(quantity)
        if max_burst <= 0 or count_per_period <= 0 or period <= 0:
            raise InvalidRateLimit()
        now_ns = normalize_now_ns(now_ns, period)
        res = self.rate_limit_batch(
            [key], [max_burst], [count_per_period], [period], [quantity], now_ns
        )
        return bool(res.allowed[0]), RateLimitResult(
            limit=int(res.limit[0]),
            remaining=int(res.remaining[0]),
            reset_after_ns=int(res.reset_after_ns[0]),
            retry_after_ns=int(res.retry_after_ns[0]),
        )


def derive_params(max_burst, count_per_period, period):
    """(emission_ns, tolerance_ns, invalid) via the reference f64 pipeline
    (`rate/mod.rs:164-176`; tolerance = emission * ((burst-1) as u32),
    wrapping to 64 bits, `rate_limiter.rs:122`)."""
    max_burst = np.asarray(max_burst, np.int64)
    count_per_period = np.asarray(count_per_period, np.int64)
    period = np.asarray(period, np.int64)

    invalid = (max_burst <= 0) | (count_per_period <= 0) | (period <= 0)
    safe_count = np.where(count_per_period == 0, 1, count_per_period)
    emission_f = period.astype(np.float64) * 1e9 / safe_count.astype(np.float64)
    with np.errstate(invalid="ignore"):
        # Out-of-range casts are overridden by the I64_MAX clamp below.
        emission = np.where(
            emission_f >= float(1 << 63),
            I64_MAX,
            emission_f.astype(np.int64),
        )
    emission = np.where(emission < 0, 0, emission)

    b32 = (max_burst - 1).astype(np.uint64) & np.uint64(0xFFFFFFFF)
    # Deliberately WRAPPING u64 product (rate_limiter.rs:122 semantics).
    tolerance = (emission.astype(np.uint64) * b32).astype(np.int64)  # inv: allow(i64-raw-op)
    return emission, tolerance, invalid


class _ReadyLaunch:
    """dispatch_many handle whose results are already on the host."""

    def __init__(self, results: list) -> None:
        self._results = results

    def fetch(self) -> list:
        return self._results


class _PendingLaunch:
    """An in-flight window; `.fetch()` copies the device output to the
    host (waiting for the launch) and distributes it into per-batch
    results."""

    def __init__(
        self, out_dev, prepared, valid_s, wire, cur=False, w32=False
    ) -> None:
        self._out_dev = out_dev
        self._prepared = prepared
        self._valid_s = valid_s
        self._wire = wire
        self._cur = cur
        self._w32 = w32

    def fetch(self) -> list:
        maybe_fail("fetch")
        out = self._out_dev.cpu().numpy()
        wire = self._wire
        results = []
        for j, (n, slots, rank, is_last, emission, tolerance, quantity,
                valid, now_ns, max_burst, status) in enumerate(
            self._prepared
        ):
            cur_plane = None
            if self._w32:
                o = np.stack(finish_w32(out[j, :n]))
            elif self._cur:
                o = np.stack(
                    finish_cur(
                        out[j, :n], emission, tolerance, quantity, now_ns
                    )
                )
                # cur*2 + allowed: the arithmetic shift recovers the
                # exact observed TAT.
                cur_plane = out[j, :n] >> 1
            else:
                o = out[j, :, :n]
            mask = self._valid_s[j, :n]
            fields = dict(
                allowed=(o[0] != 0) & mask,
                limit=np.where(valid, max_burst, 0),
                remaining=np.where(mask, o[1], 0),
                status=status,
                cur_ns=cur_plane,
            )
            if wire:
                results.append(
                    WireBatchResult(
                        reset_after_s=np.where(mask, o[2], 0),
                        retry_after_s=np.where(mask, o[3], 0),
                        **fields,
                    )
                )
            else:
                results.append(
                    BatchResult(
                        reset_after_ns=np.where(mask, o[2], 0),
                        retry_after_ns=np.where(mask, o[3], 0),
                        **fields,
                    )
                )
        return results


class _PendingWireLaunch:
    """In-flight window from dispatch_wire_window; `.fetch()` copies the
    compact device output to the host and distributes it into per-frame
    WireBatchResults.  The output is the 4-plane compact i32[K, 4, B],
    the w32 words, or the "cur" words i64[K, B] completed to the exact
    wire values by the native keymap's tk_finish (`finish`)."""

    def __init__(
        self, out_dev, prepared, finish=None, now_ns=0, w32=False
    ) -> None:
        self._out_dev = out_dev
        self._prepared = prepared
        self._finish = finish
        self._now_ns = now_ns
        self._w32 = w32

    def fetch(self) -> list:
        maybe_fail("fetch")
        out = self._out_dev.cpu().numpy()
        results = []
        for j, (packed, status, params) in enumerate(self._prepared):
            n = len(status)
            valid = (packed[:, 2] & 2) != 0
            cur_plane = None
            if self._w32:
                o = np.stack(finish_w32(out[j, :n]))
            elif self._finish is not None:
                o = self._finish(packed, out[j, :n], self._now_ns).T
                # cur*2 + allowed: the arithmetic shift recovers the
                # exact observed TAT.
                cur_plane = out[j, :n] >> 1
            else:
                o = out[j, :, :n]
            results.append(
                WireBatchResult(
                    allowed=(o[0] != 0) & valid,
                    limit=np.where(valid, params[:, 0], 0),
                    remaining=np.where(valid, o[1], 0),
                    reset_after_s=np.where(valid, o[2], 0),
                    retry_after_s=np.where(valid, o[3], 0),
                    status=status,
                    cur_ns=cur_plane,
                )
            )
        return results


class TorchRateLimiter(ScalarCompatMixin):
    """Batched GCRA over a bucket table on the card + a host keymap."""

    # Batches are padded to a power of two of at least MIN_PAD lanes, so
    # the window shapes stay few as traffic varies.
    MIN_PAD = 16

    def __init__(
        self,
        capacity: int = 1 << 20,
        keymap="python",
        device=None,
        auto_grow: bool = True,
        insight: bool = False,
    ) -> None:
        """`device` defaults to "cuda" (asking for it without a card
        raises); "cpu" runs the plain version.  `keymap` selects the host
        key->slot backend: "python" (hashable keys of any kind),
        "native" (the C++ batch resolver, bytes keys; str keys are
        encoded), "auto" (native when it builds, else python), or a ready
        keymap object exposing resolve/free_slots/grow/capacity."""
        self.table = BucketTable(capacity, device=device, insight=insight)
        if keymap == "auto":
            keymap = "native" if native_available() else "python"
        if keymap == "python":
            self.keymap = PyKeyMap(capacity)
        elif keymap == "native":
            self.keymap = NativeKeyMap(capacity)
        else:
            self.keymap = keymap
        self.auto_grow = auto_grow
        self._exp_hits_read = 0
        self._exp_hits_last_fetch_ns: Optional[int] = None

    def load_numpy(self, state, keymap_items, **table_kw) -> None:
        """Adopt a table and keymap held outside this limiter: `state` as
        for BucketTable.load_numpy, `keymap_items` the (key, slot) pairs
        (e.g. the JAX package's `PyKeyMap.items()`)."""
        self.table.load_numpy(state, **table_kw)
        self.keymap = PyKeyMap.from_items(self.table.capacity, keymap_items)
        self._exp_hits_read = self.table.expired_hits()

    # ------------------------------------------------------------------ #

    def expired_hits_fetch_due(
        self, now_ns: int, min_period_ns: int = 1_000_000_000
    ) -> bool:
        """True when take_expired_hits would actually read the device."""
        last = self._exp_hits_last_fetch_ns
        return last is None or now_ns - last >= min_period_ns

    def take_expired_hits(
        self, now_ns: int, min_period_ns: int = 1_000_000_000
    ) -> int:
        """New expired-hit count since the last call, for the adaptive
        cleanup policy; the device read is throttled to once per
        `min_period_ns`.  Returns 0 between reads."""
        last = self._exp_hits_last_fetch_ns
        if last is not None and now_ns - last < min_period_ns:
            return 0
        self._exp_hits_last_fetch_ns = now_ns
        total = self.table.expired_hits()
        delta = total - self._exp_hits_read
        self._exp_hits_read = total
        return delta

    def rate_limit_batch(
        self,
        keys,
        max_burst,
        count_per_period,
        period,
        quantity,
        now_ns: int,
        wire: bool = False,
        collect_cur: bool = False,
    ) -> BatchResult:
        """Decide a batch of requests at one server timestamp.

        `wire=True` takes the serving fast path (WireBatchResult, and the
        degenerate machinery dropped whenever the batch provably needs
        none).  `collect_cur=True` (wire mode) rides the cur tier when
        certifiable and attaches `result.cur_ns`."""
        (n, max_burst, quantity, emission, tolerance, status, valid,
         slots, rank0, is_last0, rounds) = self._prepare_one(
            keys, max_burst, count_per_period, period, quantity, now_ns
        )
        maybe_fail("launch")
        degen = has_degenerate(valid, emission, tolerance, quantity)
        with_degen = not wire or degen
        params_cur_safe = cur_wire_safe(valid, tolerance, now_ns)
        use_cur = (
            wire
            and collect_cur
            and not degen
            and params_cur_safe
            and self.table.cur_safe
        )

        pad = max(self.MIN_PAD, 1 << (n - 1).bit_length())
        slots_p = np.zeros(pad, np.int32)
        slots_p[:n] = slots
        em_p = np.zeros(pad, np.int64)
        em_p[:n] = emission
        tol_p = np.zeros(pad, np.int64)
        tol_p[:n] = tolerance
        q_p = np.zeros(pad, np.int64)
        q_p[:n] = quantity

        allowed = np.zeros(n, bool)
        remaining = np.zeros(n, np.int64)
        reset_after = np.zeros(n, np.int64)
        retry_after = np.zeros(n, np.int64)
        cur_plane = np.zeros(n, np.int64) if use_cur else None

        n_rounds = int(rounds.max()) + 1 if n else 1
        for r in range(n_rounds):
            mask = valid & (rounds == r)
            if not mask.any():
                continue
            valid_p = np.zeros(pad, bool)
            valid_p[:n] = mask
            if n_rounds == 1:
                rank = np.zeros(pad, np.int32)
                rank[:n] = rank0
                is_last = np.ones(pad, bool)
                is_last[:n] = is_last0
            else:
                rank, is_last = segment_info(slots_p, valid_p)
            out_dev = self.table.check_batch(
                slots_p, rank, is_last, em_p, tol_p, q_p, valid_p, now_ns,
                with_degen=with_degen, compact="cur" if use_cur else wire,
                params_cur_safe=params_cur_safe,
            )
            if use_cur:
                words = out_dev.cpu().numpy()[:n]
                out = np.stack(
                    finish_cur(words, emission, tolerance, quantity, now_ns)
                )
                cur_plane[mask] = (words >> 1)[mask]
            else:
                out = out_dev.cpu().numpy()[:, :n]
            allowed[mask] = out[0][mask] != 0
            remaining[mask] = out[1][mask]
            reset_after[mask] = out[2][mask]
            retry_after[mask] = out[3][mask]

        limit = np.where(valid, max_burst, 0)
        if wire:
            return WireBatchResult(
                allowed=allowed,
                limit=limit,
                remaining=remaining,
                reset_after_s=reset_after,
                retry_after_s=retry_after,
                status=status,
                cur_ns=cur_plane,
            )
        return BatchResult(
            allowed=allowed,
            limit=limit,
            remaining=remaining,
            reset_after_ns=reset_after,
            retry_after_ns=retry_after,
            status=status,
        )

    # ------------------------------------------------------------------ #

    def _prepare_one(
        self, keys, max_burst, count_per_period, period, quantity, now_ns
    ):
        """Shared per-batch prologue: validate, derive params, resolve
        slots (growing on full), emit segment structure + conflict rounds."""
        if now_ns < 0:
            raise ValueError(
                "batch now_ns must be non-negative; apply "
                "normalize_now_ns per request for pre-epoch clocks"
            )
        n = len(keys)
        if getattr(self.keymap, "BYTES_KEYS", False):
            keys = [k.encode() if isinstance(k, str) else k for k in keys]
        max_burst, quantity, emission, tolerance, status, valid = (
            prepare_batch(n, max_burst, count_per_period, period, quantity)
        )
        slots, rank0, is_last0, n_full = self.keymap.resolve(keys, valid)
        maybe_fail("keymap")
        while n_full:
            if not self.auto_grow:
                raise InternalError("bucket table full")
            new_capacity = max(self.keymap.capacity * 2, 1024)
            self.keymap.grow(new_capacity)
            self.table.grow(new_capacity)
            missing = valid & (slots == -1)
            slots2, _, _, n_full = self.keymap.resolve(keys, missing)
            slots = np.where(missing, slots2, slots)
            rank0, is_last0 = segment_info(slots, valid)
        rounds = self._conflict_rounds(
            slots, valid, emission, tolerance, quantity
        )
        return (n, max_burst, quantity, emission, tolerance, status, valid,
                slots, rank0, is_last0, rounds)

    @staticmethod
    def _error_result(n, status_code=STATUS_INTERNAL, wire=False):
        """All-requests-failed result (engine maps status -> error)."""
        zeros = np.zeros(n, np.int64)
        status = np.full(n, status_code, np.uint8)
        if wire:
            return WireBatchResult(
                allowed=np.zeros(n, bool), limit=zeros, remaining=zeros,
                reset_after_s=zeros, retry_after_s=zeros, status=status,
            )
        return BatchResult(
            allowed=np.zeros(n, bool), limit=zeros, remaining=zeros,
            reset_after_ns=zeros, retry_after_ns=zeros, status=status,
        )

    def rate_limit_many(
        self, batches, wire: bool = False, collect_cur: bool = False
    ) -> list:
        """Decide K whole batches in ONE window: `batches` is a list of
        (keys, max_burst, count_per_period, period, quantity, now_ns) in
        arrival order; each sub-batch sees the state the previous one
        left.  Returns a list of results."""
        return self.dispatch_many(
            batches, wire=wire, collect_cur=collect_cur
        ).fetch()

    def dispatch_many(
        self, batches, wire: bool = False, collect_cur: bool = False
    ):
        """The dispatch half of rate_limit_many: host-prepare the window,
        launch it, and return a handle whose `.fetch()` waits for the
        results.  The launch is asynchronous, so a caller can prepare and
        dispatch window N+1 before fetching window N.

        Output tier, cheapest eligible first: w32 (4 B/request,
        device-packed wire values) -> cur (8 B, host-finished; preferred
        under `collect_cur`) -> the 4-plane tier."""
        if not batches:
            return _ReadyLaunch([])

        prepared = []
        width = self.MIN_PAD
        any_degen = False
        for keys, max_burst, count_per_period, period, quantity, now_ns in (
            batches
        ):
            (n, max_burst, quantity, emission, tolerance, status, valid,
             slots, rank, is_last, rounds) = self._prepare_one(
                keys, max_burst, count_per_period, period, quantity, now_ns
            )
            if rounds.any():
                return _ReadyLaunch(
                    sequential_fallback(
                        batches, self.rate_limit_batch,
                        self._error_result, wire,
                        collect_cur=collect_cur,
                    )
                )
            any_degen = any_degen or has_degenerate(
                valid, emission, tolerance, quantity
            )
            prepared.append(
                (n, slots, rank, is_last, emission, tolerance, quantity,
                 valid, now_ns, max_burst, status)
            )
            width = max(width, 1 << max(n - 1, 0).bit_length())

        K = len(prepared)
        # Pad the window depth to a power of two with empty sub-batches.
        K_pad = 1 << (K - 1).bit_length()
        shape = (K_pad, width)
        slots_s = np.zeros(shape, np.int32)
        rank_s = np.zeros(shape, np.int32)
        last_s = np.ones(shape, bool)
        em_s = np.zeros(shape, np.int64)
        tol_s = np.zeros(shape, np.int64)
        q_s = np.zeros(shape, np.int64)
        valid_s = np.zeros(shape, bool)
        now_s = np.full(K_pad, prepared[-1][8], np.int64)
        for j, (n, slots, rank, is_last, emission, tolerance, quantity,
                valid, now_ns, _mb, _st) in enumerate(prepared):
            slots_s[j, :n] = slots
            rank_s[j, :n] = rank
            last_s[j, :n] = is_last
            em_s[j, :n] = emission
            tol_s[j, :n] = tolerance
            q_s[j, :n] = quantity
            valid_s[j, :n] = valid
            now_s[j] = now_ns

        packed = pack_requests(
            slots_s, rank_s, last_s, em_s, tol_s, q_s, valid_s
        )
        now_max = int(now_s.max(initial=0))
        params_cur_safe = cur_wire_safe(valid_s, tol_s, now_max)
        max_tol = int(np.where(valid_s, tol_s, 0).max(initial=0))
        # w32's stored-TAT bound needs timestamps non-decreasing within
        # the window and no earlier than any prior launch's.
        use_w32 = (
            wire
            and not collect_cur
            and not any_degen
            and now_max < (1 << 61)
            and bool((np.diff(now_s) >= 0).all())
            and fits_w32_wire(
                valid_s, em_s, tol_s, q_s, int(now_s[0]),
                self.table.tol_hwm, self.table.now_hwm,
            )
        )
        use_cur = (
            not use_w32
            and wire
            and not any_degen
            and params_cur_safe
            and self.table.cur_safe
        )
        maybe_fail("launch")
        out_dev = self.table.check_many_packed(
            packed, now_s,
            with_degen=not wire or any_degen,
            compact="w32" if use_w32 else ("cur" if use_cur else wire),
            params_cur_safe=params_cur_safe,
            max_tolerance=max_tol,
        )
        return _PendingLaunch(
            out_dev, prepared, valid_s, wire, cur=use_cur, w32=use_w32
        )

    def dispatch_wire_window(
        self, frames, now_ns: int, collect_cur: bool = False
    ):
        """The fully native serving dispatch: each frame is (key_blob,
        offsets i64[n+1], params i64[n, 4]) as a wire layer hands batches
        over.  One C++ call per frame validates, derives the GCRA params
        (exact f64 pipeline), resolves slots and writes the packed rows
        (native/keymap.cpp tk_prepare_batch); Python only pads to powers
        of two and launches the window through check_many_packed.
        Returns a handle with .fetch() -> [WireBatchResult], or None when
        the window needs the exact Python path (a keymap without
        prepare_batch, a mid-batch param change, or a full table;
        preparation is idempotent, so the fallback simply re-resolves)."""
        km = self.keymap
        if not hasattr(km, "prepare_batch"):
            return None
        if now_ns < 0:
            # Part of the with_degen=False certificate: the nonneg
            # saturating forms require now >= 0.
            raise ValueError(
                "batch now_ns must be non-negative; apply "
                "normalize_now_ns per request for pre-epoch clocks"
            )
        prepared = []
        width = self.MIN_PAD
        any_degen = False
        any_bigtol = False
        # Per-window w32-certificate aggregates, folded across frames (the
        # C++ prep computes them per frame in the same pass).
        agg = np.empty(4, np.int64)
        max_tol = 0
        min_tol = 1 << 62
        max_inc = 0
        rem_bound = 0
        for blob, offsets, params in frames:
            packed, status, flags = km.prepare_batch(
                blob, offsets, params, agg=agg
            )
            if flags & (PREP_CONFLICT | PREP_FULL):
                return None
            any_degen = any_degen or bool(flags & PREP_DEGEN)
            any_bigtol = any_bigtol or bool(flags & PREP_BIGTOL)
            max_tol = max(max_tol, int(agg[0]))
            # agg[0] > 0 iff the frame had a valid lane with tol > 0
            # (tol <= 0 lanes set PREP_DEGEN, which refuses w32, so the
            # 0 sentinel of the min never leaks in).
            if int(agg[0]) > 0:
                min_tol = min(min_tol, int(agg[1]))
            max_inc = max(max_inc, int(agg[2]))
            rem_bound = max(rem_bound, int(agg[3]))
            prepared.append((packed, status, params))
            n = len(status)
            width = max(width, 1 << max(n - 1, 0).bit_length())

        # PREP_BIGTOL is set only for valid lanes, and degenerate lanes
        # obey the same write bound, so bigtol and now alone decide
        # whether the stored TATs stay cur-safe.
        params_cur_safe = not any_bigtol and now_ns < (1 << 61)
        K = len(prepared)
        K_pad = 1 << max(K - 1, 0).bit_length()
        stack = np.zeros((K_pad, width, PACK_WIDTH), np.int32)
        for j, (packed, _, _) in enumerate(prepared):
            stack[j, : len(packed)] = packed

        # Tier ladder: w32 (4 B/request, certified on the C++ prep's
        # aggregates), else cur (8 B, host-finished by tk_finish), else
        # the 4-plane compact output.  collect_cur wants the observed-TAT
        # plane, which only the cur tier carries.
        use_w32 = (
            not any_degen
            and not any_bigtol
            and not collect_cur
            and fits_w32_wire_agg(
                max_tol, min_tol, max_inc, rem_bound, now_ns,
                self.table.tol_hwm, self.table.now_hwm,
            )
        )
        use_cur = (
            not use_w32
            and not any_degen
            and params_cur_safe
            and self.table.cur_safe
            and hasattr(km, "finish")
        )
        maybe_fail("launch")
        out_dev = self.table.check_many_packed(
            stack,
            np.full(K_pad, now_ns, np.int64),
            with_degen=any_degen,
            compact="w32" if use_w32 else ("cur" if use_cur else True),
            params_cur_safe=params_cur_safe,
            max_tolerance=max_tol,
        )
        if use_w32:
            return _PendingWireLaunch(out_dev, prepared, w32=True)
        if use_cur:
            return _PendingWireLaunch(
                out_dev, prepared, finish=km.finish, now_ns=now_ns
            )
        return _PendingWireLaunch(out_dev, prepared)

    def sweep(self, now_ns: int) -> int:
        """Run a cleanup sweep; returns the number of slots freed."""
        expired = self.table.sweep(now_ns)
        return self.keymap.free_slots(np.flatnonzero(expired))

    def __len__(self) -> int:
        return len(self.keymap)

    @property
    def total_capacity(self) -> int:
        """Slots available before growth (for capacity-pressure policies)."""
        return self.table.capacity

    # ------------------------------------------------------------------ #

    @staticmethod
    def _conflict_rounds(slots, valid, emission, tolerance, quantity):
        """Arrival-order rounds for keys whose params change mid-batch."""
        n = len(slots)
        rounds = np.zeros(n, np.int32)
        if n == 0:
            return rounds
        vslots = slots[valid]
        if len(np.unique(vslots)) == len(vslots):
            return rounds  # no duplicates at all: single round

        uniq, first_idx, inv = np.unique(
            slots, return_index=True, return_inverse=True
        )
        canon = first_idx[inv]
        conflict = valid & (
            (emission != emission[canon])
            | (tolerance != tolerance[canon])
            | (quantity != quantity[canon])
        )
        if not conflict.any():
            return rounds
        return param_rounds(
            rounds, slots, np.flatnonzero(valid), emission, tolerance,
            quantity,
        )
