"""Bucket table on the card: one packed int32 row per slot.

The counterpart of `throttlecrab_tpu/tpu/table.py`.  String keys are
resolved to dense slot indices on the host (keymap.py); the device only
sees integer slots.  Each slot's (TAT, expiry) pair is one i32[4] row
(i32[6] with the insight deny counter), plus a scratch tail of
`SCRATCH` rows that absorbs suppressed writes at unique indices.

Every decision window goes through `fused.gcra_scan_packed_fused_*`:
on `cuda` that is one launch of the hand-written kernel, on `cpu` the
plain version.  The by-id launch path (`upload_id_rows`,
`check_many_byid` / `_ids` / `_ids20`) first expands the window's ids
into packed request rows with a front end: for raw ids the front-end
kernel of `ids_front.py` (on `cpu` its plain version, `kernel.py`
`ids_window` / `ids20_window`), for host-ranked words `kernel.py`
`byid_window`.  So a by-id window of raw ids is the front-end kernel
and the window kernel, and the row kernels (`row_ops.py`) are not on
it.  The state is updated in
place; outputs are returned as device tensors so the caller decides
when to fetch.
"""

from __future__ import annotations

from contextlib import nullcontext

import numpy as np
import torch

from . import fused, ids_front
from .kernel import (
    EMPTY_EXPIRY,
    IDS20_SENTINEL,
    INS_WIDTH,
    byid_window,
    insight_decay,
    insight_topk,
    pack_id_rows,
    pack_requests,
    pack_state,
    sweep_expired,
    unpack_state,
)
from .profiling import span
from .sat import I64_MAX


def resolve_device(device) -> torch.device:
    """The table's device: `cuda` unless the caller asks otherwise.
    Asking for a device that is not there raises; nothing falls back."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device 'cuda' requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run the plain version"
        )
    return dev


def on_device(dev: torch.device):
    """The context a ctypes launch on `dev` needs: that card current (its
    stream and context), or nothing on the CPU.  A mesh's shards may sit
    on several cards while the calling thread's current card is another."""
    return torch.cuda.device(dev) if dev.type == "cuda" else nullcontext()


# Stored-TAT bound of the compact="cur" output: the device emits
# `cur * 2 + allowed` in i64 and a denied lane's cur can be the stored
# TAT verbatim, so every live TAT must sit in [0, 2^62).
CUR_TAT_BOUND = 1 << 62


def tats_cur_safe(tats) -> bool:
    """True iff every raw i64 TAT value is in [0, CUR_TAT_BOUND): the
    condition under which compact="cur" launches are exact against state
    holding them.  Snapshot restore re-derives `cur_safe` with it."""
    tat = np.asarray(tats, np.int64)
    return tat.size == 0 or bool(((tat >= 0) & (tat < CUR_TAT_BOUND)).all())


def track_cur_safety(table, compact, params_cur_safe) -> None:
    """Cross-launch half of the compact="cur" certificate: the table's
    sticky `cur_safe` flag survives a launch iff its params are certified
    (compact "cur"/"w32" certify by contract)."""
    if compact not in ("cur", "w32") and not params_cur_safe:
        table.cur_safe = False


def _host_max_now(now_ns):
    """Max launch timestamp (host values only; a tensor reports unknown)."""
    if isinstance(now_ns, torch.Tensor):
        return None
    a = np.asarray(now_ns, np.int64)
    return int(a.max(initial=0)) if a.ndim else int(a)


def _uploaded(x, t) -> bool:
    """Whether `t`, a launch's conversion of its input `x`, was copied
    onto a device from elsewhere (on a card, an upload that waits for
    the stream)."""
    return t.device.type != "cpu" and not (
        isinstance(x, torch.Tensor) and x.device == t.device)


def _host_max_tol(valid, tolerance):
    """Masked max tolerance (host arrays only; a tensor reports unknown)."""
    if isinstance(tolerance, torch.Tensor) or isinstance(valid, torch.Tensor):
        return None
    v = np.asarray(valid, bool)
    return int(np.where(v, np.asarray(tolerance, np.int64), 0).max(initial=0))


class StaleIdRowsError(RuntimeError):
    """Device-resident by-id parameter rows refer to slots the keymap has
    since remapped (a sweep freed them, the table grew, or new ids were
    interned); re-run upload_id_rows before the next by-id launch."""


class ResidentIdRows:
    """Device-resident by-id parameter rows plus a staleness guard: pins
    the keymap's `mutations` counter at upload, and a launch after any
    later sweep, growth or intern raises StaleIdRowsError instead of
    deciding against stale or uncovered slots."""

    def __init__(self, rows: torch.Tensor, keymap) -> None:
        self.rows = rows
        self._keymap = keymap
        self._stamp = getattr(keymap, "mutations", 0)

    def rows_checked(self) -> torch.Tensor:
        current = getattr(self._keymap, "mutations", 0)
        if current != self._stamp:
            raise StaleIdRowsError(
                "by-id parameter rows are stale: the keymap remapped "
                f"slots since upload (mutations {self._stamp} -> "
                f"{current}); re-run upload_id_rows"
            )
        return self.rows


def _is_u16(a) -> bool:
    if isinstance(a, torch.Tensor):
        return a.dtype == torch.uint16
    return np.asarray(a).dtype == np.uint16


class HwmMarksMixin:
    """The compact="w32" certificate's cross-launch high-water marks,
    shared by BucketTable and the mesh's ShardedBucketTable: every
    stored TAT is <= its writing launch's now + tol <= now_hwm +
    tol_hwm.  A launch that cannot report a value saturates its mark
    (w32 off from then on).  Subclass __init__ sets `tol_hwm = now_hwm
    = 0`."""

    def note_max_tolerance(self, max_tol) -> None:
        """Record a launch's max valid-lane tolerance (None = unknown:
        the mark saturates, so w32 stays off)."""
        if max_tol is None:
            self.tol_hwm = I64_MAX
        else:
            self.tol_hwm = max(self.tol_hwm, int(max_tol))

    def note_launch_now(self, now_ns) -> None:
        """Record a launch's max timestamp (None = unknown: saturates)."""
        if now_ns is None:
            self.now_hwm = I64_MAX
        else:
            self.now_hwm = max(self.now_hwm, int(now_ns))


class BucketTable(HwmMarksMixin):
    """Per-slot GCRA state on one device."""

    SCRATCH = 1 << 16  # max batch size; scratch rows for suppressed writes

    def __init__(self, capacity: int, device=None, insight: bool = False):
        self.capacity = capacity
        self.device = resolve_device(device)
        self.state = self._alloc(capacity + self.SCRATCH)
        self.insight = False
        self.ins_counts = None
        if insight:
            self.enable_insight()
        # True while every stored TAT provably sits in [0, 2^62), the
        # cross-launch precondition of the compact="cur" tier.
        self.cur_safe = True
        # Expired-hit accumulator, read only on demand (adaptive cleanup).
        self.exp_acc = torch.zeros((), dtype=torch.int64, device=self.device)
        # High-water marks of the compact="w32" certificate: every stored
        # TAT is <= its writing launch's now + tol <= now_hwm + tol_hwm.
        self.tol_hwm = 0
        self.now_hwm = 0
        # Sequence number of the by-id launches begun (one that raises
        # uses its number up): the launch id of their recorded spans.
        self.launch_seq = 0

    def _alloc(self, rows: int) -> torch.Tensor:
        return pack_state(
            torch.zeros(rows, dtype=torch.int64, device=self.device),
            torch.full(
                (rows,), EMPTY_EXPIRY, dtype=torch.int64, device=self.device
            ),
        )

    def expired_hits(self) -> int:
        """Total expired-hit count since construction (one scalar fetch)."""
        return int(self.exp_acc)

    def enable_insight(self) -> None:
        """Widen the rows to INS_WIDTH (zeroed deny-counter columns) and
        allocate the [allowed, denied] totals.  Idempotent."""
        if self.insight:
            return
        pad = torch.zeros(
            (self.state.shape[0], INS_WIDTH - 4), dtype=torch.int32,
            device=self.device,
        )
        self.state = torch.cat([self.state, pad], dim=-1)
        self.ins_counts = torch.zeros(2, dtype=torch.int64, device=self.device)
        self.insight = True

    def insight_counts(self) -> tuple:
        """(allowed_total, denied_total) since construction."""
        if not self.insight:
            return (0, 0)
        counts = self.ins_counts.cpu().numpy()
        return int(counts[0]), int(counts[1])

    def insight_topk(self, k: int):
        """Top-K of the denied-hit counter column: (counts, slot ids)
        device tensors, highest count first, ties by lower slot; the
        fetch is the caller's.  None without the insight columns."""
        if not self.insight:
            return None
        k = max(1, min(int(k), self.capacity))
        return insight_topk(self.state, capacity=self.capacity, k=k)

    def insight_decay(self) -> None:
        """Halve the denied-hit counter columns (periodic heat decay)."""
        if self.insight:
            insight_decay(self.state)

    def load_numpy(
        self, state, exp_acc=0, ins_counts=None, tol_hwm=0, now_hwm=0,
        cur_safe=True,
    ) -> None:
        """Adopt a table held as numpy: `state` is i32[capacity + SCRATCH,
        W] rows (W 4, or 6 for the insight layout), e.g. the JAX package's
        `np.asarray(BucketTable.state)`; the accumulators, high-water
        marks and `cur_safe` flag come with it."""
        state = np.ascontiguousarray(state, np.int32)
        if state.ndim != 2 or state.shape[1] not in (4, INS_WIDTH):
            raise ValueError(f"state must be i32[N, 4|6], got {state.shape}")
        if state.shape[0] <= self.SCRATCH:
            raise ValueError("state must hold real rows before the scratch tail")
        self.capacity = state.shape[0] - self.SCRATCH
        self.state = torch.from_numpy(state.copy()).to(self.device)
        self.insight = state.shape[1] == INS_WIDTH
        self.ins_counts = (
            torch.tensor(
                list(ins_counts) if ins_counts is not None else [0, 0],
                dtype=torch.int64, device=self.device,
            )
            if self.insight
            else None
        )
        self.exp_acc = torch.tensor(
            int(exp_acc), dtype=torch.int64, device=self.device
        )
        self.tol_hwm = int(tol_hwm)
        self.now_hwm = int(now_hwm)
        self.cur_safe = bool(cur_safe)

    @property
    def tat(self) -> torch.Tensor:
        """i64 TAT column (excludes scratch)."""
        return unpack_state(self.state)[0][: self.capacity]

    @property
    def expiry(self) -> torch.Tensor:
        """i64 expiry column (excludes scratch)."""
        return unpack_state(self.state)[1][: self.capacity]

    def check_batch(
        self, slots, rank, is_last, emission, tolerance, quantity, valid,
        now_ns: int, with_degen: bool = True, compact=False,
        params_cur_safe: bool = False,
    ) -> torch.Tensor:
        """One sub-batch ([B] arrays, one timestamp); returns the device
        output of the `compact` tier for that sub-batch."""
        packed = pack_requests(
            slots, rank, is_last, emission, tolerance, quantity, valid
        )[None]
        return self.check_many_packed(
            packed, np.array([now_ns], np.int64), with_degen=with_degen,
            compact=compact, params_cur_safe=params_cur_safe,
            max_tolerance=_host_max_tol(valid, tolerance),
        )[0]

    def check_many(
        self, slots, rank, is_last, emission, tolerance, quantity, valid,
        now_ns, with_degen: bool = True, compact=False,
        params_cur_safe: bool = False,
    ) -> torch.Tensor:
        """K stacked sub-batches ([K, B] arrays, i64[K] timestamps) in one
        window; returns the stacked device output."""
        packed = pack_requests(
            slots, rank, is_last, emission, tolerance, quantity, valid
        )
        return self.check_many_packed(
            packed, now_ns, with_degen=with_degen, compact=compact,
            params_cur_safe=params_cur_safe,
            max_tolerance=_host_max_tol(valid, tolerance),
        )

    def check_many_packed(
        self, packed, now_ns, with_degen: bool = True, compact=False,
        params_cur_safe: bool = False, max_tolerance=None,
    ) -> torch.Tensor:
        """K stacked sub-batches from ONE packed i32[K, B, PACK_WIDTH]
        buffer (numpy or a tensor); `now_ns` is i64[K].  Returns the
        device output untouched, so a pipelined caller can defer the
        fetch.  `max_tolerance` is the caller's masked max tolerance
        (None saturates the w32 mark)."""
        if packed.shape[1] > self.SCRATCH:
            raise ValueError("batch exceeds scratch region")
        track_cur_safety(self, compact, params_cur_safe)
        self.note_max_tolerance(max_tolerance)
        self.note_launch_now(_host_max_now(now_ns))
        packed_t = torch.as_tensor(packed, dtype=torch.int32).to(self.device)
        now_t = torch.as_tensor(now_ns, dtype=torch.int64).to(self.device)
        if self.insight:
            self.state, self.exp_acc, self.ins_counts, out = (
                fused.gcra_scan_packed_fused_ins(
                    self.state, self.exp_acc, self.ins_counts, packed_t,
                    now_t, with_degen=with_degen, compact=compact,
                )
            )
        else:
            self.state, self.exp_acc, out = fused.gcra_scan_packed_fused_acc(
                self.state, self.exp_acc, packed_t, now_t,
                with_degen=with_degen, compact=compact,
            )
        return out

    # ---- the by-id launch path ---------------------------------------- #

    def upload_id_rows(self, slots, emission, tolerance, keymap=None):
        """Build and upload the by-id parameter rows: i32[n_ids,
        IDROW_WIDTH] = [slot, em_lo/hi, tol_lo/hi, pad], resident on the
        table's device launch after launch.

        A sweep or growth remaps slots and silently invalidates the
        rows; pass the `keymap` the slots came from to get a
        ResidentIdRows guard that raises StaleIdRowsError instead (re-
        upload to refresh).  Without `keymap` the raw tensor is returned
        and freshness is the caller's contract."""
        rows = torch.from_numpy(
            pack_id_rows(slots, emission, tolerance)
        ).to(self.device)
        # The rows' tolerances bound every later by-id write, so noting
        # them here covers all by-id launches (which report none).
        self.note_max_tolerance(
            None
            if isinstance(tolerance, torch.Tensor)
            else int(np.max(np.asarray(tolerance, np.int64), initial=0))
        )
        if keymap is None:
            return rows
        return ResidentIdRows(rows, keymap)

    def _byid_launch(self, front, id_rows, stream, dtype, batch, now_ns,
                     quantity, with_degen, compact, params_cur_safe):
        """Expand the window's ids with `front` and decide it as one
        packed window.  An insight table takes the `_acc` window too: the
        by-id entry points leave `ins_counts` alone, as the JAX package's
        do."""
        self.launch_seq += 1
        with span("tc.ids.launch", self.launch_seq):
            with span("tc.ids.prepare") as sp:
                if isinstance(id_rows, ResidentIdRows):
                    id_rows = id_rows.rows_checked()
                if batch > self.SCRATCH:
                    raise ValueError("batch exceeds scratch region")
                track_cur_safety(self, compact, params_cur_safe)
                self.note_launch_now(_host_max_now(now_ns))
                ids = torch.as_tensor(stream, dtype=dtype).to(self.device)
                now = torch.as_tensor(now_ns, dtype=torch.int64).to(
                    self.device)
                if sp is not None:
                    sp.attrs.update(
                        K=len(stream), B=batch,
                        upload=_uploaded(stream, ids)
                        or _uploaded(now_ns, now))
            with span("tc.ids.front") as sp:
                expanded = ids_front.LAUNCHES
                packed = front(id_rows, ids, int(quantity))
                if sp is not None:
                    sp.attrs.update(kernel=ids_front.LAUNCHES != expanded)
            with span("tc.ids.window"):
                self.state, self.exp_acc, out = \
                    fused.gcra_scan_packed_fused_acc(
                        self.state, self.exp_acc, packed, now,
                        with_degen=with_degen, compact=compact,
                    )
        return out

    def check_many_byid(
        self, id_rows, words, now_ns, quantity: int = 1,
        with_degen: bool = True, compact=False,
        params_cur_safe: bool = False,
    ) -> torch.Tensor:
        """K stacked sub-batches of 8-byte request words (i64[K, B],
        tk_assemble_ids layout) against resident `id_rows` (a tensor, or
        a ResidentIdRows guard, which is freshness-checked).  `quantity`
        is launch-uniform.  Returns the device output per `compact` (see
        check_many_packed) without fetching."""
        return self._byid_launch(
            byid_window, id_rows, words, torch.int64, words.shape[1],
            now_ns, quantity, with_degen, compact, params_cur_safe,
        )

    def check_many_ids(
        self, id_rows, ids, now_ns, quantity: int = 1,
        with_degen: bool = True, compact=False,
        params_cur_safe: bool = False,
    ) -> torch.Tensor:
        """K stacked sub-batches of raw key ids (i32[K, B], negative =
        padding) against resident `id_rows`: 4 bytes per request, the
        duplicate-segment structure derived on the device.  Otherwise as
        check_many_byid."""
        return self._byid_launch(
            ids_front.ids_window, id_rows, ids, torch.int32, ids.shape[1],
            now_ns, quantity, with_degen, compact, params_cur_safe,
        )

    def check_many_ids20(
        self, id_rows, packed, now_ns, quantity: int = 1,
        with_degen: bool = True, compact=False,
        params_cur_safe: bool = False,
    ) -> torch.Tensor:
        """K stacked sub-batches of 20-bit packed key ids (u16[K, B +
        B//4], kernel.pack_ids20): 2.5 bytes per request.  The resident
        rows must stay below the padding sentinel, so padding can never
        alias a real key."""
        if isinstance(id_rows, ResidentIdRows):
            id_rows = id_rows.rows_checked()
        if id_rows.shape[0] > IDS20_SENTINEL:
            raise ValueError(
                "20-bit id stream needs n_ids <= 2^20 - 1 (the padding "
                f"sentinel); table has {id_rows.shape[0]} id rows"
            )
        # Loudly reject a sibling API's buffer: raw i32 ids would be
        # truncated into in-range garbage decisions.
        if packed.shape[1] % 5 or not _is_u16(packed):
            raise ValueError(
                "packed must be the u16[K, B + B//4] stream from "
                f"kernel.pack_ids20 (got {packed.dtype}"
                f"[..., {packed.shape[1]}])"
            )
        return self._byid_launch(
            ids_front.ids20_window, id_rows, packed, torch.uint16,
            packed.shape[1] * 4 // 5, now_ns, quantity, with_degen, compact,
            params_cur_safe,
        )

    def sweep(self, now_ns: int) -> np.ndarray:
        """Vacate expired slots (a vacated slot's deny count dies with
        it); returns the boolean expired mask (host)."""
        return sweep_expired(now_ns, self.state, self.capacity).cpu().numpy()

    def grow(self, new_capacity: int) -> None:
        """Reallocate with `new_capacity` real rows (scratch kept last)."""
        if new_capacity <= self.capacity:
            return
        extra = self._alloc(new_capacity - self.capacity)
        if self.insight:
            extra = torch.cat(
                [
                    extra,
                    torch.zeros(
                        (extra.shape[0], INS_WIDTH - 4), dtype=torch.int32,
                        device=self.device,
                    ),
                ],
                dim=-1,
            )
        self.state = torch.cat(
            [self.state[: self.capacity], extra, self.state[self.capacity:]]
        )
        self.capacity = new_capacity

    def live_count(self, now_ns: int) -> int:
        """Number of live (non-expired) entries; diagnostic only."""
        return int((self.expiry > now_ns).sum())
