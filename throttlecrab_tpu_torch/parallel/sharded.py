"""Key-sharded bucket table over a list of torch devices.

The port of `throttlecrab_tpu/parallel/sharded.py`.  The JAX mesh is
single-controller: one process routes keys on the host, owns one keymap
per shard, and `shard_map`s the same decision program over D devices.
The port keeps that shape without `torch.distributed`:

- A mesh (:func:`make_mesh`) is a tuple of torch devices, one per shard.
  On ``cuda`` it takes the first n cards and refuses to shrink; on
  ``cpu`` all n shards sit on the one CPU device; an explicit
  ``devices=`` list may repeat a device (D shards as slices of one card).
- Each shard's state is its own `BucketTable` allocation on its device
  (rows i32[capacity + SCRATCH, W], W 4 or 6 with the insight column),
  so every kernel wrapper's layout and alignment checks hold by
  construction.
- A window is D launches of the decision-window kernel, one per shard,
  each on that shard's slice of the common padded ``[D, K, B]`` request
  stack (`MIN_PAD` lanes at least, padding invalid and absorbed by the
  shard's scratch tail), as the JAX shard_map runs the single-device
  program on each device's slice.
- Counters replace the ``psum``: the allowed / denied / expired counts
  and, with tenants armed, the ``[T, 2]`` per-tenant fold
  (``_tenant_fold`` in JAX) are summed over the shards from the outputs
  each fetch already brings to the host; the expired-hit counts ride the
  same fetch.
- The output-tier certificates (``cur_safe``, ``tol_hwm``, ``now_hwm``)
  are mesh-wide, on the ShardedBucketTable, so the w32 → cur → 4-plane
  ladder picks the tier JAX picks and the wire words agree.
- The insight top-K is mesh-global with JAX's tie order: each shard's
  stable descending sort of its deny column (`kernel.insight_topk`),
  then one more over the D×k partials in shard order, with global ids
  ``shard * capacity + slot`` (``lax.top_k`` over the ``all_gather``).

Routing: the host hashes keys to shards with CRC32 — one vectorized
numpy pass per batch (tenants.py), bit-identical to ``zlib.crc32`` —
or, with tenant affinity, by the namespace prefix's hash.  Tenants are
a first-class dimension (tenants.py): per-tenant allowed/denied
counters and per-tenant slot quotas (`STATUS_TENANT_QUOTA`).

The sharded limiter has no ``dispatch_wire_window`` (nor has JAX's):
the native driver takes the ``dispatch_many`` route for it.
"""

from __future__ import annotations

import threading
import zlib
from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.errors import InternalError
from ..native import NativeKeyMap, native_available
from ..tpu import fused
from ..tpu.kernel import (
    INS_WIDTH,
    cur_wire_safe,
    finish_cur,
    finish_w32,
    fits_w32_wire,
    insight_topk,
    pack_requests,
    unpack_deny,
    unpack_state,
)
from ..tpu.keymap import PyKeyMap
from ..tpu.limiter import (
    STATUS_TENANT_QUOTA,
    BatchResult,
    ScalarCompatMixin,
    TorchRateLimiter,
    WireBatchResult,
    _ReadyLaunch,
    has_degenerate,
    prepare_batch,
    segment_info,
    sequential_fallback,
)
from ..tpu.table import (
    BucketTable,
    HwmMarksMixin,
    _host_max_now,
    _host_max_tol,
    on_device,
    resolve_device,
    track_cur_safety,
)
from .tenants import (
    KeyTooLong,
    TenantRegistry,
    crc32_rows,
    key_matrix,
    prefix_lens,
)


def shard_of_key(key: bytes, n_shards: int) -> int:
    """Stable key→shard routing (host-side CRC32 via zlib).

    The single-key form; batches route through the vectorized numpy
    CRC32 twin (tenants.crc32_rows), pinned bit-identical."""
    return zlib.crc32(key) % n_shards


@dataclass(frozen=True)
class Mesh:
    """The shards' devices, in shard order."""

    devices: Tuple[torch.device, ...]

    @property
    def n_shards(self) -> int:
        return len(self.devices)


def make_mesh(
    n_devices: Optional[int] = None, devices=None, device="cuda"
) -> Mesh:
    """A mesh of `n_devices` shards.

    On ``cuda`` the shards are the first `n_devices` cards (all of them
    when None); fewer cards than requested raise — silently shrinking
    the mesh would give the caller fewer shards (and less capacity and
    throughput) than they provisioned for.  On ``cpu`` all shards sit on
    the one CPU device (one shard when None).  `devices` takes any
    explicit list instead, repeats allowed (D shards as slices of one
    card)."""
    if devices is not None:
        devs = tuple(resolve_device(d) for d in devices)
        if not devs:
            raise ValueError("a mesh needs at least one device")
        return Mesh(devs)
    dev = resolve_device(device)
    if dev.type == "cpu":
        return Mesh((dev,) * (1 if n_devices is None else int(n_devices)))
    have = torch.cuda.device_count()
    n = have if n_devices is None else int(n_devices)
    if have < n:
        raise ValueError(
            f"requested a {n}-device mesh but the backend exposes {have}"
        )
    return Mesh(tuple(torch.device("cuda", i) for i in range(n)))


def _to_host(tensors) -> list:
    """Numpy copies of same-shaped per-shard tensors: one device-to-host
    copy when every shard is on one device, else one per shard."""
    if len({t.device for t in tensors}) == 1:
        return list(torch.stack(tensors).cpu().numpy())
    return [t.cpu().numpy() for t in tensors]


class ShardedBucketTable(HwmMarksMixin):
    """Per-slot GCRA state, one `BucketTable` per shard of the mesh.

    ``W`` is 4, or ``kernel.INS_WIDTH`` when the table carries the
    insight tier's per-slot denied-hit counter — the row layouts of the
    single-device table, so each shard's window is the single-device
    kernel launch.  ``tenant_slots`` > 0 adds the per-lane tenant ids
    and the ``[T, 2]`` (allowed, denied) per-tenant counts to every
    window's counters.
    """

    SCRATCH = BucketTable.SCRATCH

    def __init__(
        self,
        capacity_per_shard: int,
        mesh: Mesh,
        insight: bool = False,
        tenant_slots: int = 0,
    ) -> None:
        self.mesh = mesh
        self.n_shards = mesh.n_shards
        self.capacity = capacity_per_shard
        self.insight = bool(insight)
        self.tenant_slots = int(tenant_slots)
        self.width = INS_WIDTH if self.insight else 4
        self.shards = [
            BucketTable(capacity_per_shard, device=dev, insight=self.insight)
            for dev in mesh.devices
        ]
        # The supervisor and the snapshot paths ask where the table
        # lives: shard 0's device stands for the mesh.
        self.device = self.shards[0].device
        # Mesh-global [allowed, denied] totals for the insight tier,
        # folded in from each fetched window's counters
        # (note_insight_counts), so insight_counts() is free.
        self.ins_allowed = 0
        self.ins_denied = 0
        # Cross-launch compact="cur" certificate and the w32 marks, once
        # for the whole mesh as in JAX (tpu/table.py track_cur_safety).
        self.cur_safe = True
        self.tol_hwm = 0
        self.now_hwm = 0

    # ------------------------------------------------------------------ #

    def _launch(self, packed, now_ns, with_degen, compact):
        """One window per shard: `packed` i32[D, K, B, PACK_WIDTH]
        (numpy), `now_ns` i64[K].  Returns (per-shard outputs, per-shard
        expired-hit counts), device tensors; nothing is fetched."""
        devs = self.mesh.devices
        packed_t = torch.from_numpy(packed)
        now_t = torch.from_numpy(np.ascontiguousarray(now_ns, np.int64))
        on_dev = {}
        outs, n_exp = [], []
        for d, shard in enumerate(self.shards):
            dev = devs[d]
            if dev not in on_dev:
                # One host-to-device copy of the whole stack per device.
                on_dev[dev] = (packed_t.to(dev), now_t.to(dev))
            p, nw = on_dev[dev]
            with on_device(dev):
                out, ne = fused.fused_window(
                    shard.state, p[d], nw, with_degen=with_degen,
                    compact=compact,
                )
            outs.append(out)
            n_exp.append(ne.sum())
        return outs, n_exp

    def check_many(
        self, slots, rank, is_last, emission, tolerance, quantity, valid,
        now_ns, with_degen: bool = True, compact=False,
        params_cur_safe: bool = False,
    ):
        """K stacked sub-batches per shard (``[D, K, B]`` host arrays,
        i64[K] timestamps), one launch per shard.  Returns (per-shard
        device outputs, per-shard expired-hit counts): [K, 4, B] planes,
        or [K, B] words for compact="cur" / "w32"."""
        if slots.shape[2] > self.SCRATCH:
            raise ValueError("batch exceeds scratch region")
        track_cur_safety(self, compact, params_cur_safe)
        self.note_max_tolerance(_host_max_tol(valid, tolerance))
        self.note_launch_now(_host_max_now(now_ns))
        packed = pack_requests(
            slots, rank, is_last, emission, tolerance, quantity, valid
        )
        return self._launch(packed, now_ns, with_degen, compact)

    def check_batch(
        self, slots, rank, is_last, emission, tolerance, quantity, valid,
        now_ns: int, with_degen: bool = True, compact=False,
        params_cur_safe: bool = False,
    ):
        """Stacked ``[D, B]`` per-shard batches at one timestamp: a
        K = 1 window per shard (see check_many)."""
        outs, n_exp = self.check_many(
            *(np.asarray(a)[:, None] for a in (
                slots, rank, is_last, emission, tolerance, quantity, valid,
            )),
            np.array([now_ns], np.int64), with_degen=with_degen,
            compact=compact, params_cur_safe=params_cur_safe,
        )
        return [o[0] for o in outs], n_exp

    # ---- insight tier on the mesh ------------------------------------- #

    def note_insight_counts(self, allowed: int, denied: int) -> None:
        """Fold one fetched window's mesh-summed counters into the
        insight totals (the limiter calls this under its counter lock)."""
        self.ins_allowed += allowed
        self.ins_denied += denied

    def insight_counts(self) -> tuple:
        """(allowed_total, denied_total) across the whole mesh.  Free:
        the totals ride each window's counter fetch."""
        return self.ins_allowed, self.ins_denied

    def insight_topk(self, k: int):
        """Mesh-global top-K of the denied-hit column: (counts i64[k],
        GLOBAL slot ids i32[k]) host tensors, highest first; decode ids
        as (shard, slot) = divmod(id, capacity)
        (insight.collector.ShardedSlotKeyResolver does).  Ties: the
        lower shard, then the lower slot, first (JAX's ``lax.top_k``
        over the gathered partials)."""
        if not self.insight:
            return None
        k = max(1, min(int(k), self.capacity))
        vals, gids = [], []
        for d, shard in enumerate(self.shards):
            v, idx = insight_topk(shard.state, capacity=self.capacity, k=k)
            vals.append(v.cpu())
            gids.append(idx.cpu().to(torch.int64) + d * self.capacity)
        gv, gi = torch.cat(vals), torch.cat(gids)
        top_v, pos = torch.sort(gv, descending=True, stable=True)
        return top_v[:k], gi[pos[:k]].to(torch.int32)

    def insight_decay(self) -> None:
        """Halve every shard's denied-hit counter columns."""
        for shard in self.shards:
            shard.insight_decay()

    # ------------------------------------------------------------------ #

    def sweep(self, now_ns: int) -> np.ndarray:
        """Vacate expired slots on every shard; returns bool[D, capacity]."""
        return np.stack([shard.sweep(now_ns) for shard in self.shards])

    def grow(self, new_capacity: int) -> None:
        """Every shard to `new_capacity` real rows (scratch kept last)."""
        if new_capacity <= self.capacity:
            return
        for shard in self.shards:
            shard.grow(new_capacity)
        self.capacity = new_capacity

    def host_rows(self) -> torch.Tensor:
        """i32[D, rows, W] host copy of every shard's rows (diagnostics:
        a whole-table copy, never on a serving path)."""
        return torch.stack([shard.state.cpu() for shard in self.shards])

    @property
    def tat(self) -> torch.Tensor:
        """i64[D, capacity] TAT columns (diagnostics/tests)."""
        return unpack_state(self.host_rows())[0][:, : self.capacity]

    @property
    def expiry(self) -> torch.Tensor:
        """i64[D, capacity] expiry columns (diagnostics/tests)."""
        return unpack_state(self.host_rows())[1][:, : self.capacity]

    @property
    def deny(self) -> torch.Tensor:
        """i64[D, capacity] denied-hit columns (insight tables only)."""
        return unpack_deny(self.host_rows())[:, : self.capacity]


class _PreparedWindow:
    """One host-prepared batch: routed, resolved, stacked [D, B] arrays
    plus the request-order bookkeeping fetch() needs to distribute
    per-shard results back to arrival positions."""

    __slots__ = (
        "n", "per_shard", "slots", "rank", "is_last", "em", "tol", "q",
        "vmask", "rounds", "max_burst", "status", "valid", "emission",
        "tolerance", "quantity", "tenant",
    )

    def __init__(self, **kw) -> None:
        for name in self.__slots__:
            setattr(self, name, kw[name])


def _lanes_allowed(out, w32_or_cur: bool):
    """Allowed bit of each lane of a host output, [..., B]."""
    return (out & 1) != 0 if w32_or_cur else out[..., 0, :] != 0


def _distribute(out_d, sel, dst, prep, tier, now_ns, res) -> None:
    """Write one shard's valid-lane outputs (`out_d[:m][sel]` per tier)
    into the arrival-order result columns `res` at `dst`."""
    allowed, remaining, reset_after, retry_after = res
    if tier == "w32":
        al, rem, rst, ret = finish_w32(out_d[sel])
    elif tier == "cur":
        al, rem, rst, ret = finish_cur(
            out_d[sel], prep.emission[dst], prep.tolerance[dst],
            prep.quantity[dst], now_ns,
        )
    else:
        al, rem, rst, ret = (out_d[i][sel] for i in range(4))
    allowed[dst] = al != 0
    remaining[dst] = rem
    reset_after[dst] = rst
    retry_after[dst] = ret


class _PendingShardedLaunch:
    """An in-flight mesh window; .fetch() copies the per-shard outputs
    and expired-hit counts to the host, sums the global (and
    per-tenant) counters over the shards, and distributes per-batch
    results.

    `tier` is the window's output tier: "w32" (kernel.finish_w32
    unpack), "cur" (completed per shard slice with kernel.finish_cur at
    each batch's timestamp in `now_list`), or None for the 4-plane
    output."""

    def __init__(
        self, limiter, outs, n_exp, prepared, valid_s, tenant_s, wire,
        tier=None, now_list=None,
    ) -> None:
        self._limiter = limiter
        self._outs = outs
        self._n_exp = n_exp
        self._prepared = prepared
        self._valid_s = valid_s
        self._tenant_s = tenant_s
        self._wire = wire
        self._tier = tier
        self._now_list = now_list

    def fetch(self) -> list:
        outs = _to_host(self._outs)
        n_exp = int(sum(int(x) for x in _to_host(self._n_exp)))
        self._limiter._count_window(
            outs, self._valid_s, self._tenant_s, n_exp,
            self._tier is not None,
        )
        results = []
        for j, prep in enumerate(self._prepared):
            n = prep.n
            res = (
                np.zeros(n, bool), np.zeros(n, np.int64),
                np.zeros(n, np.int64), np.zeros(n, np.int64),
            )
            for d, ix in enumerate(prep.per_shard):
                m = len(ix)
                if m == 0:
                    continue
                sel = prep.vmask[d, :m]
                out_d = outs[d][j][..., :m]
                _distribute(
                    out_d, sel, ix[sel], prep, self._tier,
                    self._now_list[j] if self._now_list else 0, res,
                )
            results.append(
                self._limiter._make_result(
                    prep.valid, prep.max_burst, prep.status, *res,
                    self._wire,
                )
            )
        return results


class ShardedTorchRateLimiter(ScalarCompatMixin):
    """Batched GCRA with the table sharded over a mesh of devices.

    Same request semantics as `tpu.limiter.TorchRateLimiter`
    (arrival-order duplicate handling, reference-exact param
    derivation); keys are routed to shards by CRC32 (one vectorized
    numpy pass per batch) and each shard's sub-batch is decided on its
    own device, one kernel launch per shard per window.

    ``insight=True`` widens the shard rows to the insight layout so the
    insight tier serves mesh deployments; ``tenants`` (a
    tenants.TenantRegistry) arms the namespace layer — tenant-affine
    routing, per-tenant counters, and per-tenant slot quotas.
    """

    MIN_PAD = 16

    def __init__(
        self,
        capacity_per_shard: int = 1 << 17,
        mesh: Optional[Mesh] = None,
        keymap="python",
        auto_grow: bool = True,
        insight: bool = False,
        tenants: Optional[TenantRegistry] = None,
    ) -> None:
        """`mesh` defaults to every card (make_mesh()).  `keymap`
        selects the per-shard host key→slot backend: "python",
        "native", "auto", or a factory callable `capacity -> keymap`."""
        self.mesh = mesh if mesh is not None else make_mesh()
        self.n_shards = self.mesh.n_shards
        self.tenants = tenants
        self.table = ShardedBucketTable(
            capacity_per_shard,
            self.mesh,
            insight=insight,
            tenant_slots=tenants.max_tenants if tenants is not None else 0,
        )
        if keymap == "auto":
            keymap = "native" if native_available() else "python"
        if keymap == "native":
            factory = NativeKeyMap
        elif keymap == "python":
            factory = PyKeyMap
        elif callable(keymap):
            factory = keymap
        else:
            raise ValueError(f"unknown keymap backend: {keymap!r}")
        self.keymaps = [factory(capacity_per_shard) for _ in range(self.n_shards)]
        self._bytes_keys = bool(getattr(self.keymaps[0], "BYTES_KEYS", False))
        self.auto_grow = auto_grow
        # Per-slot tenant attribution (i32[capacity] per shard, -1 =
        # vacant): filled at slot-ALLOCATION time, so per-request tenant
        # ids in steady state are one numpy gather, and doubles as the
        # slot-quota ledger (`_tenant_used` counts each tenant's live
        # slots per shard).
        if tenants is not None:
            self._tenant_of_slot = [
                np.full(capacity_per_shard, -1, np.int32)
                for _ in range(self.n_shards)
            ]
            self._tenant_used = [
                np.zeros(tenants.max_tenants, np.int64)
                for _ in range(self.n_shards)
            ]
        else:
            self._tenant_of_slot = None
            self._tenant_used = None
        # Mesh-global totals, updated per window.  A fetch can run on an
        # engine executor thread concurrently with a native transport's
        # decide thread, so accumulation takes its own lock.
        self.total_allowed = 0
        self.total_denied = 0
        self.total_expired_hits = 0
        self._counter_lock = threading.Lock()

    def __len__(self) -> int:
        return sum(len(km) for km in self.keymaps)

    def _bump_counters(
        self, allowed: int, denied: int, expired: int = 0, tcounts=None
    ) -> None:
        """Accumulate one window's mesh-summed counters."""
        with self._counter_lock:
            self.total_allowed += allowed
            self.total_denied += denied
            self.total_expired_hits += expired
            if self.table.insight:
                self.table.note_insight_counts(allowed, denied)
            if tcounts is not None and self.tenants is not None:
                self.tenants.add_counts(tcounts)

    def _count_window(self, outs, valid_s, tenant_s, n_exp, words) -> None:
        """The counters JAX psum-reduces, summed over the shards on the
        host from the fetched outputs: allowed and denied valid lanes,
        the expired hits, and with tenants the [T, 2] per-tenant fold.
        `words`: the outputs are the one-word tiers (allowed at bit 0)."""
        n_allowed = n_valid = 0
        T = self.table.tenant_slots
        tcounts = np.zeros((T, 2), np.int64) if T else None
        for d, out in enumerate(outs):
            valid = valid_s[d]
            allowed = _lanes_allowed(out, words) & valid
            n_allowed += int(allowed.sum())
            n_valid += int(valid.sum())
            if T:
                tid = tenant_s[d]
                tcounts[:, 0] += np.bincount(tid[allowed], minlength=T)
                tcounts[:, 1] += np.bincount(
                    tid[valid & ~allowed], minlength=T
                )
        self._bump_counters(
            n_allowed, n_valid - n_allowed, n_exp, tcounts=tcounts
        )

    def take_expired_hits(
        self, now_ns: int = 0, min_period_ns: int = 0
    ) -> int:
        """Drain the expired-hit counter for the cleanup policy.  Free:
        the counts ride each window's fetch, so both arguments exist
        only for signature parity with TorchRateLimiter."""
        with self._counter_lock:
            n = self.total_expired_hits
            self.total_expired_hits = 0
            return n

    def tenant_stats(self) -> dict:
        """Mesh-global per-tenant counters for /stats and metrics
        ({tenant: {"allowed", "denied", "quota_rejections"}}); empty
        when the tenant layer is off."""
        if self.tenants is None:
            return {}
        with self._counter_lock:
            return self.tenants.stats()

    @property
    def total_capacity(self) -> int:
        """Global slot capacity across every shard (len() is global too)."""
        return self.table.capacity * self.n_shards

    # ------------------------------------------------------------------ #

    def shard_of(self, key: bytes) -> int:
        """This limiter's key→shard routing (single-key form): the
        tenant-affine hash when armed, plain full-key CRC32 otherwise.
        Snapshot restore routes through this so restored keys land on
        the shard the serving path will look them up on."""
        reg = self.tenants
        if reg is not None and reg.affinity:
            p = key.find(reg.delim_byte)
            if p > 0:
                return zlib.crc32(key[:p]) % self.n_shards
        return shard_of_key(key, self.n_shards)

    def _route(self, bkeys, n):
        """(shard_ids i32[n], prefix_lens i64[n] or None) for a batch —
        ONE vectorized numpy CRC32 pass over the stacked key bytes
        (tenants.crc32_rows); the per-key zlib form survives only as the
        fallback for exotic hashable keys (python keymap) and oversized
        keys.  Tenant ids are resolved later, at slot-allocation time
        (_attribute_tenants)."""
        D = self.n_shards
        reg = self.tenants
        try:
            mat, lens = key_matrix(bkeys)
        except (TypeError, KeyTooLong):
            # A non-str/bytes key or an oversized one forces the per-key
            # path for THIS batch; each bytes key still routes exactly as
            # the vectorized path would (tenant affinity included).
            # Exotic keys route via hash() and live in the default
            # namespace (prefix length 0).
            shard_ids = np.fromiter(
                (
                    self.shard_of(bytes(k))
                    if isinstance(k, (bytes, bytearray))
                    else hash(k) % D
                    for k in bkeys
                ),
                np.int32,
                count=n,
            )
            plens = None
            if reg is not None:
                delim = reg.delim_byte
                plens = np.fromiter(
                    (
                        max(bytes(k).find(delim), 0)
                        if isinstance(k, (bytes, bytearray))
                        else 0
                        for k in bkeys
                    ),
                    np.int64,
                    count=n,
                )
            return shard_ids, plens
        crc = crc32_rows(mat, lens)
        if reg is None:
            return (crc % np.uint32(D)).astype(np.int32), None
        plens = prefix_lens(mat, lens, reg.delim_byte)
        if reg.affinity:
            # Tenant-affine: a namespaced key routes by its namespace
            # hash, so one tenant's keys are shard-local; bare keys keep
            # spreading by full-key hash.
            tcrc = crc32_rows(mat, plens)
            crc = np.where(plens > 0, tcrc, crc)
        return (crc % np.uint32(D)).astype(np.int32), plens

    def _grow_tenant_slots(self, new_capacity: int) -> None:
        if self._tenant_of_slot is None:
            return
        for d in range(self.n_shards):
            old = self._tenant_of_slot[d]
            if new_capacity > len(old):
                grown = np.full(new_capacity, -1, np.int32)
                grown[: len(old)] = old
                self._tenant_of_slot[d] = grown

    def _refuse_over_quota_missing(
        self, d: int, km, sl, ix, bkeys, plens, svalid
    ):
        """Quota-refuse UNRESOLVED fresh keys (table-full lanes) BEFORE
        any growth: an at-quota tenant spraying keys into a full shard
        must never force the table to grow — growth is warranted only
        when within-quota keys still need capacity.  Usage is counted
        from the ledger plus this batch's pending acceptances.  Returns
        a bool[m] rejected mask or None."""
        reg = self.tenants
        if reg.quota_frac <= 0:
            return None
        used = self._tenant_used[d]
        cap = max(int(reg.quota_frac * km.capacity), 1)
        missing = np.flatnonzero(svalid & (sl < 0))
        if not len(missing):
            return None
        pending = np.zeros_like(used)
        decided: dict = {}
        rejected = None
        for lane in missing:
            gi = ix[lane]
            key = bkeys[gi]
            acc = decided.get(key)
            if acc is None:
                p = int(plens[gi]) if plens is not None else 0
                tid = reg.tid_of(bytes(key[:p]) if p else b"")
                acc = used[tid] + pending[tid] < cap
                if acc:
                    pending[tid] += 1
                else:
                    reg.quota_rejections[tid] += 1
                decided[key] = acc
            if not acc:
                if rejected is None:
                    rejected = np.zeros(len(sl), bool)
                rejected[lane] = True
        return rejected

    def _attribute_tenants(self, d: int, km, sl, ix, bkeys, plens):
        """Per-lane tenant ids for shard d's resolved lanes, plus quota
        enforcement.  A slot allocated earlier carries its tenant id in
        the per-slot cache (one gather); only FRESH allocations pay a
        prefix extraction and registry probe — and, when a tenant would
        cross its quota in this batch, the arrival-order admission: a
        fresh key over its tenant's quota has its just-allocated slot
        freed and every lane of it rejected with STATUS_TENANT_QUOTA.
        Existing keys are never touched.

        Returns (tenant ids i32[m], rejected bool[m] mask or None)."""
        reg = self.tenants
        tos = self._tenant_of_slot[d]
        used = self._tenant_used[d]
        tids_lane = tos[np.maximum(sl, 0)].copy()
        tids_lane[sl < 0] = 0
        fresh = np.flatnonzero((sl >= 0) & (tids_lane == -1))
        if not len(fresh):
            return tids_lane, None
        # Each fresh lane's namespace (p == 0 covers bare keys and exotic
        # non-bytes keys: both live in the default namespace), probed in
        # order of first sight, the order JAX's per-lane loop registers.
        gi = ix[fresh].tolist()
        ps = plens[ix[fresh]].tolist() if plens is not None else [0] * len(gi)
        names = [bytes(bkeys[g][:p]) if p else b"" for g, p in zip(gi, ps)]
        tid_of = {name: reg.tid_of(name) for name in dict.fromkeys(names)}
        tids = np.fromiter((tid_of[n] for n in names), np.int64,
                           count=len(names))
        slots = sl[fresh]
        _, first = np.unique(slots, return_index=True)
        new = np.bincount(tids[first], minlength=len(used))
        cap = max(int(reg.quota_frac * km.capacity), 1)
        if reg.quota_frac <= 0 or bool((used + new <= cap).all()):
            tos[slots] = tids
            used += new
            tids_lane[fresh] = tids
            return tids_lane, None
        # A tenant crosses its quota in this batch: admit fresh slots in
        # arrival order.
        rejected = np.zeros(len(sl), bool)
        decided: dict = {}
        freed = []
        for lane, slot, tid in zip(fresh.tolist(), slots.tolist(),
                                   tids.tolist()):
            ok = decided.get(slot)
            if ok is None:
                ok = bool(used[tid] < cap)
                if ok:
                    used[tid] += 1
                    tos[slot] = tid
                else:
                    reg.quota_rejections[tid] += 1
                    freed.append(slot)
                decided[slot] = ok
            if ok:
                tids_lane[lane] = tid
            else:
                rejected[lane] = True
                tids_lane[lane] = 0
        if not freed:
            return tids_lane, None
        km.free_slots(np.asarray(freed, np.int64))
        return tids_lane, rejected

    def _prepare_sharded(
        self, keys, max_burst, count_per_period, period, quantity, now_ns
    ) -> _PreparedWindow:
        """Shared per-batch prologue: validate, derive params, route keys
        to shards (one vectorized hash pass), resolve per-shard slots
        (growing on full, enforcing tenant quotas), build the stacked
        [D, B] arrays + conflict rounds."""
        if now_ns < 0:
            raise ValueError("batch now_ns must be non-negative")
        n = len(keys)
        bkeys = [k.encode() if isinstance(k, str) else k for k in keys]
        max_burst, quantity, emission, tolerance, status, valid = (
            prepare_batch(n, max_burst, count_per_period, period, quantity)
        )

        D = self.n_shards
        shard_ids, plens = self._route(bkeys, n)
        # Per-shard request positions, in arrival order.
        per_shard = [np.flatnonzero(valid & (shard_ids == d)) for d in range(D)]
        width = max((len(ix) for ix in per_shard), default=0)
        B = max(self.MIN_PAD, 1 << max(width - 1, 0).bit_length())

        slots = np.zeros((D, B), np.int32)
        rank = np.zeros((D, B), np.int32)
        is_last = np.ones((D, B), bool)
        em = np.zeros((D, B), np.int64)
        tol = np.zeros((D, B), np.int64)
        q = np.zeros((D, B), np.int64)
        vmask = np.zeros((D, B), bool)
        rounds = np.zeros((D, B), np.int32)
        tenant = (
            np.zeros((D, B), np.int32) if self.table.tenant_slots else None
        )

        key_src = bkeys if self._bytes_keys else keys
        for d, ix in enumerate(per_shard):
            m = len(ix)
            if m == 0:
                continue
            skeys = [key_src[i] for i in ix]
            svalid = np.ones(m, bool)
            km = self.keymaps[d]
            sl, rk, il, n_full = km.resolve(skeys, svalid)
            while n_full:
                if self._tenant_of_slot is not None:
                    # Quota-refuse over-quota fresh keys BEFORE growing:
                    # an at-quota tenant's spray must never force a
                    # (permanent, every-shard) capacity doubling.
                    rej0 = self._refuse_over_quota_missing(
                        d, km, sl, ix, bkeys, plens, svalid
                    )
                    if rej0 is not None:
                        svalid &= ~rej0
                        status[ix[rej0]] = STATUS_TENANT_QUOTA
                        valid[ix[rej0]] = False
                        rk, il = segment_info(sl, svalid)
                        if not (svalid & (sl < 0)).any():
                            break
                if not self.auto_grow:
                    raise InternalError("bucket table full")
                new_cap = max(km.capacity * 2, 1024)
                for km2 in self.keymaps:
                    km2.grow(new_cap)
                self.table.grow(new_cap)
                self._grow_tenant_slots(new_cap)
                missing = (sl == -1) & svalid
                sl2, _, _, n_full = km.resolve(skeys, missing)
                sl = np.where(missing, sl2, sl)
                rk, il = segment_info(sl, svalid)
            if self._tenant_of_slot is not None:
                tids_lane, rejected = self._attribute_tenants(
                    d, km, sl, ix, bkeys, plens
                )
                if rejected is not None:
                    svalid &= ~rejected
                    status[ix[rejected]] = STATUS_TENANT_QUOTA
                    valid[ix[rejected]] = False
                    rk, il = segment_info(sl, svalid)
                if tenant is not None:
                    tenant[d, :m] = tids_lane
            slots[d, :m] = sl
            rank[d, :m] = rk
            is_last[d, :m] = il
            em[d, :m] = emission[ix]
            tol[d, :m] = tolerance[ix]
            q[d, :m] = quantity[ix]
            vmask[d, :m] = svalid
            # JAX assigns param_rounds whenever a slot repeats; the
            # single-device limiter's vectorized pre-check gives the
            # same rounds and runs the per-lane loop only on a real
            # mid-batch param change.
            rounds[d, :m] = TorchRateLimiter._conflict_rounds(
                sl, svalid, emission[ix], tolerance[ix], quantity[ix]
            )
        return _PreparedWindow(
            n=n, per_shard=per_shard, slots=slots, rank=rank,
            is_last=is_last, em=em, tol=tol, q=q, vmask=vmask,
            rounds=rounds, max_burst=max_burst, status=status, valid=valid,
            emission=emission, tolerance=tolerance, quantity=quantity,
            tenant=tenant,
        )

    @staticmethod
    def _make_result(valid, max_burst, status, allowed, remaining,
                     reset_after, retry_after, wire):
        fields = dict(
            allowed=allowed,
            limit=np.where(valid, max_burst, 0),
            remaining=remaining,
            status=status,
        )
        if wire:
            return WireBatchResult(
                reset_after_s=reset_after, retry_after_s=retry_after,
                **fields,
            )
        return BatchResult(
            reset_after_ns=reset_after, retry_after_ns=retry_after,
            **fields,
        )

    def rate_limit_batch(
        self,
        keys: Sequence,
        max_burst,
        count_per_period,
        period,
        quantity,
        now_ns: int,
        wire: bool = False,
    ) -> BatchResult:
        prep = self._prepare_sharded(
            keys, max_burst, count_per_period, period, quantity, now_ns
        )
        D = self.n_shards
        B = prep.slots.shape[1]
        valid, emission, tolerance, quantity = (
            prep.valid, prep.emission, prep.tolerance, prep.quantity,
        )
        degen = has_degenerate(valid, emission, tolerance, quantity)
        with_degen = not wire or degen
        # Compact output ladder, same tiers as the single-device
        # dispatch: w32 (4 B/request) → cur (8 B, host-finished) →
        # 4-plane; the mesh-wide hwm / cur_safe marks carry the
        # certificates across launches.
        params_cur_safe = cur_wire_safe(valid, tolerance, now_ns)
        use_w32 = (
            wire
            and not degen
            and fits_w32_wire(
                valid, emission, tolerance, quantity, now_ns,
                self.table.tol_hwm, self.table.now_hwm,
            )
        )
        use_cur = (
            not use_w32
            and wire
            and not degen
            and params_cur_safe
            and self.table.cur_safe
        )
        tier = "w32" if use_w32 else ("cur" if use_cur else None)

        n = prep.n
        res = (
            np.zeros(n, bool), np.zeros(n, np.int64),
            np.zeros(n, np.int64), np.zeros(n, np.int64),
        )
        n_rounds = int(prep.rounds.max()) + 1 if n else 1
        for r in range(n_rounds):
            rmask = prep.vmask & (prep.rounds == r)
            if not rmask.any():
                continue
            if n_rounds == 1:
                rk, il = prep.rank, prep.is_last
            else:
                rk = np.zeros((D, B), np.int32)
                il = np.ones((D, B), bool)
                for d in range(D):
                    rk[d], il[d] = segment_info(prep.slots[d], rmask[d])
            outs_dev, n_exp = self.table.check_batch(
                prep.slots, rk, il, prep.em, prep.tol, prep.q, rmask,
                now_ns,
                with_degen=with_degen,
                compact=tier if tier else wire,
                params_cur_safe=params_cur_safe,
            )
            outs = _to_host(outs_dev)
            self._count_window(
                [o[None] for o in outs], rmask[:, None],
                prep.tenant[:, None] if prep.tenant is not None else None,
                int(sum(int(x) for x in _to_host(n_exp))), tier is not None,
            )
            for d, ix in enumerate(prep.per_shard):
                m = len(ix)
                if m == 0:
                    continue
                sel = rmask[d, :m]
                _distribute(
                    outs[d][..., :m], sel, ix[sel], prep, tier, now_ns, res
                )

        return self._make_result(
            valid, prep.max_burst, prep.status, *res, wire,
        )

    # ------------------------------------------------------------------ #

    def rate_limit_many(self, batches, wire: bool = False) -> list:
        """Decide K whole batches in ONE mesh window (one launch per
        shard).  Same contract as TorchRateLimiter.rate_limit_many:
        `batches` is a list of (keys, max_burst, count_per_period,
        period, quantity, now_ns) tuples in arrival order; each
        sub-batch sees the sharded table state left by the previous one.
        Batches whose keys change parameters mid-batch fall back to the
        sequential per-batch path (rare; exactness beats speed)."""
        return self.dispatch_many(batches, wire=wire).fetch()

    def dispatch_many(self, batches, wire: bool = False):
        """The dispatch half of rate_limit_many: host-prepare and launch
        the window, return a handle whose .fetch() waits for results —
        so the engine's flush loop can assemble window N+1 while the
        card executes window N."""
        if not batches:
            return _ReadyLaunch([])

        prepared = []
        width = self.MIN_PAD
        any_degen = False
        fallback = False
        # Prep mutates tenant-quota state: slot resolution and tenant
        # attribution are idempotent under re-prepare, but the rejection
        # COUNTER is not — snapshot it so the sequential fallback's
        # re-prepare cannot double-count refusals.
        reg = self.tenants
        rej_snapshot = (
            reg.quota_rejections.copy() if reg is not None else None
        )
        for b in batches:
            prep = self._prepare_sharded(*b)
            if prep.rounds.any():
                fallback = True
                break
            any_degen = any_degen or has_degenerate(
                prep.valid, prep.emission, prep.tolerance, prep.quantity
            )
            prepared.append(prep)
            width = max(width, prep.slots.shape[1])
        if fallback:
            # No device writes happened yet, and prep's host mutations
            # are idempotent once the rejection counters are rolled back.
            if rej_snapshot is not None:
                reg.quota_rejections[:] = rej_snapshot
            return _ReadyLaunch(
                sequential_fallback(
                    batches, self.rate_limit_batch,
                    TorchRateLimiter._error_result, wire,
                )
            )

        D = self.n_shards
        K = len(prepared)
        K_pad = 1 << (K - 1).bit_length()
        shape = (D, K_pad, width)
        slots_s = np.zeros(shape, np.int32)
        rank_s = np.zeros(shape, np.int32)
        last_s = np.ones(shape, bool)
        em_s = np.zeros(shape, np.int64)
        tol_s = np.zeros(shape, np.int64)
        q_s = np.zeros(shape, np.int64)
        valid_s = np.zeros(shape, bool)
        tenant_s = (
            np.zeros(shape, np.int32) if self.table.tenant_slots else None
        )
        now_s = np.full(K_pad, batches[-1][5], np.int64)
        for j, prep in enumerate(prepared):
            Bj = prep.slots.shape[1]
            slots_s[:, j, :Bj] = prep.slots
            rank_s[:, j, :Bj] = prep.rank
            last_s[:, j, :Bj] = prep.is_last
            em_s[:, j, :Bj] = prep.em
            tol_s[:, j, :Bj] = prep.tol
            q_s[:, j, :Bj] = prep.q
            valid_s[:, j, :Bj] = prep.vmask
            if tenant_s is not None and prep.tenant is not None:
                tenant_s[:, j, :Bj] = prep.tenant
            now_s[j] = batches[j][5]

        # Compact output ladder (w32 → cur → 4-plane), same certificates
        # as the single-device dispatch paths; host-finished in fetch().
        now_max = int(now_s.max(initial=0))
        params_cur_safe = cur_wire_safe(valid_s, tol_s, now_max)
        use_w32 = (
            wire
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
        tier = "w32" if use_w32 else ("cur" if use_cur else None)
        outs, n_exp = self.table.check_many(
            slots_s, rank_s, last_s, em_s, tol_s, q_s, valid_s, now_s,
            with_degen=not wire or any_degen,
            compact=tier if tier else wire,
            params_cur_safe=params_cur_safe,
        )
        return _PendingShardedLaunch(
            self, outs, n_exp, prepared, valid_s, tenant_s, wire,
            tier=tier,
            now_list=[int(b[5]) for b in batches] if use_cur else None,
        )

    # ------------------------------------------------------------------ #

    def sweep(self, now_ns: int) -> int:
        """Sweep every shard; returns total slots freed."""
        expired = self.table.sweep(now_ns)
        freed = 0
        for d in range(self.n_shards):
            idx = np.flatnonzero(expired[d])
            freed += self.keymaps[d].free_slots(idx)
            if self._tenant_of_slot is not None and len(idx):
                # Release quota attribution for the vacated slots.
                tos = self._tenant_of_slot[d]
                tids = tos[idx]
                live = tids >= 0
                if live.any():
                    self._tenant_used[d] -= np.bincount(
                        tids[live],
                        minlength=self.tenants.max_tenants,
                    )
                    tos[idx[live]] = -1
        return freed
