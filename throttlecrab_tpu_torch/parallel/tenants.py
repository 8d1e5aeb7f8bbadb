"""Tenant/namespace layer for the sharded mesh limiter.

The port's copy of `throttlecrab_tpu/parallel/tenants.py` (numpy only).
Multi-tenant serving treats the key namespace — the prefix before the
first delimiter, ``"tenantA:user:42"`` → ``b"tenantA"`` — as a
first-class routing and isolation dimension.  Three concerns live here:

  * **routing** — a vectorized CRC32 (bit-identical to ``zlib.crc32``,
    the hash ``shard_of_key`` uses) over the whole batch in one numpy
    pass instead of a per-key Python loop, plus the tenant-prefix
    variant that makes a tenant's keys shard-local
    (``THROTTLECRAB_TENANT_AFFINITY``);
  * **identity** — a bounded tenant registry mapping namespace bytes to
    dense tenant ids; ids index the per-tenant counters each window
    folds, so ``/stats`` and metrics get mesh-global per-tenant totals.
    Tenants past the bound share the overflow bucket (id 0) rather
    than growing without limit;
  * **isolation** — per-tenant slot-capacity quotas: a tenant may hold
    at most ``quota_frac × capacity_per_shard`` bucket slots per
    shard, so one abusive tenant spraying fresh keys cannot fill the
    table (or force growth) and starve every other tenant's slot
    allocation.  Requests that would need a NEW slot for an at-quota
    tenant are refused with ``STATUS_TENANT_QUOTA``; the tenant's
    existing keys keep deciding normally.

Keys without the delimiter belong to the default namespace (the empty
prefix), which is registered and quota'd like any other tenant.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

#: Display name of the shared bucket for tenants past the registry
#: bound (dense id 0).
OVERFLOW_TENANT = "~overflow"

#: Display name of the delimiter-less default namespace.
DEFAULT_TENANT = "(default)"


def _build_crc_table() -> np.ndarray:
    """The standard CRC-32 (IEEE 802.3, poly 0xEDB88320) byte table —
    the same polynomial zlib uses, so the vectorized form below is
    bit-identical to ``zlib.crc32``."""
    t = np.arange(256, dtype=np.uint32)
    for _ in range(8):
        t = np.where(t & 1, np.uint32(0xEDB88320) ^ (t >> 1), t >> 1)
    return t


_CRC_TABLE = _build_crc_table()
_U32_ONES = np.uint32(0xFFFFFFFF)


#: Longest key the batched routing matrix will carry: the matrix costs
#: O(n × longest key), so ONE megabyte-scale key must not inflate a
#: whole 4096-request batch's routing into a multi-GB allocation (the
#: per-key zlib fallback is O(its own bytes) and exact).
MATRIX_MAX_KEY = 1024


class KeyTooLong(ValueError):
    """A key exceeds MATRIX_MAX_KEY; route the batch per-key instead."""


def key_matrix(bkeys) -> Tuple[np.ndarray, np.ndarray]:
    """Bytes keys → (u8[n, L] zero-padded matrix, i64[n] lengths).

    One C-level ``b"".join`` + one masked assignment; raises TypeError
    when any element is not bytes-like and KeyTooLong past
    MATRIX_MAX_KEY (callers fall back to the per-key path either way).
    """
    n = len(bkeys)
    lens = np.fromiter(map(len, bkeys), np.int64, count=n)
    L = int(lens.max(initial=0))
    if L > MATRIX_MAX_KEY:
        raise KeyTooLong(
            f"key of {L} bytes exceeds the {MATRIX_MAX_KEY}-byte "
            "routing-matrix bound"
        )
    mat = np.zeros((n, max(L, 1)), np.uint8)
    if L:
        flat = np.frombuffer(b"".join(bkeys), np.uint8)
        # Row-major boolean assignment consumes `flat` in exactly the
        # concatenation order, so each row gets its own key's bytes.
        mat[np.arange(L)[None, :] < lens[:, None]] = flat
    return mat, lens


def crc32_rows(mat: np.ndarray, lens: np.ndarray) -> np.ndarray:
    """zlib.crc32 of each row's first ``lens[i]`` bytes, vectorized.

    One table-lookup pass per byte COLUMN (max key length), each O(n)
    in numpy — the whole batch hashes in L array ops instead of n
    Python-level calls.  Bit-identical to ``zlib.crc32`` (pinned by
    tests/test_torch_tenants.py).
    """
    crc = np.full(mat.shape[0], _U32_ONES, np.uint32)
    L = int(lens.max(initial=0))
    for j in range(L):
        active = lens > j
        nxt = _CRC_TABLE[(crc ^ mat[:, j]) & np.uint32(0xFF)] ^ (crc >> 8)
        crc = np.where(active, nxt, crc)
    return crc ^ _U32_ONES


def prefix_lens(
    mat: np.ndarray, lens: np.ndarray, delim_byte: int
) -> np.ndarray:
    """Per-row byte length of the namespace prefix: the offset of the
    first delimiter byte, or 0 (the default namespace) when the key
    has none."""
    inside = np.arange(mat.shape[1])[None, :] < lens[:, None]
    hit = (mat == np.uint8(delim_byte)) & inside
    return np.where(hit.any(axis=1), hit.argmax(axis=1), 0).astype(np.int64)


class TenantRegistry:
    """Bounded namespace → dense-tenant-id registry plus the host half
    of the per-tenant accounting (counter accumulation, quota state).

    Thread-safety: mutation happens on the limiter's prepare path and
    the counter-accumulation path; the limiter serializes both under
    its own locks, so this class carries no lock of its own.
    """

    def __init__(
        self,
        max_tenants: int = 64,
        delim: str = ":",
        quota_frac: float = 0.0,
        affinity: bool = False,
    ) -> None:
        if max_tenants < 2:
            raise ValueError(
                "tenant registry needs max_tenants >= 2 "
                "(id 0 is the overflow bucket)"
            )
        if not delim or len(delim.encode()) != 1:
            raise ValueError("tenant delimiter must be one byte")
        if not 0.0 <= quota_frac <= 1.0:
            raise ValueError("tenant quota fraction must be in [0, 1]")
        self.max_tenants = int(max_tenants)
        self.delim = delim
        self.delim_byte = delim.encode()[0]
        self.quota_frac = float(quota_frac)
        self.affinity = bool(affinity)
        self._tids: dict = {}
        self._names: List[str] = [OVERFLOW_TENANT]
        # Mesh-global [T, 2] (allowed, denied) totals, accumulated from
        # each window's per-tenant counters, summed over the shards.
        self.counts = np.zeros((self.max_tenants, 2), np.int64)
        # New-slot requests refused by the per-tenant capacity quota.
        self.quota_rejections = np.zeros(self.max_tenants, np.int64)

    def __len__(self) -> int:
        return len(self._names)

    def tid_of(self, tenant: bytes) -> int:
        """Dense id for a namespace, registering on first sight;
        namespaces past the bound collapse into the overflow bucket."""
        tid = self._tids.get(tenant)
        if tid is not None:
            return tid
        if len(self._names) >= self.max_tenants:
            return 0
        tid = len(self._names)
        self._tids[tenant] = tid
        self._names.append(
            DEFAULT_TENANT
            if tenant == b""
            else tenant.decode("utf-8", "replace")[:64]
        )
        return tid

    def add_counts(self, tcounts: np.ndarray) -> None:
        """Fold one window's mesh-summed [T, 2] per-tenant counters in
        (called under the limiter's counter lock)."""
        self.counts += np.asarray(tcounts, np.int64)

    def stats(self) -> dict:
        """{tenant: {"allowed", "denied", "quota_rejections"}} for
        every tenant with any activity, /stats- and metrics-ready."""
        out = {}
        for tid, name in enumerate(self._names):
            allowed = int(self.counts[tid, 0])
            denied = int(self.counts[tid, 1])
            rejected = int(self.quota_rejections[tid])
            if allowed or denied or rejected:
                out[name] = {
                    "allowed": allowed,
                    "denied": denied,
                    "quota_rejections": rejected,
                }
        return out
