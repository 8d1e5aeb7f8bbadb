"""Device-state snapshot / restore, with the rows moved by the row kernels.

The port of `throttlecrab_tpu/tpu/snapshot.py`, for the single-device
limiter and the sharded mesh.  The file format is the JAX package's,
field for field (`FORMAT_VERSION` 2: the per-key `shard` column,
`n_shards`, length-prefixed keys, the per-key codec and
`source_bytes_keys`), so a file saved by either package loads in the
other.

Export gathers the table's rows at the live slots with
`row_ops.row_gather` (the CUDA kernel on a card, `index_select` on the
CPU), in chunks of at most `row_ops.MAX_BATCH` rows, fetches them to the
host once and joins the i64 tat/expiry there.  Restore allocates slots
through the keymap, packs the rows on the table's device and writes them
with `row_ops.row_scatter`, chunked the same way.  On the mesh each
shard's rows move this way on that shard's own table, ceil(n_d /
MAX_BATCH) launches per shard (the JAX package copies the whole
[D, rows, W] table through the host instead), and restored keys route
through the target limiter's own `shard_of` (tenant affinity included),
so a snapshot of D shards restores onto any shard count.

Snapshots are best-effort soft state: keys whose TTL lapsed between
snapshot and restore are dropped, so a stale snapshot degrades to an
empty table, never to wrong decisions.

A ClusterLimiter (parallel/cluster.py) exports, saves and restores its
local node; the cluster's migrations, leaves and takeovers move their
rows through :func:`export_state` and :func:`_bulk_insert` too.

The launch supervisor (server/supervisor.py) uses both halves: a degrade
seeds its host oracle from :func:`export_state` (the gathers), and a
re-promotion writes the host-mutated buckets back with
:func:`_bulk_insert` (the scatters).  The file I/O carries the
"snapshot" fault site (faults/) where the JAX package has it.
"""

from __future__ import annotations

import json
import os
import zipfile
import zlib
from pathlib import Path
from typing import Union

import numpy as np
import torch

from ..faults import fsync_with_faults, maybe_fail
from . import row_ops
from .kernel import pack_state
from .limiter import limiter_uses_bytes_keys
from .table import on_device, tats_cur_safe

FORMAT_VERSION = 2  # v2 adds the per-key `shard` column (v1 loads fine)

_U32 = (1 << 32) - 1


class SnapshotError(ValueError):
    """A snapshot file is corrupt, truncated, or otherwise unreadable.

    Subclasses ValueError; the boot path (server/__main__.py) catches it
    to apply the THROTTLECRAB_SNAPSHOT_STRICT policy."""


def _encode_keys(keys):
    """keys -> (key bytes, per-key is_bytes flag, per-key codec)."""
    if all(type(k) is bytes for k in keys):  # a native keymap's export
        return list(keys), [True] * len(keys), [0] * len(keys)
    out = []
    key_is_bytes = []
    key_codec = []  # 0 = surrogateescape, 1 = surrogatepass
    for key in keys:
        is_b = isinstance(key, (bytes, bytearray))
        key_is_bytes.append(is_b)
        if is_b:
            out.append(bytes(key))
            key_codec.append(0)
        else:
            # surrogateescape round-trips keys decoded from raw bytes;
            # lone surrogates outside U+DC80-DCFF (JSON can deliver them)
            # need surrogatepass, recorded per key so restore reverses it.
            try:
                out.append(str(key).encode("utf-8", "surrogateescape"))
                key_codec.append(0)
            except UnicodeEncodeError:
                out.append(str(key).encode("utf-8", "surrogatepass"))
                key_codec.append(1)
    return out, key_is_bytes, key_codec


def _chunks(n: int):
    for lo in range(0, n, row_ops.MAX_BATCH):
        yield lo, min(lo + row_ops.MAX_BATCH, n)


def gather_rows(table, slots) -> np.ndarray:
    """The table's packed rows at `slots` (i64[n], live slots), fetched
    to the host once: ceil(n / MAX_BATCH) `row_gather` launches."""
    idx = torch.from_numpy(np.asarray(slots, np.int32)).to(table.device)
    with on_device(table.device):
        parts = [
            row_ops.row_gather(table.state, idx[lo:hi])
            for lo, hi in _chunks(len(slots))
        ]
    return torch.cat(parts).cpu().numpy()


def scatter_rows(table, slots, rows) -> None:
    """table.state[slots] = rows in place, `slots` unique: ceil(n /
    MAX_BATCH) `row_scatter` launches."""
    idx = torch.from_numpy(np.asarray(slots, np.int32)).to(table.device)
    with on_device(table.device):
        for lo, hi in _chunks(len(slots)):
            row_ops.row_scatter(table.state, idx[lo:hi], rows[lo:hi])


def _join_cols(rows):
    """Packed i32[n, W] rows -> (tat i64[n], expiry i64[n])."""
    tat = (rows[:, 1].astype(np.int64) << 32) | (
        rows[:, 0].astype(np.int64) & _U32
    )
    expiry = (rows[:, 3].astype(np.int64) << 32) | (
        rows[:, 2].astype(np.int64) & _U32
    )
    return tat, expiry


def export_state(limiter):
    """Fetch the limiter's live state host-side, without encoding it.

    Returns ``(keys, slots, shard, tat, expiry, capacity, n_shards)``:
    the key objects as the keymap holds them (str or bytes) plus i64
    tat/expiry columns.  A sharded limiter lists its shards in order,
    each key with its shard; a single-device one has `shard` all zero
    and `n_shards` 1.

    A degraded SupervisedLimiter exports its host oracle's state (the
    device copy is stale once the oracle takes over; slots are -1);
    otherwise the wrapped limiter's table is gathered.  A ClusterLimiter
    exports its local node."""
    local = getattr(limiter, "local", None)
    if local is not None:  # ClusterLimiter
        return export_state(local)
    degraded = getattr(limiter, "export_degraded_state", None)
    if degraded is not None:  # SupervisedLimiter
        host = degraded()
        if host is not None:
            keys, tats, exps = host
            n = len(keys)
            return (
                list(keys),
                np.full(n, -1, np.int64),
                np.zeros(n, np.int32),
                np.asarray(tats, np.int64),
                np.asarray(exps, np.int64),
                int(getattr(limiter, "total_capacity", 1 << 62)),
                1,
            )
        limiter = limiter.inner
    if hasattr(limiter, "keymaps"):  # ShardedTorchRateLimiter
        tables = limiter.table.shards
        per_shard = [km.items() for km in limiter.keymaps]
    else:
        tables = [limiter.table]
        per_shard = [limiter.keymap.items()]
    keys = [k for p in per_shard for k, _ in p]
    slots = np.asarray([s for p in per_shard for _, s in p], np.int64)
    shard = np.asarray(
        [d for d, p in enumerate(per_shard) for _ in p], np.int32
    )
    rows = [
        gather_rows(table, [s for _, s in p])
        for table, p in zip(tables, per_shard)
        if p
    ]
    tat, expiry = _join_cols(
        np.concatenate(rows) if rows else np.zeros((0, 4), np.int32)
    )
    return (
        keys, slots, shard, tat, expiry, limiter.table.capacity,
        len(tables),
    )


def translate_key(
    raw: bytes,
    is_bytes: bool,
    codec: int,
    source_bytes_keys: bool,
    target_bytes_keys: bool,
):
    """Cross-backend key identity translation for restores.

    str-keyed transports look keys up as str, bytes-keyed (native)
    keymaps as bytes.  A snapshot from a native keymap marks everything
    bytes even though the transports used str: restoring it into a
    python keymap decodes back to str (surrogateescape, lossless for
    arbitrary bytes) or the restored buckets would be unreachable."""
    if target_bytes_keys:
        return raw  # native keymaps hold bytes; str lookups encode
    if source_bytes_keys and is_bytes:
        return raw.decode("utf-8", "surrogateescape")
    if is_bytes:
        return raw  # genuinely-bytes key in a str keymap: keep as-is
    return raw.decode(
        "utf-8", "surrogatepass" if codec else "surrogateescape"
    )


def fsync_dir(path: Union[str, Path]) -> None:
    """fsync a directory so a just-renamed entry survives power loss
    (best-effort: a filesystem that refuses it does not fail the save)."""
    try:
        fd = os.open(str(path), os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def _normalize(path: Union[str, Path]) -> Path:
    """np.savez_compressed appends .npz to suffix-less paths; normalize
    both save and load so `--snapshot-path /data/state` round-trips."""
    path = Path(path)
    if path.suffix != ".npz":
        path = Path(str(path) + ".npz")
    return path


def export_snapshot_payload(limiter) -> dict:
    """The device half of :func:`save_snapshot`: the row gather and the
    keymap walk, no encoding and no file I/O, so it is the one part of a
    snapshot that belongs under the limiter lock.  Hand the payload to
    :func:`write_snapshot_payload` outside the lock."""
    local = getattr(limiter, "local", None)
    if local is not None:  # ClusterLimiter
        return export_snapshot_payload(local)
    raw_keys, slots, shard, tat, expiry, capacity, n_shards = (
        export_state(limiter)
    )
    return {
        "keys": raw_keys,
        "slots": slots,
        "shard": shard,
        "tat": tat,
        "expiry": expiry,
        "capacity": capacity,
        "n_shards": n_shards,
        # A bytes-keyed (native) keymap stores every key as bytes even
        # when the transports spoke str; the restore translates.
        "source_bytes_keys": limiter_uses_bytes_keys(limiter),
    }


def write_snapshot_payload(payload: dict, path: Union[str, Path]) -> int:
    """Encode, compress and durably write an exported payload to `path`;
    returns #keys written.  The tmp file is fsynced before the rename and
    the parent directory after it, so a crash after a save cannot surface
    an empty or torn file, and a failed write leaves the previous file."""
    path = _normalize(path)
    keys, key_is_bytes, key_codec = _encode_keys(payload["keys"])
    # Length-prefixed layout (offsets[n+1] + blob): binary-safe for keys
    # containing any byte, including NUL.
    offsets = np.zeros(len(keys) + 1, np.int64)
    if keys:
        np.cumsum([len(k) for k in keys], out=offsets[1:])
    key_blob = b"".join(keys)
    maybe_fail("snapshot")
    tmp = path.with_name(path.name + ".tmp")
    try:
        with open(tmp, "wb") as f:
            np.savez_compressed(
                f,
                version=np.int64(FORMAT_VERSION),
                capacity=np.int64(payload["capacity"]),
                slots=payload["slots"],
                shard=payload["shard"],
                n_shards=np.int64(payload["n_shards"]),
                tat=payload["tat"],
                expiry=payload["expiry"],
                key_offsets=offsets,
                key_blob=np.frombuffer(key_blob, np.uint8),
                key_is_bytes=np.asarray(key_is_bytes, np.uint8),
                key_codec=np.asarray(key_codec, np.uint8),
                source_bytes_keys=np.uint8(payload["source_bytes_keys"]),
                meta=np.frombuffer(
                    json.dumps({"n_keys": len(keys)}).encode(), np.uint8
                ),
            )
            f.flush()
            fsync_with_faults("snapshot", f.fileno())
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise
    os.replace(tmp, path)
    fsync_dir(path.parent)
    return len(keys)


def save_snapshot(limiter, path: Union[str, Path]) -> int:
    """Write the limiter's live state to `path` (.npz); returns #keys
    saved.  Callers holding the limiter lock run the two halves
    (:func:`export_snapshot_payload`, :func:`write_snapshot_payload`)
    separately, so compression and fsync happen outside it."""
    return write_snapshot_payload(export_snapshot_payload(limiter), path)


def load_snapshot(
    limiter, path: Union[str, Path], now_ns: int, front=None
) -> int:
    """Restore a snapshot into an empty limiter; returns #keys restored.

    Entries already expired at `now_ns` are skipped (the TTL contract
    holds across restarts).  `front` (an optional front.FrontTier) is
    fully invalidated: the restore rewrites bucket state out from under
    any cached denials.  Every corruption of the file surfaces as
    SnapshotError.  A ClusterLimiter restores into its local node (each
    node pairs with its own snapshot file)."""
    local = getattr(limiter, "local", None)
    if local is not None:  # ClusterLimiter
        return load_snapshot(local, path, now_ns, front=front)
    if front is not None:
        front.on_restore()
    if len(limiter) != 0:
        raise ValueError("restore requires an empty limiter")
    path = _normalize(path)
    maybe_fail("snapshot")
    # A truncated npz raises BadZipFile/EOFError/zlib.error depending on
    # where the cut landed, a damaged member ValueError, a missing
    # column KeyError: all become one SnapshotError.
    try:
        with np.load(path) as data:
            version = int(data["version"])
            if version not in (1, FORMAT_VERSION):
                raise SnapshotError(
                    f"unsupported snapshot version {version}"
                )
            tat = data["tat"]
            expiry = data["expiry"]
            offsets = data["key_offsets"]
            key_blob = data["key_blob"].tobytes()
            key_is_bytes = data["key_is_bytes"].astype(bool)
            key_codec = (
                data["key_codec"].astype(np.uint8)
                if "key_codec" in data
                else np.zeros(len(key_is_bytes), np.uint8)
            )
            source_bytes_keys = (
                bool(data["source_bytes_keys"])
                if "source_bytes_keys" in data
                else False
            )
            meta = json.loads(data["meta"].tobytes())
    except SnapshotError:
        raise
    except (
        OSError,
        KeyError,
        ValueError,
        EOFError,
        zipfile.BadZipFile,
        zlib.error,
        json.JSONDecodeError,
    ) as e:
        raise SnapshotError(
            f"corrupt or unreadable snapshot {path}: {e}"
        ) from e

    n = len(offsets) - 1
    if (
        n < 0
        or meta.get("n_keys") != n
        or len(tat) != n
        or len(expiry) != n
        or len(key_is_bytes) != n
        or len(key_codec) != n
    ):
        raise SnapshotError("corrupt snapshot: array lengths disagree")
    if n and (
        int(offsets[0]) != 0
        or bool((np.diff(offsets) < 0).any())
        or int(offsets[-1]) != len(key_blob)
    ):
        raise SnapshotError("corrupt snapshot: key offsets inconsistent")

    target_bytes_keys = limiter_uses_bytes_keys(limiter)
    live = np.flatnonzero(expiry > now_ns).tolist()
    bounds = offsets.tolist()
    if target_bytes_keys:  # translate_key returns the raw bytes
        keys = [key_blob[bounds[i]:bounds[i + 1]] for i in live]
    else:
        keys = [
            translate_key(
                key_blob[bounds[i]:bounds[i + 1]],
                bool(key_is_bytes[i]),
                int(key_codec[i]),
                source_bytes_keys,
                target_bytes_keys,
            )
            for i in live
        ]
    if not keys:
        return 0
    return _bulk_insert(
        limiter, keys, tat[live].astype(np.int64),
        expiry[live].astype(np.int64),
    )


def _reattribute_tenants(limiter) -> None:
    """Rebuild a sharded limiter's per-tenant slot-quota bookkeeping
    after a bulk restore (no-op without the tenant layer): restored
    slots were allocated behind the prepare path's back, and an
    unattributed live slot would otherwise be mistaken for a fresh
    allocation — and could be quota-refused and freed, losing its
    restored state — on its first touch after the restore."""
    tos_list = getattr(limiter, "_tenant_of_slot", None)
    if tos_list is None:
        return
    reg = limiter.tenants
    delim = reg.delim_byte
    for d, km in enumerate(limiter.keymaps):
        tos = tos_list[d]
        used = limiter._tenant_used[d]
        tos[:] = -1
        used[:] = 0
        items = km.items()
        kbs = [
            k if isinstance(k, bytes)
            else str(k).encode("utf-8", "surrogateescape")
            for k, _ in items
        ]
        names = [kb[:p] if (p := kb.find(delim)) > 0 else b"" for kb in kbs]
        # Registry probes in keymap order of first sight, as JAX's
        # per-key loop registers them; repeats reuse the answer.
        tid = {name: reg.tid_of(name) for name in dict.fromkeys(names)}
        tids = np.fromiter((tid[name] for name in names), np.int64,
                           count=len(names))
        slots = np.fromiter((s for _, s in items), np.int64,
                            count=len(items))
        ok = (slots >= 0) & (slots < len(tos))
        tos[slots[ok]] = tids[ok]
        used += np.bincount(tids[ok], minlength=len(used))


def _insert_rows(table, keymap, keys, tat_arr, exp_arr) -> None:
    """Allocate `keymap` slots for `keys` and scatter their packed rows
    into `table` (one device's table)."""
    if getattr(keymap, "BYTES_KEYS", False):
        key_src = [
            k if isinstance(k, bytes) else k.encode("utf-8", "surrogateescape")
            for k in keys
        ]
    else:
        key_src = keys  # original identity preserved (str stays str)
    slots, _, _, n_full = keymap.resolve(key_src, np.ones(len(keys), bool))
    if n_full:
        raise ValueError("snapshot exceeds limiter capacity")
    # Two keys can resolve to one slot ("a" and b"a" both become b"a" in
    # a native keymap).  The JAX restore's `.at[slots].set(rows)` keeps
    # the last; row_scatter needs unique slots, so keep the last here.
    slots = np.asarray(slots, np.int64)
    _, first_rev = np.unique(slots[::-1], return_index=True)
    keep = np.sort(len(slots) - 1 - first_rev)
    dev = table.device
    rows = pack_state(
        torch.from_numpy(tat_arr[keep]).to(dev),
        torch.from_numpy(exp_arr[keep]).to(dev),
    )
    width = table.state.shape[-1]
    if width > rows.shape[-1]:
        # Insight-widened rows: restored keys start with a cold
        # denied-hit counter.
        rows = torch.cat(
            [rows, rows.new_zeros((len(keep), width - rows.shape[-1]))],
            dim=-1,
        )
    scatter_rows(table, slots[keep], rows.contiguous())


def _route_restored(limiter, keys):
    """Shard of each restored key under `limiter`'s own routing
    (`_route`, the serving path's vectorized twin of `shard_of`, tenant
    affinity included), or -1 for a str key that cannot be encoded: the
    sharded decide path strict-encodes keys the same way, so it could
    never serve such a key, and one odd key must not lose the whole
    snapshot."""
    bkeys = []
    for k in keys:
        if isinstance(k, bytes):
            bkeys.append(k)
            continue
        try:
            bkeys.append(str(k).encode())
        except UnicodeEncodeError:
            bkeys.append(None)
    shard = np.full(len(keys), -1, np.int32)
    ok = np.flatnonzero([b is not None for b in bkeys])
    for lo, hi in _chunks(len(ok)):
        part = [bkeys[i] for i in ok[lo:hi]]
        shard[ok[lo:hi]] = limiter._route(part, len(part))[0]
    return shard


def _bulk_insert(limiter, keys, tats, expiries) -> int:
    """Allocate slots for `keys` and write their state rows; returns the
    number of keys inserted (duplicates included, as the JAX package
    counts them).  `tats` / `expiries` are any i64 sequences (the
    supervisor's re-promotion hands over lists).

    A sharded target re-routes every key through its own key→shard hash
    (a snapshot's shard column is advisory only), so a D-shard snapshot
    restores onto any shard count; each shard's rows are scattered on
    that shard's table."""
    tat_arr = np.asarray(tats, np.int64)
    exp_arr = np.asarray(expiries, np.int64)
    table = limiter.table
    # Restored TATs are foreign state: the compact="cur" certificate
    # survives only if every one sits in the proven-safe range.
    if not tats_cur_safe(tat_arr):
        table.cur_safe = False
    # The w32 certificate's tolerance mark must cover restored state:
    # each entry's write-time tolerance is expiry - tat.  That difference
    # can wrap i64 for pathological foreign entries, so it is probed in
    # f64 first and anything at or beyond 2^61 saturates the mark.
    diff_f = exp_arr.astype(np.float64) - tat_arr.astype(np.float64)
    sat = (exp_arr >= (1 << 62)) | (diff_f >= float(1 << 61))
    if bool(sat.any()):
        table.note_max_tolerance(None)
    else:
        table.note_max_tolerance(int((exp_arr - tat_arr).max(initial=0)))  # inv: allow(i64-raw-op)
    # Restored TATs embed the writer's clock (tat <= writer_now + tol):
    # seeding now_hwm with the max restored TAT keeps stored <= now_hwm
    # + tol_hwm, so w32 stays off until this clock catches up.
    restored_tat = int(tat_arr.max(initial=0))
    table.note_launch_now(restored_tat if restored_tat < (1 << 62) else None)

    if not hasattr(limiter, "keymaps"):
        _insert_rows(table, limiter.keymap, keys, tat_arr, exp_arr)
        return len(keys)
    shard = _route_restored(limiter, keys)
    for d, km in enumerate(limiter.keymaps):
        ix = np.flatnonzero(shard == d)
        if len(ix):
            _insert_rows(
                table.shards[d], km, [keys[i] for i in ix],
                tat_arr[ix], exp_arr[ix],
            )
    _reattribute_tenants(limiter)
    return int((shard >= 0).sum())
