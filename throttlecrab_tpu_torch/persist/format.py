"""Checkpoint file format: CRC-framed columnar state, torn-write safe.

The port's copy of `throttlecrab_tpu/persist/format.py`: the same bytes
for the same rows.

One checkpoint file is one generation — either a ``base`` (the full
live table) or a ``delta`` (only the slots dirtied since the previous
generation).  The frame is designed so that *any* torn write — a
prefix of the file, a hole, a bit flip — is detected on read and
surfaces as one typed :class:`CheckpointCorrupt`, never as silently
wrong restored state:

    MAGIC(4) | crc32(body) u32 | len(body) u64 | body
    body = header_len u32 | header JSON | key_offsets i64[n+1]
         | key_blob | key_is_bytes u8[n] | key_codec u8[n]
         | tat i64[n] | expiry i64[n]

The CRC covers the whole body (header included), and the length field
catches truncation even in the astronomically unlikely case a torn
prefix CRC-matches.  Columns reuse the snapshot encoding
(tpu/snapshot.py `_encode_keys` / `translate_key`) so the two
persistence formats cannot drift in key-identity semantics.

The manifest (``MANIFEST.json``) names the retained generation chains
newest-first; it is advisory — recovery falls back to a directory scan
when it is missing, torn, or stale (see persist/recovery.py).

All writes here are durable, not just atomic: payload fsync (through
the ``snapshot`` fault site's :func:`fsync_with_faults` chokepoint)
before the rename, directory fsync after.  An injected ``truncate``
fault promotes the torn tmp file into the *final* path before raising
— modeling the ext4/xfs crash shape where the rename is journaled
before the data blocks land — so chaos tests exercise recovery against
genuinely torn files, not just cleanly missing ones.
"""

from __future__ import annotations

import json
import os
import struct
import zlib
from dataclasses import dataclass
from pathlib import Path
from typing import List, Optional, Sequence, Union

import numpy as np

from ..faults import (
    TruncatedWriteError,
    file_write_with_faults,
    fsync_with_faults,
    maybe_fail,
)
from ..tpu.snapshot import _encode_keys, fsync_dir

MAGIC = b"TCKP"
FORMAT_VERSION = 1
MANIFEST_NAME = "MANIFEST.json"

_FRAME = struct.Struct("<IQ")  # crc32(body), len(body)


class CheckpointCorrupt(ValueError):
    """A checkpoint file or manifest is torn, truncated, or damaged.

    Subclasses ValueError (like SnapshotError) so generic callers keep
    working; the recovery scanner catches it to fall back
    generation-by-generation instead of refusing to boot.
    """


@dataclass
class CheckpointRecord:
    """One decoded checkpoint file."""

    kind: str  # "base" | "delta"
    generation: int
    base_generation: int
    created_ns: int
    capacity: int
    n_shards: int
    source_bytes_keys: bool
    keys_raw: List[bytes]
    key_is_bytes: np.ndarray  # bool[n]
    key_codec: np.ndarray  # u8[n]
    tat: np.ndarray  # i64[n]
    expiry: np.ndarray  # i64[n]


def checkpoint_name(generation: int, kind: str) -> str:
    """``ckpt-<gen 12 digits>-<kind>.tck`` — lexicographic == numeric."""
    return f"ckpt-{generation:012d}-{kind}.tck"


def parse_checkpoint_name(name: str) -> Optional[tuple]:
    """(generation, kind) for a checkpoint filename, else None."""
    if not (name.startswith("ckpt-") and name.endswith(".tck")):
        return None
    parts = name[len("ckpt-") : -len(".tck")].split("-")
    if len(parts) != 2 or parts[1] not in ("base", "delta"):
        return None
    try:
        return int(parts[0]), parts[1]
    except ValueError:
        return None


def encode_checkpoint(
    kind: str,
    generation: int,
    base_generation: int,
    created_ns: int,
    capacity: int,
    n_shards: int,
    source_bytes_keys: bool,
    keys: Sequence,
    tat: np.ndarray,
    expiry: np.ndarray,
) -> bytes:
    """Frame one generation's rows as a checkpoint blob."""
    enc_keys, key_is_bytes, key_codec = _encode_keys(keys)
    n = len(enc_keys)
    offsets = np.zeros(n + 1, np.int64)
    if enc_keys:
        np.cumsum([len(k) for k in enc_keys], out=offsets[1:])
    key_blob = b"".join(enc_keys)
    header = json.dumps(
        {
            "version": FORMAT_VERSION,
            "kind": kind,
            "generation": int(generation),
            "base_generation": int(base_generation),
            "created_ns": int(created_ns),
            "n_keys": n,
            "capacity": int(capacity),
            "n_shards": int(n_shards),
            "source_bytes_keys": bool(source_bytes_keys),
            "key_blob_len": len(key_blob),
        },
        sort_keys=True,
    ).encode()
    body = b"".join(
        (
            struct.pack("<I", len(header)),
            header,
            offsets.astype("<i8").tobytes(),
            key_blob,
            np.asarray(key_is_bytes, np.uint8).tobytes(),
            np.asarray(key_codec, np.uint8).tobytes(),
            np.asarray(tat, "<i8").tobytes(),
            np.asarray(expiry, "<i8").tobytes(),
        )
    )
    crc = zlib.crc32(body) & 0xFFFFFFFF
    return MAGIC + _FRAME.pack(crc, len(body)) + body


def decode_checkpoint(blob: bytes, name: str = "?") -> CheckpointRecord:
    """Verify + decode a checkpoint blob; CheckpointCorrupt on damage."""
    head = len(MAGIC) + _FRAME.size
    if len(blob) < head or blob[: len(MAGIC)] != MAGIC:
        raise CheckpointCorrupt(f"{name}: bad magic or truncated frame")
    crc, body_len = _FRAME.unpack_from(blob, len(MAGIC))
    body = blob[head:]
    if len(body) != body_len:
        raise CheckpointCorrupt(
            f"{name}: torn body ({len(body)} of {body_len} bytes)"
        )
    if (zlib.crc32(body) & 0xFFFFFFFF) != crc:
        raise CheckpointCorrupt(f"{name}: CRC mismatch")
    try:
        (hlen,) = struct.unpack_from("<I", body, 0)
        header = json.loads(body[4 : 4 + hlen])
        n = int(header["n_keys"])
        blob_len = int(header["key_blob_len"])
        kind = header["kind"]
        if kind not in ("base", "delta") or n < 0 or blob_len < 0:
            raise CheckpointCorrupt(f"{name}: bad header fields")
        if int(header["version"]) != FORMAT_VERSION:
            raise CheckpointCorrupt(
                f"{name}: unsupported version {header['version']}"
            )
        pos = 4 + hlen
        want = pos + 8 * (n + 1) + blob_len + n + n + 8 * n + 8 * n
        if want != len(body):
            raise CheckpointCorrupt(f"{name}: column lengths disagree")
        offsets = np.frombuffer(body, "<i8", n + 1, pos)
        pos += 8 * (n + 1)
        key_blob = body[pos : pos + blob_len]
        pos += blob_len
        key_is_bytes = np.frombuffer(body, np.uint8, n, pos).astype(bool)
        pos += n
        key_codec = np.frombuffer(body, np.uint8, n, pos)
        pos += n
        tat = np.frombuffer(body, "<i8", n, pos)
        pos += 8 * n
        expiry = np.frombuffer(body, "<i8", n, pos)
        if n and (
            int(offsets[0]) != 0
            or bool((np.diff(offsets) < 0).any())
            or int(offsets[-1]) != blob_len
        ):
            raise CheckpointCorrupt(f"{name}: key offsets inconsistent")
        keys_raw = [
            key_blob[offsets[i] : offsets[i + 1]] for i in range(n)
        ]
    except CheckpointCorrupt:
        raise
    except (KeyError, ValueError, TypeError, struct.error) as e:
        raise CheckpointCorrupt(f"{name}: undecodable header: {e}") from e
    return CheckpointRecord(
        kind=kind,
        generation=int(header["generation"]),
        base_generation=int(header["base_generation"]),
        created_ns=int(header["created_ns"]),
        capacity=int(header["capacity"]),
        n_shards=int(header["n_shards"]),
        source_bytes_keys=bool(header["source_bytes_keys"]),
        keys_raw=keys_raw,
        key_is_bytes=key_is_bytes,
        key_codec=key_codec,
        tat=tat,
        expiry=expiry,
    )


def read_checkpoint(path: Union[str, Path]) -> CheckpointRecord:
    path = Path(path)
    maybe_fail("snapshot")
    try:
        blob = path.read_bytes()
    except OSError as e:
        raise CheckpointCorrupt(f"{path.name}: unreadable: {e}") from e
    return decode_checkpoint(blob, path.name)


def write_file_durable(path: Union[str, Path], blob: bytes) -> None:
    """tmp + write + fsync + rename + dir fsync; fault-site threaded.

    On an injected torn write the torn tmp is *promoted into the final
    path* before the error surfaces: the worst real crash shape is a
    rename that hits the journal before the data blocks do, leaving a
    torn file under the final name — recovery must survive exactly
    that, so that is what injection produces.
    """
    path = Path(path)
    tmp = path.with_name(path.name + ".tmp")
    try:
        with open(tmp, "wb") as f:
            file_write_with_faults("snapshot", f, blob)
            f.flush()
            fsync_with_faults("snapshot", f.fileno())
    except TruncatedWriteError:
        try:
            os.replace(tmp, path)
        except OSError:
            pass
        raise
    except BaseException:
        try:
            tmp.unlink()
        except OSError:
            pass
        raise
    os.replace(tmp, path)
    fsync_dir(path.parent)


# ------------------------------------------------------------------ #
# Manifest


def write_manifest(
    directory: Union[str, Path], chains: List[List[int]]
) -> None:
    """Durably record the retained chains, newest-first.

    Each chain is ``[base_gen, delta_gen, ...]`` in ascending
    generation order.  Advisory only: recovery re-verifies every file
    it names and falls back to a directory scan without it.
    """
    directory = Path(directory)
    blob = json.dumps(
        {"version": FORMAT_VERSION, "chains": chains}, sort_keys=True
    ).encode()
    write_file_durable(directory / MANIFEST_NAME, blob)


def read_manifest(
    directory: Union[str, Path],
) -> Optional[List[List[int]]]:
    """The manifest's chain list, or None when missing/corrupt."""
    path = Path(directory) / MANIFEST_NAME
    try:
        doc = json.loads(path.read_bytes())
        chains = doc["chains"]
        if not isinstance(chains, list):
            raise ValueError("chains is not a list")
        out = []
        for chain in chains:
            gens = [int(g) for g in chain]
            if not gens:
                raise ValueError("empty chain")
            out.append(gens)
        return out
    except (OSError, ValueError, TypeError, KeyError):
        return None
