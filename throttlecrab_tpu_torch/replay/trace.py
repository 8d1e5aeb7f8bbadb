"""Versioned columnar trace format for deterministic record/replay.

The port of `throttlecrab_tpu/replay/trace.py`: the same ``TCRT`` v1
codec, so for the same records the encoded bytes are identical and each
package reads the other's files.

A trace is a byte stream: an 6-byte file header (magic + version)
followed by self-delimiting frames, each ``<IB`` (body_len, kind) —
the JAX cluster wire ladder's ``_HDR`` idiom, with its hardening
contract:

* every count and length is validated against the actual body size
  **before any allocation** — a trace file is an untrusted input (it
  may come off a crashed node, a bug report, or a fuzzer);
* truncation, corruption and count-vs-size lies raise the typed
  :class:`TraceError`, never ``struct.error`` / ``IndexError`` /
  ``MemoryError``;
* trailing bytes inside a frame are rejected (a desynced stream must
  not half-apply).

Frame kinds:

``REC_WINDOW``
    One decided window: the per-window decision inputs ``(key, burst,
    count_per_period, period, quantity, now_ns)`` plus the outcomes
    (allowed, status) and per-row tenant ids — columnar, so whole
    windows encode/decode in a handful of vectorized numpy calls
    (capture rides the serving path when armed)::

        now_ns i64 | source u8 | n u32 |
        n x u16 key_len | key blob |
        n x 4 i64 params (burst, count, period, quantity; row-major) |
        n x u16 tenant | n x u8 allowed | n x u8 status

``REC_EVENT``
    A lifecycle event (membership epoch bumps, joins, takeovers,
    degrade/re-promote): ``now_ns i64 | u16 kind_len | kind |
    u16 detail_len | detail`` (utf-8).

``REC_INJECTION``
    One fired fault injection — the site, mode, the site's check index
    at which it fired, and the mode arg — enough to replay a chaos run
    bit-identically (faults/injector.py ``from_schedule``):
    ``u32 index | f64 arg | u16 site_len | site | u16 mode_len | mode``.

Records keep their capture order (a global sequence), so a multi-node
timeline merged into one recorder replays in true decision order.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field
from typing import List, Optional, Sequence, Tuple

import numpy as np

MAGIC = b"TCRT"
VERSION = 1
_FILE_HEAD = struct.Struct("<4sH")  # magic, version
_FHDR = struct.Struct("<IB")        # body_len, kind
_WIN_HEAD = struct.Struct("<qBI")   # now_ns, source, n
_EVT_HEAD = struct.Struct("<q")     # now_ns
_INJ_HEAD = struct.Struct("<Id")    # index, arg

REC_WINDOW = 1
REC_EVENT = 2
REC_INJECTION = 3

#: Capture-source codes for window frames.  Cluster frontends encode
#: their node index as SOURCE_CLUSTER_BASE + index so a replayer can
#: route each window through the frontend that originally decided it.
SOURCE_ENGINE = 0
SOURCE_NATIVE = 1
SOURCE_HARNESS = 2
SOURCE_SYNTH = 3
SOURCE_CLUSTER_BASE = 16

MAX_FRAME = 64 << 20  # hardening cap, same spirit as the cluster codecs
MAX_KEY_BYTES = 0xFFFF  # u16 key_len on the wire

#: Per-row fixed cost inside a window body: u16 key_len + 4 x i64
#: params + u16 tenant + u8 allowed + u8 status.
_ROW_FIXED = 2 + 4 * 8 + 2 + 1 + 1


class TraceError(ValueError):
    """Malformed, truncated or inconsistent trace data."""


@dataclass
class Window:
    """One decided window: inputs + outcomes, arrival order preserved."""

    now_ns: int
    source: int
    keys: List[bytes]
    #: i64[n, 4] — burst, count_per_period, period, quantity.
    params: np.ndarray
    allowed: np.ndarray   # u8[n]
    status: np.ndarray    # u8[n]
    tenants: np.ndarray   # u16[n] (0 = no tenant / overflow bucket)

    def __len__(self) -> int:
        return len(self.keys)


@dataclass
class Event:
    now_ns: int
    kind: str
    detail: str = ""


@dataclass
class Injection:
    site: str
    mode: str
    index: int   # the site's check counter at which this fault fired
    arg: float = 0.0


# ------------------------------------------------------------------ #
# Frame codecs.


def encode_window(
    now_ns: int,
    source: int,
    keys: Sequence[bytes],
    params,
    allowed,
    status,
    tenants=None,
) -> bytes:
    n = len(keys)
    params = np.ascontiguousarray(np.asarray(params, np.int64)).reshape(
        n, 4
    )
    lens = np.fromiter(map(len, keys), np.int64, count=n)
    if n and int(lens.max(initial=0)) > MAX_KEY_BYTES:
        raise TraceError("key exceeds the u16 length bound")
    ten = (
        np.zeros(n, np.uint16)
        if tenants is None
        else np.asarray(tenants, np.uint16)
    )
    body = b"".join((
        _WIN_HEAD.pack(int(now_ns), int(source) & 0xFF, n),
        lens.astype("<u2").tobytes(),
        b"".join(keys),
        params.astype("<i8").tobytes(),
        ten.astype("<u2").tobytes(),
        np.asarray(allowed, np.uint8).tobytes(),
        np.asarray(status, np.uint8).tobytes(),
    ))
    return _FHDR.pack(len(body), REC_WINDOW) + body


def decode_window(body: bytes) -> Window:
    """Count-vs-size before allocation; trailing bytes rejected."""
    if len(body) < _WIN_HEAD.size:
        raise TraceError("short window frame")
    now_ns, source, n = _WIN_HEAD.unpack_from(body, 0)
    if n > (len(body) - _WIN_HEAD.size) // _ROW_FIXED:
        raise TraceError(f"window count {n} exceeds frame size")
    off = _WIN_HEAD.size
    lens = np.frombuffer(body, "<u2", count=n, offset=off).astype(np.int64)
    off += 2 * n
    blob_len = int(lens.sum())
    if off + blob_len + (4 * 8 + 2 + 1 + 1) * n != len(body):
        raise TraceError("window frame size mismatches lengths")
    ends = np.cumsum(lens) + off
    starts = ends - lens
    keys = [body[int(s): int(e)] for s, e in zip(starts, ends)]
    off += blob_len
    params = (
        np.frombuffer(body, "<i8", count=4 * n, offset=off)
        .astype(np.int64)
        .reshape(n, 4)
    )
    off += 4 * 8 * n
    tenants = np.frombuffer(body, "<u2", count=n, offset=off).astype(
        np.uint16
    )
    off += 2 * n
    allowed = np.frombuffer(body, np.uint8, count=n, offset=off).copy()
    off += n
    status = np.frombuffer(body, np.uint8, count=n, offset=off).copy()
    return Window(
        now_ns=int(now_ns), source=int(source), keys=keys, params=params,
        allowed=allowed, status=status, tenants=tenants,
    )


def _pack_str(s: str) -> bytes:
    b = s.encode()
    if len(b) > 0xFFFF:
        raise TraceError("string exceeds the u16 length bound")
    return struct.pack("<H", len(b)) + b


def _unpack_str(body: bytes, off: int) -> Tuple[str, int]:
    if off + 2 > len(body):
        raise TraceError("short string field")
    (ln,) = struct.unpack_from("<H", body, off)
    off += 2
    if off + ln > len(body):
        raise TraceError("string field exceeds frame")
    return body[off: off + ln].decode("utf-8", "replace"), off + ln


def encode_event(now_ns: int, kind: str, detail: str = "") -> bytes:
    body = _EVT_HEAD.pack(int(now_ns)) + _pack_str(kind) + _pack_str(detail)
    return _FHDR.pack(len(body), REC_EVENT) + body


def decode_event(body: bytes) -> Event:
    if len(body) < _EVT_HEAD.size:
        raise TraceError("short event frame")
    (now_ns,) = _EVT_HEAD.unpack_from(body, 0)
    kind, off = _unpack_str(body, _EVT_HEAD.size)
    detail, off = _unpack_str(body, off)
    if off != len(body):
        raise TraceError("trailing bytes in event frame")
    return Event(now_ns=int(now_ns), kind=kind, detail=detail)


def encode_injection(
    site: str, mode: str, index: int, arg: float = 0.0
) -> bytes:
    body = (
        _INJ_HEAD.pack(int(index), float(arg))
        + _pack_str(site)
        + _pack_str(mode)
    )
    return _FHDR.pack(len(body), REC_INJECTION) + body


def decode_injection(body: bytes) -> Injection:
    if len(body) < _INJ_HEAD.size:
        raise TraceError("short injection frame")
    index, arg = _INJ_HEAD.unpack_from(body, 0)
    site, off = _unpack_str(body, _INJ_HEAD.size)
    mode, off = _unpack_str(body, off)
    if off != len(body):
        raise TraceError("trailing bytes in injection frame")
    return Injection(site=site, mode=mode, index=int(index), arg=float(arg))


_DECODERS = {
    REC_WINDOW: decode_window,
    REC_EVENT: decode_event,
    REC_INJECTION: decode_injection,
}


# ------------------------------------------------------------------ #


@dataclass
class Trace:
    """A parsed trace: records in capture order plus typed views."""

    records: List[tuple] = field(default_factory=list)  # (kind, obj)
    version: int = VERSION

    @property
    def windows(self) -> List[Window]:
        return [r for k, r in self.records if k == REC_WINDOW]

    @property
    def events(self) -> List[Event]:
        return [r for k, r in self.records if k == REC_EVENT]

    @property
    def injections(self) -> List[Injection]:
        return [r for k, r in self.records if k == REC_INJECTION]

    def n_rows(self) -> int:
        return sum(len(w) for w in self.windows)

    def distinct_keys(self) -> int:
        seen = set()
        for w in self.windows:
            seen.update(w.keys)
        return len(seen)

    def outcome_vector(self) -> bytes:
        """The byte-for-byte determinism diff target: every window's
        (allowed, status) planes concatenated in capture order."""
        parts = []
        for w in self.windows:
            parts.append(np.asarray(w.allowed, np.uint8).tobytes())
            parts.append(np.asarray(w.status, np.uint8).tobytes())
        return b"".join(parts)

    def injection_schedule(self) -> List[Tuple[str, str, int, float]]:
        """(site, mode, index, arg) rows for FaultInjector.from_schedule
        — replays a chaos run's exact fired-injection sequence."""
        return [
            (i.site, i.mode, i.index, i.arg) for i in self.injections
        ]

    @classmethod
    def loads(cls, data: bytes) -> "Trace":
        if len(data) < _FILE_HEAD.size:
            raise TraceError("short trace: missing file header")
        magic, version = _FILE_HEAD.unpack_from(data, 0)
        if magic != MAGIC:
            raise TraceError(f"bad trace magic {magic!r}")
        if version != VERSION:
            raise TraceError(f"unsupported trace version {version}")
        trace = cls(version=version)
        off = _FILE_HEAD.size
        try:
            while off < len(data):
                if off + _FHDR.size > len(data):
                    raise TraceError("truncated frame header")
                body_len, kind = _FHDR.unpack_from(data, off)
                if body_len > MAX_FRAME:
                    raise TraceError(f"frame length {body_len} over cap")
                off += _FHDR.size
                if off + body_len > len(data):
                    raise TraceError("truncated frame body")
                decoder = _DECODERS.get(kind)
                if decoder is None:
                    raise TraceError(f"unknown record kind {kind}")
                trace.records.append(
                    (kind, decoder(data[off: off + body_len]))
                )
                off += body_len
        except struct.error as e:  # belt and braces: always typed
            raise TraceError(f"malformed trace frame: {e}") from e
        return trace

    @classmethod
    def load(cls, path: str) -> "Trace":
        with open(path, "rb") as f:
            return cls.loads(f.read())


class TraceWriter:
    """Accumulates encoded frames; ``save`` writes header + frames.

    Not thread-safe — the flight recorder (recorder.py) owns locking;
    this class is the encode/accumulate half shared by the recorder
    and the synthetic generators.
    """

    def __init__(self) -> None:
        self._frames: List[bytes] = []
        self.n_windows = 0

    def add_window(
        self, now_ns, source, keys, params, allowed, status, tenants=None
    ) -> None:
        self._frames.append(
            encode_window(
                now_ns, source, keys, params, allowed, status, tenants
            )
        )
        self.n_windows += 1

    def add_event(self, now_ns: int, kind: str, detail: str = "") -> None:
        self._frames.append(encode_event(now_ns, kind, detail))

    def add_injection(
        self, site: str, mode: str, index: int, arg: float = 0.0
    ) -> None:
        self._frames.append(encode_injection(site, mode, index, arg))

    def to_bytes(self) -> bytes:
        return _FILE_HEAD.pack(MAGIC, VERSION) + b"".join(self._frames)

    def save(self, path: str) -> str:
        import os

        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "wb") as f:
            f.write(self.to_bytes())
        os.replace(tmp, path)  # atomic: a dump is never half-readable
        return path


def normalize_keys(keys) -> List[bytes]:
    """str/bytes keys -> bytes (the trace's on-disk identity), using the
    same lossless surrogateescape the native wire path uses."""
    out = []
    for k in keys:
        out.append(
            k if isinstance(k, (bytes, bytearray))
            else str(k).encode("utf-8", "surrogateescape")
        )
    return out


def derive_tenants(
    keys: Sequence[bytes], delim: bytes, interning: dict
) -> Optional[np.ndarray]:
    """Per-row tenant ids, interned per trace (id 0 = no tenant) — the
    trace is self-contained: its tenant-id mapping lives in the trace's
    own interning dict, independent of any server registry."""
    if not delim:
        return None
    out = np.zeros(len(keys), np.uint16)
    for i, kb in enumerate(keys):
        j = kb.find(delim)
        if j <= 0:
            continue
        prefix = kb[:j]
        tid = interning.get(prefix)
        if tid is None:
            if len(interning) >= 0xFFFF:
                continue  # bounded: extras share the 0 bucket
            tid = len(interning) + 1
            interning[prefix] = tid
        out[i] = tid
    return out
