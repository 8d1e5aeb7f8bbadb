"""Bounded flight recorder: the always-on last-N-windows ring buffer.

The port of `throttlecrab_tpu/replay/recorder.py`.  Armed via the
``THROTTLECRAB_TRACE_*`` knobs (server/config.py) and the same
global-hook plumbing as fault injection (faults/injector.py): when
nothing is armed every capture hook is one global ``None`` check, and
the hooks ride per-*batch* paths (the engine flush path, the native
driver's dispatch) — never per-request.  The recorder lives on the
host: a window's outcome planes are already host arrays when it is
captured, so capture never touches the card.

Two modes:

* ``ring`` (the flight recorder, serving-safe default): raw window
  tuples land in a bounded deque; nothing is encoded until a dump.  A
  dump happens on demand (``GET /trace/dump``), automatically when the
  supervisor declares the device down (every persistent degrade leaves
  a post-mortem artifact), and programmatically via :meth:`dump`.
* ``full`` (capture-for-replay): every window is encoded at capture
  and buffered; the buffer flushes to the trace file as it fills and
  on :meth:`close` — the mode that captures complete workloads for
  replay (``--trace-mode full``).

Lifecycle events (membership changes, degrade/re-promote) and fired
fault injections are always kept, in bounded side lists, so a ring
overflow can never drop the timeline the windows need for
reconstruction.
"""

from __future__ import annotations

import logging
import os
import threading
import time
from collections import deque
from typing import Optional, Tuple

import numpy as np

from .trace import (
    SOURCE_ENGINE,
    TraceWriter,
    derive_tenants,
    encode_event,
    encode_injection,
    encode_window,
    normalize_keys,
)

log = logging.getLogger("throttlecrab.replay")

#: Bounds on the always-kept side lists (events are rare; injections
#: only exist in chaos runs).
MAX_EVENTS = 4096
MAX_INJECTIONS = 1 << 16
#: Full mode: flush the encoded buffer to disk past this many bytes.
FLUSH_BYTES = 1 << 20


class FlightRecorder:
    """Bounded capture of decided windows + lifecycle timeline."""

    def __init__(
        self,
        capacity: int = 1024,
        mode: str = "ring",
        out_dir: str = ".",
        dump_on_degrade: bool = True,
        tenant_delim: str = ":",
        path: Optional[str] = None,
        clock=None,
    ) -> None:
        if mode not in ("ring", "full"):
            raise ValueError(f"unknown trace mode {mode!r}")
        self.mode = mode
        self.out_dir = out_dir
        self.dump_on_degrade = dump_on_degrade
        self._delim = tenant_delim.encode() if tenant_delim else b""
        self._clock = clock or time.time_ns
        # Leaf lock: guards the ring/buffers; full-mode file appends
        # happen under it too (small buffered writes).
        self._mu = threading.Lock()
        self._closed = False
        self._capture_errors = 0
        self._seq = 0
        self._ring: deque = deque(maxlen=max(int(capacity), 1))
        self._events: list = []      # (seq, encoded bytes)
        self._injections: list = []  # (seq, encoded bytes)
        self._tenant_intern: dict = {}
        self.windows_recorded = 0
        self.dumps = 0
        # Full mode: incremental trace file.
        self._path = path
        self._file = None
        self._pending: list = []
        self._pending_bytes = 0

    # -- capture ------------------------------------------------------- #
    #
    # Capture must NEVER raise into a serving path and NEVER do file
    # I/O from a caller that may hold a serving lock: every hook is
    # wrapped (a failed capture logs and drops — the workload matters
    # more than its trace), over-long keys are truncated to the trace's
    # u16 bound (the metrics key-cap precedent) instead of refused, and
    # event/injection records only *enqueue* in full mode — the flush
    # (and the lazy file open) happens on window captures, which only
    # arrive from executor/driver threads, or at close/dump.

    def record_window(
        self, now_ns, keys, params, allowed, status,
        source: int = SOURCE_ENGINE,
    ) -> None:
        """One decided window (per-batch hook).  ``keys`` may be str or
        bytes; ``params`` is any (n, 4) int-shaped structure; outcome
        planes are copied — callers may reuse their buffers."""
        try:
            from .trace import MAX_KEY_BYTES

            kb = [
                k if len(k) <= MAX_KEY_BYTES else k[:MAX_KEY_BYTES]
                for k in normalize_keys(keys)
            ]
            p = np.array(np.asarray(params, np.int64).reshape(len(kb), 4))
            a = np.array(np.asarray(allowed, np.uint8))
            s = np.array(np.asarray(status, np.uint8))
            with self._mu:
                seq = self._seq
                self._seq += 1
                self.windows_recorded += 1
                if self.mode == "full":
                    tenants = derive_tenants(
                        kb, self._delim, self._tenant_intern
                    )
                    frame = encode_window(
                        int(now_ns), source, kb, p, a, s, tenants
                    )
                    self._enqueue_full(frame)
                    if self._pending_bytes >= FLUSH_BYTES:
                        self._flush_locked()
                else:
                    self._ring.append(
                        (seq, int(now_ns), source, kb, p, a, s)
                    )
        except Exception:
            self._note_capture_error()

    def record_event(
        self, kind: str, detail: str = "", now_ns: Optional[int] = None
    ) -> None:
        try:
            frame = encode_event(
                self._clock() if now_ns is None else int(now_ns),
                kind, detail,
            )
            with self._mu:
                seq = self._seq
                self._seq += 1
                if self.mode == "full":
                    self._enqueue_full(frame)  # no flush: caller may
                    # hold a serving lock (supervisor degrade, cluster
                    # takeover) — the next window capture flushes.
                elif len(self._events) < MAX_EVENTS:
                    self._events.append((seq, frame))
        except Exception:
            self._note_capture_error()

    def record_injection(
        self, site: str, mode: str, index: int, arg: float = 0.0
    ) -> None:
        try:
            frame = encode_injection(site, mode, index, arg)
            with self._mu:
                seq = self._seq
                self._seq += 1
                if self.mode == "full":
                    self._enqueue_full(frame)  # no flush (see above)
                elif len(self._injections) < MAX_INJECTIONS:
                    self._injections.append((seq, frame))
        except Exception:
            self._note_capture_error()

    def _note_capture_error(self) -> None:
        self._capture_errors += 1
        if self._capture_errors <= 3:  # bounded: never spam the log
            log.exception("trace capture failed; record dropped")

    # -- full-mode incremental file ------------------------------------ #

    def _enqueue_full(self, frame: bytes) -> None:
        # Caller holds self._mu.  Pure memory append — records arriving
        # after close() are dropped (reopening the finalized file with
        # "wb" would truncate the artifact this recorder exists to
        # preserve).
        if self._closed:
            return
        self._pending.append(frame)
        self._pending_bytes += len(frame)

    def _flush_locked(self) -> None:
        # Caller holds self._mu; only reached from window captures
        # (executor/driver threads), dump() and close() — never from a
        # caller that may hold a serving lock.
        if self._closed:
            self._pending = []
            self._pending_bytes = 0
            return
        if self._file is None:
            from .trace import _FILE_HEAD, MAGIC, VERSION

            if self._path is None:
                self._path = os.path.join(
                    self.out_dir, f"trace-{os.getpid()}.tctr"
                )
            os.makedirs(self.out_dir or ".", exist_ok=True)
            self._file = open(self._path, "wb")
            self._file.write(_FILE_HEAD.pack(MAGIC, VERSION))
        if self._pending:
            self._file.write(b"".join(self._pending))
            self._file.flush()
        self._pending = []
        self._pending_bytes = 0

    def close(self) -> Optional[str]:
        """Finalize the full-mode trace file; returns its path (None in
        ring mode, where nothing is persisted until a dump).  Late
        captures after close are dropped, never appended — the
        finalized artifact is immutable."""
        with self._mu:
            if self.mode != "full":
                self._closed = True
                return None
            self._flush_locked()
            self._closed = True
            if self._file is not None:
                self._file.close()
                self._file = None
            return self._path

    # -- dumps --------------------------------------------------------- #

    def _snapshot(self) -> Tuple[list, int]:
        """Capture-ordered encoded frames (called under self._mu)."""
        tagged = list(self._events) + list(self._injections)
        n_windows = len(self._ring)
        for seq, now_ns, source, kb, p, a, s in self._ring:
            tenants = derive_tenants(kb, self._delim, self._tenant_intern)
            tagged.append(
                (seq, encode_window(now_ns, source, kb, p, a, s, tenants))
            )
        tagged.sort(key=lambda t: t[0])
        return [frame for _seq, frame in tagged], n_windows

    def dump(self, path: Optional[str] = None) -> Tuple[str, int]:
        """Serialize the retained records to a trace file; returns
        (path, windows written).  In full mode this flushes the
        incremental file and reports it."""
        with self._mu:
            if self.mode == "full":
                self._flush_locked()
                self.dumps += 1
                return self._path or "", self.windows_recorded
            frames, n_windows = self._snapshot()
            self.dumps += 1
        writer = TraceWriter()
        writer._frames = frames
        if path is None:
            os.makedirs(self.out_dir or ".", exist_ok=True)
            path = os.path.join(
                self.out_dir,
                f"trace-{os.getpid()}-{self.dumps}.tctr",
            )
        writer.save(path)
        log.info(
            "flight recorder dumped %d windows to %s", n_windows, path
        )
        return path, n_windows

    def request_degrade_dump(self) -> None:
        """Supervisor hook: persistent device degrade.  The dump runs on
        a one-shot daemon thread — the caller holds the limiter lock and
        must never block on file I/O."""
        if not self.dump_on_degrade:
            return

        def _bg() -> None:
            try:
                self.dump()
            except Exception:
                log.exception("degrade-triggered trace dump failed")

        threading.Thread(
            target=_bg, name="tk-trace-dump", daemon=True
        ).start()

    def stats(self) -> dict:
        # Lock-free snapshot of plain counters (int reads are atomic in
        # CPython): callable from the event loop's /trace/dump route.
        return {
            "mode": self.mode,
            "windows_recorded": self.windows_recorded,
            "retained": (
                self.windows_recorded
                if self.mode == "full"
                else len(self._ring)
            ),
            "dumps": self.dumps,
        }


def from_config(config) -> Optional[FlightRecorder]:
    """Build the recorder from the THROTTLECRAB_TRACE_* knobs, or None
    when tracing is off (empty trace_dir)."""
    if not getattr(config, "trace_dir", ""):
        return None
    return FlightRecorder(
        capacity=config.trace_windows,
        mode=config.trace_mode,
        out_dir=config.trace_dir,
        dump_on_degrade=config.trace_dump_on_degrade,
        tenant_delim=getattr(config, "tenant_delim", ":"),
    )


# ------------------------------------------------------------------ #
# Global hook plumbing: one None check when disarmed (the
# faults/injector.py discipline — capture hooks ride per-batch paths).

_active: Optional[FlightRecorder] = None


def arm(recorder: Optional[FlightRecorder]) -> None:
    """Install `recorder` as the process-wide capture sink (None
    disarms)."""
    global _active
    _active = recorder


def disarm() -> None:
    arm(None)


def active_recorder() -> Optional[FlightRecorder]:
    return _active


def maybe_record_event(kind: str, detail: str = "", now_ns=None) -> None:
    """Lifecycle-event hook (membership/degrade timeline); no-op unless
    armed."""
    if _active is not None:
        _active.record_event(kind, detail, now_ns)


def maybe_record_injection(
    site: str, mode: str, index: int, arg: float = 0.0
) -> None:
    """Fault-firing hook (faults/injector.py); no-op unless armed."""
    if _active is not None:
        _active.record_injection(site, mode, index, arg)
