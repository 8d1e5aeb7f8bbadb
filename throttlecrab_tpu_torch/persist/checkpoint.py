"""Background incremental checkpointer.

The port of `throttlecrab_tpu/persist/checkpoint.py`.  Every generation
exports through `tpu/snapshot.py`'s `export_snapshot_payload`, so on a
card its rows move through the `row_gather` kernel.  Each generation
stamps a "checkpoint" event on the flight recorder when one is armed.

Periodically persists the limiter's live state as a generation chain:
a full **base** checkpoint, then incremental **delta** checkpoints of
only the slots dirtied since the previous generation.  Dirty tracking
rides the existing host observe/flush path (`note_keys` is called with
each decided window's keys) so the device hot loop is untouched; a
delta's cost scales with churn, not table size.

Crash-safety argument: restored TATs are only ever *older* than
live state, and GCRA clamps an old TAT up to `now` before deciding —
so a stale checkpoint, a missed dirty mark, or a dropped delta
generation is strictly **over-allow-only**.  Recovery can never
manufacture a deny the live server would not have issued.

Tick discipline, as the insight poll's: the engine's housekeeping path
calls `maybe_tick(now_ns, lock)` off the event loop; inside, the
*device export* happens under the limiter lock and encoding + CRC + fsync happen with
the lock released.  A failed write re-merges the dirty set so the next
tick retries with nothing lost; the generation number only advances on
a durable write.

Retention is bounded: every new base starts a new chain and prunes all
but the newest `retain` chains, so disk use is O(retain · table), and
a base every `base_every` deltas bounds both recovery replay length
and the cost of a single lost generation.
"""

from __future__ import annotations

import logging
import threading
import time
from pathlib import Path
from typing import Iterable, Optional, Union

from ..tpu.snapshot import export_snapshot_payload
from .format import (
    MANIFEST_NAME,
    checkpoint_name,
    encode_checkpoint,
    parse_checkpoint_name,
    write_file_durable,
    write_manifest,
)

log = logging.getLogger("throttlecrab.persist")


def _canon_key(key) -> bytes:
    """Canonical byte identity of a keymap/wire key — the same mapping
    ``_encode_keys`` (tpu/snapshot.py) uses on disk, so a str key noted
    by a transport matches the bytes the native keymap exports."""
    if isinstance(key, (bytes, bytearray)):
        return bytes(key)
    try:
        return str(key).encode("utf-8", "surrogateescape")
    except UnicodeEncodeError:
        return str(key).encode("utf-8", "surrogatepass")


#: Deltas per base when mode == "incremental": bounds recovery replay
#: length and the blast radius of one corrupt generation.
BASE_EVERY = 16


class Checkpointer:
    """Owns one checkpoint directory for one node's limiter."""

    def __init__(
        self,
        limiter,
        directory: Union[str, Path],
        interval_ns: int,
        retain: int = 2,
        mode: str = "incremental",
        base_every: int = BASE_EVERY,
        now_fn=time.time_ns,
    ) -> None:
        self.limiter = limiter
        self.directory = Path(directory)
        self.interval_ns = int(interval_ns)
        self.retain = max(1, int(retain))
        self.mode = mode
        self.base_every = max(1, int(base_every))
        self._now_fn = now_fn
        self._mu = threading.Lock()  # dirty set + counters
        self._tick_mu = threading.Lock()  # single writer at a time
        self._dirty: set = set()
        #: Next generation to write (recovery seeds it past the chain).
        self.generation = 0
        self._deltas_since_base = 0
        #: Chains on disk, newest-first, each [base, delta, ...].
        self._chains: list = []
        self._last_tick_ns = 0
        # Stats (exported via metric_stats):
        self.last_checkpoint_ns = 0
        self.last_generation = -1
        self.last_duration_s = 0.0
        self.last_bytes = 0
        self.checkpoints_total = 0
        self.write_errors = 0
        # Boot-recovery stats, stamped by note_recovery:
        self.recoveries = 0
        self.recovered_keys = 0
        self.corrupt_skipped = 0

    # -------------------------------------------------------------- #
    # Dirty tracking (host observe path)

    def note_keys(self, keys: Iterable) -> None:
        """Mark `keys` dirty for the next delta.  Over-marking is
        harmless (the delta gathers dirty ∩ live table); a missed mark
        is bounded by the next base and over-allow-only anyway."""
        if self.interval_ns <= 0:
            # Recovery/shutdown-flush-only mode: the only write is a
            # full base, which needs no marks — don't grow a set that
            # nothing will ever drain.
            return
        with self._mu:
            self._dirty.update(keys)

    def dirty_count(self) -> int:
        with self._mu:
            return len(self._dirty)

    # -------------------------------------------------------------- #
    # Tick discipline (engine housekeeping path)

    def tick_due(self, now_ns: int) -> bool:
        """Cheap pre-check the engine calls before paying an executor
        hop — same shape as control.tick_due / insight.poll_due."""
        return (
            self.interval_ns > 0
            and now_ns - self._last_tick_ns >= self.interval_ns
        )

    def maybe_tick(self, now_ns: int, lock=None) -> int:
        """Write one checkpoint if the interval elapsed; returns rows
        written (0 when not due / nothing dirty / another tick runs).

        Never raises: a background housekeeping path must not take the
        serving loop down with it — failures are counted, logged, and
        retried next interval with the dirty set re-merged."""
        if not self.tick_due(now_ns):
            return 0
        if not self._tick_mu.acquire(blocking=False):
            return 0  # another driver (engine vs native) is mid-write
        try:
            if not self.tick_due(now_ns):
                return 0
            self._last_tick_ns = now_ns
            try:
                return self.checkpoint_now(now_ns, lock=lock)
            except OSError as e:
                log.warning("checkpoint generation failed: %s", e)
                return 0
        finally:
            self._tick_mu.release()

    # -------------------------------------------------------------- #
    # The write itself

    def checkpoint_now(
        self,
        now_ns: Optional[int] = None,
        lock=None,
        force_base: bool = False,
    ) -> int:
        """Write one generation immediately; returns rows written.

        Raises OSError on write failure (the dirty set is re-merged
        first, so a later call retries losslessly) — `maybe_tick`
        catches it; explicit callers (tests, shutdown flush) see it.
        """
        if now_ns is None:
            now_ns = self._now_fn()
        want_base = (
            force_base
            or self.mode == "full"
            or self.last_generation < 0
            or self._deltas_since_base >= self.base_every
        )
        with self._mu:
            dirty = self._dirty
            self._dirty = set()
        if not want_base and not dirty:
            return 0  # idle interval: no state changed, no file
        # Device half under the lock, everything else outside it.
        if lock is not None:
            with lock:
                payload = export_snapshot_payload(self.limiter)
        else:
            payload = export_snapshot_payload(self.limiter)
        t0 = time.perf_counter()
        keys = payload["keys"]
        tat = payload["tat"]
        expiry = payload["expiry"]
        if want_base:
            kind = "base"
            idx = range(len(keys))
        else:
            # A dirtied key can have expired/evicted since its mark —
            # then it's simply absent from the export and the delta.
            # An all-expired dirty set still writes an (empty) delta so
            # the chain has no generation holes for recovery to
            # misread as torn.  Match on canonical byte identity: the
            # transports note wire (str) keys while a bytes-keyed
            # keymap exports bytes, and those must name the same row.
            kind = "delta"
            dirty_c = {_canon_key(k) for k in dirty}
            idx = [
                i for i, k in enumerate(keys) if _canon_key(k) in dirty_c
            ]
        gen = self.generation
        base_gen = (
            gen if want_base else (self._chains[0][0] if self._chains else gen)
        )
        blob = encode_checkpoint(
            kind,
            gen,
            base_gen,
            now_ns,
            payload["capacity"],
            payload["n_shards"],
            payload["source_bytes_keys"],
            [keys[i] for i in idx],
            [int(tat[i]) for i in idx],
            [int(expiry[i]) for i in idx],
        )
        path = self.directory / checkpoint_name(gen, kind)
        try:
            self.directory.mkdir(parents=True, exist_ok=True)
            write_file_durable(path, blob)
        except OSError:
            self.write_errors += 1
            with self._mu:
                self._dirty |= dirty  # nothing lost; retry next tick
            raise
        # Durable: advance the chain, then the advisory manifest.
        if want_base:
            self._chains.insert(0, [gen])
            self._deltas_since_base = 0
        else:
            if self._chains:
                self._chains[0].append(gen)
            else:
                self._chains.insert(0, [gen])
            self._deltas_since_base += 1
        self.generation = gen + 1
        self.last_generation = gen
        self.last_checkpoint_ns = now_ns
        self.last_bytes = len(blob)
        self.last_duration_s = time.perf_counter() - t0
        self.checkpoints_total += 1
        try:
            self._prune()
            write_manifest(self.directory, self._chains)
        except OSError as e:
            # The generation itself is durable; a directory-scan
            # recovery finds it without the manifest.
            self.write_errors += 1
            log.warning("checkpoint manifest/prune failed: %s", e)
        from ..replay.recorder import maybe_record_event

        maybe_record_event(
            "checkpoint", f"{kind} gen={gen} rows={len(idx)}", now_ns
        )
        return len(idx)

    def _prune(self) -> None:
        """Keep the newest `retain` chains; delete the rest's files."""
        if len(self._chains) <= self.retain:
            return
        dead, self._chains = (
            self._chains[self.retain :],
            self._chains[: self.retain],
        )
        keep = {g for chain in self._chains for g in chain}
        for entry in list(self.directory.iterdir()):
            parsed = parse_checkpoint_name(entry.name)
            if parsed is None or parsed[0] in keep:
                continue
            try:
                entry.unlink()
            except OSError:
                pass
        del dead

    # -------------------------------------------------------------- #
    # Lifecycle + surface

    def note_recovery(
        self, restored: int, corrupt_skipped: int, chains: list
    ) -> None:
        """Stamp boot-recovery results and resume generation numbering
        strictly past everything on disk (chains is the full retained
        list, newest-first, as recovery saw it)."""
        self.recoveries += 1
        self.recovered_keys += restored
        self.corrupt_skipped += corrupt_skipped
        self._chains = [list(c) for c in chains]
        highest = max(
            (g for chain in chains for g in chain), default=-1
        )
        self.generation = highest + 1
        # A fresh base after recovery re-anchors the chain: everything
        # recovered is immediately re-persisted without replaying the
        # old (possibly tail-dropped) deltas forever.
        self._deltas_since_base = self.base_every

    def stop(self, now_ns: Optional[int] = None) -> None:
        """Final flush on graceful shutdown (best-effort)."""
        try:
            with self._tick_mu:
                self.checkpoint_now(now_ns)
        except OSError as e:
            log.warning("final checkpoint flush failed: %s", e)

    def metric_stats(self) -> dict:
        """Gauges for server/metrics.py's checkpoint stats provider."""
        age_s = (
            (self._now_fn() - self.last_checkpoint_ns) / 1e9
            if self.last_checkpoint_ns
            else -1.0
        )
        return {
            "generation": float(self.last_generation),
            "age_seconds": age_s,
            "duration_seconds": self.last_duration_s,
            "bytes": float(self.last_bytes),
            "corrupt_skipped_total": float(self.corrupt_skipped),
            "recoveries_total": float(self.recoveries),
            "write_errors_total": float(self.write_errors),
            "dirty_pending": float(self.dirty_count()),
        }

    def health_suffix(self) -> str:
        """The /health annotation: last-checkpoint age in seconds."""
        if not self.last_checkpoint_ns:
            return "checkpoint_age_s=never"
        age = max(0.0, (self._now_fn() - self.last_checkpoint_ns) / 1e9)
        return f"checkpoint_age_s={age:.1f}"


__all__ = [
    "BASE_EVERY",
    "Checkpointer",
    "MANIFEST_NAME",
]
