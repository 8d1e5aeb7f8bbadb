"""Deterministic fault injection for the real failure surfaces.

The port's copy of `throttlecrab_tpu/faults/injector.py`, line for line
in its grammar, its per-fault 64-bit LCG and its exception shapes, so a
schedule armed with the same spec and seed fires at the same checks with
the same errors in both packages.  The operational failure it produces
on demand is the device going away mid-run (`UNAVAILABLE`): a registry
of injection points threaded through the real failure surfaces —

  * ``launch``   — a device kernel launch (dispatch) fails,
  * ``fetch``    — a deferred device→host result fetch fails,
  * ``peer``     — a cluster peer socket operation fails,
  * ``keymap``   — host key→slot resolution hits capacity exhaustion,
  * ``snapshot`` — snapshot file I/O fails,
  * ``migrate``  — a cluster key-range migration (send or apply side)
    fails mid-handoff — the elastic ring's hardest window,
  * ``leave``    — a planned departure (announce or receive side) fails
    mid-handoff — graceful drain degrading to the kill path,

each raising the same exception *shape* the real system produces at that
surface (an ``UNAVAILABLE``-prefixed runtime error for the device
surfaces — the string the JAX runtime puts on a lost device, kept
here because it is exactly what the launch supervisor's classifier
keys on; ``ConnectionError`` for peer
sockets; ``InternalError("bucket table full")`` for the keymap;
``OSError`` for snapshot I/O).

Socket realism: beyond clean raises, the ``slow`` mode stalls a socket
operation (a congested/slow peer) and then lets it proceed, and the
``partial`` mode — at sender chokepoints routed through
:func:`send_with_faults` — writes a *prefix* of the frame before
failing, so the receiver observes a genuinely truncated frame and must
drop the connection to resynchronize.

Durability realism (the ``snapshot`` site): ``truncate:<frac>`` — at
file-write chokepoints routed through :func:`file_write_with_faults` —
puts a *prefix* of the payload on disk before failing, the torn-write
shape a crash leaves behind on ext4/xfs when the rename is journaled
before the data blocks land; ``fsyncfail`` raises at the
:func:`fsync_with_faults` chokepoint, the EIO-on-fsync failure that
makes "written" files vanish on power loss.  Both degrade to a clean
``OSError`` at sites/hooks with no file to tear (the same discipline
as ``partial`` on the socket receive side).

Determinism: probability draws come from a per-fault 64-bit LCG seeded
from the spec, never from ``random``/wall clock, so a chaos run replays
bit-identically.  ``hang`` sleeps through an injectable ``sleep_fn`` so
virtual-time tests can observe stalls without real waiting.

Arming: ``THROTTLECRAB_FAULTS=launch:transient:0.01,fetch:count:3`` via
the server config (see server/config.py), or programmatically with
:func:`arm` in tests.  When nothing is armed every hook is one global
``None`` check — the hooks ride per-*batch* paths (never per-request),
so the disarmed cost is unmeasurable.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

SITES = (
    "launch", "fetch", "peer", "keymap", "snapshot", "migrate", "leave",
)
MODES = (
    "transient", "persistent", "count", "hang", "slow", "partial",
    "truncate", "fsyncfail",
)


class InjectedDeviceError(RuntimeError):
    """UNAVAILABLE-shaped device failure.

    Deliberately a plain RuntimeError subclass: the launch supervisor
    must classify it by *message*, as it classifies any runtime error —
    so injection exercises the production classification path, not a
    test-only shortcut.  (On a card the supervisor also requires this
    type before it retries or degrades, since a real CUDA error is
    sticky and some carry a marker; see server/supervisor.py.)
    """


class PartialWriteError(ConnectionError):
    """A fired ``partial`` socket mode.

    A ConnectionError subclass so sites that only ``maybe_fail`` (no
    frame to truncate, e.g. the receive side) degrade to a clean
    connection failure; :func:`send_with_faults` catches it at sender
    chokepoints to actually truncate the frame on the wire first.
    """


class TruncatedWriteError(OSError):
    """A fired ``truncate`` file mode.

    An OSError subclass so sites that only ``maybe_fail`` (no payload
    in hand) degrade to a clean I/O failure;
    :func:`file_write_with_faults` catches it at file-write chokepoints
    to actually put a prefix of the payload on disk first — the torn
    file a crash mid-write leaves behind.
    """

    def __init__(self, frac: float) -> None:
        super().__init__(
            f"injected torn write (first {frac:.0%} of payload on disk)"
        )
        self.frac = frac


class FsyncFailError(OSError):
    """A fired ``fsyncfail`` mode: fsync raises before durability is
    promised — the EIO-on-fsync shape that makes "written" data vanish
    on power loss.  An OSError subclass so every snapshot-site caller
    already handles it."""


def _site_error(site: str, detail: str) -> Exception:
    if site in ("launch", "fetch"):
        return InjectedDeviceError(
            f"UNAVAILABLE: injected {site} fault ({detail})"
        )
    if site in ("peer", "migrate", "leave"):
        return ConnectionError(
            f"injected {site} socket fault ({detail})"
        )
    if site == "keymap":
        from ..core.errors import InternalError

        return InternalError("bucket table full")
    # snapshot
    return OSError(f"injected snapshot I/O fault ({detail})")


@dataclass(frozen=True)
class FaultSpec:
    """One parsed ``site:mode[:arg]`` entry."""

    site: str
    mode: str
    arg: float = 0.0


def parse_spec(text: str) -> List[FaultSpec]:
    """Parse ``site:mode[:arg],...``; raises ValueError on a bad entry.

    Modes: ``transient:p`` (each check fails with probability p),
    ``persistent`` (every check fails until healed), ``count:n`` (the
    next n checks fail, then pass — scripts an outage-then-recovery),
    ``hang:seconds`` (the check stalls, then passes), ``slow:seconds``
    (socket sites: the operation stalls like a congested peer, then
    proceeds), ``partial`` (socket sender sites: a prefix of the frame
    reaches the wire before the connection fails), ``truncate:frac``
    (file-write sites: the first ``frac`` of the payload lands on disk
    before the write fails — a torn write), ``fsyncfail`` (fsync
    chokepoints raise before durability is promised).
    """
    specs: List[FaultSpec] = []
    for raw in text.split(","):
        raw = raw.strip()
        if not raw:
            continue
        parts = raw.split(":")
        if len(parts) not in (2, 3):
            raise ValueError(f"bad fault spec {raw!r} (want site:mode[:arg])")
        site, mode = parts[0], parts[1]
        if site not in SITES:
            raise ValueError(
                f"unknown fault site {site!r} (one of {', '.join(SITES)})"
            )
        if mode not in MODES:
            raise ValueError(
                f"unknown fault mode {mode!r} (one of {', '.join(MODES)})"
            )
        arg = 0.0
        if len(parts) == 3:
            try:
                arg = float(parts[2])
            except ValueError as e:
                raise ValueError(f"bad fault arg in {raw!r}: {e}") from e
        elif mode in ("transient", "count", "hang", "slow", "truncate"):
            raise ValueError(f"fault mode {mode!r} requires an arg")
        if mode == "transient" and not 0.0 <= arg <= 1.0:
            raise ValueError("transient probability must be in [0, 1]")
        if mode in ("count", "hang", "slow") and arg < 0:
            raise ValueError(f"fault arg must be >= 0 in {raw!r}")
        if mode == "truncate" and not 0.0 < arg < 1.0:
            raise ValueError("truncate fraction must be in (0, 1)")
        specs.append(FaultSpec(site, mode, arg))
    return specs


class _Armed:
    """Mutable per-fault state (LCG stream / remaining count)."""

    def __init__(self, spec: FaultSpec, seed: int) -> None:
        import zlib

        self.spec = spec
        # Distinct stream per (seed, site, mode): replays are exact.
        # crc32, not hash() — str hashing is salt-randomized per
        # process, which would break cross-run replay.
        self._state = (
            seed * 0x9E3779B97F4A7C15
            + zlib.crc32(f"{spec.site}:{spec.mode}".encode())
        ) & 0xFFFFFFFFFFFFFFFF
        self.remaining = int(spec.arg) if spec.mode == "count" else 0
        self.fired = 0
        self.healed = False

    def _draw(self) -> float:
        self._state = (
            self._state * 6364136223846793005 + 1442695040888963407
        ) & 0xFFFFFFFFFFFFFFFF
        return (self._state >> 11) / float(1 << 53)

    def fire(self, sleep_fn, index: int, note_fired) -> None:
        """Raise (or stall) according to the mode, or pass through.
        `index` is the site's check counter (the draw index) and
        `note_fired` logs every firing — the (site, mode, index, arg)
        row a replay needs to reproduce this exact injection."""
        if self.healed:
            return
        spec = self.spec
        if spec.mode == "transient":
            if self._draw() < spec.arg:
                self.fired += 1
                note_fired(spec.site, spec.mode, index, spec.arg)
                raise _site_error(spec.site, f"transient p={spec.arg}")
        elif spec.mode == "persistent":
            self.fired += 1
            note_fired(spec.site, spec.mode, index, spec.arg)
            raise _site_error(spec.site, "persistent")
        elif spec.mode == "count":
            if self.remaining > 0:
                self.remaining -= 1
                self.fired += 1
                note_fired(spec.site, spec.mode, index, spec.arg)
                raise _site_error(
                    spec.site, f"count, {self.remaining} left"
                )
        elif spec.mode == "hang":
            self.fired += 1
            note_fired(spec.site, spec.mode, index, spec.arg)
            sleep_fn(spec.arg)
        elif spec.mode == "slow":
            # A congested peer: the operation stalls, then succeeds.
            self.fired += 1
            note_fired(spec.site, spec.mode, index, spec.arg)
            sleep_fn(spec.arg)
        elif spec.mode == "partial":
            self.fired += 1
            note_fired(spec.site, spec.mode, index, spec.arg)
            raise PartialWriteError(
                f"injected {spec.site} partial write (connection lost "
                "mid-frame)"
            )
        elif spec.mode == "truncate":
            self.fired += 1
            note_fired(spec.site, spec.mode, index, spec.arg)
            raise TruncatedWriteError(spec.arg)
        elif spec.mode == "fsyncfail":
            self.fired += 1
            note_fired(spec.site, spec.mode, index, spec.arg)
            raise FsyncFailError(
                f"injected {spec.site} fsync failure (durability lost)"
            )


class FaultInjector:
    """An armed set of fault specs, checked at the injection points.

    Every firing is logged: ``fired_schedule()`` returns the exact
    (site, mode, draw-index, arg) sequence — what ``from_schedule``
    replays bit-identically.  Each firing is also pushed to the flight
    recorder when one is armed (replay/recorder.py).
    """

    def __init__(
        self,
        specs: Sequence[FaultSpec],
        seed: int = 0,
        sleep_fn=None,
    ) -> None:
        import time

        self._sleep = sleep_fn or time.sleep
        self._lock = threading.Lock()
        self._by_site: Dict[str, List[_Armed]] = {}
        #: Per-site check counter: the draw index a replay keys on.
        self._checks: Dict[str, int] = {}
        #: Every firing, in order: (site, mode, index, arg).
        self.fired_log: List[tuple] = []
        for spec in specs:
            self._by_site.setdefault(spec.site, []).append(
                _Armed(spec, seed)
            )

    def _note_fired(self, site, mode, index, arg) -> None:
        self.fired_log.append((site, mode, index, arg))
        from ..replay.recorder import maybe_record_injection

        maybe_record_injection(site, mode, index, arg)

    def check(self, site: str) -> None:
        """Called from a hook; raises/stalls when a fault fires."""
        armed = self._by_site.get(site)
        if not armed:
            return
        with self._lock:
            index = self._checks.get(site, 0)
            self._checks[site] = index + 1
            for f in armed:
                f.fire(self._sleep, index, self._note_fired)

    def heal(self, site: Optional[str] = None) -> None:
        """Disarm `site`'s faults (all sites when None) — models the
        device/peer coming back, for recovery tests."""
        with self._lock:
            for s, armed in self._by_site.items():
                if site is None or s == site:
                    for f in armed:
                        f.healed = True

    def stats(self) -> Dict[str, int]:
        """{site: total faults fired} for assertions and logs — also
        exported as the per-site throttlecrab_tpu_faults_injected_total
        counter (server/metrics.py)."""
        with self._lock:
            return {
                s: sum(f.fired for f in armed)
                for s, armed in self._by_site.items()
            }

    def fired_schedule(self) -> List[tuple]:
        """The exact firing sequence: (site, mode, index, arg) rows."""
        with self._lock:
            return list(self.fired_log)

    @classmethod
    def from_schedule(cls, entries, sleep_fn=None) -> "FaultInjector":
        """Deterministic fault replay: an injector that fires exactly
        the recorded (site, mode, index, arg) rows — at the same check
        indexes, with the same error shapes — regardless of probability
        draws.  A chaos run replays bit-identically, not merely
        statistically.  A check index maps to a LIST of firings: one
        live check can fire several armed specs (e.g. a hang that
        stalls, then a transient that raises), and replay must
        reproduce all of them in order."""
        inj = cls((), sleep_fn=sleep_fn)
        inj._schedule = {}
        for site, mode, index, arg in entries:
            inj._schedule.setdefault(site, {}).setdefault(
                int(index), []
            ).append((mode, float(arg)))
        inj.check = inj._check_scheduled  # type: ignore[method-assign]
        return inj

    def _check_scheduled(self, site: str) -> None:
        with self._lock:
            index = self._checks.get(site, 0)
            self._checks[site] = index + 1
            hits = self._schedule.get(site, {}).get(index)
            if not hits:
                return
            for mode, arg in hits:
                self._note_fired(site, mode, index, arg)
        # Recorded order == live armed order: hangs/slows stalled
        # first, and the firing that raised ended the live check —
        # replay the stalls, then re-raise the (single possible)
        # raising mode.  `partial` replays as its clean ConnectionError
        # shape (replay has no socket to truncate).
        for mode, arg in hits:
            if mode in ("hang", "slow"):
                self._sleep(arg)
            else:
                raise _site_error(
                    site, f"replayed {mode} (draw {index})"
                )


# ------------------------------------------------------------------ #
# Global hook plumbing: one None check when disarmed.

_active: Optional[FaultInjector] = None


def arm(injector: Optional[FaultInjector]) -> None:
    """Install `injector` as the process-wide fault source (None disarms)."""
    global _active
    _active = injector


def disarm() -> None:
    arm(None)


def active_injector() -> Optional[FaultInjector]:
    return _active


def maybe_fail(site: str) -> None:
    """The hook the failure surfaces call; no-op unless armed."""
    if _active is not None:
        _active.check(site)


def send_with_faults(site: str, sock, frame: bytes) -> None:
    """Socket-send chokepoint: checks `site` like maybe_fail, then
    writes `frame` — but a fired ``partial`` mode puts a prefix of the
    frame on the wire and kills the connection first, so the receiver
    sees a genuinely truncated frame (not a clean error) and must drop
    the connection to resynchronize its frame stream."""
    if _active is not None:
        try:
            _active.check(site)
        except PartialWriteError:
            try:
                sock.sendall(frame[: max(1, len(frame) // 2)])
                sock.close()
            except OSError:
                pass
            raise
    sock.sendall(frame)


def file_write_with_faults(site: str, fileobj, data: bytes) -> None:
    """File-write chokepoint: checks `site` like maybe_fail, then
    writes `data` — but a fired ``truncate`` mode puts the leading
    fraction of the payload on disk and fails, so the file is
    genuinely torn (short body, stale CRC) rather than cleanly absent.
    Callers that rename-into-place on success should, on this error,
    decide whether the torn bytes model a pre-rename crash (tmp file
    left behind) or a post-rename one (torn final file)."""
    if _active is not None:
        try:
            _active.check(site)
        except TruncatedWriteError as e:
            try:
                fileobj.write(data[: max(1, int(len(data) * e.frac))])
                fileobj.flush()
            except OSError:
                pass
            raise
    fileobj.write(data)


def fsync_with_faults(site: str, fd: int) -> None:
    """fsync chokepoint: checks `site` like maybe_fail (a fired
    ``fsyncfail`` raises here, *before* durability is promised), then
    fsyncs `fd` for real."""
    import os

    if _active is not None:
        _active.check(site)
    os.fsync(fd)
