"""Replay player: re-run a trace under virtual time, differentially.

The port of `throttlecrab_tpu/replay/player.py`.  A trace (trace.py)
carries everything a decision depends on — key, params, quantity, and
the server-side timestamp each window was stamped with — so replaying
is exact by construction: time is an input (rate_limiter.rs:109), never
ambient.  The player re-drives those windows against a limiter:

* ``oracle``  — the ``core/`` scalar GCRA engine (the repo's
  differential-test oracle, via server/supervisor.HostOracle);
* ``device``  — a `TorchRateLimiter`, on ``cuda`` unless the caller
  passes ``device="cpu"`` (the plain version); every window is one
  ``rate_limit_batch`` call, so on a card one launch of the
  decision-window kernel per conflict round of the window (one for a
  window whose keys keep their params);
* ``sharded:D`` — a `ShardedTorchRateLimiter` over ``make_mesh(D)`` on
  the same device (D cards on ``cuda``, D shards of the CPU on
  ``cpu``), one launch per shard per conflict round;
* a live in-process cluster, reconstructed join/kill/rejoin and all
  from the recorded membership timeline (:class:`ClusterReplayer`),
  every node's limiter a `TorchRateLimiter` on the same device.

Two modes:

* **differential** (:func:`differential_replay`): the target's
  replayed outcomes are compared row-by-row against the scalar oracle
  AND against the recorded outcomes, so silent drift between the
  capture config and the replay config is a test failure, not a shrug.
* **deterministic fault replay**: :func:`injector_from_trace` rebuilds
  the exact fired-injection schedule a chaos run recorded
  (faults/injector.py ``from_schedule``), so the replayed run fails at
  the same sites, on the same draws, in the same order.

Rows whose *recorded* status is load-dependent (admission shed, or an
internal error from a mid-run fault) are excluded from outcome
comparison by default — they are properties of the original run's
environment, not of the decision function.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import numpy as np

from .trace import SOURCE_CLUSTER_BASE, Trace

#: Recorded statuses excluded from comparison by default: 3 = internal
#: (a fault fired mid-run; deterministic fault replay pins those runs
#: instead), 4 = overloaded (admission shed is queue-depth-dependent),
#: 6 = deadline exceeded (queue-dwell-dependent: a replay's dwell times
#: differ, so which rows expired in queue is an environment fact).
DEFAULT_IGNORE_STATUSES = (3, 4, 6)


def _next_pow2(n: int) -> int:
    p = 1024
    while p < n:
        p <<= 1
    return p


def make_target(name: str, trace: Optional[Trace] = None, **kw):
    """Build a replay target limiter: ``oracle``, ``device`` (extra
    keywords go to `TorchRateLimiter`, e.g. ``device="cpu"``; the
    default is the card) or ``sharded:D`` (D shards, ``device`` picks
    the mesh's device type; other keywords go to
    `ShardedTorchRateLimiter`).  Capacity is sized from the trace's
    distinct-key count so a replay can never fail on table growth."""
    cap = kw.pop("capacity", None)
    if cap is None:
        cap = _next_pow2(
            2 * (trace.distinct_keys() if trace is not None else 4096)
        )
    if name == "oracle":
        from ..server.supervisor import HostOracle

        return HostOracle(bytes_keys=True)
    if name == "device":
        from ..tpu.limiter import TorchRateLimiter

        return TorchRateLimiter(capacity=cap, **kw)
    if name.startswith("sharded"):
        from ..parallel.sharded import ShardedTorchRateLimiter, make_mesh

        d = int(name.split(":", 1)[1]) if ":" in name else 2
        device = kw.pop("device", "cuda")
        return ShardedTorchRateLimiter(
            capacity_per_shard=max(cap // d, 1024),
            mesh=make_mesh(d, device=device),
            **kw,
        )
    raise ValueError(f"unknown replay target {name!r}")


def _decode_keys(keys: List[bytes], limiter) -> list:
    from ..tpu.limiter import limiter_uses_bytes_keys

    if getattr(limiter, "bytes_keys", False) or limiter_uses_bytes_keys(
        limiter
    ):
        return keys
    return [k.decode("utf-8", "surrogateescape") for k in keys]


def replay(
    trace: Trace, limiter, frontends=None
) -> List[Tuple[np.ndarray, np.ndarray]]:
    """Re-run every window in capture order; returns per-window
    (allowed u8, status u8) planes.  ``frontends`` (ClusterReplayer)
    overrides the single limiter with the recorded node routing."""
    out = []
    for w in trace.windows:
        target = limiter
        if frontends is not None:
            target = frontends.frontend_for(w.source)
        keys = _decode_keys(w.keys, target)
        res = target.rate_limit_batch(
            keys,
            w.params[:, 0], w.params[:, 1], w.params[:, 2],
            w.params[:, 3], w.now_ns,
        )
        out.append((
            np.asarray(res.allowed, np.uint8).copy(),
            np.asarray(res.status, np.uint8).copy(),
        ))
    return out


def outcome_vector(outcomes) -> bytes:
    """Byte-for-byte determinism diff target for replayed outcomes."""
    return b"".join(a.tobytes() + s.tobytes() for a, s in outcomes)


@dataclass
class Mismatch:
    window: int
    row: int
    field: str
    got: int
    want: int
    key: bytes = b""

    def __str__(self) -> str:
        return (
            f"window {self.window} row {self.row} key {self.key!r}: "
            f"{self.field} got {self.got} want {self.want}"
        )


@dataclass
class ReplayReport:
    n_windows: int = 0
    n_rows: int = 0
    n_compared: int = 0
    vs_oracle: List[Mismatch] = field(default_factory=list)
    vs_recorded: List[Mismatch] = field(default_factory=list)

    @property
    def ok(self) -> bool:
        return not self.vs_oracle and not self.vs_recorded

    def summary(self) -> dict:
        return {
            "windows": self.n_windows,
            "rows": self.n_rows,
            "compared": self.n_compared,
            "oracle_mismatches": len(self.vs_oracle),
            "recorded_mismatches": len(self.vs_recorded),
            "ok": self.ok,
        }


def compare_outcomes(
    trace: Trace,
    got,
    want,
    label: str,
    sink: List[Mismatch],
    ignore_statuses=DEFAULT_IGNORE_STATUSES,
    max_mismatches: int = 64,
) -> int:
    """Row-by-row outcome comparison, gated on the recorded status;
    returns the number of rows compared."""
    compared = 0
    for wi, (w, (ga, gs), (wa, ws)) in enumerate(
        zip(trace.windows, got, want)
    ):
        rec_status = np.asarray(w.status)
        comparable = ~np.isin(rec_status, ignore_statuses)
        compared += int(comparable.sum())
        bad_status = comparable & (gs != ws)
        ok_rows = comparable & (gs == 0) & (ws == 0)
        bad_allowed = ok_rows & (ga != wa)
        for i in np.flatnonzero(bad_status | bad_allowed):
            if len(sink) >= max_mismatches:
                return compared
            i = int(i)
            fieldname = "status" if bad_status[i] else "allowed"
            g, e = (gs[i], ws[i]) if bad_status[i] else (ga[i], wa[i])
            sink.append(
                Mismatch(
                    window=wi, row=i, field=f"{label}:{fieldname}",
                    got=int(g), want=int(e), key=w.keys[i],
                )
            )
    return compared


def recorded_outcomes(trace: Trace):
    return [
        (np.asarray(w.allowed, np.uint8), np.asarray(w.status, np.uint8))
        for w in trace.windows
    ]


def differential_replay(
    trace: Trace,
    target="device",
    ignore_statuses=DEFAULT_IGNORE_STATUSES,
) -> ReplayReport:
    """Replay against ``target`` and the scalar oracle; compare the
    target's outcomes against BOTH the oracle and the recorded planes.
    Any drift — replay config vs capture config, or engine vs oracle —
    surfaces as a mismatch list, never silently.  A target named by a
    string is built by `make_target` (``"device"``: on the card); pass
    ``make_target("device", trace, device="cpu")`` for the CPU."""
    limiter = (
        make_target(target, trace) if isinstance(target, str) else target
    )
    report = ReplayReport(
        n_windows=len(trace.windows), n_rows=trace.n_rows()
    )
    got = replay(trace, limiter)
    oracle = replay(trace, make_target("oracle", trace))
    report.n_compared = compare_outcomes(
        trace, got, oracle, "oracle", report.vs_oracle, ignore_statuses
    )
    compare_outcomes(
        trace, got, recorded_outcomes(trace), "recorded",
        report.vs_recorded, ignore_statuses,
    )
    return report


def injector_from_trace(trace: Trace, sleep_fn=None):
    """Rebuild the chaos run's exact fired-injection schedule."""
    from ..faults import FaultInjector

    return FaultInjector.from_schedule(
        trace.injection_schedule(), sleep_fn=sleep_fn
    )


# ------------------------------------------------------------------ #
# Cluster replay: reconstruct the membership timeline.


class ClusterReplayer:
    """In-process multi-node cluster driven by a recorded timeline.

    Nodes are real ``ClusterLimiter`` + ``ClusterServer`` instances on
    their own event-loop threads over real TCP (the cluster chaos
    suite's harness shape).  The recorded lifecycle events reconstruct
    membership: the first ``cluster-join`` for an index boots and
    announces that node, ``cluster-takeover`` kills the named node, and
    a later ``cluster-join`` for a killed index is a rejoin (fresh
    node, state migrated back by the ring — exactly the recorded
    lifecycle).  Windows route through the frontend that decided them
    originally (``source = SOURCE_CLUSTER_BASE + node``), falling back
    to any live node while that frontend is down.  Every node's limiter
    is a `TorchRateLimiter` on `device` (the card unless the caller
    passes ``"cpu"``); on one card the nodes share its context and
    default stream, each serializing its own table under its cluster's
    ``device_lock``.
    """

    def __init__(self, n_nodes: int, capacity: int = 4096,
                 device: str = "cuda", **node_kw):
        import socket

        self.n_nodes = n_nodes
        socks = [socket.socket() for _ in range(n_nodes)]
        try:
            for s in socks:
                s.setsockopt(
                    socket.SOL_SOCKET, socket.SO_REUSEADDR, 1
                )
                s.bind(("127.0.0.1", 0))
            ports = [s.getsockname()[1] for s in socks]
        finally:
            for s in socks:
                s.close()
        self.nodes_spec = [f"127.0.0.1:{p}" for p in ports]
        self.capacity = capacity
        self.device = device
        self.node_kw = node_kw
        self.nodes: List[Optional[_ReplayNode]] = [None] * n_nodes

    def ensure_joined(self, index: int) -> None:
        if self.nodes[index] is None:
            self.nodes[index] = _ReplayNode(
                index, self.nodes_spec, self.capacity,
                device=self.device, **self.node_kw,
            )
            self.nodes[index].announce()

    def kill(self, index: int) -> None:
        node = self.nodes[index]
        if node is not None:
            node.kill()
            self.nodes[index] = None

    def frontend_for(self, source: int):
        idx = source - SOURCE_CLUSTER_BASE
        if 0 <= idx < self.n_nodes and self.nodes[idx] is not None:
            return self.nodes[idx].cl
        for node in self.nodes:
            if node is not None:
                return node.cl
        raise RuntimeError("no live cluster node to route through")

    def apply_event(self, event) -> None:
        if event.kind == "cluster-join":
            self.ensure_joined(int(event.detail))
        elif event.kind == "cluster-takeover":
            self.kill(int(event.detail))
        elif event.kind == "cluster-leave":
            self.leave(int(event.detail))

    def leave(self, index: int) -> None:
        """Replay a planned departure: the node hands off its range
        (the state-preserving path the live run took), then dies."""
        node = self.nodes[index]
        if node is not None:
            node.leave()
            self.nodes[index] = None

    def replay(self, trace: Trace, settle_s: float = 0.5):
        """Process records in capture order: lifecycle events mutate
        membership (with a short settle so migrations land, like the
        live system's handoff gate), windows decide.  Returns
        per-window (allowed, status) planes."""
        import time as _time

        from .trace import REC_EVENT, REC_WINDOW

        out = []
        wi = 0
        for kind, rec in trace.records:
            if kind == REC_EVENT:
                if rec.kind in ("cluster-takeover", "cluster-leave"):
                    # Before killing a node, give the replica pump the
                    # flush window the live run's pre-kill traffic had —
                    # the warm-standby copy must land on the successor
                    # or the kill loses state the original run kept.
                    _time.sleep(settle_s)
                before = [n is not None for n in self.nodes]
                self.apply_event(rec)
                if [n is not None for n in self.nodes] != before:
                    _time.sleep(settle_s)  # let migrations/replicas land
            elif kind == REC_WINDOW:
                target = self.frontend_for(rec.source)
                keys = _decode_keys(rec.keys, target)
                res = target.rate_limit_batch(
                    keys,
                    rec.params[:, 0], rec.params[:, 1],
                    rec.params[:, 2], rec.params[:, 3], rec.now_ns,
                )
                out.append((
                    np.asarray(res.allowed, np.uint8).copy(),
                    np.asarray(res.status, np.uint8).copy(),
                ))
                wi += 1
        return out

    def close(self) -> None:
        for i in range(self.n_nodes):
            try:
                self.kill(i)
            except Exception:
                pass


class _ReplayNode:
    """One in-process node: device limiter + cluster tier + RPC server
    on a dedicated event-loop thread (the chaos-suite harness shape)."""

    def __init__(self, index, nodes, capacity, device="cuda", **kw):
        import asyncio
        import threading

        from ..parallel.cluster import ClusterLimiter, ClusterServer
        from ..tpu.limiter import TorchRateLimiter

        kw.setdefault("vnodes", 64)
        kw.setdefault("replicate", True)
        kw.setdefault("io_timeout_s", 60.0)
        kw.setdefault("handoff_timeout_s", 4.0)
        self.index = index
        self.limiter = TorchRateLimiter(capacity=capacity, device=device)
        self.cl = ClusterLimiter(self.limiter, nodes, index, **kw)
        port = int(nodes[index].rpartition(":")[2])
        self.srv = ClusterServer(
            "127.0.0.1", port, self.cl.local, self.cl.device_lock,
            cluster=self.cl,
        )
        self.loop = asyncio.new_event_loop()
        self._thread = threading.Thread(
            target=self._run, name=f"replay-node{index}", daemon=True
        )
        self._thread.start()
        asyncio.run_coroutine_threadsafe(
            self.srv.start(), self.loop
        ).result(timeout=10)

    def _run(self):
        import asyncio

        asyncio.set_event_loop(self.loop)
        self.loop.run_forever()

    def announce(self):
        self.cl.announce_join_all()

    def kill(self):
        import asyncio

        asyncio.run_coroutine_threadsafe(
            self.srv.stop(), self.loop
        ).result(timeout=10)
        self.cl.close()
        self.loop.call_soon_threadsafe(self.loop.stop)
        self._thread.join(timeout=5)

    def leave(self):
        """Planned departure: hand the key range off (zero-staleness
        path), then tear down like kill()."""
        self.cl.leave()
        self.kill()
