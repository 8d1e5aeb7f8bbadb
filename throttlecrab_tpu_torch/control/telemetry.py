"""Sensor bus: one typed `Telemetry` record per control tick.

The port of `throttlecrab_tpu/control/telemetry.py`.  The control plane
never reaches into subsystems mid-decision — every signal it acts on is
snapshotted here, once per tick, into an immutable record.  That buys
three things the feedback literature (and arXiv:2511.03279) asks for:

* **consistency** — a controller reasons about one coherent instant,
  not a smear of counters read at different times;
* **replayability** — a `Telemetry` is plain data, so the offline
  policy search (control/replayer.py) can synthesize the identical
  records a live tick would have seen;
* **lock discipline** — the snapshot runs under the same limiter-lock
  hold the insight poll uses (engine._maybe_sweep → executor): on a
  card, reading the insight totals fetches them from the device, which
  syncs the table's stream.  The leaf locks it touches (insight,
  admission, metrics) are taken after the control plane's own lock,
  never before it.

Sensors: engine queue depth + EWMA wait (admission's cost model),
front-tier shed/deny-cache counters, insight hot-set concentration +
top-K churn, and, on a limiter that has them (none in the port yet), the
cluster view's per-node load skew and per-tenant served counts: the
``getattr`` guards read them as absent.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional


@dataclass(frozen=True)
class Telemetry:
    """One control tick's coherent sensor snapshot (all cumulative
    counters are totals-so-far; the controllers difference consecutive
    records themselves)."""

    now_ns: int
    # Engine (L3): pending-queue depth and the admission cost model's
    # view of it.
    queue_depth: int = 0
    est_wait_us: float = 0.0
    cost_us: float = 0.0
    # Front tier (L3.5): cumulative shed + deny-cache counters.
    shed_peek: int = 0
    shed_consume: int = 0
    deny_hits: int = 0
    deny_cache_size: int = 0
    # Decision totals (insight tier when present, else the simulator's
    # own counts): cumulative allowed/denied across every serving path.
    allowed_total: int = 0
    denied_total: int = 0
    # Insight tier (L3.75): hot-set concentration + top-K churn (the
    # fraction of the current top-K that was NOT in the previous
    # tick's top-K — 0 = stable hot set, 1 = full turnover).
    hot_concentration: float = 0.0
    topk_churn: float = 0.0
    # Cluster view: per-node load skew (max/mean replica+forward load,
    # 0 when single-node or unknown).
    load_skew: float = 0.0
    # Per-tenant served counts for the fairness term (empty when the
    # tenant layer is absent).
    tenant_served: dict = field(default_factory=dict)

    @property
    def served_total(self) -> int:
        return self.allowed_total + self.denied_total

    @property
    def shed_total(self) -> int:
        return self.shed_peek + self.shed_consume


def shed_fraction(prev: Optional[Telemetry], cur: Telemetry) -> float:
    """Fraction of this tick's arrivals that admission shed (0 when
    nothing arrived)."""
    if prev is None:
        shed, served = cur.shed_total, cur.served_total
    else:
        shed = cur.shed_total - prev.shed_total
        served = cur.served_total - prev.served_total
    offered = shed + served
    return shed / offered if offered > 0 else 0.0


class SensorBus:
    """Snapshots a `Telemetry` from the live subsystems.

    Pure reader: holds no lock of its own; callers (ControlPlane.tick)
    run it under the control lock, and the leaf locks the getters take
    (InsightTier._lock, AdmissionController._lock, Metrics._lock) all
    rank above it.  Any subsystem may be absent — its sensors read as
    zeros, so one bus shape serves every deployment and the simulator.
    """

    def __init__(self, front=None, insight=None, metrics=None,
                 limiter=None) -> None:
        self.front = front
        self.insight = insight
        self.metrics = metrics
        self.limiter = limiter
        self._last_topk: frozenset = frozenset()

    def snapshot(self, now_ns: int, queue_depth: int = 0) -> Telemetry:
        admission = getattr(self.front, "admission", None)
        est_wait_us = cost_us = 0.0
        shed_peek = shed_consume = 0
        if admission is not None:
            cost_us = admission._cost_us
            est_wait_us = admission.estimated_wait_us(queue_depth)
            shed_peek = admission.shed_peek
            shed_consume = admission.shed_consume
        deny_hits = deny_cache_size = 0
        if self.front is not None:
            deny_cache_size = self.front.stats().get("deny_cache_size", 0)
        if self.metrics is not None:
            deny_hits = getattr(self.metrics, "front_deny_hits", 0)
        allowed_total = denied_total = 0
        hot_concentration = topk_churn = 0.0
        insight = self.insight
        if insight is not None:
            with insight._lock:
                allowed_total, denied_total = insight._totals_locked()
                hot_concentration = insight.hot_concentration
                top = frozenset(
                    k for k, _ in insight.sketch.top(insight.topk)
                )
            if top:
                stale = self._last_topk
                if stale:
                    topk_churn = len(top - stale) / len(top)
                self._last_topk = top
        load_skew = 0.0
        tenant_served: dict = {}
        limiter = self.limiter
        if limiter is not None:
            view_fn = getattr(limiter, "cluster_view", None)
            if view_fn is not None:
                try:
                    load_skew = _view_skew(view_fn())
                except Exception:
                    load_skew = 0.0
            tenant_fn = getattr(limiter, "tenant_stats", None)
            if tenant_fn is not None:
                try:
                    tenant_served = {
                        t: row.get("allowed", 0) + row.get("denied", 0)
                        for t, row in tenant_fn().items()
                    }
                except Exception:
                    tenant_served = {}
        return Telemetry(
            now_ns=now_ns,
            queue_depth=queue_depth,
            est_wait_us=est_wait_us,
            cost_us=cost_us,
            shed_peek=shed_peek,
            shed_consume=shed_consume,
            deny_hits=deny_hits,
            deny_cache_size=deny_cache_size,
            allowed_total=allowed_total,
            denied_total=denied_total,
            hot_concentration=hot_concentration,
            topk_churn=topk_churn,
            load_skew=load_skew,
            tenant_served=tenant_served,
        )


def _view_skew(view: dict) -> float:
    """Per-node load skew from a cluster_view() document: max/mean of
    the per-peer forwarded counts (1.0 = perfectly even; grows as one
    node soaks the traffic)."""
    peers = view.get("peers")
    if not isinstance(peers, dict) or not peers:
        return 0.0
    loads = [
        float(p.get("forwarded", 0))
        for p in peers.values()
        if isinstance(p, dict)
    ]
    if not loads or sum(loads) <= 0:
        return 0.0
    mean = sum(loads) / len(loads)
    return max(loads) / mean if mean > 0 else 0.0


def jain_fairness(served: dict) -> float:
    """Jain's fairness index over per-tenant served counts (1.0 when
    perfectly even or when fewer than two tenants are visible)."""
    xs = [float(v) for v in served.values() if v > 0]
    if len(xs) < 2:
        return 1.0
    s = sum(xs)
    sq = sum(x * x for x in xs)
    return (s * s) / (len(xs) * sq) if sq > 0 else 1.0
