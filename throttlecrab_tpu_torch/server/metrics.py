"""Server metrics with Prometheus text export.

The counters the engine and the transports touch, under the metric
names of `throttlecrab_tpu/server/metrics.py` (the reference's names,
`metrics.rs:233-310`, plus the `throttlecrab_tpu_*` launch/sweep,
front-tier, supervisor, fault-injection, insight, control-plane and
checkpoint extensions, and the cluster tier's `throttlecrab_cluster_*`
per-peer counters and membership gauges), so dashboards
read either server unchanged, and the reference's top-denied leaderboard
`throttlecrab_top_denied_keys{key,rank}` (`metrics.rs:24-76`).
Invariant: allowed + denied + errors == total.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional, Tuple

from ..faults import active_injector
from ..insight.sketch import SpaceSavingSketch
from .supervisor import STATE_GAUGE

MAX_KEY_LENGTH = 256  # metrics.rs:21
MAX_TRACKED_DENIED_KEYS = 10_000  # metrics.rs:119-121

METRIC_NAMES = (
    "throttlecrab_uptime_seconds",
    "throttlecrab_requests_total",
    "throttlecrab_requests_by_transport",
    "throttlecrab_requests_allowed",
    "throttlecrab_requests_denied",
    "throttlecrab_requests_errors",
    "throttlecrab_top_denied_keys",
    "throttlecrab_tpu_device_launches",
    "throttlecrab_tpu_batched_requests",
    "throttlecrab_tpu_max_batch_size",
    "throttlecrab_tpu_sweeps",
    "throttlecrab_tpu_expired_hits",
    "throttlecrab_tpu_slots_freed",
    "throttlecrab_tpu_front_deny_hits",
    "throttlecrab_tpu_front_shed",
    "throttlecrab_tpu_front_stale_evictions",
    "throttlecrab_tpu_front_deny_cache_size",
    "throttlecrab_tpu_engine_state",
    "throttlecrab_tpu_supervisor_retries",
    "throttlecrab_tpu_supervisor_degrades",
    "throttlecrab_tpu_supervisor_repromotes",
    "throttlecrab_tpu_drain_shed_total",
    "throttlecrab_tpu_deadline_shed_total",
    "throttlecrab_tpu_faults_injected_total",
    # Cluster tier (parallel/cluster.py + parallel/ring.py).
    "throttlecrab_cluster_forwarded_total",
    "throttlecrab_cluster_failed_total",
    "throttlecrab_cluster_breaker_open",
    "throttlecrab_cluster_migrated_keys",
    "throttlecrab_cluster_migrated_in_total",
    "throttlecrab_cluster_replica_rows",
    "throttlecrab_cluster_takeovers_total",
    "throttlecrab_cluster_leaves_total",
    "throttlecrab_cluster_epoch",
    # Insight tier (insight/).
    "throttlecrab_tpu_insight_allowed_rate",
    "throttlecrab_tpu_insight_denied_rate",
    "throttlecrab_tpu_insight_hot_concentration",
    "throttlecrab_tpu_insight_tracked_keys",
    "throttlecrab_tpu_insight_prewarmed_total",
    "throttlecrab_tpu_insight_polls",
    # Tenant/namespace layer (sharded mesh, parallel/tenants.py):
    # mesh-global per-tenant counters.
    "throttlecrab_tpu_tenant_allowed",
    "throttlecrab_tpu_tenant_denied",
    "throttlecrab_tpu_tenant_quota_rejections",
    # Control plane (control/).
    "throttlecrab_tpu_control_ticks",
    "throttlecrab_tpu_control_actuations",
    "throttlecrab_tpu_control_clamped",
    "throttlecrab_tpu_control_objective",
    "throttlecrab_tpu_control_shed_rate",
    # Crash durability (persist/): checkpoint chain + boot recovery.
    "throttlecrab_tpu_checkpoint_generation",
    "throttlecrab_tpu_checkpoint_age_seconds",
    "throttlecrab_tpu_checkpoint_duration_seconds",
    "throttlecrab_tpu_checkpoint_bytes",
    "throttlecrab_tpu_checkpoint_corrupt_skipped_total",
    "throttlecrab_tpu_checkpoint_recoveries_total",
)


class TopDeniedKeys:
    """Bounded denied-key counter (metrics.rs:24-76) over the space-saving
    sketch: exact while the distinct denied keys fit `max_keys`, then
    bounded with a per-key error.  Keys are cut at 256 characters."""

    def __init__(self, max_keys: int) -> None:
        self.max_keys = max_keys
        self._sketch = (
            SpaceSavingSketch(max_keys) if max_keys > 0 else None
        )

    def record(self, key: str) -> None:
        if self._sketch is None:
            return
        self._sketch.record(key[:MAX_KEY_LENGTH])

    def top(self) -> List[Tuple[str, int]]:
        if self._sketch is None:
            return []
        return self._sketch.top(self.max_keys)


class Metrics:
    """Request counters + optional top-denied-keys tracking (thread-safe:
    worker threads write here too)."""

    def __init__(self, max_denied_keys: int = 0) -> None:
        self._lock = threading.Lock()
        self.start_time = time.time()
        self.requests_total = 0
        self.requests_by_transport: Dict[str, int] = {
            "http": 0,
            "grpc": 0,
            "redis": 0,
        }
        self.requests_allowed = 0
        self.requests_denied = 0
        self.requests_errors = 0
        max_denied_keys = min(max_denied_keys, MAX_TRACKED_DENIED_KEYS)
        self.top_denied: Optional[TopDeniedKeys] = (
            TopDeniedKeys(max_denied_keys) if max_denied_keys > 0 else None
        )
        self.device_launches = 0
        self.batched_requests = 0
        self.max_batch = 0
        self.sweeps = 0
        self.slots_freed = 0
        self.expired_hits = 0
        # Front tier (deny cache + admission control).
        self.front_deny_hits = 0
        self.front_shed_peek = 0
        self.front_shed_consume = 0
        self.front_stale_evictions = 0
        self._front_stats = None
        # Failure-domain supervision (server/supervisor.py).
        self.supervisor_retries = 0
        self.supervisor_degrades = 0
        self.supervisor_repromotes = 0
        self._engine_state = None
        self.drain_shed = 0
        self.deadline_shed = 0
        self._insight_stats = None
        self._control_stats = None
        self._checkpoint_stats = None
        self._tenant_stats = None
        self._cluster_stats = None
        self._cluster_view = None

    @classmethod
    def builder(cls) -> "MetricsBuilder":
        return MetricsBuilder()

    def record_request(self, transport: str, allowed: bool) -> None:
        with self._lock:
            self.requests_total += 1
            if transport in self.requests_by_transport:
                self.requests_by_transport[transport] += 1
            if allowed:
                self.requests_allowed += 1
            else:
                self.requests_denied += 1

    def record_request_with_key(
        self, transport: str, allowed: bool, key: str
    ) -> None:
        """metrics.rs:162-173: denied keys feed the leaderboard."""
        self.record_request(transport, allowed)
        if not allowed and self.top_denied is not None:
            with self._lock:
                self.top_denied.record(key)

    def record_error(self, transport: str) -> None:
        with self._lock:
            self.requests_total += 1
            if transport in self.requests_by_transport:
                self.requests_by_transport[transport] += 1
            self.requests_errors += 1

    def record_batch(
        self, transport, n_allowed, n_denied, n_errors, denied_keys, batch,
        launches: int = 1,
    ) -> None:
        """One aggregated update per window of a native transport's
        driver thread (`launches=0`: a window answered without the
        device, e.g. every row's deadline had lapsed).  `denied_keys`
        feeds the top-denied leaderboard."""
        with self._lock:
            n = n_allowed + n_denied + n_errors
            self.requests_total += n
            if transport in self.requests_by_transport:
                self.requests_by_transport[transport] += n
            self.requests_allowed += n_allowed
            self.requests_denied += n_denied
            self.requests_errors += n_errors
            if self.top_denied is not None:
                for key in denied_keys:
                    self.top_denied.record(key)
            self.device_launches += launches
            if launches:
                self.batched_requests += batch
                self.max_batch = max(self.max_batch, batch)

    def record_launch(self, batch_size: int) -> None:
        with self._lock:
            self.device_launches += 1
            self.batched_requests += batch_size
            self.max_batch = max(self.max_batch, batch_size)

    def record_sweep(self, freed: int) -> None:
        with self._lock:
            self.sweeps += 1
            self.slots_freed += freed

    def record_expired_hits(self, n: int) -> None:
        with self._lock:
            self.expired_hits += n

    def record_front_hit(self) -> None:
        """A denial served exactly from the deny cache (no launch)."""
        with self._lock:
            self.front_deny_hits += 1

    def record_front_hits(self, n: int) -> None:
        """Bulk form: one window's deny-cache hit count."""
        with self._lock:
            self.front_deny_hits += n

    def record_front_shed(self, peek: bool) -> None:
        """A request shed by admission control, by priority class."""
        with self._lock:
            if peek:
                self.front_shed_peek += 1
            else:
                self.front_shed_consume += 1

    def record_front_stale(self, n: int) -> None:
        """Deny-cache entries evicted because their proven window (or
        their bucket's TTL) lapsed."""
        with self._lock:
            self.front_stale_evictions += n

    def record_supervisor_retry(self, n: int = 1) -> None:
        """A transient device fault absorbed by a launch/fetch retry."""
        with self._lock:
            self.supervisor_retries += n

    def record_supervisor_degrade(self) -> None:
        """Persistent device failure: serving fell back to the host
        scalar oracle."""
        with self._lock:
            self.supervisor_degrades += 1

    def record_supervisor_repromote(self) -> None:
        """Device recovery: host-mutated state re-promoted on-device."""
        with self._lock:
            self.supervisor_repromotes += 1

    def set_engine_state_provider(self, provider) -> None:
        """`provider()` -> "ok"|"retrying"|"degraded"|"recovering";
        exported as the throttlecrab_tpu_engine_state gauge."""
        self._engine_state = provider

    def set_front_stats_provider(self, provider) -> None:
        """`provider()` -> {"deny_cache_size": n} (FrontTier.stats)."""
        self._front_stats = provider

    def set_insight_stats_provider(self, provider) -> None:
        """`provider()` -> InsightTier.metric_stats(); exported as the
        throttlecrab_tpu_insight_* gauges (zeros when absent)."""
        self._insight_stats = provider

    def set_control_stats_provider(self, provider) -> None:
        """`provider()` -> ControlPlane.metric_stats(); exported as the
        throttlecrab_tpu_control_* gauges (zeros when absent)."""
        self._control_stats = provider

    def set_checkpoint_stats_provider(self, provider) -> None:
        """`provider()` -> Checkpointer.metric_stats(); exported as the
        throttlecrab_tpu_checkpoint_* gauges (-1 / 0 when disarmed)."""
        self._checkpoint_stats = provider

    def set_tenant_stats_provider(self, provider) -> None:
        """`provider()` -> ShardedTorchRateLimiter.tenant_stats();
        exported as per-tenant allowed/denied/quota-rejection counters
        (sharded deployments with the tenant layer armed)."""
        self._tenant_stats = provider

    def set_cluster_stats_provider(self, provider) -> None:
        """`provider()` -> {peer_addr: {"forwarded": n, "failed": n,
        "breaker_open": 0|1, "migrated_keys": n}}; exported as per-peer
        counters (cluster deployments only)."""
        self._cluster_stats = provider

    def set_cluster_view_provider(self, provider) -> None:
        """`provider()` -> ClusterLimiter.cluster_view(); exported as
        the cluster-scalar gauges (epoch, replica rows, takeovers) and
        served on GET /health/cluster (cluster deployments only)."""
        self._cluster_view = provider

    def record_drain_shed(self, n: int = 1) -> None:
        with self._lock:
            self.drain_shed += n

    def record_deadline_shed(self, n: int = 1) -> None:
        with self._lock:
            self.deadline_shed += n

    def uptime_seconds(self) -> int:
        return int(time.time() - self.start_time)

    def export_prometheus(self) -> str:
        """Prometheus text format, reference names (metrics.rs:233-310)."""
        out = []

        def metric(name, help_, typ, value):
            out.append(f"# HELP {name} {help_}")
            out.append(f"# TYPE {name} {typ}")
            out.append(f"{name} {value}")

        metric("throttlecrab_uptime_seconds", "Server uptime in seconds",
               "counter", self.uptime_seconds())
        metric("throttlecrab_requests_total", "Total number of requests",
               "counter", self.requests_total)
        out.append(
            "# HELP throttlecrab_requests_by_transport "
            "Requests by transport type"
        )
        out.append("# TYPE throttlecrab_requests_by_transport counter")
        for transport, count in sorted(self.requests_by_transport.items()):
            out.append(
                f'throttlecrab_requests_by_transport{{transport="{transport}"}}'
                f" {count}"
            )
        metric("throttlecrab_requests_allowed", "Number of allowed requests",
               "counter", self.requests_allowed)
        metric("throttlecrab_requests_denied", "Number of denied requests",
               "counter", self.requests_denied)
        metric("throttlecrab_requests_errors", "Number of error responses",
               "counter", self.requests_errors)
        if self.top_denied is not None:
            out.append(
                "# HELP throttlecrab_top_denied_keys "
                "Top denied keys by count"
            )
            out.append("# TYPE throttlecrab_top_denied_keys gauge")
            for rank, (key, count) in enumerate(self.top_denied.top(), 1):
                escaped = escape_label_value(key)
                out.append(
                    f'throttlecrab_top_denied_keys{{key="{escaped}",'
                    f'rank="{rank}"}} {count}'
                )
        metric("throttlecrab_tpu_device_launches",
               "Number of device kernel launches", "counter",
               self.device_launches)
        metric("throttlecrab_tpu_batched_requests",
               "Requests decided through batched launches", "counter",
               self.batched_requests)
        metric("throttlecrab_tpu_max_batch_size",
               "Largest batch coalesced into one launch", "gauge",
               self.max_batch)
        metric("throttlecrab_tpu_sweeps", "Expiry compaction sweeps executed",
               "counter", self.sweeps)
        metric("throttlecrab_tpu_expired_hits",
               "Requests that landed on expired entries "
               "(kernel-counted; drives the adaptive cleanup trigger)",
               "counter", self.expired_hits)
        metric("throttlecrab_tpu_slots_freed",
               "Slots freed by compaction sweeps", "counter",
               self.slots_freed)
        metric("throttlecrab_tpu_front_deny_hits",
               "Denials served exactly from the deny cache "
               "(no engine round trip)", "counter", self.front_deny_hits)
        out.append("# HELP throttlecrab_tpu_front_shed Requests shed by "
                   "admission control, by priority class")
        out.append("# TYPE throttlecrab_tpu_front_shed counter")
        out.append('throttlecrab_tpu_front_shed{class="peek"} '
                   f"{self.front_shed_peek}")
        out.append('throttlecrab_tpu_front_shed{class="consume"} '
                   f"{self.front_shed_consume}")
        metric("throttlecrab_tpu_front_stale_evictions",
               "Deny-cache entries evicted after their proven window "
               "or bucket TTL lapsed", "counter",
               self.front_stale_evictions)
        front_stats = self._front_stats() if self._front_stats else {}
        metric("throttlecrab_tpu_front_deny_cache_size",
               "Live deny-cache entries", "gauge",
               front_stats.get("deny_cache_size", 0))
        state = self._engine_state() if self._engine_state else "ok"
        metric("throttlecrab_tpu_engine_state",
               "Serving state: 0=ok 1=retrying 2=degraded 3=recovering",
               "gauge", STATE_GAUGE.get(state, 0))
        metric("throttlecrab_tpu_supervisor_retries",
               "Transient device faults absorbed by launch/fetch retries",
               "counter", self.supervisor_retries)
        metric("throttlecrab_tpu_supervisor_degrades",
               "Transitions into host-oracle degraded mode", "counter",
               self.supervisor_degrades)
        metric("throttlecrab_tpu_supervisor_repromotes",
               "Recoveries that re-promoted host state onto the device",
               "counter", self.supervisor_repromotes)
        metric("throttlecrab_tpu_drain_shed_total",
               "Arrivals refused while draining (balancers should have "
               "de-routed; the stragglers get 503)", "counter",
               self.drain_shed)
        metric("throttlecrab_tpu_deadline_shed_total",
               "Requests shed host-side because their client deadline "
               "lapsed before device dispatch", "counter",
               self.deadline_shed)
        # Per-site fired counts of the armed injector (faults/).
        out.append("# HELP throttlecrab_tpu_faults_injected_total Injected "
                   "faults fired, by site (0 lines when disarmed)")
        out.append("# TYPE throttlecrab_tpu_faults_injected_total counter")
        injector = active_injector()
        fault_stats = injector.stats() if injector is not None else {}
        for site, fired in sorted(fault_stats.items()):
            out.append("throttlecrab_tpu_faults_injected_total"
                       f'{{site="{escape_label_value(site)}"}} {fired}')
        if not fault_stats:
            out.append("throttlecrab_tpu_faults_injected_total 0")
        ins = self._insight_stats() if self._insight_stats else {}
        metric("throttlecrab_tpu_insight_allowed_rate",
               "Allowed decisions/s over the insight window", "gauge",
               ins.get("allowed_rate", 0))
        metric("throttlecrab_tpu_insight_denied_rate",
               "Denied decisions/s over the insight window", "gauge",
               ins.get("denied_rate", 0))
        metric("throttlecrab_tpu_insight_hot_concentration",
               "Share of recent denials landing on the device top-K "
               "hot set", "gauge", ins.get("hot_concentration", 0))
        metric("throttlecrab_tpu_insight_tracked_keys",
               "Keys tracked by the space-saving hot-key sketch", "gauge",
               ins.get("tracked_keys", 0))
        metric("throttlecrab_tpu_insight_prewarmed_total",
               "Hot-denied keys refreshed into the deny cache by the "
               "insight feedback loop", "counter",
               ins.get("prewarmed_total", 0))
        metric("throttlecrab_tpu_insight_polls",
               "Device insight polls (accumulator fetch + top-K launch)",
               "counter", ins.get("polls", 0))
        ctl = self._control_stats() if self._control_stats else {}
        metric("throttlecrab_tpu_control_ticks",
               "Control-plane ticks (sensor snapshot + controller step)",
               "counter", ctl.get("ticks", 0))
        metric("throttlecrab_tpu_control_actuations",
               "Knob moves applied through the actuator registry",
               "counter", ctl.get("actuations", 0))
        metric("throttlecrab_tpu_control_clamped",
               "Actuations clamped by declared bounds or rate limits",
               "counter", ctl.get("clamped", 0))
        metric("throttlecrab_tpu_control_objective",
               "Last multi-objective score "
               "(throughput / wait / fairness, weighted)",
               "gauge", ctl.get("objective", 0))
        metric("throttlecrab_tpu_control_shed_rate",
               "Shed fraction of arrivals over the last control tick",
               "gauge", ctl.get("shed_rate", 0))
        ck = self._checkpoint_stats() if self._checkpoint_stats else {}
        metric("throttlecrab_tpu_checkpoint_generation",
               "Newest durable checkpoint generation (-1: none yet)",
               "gauge", ck.get("generation", -1))
        metric("throttlecrab_tpu_checkpoint_age_seconds",
               "Seconds since the last durable checkpoint "
               "(-1: none yet / disarmed)", "gauge",
               ck.get("age_seconds", -1))
        metric("throttlecrab_tpu_checkpoint_duration_seconds",
               "Wall time of the last checkpoint write "
               "(encode + CRC + fsync, outside the limiter lock)", "gauge",
               ck.get("duration_seconds", 0))
        metric("throttlecrab_tpu_checkpoint_bytes",
               "Size of the last checkpoint generation on disk", "gauge",
               ck.get("bytes", 0))
        metric("throttlecrab_tpu_checkpoint_corrupt_skipped_total",
               "Torn/corrupt generations dropped by boot recovery's "
               "generation-by-generation fallback", "counter",
               ck.get("corrupt_skipped_total", 0))
        metric("throttlecrab_tpu_checkpoint_recoveries_total",
               "Boot-time recoveries that restored a checkpoint chain",
               "counter", ck.get("recoveries_total", 0))
        if self._tenant_stats is not None:
            # Tenant/namespace layer (sharded mesh deployments only).
            stats = self._tenant_stats()
            for name, field, help_ in (
                ("throttlecrab_tpu_tenant_allowed", "allowed",
                 "Allowed decisions per tenant (mesh-global, "
                 "psum-reduced in-launch)"),
                ("throttlecrab_tpu_tenant_denied", "denied",
                 "Denied decisions per tenant (mesh-global, "
                 "psum-reduced in-launch)"),
                ("throttlecrab_tpu_tenant_quota_rejections",
                 "quota_rejections",
                 "New keys refused by the per-tenant slot-capacity "
                 "quota"),
            ):
                out.append(f"# HELP {name} {help_}")
                out.append(f"# TYPE {name} counter")
                for tenant, counts in sorted(stats.items()):
                    escaped = escape_label_value(tenant)
                    out.append(
                        f'{name}{{tenant="{escaped}"}} {counts[field]}'
                    )
        if self._cluster_stats is not None:
            stats = self._cluster_stats()
            for name, field, typ, help_ in (
                ("throttlecrab_cluster_forwarded_total", "forwarded",
                 "counter", "Batches forwarded to each cluster peer"),
                ("throttlecrab_cluster_failed_total", "failed",
                 "counter", "Forward failures per cluster peer"),
                ("throttlecrab_cluster_breaker_open", "breaker_open",
                 "gauge",
                 "1 while the peer's circuit breaker is open (its key "
                 "range is failing over to ring successors)"),
                ("throttlecrab_cluster_migrated_keys", "migrated_keys",
                 "counter",
                 "Keys handed off to each peer by ring migrations "
                 "(join/reweight/rejoin)"),
            ):
                out.append(f"# HELP {name} {help_}")
                out.append(f"# TYPE {name} {typ}")
                for peer, counts in sorted(stats.items()):
                    escaped = escape_label_value(peer)
                    out.append(
                        f'{name}{{peer="{escaped}"}} '
                        f'{counts.get(field, 0)}'
                    )
        if self._cluster_view is not None:
            view = self._cluster_view()
            metric("throttlecrab_cluster_epoch",
                   "Cluster membership epoch (bumps on join/reweight)",
                   "gauge", view.get("epoch", 0))
            metric("throttlecrab_cluster_migrated_in_total",
                   "Keys received through ring migrations",
                   "counter", view.get("migrated_in", 0))
            metric("throttlecrab_cluster_replica_rows",
                   "Warm-standby replica rows held for ring predecessors",
                   "gauge", view.get("replica_rows", 0))
            metric("throttlecrab_cluster_takeovers_total",
                   "Dead-peer ranges absorbed from the warm replica",
                   "counter", view.get("takeovers", 0))
            metric("throttlecrab_cluster_leaves_total",
                   "Planned departures observed (own leave + peers' "
                   "OP_LEAVE announcements applied)",
                   "counter", view.get("leaves", 0))
        return "\n".join(out) + "\n"


def merge_cluster_stats(payload: str, limiter) -> str:
    """Fold the cluster view into a /stats JSON payload (shared by the
    python HTTP route and the native wire driver's pushed snapshot, so
    the two transports cannot diverge).  Non-cluster limiters return
    the payload untouched."""
    view_fn = getattr(limiter, "cluster_view", None)
    if view_fn is None:
        return payload
    import json

    stats = json.loads(payload)
    stats["cluster"] = view_fn()
    return json.dumps(stats)


def escape_label_value(value: str) -> str:
    """Prometheus label escaping (metrics.rs:213-230)."""
    return (
        value.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")
    )


class MetricsBuilder:
    """Builder mirroring metrics.rs:101-142."""

    def __init__(self) -> None:
        self._max_denied_keys = 0

    def max_denied_keys(self, n: int) -> "MetricsBuilder":
        self._max_denied_keys = n
        return self

    def build(self) -> Metrics:
        return Metrics(max_denied_keys=self._max_denied_keys)
