"""Server metrics with Prometheus text export.

The counters the engine and the transports touch, under the metric
names of `throttlecrab_tpu/server/metrics.py` (the reference's names,
`metrics.rs:233-310`, plus the `throttlecrab_tpu_*` launch/sweep
extensions), so dashboards read either server unchanged.  Invariant:
allowed + denied + errors == total.
"""

from __future__ import annotations

import threading
import time
from typing import Dict

METRIC_NAMES = (
    "throttlecrab_uptime_seconds",
    "throttlecrab_requests_total",
    "throttlecrab_requests_by_transport",
    "throttlecrab_requests_allowed",
    "throttlecrab_requests_denied",
    "throttlecrab_requests_errors",
    "throttlecrab_tpu_device_launches",
    "throttlecrab_tpu_batched_requests",
    "throttlecrab_tpu_max_batch_size",
    "throttlecrab_tpu_sweeps",
    "throttlecrab_tpu_expired_hits",
    "throttlecrab_tpu_slots_freed",
    "throttlecrab_tpu_drain_shed_total",
    "throttlecrab_tpu_deadline_shed_total",
)


class Metrics:
    """Request counters (thread-safe: worker threads write here too)."""

    def __init__(self) -> None:
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
        self.device_launches = 0
        self.batched_requests = 0
        self.max_batch = 0
        self.sweeps = 0
        self.slots_freed = 0
        self.expired_hits = 0
        self.drain_shed = 0
        self.deadline_shed = 0

    def record_request(self, transport: str, allowed: bool) -> None:
        with self._lock:
            self.requests_total += 1
            if transport in self.requests_by_transport:
                self.requests_by_transport[transport] += 1
            if allowed:
                self.requests_allowed += 1
            else:
                self.requests_denied += 1

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
        feeds the top-denied leaderboard in the JAX package; the port
        has none yet and ignores it."""
        with self._lock:
            n = n_allowed + n_denied + n_errors
            self.requests_total += n
            if transport in self.requests_by_transport:
                self.requests_by_transport[transport] += n
            self.requests_allowed += n_allowed
            self.requests_denied += n_denied
            self.requests_errors += n_errors
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
        metric("throttlecrab_tpu_drain_shed_total",
               "Arrivals refused while draining (balancers should have "
               "de-routed; the stragglers get 503)", "counter",
               self.drain_shed)
        metric("throttlecrab_tpu_deadline_shed_total",
               "Requests shed host-side because their client deadline "
               "lapsed before device dispatch", "counter",
               self.deadline_shed)
        return "\n".join(out) + "\n"
