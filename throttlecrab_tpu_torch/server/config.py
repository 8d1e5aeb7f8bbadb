"""Server configuration: CLI flags + THROTTLECRAB_* environment variables.

The flags of `throttlecrab_tpu/server/config.py`, with the same
precedence (CLI > env > default, `config.rs:356-361`): the HTTP, gRPC and
Redis/RESP transports and their backends (asyncio or the native C++ wire
server), the store (which picks the cleanup policy) and its cleanup
knobs, the reference's buffer size (accepted, unused) and top-denied
leaderboard size, the micro-batching knobs, the keymap backend, the
sharded mesh (`--shards`) and its tenant layer (`--tenant-*`), the
profiler capture (`--profile-dir`), the front tier (deny cache and
admission control), the boot/shutdown snapshot, crash-durability
checkpoints, the insight tier, the launch supervisor and fault
injection, the flight recorder (`--trace-*`), the SIGTERM drain budget
and the default request deadline, the adaptive control plane
(`--control*`), and `--device` / THROTTLECRAB_DEVICE (default `cuda`;
`cpu` runs the plain version).

`--pallas-fused` parses and changes nothing: the port has one route, the
hand-written decision-window kernel.  The `--cluster-*` flags build the
multi-node cluster tier (`parallel/cluster.py`) with JAX's validation.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys
from typing import List, Optional

from ..faults import parse_spec

STORE_TYPES = ("periodic", "probabilistic", "adaptive")

# (flag, env, default, type, help)
_SPEC = [
    ("http", "THROTTLECRAB_HTTP", False, bool, "Enable HTTP transport"),
    ("http_host", "THROTTLECRAB_HTTP_HOST", "0.0.0.0", str, "HTTP host"),
    ("http_port", "THROTTLECRAB_HTTP_PORT", 8080, int, "HTTP port"),
    ("http_backend", "THROTTLECRAB_HTTP_BACKEND", "python", str,
     "HTTP transport backend: python (asyncio) or native (C++ epoll)"),
    ("grpc", "THROTTLECRAB_GRPC", False, bool, "Enable gRPC transport"),
    ("grpc_host", "THROTTLECRAB_GRPC_HOST", "0.0.0.0", str, "gRPC host"),
    ("grpc_port", "THROTTLECRAB_GRPC_PORT", 8070, int, "gRPC port"),
    ("redis", "THROTTLECRAB_REDIS", False, bool,
     "Enable Redis protocol transport"),
    ("redis_host", "THROTTLECRAB_REDIS_HOST", "0.0.0.0", str, "Redis host"),
    ("redis_port", "THROTTLECRAB_REDIS_PORT", 6379, int, "Redis port"),
    ("redis_backend", "THROTTLECRAB_REDIS_BACKEND", "python", str,
     "Redis transport backend: python (asyncio) or native (C++ epoll)"),
    ("store", "THROTTLECRAB_STORE", "periodic", str,
     "Store type: periodic, probabilistic, adaptive"),
    ("store_capacity", "THROTTLECRAB_STORE_CAPACITY", 100_000, int,
     "Initial store capacity"),
    ("store_cleanup_interval", "THROTTLECRAB_STORE_CLEANUP_INTERVAL", 300,
     int, "Cleanup interval for periodic store (seconds)"),
    ("store_cleanup_probability", "THROTTLECRAB_STORE_CLEANUP_PROBABILITY",
     10_000, int, "Cleanup probability for probabilistic store (1 in N)"),
    ("store_min_interval", "THROTTLECRAB_STORE_MIN_INTERVAL", 5, int,
     "Minimum cleanup interval for adaptive store (seconds)"),
    ("store_max_interval", "THROTTLECRAB_STORE_MAX_INTERVAL", 300, int,
     "Maximum cleanup interval for adaptive store (seconds)"),
    ("store_max_operations", "THROTTLECRAB_STORE_MAX_OPERATIONS", 1_000_000,
     int, "Maximum operations before cleanup for adaptive store"),
    ("buffer_size", "THROTTLECRAB_BUFFER_SIZE", 100_000, int,
     "Channel buffer size"),
    ("max_denied_keys", "THROTTLECRAB_MAX_DENIED_KEYS", 100, int,
     "Maximum number of denied keys to track in metrics "
     "(0 to disable, max: 10000)"),
    ("log_level", "THROTTLECRAB_LOG_LEVEL", "info", str,
     "Log level: error, warn, info, debug, trace"),
    ("batch_size", "THROTTLECRAB_BATCH_SIZE", 4096, int,
     "Max requests coalesced into one device launch"),
    ("max_linger_us", "THROTTLECRAB_MAX_LINGER_US", 200, int,
     "Max microseconds a request waits for its batch to fill"),
    ("max_scan_depth", "THROTTLECRAB_MAX_SCAN_DEPTH", 16, int,
     "Max backlog sub-batches decided in one device launch"),
    ("keymap", "THROTTLECRAB_KEYMAP", "auto", str,
     "Host key->slot backend: auto, python, native"),
    ("shards", "THROTTLECRAB_SHARDS", 1, int,
     "Number of devices to shard the bucket table over (on cuda the "
     "first N cards, refused when fewer exist; on cpu N shards of the "
     "one CPU device)"),
    # --- tenant/namespace layer (sharded mesh only, parallel/tenants.py)
    ("tenant_max", "THROTTLECRAB_TENANT_MAX", 64, int,
     "Max distinct tenants/namespaces tracked by the sharded mesh's "
     "per-tenant counters and quotas (key prefix before the first "
     "delimiter; extras share an overflow bucket; 0 disables the "
     "tenant layer entirely; needs --shards > 1)"),
    ("tenant_delim", "THROTTLECRAB_TENANT_DELIM", ":", str,
     "Single-byte delimiter separating the tenant/namespace prefix "
     "from the rest of the key"),
    ("tenant_quota", "THROTTLECRAB_TENANT_QUOTA", 0.0, float,
     "Per-tenant slot-capacity quota as a fraction of each shard's "
     "capacity (0 disables): new keys past the quota are refused with "
     "the tenant-quota status so one abusive tenant cannot fill the "
     "table and evict others' slots"),
    ("tenant_affinity", "THROTTLECRAB_TENANT_AFFINITY", False, bool,
     "Route keys by their tenant/namespace hash instead of the full "
     "key, making each tenant's keys shard-local (keys without a "
     "delimiter still spread by full-key hash)"),
    ("pallas_fused", "THROTTLECRAB_PALLAS_FUSED", False, bool,
     "Accepted for the JAX server's command lines and changes nothing: "
     "every decision window here is one launch of the hand-written "
     "CUDA kernel (the cpu device runs its plain version)"),
    ("profile_dir", "THROTTLECRAB_PROFILE_DIR", "", str,
     "Directory for a torch.profiler Chrome trace of the first launches "
     "(empty: off)"),
    # --- front tier (exact deny cache + admission control) -------------
    ("front_deny_cache", "THROTTLECRAB_FRONT_DENY_CACHE", 65536, int,
     "Deny-cache capacity in entries: provably exact repeat denials "
     "answer without a device launch (0 disables)"),
    ("front_max_pending", "THROTTLECRAB_FRONT_MAX_PENDING", 100_000, int,
     "Admission control: shed new arrivals with an overload status once "
     "this many requests are already queued (0 disables; the reference's "
     "full-channel backpressure, surfaced instead of silently awaited)"),
    ("front_max_wait_us", "THROTTLECRAB_FRONT_MAX_WAIT_US", 0, int,
     "Admission control: shed when the EWMA-estimated queue wait exceeds "
     "this many microseconds (0 disables)"),
    ("front_peek_frac", "THROTTLECRAB_FRONT_PEEK_FRAC", 0.9, float,
     "Fraction of each admission bound at which quantity-0 peek probes "
     "shed (they consume nothing; keep headroom for consuming checks)"),
    ("snapshot_path", "THROTTLECRAB_SNAPSHOT_PATH", "", str,
     "Snapshot file (.npz): restored at startup when present, written on "
     "graceful shutdown (empty: disabled; state is soft either way)"),
    ("snapshot_strict", "THROTTLECRAB_SNAPSHOT_STRICT", True, bool,
     "Refuse to start when the boot snapshot is corrupt/truncated "
     "(env 0 disables: log the corruption and start with an empty "
     "table instead)"),
    # --- crash durability (persist/) ------------------------------------
    ("checkpoint_interval_ms", "THROTTLECRAB_CHECKPOINT_INTERVAL_MS",
     0, int,
     "Milliseconds between background checkpoint generations (0 — the "
     "default — disables checkpointing entirely; needs "
     "--checkpoint-dir)"),
    ("checkpoint_dir", "THROTTLECRAB_CHECKPOINT_DIR", "", str,
     "Directory for generation-numbered, CRC-checksummed checkpoint "
     "chains (full base + incremental deltas).  At boot the newest "
     "verifiable chain is restored, falling back generation-by-"
     "generation past torn/corrupt files — never refusing to start "
     "(contrast THROTTLECRAB_SNAPSHOT_STRICT, which keeps its meaning "
     "for an explicitly-named boot snapshot)"),
    ("checkpoint_retain", "THROTTLECRAB_CHECKPOINT_RETAIN", 2, int,
     "Generation chains kept on disk (a new full base starts a chain "
     "and prunes the oldest beyond this bound; >= 1)"),
    ("checkpoint_mode", "THROTTLECRAB_CHECKPOINT_MODE", "incremental",
     str,
     "incremental (full base then deltas of slots dirtied since the "
     "previous generation, re-based periodically) or full (every "
     "generation is a complete base)"),
    # --- failure-domain supervision (server/supervisor.py, faults/) ----
    ("supervisor_retries", "THROTTLECRAB_SUPERVISOR_RETRIES", 3, int,
     "Max retries of a transient (UNAVAILABLE-shaped) device "
     "launch/fetch fault before the device is declared down"),
    ("supervisor_backoff_us", "THROTTLECRAB_SUPERVISOR_BACKOFF_US",
     2000, int,
     "Initial retry backoff in microseconds (doubles per retry)"),
    ("supervisor_backoff_max_us",
     "THROTTLECRAB_SUPERVISOR_BACKOFF_MAX_US", 50_000, int,
     "Retry backoff ceiling in microseconds"),
    ("supervisor_probe_interval_ms",
     "THROTTLECRAB_SUPERVISOR_PROBE_INTERVAL_MS", 1000, int,
     "Degraded mode: milliseconds between device recovery probes"),
    ("supervisor_mode", "THROTTLECRAB_SUPERVISOR_MODE", "degrade", str,
     "On persistent device failure: degrade (keep serving from the "
     "host scalar oracle, re-promote on recovery) or fail (error the "
     "affected batches)"),
    ("faults", "THROTTLECRAB_FAULTS", "", str,
     "Fault injection spec site:mode[:arg],... — sites launch, fetch, "
     "keymap, snapshot (peer, migrate, leave parse but have no site "
     "here); modes transient:p, persistent, count:n, hang:seconds, "
     "truncate:frac, fsyncfail (empty: off; see "
     "throttlecrab_tpu_torch/faults/)"),
    ("faults_seed", "THROTTLECRAB_FAULTS_SEED", 0, int,
     "Seed for the deterministic fault-injection probability stream"),
    # --- record/replay flight recorder (replay/) ------------------------
    ("trace_dir", "THROTTLECRAB_TRACE_DIR", "", str,
     "Arm the decision-trace flight recorder and write trace dumps "
     "into this directory (empty: off).  Dumps happen on persistent "
     "degrade, on GET /trace/dump, and at shutdown in full mode; "
     "replay them with python -m throttlecrab_tpu_torch.replay"),
    ("trace_windows", "THROTTLECRAB_TRACE_WINDOWS", 1024, int,
     "Ring mode: how many decided windows the flight recorder retains "
     "(the last-N post-mortem buffer)"),
    ("trace_mode", "THROTTLECRAB_TRACE_MODE", "ring", str,
     "ring (bounded last-N flight recorder, serving-safe default) or "
     "full (record every window incrementally to the trace file — the "
     "capture-for-replay mode)"),
    ("trace_dump_on_degrade", "THROTTLECRAB_TRACE_DUMP_ON_DEGRADE",
     True, bool,
     "Automatically dump the flight recorder when the supervisor "
     "declares the device down (persistent degrade), so every chaos "
     "failure leaves a replayable post-mortem artifact (env 0 "
     "disables)"),
    # --- cluster tier
    ("cluster_nodes", "THROTTLECRAB_CLUSTER_NODES", "", str,
     "Comma-separated host:port cluster RPC addresses of every node "
     "(same list on every node; empty: single-node)"),
    ("cluster_index", "THROTTLECRAB_CLUSTER_INDEX", 0, int,
     "This node's position in --cluster-nodes"),
    ("cluster_bind_host", "THROTTLECRAB_CLUSTER_BIND_HOST", "0.0.0.0", str,
     "Bind host for the cluster RPC listener"),
    ("cluster_timeout_ms", "THROTTLECRAB_CLUSTER_TIMEOUT_MS", 1000, int,
     "Per-peer forward deadline in milliseconds (must cover the owner's "
     "remote decision incl. one device launch)"),
    ("cluster_connect_timeout_ms",
     "THROTTLECRAB_CLUSTER_CONNECT_TIMEOUT_MS", 1000, int,
     "Per-peer TCP connect deadline in milliseconds"),
    ("cluster_breaker_failures", "THROTTLECRAB_CLUSTER_BREAKER_FAILURES",
     3, int, "Consecutive peer failures that open the circuit breaker"),
    ("cluster_breaker_cooldown_ms",
     "THROTTLECRAB_CLUSTER_BREAKER_COOLDOWN_MS", 1000, int,
     "Circuit-breaker cooldown before the next probe (milliseconds)"),
    ("cluster_vnodes", "THROTTLECRAB_CLUSTER_VNODES", 128, int,
     "Virtual nodes per cluster node on the consistent-hash ring "
     "(elastic membership: join/leave only remaps the affected vnode "
     "ranges).  0 is the kill switch: the legacy static crc32-modulo "
     "routing, bit-identical to the pre-ring cluster tier.  MUST be "
     "identical on every node — a mixed ring/modulo (or mixed-vnodes) "
     "cluster splits key ownership"),
    ("cluster_replicate", "THROTTLECRAB_CLUSTER_REPLICATE", True, bool,
     "Warm-standby replication (ring mode): each node streams async "
     "state deltas for its decided keys to their ring successor, so a "
     "dead node's range keeps serving from the replica instead of "
     "failing (env 0 disables; failover then starts those keys fresh)"),
    ("cluster_handoff_timeout_ms",
     "THROTTLECRAB_CLUSTER_HANDOFF_TIMEOUT_MS", 5000, int,
     "How long a joining node holds decisions on a gained key range "
     "waiting for the predecessor's migration before serving without "
     "it (milliseconds)"),
    ("cluster_replica_cap", "THROTTLECRAB_CLUSTER_REPLICA_CAP",
     100_000, int,
     "Bound on warm-standby replica rows held for ring predecessors "
     "(overflow evicts the coldest row)"),
    ("drain_timeout_ms", "THROTTLECRAB_DRAIN_TIMEOUT_MS", 10_000, int,
     "SIGTERM drain budget in milliseconds: stop accepting, flush "
     "in-flight batches with real decisions, run the planned cluster "
     "leave (zero-staleness handoff) and snapshot; past the budget "
     "the node falls back to the abrupt kill path (replica takeover "
     "bounds the damage).  0 skips the drain entirely — SIGTERM "
     "behaves like SIGINT"),
    ("deadline_default_ms", "THROTTLECRAB_DEADLINE_DEFAULT_MS", 0, int,
     "Default per-request deadline stamped on requests that carry "
     "none (milliseconds; 0, the default, stamps nothing).  Requests "
     "still queued past their deadline are shed before device dispatch "
     "with the timeout status (HTTP 504 / gRPC DEADLINE_EXCEEDED / "
     "RESP -ERR)"),
    # --- insight tier (L3.75: device-resident traffic analytics) --------
    ("insight", "THROTTLECRAB_INSIGHT", True, bool,
     "Insight tier: device-resident traffic analytics riding every "
     "decision launch, GET /stats, and the deny-cache/admission "
     "feedback loop (env 0 disables; the decision path is then "
     "bit-identical to the subsystem absent)"),
    ("insight_topk", "THROTTLECRAB_INSIGHT_TOPK", 64, int,
     "Device-side top-K size over the denied-hit column"),
    ("insight_sketch", "THROTTLECRAB_INSIGHT_SKETCH", 4096, int,
     "Host space-saving sketch capacity (hot-key tracking, keyed by "
     "real key bytes)"),
    ("insight_window_s", "THROTTLECRAB_INSIGHT_WINDOW_S", 10, int,
     "Sliding window for the /stats allowed/denied rates (seconds)"),
    ("insight_poll_ms", "THROTTLECRAB_INSIGHT_POLL_MS", 1000, int,
     "Cadence of the throttled device insight poll (accumulator fetch "
     "+ top-K; milliseconds)"),
    ("insight_decay_s", "THROTTLECRAB_INSIGHT_DECAY_S", 60, int,
     "Halving cadence of the device denied-hit column so the top-K "
     "tracks the current hot set (seconds; 0 never decays)"),
    ("insight_prewarm", "THROTTLECRAB_INSIGHT_PREWARM", 64, int,
     "Max confirmed hot-denied keys refreshed into the deny cache's "
     "eviction queue per poll (0 disables the prewarm feedback)"),
    ("insight_hot_denies", "THROTTLECRAB_INSIGHT_HOT_DENIES", 100, int,
     "Sketch count at which a denied key counts as confirmed-hot"),
    ("insight_shed_weight", "THROTTLECRAB_INSIGHT_SHED_WEIGHT", 0.0, float,
     "Scale admission-control peek shedding by hot-set concentration "
     "(0 disables; 1 = full tightening under pure abuse traffic)"),
    # --- control plane (L3.9: adaptive feedback over the knob surface) --
    ("control", "THROTTLECRAB_CONTROL", False, bool,
     "Adaptive control plane: telemetry-driven feedback controllers "
     "moving admission/deny-cache/insight knobs through a bounded "
     "actuator registry (env 0 — the default — builds none of it; "
     "decisions and every knob value are bit-identical to the "
     "subsystem absent)"),
    ("control_tick_ms", "THROTTLECRAB_CONTROL_TICK_MS", 1000, int,
     "Cadence of the control tick (sensor snapshot + controller step; "
     "milliseconds) in the engine flush loop / native driver"),
    ("control_mode", "THROTTLECRAB_CONTROL_MODE", "both", str,
     "Armed controllers: aimd (fast loop on admission), hill "
     "(coordinate-descent slow loop), or both"),
    ("control_target_wait_us", "THROTTLECRAB_CONTROL_TARGET_WAIT_US",
     5000.0, float,
     "AIMD setpoint: estimated queue wait (microseconds) above which "
     "the admission bound decreases multiplicatively"),
    ("control_w_throughput", "THROTTLECRAB_CONTROL_W_THROUGHPUT",
     1.0, float,
     "Objective weight on served throughput (log-compressed rows/s)"),
    ("control_w_wait", "THROTTLECRAB_CONTROL_W_WAIT", 1.0, float,
     "Objective weight on estimated queue wait (log-compressed us)"),
    ("control_w_fairness", "THROTTLECRAB_CONTROL_W_FAIRNESS", 0.5, float,
     "Objective weight on per-tenant Jain fairness ([0, 1] term)"),
    ("device", "THROTTLECRAB_DEVICE", "cuda", str,
     "Torch device of the bucket table: cuda (the CUDA kernel) or cpu "
     "(the plain version)"),
]


@dataclasses.dataclass
class Config:
    http: bool = False
    http_host: str = "0.0.0.0"
    http_port: int = 8080
    http_backend: str = "python"
    grpc: bool = False
    grpc_host: str = "0.0.0.0"
    grpc_port: int = 8070
    redis: bool = False
    redis_host: str = "0.0.0.0"
    redis_port: int = 6379
    redis_backend: str = "python"
    store: str = "periodic"
    store_capacity: int = 100_000
    store_cleanup_interval: int = 300
    store_cleanup_probability: int = 10_000
    store_min_interval: int = 5
    store_max_interval: int = 300
    store_max_operations: int = 1_000_000
    buffer_size: int = 100_000
    max_denied_keys: int = 100
    log_level: str = "info"
    batch_size: int = 4096
    max_linger_us: int = 200
    max_scan_depth: int = 16
    keymap: str = "auto"
    shards: int = 1
    tenant_max: int = 64
    tenant_delim: str = ":"
    tenant_quota: float = 0.0
    tenant_affinity: bool = False
    pallas_fused: bool = False
    profile_dir: str = ""
    front_deny_cache: int = 65536
    front_max_pending: int = 100_000
    front_max_wait_us: int = 0
    front_peek_frac: float = 0.9
    snapshot_path: str = ""
    snapshot_strict: bool = True
    checkpoint_interval_ms: int = 0
    checkpoint_dir: str = ""
    checkpoint_retain: int = 2
    checkpoint_mode: str = "incremental"
    supervisor_retries: int = 3
    supervisor_backoff_us: int = 2000
    supervisor_backoff_max_us: int = 50_000
    supervisor_probe_interval_ms: int = 1000
    supervisor_mode: str = "degrade"
    faults: str = ""
    faults_seed: int = 0
    trace_dir: str = ""
    trace_windows: int = 1024
    trace_mode: str = "ring"
    trace_dump_on_degrade: bool = True
    cluster_nodes: str = ""
    cluster_index: int = 0
    cluster_bind_host: str = "0.0.0.0"
    cluster_timeout_ms: int = 1000
    cluster_connect_timeout_ms: int = 1000
    cluster_breaker_failures: int = 3
    cluster_breaker_cooldown_ms: int = 1000
    cluster_vnodes: int = 128
    cluster_replicate: bool = True
    cluster_handoff_timeout_ms: int = 5000
    cluster_replica_cap: int = 100_000
    drain_timeout_ms: int = 10_000
    deadline_default_ms: int = 0
    insight: bool = True
    insight_topk: int = 64
    insight_sketch: int = 4096
    insight_window_s: int = 10
    insight_poll_ms: int = 1000
    insight_decay_s: int = 60
    insight_prewarm: int = 64
    insight_hot_denies: int = 100
    insight_shed_weight: float = 0.0
    control: bool = False
    control_tick_ms: int = 1000
    control_mode: str = "both"
    control_target_wait_us: float = 5000.0
    control_w_throughput: float = 1.0
    control_w_wait: float = 1.0
    control_w_fairness: float = 0.5
    device: str = "cuda"

    @classmethod
    def from_env_and_args(cls, argv: Optional[List[str]] = None) -> "Config":
        """CLI > env > default, as `config.rs:356-416`."""
        parser = build_parser()
        ns = parser.parse_args(argv)
        if ns.list_env_vars:
            print(list_env_vars_text())
            sys.exit(0)
        cfg = cls(**{name: getattr(ns, name) for name, *_ in _SPEC})
        cfg.validate()
        return cfg

    def validate(self) -> None:
        if not (self.http or self.grpc or self.redis):
            raise ConfigError(
                "At least one transport must be enabled. "
                "Use --http, --grpc, or --redis"
            )
        if self.store not in STORE_TYPES:
            raise ConfigError(
                f"Invalid store type: {self.store!r} "
                f"(expected one of {', '.join(STORE_TYPES)})"
            )
        if not 0 <= self.max_denied_keys <= 10_000:
            raise ConfigError("max_denied_keys must be in 0..=10000")
        if self.batch_size <= 0:
            raise ConfigError("batch_size must be positive")
        for name, backend in (("redis", self.redis_backend),
                              ("http", self.http_backend)):
            if backend not in ("python", "native"):
                raise ConfigError(
                    f"Invalid {name} backend: {backend!r} "
                    "(expected python or native)"
                )
        if self.max_scan_depth <= 0:
            raise ConfigError("max_scan_depth must be positive")
        if self.keymap not in ("auto", "python", "native"):
            raise ConfigError(
                f"Invalid keymap backend: {self.keymap!r} "
                "(expected auto, python, or native)"
            )
        if self.shards < 1:
            raise ConfigError("shards must be >= 1")
        if self.tenant_max < 0:
            raise ConfigError("tenant_max must be >= 0")
        if self.tenant_max == 1:
            raise ConfigError(
                "tenant_max must be 0 (off) or >= 2 (id 0 is the "
                "overflow bucket)"
            )
        if len(self.tenant_delim.encode()) != 1:
            raise ConfigError("tenant_delim must be exactly one byte")
        if not 0.0 <= self.tenant_quota <= 1.0:
            raise ConfigError("tenant_quota must be in [0, 1]")
        if self.tenant_quota > 0 and self.tenant_max == 0:
            raise ConfigError(
                "tenant_quota needs the tenant layer (tenant_max > 0)"
            )
        if self.tenant_affinity and self.tenant_max == 0:
            raise ConfigError(
                "tenant_affinity needs the tenant layer (tenant_max > 0)"
            )
        if self.shards == 1 and (
            self.tenant_affinity or self.tenant_quota > 0
        ):
            # Explicitly requested isolation knobs exist only on the
            # sharded mesh: refusing beats silently dropping them
            # (tenant_max alone keeps its default and stays quiet).
            raise ConfigError(
                "tenant_affinity/tenant_quota need a sharded mesh "
                "(--shards > 1)"
            )
        if self.front_deny_cache < 0:
            raise ConfigError("front_deny_cache must be >= 0")
        if self.front_max_pending < 0 or self.front_max_wait_us < 0:
            raise ConfigError("front admission bounds must be >= 0")
        if not 0.0 < self.front_peek_frac <= 1.0:
            raise ConfigError("front_peek_frac must be in (0, 1]")
        if self.checkpoint_interval_ms < 0:
            raise ConfigError("checkpoint_interval_ms must be >= 0")
        if self.checkpoint_interval_ms > 0 and not self.checkpoint_dir:
            raise ConfigError(
                "checkpoint_interval_ms needs --checkpoint-dir"
            )
        if self.checkpoint_retain < 1:
            raise ConfigError("checkpoint_retain must be >= 1")
        if self.checkpoint_mode not in ("incremental", "full"):
            raise ConfigError(
                f"Invalid checkpoint mode: {self.checkpoint_mode!r} "
                "(expected incremental or full)"
            )
        if self.supervisor_mode not in ("degrade", "fail"):
            raise ConfigError(
                f"Invalid supervisor mode: {self.supervisor_mode!r} "
                "(expected degrade or fail)"
            )
        if self.supervisor_retries < 0:
            raise ConfigError("supervisor_retries must be >= 0")
        if self.supervisor_backoff_us < 0 or self.supervisor_backoff_max_us < 0:
            raise ConfigError("supervisor backoffs must be >= 0")
        if self.supervisor_probe_interval_ms <= 0:
            raise ConfigError("supervisor_probe_interval_ms must be > 0")
        if self.insight_topk <= 0 or self.insight_sketch <= 0:
            raise ConfigError("insight_topk/insight_sketch must be > 0")
        if self.insight_window_s <= 0 or self.insight_poll_ms <= 0:
            raise ConfigError(
                "insight_window_s/insight_poll_ms must be > 0"
            )
        if self.insight_decay_s < 0:
            raise ConfigError("insight_decay_s must be >= 0")
        if self.insight_prewarm < 0 or self.insight_hot_denies < 1:
            raise ConfigError(
                "insight_prewarm must be >= 0 and "
                "insight_hot_denies >= 1"
            )
        if not 0.0 <= self.insight_shed_weight <= 1.0:
            raise ConfigError("insight_shed_weight must be in [0, 1]")
        if self.control_mode not in ("aimd", "hill", "both"):
            raise ConfigError(
                f"Invalid control mode: {self.control_mode!r} "
                "(expected aimd, hill, or both)"
            )
        if self.control_tick_ms <= 0:
            raise ConfigError("control_tick_ms must be > 0")
        if self.control_target_wait_us <= 0:
            raise ConfigError("control_target_wait_us must be > 0")
        if (
            self.control_w_throughput < 0
            or self.control_w_wait < 0
            or self.control_w_fairness < 0
        ):
            raise ConfigError("control objective weights must be >= 0")
        if self.faults:
            try:
                parse_spec(self.faults)
            except ValueError as e:
                raise ConfigError(f"invalid --faults spec: {e}") from e
        if self.trace_mode not in ("ring", "full"):
            raise ConfigError(
                f"Invalid trace mode: {self.trace_mode!r} "
                "(expected ring or full)"
            )
        if self.trace_windows <= 0:
            raise ConfigError("trace_windows must be > 0")
        if self.cluster_vnodes < 0:
            raise ConfigError(
                "cluster_vnodes must be >= 0 (0 = legacy modulo routing)"
            )
        if self.cluster_handoff_timeout_ms <= 0:
            raise ConfigError("cluster_handoff_timeout_ms must be > 0")
        if self.cluster_replica_cap < 0:
            raise ConfigError("cluster_replica_cap must be >= 0")
        if self.drain_timeout_ms < 0:
            raise ConfigError("drain_timeout_ms must be >= 0")
        if self.deadline_default_ms < 0:
            raise ConfigError("deadline_default_ms must be >= 0")
        nodes = self.cluster_node_list()
        if nodes:
            if not 0 <= self.cluster_index < len(nodes):
                raise ConfigError(
                    "cluster_index must index into cluster_nodes"
                )
            for addr in nodes:
                host, _, port = addr.rpartition(":")
                if not host or not port.isdigit():
                    raise ConfigError(
                        f"Invalid cluster node address: {addr!r} "
                        "(expected host:port)"
                    )
        if self.device.split(":")[0] not in ("cuda", "cpu"):
            raise ConfigError(
                f"Invalid device: {self.device!r} (expected cuda or cpu)"
            )

    def cluster_node_list(self) -> List[str]:
        return [a.strip() for a in self.cluster_nodes.split(",") if a.strip()]


class ConfigError(ValueError):
    pass


def _env_bool(value: str) -> bool:
    return value.lower() in ("1", "true", "yes", "on")


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="throttlecrab-tpu-torch-server",
        description=(
            "A GCRA rate limiting server deciding on a CUDA card.\n\n"
            "Environment variables with THROTTLECRAB_ prefix are supported. "
            "CLI arguments take precedence over environment variables."
        ),
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    for name, env, default, typ, help_ in _SPEC:
        flag = "--" + name.replace("_", "-")
        raw = os.environ.get(env)
        if typ is bool:
            env_default = _env_bool(raw) if raw is not None else default
            parser.add_argument(
                flag, action="store_true", default=env_default,
                help=f"{help_} [env: {env}]",
            )
        else:
            try:
                env_default = typ(raw) if raw is not None else default
            except ValueError as e:
                raise ConfigError(
                    f"invalid value for {env}: {raw!r} ({e})"
                ) from e
            parser.add_argument(
                flag, type=typ, default=env_default, metavar=name.upper(),
                help=f"{help_} (default: {default}) [env: {env}]",
            )
    parser.add_argument(
        "--list-env-vars", action="store_true",
        help="List all environment variables and exit",
    )
    return parser


def list_env_vars_text() -> str:
    """Self-documentation dump (config.rs:461-535)."""
    lines = [
        "Environment variables supported by throttlecrab-tpu-torch-server:",
        "",
    ]
    for name, env, default, typ, help_ in _SPEC:
        lines.append(f"  {env}")
        lines.append(f"      {help_}")
        lines.append(f"      Default: {default}")
        lines.append("")
    lines.append("CLI arguments take precedence over environment variables.")
    return "\n".join(lines)
