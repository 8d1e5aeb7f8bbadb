"""Multi-transport load generator.

The `integration-tests` crate equivalent
(`perf_test_multi_transport.rs:48-443`): N concurrent workers with
pre-generated payloads, start-barrier synchronization, per-transport clients
(HTTP keep-alive, RESP pipeline-per-connection, gRPC channel), and
p50/p90/p99/p99.9 latency percentiles.

Run against a live server:
  python -m throttlecrab_tpu_torch.harness perf-test \
      --transport http --port 8080 --workers 32 --requests 10000
"""

from __future__ import annotations

import argparse
import asyncio
import json
import sys
import time
from dataclasses import dataclass, field
from typing import List

from .workload import (
    Workload,
    crash_restart_ledger,
    flash_crowd_hot_sets,
    make_keys,
)

#: Sentinel outcome a client returns when the server shed the request
#: for a lapsed deadline (HTTP 504 / RESP -ERR deadline exceeded /
#: gRPC DEADLINE_EXCEEDED) — counted separately from errors: a miss is
#: the deadline feature working, not the server failing.
DEADLINE_MISS = object()


@dataclass
class StatsProbe:
    """GET /stats polling alongside a load run (--stats): counts polls
    and measures hot-key detection latency — the wall time from the
    flash-crowd pattern's hot-set shift until a post-shift hot key
    first appears in the insight tier's top_denied list."""

    polls: int = 0
    errors: int = 0
    shift_t: float = -1.0
    detection_latency_s: float = -1.0

    def summary(self) -> dict:
        return {
            "polls": self.polls,
            "errors": self.errors,
            "hot_detection_latency_s": round(self.detection_latency_s, 3),
        }


async def _get_stats(host: str, port: int) -> dict:
    """One GET /stats over a throwaway connection (Connection: close)."""
    reader, writer = await asyncio.open_connection(host, port)
    try:
        writer.write(
            b"GET /stats HTTP/1.1\r\nHost: x\r\nConnection: close\r\n\r\n"
        )
        await writer.drain()
        # Connection: close — read to EOF so a body split across TCP
        # segments never truncates the JSON.
        chunks = []
        while True:
            chunk = await reader.read(1 << 16)
            if not chunk:
                break
            chunks.append(chunk)
        _head, _, body = b"".join(chunks).partition(b"\r\n\r\n")
        return json.loads(body)
    finally:
        writer.close()


async def stats_poller(
    host: str, port: int, probe: StatsProbe, hot_b, stop: asyncio.Event,
    interval: float = 0.2,
) -> None:
    while not stop.is_set():
        try:
            doc = await _get_stats(host, port)
            probe.polls += 1
            top = {d.get("key") for d in doc.get("top_denied", ())}
            if (
                probe.detection_latency_s < 0
                and probe.shift_t >= 0
                and top & hot_b
            ):
                probe.detection_latency_s = (
                    time.perf_counter() - probe.shift_t
                )
        except Exception:
            probe.errors += 1
        try:
            await asyncio.wait_for(stop.wait(), interval)
        except asyncio.TimeoutError:
            pass


@dataclass
class PerfResult:
    transport: str
    total_requests: int
    elapsed_s: float
    allowed: int
    denied: int
    errors: int
    latencies_s: List[float] = field(default_factory=list, repr=False)
    # The deterministic base seed and key pattern that produced this
    # run's key streams (worker w draws with seed + w): any failing
    # harness run can be re-captured bit-identically from these two.
    seed: int = 0
    key_pattern: str = "random"
    # Chaos-run resilience tracking (--chaos): how the client
    # experienced injected server-side faults.
    max_consecutive_errors: int = 0
    _consecutive_errors: int = field(default=0, repr=False)
    first_error_s: float = -1.0
    last_recovery_s: float = -1.0
    # Requests the server shed for a lapsed deadline (--deadline-ms).
    deadline_misses: int = 0
    # Longest gap between any two successful responses across the whole
    # client fleet — the client-observed availability stall; a rolling
    # restart passes when this stays near the normal response cadence.
    max_stall_s: float = 0.0
    _last_ok_t: float = field(default=-1.0, repr=False)
    # GET /stats polling results (--stats; a StatsProbe or None).
    stats_probe: object = field(default=None, repr=False)
    # Per-tenant [allowed, denied, errors] splits, keyed by the tenant
    # prefix before the first ":" — populated for tenant-prefixed key
    # patterns (noisy-neighbor), so tenant isolation is a measured,
    # replayable scenario rather than a one-off test.
    tenant_counts: dict = field(default_factory=dict, repr=False)
    # Warm-restart ledger (--key-pattern crash-restart): cumulative
    # allows per fixed ledger key.  A restart that comes back cold
    # grants each exhausted key a fresh bucket, so allows past one
    # burst count exactly the state the restart forgot; zero extras
    # means the checkpoint restore was fully warm.
    ledger_counts: dict = field(default_factory=dict, repr=False)
    ledger_burst: int = 0

    def track_tenant(self, key: str, allowed) -> None:
        tenant = key.split(":", 1)[0] if ":" in key else "(default)"
        row = self.tenant_counts.get(tenant)
        if row is None:
            row = self.tenant_counts[tenant] = [0, 0, 0]
        if allowed is None:
            row[2] += 1
        elif allowed:
            row[0] += 1
        else:
            row[1] += 1

    def tenant_summary(self) -> dict:
        """{tenant: {allowed, denied, errors, deny_rate}}, worst deny
        rate first — the noisy neighbor should top this list while the
        compliant tenants' deny rates stay near zero."""
        out = {}
        for tenant, (a, d, e) in sorted(
            self.tenant_counts.items(),
            key=lambda kv: -(kv[1][1] / max(sum(kv[1]), 1)),
        ):
            total = a + d + e
            out[tenant] = {
                "allowed": a,
                "denied": d,
                "errors": e,
                "deny_rate": round(d / total, 4) if total else 0.0,
            }
        return out

    def track_ledger(self, key: str, allowed) -> None:
        if allowed:
            self.ledger_counts[key] = self.ledger_counts.get(key, 0) + 1

    def warm_start_summary(self) -> dict:
        """{ledger_keys, keys_over_burst, extra_allows_total, ...} —
        the crash-restart audit.  keys_over_burst == 0 means no ledger
        key was ever granted more than one full bucket across every
        kill/restart in the run (the restore carried its TAT); each
        cold restart would add up to a full burst per exhausted key to
        extra_allows_total."""
        burst = self.ledger_burst
        over = {
            k: c for k, c in self.ledger_counts.items() if c > burst
        }
        return {
            "ledger_keys": len(self.ledger_counts),
            "ledger_burst": burst,
            "keys_over_burst": len(over),
            "extra_allows_total": sum(
                c - burst for c in over.values()
            ),
            "max_allows_per_key": max(
                self.ledger_counts.values(), default=0
            ),
        }

    def track_stall(self, t_s: float, ok: bool) -> None:
        """Feed per-request completion times (any worker): a success
        closes the current availability gap, and the longest gap is the
        run's max stall."""
        if ok:
            if self._last_ok_t >= 0:
                self.max_stall_s = max(
                    self.max_stall_s, t_s - self._last_ok_t
                )
            self._last_ok_t = t_s

    def track_outcome(self, is_error: bool, t_s: float) -> None:
        """Feed per-request outcomes (in completion order) for the
        chaos stats: longest error run and the last error→success
        recovery timestamp."""
        if is_error:
            self._consecutive_errors += 1
            self.max_consecutive_errors = max(
                self.max_consecutive_errors, self._consecutive_errors
            )
            if self.first_error_s < 0:
                self.first_error_s = t_s
        else:
            if self._consecutive_errors:
                self.last_recovery_s = t_s
            self._consecutive_errors = 0

    def chaos_summary(self) -> dict:
        return {
            "error_rate": round(
                self.errors / self.total_requests, 6
            ) if self.total_requests else 0.0,
            "max_consecutive_errors": self.max_consecutive_errors,
            "first_error_s": round(self.first_error_s, 3),
            "last_recovery_s": round(self.last_recovery_s, 3),
            "recovered": (
                self.errors == 0 or self.last_recovery_s >= 0
            ),
            "max_stall_s": round(self.max_stall_s, 3),
            "deadline_misses": self.deadline_misses,
        }

    @property
    def rps(self) -> float:
        return self.total_requests / self.elapsed_s if self.elapsed_s else 0.0

    def percentile_ms(self, q: float) -> float:
        if not self.latencies_s:
            return 0.0
        data = sorted(self.latencies_s)
        idx = min(int(q * len(data)), len(data) - 1)
        return data[idx] * 1e3

    def objective_score(self) -> float:
        """The control plane's declared multi-objective score, computed
        from the measured run (control/controllers.Objective with the
        default weights): log-compressed served throughput, minus
        log-compressed p99 wait, plus per-tenant Jain fairness.  The
        same yardstick `python -m throttlecrab_tpu_torch.control rank` uses,
        so live runs and offline policy search are comparable."""
        import math

        from ..control import jain_fairness

        served = self.allowed + self.denied
        rate = served / self.elapsed_s if self.elapsed_s else 0.0
        wait_us = self.percentile_ms(0.99) * 1e3
        fairness = jain_fairness(
            {t: a + d for t, (a, d, _e) in self.tenant_counts.items()}
        )
        return (
            math.log1p(max(rate, 0.0))
            - math.log1p(max(wait_us, 0.0))
            + 0.5 * fairness
        )

    def summary(self) -> dict:
        return {
            "transport": self.transport,
            "requests": self.total_requests,
            "elapsed_s": round(self.elapsed_s, 3),
            "rps": round(self.rps),
            "allowed": self.allowed,
            "denied": self.denied,
            "errors": self.errors,
            "seed": self.seed,
            "key_pattern": self.key_pattern,
            "p50_ms": round(self.percentile_ms(0.50), 3),
            "p90_ms": round(self.percentile_ms(0.90), 3),
            "p99_ms": round(self.percentile_ms(0.99), 3),
            "p99_9_ms": round(self.percentile_ms(0.999), 3),
            "deadline_misses": self.deadline_misses,
            "max_stall_s": round(self.max_stall_s, 3),
            # The control plane's multi-objective yardstick (L3.9):
            # comparable across live runs, bench A/Bs, and offline
            # `control rank` output.
            "objective": round(self.objective_score(), 6),
        }


def _make_barrier(n: int):
    """asyncio.Barrier, or a minimal event-based stand-in on Python
    3.10 (Barrier landed in 3.11) — the start gate only ever does one
    all-workers rendezvous."""
    if hasattr(asyncio, "Barrier"):
        return asyncio.Barrier(n)

    class _OneShotBarrier:
        def __init__(self, parties: int) -> None:
            self._parties = parties
            self._count = 0
            self._event = asyncio.Event()

        async def wait(self) -> None:
            self._count += 1
            if self._count >= self._parties:
                self._event.set()
            await self._event.wait()

    return _OneShotBarrier(n)


# ---------------------------------------------------------------- clients #


class HttpClient:
    """Keep-alive HTTP/1.1 client on asyncio streams."""

    def __init__(self, host: str, port: int) -> None:
        self.host, self.port = host, port
        self.reader = None
        self.writer = None

    async def connect(self) -> None:
        self.reader, self.writer = await asyncio.open_connection(
            self.host, self.port
        )

    async def throttle(
        self, key: str, burst: int, count: int, period: int,
        quantity: int = 1, deadline_ms: int = 0,
    ):
        body = json.dumps(
            {
                "key": key,
                "max_burst": burst,
                "count_per_period": count,
                "period": period,
                "quantity": quantity,
            }
        ).encode()
        deadline_hdr = (
            b"X-Throttlecrab-Deadline-Ms: %d\r\n" % deadline_ms
            if deadline_ms > 0 else b""
        )
        self.writer.write(
            b"POST /throttle HTTP/1.1\r\nHost: x\r\n"
            b"Content-Type: application/json\r\n" + deadline_hdr +
            b"Content-Length: %d\r\n\r\n%s" % (len(body), body)
        )
        await self.writer.drain()
        head = await self.reader.readuntil(b"\r\n\r\n")
        status = int(head.split(b" ", 2)[1])
        length = 0
        for line in head.split(b"\r\n"):
            if line.lower().startswith(b"content-length:"):
                length = int(line.split(b":", 1)[1])
        payload = await self.reader.readexactly(length)
        if status == 504:
            return DEADLINE_MISS
        if status != 200:
            return None
        return json.loads(payload)["allowed"]

    async def close(self) -> None:
        if self.writer:
            self.writer.close()


class RedisClient:
    """RESP client issuing THROTTLE commands.

    Supports pipelining (`throttle_many`): N commands written in one
    burst, then N responses parsed in order — the mode behind the
    pipelined throughput numbers in docs/benchmark-results.md."""

    def __init__(self, host: str, port: int) -> None:
        self.host, self.port = host, port
        self.reader = None
        self.writer = None
        self._buf = b""

    async def connect(self) -> None:
        self.reader, self.writer = await asyncio.open_connection(
            self.host, self.port
        )

    @staticmethod
    def _frame(
        key: str, burst: int, count: int, period: int, quantity: int = 1,
        deadline_ms: int = 0,
    ) -> bytes:
        parts = [b"THROTTLE", key.encode(), str(burst).encode(),
                 str(count).encode(), str(period).encode(),
                 str(quantity).encode()]
        if deadline_ms > 0:
            parts.append(str(deadline_ms).encode())
        return b"*%d\r\n" % len(parts) + b"".join(
            b"$%d\r\n%s\r\n" % (len(p), p) for p in parts
        )

    async def _readline(self) -> bytes:
        idx = self._buf.find(b"\r\n")
        while idx < 0:
            chunk = await self.reader.read(65536)
            if not chunk:
                raise ConnectionError("server closed mid-response")
            self._buf += chunk
            idx = self._buf.find(b"\r\n", max(len(self._buf) - len(chunk) - 1, 0))
        line, self._buf = self._buf[:idx], self._buf[idx + 2 :]
        return line

    async def _read_response(self):
        """One RESP response: *5 int array → allowed bool; -ERR → None
        (a deadline shed maps to the DEADLINE_MISS sentinel)."""
        line = await self._readline()
        if line.startswith(b"-"):
            if line.startswith(b"-ERR deadline"):
                return DEADLINE_MISS
            return None
        if line.startswith(b"*"):
            n = int(line[1:])
            vals = [await self._readline() for _ in range(n)]
            return vals[0] == b":1"
        return None

    async def throttle(
        self, key: str, burst: int, count: int, period: int,
        quantity: int = 1, deadline_ms: int = 0,
    ):
        self.writer.write(
            self._frame(key, burst, count, period, quantity, deadline_ms)
        )
        await self.writer.drain()
        return await self._read_response()

    async def throttle_many(
        self, keys, burst: int, count: int, period: int
    ):
        """Pipelined: len(keys) commands in one write, responses in
        order (the server guarantees pipelined ordering — test_resp.py).

        Responses are parsed token-wise from whole buffers (one C-speed
        split per read) — per-line asyncio reads cap a pipelined client
        at ~30 K resp/s, an order of magnitude under the server."""
        self.writer.write(
            b"".join(self._frame(k, burst, count, period) for k in keys)
        )
        await self.writer.drain()
        need = len(keys)
        outcomes: List = []
        tokens: List[bytes] = self._buf.split(b"\r\n") if self._buf else [b""]
        carry = tokens.pop()  # possibly-partial trailing line
        i = 0
        while len(outcomes) < need:
            # Parse as many complete responses as the tokens allow.
            made_progress = True
            while len(outcomes) < need and made_progress:
                made_progress = False
                if i >= len(tokens):
                    break
                head = tokens[i]
                if head.startswith(b"-"):
                    outcomes.append(None)
                    i += 1
                    made_progress = True
                elif head.startswith(b"*"):
                    n = int(head[1:])
                    if i + n < len(tokens):
                        outcomes.append(tokens[i + 1] == b":1")
                        i += n + 1
                        made_progress = True
                elif head == b"":
                    i += 1
                    made_progress = True
                else:  # +simple string (not expected for THROTTLE)
                    outcomes.append(None)
                    i += 1
                    made_progress = True
            if len(outcomes) >= need:
                break
            chunk = await self.reader.read(1 << 20)
            if not chunk:
                raise ConnectionError("server closed mid-pipeline")
            fresh = (carry + chunk).split(b"\r\n")
            carry = fresh.pop()
            tokens = tokens[i:] + fresh
            i = 0
        # Preserve any unconsumed bytes for subsequent reads.
        rest = tokens[i:]
        self._buf = b"\r\n".join(rest + [carry]) if (rest or carry) else b""
        return outcomes

    async def close(self) -> None:
        if self.writer:
            self.writer.close()


class GrpcClient:
    """grpc.aio client for throttlecrab.RateLimiter/Throttle."""

    def __init__(self, host: str, port: int) -> None:
        self.host, self.port = host, port
        self.channel = None
        self.method = None

    async def connect(self) -> None:
        import grpc.aio

        from ..server.proto import throttlecrab_pb2 as pb

        self._pb = pb
        self.channel = grpc.aio.insecure_channel(f"{self.host}:{self.port}")
        self.method = self.channel.unary_unary(
            "/throttlecrab.RateLimiter/Throttle",
            request_serializer=pb.ThrottleRequest.SerializeToString,
            response_deserializer=pb.ThrottleResponse.FromString,
        )

    async def throttle(
        self, key: str, burst: int, count: int, period: int,
        quantity: int = 1, deadline_ms: int = 0,
    ):
        import grpc

        call_kw = (
            {"timeout": deadline_ms / 1000.0} if deadline_ms > 0 else {}
        )
        try:
            response = await self.method(
                self._pb.ThrottleRequest(
                    key=key, max_burst=burst, count_per_period=count,
                    period=period, quantity=quantity,
                ),
                **call_kw,
            )
        except grpc.aio.AioRpcError as e:
            if e.code() == grpc.StatusCode.DEADLINE_EXCEEDED:
                return DEADLINE_MISS
            raise
        return response.allowed

    async def close(self) -> None:
        if self.channel:
            await self.channel.close()


CLIENTS = {"http": HttpClient, "redis": RedisClient, "grpc": GrpcClient}


# ----------------------------------------------------------------- runner #


async def run_perf_test(
    transport: str,
    host: str,
    port: int,
    workers: int,
    requests_per_worker: int,
    burst: int = 100,
    count: int = 10_000,
    period: int = 60,
    key_pattern: str = "random",
    key_space: int = 10_000,
    workload: str = "steady",
    target_rps: float = 0.0,
    pipeline: int = 1,
    chaos: bool = False,
    stats_port: int = 0,
    seed: int = 0,
    record_path: str = "",
    replay_path: str = "",
    deadline_ms: int = 0,
) -> PerfResult:
    """Barrier-synchronized workers, pre-generated keys
    (perf_test_multi_transport.rs:48-127).

    `pipeline` > 1 (RESP only) sends that many commands per write before
    reading the responses; recorded latency is then per *window* — the
    time until the whole window's responses are parsed.

    `stats_port` > 0 polls GET /stats (the insight tier) every 200 ms
    during the run and, with the flash-crowd key pattern, reports the
    hot-key detection latency in result.stats_probe.

    `seed` offsets every worker's deterministic key stream (worker w
    draws with seed + w), so a failing run re-captures bit-identically.
    `record_path` writes the run's request schedule + observed outcomes
    as a replayable trace (replay/); `replay_path`
    drives the run from a trace's windows (round-robin across workers,
    per-row params honored) instead of generating keys."""
    if pipeline > 1 and transport != "redis":
        raise ValueError("--pipeline requires the redis transport")
    if pipeline > 1 and (record_path or replay_path):
        raise ValueError("--record/--replay require --pipeline 1")
    if pipeline > 1 and deadline_ms > 0:
        raise ValueError("--deadline-ms requires --pipeline 1")

    # Per-worker schedules of (key, burst, count, period, quantity).
    if replay_path:
        from ..replay.trace import Trace

        trace = Trace.load(replay_path)
        schedules: List[list] = [[] for _ in range(workers)]
        for i, win in enumerate(trace.windows):
            rows = schedules[i % workers]
            for j in range(len(win)):
                rows.append((
                    win.keys[j].decode("utf-8", "surrogateescape"),
                    int(win.params[j, 0]), int(win.params[j, 1]),
                    int(win.params[j, 2]), int(win.params[j, 3]),
                ))
    else:
        schedules = [
            [
                (k, burst, count, period, 1)
                for k in make_keys(
                    key_pattern, requests_per_worker, key_space,
                    seed=seed + w,
                )
            ]
            for w in range(workers)
        ]
    recorded: List[list] = [[] for _ in range(workers)]

    clients = [CLIENTS[transport](host, port) for _ in range(workers)]
    await asyncio.gather(*(c.connect() for c in clients))

    probe = None
    stats_stop = None
    stats_task = None
    if stats_port:
        probe = StatsProbe()
        _, hot_b = flash_crowd_hot_sets(key_space)
        stats_stop = asyncio.Event()
        stats_task = asyncio.create_task(
            stats_poller(host, stats_port, probe, hot_b, stats_stop)
        )
    shift = requests_per_worker // 2

    barrier = _make_barrier(workers)
    result = PerfResult(
        transport, 0, 0.0, 0, 0, 0, seed=seed, key_pattern=key_pattern
    )
    # Tenant-prefixed patterns report per-tenant splits (the isolation
    # scenario the sharded mesh's namespace layer serves).
    track_tenants = key_pattern == "noisy-neighbor"
    ledger = None
    if key_pattern == "crash-restart":
        ledger = crash_restart_ledger(key_space)
        result.ledger_burst = burst

    def tally(allowed, key=None) -> None:
        t_s = time.perf_counter() - t_start
        if allowed is DEADLINE_MISS:
            # The deadline feature working as designed — tracked apart
            # from errors so a shed never masks a real failure (and
            # never counts as chaos-recovery "success" either).
            result.deadline_misses += 1
            return
        result.track_stall(t_s, allowed is not None)
        if allowed is None:
            result.errors += 1
        elif allowed:
            result.allowed += 1
        else:
            result.denied += 1
        if track_tenants and key is not None:
            result.track_tenant(key, allowed)
        if ledger is not None and key is not None and key in ledger:
            result.track_ledger(key, allowed)
        if chaos:
            result.track_outcome(allowed is None, t_s)

    def tally_errors(n: int) -> None:
        result.errors += n
        if chaos:
            t = time.perf_counter() - t_start
            for _ in range(n):
                result.track_outcome(True, t)

    async def worker(w: int) -> None:
        client = clients[w]
        schedule = schedules[w]
        record = recorded[w] if record_path else None
        wl = Workload(workload, target_rps, len(schedule))
        await barrier.wait()
        if pipeline > 1:
            keys = [row[0] for row in schedule]
            for start in range(0, len(keys), pipeline):
                window = keys[start : start + pipeline]
                if (
                    probe is not None
                    and probe.shift_t < 0
                    and start <= shift < start + pipeline
                ):
                    probe.shift_t = time.perf_counter()
                t0 = time.perf_counter()
                try:
                    outcomes = await client.throttle_many(
                        window, burst, count, period
                    )
                except Exception:
                    tally_errors(len(window))
                    try:
                        await client.close()
                        await client.connect()
                    except Exception:
                        tally_errors(len(keys) - start - len(window))
                        return
                    continue
                result.latencies_s.append(time.perf_counter() - t0)
                for key, allowed in zip(window, outcomes):
                    tally(allowed, key)
            return
        for done, ((key, kb, kc, kp, kq), delay) in enumerate(
            zip(schedule, wl.delays())
        ):
            if probe is not None and done == shift and probe.shift_t < 0:
                probe.shift_t = time.perf_counter()
            if delay > 0:
                await asyncio.sleep(delay)
            t0 = time.perf_counter()
            try:
                allowed = await client.throttle(
                    key, kb, kc, kp, kq, deadline_ms=deadline_ms
                )
            except Exception:
                tally_errors(1)
                if record is not None:
                    record.append(
                        (key, kb, kc, kp, kq, None, time.time_ns())
                    )
                # The stream may hold a half-read response; a reconnect is
                # the only way to resynchronize the framing.  Abort the
                # worker if the server is truly gone.
                try:
                    await client.close()
                    await client.connect()
                except Exception:
                    tally_errors(len(schedule) - done - 1)
                    return
                continue
            result.latencies_s.append(time.perf_counter() - t0)
            if record is not None:
                record.append((
                    key, kb, kc, kp, kq,
                    None if allowed is DEADLINE_MISS else allowed,
                    time.time_ns(),
                ))
            tally(allowed, key)

    t_start = time.perf_counter()
    await asyncio.gather(*(worker(w) for w in range(workers)))
    result.elapsed_s = time.perf_counter() - t_start
    result.total_requests = sum(len(s) for s in schedules)
    if record_path:
        _write_harness_trace(record_path, recorded)
    if stats_task is not None:
        # Give the poller one more cadence to catch a shift that
        # happened in the run's final windows, then stop it.
        await asyncio.sleep(0.25)
        stats_stop.set()
        await stats_task
        result.stats_probe = probe
    await asyncio.gather(*(c.close() for c in clients))
    return result


def _write_harness_trace(path: str, recorded) -> None:
    """Client-side capture: each worker's (key, params, outcome, t_ns)
    rows become trace windows (<= 512 rows each, worker-ordered), so a
    live run replays through `--replay` or the offline player."""
    from ..replay.trace import SOURCE_HARNESS, TraceWriter

    writer = TraceWriter()
    for rows in recorded:
        for start in range(0, len(rows), 512):
            chunk = rows[start : start + 512]
            writer.add_window(
                chunk[0][6],
                SOURCE_HARNESS,
                [r[0].encode("utf-8", "surrogateescape") for r in chunk],
                [[r[1], r[2], r[3], r[4]] for r in chunk],
                [1 if r[5] else 0 for r in chunk],
                # Outcome status: 0 decided, 3 (internal) transport error.
                [0 if r[5] is not None else 3 for r in chunk],
            )
    writer.save(path)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="throttlecrab-tpu-torch-harness")
    sub = ap.add_subparsers(dest="command", required=True)
    p = sub.add_parser("perf-test", help="load-test a running server")
    p.add_argument("--transport", default="http",
                   choices=["http", "redis", "grpc", "all"])
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8080)
    p.add_argument("--grpc-port", type=int, default=8070)
    p.add_argument("--redis-port", type=int, default=6379)
    p.add_argument("--workers", type=int, default=32)
    p.add_argument("--requests", type=int, default=10_000,
                   help="requests per worker")
    p.add_argument("--key-pattern", default="random",
                   choices=["sequential", "random", "zipfian",
                            "user-resource", "hotkey-abuse",
                            "flash-crowd", "chaos", "noisy-neighbor",
                            "diurnal", "slow-drift", "rolling-restart",
                            "crash-restart"])
    p.add_argument("--stats", action="store_true",
                   help="poll GET /stats (the insight tier) every "
                        "200 ms during the run and report hot-key "
                        "detection latency — with --key-pattern "
                        "flash-crowd, the wall time from the hot-set "
                        "shift until a post-shift hot key appears in "
                        "top_denied")
    p.add_argument("--stats-port", type=int, default=0,
                   help="port serving GET /stats (default: the HTTP "
                        "port)")
    p.add_argument("--chaos", action="store_true",
                   help="chaos run against a THROTTLECRAB_FAULTS-armed "
                        "server: drives the 'chaos' key pattern (hot "
                        "abuse + cold + keymap-churn bands) and reports "
                        "resilience stats (error rate, longest error "
                        "run, recovery) alongside the latency summary")
    p.add_argument("--key-space", type=int, default=10_000)
    p.add_argument("--seed", type=int, default=0,
                   help="base seed for the deterministic per-worker key "
                        "streams (worker w draws with seed + w; the "
                        "summary echoes it so any run re-captures "
                        "bit-identically)")
    p.add_argument("--record", default="", metavar="TRACE",
                   help="write the run's request schedule + observed "
                        "outcomes as a replayable trace file "
                        "(replay/ trace format)")
    p.add_argument("--replay", default="", metavar="TRACE",
                   help="drive the run from a trace file (recorded or "
                        "synthesized via python -m "
                        "throttlecrab_tpu_torch.replay synth) instead of "
                        "generating keys; per-row params are honored")
    p.add_argument("--workload", default="steady",
                   choices=["steady", "burst", "ramp", "wave"])
    p.add_argument("--target-rps", type=float, default=0.0,
                   help="per-worker pacing (0 = open throttle)")
    p.add_argument("--pipeline", type=int, default=1,
                   help="RESP only: commands pipelined per write "
                        "(reproduces the pipelined throughput numbers)")
    p.add_argument("--procs", type=int, default=1,
                   help="worker processes (a single Python process "
                        "saturates around ~50K resp/s client-side; the "
                        "reference harness is compiled Rust)")
    p.add_argument("--burst", type=int, default=100)
    p.add_argument("--count", type=int, default=10_000)
    p.add_argument("--period", type=int, default=60)
    p.add_argument("--deadline-ms", type=int, default=0,
                   help="per-request deadline in milliseconds (HTTP "
                        "header / RESP 7th token / native gRPC "
                        "deadline); server-shed requests are reported "
                        "as deadline_misses, apart from errors")
    args = ap.parse_args(argv)

    transports = (
        ["http", "grpc", "redis"] if args.transport == "all"
        else [args.transport]
    )
    if args.pipeline > 1 and transports != ["redis"]:
        print("error: --pipeline requires --transport redis",
              file=sys.stderr)
        return 2
    ports = {"http": args.port, "grpc": args.grpc_port,
             "redis": args.redis_port}
    if args.stats and args.procs > 1:
        print("error: --stats requires --procs 1", file=sys.stderr)
        return 2
    if (args.record or args.replay) and (
        args.procs > 1 or args.pipeline > 1
    ):
        print(
            "error: --record/--replay require --procs 1 --pipeline 1",
            file=sys.stderr,
        )
        return 2
    for transport in transports:
        key_pattern = args.key_pattern
        if args.chaos and key_pattern == "random":
            key_pattern = "chaos"  # the chaos default; explicit wins
        if args.stats and key_pattern == "random":
            key_pattern = "flash-crowd"  # the --stats default
        kwargs = dict(
            burst=args.burst, count=args.count, period=args.period,
            key_pattern=key_pattern, key_space=args.key_space,
            workload=args.workload, target_rps=args.target_rps,
            pipeline=args.pipeline, chaos=args.chaos,
            stats_port=(args.stats_port or args.port) if args.stats else 0,
            seed=args.seed, record_path=args.record,
            replay_path=args.replay, deadline_ms=args.deadline_ms,
        )
        if args.procs > 1:
            result = run_multiproc(
                transport, args.host, ports[transport], args.workers,
                args.requests, args.procs, kwargs,
            )
        else:
            result = asyncio.run(
                run_perf_test(
                    transport, args.host, ports[transport], args.workers,
                    args.requests, **kwargs,
                )
            )
        summary = result.summary()
        if args.pipeline > 1:
            summary["pipeline"] = args.pipeline
        if args.procs > 1:
            summary["procs"] = args.procs
        if args.chaos:
            summary["chaos"] = result.chaos_summary()
        if key_pattern == "crash-restart":
            summary["warm_start"] = result.warm_start_summary()
        if result.stats_probe is not None:
            summary["stats"] = result.stats_probe.summary()
        if result.tenant_counts:
            # Top 8 tenants by deny rate: the noisy neighbor leads,
            # compliant tenants' rates should sit near zero.
            per_tenant = result.tenant_summary()
            summary["tenants"] = dict(list(per_tenant.items())[:8])
        print(json.dumps(summary))
    return 0


def _proc_entry(transport, host, port, workers, requests, kwargs):
    result = asyncio.run(
        run_perf_test(transport, host, port, workers, requests, **kwargs)
    )
    return (
        result.total_requests, result.elapsed_s, result.allowed,
        result.denied, result.errors, result.latencies_s,
        result.max_consecutive_errors, result.first_error_s,
        result.last_recovery_s, result.deadline_misses,
        result.max_stall_s, result.ledger_counts, result.ledger_burst,
    )


def run_multiproc(
    transport, host, port, workers, requests, procs, kwargs
) -> PerfResult:
    """Fan the load across OS processes (one asyncio loop each): a single
    Python process tops out around ~50K pipelined resp/s of client-side
    parsing, well under the native server's capacity."""
    import multiprocessing as mp

    if workers % procs != 0:
        raise ValueError(
            f"--workers ({workers}) must be a multiple of --procs "
            f"({procs}) so the measured load matches the flags"
        )
    per_proc = workers // procs
    ctx = mp.get_context("spawn")
    with ctx.Pool(procs) as pool:
        parts = pool.starmap(
            _proc_entry,
            [
                (
                    transport, host, port, per_proc, requests,
                    # Offset each process's seed block so worker
                    # streams stay distinct across the whole fan-out
                    # (proc i's workers draw seed + i*per_proc + w).
                    {**kwargs, "seed": kwargs.get("seed", 0) + i * per_proc},
                )
                for i in range(procs)
            ],
        )
    merged = PerfResult(
        transport, 0, 0.0, 0, 0, 0,
        seed=kwargs.get("seed", 0),
        key_pattern=kwargs.get("key_pattern", "random"),
    )
    for (total, elapsed, allowed, denied, errors, lats,
         max_consec, first_err, last_rec, dl_misses, max_stall,
         ledger_counts, ledger_burst) in parts:
        merged.total_requests += total
        merged.elapsed_s = max(merged.elapsed_s, elapsed)
        merged.allowed += allowed
        merged.denied += denied
        merged.errors += errors
        merged.latencies_s.extend(lats)
        merged.max_consecutive_errors = max(
            merged.max_consecutive_errors, max_consec
        )
        if first_err >= 0 and (
            merged.first_error_s < 0 or first_err < merged.first_error_s
        ):
            merged.first_error_s = first_err
        merged.last_recovery_s = max(merged.last_recovery_s, last_rec)
        merged.deadline_misses += dl_misses
        # Per-process stalls only (cross-process response interleaving
        # is unobservable here); the max is still the fleet's worst.
        merged.max_stall_s = max(merged.max_stall_s, max_stall)
        # Ledger keys are shared across processes: per-key allows sum.
        merged.ledger_burst = ledger_burst or merged.ledger_burst
        for k, c in ledger_counts.items():
            merged.ledger_counts[k] = merged.ledger_counts.get(k, 0) + c
    return merged


if __name__ == "__main__":
    sys.exit(main())
