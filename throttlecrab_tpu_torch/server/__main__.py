"""Server entry point: `python -m throttlecrab_tpu_torch.server --http ...`.

Lifecycle as the reference's `main.rs:49-184`: parse config -> logging ->
metrics -> fault injection when `--faults` is set -> the flight recorder
when `--trace-dir` is set -> limiter on the device (6-wide insight rows
by default), wrapped in the launch supervisor -> with `--cluster-nodes`,
the cluster tier around it (parallel/cluster.py) -> checkpointer when
`--checkpoint-dir` is set -> front tier (deny cache + admission control)
-> boot restore (the newest verifiable checkpoint chain, else
`--snapshot-path` when the file exists) -> insight tier -> control plane
when `--control` is set -> micro-batching engine (a profiler capture of
its first launches with `--profile-dir`) -> transports (HTTP, gRPC
and/or Redis/RESP, HTTP and RESP each on asyncio or the native C++ wire
server; a cluster node adds its RPC listener and announces its
membership) -> wait for SIGINT/SIGTERM or a transport failure ->
shutdown.  SIGTERM drains first (de-route, flush queued requests with
real decisions, a cluster node's planned leave, bounded by
`--drain-timeout-ms`; 0 skips the drain); SIGINT
flushes and stops.  After the engine stops, the flight recorder closes
(a full-mode trace is then complete); after the transports stop, the
checkpointer writes a final generation and, with `--snapshot-path`, the
table is saved.
"""

from __future__ import annotations

import asyncio
import logging
import os
import signal
import sys
import time

from ..faults import FaultInjector, arm, parse_spec
from ..parallel.cluster import ClusterLimiter, ClusterServer
from ..persist import Checkpointer, recover_into
from ..replay import recorder as replay_recorder
from .config import Config, ConfigError
from .engine import BatchingEngine
from .metrics import Metrics
from .store import (
    create_cleanup_policy,
    create_control,
    create_front_tier,
    create_insight,
    create_limiter,
    create_supervised_limiter,
)

log = logging.getLogger("throttlecrab")

LOG_LEVELS = {
    "error": logging.ERROR,
    "warn": logging.WARNING,
    "info": logging.INFO,
    "debug": logging.DEBUG,
    "trace": logging.DEBUG,
}


def build_transports(config: Config, engine, metrics):
    """One instance per enabled transport (main.rs:74-116).  The native
    ones drive `engine.limiter` from their own threads under
    `engine.limiter_lock`, with the engine's clock and cleanup policy,
    so limits and sweeps are shared with the asyncio transports."""
    native_kw = dict(
        batch_size=config.batch_size,
        max_linger_us=config.max_linger_us,
        max_scan_depth=config.max_scan_depth,
        cleanup_policy=engine.cleanup_policy,
        limiter_lock=engine.limiter_lock,
        now_fn=engine.now_fn,
        front=engine.front,
        insight=engine.insight,
        checkpointer=engine.checkpointer,
        control=engine.control,
    )
    transports = []
    if config.http:
        if config.http_backend == "native":
            from .native_http import NativeHttpTransport

            transports.append(NativeHttpTransport(
                config.http_host, config.http_port, engine.limiter,
                metrics, **native_kw,
            ))
        else:
            from .http import HttpTransport

            transports.append(HttpTransport(
                config.http_host, config.http_port, engine, metrics
            ))
    if config.grpc:
        # Imported only here: a server without --grpc needs neither
        # grpcio nor protobuf.
        from .grpc import GrpcTransport

        transports.append(GrpcTransport(
            config.grpc_host, config.grpc_port, engine, metrics
        ))
    if config.redis:
        if config.redis_backend == "native":
            from .native_redis import NativeRedisTransport

            transports.append(NativeRedisTransport(
                config.redis_host, config.redis_port, engine.limiter,
                metrics, **native_kw,
            ))
        else:
            from .redis import RedisTransport

            transports.append(RedisTransport(
                config.redis_host, config.redis_port, engine, metrics
            ))
    return transports


class SnapshotRefused(RuntimeError):
    """Boot refused: the snapshot is corrupt and strict mode is on."""


def restore_snapshot_on_boot(limiter, config: Config, front=None) -> int:
    """Restore-on-boot with the THROTTLECRAB_SNAPSHOT_STRICT policy;
    returns the number of keys restored (0 when there is no snapshot or
    the non-strict path started cold).  Strict mode (the default) refuses
    a corrupt snapshot with SnapshotRefused; non-strict logs it and
    starts with an empty table.  `front`'s deny cache is cleared by the
    restore."""
    from ..tpu.snapshot import SnapshotError, _normalize, load_snapshot

    if not config.snapshot_path:
        return 0
    if not os.path.exists(_normalize(config.snapshot_path)):
        return 0
    try:
        restored = load_snapshot(
            limiter, config.snapshot_path, time.time_ns(), front=front
        )
        log.info(
            "restored %d keys from snapshot %s",
            restored, config.snapshot_path,
        )
        return restored
    except SnapshotError as e:
        if config.snapshot_strict:
            raise SnapshotRefused(
                f"refusing to start: {e} (set "
                "THROTTLECRAB_SNAPSHOT_STRICT=0 to log and start with "
                "an empty table instead)"
            ) from e
        log.error(
            "snapshot %s is corrupt; starting with an empty table "
            "(THROTTLECRAB_SNAPSHOT_STRICT=0): %s",
            config.snapshot_path, e,
        )
    except Exception:
        # Not corruption (e.g. capacity): soft state, a cold start.
        log.exception(
            "snapshot restore failed; starting cold (%s)",
            config.snapshot_path,
        )
    # A partial restore may have populated the keymap: sweep everything
    # so "cold" is real, not a table full of dead entries.
    try:
        limiter.sweep(1 << 62)
    except Exception:
        log.exception("post-restore-failure sweep failed")
    return 0


def restore_on_boot(limiter, config: Config, checkpointer,
                    front=None) -> int:
    """Boot restore precedence: the checkpoint chain first, the snapshot
    second.  Checkpoint recovery never refuses boot (torn or corrupt
    generations narrow what is restored: persist/recovery.py); only when
    no usable chain exists does boot fall through to `--snapshot-path`,
    which keeps its THROTTLECRAB_SNAPSHOT_STRICT policy."""
    if checkpointer is not None:
        try:
            res = recover_into(
                limiter, checkpointer.directory, time.time_ns(), front=front
            )
        except Exception:
            # Not corruption (e.g. capacity): the snapshot path's soft
            # policy — sweep to a real cold start and fall through.
            log.exception(
                "checkpoint recovery failed; falling back to snapshot "
                "restore (%s)", checkpointer.directory,
            )
            try:
                limiter.sweep(1 << 62)
            except Exception:
                log.exception("post-recovery-failure sweep failed")
            res = None
        if res is not None:
            checkpointer.note_recovery(
                res.restored, res.corrupt_skipped, res.chains
            )
            log.info(
                "recovered %d keys from checkpoint chain gen=%d "
                "(%d corrupt generation(s) skipped, manifest=%s)",
                res.restored, res.generation, res.corrupt_skipped,
                "used" if res.used_manifest else "rebuilt",
            )
            return res.restored
    return restore_snapshot_on_boot(limiter, config, front)


async def save_snapshot_on_shutdown(config: Config, engine) -> None:
    """Save the table to `--snapshot-path`: the device export runs under
    `engine.limiter_lock` (native driver threads share it), the .npz
    write outside it, both on the executor."""
    from ..tpu.snapshot import export_snapshot_payload, write_snapshot_payload

    def locked_export() -> dict:
        with engine.limiter_lock:
            return export_snapshot_payload(engine.limiter)

    loop = asyncio.get_running_loop()
    try:
        payload = await loop.run_in_executor(None, locked_export)
        saved = await loop.run_in_executor(
            None, write_snapshot_payload, payload, config.snapshot_path,
        )
        log.info("saved %d keys to snapshot %s", saved, config.snapshot_path)
    except Exception:
        log.exception("snapshot save failed (%s)", config.snapshot_path)


async def run_server(config: Config) -> None:
    metrics = Metrics(max_denied_keys=config.max_denied_keys)
    log.info(
        "starting rate limiter with %s store on %s", config.store,
        config.device,
    )
    if config.faults:
        # Deterministic injected faults at the failure surfaces (faults/).
        arm(FaultInjector(parse_spec(config.faults),
                          seed=config.faults_seed))
        log.warning("fault injection armed: %s", config.faults)
    recorder = replay_recorder.from_config(config)
    if recorder is not None:
        # Flight recorder: the engine flush path, the native drivers and
        # the supervisor's degrade path all feed this one process-wide
        # recorder; GET /trace/dump and a persistent degrade dump it.
        replay_recorder.arm(recorder)
        log.info(
            "trace recorder armed: dir=%s mode=%s windows=%d",
            config.trace_dir, config.trace_mode, config.trace_windows,
        )
    # Every transport drives the same supervised limiter, so retry /
    # degrade / re-promote decisions are made once, under the shared
    # limiter lock.
    device_limiter = create_limiter(config)
    if getattr(device_limiter, "tenants", None) is not None:
        # Sharded mesh with the tenant layer armed: export the
        # mesh-global per-tenant counters on GET /metrics.
        metrics.set_tenant_stats_provider(device_limiter.tenant_stats)
    supervisor = create_supervised_limiter(config, device_limiter, metrics)
    metrics.set_engine_state_provider(lambda: supervisor.state)
    limiter = supervisor
    cluster_nodes = config.cluster_node_list()
    if cluster_nodes:
        # Multi-node deployment: every key has one owner node; remote
        # keys forward over the cluster RPC and limits hold globally
        # (parallel/cluster.py).
        log.info(
            "cluster mode: node %d of %d (%s)",
            config.cluster_index, len(cluster_nodes),
            cluster_nodes[config.cluster_index],
        )
        limiter = ClusterLimiter(
            supervisor, cluster_nodes, config.cluster_index,
            io_timeout_s=config.cluster_timeout_ms / 1000.0,
            breaker_failures=config.cluster_breaker_failures,
            breaker_cooldown_s=config.cluster_breaker_cooldown_ms / 1000.0,
            connect_timeout_s=config.cluster_connect_timeout_ms / 1000.0,
            vnodes=config.cluster_vnodes,
            replicate=config.cluster_replicate,
            handoff_timeout_s=config.cluster_handoff_timeout_ms / 1000.0,
            replica_cap=config.cluster_replica_cap,
        )
        metrics.set_cluster_stats_provider(limiter.peer_stats)
        metrics.set_cluster_view_provider(limiter.cluster_view)
        if config.cluster_vnodes > 0:
            # A degraded node shrinks its ring weight so its neighbours
            # absorb load; re-promotion restores it.  The hooks run
            # under the limiter lock, so they only schedule: the
            # cluster's pump applies the weight outside it.
            cluster = limiter
            supervisor.on_degrade = lambda: cluster.schedule_reweight(0.5)
            supervisor.on_repromote = (
                lambda: cluster.schedule_reweight(1.0)
            )
    checkpointer = None
    if config.checkpoint_dir:
        # Crash durability: background generation-chain checkpoints plus
        # boot-time recovery.  With interval 0 it is recovery and the
        # shutdown flush only (no ticks, no dirty tracking).
        checkpointer = Checkpointer(
            limiter,
            config.checkpoint_dir,
            interval_ns=config.checkpoint_interval_ms * 1_000_000,
            retain=config.checkpoint_retain,
            mode=config.checkpoint_mode,
        )
        metrics.set_checkpoint_stats_provider(checkpointer.metric_stats)
        log.info(
            "checkpointing armed: dir=%s interval=%dms retain=%d mode=%s",
            config.checkpoint_dir, config.checkpoint_interval_ms,
            config.checkpoint_retain, config.checkpoint_mode,
        )
    # The front tier is shared by the engine and the native transports;
    # a re-promotion rewrites bucket state, so the supervisor invalidates
    # the deny cache through it.
    front = create_front_tier(config, metrics, limiter)
    supervisor.front = front
    loop = asyncio.get_running_loop()
    # The restore is a device bulk insert: executor, not the event loop,
    # and done before any transport (the cluster listener included)
    # starts.
    await loop.run_in_executor(
        None, restore_on_boot, limiter, config, checkpointer, front
    )
    # The insight tier watches the device limiter; the supervisor feeds
    # it from the host oracle while degraded so /stats stays truthful.
    insight = create_insight(config, metrics, device_limiter, front)
    supervisor.insight = insight
    if cluster_nodes and insight is not None:
        # A cluster node's table is serialized by the cluster's device
        # lock (the RPC listener decides under it, not under the
        # engine's limiter lock): the insight poll takes the same one.
        insight.poll_lock = limiter.device_lock
    cleanup_policy = create_cleanup_policy(config)
    # The control plane tunes the knobs of the tiers just built; off by
    # default (THROTTLECRAB_CONTROL=0), when nothing ticks and no knob
    # moves.
    control = create_control(
        config, metrics, limiter, front, insight, cleanup_policy
    )
    if cluster_nodes and control is not None:
        # As for the insight poll: the tick's sensor reads ride the
        # cluster's device lock.
        control.tick_lock = limiter.device_lock
    engine = BatchingEngine(
        limiter,
        batch_size=config.batch_size,
        max_linger_us=config.max_linger_us,
        max_scan_depth=config.max_scan_depth,
        cleanup_policy=cleanup_policy,
        metrics=metrics,
        front=front,
        deadline_default_ms=config.deadline_default_ms,
        insight=insight,
        checkpointer=checkpointer,
        control=control,
        profile_dir=config.profile_dir or None,
    )
    transports = build_transports(config, engine, metrics)
    if cluster_nodes:
        # The RPC listener decides on the local limiter under the
        # cluster's device lock, not the engine's limiter lock, which is
        # held across outbound peer RPCs: sharing it would deadlock two
        # nodes forwarding to each other.
        rpc_port = int(
            cluster_nodes[config.cluster_index].rpartition(":")[2]
        )
        transports.append(
            ClusterServer(
                config.cluster_bind_host, rpc_port, limiter.local,
                limiter.device_lock, cluster=limiter,
            )
        )
    for transport in transports:
        await transport.start()
    if cluster_nodes and config.cluster_vnodes > 0:
        # Announce membership once the RPC listener is up, so peers can
        # stream this node's key range back (join and rejoin).
        limiter.start_membership()

    stop = asyncio.Event()
    drain_requested = False

    def _signal_handler(graceful: bool) -> None:
        nonlocal drain_requested
        log.info("shutdown signal received (%s)",
                 "drain" if graceful else "kill")
        drain_requested = drain_requested or graceful
        stop.set()

    for sig, graceful in ((signal.SIGINT, False), (signal.SIGTERM, True)):
        loop.add_signal_handler(sig, _signal_handler, graceful)

    serve_tasks = {
        asyncio.create_task(t.serve_forever(), name=f"transport-{t.name}"): t
        for t in transports
    }
    stop_task = asyncio.create_task(stop.wait())
    # A transport ending with an error ends the process with an error,
    # as the reference's JoinSet select does (main.rs:143-171).
    done, _ = await asyncio.wait(
        [*serve_tasks, stop_task], return_when=asyncio.FIRST_COMPLETED
    )
    failed = []
    for task in done:
        if task is not stop_task and task.exception() is not None:
            failed.append(serve_tasks[task].name)
            log.error("%s transport failed: %r", failed[-1],
                      task.exception())

    log.info("shutting down")
    stop_task.cancel()
    if drain_requested and config.drain_timeout_ms > 0 and not failed:
        async def _drain() -> None:
            engine.begin_drain()
            for transport in transports:
                drain_hook = getattr(transport, "drain", None)
                if drain_hook is not None:
                    await drain_hook()
            await engine.drain()
            # Planned cluster leave: stream this node's key range to its
            # new owners (no lost decisions, no replica staleness);
            # blocking socket work, so on the executor.
            if cluster_nodes and config.cluster_vnodes > 0:
                left = await loop.run_in_executor(None, limiter.leave)
                if not left:
                    log.warning(
                        "planned leave unavailable; peers take over "
                        "via the kill path"
                    )

        try:
            await asyncio.wait_for(_drain(), config.drain_timeout_ms / 1000.0)
            log.info("drain complete")
        except asyncio.TimeoutError:
            log.warning(
                "drain timed out after %dms; falling back to the kill "
                "path", config.drain_timeout_ms,
            )
    await engine.shutdown()
    if recorder is not None:
        # Finalize the trace: full mode flushes and closes its file, so
        # a recorded workload replays after a clean stop (ring mode
        # persists nothing unless dumped).
        await loop.run_in_executor(None, recorder.close)
        replay_recorder.disarm()
    for transport in transports:
        await transport.stop()
    if checkpointer is not None:
        # Final generation: the transports are stopped, so the export
        # races nothing.  Best-effort; a failed flush leaves the last
        # durable chain intact.
        await loop.run_in_executor(None, checkpointer.stop)
    if config.snapshot_path:
        await save_snapshot_on_shutdown(config, engine)
    for task in serve_tasks:
        task.cancel()
    await asyncio.gather(*serve_tasks, stop_task, return_exceptions=True)
    if failed:
        raise TransportFailure(
            f"the {' and '.join(failed)} transport ended with an error"
        )


class TransportFailure(RuntimeError):
    pass


def main(argv=None) -> int:
    try:
        config = Config.from_env_and_args(argv)
    except ConfigError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    logging.basicConfig(
        level=LOG_LEVELS.get(config.log_level.lower(), logging.INFO),
        format="%(asctime)s %(levelname)s %(name)s: %(message)s",
    )
    try:
        asyncio.run(run_server(config))
    except KeyboardInterrupt:
        pass
    except SnapshotRefused as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    except TransportFailure:
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
