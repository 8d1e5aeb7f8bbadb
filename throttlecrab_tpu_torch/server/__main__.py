"""Server entry point: `python -m throttlecrab_tpu_torch.server --http ...`.

Lifecycle as the reference's `main.rs:49-184`: parse config -> logging ->
metrics -> limiter on the device + micro-batching engine -> transports
(HTTP and/or Redis/RESP, each on asyncio or the native C++ wire server)
-> wait for SIGINT/SIGTERM or a transport failure -> shutdown.  SIGTERM
drains first (de-route, flush queued requests with real decisions,
bounded by DRAIN_TIMEOUT_S); SIGINT flushes and stops.
"""

from __future__ import annotations

import asyncio
import logging
import signal
import sys

from .config import Config, ConfigError
from .engine import BatchingEngine
from .metrics import Metrics
from .store import create_cleanup_policy, create_limiter

log = logging.getLogger("throttlecrab")

LOG_LEVELS = {
    "error": logging.ERROR,
    "warn": logging.WARNING,
    "info": logging.INFO,
    "debug": logging.DEBUG,
    "trace": logging.DEBUG,
}

DRAIN_TIMEOUT_S = 10.0


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


async def run_server(config: Config) -> None:
    metrics = Metrics()
    log.info(
        "starting rate limiter with %s store on %s", config.store,
        config.device,
    )
    limiter = create_limiter(config)
    engine = BatchingEngine(
        limiter,
        batch_size=config.batch_size,
        max_linger_us=config.max_linger_us,
        max_scan_depth=config.max_scan_depth,
        cleanup_policy=create_cleanup_policy(config),
        metrics=metrics,
    )
    transports = build_transports(config, engine, metrics)
    for transport in transports:
        await transport.start()

    loop = asyncio.get_running_loop()
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
    if drain_requested and not failed:
        async def _drain() -> None:
            engine.begin_drain()
            for transport in transports:
                await transport.drain()
            await engine.drain()

        try:
            await asyncio.wait_for(_drain(), DRAIN_TIMEOUT_S)
            log.info("drain complete")
        except asyncio.TimeoutError:
            log.warning("drain timed out after %.0fs", DRAIN_TIMEOUT_S)
    await engine.shutdown()
    for transport in transports:
        await transport.stop()
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
    except TransportFailure:
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
