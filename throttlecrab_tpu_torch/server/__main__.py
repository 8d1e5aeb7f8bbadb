"""Server entry point: `python -m throttlecrab_tpu_torch.server --http ...`.

Lifecycle as the reference's `main.rs:49-184`: parse config -> logging ->
metrics -> limiter on the device + micro-batching engine -> HTTP transport
-> wait for SIGINT/SIGTERM -> shutdown.  SIGTERM drains first (stop
accepting, flush queued requests with real decisions, bounded by
DRAIN_TIMEOUT_S); SIGINT flushes and stops.
"""

from __future__ import annotations

import asyncio
import logging
import signal
import sys

from .config import Config, ConfigError
from .engine import BatchingEngine
from .http import HttpTransport
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
    transport = HttpTransport(
        config.http_host, config.http_port, engine, metrics
    )
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

    serve_task = asyncio.create_task(transport.serve_forever())
    stop_task = asyncio.create_task(stop.wait())
    done, _ = await asyncio.wait(
        [serve_task, stop_task], return_when=asyncio.FIRST_COMPLETED
    )
    failed = serve_task in done and serve_task.exception() is not None
    if failed:
        log.error("transport failed: %r", serve_task.exception())

    log.info("shutting down")
    stop_task.cancel()
    if drain_requested and not failed:
        async def _drain() -> None:
            engine.begin_drain()
            await transport.drain()
            await engine.drain()

        try:
            await asyncio.wait_for(_drain(), DRAIN_TIMEOUT_S)
            log.info("drain complete")
        except asyncio.TimeoutError:
            log.warning("drain timed out after %.0fs", DRAIN_TIMEOUT_S)
    await engine.shutdown()
    await transport.stop()
    serve_task.cancel()
    await asyncio.gather(serve_task, stop_task, return_exceptions=True)
    if failed:
        raise TransportFailure("the HTTP transport ended with an error")


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
