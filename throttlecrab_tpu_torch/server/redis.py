"""Redis/RESP transport (asyncio).

The port's counterpart of `throttlecrab_tpu/server/redis.py`, over the
port's BatchingEngine.  Wire-compatible with the reference
(`transport/redis/mod.rs`): commands `THROTTLE key max_burst
count_per_period period [quantity [deadline_ms]]`, `PING [msg]`, and
`QUIT`, all case-insensitive; a THROTTLE response is the 5-integer array
`[allowed, limit, remaining, reset_after, retry_after]`
(`redis/mod.rs:276-284`).  Connection hardening mirrors
`redis/mod.rs:83-149`: 64 KB per-connection buffer cap, 5-minute idle
timeout, per-connection error isolation, QUIT replies +OK then closes.
"""

from __future__ import annotations

import asyncio
import logging
from typing import Optional

from .engine import (
    BatchingEngine,
    DeadlineError,
    OverloadError,
    ThrottleError,
)
from .metrics import Metrics
from .transport_base import ConnTrackingMixin
from .resp import (
    Array,
    BulkString,
    Error,
    Integer,
    RespError,
    RespParser,
    SimpleString,
    serialize,
)
from .types import ThrottleRequest

log = logging.getLogger("throttlecrab.redis")

MAX_BUFFER_SIZE = 64 * 1024  # redis/mod.rs:83
IDLE_TIMEOUT_SECS = 300  # redis/mod.rs:99


class RedisTransport(ConnTrackingMixin):
    """RESP TCP accept loop + command dispatch."""

    name = "redis"

    def __init__(
        self, host: str, port: int, engine: BatchingEngine, metrics: Metrics
    ) -> None:
        self.host = host
        self.port = port
        self.engine = engine
        self.metrics = metrics
        self._server: Optional[asyncio.AbstractServer] = None
        self._init_conn_tracking()

    async def start(self) -> None:
        self._server = await asyncio.start_server(
            self._handle_connection, self.host, self.port
        )
        log.info("Redis transport listening on %s:%d", self.host, self.port)

    async def serve_forever(self) -> None:
        if self._server is None:
            await self.start()
        async with self._server:
            await self._server.serve_forever()

    async def stop(self) -> None:
        if self._server is not None:
            await self._stop_dropping_conns(self._server)

    @property
    def bound_port(self) -> int:
        return self._server.sockets[0].getsockname()[1]

    # ------------------------------------------------------------------ #

    async def _handle_connection(self, reader, writer) -> None:
        """redis/mod.rs:85-149: read → accumulate → parse → dispatch."""
        task = self._track_conn()
        buffer = b""
        parser = RespParser()
        try:
            while True:
                try:
                    chunk = await asyncio.wait_for(
                        reader.read(4096), timeout=IDLE_TIMEOUT_SECS
                    )
                except asyncio.TimeoutError:
                    log.debug("connection idle timeout")
                    break
                if not chunk:
                    break
                buffer += chunk
                if len(buffer) > MAX_BUFFER_SIZE:
                    writer.write(
                        serialize(Error("ERR request too large"))
                    )
                    await writer.drain()
                    break
                quit_conn = False
                while buffer:
                    try:
                        result = parser.parse(buffer)
                    except RespError as e:
                        writer.write(serialize(Error(f"ERR {e}")))
                        await writer.drain()
                        quit_conn = True
                        break
                    if result is None:
                        break
                    value, consumed = result
                    buffer = buffer[consumed:]
                    response, quit_conn = await self._process_command(value)
                    writer.write(serialize(response))
                    await writer.drain()
                    if quit_conn:
                        break
                if quit_conn:
                    break
        except (ConnectionResetError, BrokenPipeError):
            pass
        except asyncio.CancelledError:
            pass  # server shutdown dropped the connection
        except Exception:
            log.exception("Redis connection error")
        finally:
            writer.close()
            try:
                # Untrack only after the last await: stop()'s cancel loop
                # must still reach a handler stuck in wait_closed.
                await writer.wait_closed()
            except Exception:
                pass
            finally:
                self._untrack_conn(task)

    # ------------------------------------------------------------------ #

    async def _process_command(self, value):
        """redis/mod.rs:150-208.  Returns (response, close_connection)."""
        if not isinstance(value, Array):
            return Error("ERR expected array of commands"), False
        if not value.value:
            return Error("ERR empty command"), False
        head = value.value[0]
        if not (isinstance(head, BulkString) and head.value is not None):
            return Error("ERR invalid command format"), False
        command = head.value.upper()

        if command == "PING":
            return self._handle_ping(value.value), False
        if command == "THROTTLE":
            key = None
            if len(value.value) > 1:
                arg = value.value[1]
                if isinstance(arg, BulkString) and arg.value is not None:
                    key = arg.value
            result = await self._handle_throttle(value.value)
            # An error reply counts as a denial, as in the JAX transport.
            allowed = (
                isinstance(result, Array)
                and len(result.value) >= 5
                and result.value[0] == Integer(1)
            )
            if key is not None:
                self.metrics.record_request_with_key(self.name, allowed, key)
            else:
                self.metrics.record_request(self.name, allowed)
            return result, False
        if command == "QUIT":
            return SimpleString("OK"), True
        return Error(f"ERR unknown command '{command}'"), False

    @staticmethod
    def _handle_ping(args):
        """redis/mod.rs:209-218."""
        if len(args) == 1:
            return SimpleString("PONG")
        if len(args) == 2:
            return args[1]
        return Error("ERR wrong number of arguments for 'ping' command")

    async def _handle_throttle(self, args):
        """redis/mod.rs:221-287.

        A 7th token (after quantity) is an optional client deadline in
        milliseconds: `THROTTLE key burst count period quantity
        deadline_ms`.  Expired-in-queue requests answer
        `-ERR deadline exceeded` without a device launch."""
        if not 5 <= len(args) <= 7:
            return Error(
                "ERR wrong number of arguments for 'throttle' command"
            )
        if not (isinstance(args[1], BulkString) and args[1].value is not None):
            return Error("ERR invalid key")
        key = args[1].value
        max_burst = _parse_integer(args[2])
        if max_burst is None:
            return Error("ERR invalid max_burst")
        count_per_period = _parse_integer(args[3])
        if count_per_period is None:
            return Error("ERR invalid count_per_period")
        period = _parse_integer(args[4])
        if period is None:
            return Error("ERR invalid period")
        if len(args) >= 6:
            quantity = _parse_integer(args[5])
            if quantity is None:
                return Error("ERR invalid quantity")
        else:
            quantity = 1
        deadline_ns = None
        if len(args) == 7:
            deadline_ms = _parse_integer(args[6])
            if deadline_ms is None:
                return Error("ERR invalid deadline_ms")
            if deadline_ms > 0:
                deadline_ns = (
                    self.engine.now_fn() + deadline_ms * 1_000_000
                )

        request = ThrottleRequest(
            key=key,
            max_burst=max_burst,
            count_per_period=count_per_period,
            period=period,
            quantity=quantity,
            deadline_ns=deadline_ns,
        )
        try:
            response = await self.engine.throttle(request)
        except OverloadError as e:
            # Shed by admission control; RESP has one error channel, so
            # the overload status is the distinguished message text.
            return Error(f"ERR {e}")
        except DeadlineError as e:
            # Same single error channel: "deadline exceeded" is the
            # distinguished timeout message.
            return Error(f"ERR {e}")
        except ThrottleError as e:
            return Error(f"ERR {e}")
        return Array(
            (
                Integer(1 if response.allowed else 0),
                Integer(response.limit),
                Integer(response.remaining),
                Integer(response.reset_after),
                Integer(response.retry_after),
            )
        )


def _parse_integer(value) -> Optional[int]:
    """redis/mod.rs:289-296: bulk strings parse as i64, integers pass.

    ASCII digits only — Rust's i64::parse rejects Unicode digits that
    Python's int() would accept (e.g. Arabic-Indic numerals).
    """
    if isinstance(value, BulkString) and value.value is not None:
        s = value.value
        body = s[1:] if s[:1] in ("+", "-") else s
        if body.isascii() and body.isdigit():
            n = int(s)
            if -(1 << 63) <= n < (1 << 63):
                return n
        return None
    if isinstance(value, Integer):
        return value.value
    return None
