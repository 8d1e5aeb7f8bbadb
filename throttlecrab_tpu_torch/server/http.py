"""HTTP/JSON transport.

Same wire surface as the reference's router (`http.rs:103-163`) and as
`throttlecrab_tpu/server/http.py`: `POST /throttle` with `{key, max_burst,
count_per_period, period, quantity?}` (quantity defaults to 1), `GET
/health` returning "OK" (or the serving state's name; with checkpoints
armed, followed by " checkpoint_age_s=..."), `GET /metrics` returning
Prometheus text, and `GET /stats` returning the insight tier's JSON.
Timestamps are always server-side.  Errors return `{"error": ...}` with
400 (malformed request), 500 (validation), 503 (draining, or shed by the
front tier's admission control) or 504 (client deadline lapsed in the
queue).

A deliberately minimal HTTP/1.1 server (keep-alive, Content-Length
bodies) on asyncio streams.
"""

from __future__ import annotations

import asyncio
import json
import logging
from typing import Optional

from .engine import BatchingEngine, DeadlineError, OverloadError, ThrottleError
from .metrics import Metrics
from .transport_base import ConnTrackingMixin
from .types import ThrottleRequest

log = logging.getLogger("throttlecrab.http")

MAX_HEADER_BYTES = 16 * 1024
MAX_BODY_BYTES = 1 << 20

_REASONS = {
    200: "OK", 400: "Bad Request", 404: "Not Found",
    500: "Internal Server Error", 503: "Service Unavailable",
    504: "Gateway Timeout",
}


class HttpTransport(ConnTrackingMixin):
    """`POST /throttle` + `GET /health` + `GET /metrics` + `GET /stats`."""

    name = "http"

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
        log.info("HTTP transport listening on %s:%d", self.host, self.port)

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
        task = self._track_conn()
        try:
            while True:
                request = await self._read_request(reader)
                if request is None:
                    break
                method, path, headers, body = request
                keep_alive = (
                    headers.get("connection", "keep-alive").lower() != "close"
                )
                status, payload, content_type = await self._route(
                    method, path, body, headers
                )
                await self._write_response(
                    writer, status, payload, content_type, keep_alive
                )
                if not keep_alive:
                    break
        except (
            asyncio.IncompleteReadError,
            ConnectionResetError,
            BrokenPipeError,
        ):
            pass
        except asyncio.CancelledError:
            pass  # server shutdown dropped the connection
        except Exception:
            log.exception("HTTP connection error")
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

    async def _read_request(self, reader):
        """Parse one HTTP/1.1 request; None on clean EOF."""
        try:
            head = await reader.readuntil(b"\r\n\r\n")
        except asyncio.IncompleteReadError as e:
            if not e.partial:
                return None
            raise
        except asyncio.LimitOverrunError:
            raise ValueError("header section too large")
        if len(head) > MAX_HEADER_BYTES:
            raise ValueError("header section too large")
        lines = head.decode("latin-1").split("\r\n")
        method, path, _version = lines[0].split(" ", 2)
        headers = {}
        for line in lines[1:]:
            if ":" in line:
                k, v = line.split(":", 1)
                headers[k.strip().lower()] = v.strip()
        length = int(headers.get("content-length", "0"))
        if length > MAX_BODY_BYTES:
            raise ValueError("body too large")
        body = await reader.readexactly(length) if length else b""
        return method, path, headers, body

    async def _route(self, method: str, path: str, body: bytes, headers=None):
        if method == "POST" and path == "/throttle":
            return await self._handle_throttle(body, headers or {})
        if method == "GET" and path == "/health":
            # "OK" in the ok state (reference-compatible), else the
            # state name: the supervisor's ("retrying", "degraded",
            # "recovering") or the engine's ("draining", "shutdown").
            # Always 200: a degraded node still answers, from the host.
            state = self.engine.health_state()
            body = b"OK" if state == "ok" else state.encode()
            ck = getattr(self.engine, "checkpointer", None)
            if ck is not None:
                # The last checkpoint's age rides /health only when
                # durability is armed (the bare "OK" is a wire contract).
                body += b" " + ck.health_suffix().encode()
            return 200, body, "text/plain"
        if method == "GET" and path == "/metrics":
            return (
                200,
                self.metrics.export_prometheus().encode(),
                "text/plain; version=0.0.4",
            )
        if method == "GET" and path == "/stats":
            # The insight tier's JSON; with the tier off the shape still
            # answers (enabled: false) so pollers need no probe logic.
            insight = getattr(self.engine, "insight", None)
            if insight is None:
                payload = json.dumps({"insight": {"enabled": False}})
            else:
                payload = insight.stats_json(
                    state=self.engine.health_state()
                )
            return 200, payload.encode(), "application/json"
        return 404, b"Not Found", "text/plain"

    @staticmethod
    def _error(status: int, message: str):
        return status, json.dumps({"error": message}).encode(), "application/json"

    async def _handle_throttle(self, body: bytes, headers):
        """http.rs:123-159 — server timestamp, quantity default 1.

        `X-Throttlecrab-Deadline-Ms: N` (optional) stamps a client deadline
        N ms out; a request still queued past it is shed with 504."""
        try:
            data = json.loads(body)
            request = ThrottleRequest(
                key=str(data["key"]),
                max_burst=int(data["max_burst"]),
                count_per_period=int(data["count_per_period"]),
                period=int(data["period"]),
                quantity=int(data.get("quantity", 1)),
            )
            deadline_ms = headers.get("x-throttlecrab-deadline-ms")
            if deadline_ms is not None:
                ms = int(deadline_ms)
                if ms > 0:
                    request.deadline_ns = self.engine.now_fn() + ms * 1_000_000
        except (json.JSONDecodeError, KeyError, TypeError, ValueError) as e:
            self.metrics.record_error(self.name)
            return self._error(400, f"invalid request: {e}")
        try:
            response = await self.engine.throttle(request)
        except OverloadError as e:
            self.metrics.record_error(self.name)
            return self._error(503, str(e))
        except DeadlineError as e:
            self.metrics.record_error(self.name)
            return self._error(504, str(e))
        except ThrottleError as e:
            self.metrics.record_error(self.name)
            return self._error(500, str(e))
        self.metrics.record_request_with_key(
            self.name, response.allowed, request.key
        )
        payload = json.dumps(
            {
                "allowed": response.allowed,
                "limit": response.limit,
                "remaining": response.remaining,
                "reset_after": response.reset_after,
                "retry_after": response.retry_after,
            }
        ).encode()
        return 200, payload, "application/json"

    async def _write_response(
        self, writer, status, payload, content_type, keep_alive
    ) -> None:
        head = (
            f"HTTP/1.1 {status} {_REASONS.get(status, 'OK')}\r\n"
            f"Content-Type: {content_type}\r\n"
            f"Content-Length: {len(payload)}\r\n"
            f"Connection: {'keep-alive' if keep_alive else 'close'}\r\n"
            "\r\n"
        ).encode("latin-1")
        writer.write(head + payload)
        await writer.drain()
