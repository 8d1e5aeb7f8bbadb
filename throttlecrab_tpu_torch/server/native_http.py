"""Native HTTP/JSON transport: the C++ epoll wire layer speaking HTTP.

The port's counterpart of `throttlecrab_tpu/server/native_http.py`: the
driver of the native RESP backend (native_redis.py) with the wire layer
in its HTTP protocol.  The C++ side parses `POST /throttle` JSON bodies
and answers `GET /health` / `GET /metrics` / `GET /stats` inline from
snapshots the driver refreshes every second (/health: "OK", else the
launch supervisor's state: "retrying" | "degraded" | "recovering", or
"draining" after drain(); with checkpoints armed, followed by
" checkpoint_age_s=..."; /stats: the insight tier's document).
Wire schema matches the reference's axum routes (`http.rs:61-163`):
quantity defaults to 1, server-side timestamps, engine errors as 500
`{"error": ...}`, rows the front tier sheds as 503.

Selectable via `--http-backend native`.
"""

from __future__ import annotations

from .native_redis import NativeRedisTransport


class NativeHttpTransport(NativeRedisTransport):
    name = "http"
    PROTOCOL = 1
