"""gRPC transport: the port of `throttlecrab_tpu/server/grpc.py`.

Serves the reference's exact proto (`throttlecrab-server/proto/
throttlecrab.proto`: package `throttlecrab`, service `RateLimiter`, rpc
`Throttle`) over `grpc.aio`, so tonic/grpcurl clients of the reference work
unchanged.  Like the reference service (`grpc.rs:136-194`): proto int32
fields widen to internal i64, timestamps are server-side, responses narrow
back to int32 (the engine's compact path already saturates at i32::MAX),
and engine failures surface as INTERNAL status.

The service is registered with a generic handler built from the
protoc-generated message classes — no grpc_tools codegen dependency.
Requests go through `BatchingEngine.throttle`, the path the asyncio HTTP
transport takes.  The server imports this module only for `--grpc`.
"""

from __future__ import annotations

import logging
from typing import Optional

import grpc
import grpc.aio

from .engine import (
    BatchingEngine,
    DeadlineError,
    OverloadError,
    ThrottleError,
)
from .metrics import Metrics
from .proto import throttlecrab_pb2 as pb
from .types import ThrottleRequest

log = logging.getLogger("throttlecrab.grpc")

SERVICE_NAME = "throttlecrab.RateLimiter"
_I32_MAX = (1 << 31) - 1


def _i32(value: int) -> int:
    return min(value, _I32_MAX)


class GrpcTransport:
    """`throttlecrab.RateLimiter/Throttle` on grpc.aio."""

    name = "grpc"

    def __init__(
        self, host: str, port: int, engine: BatchingEngine, metrics: Metrics
    ) -> None:
        self.host = host
        self.port = port
        self.engine = engine
        self.metrics = metrics
        self._server: Optional[grpc.aio.Server] = None
        self.bound_port: Optional[int] = None

    async def start(self) -> None:
        self._server = grpc.aio.server()
        self._server.add_generic_rpc_handlers((self._make_handler(),))
        self.bound_port = self._server.add_insecure_port(
            f"{self.host}:{self.port}"
        )
        await self._server.start()
        log.info(
            "gRPC transport listening on %s:%d", self.host, self.bound_port
        )

    async def serve_forever(self) -> None:
        if self._server is None:
            await self.start()
        await self._server.wait_for_termination()

    async def stop(self) -> None:
        if self._server is not None:
            await self._server.stop(grace=1.0)

    # ------------------------------------------------------------------ #

    def _make_handler(self):
        method_handlers = {
            "Throttle": grpc.unary_unary_rpc_method_handler(
                self._throttle,
                request_deserializer=pb.ThrottleRequest.FromString,
                response_serializer=pb.ThrottleResponse.SerializeToString,
            )
        }
        return grpc.method_handlers_generic_handler(
            SERVICE_NAME, method_handlers
        )

    async def _throttle(self, request: pb.ThrottleRequest, context):
        """grpc.rs:148-194: widen i32→i64, server timestamp, narrow back."""
        internal = ThrottleRequest(
            key=request.key,
            max_burst=request.max_burst,
            count_per_period=request.count_per_period,
            period=request.period,
            # Passed through verbatim (grpc.rs:164): proto3's implicit 0 is
            # a free probe, matching the library's quantity-0 semantics.
            quantity=request.quantity,
        )
        # gRPC carries deadlines natively: map the call's remaining
        # budget onto the engine queue entry so an expired-in-queue
        # request is shed host-side (DEADLINE_EXCEEDED) instead of
        # spending a device launch the client will never see.
        remaining_s = context.time_remaining()
        if remaining_s is not None:
            internal.deadline_ns = self.engine.now_fn() + int(
                remaining_s * 1e9
            )
        try:
            response = await self.engine.throttle(internal)
        except OverloadError as e:
            # Shed by admission control: RESOURCE_EXHAUSTED is gRPC's
            # overload status (clients back off; INTERNAL means a bug).
            self.metrics.record_error(self.name)
            await context.abort(grpc.StatusCode.RESOURCE_EXHAUSTED, str(e))
        except DeadlineError as e:
            self.metrics.record_error(self.name)
            await context.abort(grpc.StatusCode.DEADLINE_EXCEEDED, str(e))
        except ThrottleError as e:
            self.metrics.record_error(self.name)
            await context.abort(grpc.StatusCode.INTERNAL, str(e))
        self.metrics.record_request_with_key(
            self.name, response.allowed, internal.key
        )
        return pb.ThrottleResponse(
            allowed=response.allowed,
            limit=_i32(response.limit),
            remaining=_i32(response.remaining),
            reset_after=_i32(response.reset_after),
            retry_after=_i32(response.retry_after),
        )
