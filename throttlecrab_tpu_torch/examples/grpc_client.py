"""Call a running throttlecrab server over gRPC — the client-side
example for the proto transport (reference:
throttlecrab-server/examples/grpc_client.rs:1-51).

The port's counterpart of the JAX package's `examples/grpc_client.py`.
Start a server first:
    python -m throttlecrab_tpu_torch.server --grpc --grpc-port 9070

Then:
    python -m throttlecrab_tpu_torch.examples.grpc_client
        [--target 127.0.0.1:9070]

Needs grpcio and protobuf, imported only when the example runs (the
package imports without them).  The method is called through its full
name, so no stub generation is required — the request/response classes
come from the checked-in `server/proto/throttlecrab_pb2` module.
"""

from __future__ import annotations

import argparse
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--target", default="127.0.0.1:9070")
    args = ap.parse_args(argv)

    import grpc

    from ..server.proto import throttlecrab_pb2 as pb

    channel = grpc.insecure_channel(args.target)
    throttle = channel.unary_unary(
        "/throttlecrab.RateLimiter/Throttle",
        request_serializer=pb.ThrottleRequest.SerializeToString,
        response_deserializer=pb.ThrottleResponse.FromString,
    )

    print("Burst 5, then denial:")
    for i in range(7):
        resp = throttle(
            pb.ThrottleRequest(
                key="grpc:user:99",
                max_burst=5,
                count_per_period=100,
                period=60,
                quantity=1,
            ),
            timeout=30,
        )
        verdict = "allowed" if resp.allowed else (
            f"DENIED (retry after {resp.retry_after}s)"
        )
        print(
            f"  request {i + 1}: {verdict}  "
            f"limit={resp.limit} remaining={resp.remaining}"
        )

    channel.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
