"""Load-generation harness: the `integration-tests` crate equivalent.

The port of `throttlecrab_tpu/harness/`: a client of the server's
transports, numpy only, with the port's own `control`, `server/proto`
and `replay/trace`; the gRPC client imports `grpc` only when used.

Drives a running server over real sockets with configurable concurrency,
workload shapes and key distributions, reporting throughput and latency
percentiles (p50-p99.9) per transport — the same measurement surface as the
reference's perf tool (`integration-tests/src/perf_test_multi_transport.rs`)
plus the workload/key patterns designed in its benchmark suite
(`tests/integration/workload.rs:8-52`).
"""

from .loadgen import PerfResult, run_perf_test

__all__ = ["PerfResult", "run_perf_test"]
