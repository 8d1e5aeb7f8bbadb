#!/usr/bin/env bash
# End-to-end transport perf driver of the port: the counterpart of the
# JAX package's scripts/run-transport-test.sh, with its flags and ports.
# Boots `python3 -m throttlecrab_tpu_torch.server` with every selected
# transport (HTTP always, for /health) on high ports, waits on /health,
# warms up, runs `python3 -m throttlecrab_tpu_torch.harness perf-test`
# per transport (one JSON summary line each), then stops the server.
#
# Usage: throttlecrab_tpu_torch/tools/run-transport-test.sh
#        [-t http|grpc|redis|all] [-T workers] [-r requests-per-worker]
#        [--cpu] [--native] [--pipeline N] [--procs N] [--warm N]
#
#   --cpu         the server runs the plain version (--device cpu);
#                 without it the server decides on the card
#   --native      use the C++ epoll backends for HTTP and RESP
#   --pipeline N  RESP only: N commands per pipelined write
#   --procs N     client worker processes (single-proc Python tops out
#                 around ~50K pipelined resp/s)
#   --warm N      per-transport warmup requests before the timed run
#                 (the first window builds and loads the kernel)
#
# -t grpc and -t all need grpcio and protobuf: without them the driver
# stops before booting anything, naming the missing module.
set -euo pipefail

TRANSPORT=all
WORKERS=32
REQUESTS=1000
PIPELINE=1
PROCS=1
WARM=64
BACKEND=python
HTTP_PORT=58080
GRPC_PORT=58070
REDIS_PORT=58060
DEVICE=()

while [[ $# -gt 0 ]]; do
  case "$1" in
    -t) TRANSPORT="$2"; shift 2 ;;
    -T) WORKERS="$2"; shift 2 ;;
    -r) REQUESTS="$2"; shift 2 ;;
    --cpu) DEVICE=(--device cpu); shift ;;
    --native) BACKEND=native; shift ;;
    --pipeline) PIPELINE="$2"; shift 2 ;;
    --procs) PROCS="$2"; shift 2 ;;
    --warm) WARM="$2"; shift 2 ;;
    *) echo "unknown arg: $1" >&2; exit 2 ;;
  esac
done

SERVE=(--http --http-port "$HTTP_PORT" --http-backend "$BACKEND")
case "$TRANSPORT" in
  http) ;;
  redis) SERVE+=(--redis --redis-port "$REDIS_PORT"
                 --redis-backend "$BACKEND") ;;
  grpc|all)
    if ! python3 -c "import grpc, google.protobuf" 2>/dev/null; then
      echo "error: -t $TRANSPORT needs grpcio and protobuf, which this" \
           "python3 cannot import; install grpcio or pick -t http|redis" >&2
      exit 2
    fi
    SERVE+=(--grpc --grpc-port "$GRPC_PORT")
    if [[ "$TRANSPORT" == all ]]; then
      SERVE+=(--redis --redis-port "$REDIS_PORT" --redis-backend "$BACKEND")
    fi ;;
  *) echo "unknown transport: $TRANSPORT" >&2; exit 2 ;;
esac

cd "$(dirname "$0")/../.."

python3 -m throttlecrab_tpu_torch.server "${SERVE[@]}" "${DEVICE[@]}" \
    --store adaptive --log-level warn &
SERVER_PID=$!
trap 'kill "$SERVER_PID" 2>/dev/null || true' EXIT

# Wait for readiness via /health (two minutes at most).
python3 - "$HTTP_PORT" "$SERVER_PID" <<'PY'
import os, sys, time, urllib.request
port, pid = sys.argv[1], int(sys.argv[2])
for _ in range(240):
    try:
        urllib.request.urlopen(f"http://127.0.0.1:{port}/health", timeout=1)
        sys.exit(0)
    except OSError:
        try:
            os.kill(pid, 0)
        except OSError:
            sys.exit("the server exited before answering /health")
        time.sleep(0.5)
sys.exit("the server never answered /health")
PY

# Warmup: drive every selected transport through the first window (the
# kernel's build and load) so the timed run measures steady state.
if [[ "$WARM" -gt 0 ]]; then
  python3 -m throttlecrab_tpu_torch.harness perf-test \
      --transport "$TRANSPORT" \
      --port "$HTTP_PORT" --grpc-port "$GRPC_PORT" \
      --redis-port "$REDIS_PORT" \
      --workers 4 --requests "$WARM" --key-pattern zipfian \
      >/dev/null
fi

python3 -m throttlecrab_tpu_torch.harness perf-test \
    --transport "$TRANSPORT" \
    --port "$HTTP_PORT" --grpc-port "$GRPC_PORT" --redis-port "$REDIS_PORT" \
    --workers "$WORKERS" --requests "$REQUESTS" --key-pattern zipfian \
    --pipeline "$PIPELINE" --procs "$PROCS"

kill "$SERVER_PID" 2>/dev/null || true
wait "$SERVER_PID" 2>/dev/null || true
trap - EXIT
echo "done"
