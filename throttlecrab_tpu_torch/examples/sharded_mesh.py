"""Mesh-sharded engine: key-shard data parallelism over every card.

The port's counterpart of the JAX package's `examples/sharded_mesh.py`:
`ShardedTorchRateLimiter` over `make_mesh()`, one shard per visible card
(`--cpu`: one shard on the host, the plain version).  The global counters
sum every shard's.

    python -m throttlecrab_tpu_torch.examples.sharded_mesh [--cpu]
"""

import argparse
import sys
import time

from ..parallel import ShardedTorchRateLimiter
from ..parallel.sharded import make_mesh


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args(argv)
    mesh = make_mesh(device="cpu" if args.cpu else "cuda")  # every device
    print(f"mesh: {mesh.n_shards} shard(s) on "
          f"{sorted({str(d) for d in mesh.devices})}")
    limiter = ShardedTorchRateLimiter(capacity_per_shard=1 << 14, mesh=mesh)
    now = time.time_ns()

    keys = [f"user:{i}" for i in range(8192)]
    result = limiter.rate_limit_batch(
        keys, max_burst=10, count_per_period=100, period=60,
        quantity=1, now_ns=now,
    )
    print(f"{int(result.allowed.sum())}/{len(keys)} allowed")
    print(f"global allowed={limiter.total_allowed} "
          f"denied={limiter.total_denied}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
