"""Multi-device sharding of the GCRA bucket table, and the cluster's ring.

The port of `throttlecrab_tpu/parallel/`: the bucket table is split over
a mesh of devices, keys route to shards by a stable hash on the host,
and each shard's requests are decided by the same decision-window kernel
— one launch per shard per window, with the allowed/denied counters
summed over the shards.  Across processes, the cluster tier
(`parallel/cluster.py`) gives every key one owner node on the weighted
consistent-hash ring (`HashRing`) and forwards remote keys over TCP.
"""

from .ring import HashRing
from .sharded import (
    ShardedBucketTable,
    ShardedTorchRateLimiter,
    make_mesh,
    shard_of_key,
)

__all__ = [
    "HashRing",
    "ShardedBucketTable",
    "ShardedTorchRateLimiter",
    "make_mesh",
    "shard_of_key",
]
