"""Multi-device sharding of the GCRA bucket table.

The port of `throttlecrab_tpu/parallel/` (the mesh; the cluster and its
hash ring are not part of the port yet): the bucket table is split over
a mesh of devices, keys route to shards by a stable hash on the host,
and each shard's requests are decided by the same decision-window kernel
— one launch per shard per window, with the allowed/denied counters
summed over the shards.
"""

from .sharded import (
    ShardedBucketTable,
    ShardedTorchRateLimiter,
    make_mesh,
    shard_of_key,
)

__all__ = [
    "ShardedBucketTable",
    "ShardedTorchRateLimiter",
    "make_mesh",
    "shard_of_key",
]
