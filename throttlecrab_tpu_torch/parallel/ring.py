"""Weighted consistent-hash ring with virtual nodes: the routing core of
the elastic N-node cluster (parallel/cluster.py).

The port of `throttlecrab_tpu/parallel/ring.py`, line for line: the ring
is host numpy, and its points and owners are the JAX package's for the
same node list, weights and vnodes.

The legacy cluster routing (`node_of_key`: crc32 %% n_nodes) has the
classic modulo failure modes the scalable-rate-limiting survey
(arXiv:2602.11741) warns about: losing a node loses its key range
outright, and adding one silently remaps ~every key.  A consistent-hash
ring bounds both: each node projects ~``vnodes`` points onto a 32-bit
circle and a key belongs to the first point clockwise of its hash, so a
membership or weight change only moves the keys between the affected
points (~1/N of the space per node, fragmented evenly by the vnodes).

Design notes:

- **Hash.** Points and keys share one map: ``mix32(crc32(x))`` where
  ``mix32`` is the Fibonacci multiplicative scramble already used by
  ``node_of_key``.  CRC32 is linear, so without the scramble a node's
  vnode points (``addr#0``, ``addr#1``, ...) would be correlated and
  clump; the multiply decorrelates them and keeps the intra-node
  device-shard hash (plain ``crc32 %% D``) independent.
- **Vectorized lookup.** The batch routing path hashes every key with
  the tenants.crc32_rows table-driven numpy CRC (one pass over the
  stacked key matrix, same as the mesh's shard routing) and resolves
  owners with ONE ``np.searchsorted`` over the point array — no
  per-key Python in the hot path.  ``owner_of`` is the zlib per-key
  oracle the tests pin the vectorized form against.
- **Weights.** Each node carries a weight in [0, 1] scaling its vnode
  count; the supervisor announces 0.5 when a node's device dies (the
  host oracle serves at a fraction of device throughput) so its ring
  neighbours absorb the difference, and 1.0 again on re-promotion.
  Weight 0 removes a node's points entirely (it owns nothing) while
  keeping it a member.
- **Exclusion.** ``owners_of(..., exclude={d})`` answers "who would own
  this key if d were gone" — the warm-standby failover rule: when a
  peer's circuit breaker declares it dead, its keys route to exactly
  the node that warm-replication targeted.  Excluded rings are derived
  by masking points (no rehash), so failover routing of the surviving
  ranges is unchanged — only the dead node's keys move.

Rings are immutable; membership/weight changes build a new ring via
``with_weight``.  ``vnodes=0`` is not a ring — the cluster tier keeps
the legacy modulo path verbatim for that (kill switch).
"""

from __future__ import annotations

import zlib
from typing import Dict, FrozenSet, List, Optional, Sequence, Tuple

import numpy as np

from .tenants import crc32_rows, key_matrix

#: Fibonacci multiplicative scramble (same constant as node_of_key).
_MIX = 2654435761
_U32 = 0xFFFFFFFF

DEFAULT_VNODES = 128


def mix32(h: int) -> int:
    """Scramble a 32-bit hash (invertible, so no entropy loss)."""
    return (h * _MIX) & _U32


def key_point(key: bytes) -> int:
    """A key's position on the circle (per-key oracle form)."""
    return mix32(zlib.crc32(key))


def key_points(crcs: np.ndarray) -> np.ndarray:
    """Vectorized twin of key_point over raw crc32 values (u32[n])."""
    return ((crcs.astype(np.uint64) * _MIX) & _U32).astype(np.uint32)


def batch_crc32(kb: Sequence[bytes]) -> np.ndarray:
    """crc32 of every key in one vectorized pass (u32[n]).

    Falls back to per-key zlib when a key exceeds the routing-matrix
    bound (the matrix costs O(n x longest key); one huge key must not
    inflate the whole batch) — bit-identical either way.
    """
    try:
        mat, lens = key_matrix(kb)
        return crc32_rows(mat, lens)
    except Exception:
        return np.fromiter(
            (zlib.crc32(bytes(k)) & _U32 for k in kb),
            np.uint32,
            count=len(kb),
        )


class HashRing:
    """Immutable weighted vnode ring over a fixed node list.

    ``nodes`` is every node's address (the same list, in the same
    order, on every node — identical inputs build identical rings, so
    no ring state ever crosses the wire beyond the weight vector).
    """

    def __init__(
        self,
        nodes: Sequence[str],
        vnodes: int = DEFAULT_VNODES,
        weights: Optional[Dict[int, float]] = None,
    ) -> None:
        if vnodes <= 0:
            raise ValueError("HashRing needs vnodes > 0 (0 is the "
                             "legacy-modulo kill switch, no ring)")
        if not nodes:
            raise ValueError("HashRing needs at least one node")
        self.nodes = list(nodes)
        self.vnodes = int(vnodes)
        self.weights: Dict[int, float] = {
            i: 1.0 for i in range(len(self.nodes))
        }
        if weights:
            for i, w in weights.items():
                if not 0.0 <= w <= 1.0:
                    raise ValueError(f"node weight must be in [0,1]: {w}")
                self.weights[int(i)] = float(w)
        points: List[int] = []
        owners: List[int] = []
        for i, addr in enumerate(self.nodes):
            w = self.weights[i]
            n_pts = int(round(self.vnodes * w)) if w > 0 else 0
            if w > 0:
                n_pts = max(n_pts, 1)
            for v in range(n_pts):
                points.append(
                    mix32(zlib.crc32(f"{addr}#{v}".encode()))
                )
                owners.append(i)
        if not points:
            raise ValueError("ring has no points (all weights 0)")
        pts = np.asarray(points, np.uint32)
        own = np.asarray(owners, np.int32)
        # Ties (two nodes hashing a vnode to the same point) break by
        # node index — deterministic on every node.
        order = np.lexsort((own, pts))
        self._points = pts[order]
        self._owners = own[order]
        #: Masked-point view per excluded node set, built lazily.
        self._excl_cache: Dict[
            FrozenSet[int], Tuple[np.ndarray, np.ndarray]
        ] = {}

    # ------------------------------------------------------------------ #

    def _view(self, exclude: FrozenSet[int]):
        if not exclude:
            return self._points, self._owners
        view = self._excl_cache.get(exclude)
        if view is None:
            keep = ~np.isin(self._owners, list(exclude))
            if not keep.any():
                raise ValueError("every ring node excluded")
            view = (self._points[keep], self._owners[keep])
            # The cache is bounded by the number of distinct dead-sets
            # seen, which is bounded by 2^N for tiny N — but clamp it
            # anyway so a flapping large cluster cannot grow it.
            if len(self._excl_cache) > 64:
                self._excl_cache.clear()
            self._excl_cache[exclude] = view
        return view

    def owners_of(
        self,
        crcs: np.ndarray,
        exclude: FrozenSet[int] = frozenset(),
    ) -> np.ndarray:
        """Owner index per key, from raw crc32 hashes (u32[n]) — one
        searchsorted, no per-key Python."""
        points, owners = self._view(exclude)
        h = key_points(np.asarray(crcs, np.uint32))
        idx = np.searchsorted(points, h, side="left")
        idx[idx == len(points)] = 0  # wrap: first point owns the tail
        return owners[idx]

    def owner_of(
        self, key: bytes, exclude: FrozenSet[int] = frozenset()
    ) -> int:
        """Per-key oracle (zlib crc32 + scalar search) — the form tests
        pin owners_of against."""
        points, owners = self._view(exclude)
        h = key_point(bytes(key))
        idx = int(np.searchsorted(points, np.uint32(h), side="left"))
        if idx == len(points):
            idx = 0
        return int(owners[idx])

    def successor_of(self, key: bytes, owner: int) -> int:
        """Who takes over `key` when `owner` dies — the warm-standby
        replication target."""
        return self.owner_of(key, exclude=frozenset((owner,)))

    def with_weight(self, node: int, weight: float) -> "HashRing":
        w = dict(self.weights)
        w[int(node)] = float(weight)
        return HashRing(self.nodes, self.vnodes, weights=w)

    def weight_vector(self) -> List[float]:
        return [self.weights[i] for i in range(len(self.nodes))]

    def __len__(self) -> int:
        return len(self._points)

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return (
            f"HashRing(nodes={len(self.nodes)}, vnodes={self.vnodes}, "
            f"points={len(self._points)}, weights={self.weight_vector()})"
        )
