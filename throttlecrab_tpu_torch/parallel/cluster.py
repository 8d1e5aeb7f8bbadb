"""Cross-process / cross-host key sharding: the multi-node cluster tier.

The port of `throttlecrab_tpu/parallel/cluster.py`: host code over TCP,
frame for frame the JAX package's wire protocol, so a node of either
package serves in one cluster with the other's.  A node's work reaches
its card only through its local limiter (the decision-window kernel),
`tpu/snapshot.py`'s `export_state` (the `row_gather` kernel: join,
reweight, rejoin and leave exports, the migrate reconcile) and
`_bulk_insert` (the `row_scatter` kernel: migrate and takeover absorbs).

The reference's only horizontal-scaling answer is "shard keys across
instances client-side" (`README.md:247-249`).  Here the server does it:

- **Within a node** (one process): the mesh-sharded limiter
  (parallel/sharded.py) splits the bucket table over devices.
- **Across nodes** (processes/hosts/slices): every key has exactly one
  owner node — assigned by the weighted consistent-hash ring
  (parallel/ring.py; ``vnodes=0`` keeps the legacy crc32-modulo
  ``node_of_key`` bit-identically) — and a node receiving a request for
  a remote key forwards it, whole batches at a time, never request by
  request, over a persistent length-prefixed TCP connection (the DCN
  path), merging the replies back into arrival order.

One key therefore lives in exactly one device shard of exactly one node:
limits hold globally without any cross-node consensus — the ring is a
pure function of the static node list plus the broadcast weight vector.

Ring mode adds the elastic membership lifecycle (see the
ClusterLimiter docstring and ARCHITECTURE.md "Multi-node"): OP_JOIN
announcements with atomic export-then-flip OP_MIGRATE key-range
handoffs (join/rejoin), warm-standby OP_REPLICA deltas to each key's
ring successor with breaker-driven failover takeover (fail), and
OP_RING weight broadcasts when the supervisor degrades a node's
capacity.

The owner decides with the *frontend's* batch timestamp: GCRA tolerates
cross-clock skew by construction (TAT is clamped against each request's
`now`, rate_limiter.rs:158-166), and carrying the timestamp keeps
decisions reproducible under virtual time in tests.

Wire format (little-endian, one frame per message; ops 1/2 are the
frozen legacy pair, the rest are ring-mode only):

  batch (1):    u32 body_len | u8 op | u32 n | i64 now_ns |
                n x { u16 key_len | key bytes | i64 burst | i64 count |
                      i64 period | i64 quantity }
  reply (2):    u32 body_len | u8 op | u32 n |
                n x { u8 status | u8 allowed | i64 limit | i64 remaining |
                      i64 reset_ns | i64 retry_ns }
  route (10):   u8 hops | <batch body>          -> reply (2)
  migrate (3),
  replica (9):  u8 origin | u32 epoch | u32 n | n x u16 key_len |
                key blob | n x i64 tat | n x i64 expiry   (no reply)
  ring (5),
  ring_state (8): u32 epoch | u8 n | n x u16 milliweight  (no reply)
  join (7):     u8 origin                        -> ring_state (8)
  leave (11):   u8 origin | u32 epoch             (no reply)
  droute (12):  u8 hops | u32 n | n x i64 budget_ns | <batch body>
                                                 -> reply (2)

Failure isolation: in legacy mode a dead peer fails only the requests
routed to it (STATUS_INTERNAL per request); in ring mode those requests
fail over to the dead peer's ring successors, which serve them from the
warm replica — local keys keep deciding either way.
"""

from __future__ import annotations

import asyncio
import logging
import socket
import struct
import threading
import zlib
from typing import List, Optional, Sequence, Tuple

import numpy as np

from ..faults import maybe_fail, send_with_faults
from ..tpu.limiter import (
    BatchResult,
    _ReadyLaunch,
    STATUS_DEADLINE,
    STATUS_INTERNAL,
    STATUS_INVALID_PARAMS,
    ScalarCompatMixin,
    WireBatchResult,
    limiter_uses_bytes_keys,
)

log = logging.getLogger("throttlecrab.cluster")

NS_PER_SEC = 1_000_000_000
I32_MAX = (1 << 31) - 1

OP_THROTTLE_BATCH = 1
OP_THROTTLE_REPLY = 2
# Elastic-cluster ops (ring mode only; legacy modulo mode never emits
# them).  MIGRATE/REPLICA/RING are fire-and-forget (no reply frame), so
# they can interleave with a pipelined request/reply cycle without
# stealing its reply; JOIN expects an OP_RING_STATE reply and
# ROUTE_BATCH an OP_THROTTLE_REPLY.
OP_MIGRATE = 3        # key-range handoff rows (join/reweight/rejoin)
OP_RING = 5           # weight-vector broadcast after a reweight
OP_JOIN = 7           # membership (re-)announcement -> OP_RING_STATE
OP_RING_STATE = 8     # reply to OP_JOIN: epoch + weight vector
OP_REPLICA = 9        # warm-standby async state deltas (best-effort)
OP_ROUTE_BATCH = 10   # ownership-checked batch (hop-counted)
OP_LEAVE = 11         # planned departure announcement (no reply)
OP_DROUTE_BATCH = 12  # route batch carrying per-row deadline budgets

#: Forward-chain bound for OP_ROUTE_BATCH: membership skew is resolved
#: by each receiver re-checking ownership and forwarding onward; at the
#: bound the receiver decides locally (loudly) instead of looping.
MAX_HOPS = 3

_HDR = struct.Struct("<IB")          # body_len (after header), op
_REQ_HEAD = struct.Struct("<Iq")     # n, now_ns
_REQ_ITEM = struct.Struct("<qqqq")   # burst, count, period, quantity
_REP_HEAD = struct.Struct("<I")      # n
_ROWS_HEAD = struct.Struct("<BII")   # origin, epoch, n (migrate/replica)
_ROW_STATE = struct.Struct("<qq")    # tat_ns, expiry_ns
_RING_HEAD = struct.Struct("<IB")    # epoch, n_nodes (then u16 milliweights)
_JOIN_BODY = struct.Struct("<B")     # origin index
_ROUTE_HEAD = struct.Struct("<B")    # hops (then the OP_THROTTLE_BATCH body)
_LEAVE_BODY = struct.Struct("<BI")   # origin index, epoch
_DROUTE_HEAD = struct.Struct("<BI")  # hops, n (then n x i64 budgets + body)
# Reply items as a numpy structured dtype: fixed-stride, so whole batches
# encode/decode in one vectorized call instead of per-item struct loops.
_REP_DTYPE = np.dtype(
    [
        ("status", "<u1"), ("allowed", "<u1"), ("limit", "<i8"),
        ("remaining", "<i8"), ("reset_ns", "<i8"), ("retry_ns", "<i8"),
    ]
)

MAX_FRAME = 64 << 20  # hardening cap, same spirit as the RESP limits
MAX_KEY_BYTES = 0xFFFF  # u16 key_len on the wire


class ClusterProtocolError(ConnectionError):
    """Malformed or inconsistent peer frame."""




def node_of_key(key: bytes, n_nodes: int) -> int:
    """Stable key→node routing, decorrelated from the intra-node
    device-shard hash (shard_of_key = crc32 % D).

    CRC32 is linear, so a salted prefix would leave the low bits
    correlated with the unsalted CRC and funnel a node's keys onto few
    local shards; a Fibonacci (multiplicative) bit-mix of the same CRC
    scrambles the bits the modulus sees."""
    h = (zlib.crc32(key) * 2654435761) & 0xFFFFFFFF
    return (h >> 7) % n_nodes


def _batch_body(keys: Sequence[bytes], params, now_ns: int) -> bytes:
    parts = [_REQ_HEAD.pack(len(keys), now_ns)]
    for k, (b, c, p, q) in zip(keys, params):
        parts.append(struct.pack("<H", len(k)))
        parts.append(k)
        parts.append(_REQ_ITEM.pack(int(b), int(c), int(p), int(q)))
    return b"".join(parts)


def encode_batch(keys: Sequence[bytes], params, now_ns: int) -> bytes:
    """params: iterable of (burst, count, period, quantity) per key."""
    body = _batch_body(keys, params, now_ns)
    return _HDR.pack(len(body), OP_THROTTLE_BATCH) + body


def encode_route(
    keys: Sequence[bytes], params, now_ns: int, hops: int
) -> bytes:
    """The ring-mode batch frame: a hop counter ahead of the classic
    batch body, so receivers can re-check ownership and forward onward
    without unbounded loops under membership skew."""
    body = _ROUTE_HEAD.pack(hops) + _batch_body(keys, params, now_ns)
    return _HDR.pack(len(body), OP_ROUTE_BATCH) + body


def decode_route(body: bytes):
    """-> (hops, keys, params, now_ns); bounds-checked like decode_batch."""
    if len(body) < _ROUTE_HEAD.size:
        raise ClusterProtocolError("short route frame")
    (hops,) = _ROUTE_HEAD.unpack_from(body, 0)
    keys, params, now_ns = decode_batch(body[_ROUTE_HEAD.size:])
    return hops, keys, params, now_ns


def decode_batch(body: bytes):
    """-> (keys, params [n,4] i64, now_ns).

    The count and every length are validated against the actual body size
    before any allocation — the RPC port is reachable by anything on the
    network, so an attacker-controlled n must not size a buffer."""
    if len(body) < _REQ_HEAD.size:
        raise ClusterProtocolError("short batch frame")
    n, now_ns = _REQ_HEAD.unpack_from(body, 0)
    min_item = 2 + _REQ_ITEM.size
    if n > (len(body) - _REQ_HEAD.size) // min_item:
        raise ClusterProtocolError(f"batch count {n} exceeds frame size")
    off = _REQ_HEAD.size
    keys: List[bytes] = []
    params = np.empty((n, 4), np.int64)
    for i in range(n):
        if off + 2 > len(body):
            raise ClusterProtocolError("batch item exceeds frame")
        (klen,) = struct.unpack_from("<H", body, off)
        off += 2
        if off + klen + _REQ_ITEM.size > len(body):
            raise ClusterProtocolError("batch item exceeds frame")
        keys.append(body[off : off + klen])
        off += klen
        params[i] = _REQ_ITEM.unpack_from(body, off)
        off += _REQ_ITEM.size
    if off != len(body):
        raise ClusterProtocolError("trailing bytes after batch items")
    return keys, params, now_ns


def encode_reply(status, allowed, limit, remaining, reset_ns, retry_ns):
    n = len(status)
    rows = np.empty(n, _REP_DTYPE)
    rows["status"] = status
    rows["allowed"] = np.asarray(allowed, bool)
    rows["limit"] = limit
    rows["remaining"] = remaining
    rows["reset_ns"] = reset_ns
    rows["retry_ns"] = retry_ns
    body = _REP_HEAD.pack(n) + rows.tobytes()
    return _HDR.pack(len(body), OP_THROTTLE_REPLY) + body


def decode_reply(body: bytes):
    """-> structured array with status/allowed/limit/remaining/reset_ns/
    retry_ns columns; count validated against the frame size."""
    if len(body) < _REP_HEAD.size:
        raise ClusterProtocolError("short reply frame")
    (n,) = _REP_HEAD.unpack_from(body, 0)
    if n * _REP_DTYPE.itemsize != len(body) - _REP_HEAD.size:
        raise ClusterProtocolError("reply count mismatches frame size")
    return np.frombuffer(body, _REP_DTYPE, count=n, offset=_REP_HEAD.size)


def encode_rows(
    op: int, origin: int, epoch: int, keys: Sequence[bytes], tats, exps
) -> bytes:
    """OP_MIGRATE / OP_REPLICA row frames, columnar so whole batches
    encode/decode in a handful of vectorized numpy calls (replication
    rides every serving window — a per-row Python loop here measurably
    taxes the decide path on small hosts):

      origin u8 | epoch u32 | n u32 |
      n x u16 key_len | key blob | n x i64 tat | n x i64 expiry

    The (tat, expiry) pairs are exactly what snapshot ``export_state``
    yields and ``_bulk_insert`` consumes."""
    lens = np.fromiter(map(len, keys), np.uint16, count=len(keys))
    body = b"".join((
        _ROWS_HEAD.pack(origin, epoch, len(keys)),
        lens.astype("<u2").tobytes(),
        b"".join(keys),
        np.asarray(tats, np.int64).astype("<i8").tobytes(),
        np.asarray(exps, np.int64).astype("<i8").tobytes(),
    ))
    return _HDR.pack(len(body), op) + body


def decode_rows(body: bytes):
    """-> (origin, epoch, keys, tat i64[n], expiry i64[n]).

    Same hardening contract as decode_batch: the count and every length
    are validated against the actual body size before any allocation,
    truncation raises the typed ClusterProtocolError, and trailing
    garbage is rejected (a desynced stream must not half-apply)."""
    if len(body) < _ROWS_HEAD.size:
        raise ClusterProtocolError("short rows frame")
    origin, epoch, n = _ROWS_HEAD.unpack_from(body, 0)
    fixed = 2 + _ROW_STATE.size  # per-row: u16 len + (tat, expiry) i64s
    if n > (len(body) - _ROWS_HEAD.size) // max(fixed, 1):
        raise ClusterProtocolError(f"rows count {n} exceeds frame size")
    off = _ROWS_HEAD.size
    lens = np.frombuffer(body, "<u2", count=n, offset=off).astype(
        np.int64
    )
    off += 2 * n
    blob_len = int(lens.sum())
    if off + blob_len + 2 * 8 * n != len(body):
        raise ClusterProtocolError("rows frame size mismatches lengths")
    ends = np.cumsum(lens) + off
    starts = ends - lens
    keys = [
        body[int(s) : int(e)] for s, e in zip(starts, ends)
    ]
    off += blob_len
    tats = np.frombuffer(body, "<i8", count=n, offset=off).astype(
        np.int64
    )
    off += 8 * n
    exps = np.frombuffer(body, "<i8", count=n, offset=off).astype(
        np.int64
    )
    return origin, epoch, keys, tats, exps


def encode_ring(op: int, epoch: int, weights: Sequence[float]) -> bytes:
    """OP_RING / OP_RING_STATE: epoch + the full weight vector (u16
    milli-units), so adoption is stateless — identical inputs rebuild
    identical rings on every node."""
    body = _RING_HEAD.pack(epoch, len(weights)) + b"".join(
        struct.pack("<H", max(0, min(1000, int(round(w * 1000)))))
        for w in weights
    )
    return _HDR.pack(len(body), op) + body


def decode_ring(body: bytes):
    """-> (epoch, weights list[float]); bounds-checked."""
    if len(body) < _RING_HEAD.size:
        raise ClusterProtocolError("short ring frame")
    epoch, n = _RING_HEAD.unpack_from(body, 0)
    if len(body) != _RING_HEAD.size + 2 * n:
        raise ClusterProtocolError("ring frame size mismatches count")
    weights = [
        struct.unpack_from("<H", body, _RING_HEAD.size + 2 * i)[0] / 1000.0
        for i in range(n)
    ]
    return epoch, weights


def encode_join(origin: int) -> bytes:
    body = _JOIN_BODY.pack(origin)
    return _HDR.pack(len(body), OP_JOIN) + body


def decode_join(body: bytes) -> int:
    if len(body) != _JOIN_BODY.size:
        raise ClusterProtocolError("bad join frame size")
    return _JOIN_BODY.unpack(body)[0]


def encode_leave(origin: int, epoch: int) -> bytes:
    body = _LEAVE_BODY.pack(origin, epoch)
    return _HDR.pack(len(body), OP_LEAVE) + body


def decode_leave(body: bytes) -> Tuple[int, int]:
    if len(body) != _LEAVE_BODY.size:
        raise ClusterProtocolError("bad leave frame size")
    return _LEAVE_BODY.unpack(body)


def encode_droute(
    keys: Sequence[bytes], params, now_ns: int, hops: int, budgets_ns
) -> bytes:
    """OP_ROUTE_BATCH plus a per-row deadline column: the remaining
    client budget in ns at send time (0 = no deadline).  Emitted ONLY
    when some row actually carries a deadline — batches without one
    stay on the classic route op, byte-identical to before."""
    body = (
        _DROUTE_HEAD.pack(hops, len(keys))
        + np.asarray(budgets_ns, np.int64).astype("<i8").tobytes()
        + _batch_body(keys, params, now_ns)
    )
    return _HDR.pack(len(body), OP_DROUTE_BATCH) + body


def decode_droute(body: bytes):
    """-> (hops, keys, params, now_ns, budgets_ns i64[n]);
    bounds-checked like decode_batch."""
    if len(body) < _DROUTE_HEAD.size:
        raise ClusterProtocolError("short droute frame")
    hops, n = _DROUTE_HEAD.unpack_from(body, 0)
    if n > (len(body) - _DROUTE_HEAD.size) // 8:
        raise ClusterProtocolError(f"droute count {n} exceeds frame size")
    off = _DROUTE_HEAD.size
    budgets = np.frombuffer(body, "<i8", count=n, offset=off).astype(
        np.int64
    )
    keys, params, now_ns = decode_batch(body[off + 8 * n :])
    if len(keys) != n:
        raise ClusterProtocolError("droute count mismatches batch")
    return hops, keys, params, now_ns, budgets


#: op -> (frame-kind name, decoder): the wire protocol's single source
#: of truth, as in the JAX package.
FRAME_DECODERS = {
    OP_THROTTLE_BATCH: ("batch", decode_batch),
    OP_THROTTLE_REPLY: ("reply", decode_reply),
    OP_MIGRATE: ("migrate", decode_rows),
    OP_RING: ("ring", decode_ring),
    OP_JOIN: ("join", decode_join),
    OP_RING_STATE: ("ring-state", decode_ring),
    OP_REPLICA: ("replica", decode_rows),
    OP_ROUTE_BATCH: ("route", decode_route),
    OP_LEAVE: ("leave", decode_leave),
    OP_DROUTE_BATCH: ("droute", decode_droute),
}


class PeerUnavailable(ConnectionError):
    """Raised without touching the network: the peer's circuit is open or
    its reconnect backoff has not elapsed.  A hung or flapping peer must
    cost the batch path ~nothing — only its own keys fail."""


class PeerConnection:
    """One persistent blocking TCP connection to a peer node.

    Used from the engine's executor thread (decisions are already off the
    event loop); a lock serializes request/reply cycles.  Frames can be
    pipelined: send_frame() N times, then recv_frame() N times in order.

    Failure containment (a hung peer would otherwise stall
    every batch for IO_TIMEOUT_S=30 s):

    - `io_timeout_s` is a serving-grade per-operation deadline (default
      1 s — it must cover the owner's full remote decision including a
      device launch): an accepted-but-silent peer fails its
      requests within the deadline instead of wedging the pipeline.
    - after a failure, reconnect attempts back off exponentially
      (BACKOFF_MIN_S → BACKOFF_MAX_S); attempts inside the backoff window
      raise PeerUnavailable immediately, without touching the network.
    - BREAKER_FAILURES consecutive failures open a circuit breaker for
      BREAKER_COOLDOWN_S: the peer is assumed down and its keys fail
      instantly until one probe attempt is allowed through.
    """

    CONNECT_TIMEOUT_S = 1.0
    IO_TIMEOUT_S = 1.0
    BACKOFF_MIN_S = 0.05
    BACKOFF_MAX_S = 2.0
    BREAKER_FAILURES = 3
    BREAKER_COOLDOWN_S = 1.0

    def __init__(
        self,
        host: str,
        port: int,
        io_timeout_s: Optional[float] = None,
        connect_timeout_s: Optional[float] = None,
        breaker_failures: Optional[int] = None,
        breaker_cooldown_s: Optional[float] = None,
        clock=None,
    ) -> None:
        import time

        self.host = host
        self.port = port
        self.io_timeout_s = (
            self.IO_TIMEOUT_S if io_timeout_s is None else io_timeout_s
        )
        self.connect_timeout_s = (
            self.CONNECT_TIMEOUT_S
            if connect_timeout_s is None
            else connect_timeout_s
        )
        self.breaker_failures = (
            self.BREAKER_FAILURES
            if breaker_failures is None
            else breaker_failures
        )
        self.breaker_cooldown_s = (
            self.BREAKER_COOLDOWN_S
            if breaker_cooldown_s is None
            else breaker_cooldown_s
        )
        self._clock = clock or time.monotonic
        self.lock = threading.Lock()
        #: Outer lock held across a whole request->reply cycle (ring
        #: mode), so a concurrent forwarder on another thread cannot
        #: interleave its own request and steal this cycle's reply.
        #: Fire-and-forget sends (replica/migrate/ring) need only the
        #: inner `lock` — a frame injected between a request and its
        #: reply is harmless because the server replies in op order.
        self.request_lock = threading.Lock()
        self._sock: Optional[socket.socket] = None
        self._consecutive_failures = 0
        self._retry_at = 0.0  # monotonic deadline gating the next attempt
        # Diagnostics / metrics (read under self.lock or approximately).
        self.forwarded = 0
        self.failed = 0
        self.migrated = 0  # keys handed off to this peer (OP_MIGRATE)

    def _check_gate(self) -> None:
        if self._sock is None and self._clock() < self._retry_at:
            state = (
                "circuit open"
                if self._consecutive_failures >= self.breaker_failures
                else "reconnect backoff"
            )
            raise PeerUnavailable(
                f"peer {self.host}:{self.port} unavailable ({state}, "
                f"{self._consecutive_failures} consecutive failures)"
            )

    def _connect(self) -> socket.socket:
        if self._sock is None:
            self._check_gate()
            s = socket.create_connection(
                (self.host, self.port), self.connect_timeout_s
            )
            s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            s.settimeout(self.io_timeout_s)
            self._sock = s
        return self._sock

    @property
    def breaker_open(self) -> bool:
        """The peer is declared dead: enough consecutive failures to
        open the circuit.  Ring-mode routing consults this to fail over
        a dead node's range onto its ring successor; the flag clears on
        any success or an explicit heal() (a peer re-announcing itself
        via OP_JOIN)."""
        return self._consecutive_failures >= self.breaker_failures

    def heal(self) -> None:
        """Clear the breaker/backoff without a round trip — called when
        the peer proves itself alive out-of-band (its OP_JOIN arrived).
        Deliberately NOT record_success(): no batch was forwarded, so
        the forwarded counter must not move."""
        self._consecutive_failures = 0
        self._retry_at = 0.0

    def record_success(self) -> None:
        self._consecutive_failures = 0
        self._retry_at = 0.0
        self.forwarded += 1

    def record_failure(self) -> None:
        """Close the connection and arm the backoff / circuit breaker."""
        self.failed += 1
        self._consecutive_failures += 1
        if self._consecutive_failures >= self.breaker_failures:
            delay = self.breaker_cooldown_s
        else:
            delay = min(
                self.BACKOFF_MIN_S
                * (2 ** (self._consecutive_failures - 1)),
                self.BACKOFF_MAX_S,
            )
        self._retry_at = self._clock() + delay
        self.close()

    def close(self) -> None:
        if self._sock is not None:
            try:
                self._sock.close()
            finally:
                self._sock = None

    def send_frame(self, frame: bytes) -> None:
        # Routed through the sender chokepoint so a `partial` fault can
        # truncate the frame on the wire, not just raise cleanly.
        send_with_faults("peer", self._connect(), frame)

    def recv_frame(self) -> Tuple[int, bytes]:
        maybe_fail("peer")
        s = self._connect()
        head = self._recv_exact(s, _HDR.size)
        body_len, op = _HDR.unpack(head)
        if body_len > MAX_FRAME:
            raise ConnectionError(f"oversized cluster frame: {body_len}")
        return op, self._recv_exact(s, body_len)

    @staticmethod
    def _recv_exact(s: socket.socket, n: int) -> bytes:
        buf = b""
        while len(buf) < n:
            chunk = s.recv(n - len(buf))
            if not chunk:
                raise ConnectionError("peer closed mid-frame")
            buf += chunk
        return buf


def _note_peer_error(peer: PeerConnection, exc: BaseException) -> None:
    """Failure bookkeeping that distinguishes a *gate rejection* from a
    real network failure: PeerUnavailable means the reconnect backoff /
    breaker gate refused the attempt without touching the network —
    counting it via record_failure would escalate the breaker on a
    healthy peer and push the retry deadline forever outward (the
    legacy send path has always special-cased this)."""
    with peer.lock:
        if isinstance(exc, PeerUnavailable):
            peer.failed += 1
        else:
            peer.record_failure()


class ClusterLimiter(ScalarCompatMixin):
    """Routes batches between the local limiter and owner peers.

    Duck-types the limiter interface the engine expects
    (rate_limit_batch / rate_limit_many / sweep / __len__), so the whole
    serving stack — transports, metrics, batching — is cluster-transparent.

    Two routing modes:

    - **legacy modulo** (``vnodes=0``, the kill switch): the original
      static ``node_of_key`` crc32-modulo ownership, bit-identical to
      the pre-ring cluster tier.  A dead peer fails its own key range
      (STATUS_INTERNAL) and nothing else.
    - **ring** (``vnodes>0``): a weighted consistent-hash ring
      (parallel/ring.py) plus the elastic lifecycle — **join** (a
      (re)starting node announces OP_JOIN; each peer atomically exports
      the announced node's key range from its own table and streams it
      back as OP_MIGRATE rows before flipping its routing, while the
      joiner gates local decisions on a handoff window so no key is
      ever decided in two places), **fail** (warm-standby OP_REPLICA
      deltas flow to each key's ring successor; when a peer's circuit
      breaker opens, its range routes to exactly those successors, who
      absorb the replica rows and keep serving — GCRA's clamp-against-
      now makes a slightly-stale replica TAT safe by construction, see
      ARCHITECTURE.md for the staleness bound), and **rejoin** (the
      same OP_JOIN path: the successors migrate the absorbed, freshest
      state back, overwriting the returning node's stale rows).
      A node whose device degrades announces a reduced ring weight
      (OP_RING) and migrates the lost vnode ranges out, so a host-
      oracle node serves a proportionally smaller range instead of
      device-scale traffic.  **leave** (the drain path) runs join in
      reverse: OP_LEAVE announces the departure, the whole local table
      streams out as OP_MIGRATE rows, and the node serves on as a
      lame-duck forwarder until shutdown — a planned exit loses zero
      decisions and zero replica freshness (see ARCHITECTURE.md
      "Lifecycle").
    """

    def __init__(
        self,
        local,
        nodes: Sequence[str],
        self_index: int,
        io_timeout_s: Optional[float] = None,
        connect_timeout_s: Optional[float] = None,
        breaker_failures: Optional[int] = None,
        breaker_cooldown_s: Optional[float] = None,
        vnodes: int = 0,
        replicate: bool = False,
        handoff_timeout_s: float = 5.0,
        replica_cap: int = 100_000,
        clock=None,
    ) -> None:
        """`nodes` lists every node's cluster RPC address host:port (the
        same list, in the same order, on every node); `self_index` is this
        node's position in it.  The timeout/breaker knobs configure each
        PeerConnection's failure containment (see its docstring).
        `vnodes` > 0 arms the consistent-hash ring (vnodes per node at
        weight 1.0); 0 keeps the legacy modulo routing.  `replicate`
        arms warm-standby replication to ring successors (ring mode
        only).  For per-peer observability, point the server's Metrics
        at `peer_stats` via set_cluster_stats_provider (run_server
        does).  `clock` (monotonic seconds, default time.monotonic)
        drives the handoff-deadline gate — tests inject a virtual clock
        so the gate cannot expire spuriously under load."""
        import time

        if not 0 <= self_index < len(nodes):
            raise ValueError("self_index out of range")
        self._clock = clock or time.monotonic
        self.local = local
        self.nodes = list(nodes)
        self.self_index = self_index
        # Serializes access to the local device.  Held ONLY around local
        # decides/sweeps, never across a peer RPC — holding a lock the
        # ClusterServer also needs while waiting on a peer whose engine is
        # symmetrically waiting on us would deadlock both nodes (each
        # node's reply production must stay independent of its own
        # outbound forwards).
        self.device_lock = threading.Lock()
        self._bytes_keys = limiter_uses_bytes_keys(local)
        self.peers: List[Optional[PeerConnection]] = []
        for i, addr in enumerate(self.nodes):
            if i == self_index:
                self.peers.append(None)
            else:
                host, _, port = addr.rpartition(":")
                self.peers.append(
                    PeerConnection(
                        host,
                        int(port),
                        io_timeout_s=io_timeout_s,
                        connect_timeout_s=connect_timeout_s,
                        breaker_failures=breaker_failures,
                        breaker_cooldown_s=breaker_cooldown_s,
                    )
                )
        # ---- elastic ring state (vnodes > 0) -------------------------- #
        self.ring = None
        if vnodes > 0:
            from .ring import HashRing

            self.ring = HashRing(self.nodes, vnodes)
        self.replicate = bool(
            replicate and self.ring is not None and len(self.nodes) > 1
        )
        self.handoff_timeout_s = float(handoff_timeout_s)
        self.replica_cap = int(replica_cap)
        self.epoch = 0
        self._mu = threading.Lock()  # ring/epoch/membership state
        self._handoff_cv = threading.Condition(self._mu)
        #: origin index -> monotonic deadline: ranges this node gained
        #: whose OP_MIGRATE has not arrived yet (decisions gate on it).
        self._pending_from: dict = {}
        #: origins whose migrate already landed this membership round
        #: (clears the announce/migrate arrival race).
        self._handoff_done: set = set()
        #: dead peers whose replica rows were absorbed into the local
        #: table (takeover ran); cleared when the peer rejoins.
        self._absorbed: set = set()
        self._takeover_lock = threading.Lock()
        #: Warm-standby rows replicated TO this node: key bytes ->
        #: (tat_ns, expiry_ns), insertion-ordered so overflow drops the
        #: coldest entry (re-replication refreshes recency).
        self.replica_store: dict = {}
        self._replica_mu = threading.Lock()
        # ---- planned-leave lifecycle (ring mode) ---------------------- #
        #: Lame duck: this node announced OP_LEAVE — its ring weight is
        #: 0 (every key forwards; nothing decides locally), replication
        #: and reweight broadcasts stop, and the pump's heal probes are
        #: inert.  Set under _mu, read lock-free on hot paths (benign:
        #: the ring flip it rides is what actually reroutes keys).
        self._lame_duck = False
        #: Peers that announced OP_LEAVE: weight pinned to 0 against
        #: stale ring echoes, heal probes skip them.  A later OP_JOIN
        #: re-registers the node.  Guarded by _mu.
        self._departed: set = set()
        #: Set once this node's own leave handoff is fully streamed —
        #: lame-duck forwards park on it so no forward can overtake the
        #: OP_LEAVE/OP_MIGRATE frames on a peer connection.
        self._leave_complete = threading.Event()
        # Diagnostics (peer_stats / cluster_view / metrics).
        self.migrated_in = 0
        #: Inbound migrate rows dropped because the local row (e.g. a
        #: crash-rejoin's checkpoint restore) was at least as new.
        self.reconciled_stale = 0
        self.takeover_count = 0
        self.replica_drops = 0
        self.handoff_timeouts = 0
        self.leave_count = 0  # OP_LEAVE events seen (ours + peers')
        #: Monotonic deadline while weight announcements keep
        #: re-broadcasting (covers a lost OP_RING around EITHER
        #: transition — reduce or restore — and a restart whose peers
        #: still hold our old degraded weight).
        self._reweight_heal_until = 0.0
        #: Flight-recorder capture of client-visible decisions at THIS
        #: frontend (replay/).  Off by default: when an engine drives
        #: this limiter the engine's own per-batch hook records, and a
        #: second hook here would double-capture every window.  Library
        #: users (the in-process chaos/replay harnesses) set it to True
        #: to capture at the cluster frontend instead.
        self.capture = False
        self._pump = None
        if self.ring is not None and len(self.nodes) > 1:
            self._pump = _ClusterPump(self)
            self._pump.start()

    def peer_stats(self) -> dict:
        """Per-peer forwarding/breaker/migration counters for /stats and
        the throttlecrab_cluster_* metrics."""
        return {
            self.nodes[i]: {
                "forwarded": peer.forwarded,
                "failed": peer.failed,
                "breaker_open": int(peer.breaker_open),
                "migrated_keys": peer.migrated,
            }
            for i, peer in enumerate(self.peers)
            if peer is not None
        }

    def cluster_view(self) -> dict:
        """The /health cluster view: membership, epoch, handoff and
        replica state — what an operator needs to see mid-join or
        mid-failover."""
        with self._mu:
            pending = sorted(self.nodes[d] for d in self._pending_from)
            absorbed = sorted(self.nodes[d] for d in self._absorbed)
            departed = sorted(self.nodes[d] for d in self._departed)
            lame_duck = self._lame_duck
            weights = (
                self.ring.weight_vector() if self.ring is not None else []
            )
            epoch = self.epoch
        with self._replica_mu:
            replica_rows = len(self.replica_store)
        return {
            "mode": "ring" if self.ring is not None else "modulo",
            "self": self.nodes[self.self_index],
            "epoch": epoch,
            "vnodes": self.ring.vnodes if self.ring is not None else 0,
            "weights": weights,
            "replicate": self.replicate,
            "replica_rows": replica_rows,
            "replica_drops": self.replica_drops,
            "takeovers": self.takeover_count,
            "migrated_in": self.migrated_in,
            "reconciled_stale": self.reconciled_stale,
            "handoff_timeouts": self.handoff_timeouts,
            "leaves": self.leave_count,
            "lame_duck": lame_duck,
            "departed": departed,
            "pending_handoffs": pending,
            "absorbed": absorbed,
            "peers": self.peer_stats(),
        }

    # ------------------------------------------------------------------ #

    @staticmethod
    def _key_bytes(k) -> bytes:
        # surrogateescape round-trips keys that native transports decoded
        # from arbitrary bytes.  Raises UnicodeEncodeError for lone
        # surrogates outside U+DC80-DCFF (JSON can deliver those) — the
        # caller rejects such keys per-request.
        return (
            k.encode("utf-8", "surrogateescape")
            if isinstance(k, str)
            else bytes(k)
        )

    def _dead_peers(self) -> frozenset:
        """Peers whose circuit breaker is open right now (ring mode's
        failure-detection input)."""
        return frozenset(
            i
            for i, p in enumerate(self.peers)
            if p is not None and p.breaker_open
        )

    def _owners_for(
        self,
        kb: List[bytes],
        bad: np.ndarray,
        force_local: bool = False,
        trigger_takeover: bool = True,
    ) -> np.ndarray:
        """Owner index per key, with the ring mode's routing overrides:
        a dead owner's keys fail over to their ring successor (who
        absorbs the warm replica first), and `force_local` (the
        OP_ROUTE_BATCH hop bound) pins everything here.
        `trigger_takeover=False` skips the replica absorb — required by
        callers already holding device_lock (the re-partition check)."""
        n = len(kb)
        if force_local:
            return np.full(n, self.self_index, np.int32)
        if self.ring is None:
            n_nodes = len(self.nodes)
            owners = np.zeros(n, np.int32)
            for i, b in enumerate(kb):
                if not bad[i]:
                    owners[i] = node_of_key(b, n_nodes)
            return owners
        from .ring import batch_crc32

        if bad.any():
            # Rejected keys (unencodable / oversized) never route, but
            # one >1 KB reject in the hash input would force the whole
            # batch off the vectorized CRC matrix — hash only the good
            # rows (owner values of bad rows are discarded anyway).
            good = np.flatnonzero(~bad)
            crcs = np.zeros(n, np.uint32)
            crcs[good] = batch_crc32([kb[int(i)] for i in good])
        else:
            crcs = batch_crc32(kb)
        owners = self.ring.owners_of(crcs).astype(np.int32)
        dead = self._dead_peers()
        if dead:
            mask = np.isin(owners, list(dead))
            if mask.any():
                owners[mask] = self.ring.owners_of(
                    crcs[mask], exclude=dead
                )
                if trigger_takeover and (
                    owners[mask] == self.self_index
                ).any():
                    # This node inherits (part of) a dead peer's range:
                    # absorb its warm replica before deciding.
                    for d in dead:
                        self._ensure_takeover(d)
        return owners

    def _encode_and_partition(self, keys, force_local: bool = False):
        """Per-key wire bytes, per-key reject mask, owner partition and
        the membership epoch the partition was computed under (the
        decide path re-validates ownership when the epoch moved — a
        batch partitioned before a join/reweight flip must not decide a
        key the flip handed away).

        A key that cannot cross the wire (unencodable lone surrogate) or
        exceeds the u16 length limit is rejected *individually* — it must
        never fail its batchmates.
        """
        n = len(keys)
        n_nodes = len(self.nodes)
        with self._mu:
            epoch = self.epoch
        kb: List[bytes] = []
        bad = np.zeros(n, bool)
        for i, k in enumerate(keys):
            try:
                b = self._key_bytes(k)
            except UnicodeEncodeError:
                kb.append(b"")
                bad[i] = True
                continue
            if len(b) > MAX_KEY_BYTES:
                bad[i] = True
            kb.append(b)
        owners = self._owners_for(kb, bad, force_local=force_local)
        by_node = [
            np.flatnonzero(~bad & (owners == d)) for d in range(n_nodes)
        ]
        return kb, bad, by_node, epoch

    @staticmethod
    def _broadcast(v, n):
        return np.broadcast_to(np.asarray(v, np.int64), (n,))

    def _apply_reply(self, arrays, ix, rep, wire: bool) -> None:
        """Merge one peer reply (exact-ns wire rows) into the output
        arrays, applying the documented wire truncation when asked."""
        allowed, limit, remaining, reset_after, retry_after, status = arrays
        status[ix] = rep["status"]
        allowed[ix] = rep["allowed"] != 0
        limit[ix] = rep["limit"]
        remaining[ix] = rep["remaining"]
        if wire:
            # Replies carry exact ns; apply the wire truncation here
            # (identical to the compact kernel's, types.rs:87-97).
            reset_after[ix] = np.minimum(
                rep["reset_ns"] // NS_PER_SEC, I32_MAX
            )
            retry_after[ix] = np.minimum(
                rep["retry_ns"] // NS_PER_SEC, I32_MAX
            )
            remaining[ix] = np.minimum(rep["remaining"], I32_MAX)
        else:
            reset_after[ix] = rep["reset_ns"]
            retry_after[ix] = rep["retry_ns"]

    def _apply_local(self, arrays, ix, res, wire: bool) -> None:
        allowed, limit, remaining, reset_after, retry_after, status = arrays
        allowed[ix] = res.allowed
        limit[ix] = res.limit
        remaining[ix] = res.remaining
        status[ix] = res.status
        if wire:
            reset_after[ix] = res.reset_after_s
            retry_after[ix] = res.retry_after_s
        else:
            reset_after[ix] = res.reset_after_ns
            retry_after[ix] = res.retry_after_ns

    def _forward_frame(self, kb, ix, mb, cp, pd, qt, now_ns, hops,
                       dl=None):
        sub = [kb[i] for i in ix]
        params = zip(mb[ix], cp[ix], pd[ix], qt[ix])
        if self.ring is not None:
            if dl is not None and (dl[ix] > 0).any():
                # Carry the remaining client budget (deadline - now) so
                # the receiver sheds with ITS flush-time clock — a
                # hop-chained request cannot outlive its client.  Rows
                # without a deadline ride budget 0; batches with no
                # deadline at all stay on the classic op (byte-
                # identical kill switch).
                budgets = np.where(dl[ix] > 0, dl[ix] - now_ns, 0)
                return encode_droute(sub, params, now_ns, hops, budgets)
            return encode_route(sub, params, now_ns, hops)
        return encode_batch(sub, params, now_ns)

    def _single_rpc(self, d: int, frame: bytes, n_expect: int):
        """One request->reply cycle to peer `d` (failover/re-partition
        rounds).  Returns the decoded reply rows or None on failure
        (breaker bookkeeping done)."""
        peer = self.peers[d]
        try:
            with peer.request_lock:
                with peer.lock:
                    peer.send_frame(frame)
                with peer.lock:
                    op, body = peer.recv_frame()
            if op != OP_THROTTLE_REPLY:
                raise ClusterProtocolError(f"unexpected cluster op {op}")
            rep = decode_reply(body)
            if len(rep) != n_expect:
                raise ClusterProtocolError("cluster reply length mismatch")
        except (OSError, struct.error) as exc:
            log.warning(
                "cluster forward to %s failed: %s", self.nodes[d], exc
            )
            _note_peer_error(peer, exc)
            return None
        with peer.lock:
            peer.record_success()
        return rep

    def rate_limit_batch(
        self, keys, max_burst, count_per_period, period, quantity,
        now_ns: int, wire: bool = False, _part=None, _hops: int = 0,
        deadlines_ns=None,
    ):
        """`_part` lets rate_limit_many pass the partition it already
        computed for its local-only probe, so no batch is partitioned
        twice.  `_hops` counts OP_ROUTE_BATCH forward hops (server
        path): at MAX_HOPS everything is decided here rather than
        forwarded again.  `deadlines_ns` (i64 per key, 0 = none) sheds
        rows already past their client deadline with STATUS_DEADLINE —
        before any device dispatch or forward — and stamps the
        remaining budget onto forwarded frames."""
        n = len(keys)
        force_local = self.ring is not None and _hops >= MAX_HOPS
        if force_local and _part is None:
            log.warning(
                "cluster hop bound reached (%d); deciding %d keys "
                "locally despite ownership (membership skew)", _hops, n,
            )
        kb, bad, by_node, part_epoch = (
            self._encode_and_partition(keys, force_local=force_local)
            if _part is None
            else _part
        )
        mb = self._broadcast(max_burst, n)
        cp = self._broadcast(count_per_period, n)
        pd = self._broadcast(period, n)
        qt = self._broadcast(quantity, n)
        dl = None
        expired = None
        if deadlines_ns is not None:
            dl = np.asarray(deadlines_ns, np.int64)
            if dl.shape != (n,):
                dl = np.broadcast_to(dl, (n,))
            exp_mask = (dl > 0) & (dl <= now_ns)
            if exp_mask.any():
                # Shed expired rows from every partition: they must
                # never reach a device or a peer.
                expired = exp_mask
                by_node = [ix[~expired[ix]] for ix in by_node]

        # A joining/rejoining node must not decide its ranges before the
        # predecessors' migrations land (zero lost decisions across the
        # handoff epoch).
        if self.ring is not None and len(by_node[self.self_index]):
            self._wait_handoff()

        # A mid-leave lame duck parks forwards until its own OP_LEAVE /
        # OP_MIGRATE stream is fully sent: forwards share each peer's
        # connection with those frames, so per-connection ordering then
        # guarantees the receiver has flipped its ring AND installed
        # the handed-off state before any forwarded key arrives.
        if self._lame_duck and not self._leave_complete.is_set():
            self._leave_complete.wait(self.handoff_timeout_s)

        # Ship remote sub-batches first (pipelined), then decide locally
        # while peers work, then collect replies.  Ring mode holds each
        # involved peer's request_lock from its send until ITS OWN
        # reply is consumed — that is exactly the pairing window a
        # concurrent forwarder (ClusterServer hop path) must not
        # interleave into; holding it any longer (e.g. across the other
        # peers' replies) would serialize concurrent forwarders on the
        # whole round instead of one RPC.
        sent: List[Tuple[int, np.ndarray]] = []
        failed_nodes: List[Tuple[int, np.ndarray]] = []
        held: dict = {}

        def _unpair(d: int) -> None:
            # Exactly-once release of a peer's request_lock, the moment
            # its request/reply cycle is paired off (or provably dead).
            lock = held.pop(d, None)
            if lock is not None:
                lock.release()

        try:
            if self.ring is not None:
                for d, ix in enumerate(by_node):
                    if d != self.self_index and len(ix):
                        self.peers[d].request_lock.acquire()
                        held[d] = self.peers[d].request_lock
            for d, ix in enumerate(by_node):
                if d == self.self_index or len(ix) == 0:
                    continue
                frame = self._forward_frame(
                    kb, ix, mb, cp, pd, qt, now_ns, _hops + 1, dl
                )
                peer = self.peers[d]
                try:
                    with peer.lock:
                        peer.send_frame(frame)
                    sent.append((d, ix))
                except PeerUnavailable:
                    # Gate already armed by the original failure;
                    # re-arming here would push the retry deadline
                    # forever outward.
                    with peer.lock:
                        peer.failed += 1
                    failed_nodes.append((d, ix))
                    _unpair(d)  # no reply coming
                except OSError as e:
                    log.warning(
                        "cluster peer %s send failed: %s",
                        self.nodes[d], e,
                    )
                    with peer.lock:
                        peer.record_failure()
                    failed_nodes.append((d, ix))
                    _unpair(d)

            local_ix = by_node[self.self_index]
            local_res = None
            moved_pairs: List[Tuple[int, np.ndarray]] = []
            if len(local_ix):
                with self.device_lock:
                    if (
                        self.ring is not None
                        and not force_local
                        and self.epoch != part_epoch
                    ):
                        # Membership flipped between partition and here
                        # (join/reweight under the lock we now hold):
                        # re-validate before deciding, or a key this
                        # flip handed away would be decided twice.
                        sub_kb = [kb[i] for i in local_ix]
                        owners2 = self._owners_for(
                            sub_kb, np.zeros(len(sub_kb), bool),
                            trigger_takeover=False,
                        )
                        for d in np.unique(owners2):
                            d = int(d)
                            if d != self.self_index:
                                moved_pairs.append(
                                    (d, local_ix[owners2 == d])
                                )
                        local_ix = local_ix[owners2 == self.self_index]
                    if len(local_ix):
                        local_res = self.local.rate_limit_batch(
                            [keys[i] for i in local_ix],
                            mb[local_ix], cp[local_ix], pd[local_ix],
                            qt[local_ix], now_ns, wire=wire,
                        )

            # Assemble in request order.
            allowed = np.zeros(n, bool)
            limit = np.zeros(n, np.int64)
            remaining = np.zeros(n, np.int64)
            reset_after = np.zeros(n, np.int64)
            retry_after = np.zeros(n, np.int64)
            status = np.zeros(n, np.uint8)
            arrays = (
                allowed, limit, remaining, reset_after, retry_after,
                status,
            )

            if local_res is not None:
                self._apply_local(arrays, local_ix, local_res, wire)
                self._queue_replicas(
                    kb, local_ix, mb, cp, pd, now_ns, local_res, wire
                )

            for d, ix in sent:
                peer = self.peers[d]
                try:
                    with peer.lock:
                        op, body = peer.recv_frame()
                    if op != OP_THROTTLE_REPLY:
                        raise ClusterProtocolError(
                            f"unexpected cluster op {op}"
                        )
                    rep = decode_reply(body)
                    if len(rep) != len(ix):
                        raise ClusterProtocolError(
                            "cluster reply length mismatch"
                        )
                except (OSError, struct.error) as e:
                    # A malformed frame leaves the stream desynced: drop
                    # the connection so the next batch reconnects
                    # cleanly (after backoff), and fail only this peer's
                    # requests.
                    log.warning(
                        "cluster peer %s reply failed: %s",
                        self.nodes[d], e,
                    )
                    with peer.lock:
                        peer.record_failure()
                    failed_nodes.append((d, ix))
                    _unpair(d)
                    continue
                with peer.lock:
                    peer.record_success()
                _unpair(d)  # this peer's cycle is paired off
                self._apply_reply(arrays, ix, rep, wire)
        finally:
            for lock in held.values():
                lock.release()
            held.clear()

        # Keys the re-partition check handed away mid-batch forward now
        # (outside the pipelined round's request locks).
        for d, ix in moved_pairs:
            frame = self._forward_frame(
                kb, ix, mb, cp, pd, qt, now_ns, _hops + 1, dl
            )
            rep = self._single_rpc(d, frame, len(ix))
            if rep is None:
                failed_nodes.append((d, ix))
            else:
                self._apply_reply(arrays, ix, rep, wire)

        if failed_nodes and self.ring is not None:
            # Elastic failover: a failed peer's keys retry once on their
            # ring successor (who absorbs the warm replica) instead of
            # failing the client — zero client-visible failures on
            # replicated ranges.
            failed_nodes = self._failover_round(
                failed_nodes, keys, kb, mb, cp, pd, qt, now_ns, wire,
                arrays, _hops, dl,
            )

        for _d, ix in failed_nodes:
            status[ix] = STATUS_INTERNAL
            allowed[ix] = False
        if bad.any():
            # Unencodable or over-length keys: each fails only itself.
            status[bad] = STATUS_INVALID_PARAMS
            allowed[bad] = False
        if expired is not None:
            status[expired] = STATUS_DEADLINE
            allowed[expired] = False

        if self.capture and _hops == 0:
            # Per-batch capture at the cluster frontend (opt-in; see
            # __init__): the client-visible outcome vector, tagged with
            # this node's index so a replayer routes each window through
            # the frontend that originally decided it.  Forwarded
            # batches re-enter here on the OWNER with _hops >= 1 —
            # capturing those too would record every forwarded request
            # twice and double-count it on replay.
            from ..replay.recorder import active_recorder
            from ..replay.trace import SOURCE_CLUSTER_BASE

            recorder = active_recorder()
            if recorder is not None:
                recorder.record_window(
                    now_ns, kb,
                    np.stack([mb, cp, pd, qt], axis=1),
                    allowed, status,
                    source=SOURCE_CLUSTER_BASE + self.self_index,
                )

        if wire:
            return WireBatchResult(
                allowed=allowed, limit=limit, remaining=remaining,
                reset_after_s=reset_after, retry_after_s=retry_after,
                status=status,
            )
        return BatchResult(
            allowed=allowed, limit=limit, remaining=remaining,
            reset_after_ns=reset_after, retry_after_ns=retry_after,
            status=status,
        )

    def _failover_round(
        self, failed_nodes, keys, kb, mb, cp, pd, qt, now_ns, wire,
        arrays, hops, dl=None,
    ):
        """Re-route failed peers' keys to their ring successors (one
        round).  Keys whose successor is this node are decided locally
        from the absorbed replica; others forward once more.  Returns
        the (d, ix) pairs that still failed."""
        from .ring import batch_crc32

        still_failed: List[Tuple[int, np.ndarray]] = []
        dead = self._dead_peers()
        for d, ix in failed_nodes:
            excl = frozenset(dead | {d})
            if len(excl) >= len(self.nodes):
                still_failed.append((d, ix))
                continue
            sub_kb = [kb[i] for i in ix]
            succ = self.ring.owners_of(batch_crc32(sub_kb), exclude=excl)
            for e in np.unique(succ):
                e = int(e)
                eix = ix[succ == e]
                if e == self.self_index:
                    self._ensure_takeover(d)
                    with self.device_lock:
                        res = self.local.rate_limit_batch(
                            [keys[i] for i in eix],
                            mb[eix], cp[eix], pd[eix], qt[eix],
                            now_ns, wire=wire,
                        )
                    self._apply_local(arrays, eix, res, wire)
                    self._queue_replicas(
                        kb, eix, mb, cp, pd, now_ns, res, wire
                    )
                    continue
                frame = self._forward_frame(
                    kb, eix, mb, cp, pd, qt, now_ns, hops + 1, dl
                )
                rep = self._single_rpc(e, frame, len(eix))
                if rep is None:
                    still_failed.append((e, eix))
                else:
                    self._apply_reply(arrays, eix, rep, wire)
        return still_failed

    # -------------------------------------------------------------- #
    # Elastic lifecycle: handoff gating, migration, replication,
    # takeover.

    def _wait_handoff(self) -> None:
        """Block local decisions while a key-range handoff is inbound.

        A joining (or rejoining) node registered `_pending_from` entries
        when its OP_JOIN was acked; each clears when that predecessor's
        OP_MIGRATE is applied.  Entries are abandoned loudly after
        `handoff_timeout_s` or when the predecessor's breaker opens
        (state lost mid-handoff — availability wins, the GCRA clamp
        bounds the damage).  Deadlines are measured on `self._clock`
        (injectable), so tests pin them against a virtual clock instead
        of racing wall time under load."""
        with self._handoff_cv:
            while self._pending_from:
                now = self._clock()
                for d in list(self._pending_from):
                    peer = self.peers[d]
                    if now >= self._pending_from[d] or (
                        peer is not None and peer.breaker_open
                    ):
                        log.warning(
                            "handoff from %s abandoned (%s); serving "
                            "without its migrated state",
                            self.nodes[d],
                            "peer dead"
                            if peer is not None and peer.breaker_open
                            else "deadline",
                        )
                        self._pending_from.pop(d)
                        self.handoff_timeouts += 1
                if not self._pending_from:
                    break
                self._handoff_cv.wait(timeout=0.05)

    def _decode_wire_keys(self, keys: List[bytes]) -> list:
        """Wire key bytes -> the local limiter's key identity."""
        if self._bytes_keys:
            return keys
        return [k.decode("utf-8", "surrogateescape") for k in keys]

    def _send_migrate(self, dest: int, epoch: int, kb, tats, exps) -> bool:
        """Stream a key range to `dest` (chunked, fire-and-forget).

        An empty range still sends one frame — it is the handoff-
        complete marker the joiner's gate waits for.  Returns False when
        the send failed (the receiver's deadline will unblock it)."""
        from ..faults import maybe_fail

        peer = self.peers[dest]
        if peer is None:
            return False
        CHUNK = 50_000
        n = len(kb)
        spans = range(0, max(n, 1), CHUNK)
        try:
            maybe_fail("migrate")
            for lo in spans:
                chunk = slice(lo, lo + CHUNK)
                frame = encode_rows(
                    OP_MIGRATE, self.self_index, epoch,
                    kb[chunk], tats[chunk], exps[chunk],
                )
                with peer.lock:
                    peer.send_frame(frame)
            peer.migrated += n
            return True
        except (OSError, PeerUnavailable) as e:
            log.warning(
                "migrate of %d keys to %s failed: %s (its handoff "
                "deadline will unblock it)", n, self.nodes[dest], e,
            )
            _note_peer_error(peer, e)
            return False

    def _export_owned_by(self, ring, target: int):
        """(wire-bytes keys, tats, exps) of local-table rows that `ring`
        assigns to `target`, plus any un-absorbed replica rows for that
        range (freshest available when the target died before takeover
        traffic arrived).  Caller must hold device_lock."""
        from ..tpu.snapshot import export_state
        from .ring import batch_crc32

        kb: List[bytes] = []
        tats: List[int] = []
        exps: List[int] = []
        try:
            keys, _s, _sh, tat_col, exp_col, _c, _d = export_state(
                self.local
            )
        except Exception:
            log.exception("cluster export for migration failed")
            keys, tat_col, exp_col = [], [], []
        enc: List[bytes] = []
        ok: List[int] = []
        for i, k in enumerate(keys):
            try:
                enc.append(self._key_bytes(k))
                ok.append(i)
            except UnicodeEncodeError:
                continue
        if enc:
            owners = ring.owners_of(batch_crc32(enc))
            for j, i in enumerate(ok):
                if owners[j] == target:
                    kb.append(enc[j])
                    tats.append(int(tat_col[i]))
                    exps.append(int(exp_col[i]))
        taken = set(kb)
        with self._replica_mu:
            rep_keys = list(self.replica_store.keys())
            if rep_keys:
                owners = ring.owners_of(batch_crc32(rep_keys))
                for j, k in enumerate(rep_keys):
                    if owners[j] == target and k not in taken:
                        t, e = self.replica_store.pop(k)
                        kb.append(k)
                        tats.append(t)
                        exps.append(e)
                    elif owners[j] == target:
                        self.replica_store.pop(k, None)
        return kb, np.asarray(tats, np.int64), np.asarray(exps, np.int64)

    def ring_state(self):
        """(epoch, weight vector) — the OP_JOIN/OP_RING_STATE payload."""
        with self._mu:
            return self.epoch, (
                self.ring.weight_vector() if self.ring is not None else []
            )

    def on_join(self, origin: int) -> tuple:
        """A node announced itself ((re)boot or partition heal): hand
        its key range back and route to it again.

        Ordering is the correctness core: the epoch bump, breaker heal
        and export are atomic under device_lock (no local decision can
        mutate the range after the export; concurrently-partitioned
        batches re-validate against the new epoch).  The OP_MIGRATE
        send itself happens OUTSIDE device_lock — an announced joiner
        gates its decisions on the migrate's arrival (pending_from), so
        a post-flip forward racing ahead of the bytes parks at the
        joiner's gate; only the un-announced pump-heal path has a
        bounded-divergence window (see the inline comment).  Returns
        the ring state for the OP_RING_STATE reply."""
        if (
            self.ring is None
            or origin == self.self_index
            or not 0 <= origin < len(self.nodes)
        ):
            return self.ring_state()
        log.info(
            "cluster join announced by %s: migrating its key range "
            "back", self.nodes[origin],
        )
        from ..replay.recorder import maybe_record_event

        maybe_record_event("cluster-join", str(origin))
        import contextlib

        peer = self.peers[origin]
        with contextlib.ExitStack() as stack:
            if peer is not None:
                # Serialize with any in-flight announce of OURS on this
                # connection (request_lock is held across its whole
                # send->recv cycle): closing the socket under it would
                # kill the announce mid-cycle AND heal() would then stop
                # the pump's breaker-gated re-probe from ever retrying
                # it — stranding the peer's migrate-back of our range.
                # Lock order (request_lock before device_lock) matches
                # the decide path.
                stack.enter_context(peer.request_lock)
            with self.device_lock:
                # The flip — epoch bump, breaker heal and the export —
                # is atomic under device_lock: no local decision can
                # mutate the range after the export, and batches
                # partitioned before the flip re-validate against the
                # new epoch before deciding.
                with self._mu:
                    self.epoch += 1
                    epoch = self.epoch
                    self._absorbed.discard(origin)
                    self._departed.discard(origin)
                    if self.ring.weights.get(origin, 1.0) < 1e-9:
                        # The origin left (planned OP_LEAVE) earlier:
                        # a join re-registers it at full weight — and
                        # the export below must run against the
                        # restored ring, or it would hand nothing back
                        # (a weight-0 node owns no points).
                        self.ring = self.ring.with_weight(origin, 1.0)
                    ring = self.ring
                if peer is not None:
                    # Any existing socket predates this announcement
                    # (the peer may have restarted): the migrate must
                    # ride a fresh connection, not a half-dead one that
                    # swallows it.
                    with peer.lock:
                        peer.close()
                    peer.heal()
                kb, tats, exps = self._export_owned_by(ring, origin)
            # The send happens OUTSIDE device_lock (still under the
            # peer's request_lock): a large migration blocking on
            # socket buffers must not stall every local decision — and
            # two nodes healing each other simultaneously would
            # otherwise deadlock, each holding its device_lock through
            # a blocked sendall while its inbound apply_migrate waits
            # for that same lock.  Ordering stays safe: an announced
            # joiner gates its decisions on this migrate's arrival
            # (pending_from), so a post-flip forward racing ahead of
            # these bytes parks at the joiner's gate until the state
            # lands; on the un-announced pump-heal path the window is
            # the documented bounded-divergence regime.
            self._send_migrate(origin, epoch, kb, tats, exps)
        if kb:
            log.info(
                "migrated %d keys back to %s", len(kb),
                self.nodes[origin],
            )
        return self.ring_state()

    def apply_migrate(self, origin: int, epoch: int, keys, tats, exps):
        """Install inbound OP_MIGRATE rows and clear the handoff gate.

        Crash-rejoin reconcile: a node that restored a local checkpoint
        before announcing has a non-empty table when the successor's
        migrate-back lands.  Per key the *newest* row wins — the
        inbound row overwrites (bulk insert semantics) unless the local
        row's TAT is at least as new (tie broken by expiry).  Dropping
        the older row is over-allow-only by the GCRA clamp argument
        either way."""
        from ..faults import maybe_fail
        from ..tpu.snapshot import _bulk_insert, export_state

        maybe_fail("migrate")
        n = len(keys)
        stale = 0
        if n and self.ring is not None:
            try:
                decoded = self._decode_wire_keys(keys)
                tats = [int(t) for t in tats]
                exps = [int(e) for e in exps]
                with self.device_lock:
                    if len(self.local) != 0:
                        k_col, _s, _sh, t_col, e_col, _c, _d = (
                            export_state(self.local)
                        )
                        local_rows = {
                            k: (int(t_col[i]), int(e_col[i]))
                            for i, k in enumerate(k_col)
                        }
                        keep = [
                            i
                            for i, k in enumerate(decoded)
                            if local_rows.get(k, (-1, -1))
                            < (tats[i], exps[i])
                        ]
                        stale = n - len(keep)
                        if stale:
                            decoded = [decoded[i] for i in keep]
                            tats = [tats[i] for i in keep]
                            exps = [exps[i] for i in keep]
                    if decoded:
                        _bulk_insert(self.local, decoded, tats, exps)
                if stale:
                    self.reconciled_stale += stale
                    log.info(
                        "reconciled %d stale inbound row(s) against "
                        "newer local state (crash-rejoin)", stale,
                    )
            except Exception:
                # A refused insert (e.g. table full) must not leave the
                # handoff gate armed until its deadline — the range is
                # served fresh, loudly, rather than stalled.
                log.exception(
                    "applying %d migrated keys from %s failed", n,
                    self.nodes[origin]
                    if 0 <= origin < len(self.nodes) else origin,
                )
        with self._handoff_cv:
            self.epoch = max(self.epoch, epoch)
            self.migrated_in += n
            self._handoff_done.add(origin)
            if origin in self._pending_from:
                self._pending_from.pop(origin)
            self._handoff_cv.notify_all()
        log.info(
            "applied %d migrated keys from %s (epoch %d)",
            n, self.nodes[origin] if 0 <= origin < len(self.nodes)
            else origin, epoch,
        )

    def apply_replica(self, origin: int, keys, tats, exps) -> None:
        """Fold warm-standby deltas into the bounded replica store
        (insertion order == recency: refreshed keys move to the back,
        overflow evicts the coldest)."""
        if self.replica_cap <= 0:
            # cap 0 = hold no replicas (valid config); must not fall
            # through to evict-from-empty.
            return
        with self._replica_mu:
            store = self.replica_store
            for k, t, e in zip(keys, tats, exps):
                if k in store:
                    del store[k]
                elif len(store) >= self.replica_cap:
                    store.pop(next(iter(store)))
                    self.replica_drops += 1
                store[k] = (int(t), int(e))

    def apply_ring(self, epoch: int, weights) -> None:
        """Adopt a broadcast weight vector (reweight announcements).
        Stale epochs are ignored — last announcement wins."""
        if self.ring is None:
            return
        if len(weights) != len(self.nodes):
            raise ClusterProtocolError(
                "ring weight vector length mismatches node list"
            )
        from .ring import HashRing

        with self._mu:
            # Equal epochs are the SAME membership event seen twice (a
            # migrate tagged with the new epoch can land before the
            # ring broadcast); only strictly-older announcements are
            # stale.  Membership events are sequential by design — two
            # simultaneous announcers are not coordinated here.
            if epoch < self.epoch:
                return
            merged = {i: w for i, w in enumerate(weights)}
            # Each node is the authority for its OWN weight (it is the
            # one announcing degraded capacity); an echo of an older
            # view must not clobber it.
            merged[self.self_index] = self.ring.weights.get(
                self.self_index, 1.0
            )
            # A departed peer stays at weight 0 until its own OP_JOIN:
            # a broadcast from a node that has not yet seen the leave
            # must not route keys at a gone node.
            for d in self._departed:
                merged[d] = 0.0
            if (
                epoch == self.epoch
                and [merged[i] for i in range(len(self.nodes))]
                == self.ring.weight_vector()
            ):
                return
            self.ring = HashRing(
                self.nodes, self.ring.vnodes, weights=merged
            )
            self.epoch = epoch
        log.info(
            "adopted cluster ring epoch %d (weights %s)", epoch,
            [round(w, 3) for w in weights],
        )
        from ..replay.recorder import maybe_record_event

        maybe_record_event("cluster-epoch", str(epoch))

    def _export_all(self):
        """EVERY exportable local-table row plus the replica store's
        leftovers, for the leave handoff (caller holds device_lock).
        Unlike _export_owned_by this is ring-blind: absorbed takeover
        ranges and freshly-migrated rows all leave with us.  Replica
        rows whose owner is alive are dropped, not exported — the owner
        holds fresher state and re-replicates to its new successor on
        the next decide; pushing our stale copy at anyone could clobber
        a fresher TAT."""
        from ..tpu.snapshot import export_state

        kb: List[bytes] = []
        tats: List[int] = []
        exps: List[int] = []
        try:
            keys, _s, _sh, tat_col, exp_col, _c, _d = export_state(
                self.local
            )
        except Exception:
            log.exception("cluster export for leave failed")
            keys, tat_col, exp_col = [], [], []
        for i, k in enumerate(keys):
            try:
                kb.append(self._key_bytes(k))
            except UnicodeEncodeError:
                continue
            tats.append(int(tat_col[i]))
            exps.append(int(exp_col[i]))
        with self._replica_mu:
            self.replica_store.clear()
        return kb, np.asarray(tats, np.int64), np.asarray(exps, np.int64)

    def leave(self) -> bool:
        """Planned departure: the join protocol in reverse.

        Under device_lock (atomic with local decides, like on_join):
        bump the epoch, enter lame-duck (ring weight 0 for self — every
        key now forwards, nothing decides locally), export the WHOLE
        local table grouped by the new ring's owners.  Then, outside
        device_lock, per peer and on its one connection: OP_LEAVE
        (the receiver flips its ring and gates its local decides on our
        migrate, mirroring a joiner's handoff gate) followed by the
        OP_MIGRATE rows (possibly the empty handoff-complete marker).
        Per-connection ordering therefore lands the announcement before
        the state and the state before any of our own forwards (which
        park on _leave_complete until the stream is fully sent) — zero
        lost decisions, zero replica staleness.

        Returns True when every live peer acked the full stream; False
        when the handoff was partial (a receiver's handoff deadline or
        breaker unblocks it — the kill-path takeover bounds the
        damage) or there was no live peer to hand off to."""
        if self.ring is None or len(self.nodes) == 1:
            return False
        from ..replay.recorder import maybe_record_event
        from .ring import batch_crc32

        with self.device_lock:
            with self._mu:
                if self._lame_duck:
                    return False
                dead = self._dead_peers()
                departed = set(self._departed)
                live = [
                    i
                    for i in range(len(self.nodes))
                    if i != self.self_index
                    and i not in dead
                    and i not in departed
                ]
                if not live:
                    log.warning(
                        "cluster leave aborted: no live peer to hand "
                        "off to (kill path will cover the exit)"
                    )
                    return False
                try:
                    new_ring = self.ring.with_weight(self.self_index, 0.0)
                except ValueError:
                    return False
                self.epoch += 1
                epoch = self.epoch
                self._lame_duck = True
            log.warning(
                "leaving cluster (epoch %d): handing off local key "
                "range", epoch,
            )
            maybe_record_event("cluster-leave", str(self.self_index))
            kb, tats, exps = self._export_all()
            moved: dict = {}
            if kb:
                # Dead peers are excluded so an absorbed takeover range
                # goes to its live successor, not back at the corpse.
                owners = new_ring.owners_of(
                    batch_crc32(kb), exclude=frozenset(dead)
                )
                for j, dest in enumerate(owners):
                    dest = int(dest)
                    if dest == self.self_index:
                        continue
                    rows = moved.setdefault(dest, ([], [], []))
                    rows[0].append(kb[j])
                    rows[1].append(int(tats[j]))
                    rows[2].append(int(exps[j]))
            with self._mu:
                self.ring = new_ring
        # Sends OUTSIDE device_lock (same rationale as on_join: a send
        # blocked on socket buffers must not stall the decide path).
        ok = True
        try:
            for dest, peer in enumerate(self.peers):
                if peer is None or dest in departed:
                    continue
                ks, ts, es = moved.get(dest, ([], [], []))
                try:
                    maybe_fail("leave")
                    with peer.lock:
                        peer.send_frame(
                            encode_leave(self.self_index, epoch)
                        )
                except (OSError, ConnectionError) as e:
                    log.warning(
                        "leave announce to %s failed: %s (its handoff "
                        "deadline will unblock it)", self.nodes[dest], e,
                    )
                    _note_peer_error(peer, e)
                    ok = False
                    continue
                if not self._send_migrate(
                    dest, epoch, ks,
                    np.asarray(ts, np.int64), np.asarray(es, np.int64),
                ):
                    ok = False
        finally:
            self.leave_count += 1
            # Unpark lame-duck forwards even on a partial handoff —
            # availability wins; receivers that missed frames time out
            # of their gates and the takeover path bounds the damage.
            self._leave_complete.set()
        if ok:
            log.info(
                "cluster leave complete: %d keys handed off to %d "
                "peers", sum(len(v[0]) for v in moved.values()),
                len(moved),
            )
        return ok

    def on_leave(self, origin: int, epoch: int) -> None:
        """A peer announced planned departure: stop routing keys at it
        and gate local decisions until its OP_MIGRATE lands (the frames
        share one connection, so the migrate is right behind this
        announcement — the gate only parks OTHER threads' decides for
        that window).  Mirrors apply_ring's flip discipline: ring and
        epoch move under _mu; in-flight batches re-validate their
        partition epoch under device_lock before deciding."""
        if (
            self.ring is None
            or origin == self.self_index
            or not 0 <= origin < len(self.nodes)
        ):
            return
        maybe_fail("leave")
        from ..replay.recorder import maybe_record_event

        maybe_record_event("cluster-leave", str(origin))
        deadline = self._clock() + self.handoff_timeout_s
        with self._handoff_cv:
            self.epoch = max(self.epoch, epoch)
            if self.ring.weights.get(origin, 1.0) > 1e-9:
                self.ring = self.ring.with_weight(origin, 0.0)
            self._departed.add(origin)
            self.leave_count += 1
            # Gate local decides until the leaver's state lands; a
            # previous join's _handoff_done entry must not short-
            # circuit this round's gate.
            self._handoff_done.discard(origin)
            self._pending_from[origin] = deadline
        log.info(
            "peer %s announced planned leave (epoch %d): gating on "
            "its handoff", self.nodes[origin], epoch,
        )

    def _ensure_takeover(self, dead: int) -> None:
        """First failover onto a dead peer's range: absorb its warm
        replica rows into the local table so the successor continues
        from the freshest replicated state instead of deciding fresh."""
        from ..tpu.snapshot import _bulk_insert
        from .ring import batch_crc32

        with self._takeover_lock:
            with self._mu:
                if dead in self._absorbed:
                    return
                self._absorbed.add(dead)
                ring = self.ring
            with self._replica_mu:
                items = list(self.replica_store.items())
            kb = [k for k, _ in items]
            take_k: List[bytes] = []
            take_t: List[int] = []
            take_e: List[int] = []
            if kb:
                owners = ring.owners_of(batch_crc32(kb))
                for j, (k, (t, e)) in enumerate(items):
                    if owners[j] == dead:
                        take_k.append(k)
                        take_t.append(t)
                        take_e.append(e)
            if take_k:
                try:
                    with self.device_lock:
                        _bulk_insert(
                            self.local,
                            self._decode_wire_keys(take_k),
                            np.asarray(take_t, np.int64),
                            np.asarray(take_e, np.int64),
                        )
                except Exception:
                    log.exception("replica takeover bulk insert failed")
            self.takeover_count += 1
            log.warning(
                "peer %s declared dead: took over its range from %d "
                "warm-replica rows", self.nodes[dead], len(take_k),
            )
            from ..replay.recorder import maybe_record_event

            maybe_record_event("cluster-takeover", str(dead))

    def _replicating(self) -> bool:
        # A lame duck decides nothing new and is about to vanish —
        # replicating its stream would only push staleness at peers.
        return (
            self.replicate
            and self._pump is not None
            and not self._lame_duck
        )

    def _queue_replicas(
        self, kb, ix, mb, cp, pd, now_ns, res, wire: bool
    ) -> None:
        """Hand one decided sub-batch to the replica pump (bounded,
        drop-oldest, zero device work — rows are reconstructed from the
        result's reset_after via tat = now + reset - tolerance and
        expiry = now + reset, both exact in ns mode and <= 1 s stale in
        wire mode)."""
        if not self._replicating() or len(ix) == 0:
            return
        reset = res.reset_after_s if wire else res.reset_after_ns
        self._pump.submit((
            [kb[i] for i in ix],
            np.asarray(mb[ix], np.int64).copy(),
            np.asarray(cp[ix], np.int64).copy(),
            np.asarray(pd[ix], np.int64).copy(),
            int(now_ns),
            np.asarray(reset, np.int64).copy(),
            np.asarray(res.status, np.uint8).copy(),
            np.asarray(res.allowed, bool).copy(),
            bool(wire),
        ))

    def _flush_replicas(self, entries) -> None:
        """Pump-thread half: rebuild (tat, expiry) rows from decide
        results, group by each key's ring successor, and push
        OP_REPLICA frames (fire-and-forget, best-effort)."""
        from .ring import batch_crc32

        by_dest: dict = {}
        seen: set = set()
        # Replicas must land on a LIVE successor: during a takeover the
        # owner-excluding-self of an absorbed key is the dead node
        # itself, and replicating into the void would leave the range
        # single-copy for the whole outage.  Excluding the dead set
        # routes those rows to the next live node; when this node is
        # the only survivor there is no replica target (skip).
        excl = frozenset({self.self_index}) | self._dead_peers()
        if len(excl) >= len(self.nodes):
            return
        for kb, mb, cp, pd, now_ns, reset, status, allowed, wire in (
            reversed(entries)
        ):
            # Newest-first with a seen-set: only the LATEST row per key
            # per flush crosses the wire, and only rows that MUTATED
            # state (allowed) — a denial never moves the TAT, so the
            # last allowed decision already replicated the final state.
            valid = (status == 0) & allowed
            if not valid.any():
                continue
            reset_ns = reset * NS_PER_SEC if wire else reset
            # tolerance = emission * (burst - 1); float-probe every
            # magnitude (no wrap; error <= ~2^11 ns at i64 scale) and
            # refuse pathological rows (>= 2^61) — the replica is
            # best-effort, never a correctness surface, so skipping a
            # poison row beats wrapping it.
            pd_ok = (cp > 0) & (
                pd.astype(np.float64) * NS_PER_SEC < float(1 << 61)
            )
            emission = (  # inv: allow(i64-raw-op)  pd_ok float-probes < 2^61
                np.where(pd_ok, pd, 0) * NS_PER_SEC
            ) // np.maximum(cp, 1)
            # The probe itself is f64 (no wrap possible).
            tol_f = emission.astype(np.float64) * np.maximum(mb - 1, 0)  # inv: allow(i64-raw-op)
            sane = (
                valid
                & pd_ok
                & (tol_f < float(1 << 61))
                & (emission > 0)
                & (
                    reset_ns.astype(np.float64) + float(now_ns)
                    < float(1 << 62)
                )
            )
            if not sane.any():
                continue
            expiry = now_ns + reset_ns
            # Both guarded by `sane` (tol_f/reset float probes < 2^61):
            # rows that could wrap were refused above.
            tol = emission * np.maximum(mb - 1, 0)  # inv: allow(i64-raw-op)
            tat = expiry - tol  # inv: allow(i64-raw-op)
            ring = self.ring
            sel = np.flatnonzero(sane)
            sel_kb = [kb[int(i)] for i in sel]
            succ = ring.owners_of(batch_crc32(sel_kb), exclude=excl)
            # Within a batch the LAST occurrence of a key is newest.
            for j in range(len(sel) - 1, -1, -1):
                k = sel_kb[j]
                if k in seen:
                    continue
                seen.add(k)
                d = int(succ[j])
                if d == self.self_index:
                    continue
                i = sel[j]
                rows = by_dest.setdefault(d, ([], [], []))
                rows[0].append(k)
                rows[1].append(int(tat[i]))
                rows[2].append(int(expiry[i]))
        with self._mu:
            epoch = self.epoch
        for d, (ks, ts, es) in by_dest.items():
            if not self._push_replica_rows(d, epoch, ks, ts, es):
                # The successor refused/failed: these rows would leave
                # their range single-copy (the exact takeover window a
                # replica exists for), so retry ONCE on the next live
                # successor instead of dropping.  A breaker heal racing
                # a node death (a stale OP_JOIN processed after the
                # kill re-closes the breaker) otherwise routes the
                # absorbed range's replicas at the dead node for the
                # whole re-detection window.
                excl2 = excl | self._dead_peers() | {d}
                if len(excl2) >= len(self.nodes):
                    continue
                succ2 = ring.owners_of(batch_crc32(ks), exclude=excl2)
                redo: dict = {}
                for j, e2 in enumerate(succ2):
                    e2 = int(e2)
                    if e2 == self.self_index:
                        continue
                    rows = redo.setdefault(e2, ([], [], []))
                    rows[0].append(ks[j])
                    rows[1].append(ts[j])
                    rows[2].append(es[j])
                for e2, (ks2, ts2, es2) in redo.items():
                    self._push_replica_rows(e2, epoch, ks2, ts2, es2)

    def _push_replica_rows(self, dest: int, epoch, ks, ts, es) -> bool:
        """One best-effort OP_REPLICA push; False when the peer is
        down/refusing (breaker bookkeeping done)."""
        peer = self.peers[dest]
        if peer is None or peer.breaker_open:
            return False
        frame = encode_rows(OP_REPLICA, self.self_index, epoch, ks, ts, es)
        try:
            with peer.lock:
                peer.send_frame(frame)
            return True
        except (OSError, PeerUnavailable) as e:
            # A failed replica push costs nothing but staleness; the
            # breaker bookkeeping still learns.
            _note_peer_error(peer, e)
            return False

    def announce_join_to(self, d: int, register_pending: bool = True):
        """OP_JOIN round trip to one peer: adopt its ring state and gate
        local decisions on its migrate.  Returns True on ack."""
        peer = self.peers[d]
        if peer is None:
            return False
        try:
            frame = encode_join(self.self_index)
            # request_lock pairs the reply; the inner lock is released
            # between send and recv so fire-and-forget frames (e.g. our
            # own on_join's migrate to this peer) can interleave — the
            # server replies in op order, so pairing still holds.
            with peer.request_lock:
                with peer.lock:
                    peer.send_frame(frame)
                with peer.lock:
                    op, body = peer.recv_frame()
            if op != OP_RING_STATE:
                raise ClusterProtocolError(
                    f"unexpected join reply op {op}"
                )
            epoch, weights = decode_ring(body)
        except (OSError, struct.error) as e:
            log.info("join announce to %s failed: %s", self.nodes[d], e)
            _note_peer_error(peer, e)
            return False
        with peer.lock:
            peer.record_success()
        try:
            self.apply_ring(epoch, weights)
        except ClusterProtocolError as e:
            log.warning("join reply from %s: %s", self.nodes[d], e)
        if (
            self.ring is not None
            and len(weights) == len(self.nodes)
            and abs(
                weights[self.self_index]
                - self.ring.weights.get(self.self_index, 1.0)
            ) > 1e-9
        ):
            # The peer holds a stale weight for US (e.g. we restarted
            # healthy while it remembers our degraded 0.5): we are the
            # authority for our own weight — arm the rebroadcast window
            # so the correction reaches everyone.
            import time

            self._reweight_heal_until = time.monotonic() + 30.0
        if register_pending:
            deadline = self._clock() + self.handoff_timeout_s
            with self._handoff_cv:
                if d not in self._handoff_done:
                    self._pending_from[d] = deadline
        return True

    def announce_join_all(self) -> None:
        """Boot/rejoin announcement: tell every peer we are here, and
        gate local decisions until their key-range migrations land."""
        with self._handoff_cv:
            self._handoff_done.clear()
        for d, peer in enumerate(self.peers):
            if peer is not None:
                self.announce_join_to(d)

    def start_membership(self) -> None:
        """Arm the membership announcement (run_server calls this once
        the ClusterServer is listening, so peers can migrate to us)."""
        if self._pump is not None:
            self._pump.request_announce()

    def rebroadcast_ring(self) -> None:
        """Anti-entropy for weight announcements: OP_RING frames are
        fire-and-forget, so a transiently-reset socket could lose one
        and leave a peer routing on stale weights indefinitely (or a
        peer whose epoch ran ahead during a partition discarding the
        announcement outright).  While this node's weight is reduced,
        the pump periodically re-announces under a FRESH epoch — no
        ownership changes on our side (the re-partition epoch check
        re-validates in-flight batches, same result), and receivers
        converge as soon as one frame lands."""
        if self.ring is None or self._lame_duck:
            return
        with self._mu:
            self.epoch += 1
            epoch = self.epoch
            weights = self.ring.weight_vector()
        frame = encode_ring(OP_RING, epoch, weights)
        for peer in self.peers:
            if peer is None or peer.breaker_open:
                continue
            try:
                with peer.lock:
                    peer.send_frame(frame)
            except (OSError, PeerUnavailable) as e:
                _note_peer_error(peer, e)

    def schedule_reweight(self, weight: float) -> None:
        """Queue a ring-weight announcement for this node (safe from
        any thread, including under the engine's limiter lock — the
        supervisor calls this from its degrade/re-promote paths; the
        pump applies it outside every lock)."""
        if self._pump is not None:
            self._pump.request_weight(weight)

    def announce_weight(self, weight: float) -> None:
        """Rebuild the ring with this node's new weight, migrate the
        lost vnode ranges to their new owners, then broadcast OP_RING.

        Per-connection ordering does the heavy lifting: each gaining
        peer's OP_MIGRATE is sent before the ring flip (and before
        OP_RING on the same connection), so by the time anyone routes a
        moved key to its new owner, the state is already there."""
        if self.ring is None or len(self.nodes) == 1 or self._lame_duck:
            return
        from .ring import batch_crc32

        with self._mu:
            w_now = self.ring.weights.get(self.self_index, 1.0)
            if abs(w_now - weight) < 1e-9:
                return
            new_ring = self.ring.with_weight(self.self_index, weight)
            old_ring = self.ring
        log.warning(
            "announcing cluster weight %.2f for %s",
            weight, self.nodes[self.self_index],
        )
        from ..replay.recorder import maybe_record_event

        maybe_record_event(
            "cluster-reweight", f"{self.self_index}:{weight}"
        )
        with self.device_lock:
            # Epoch bump, export and the ring flip are one atomic step
            # under device_lock (see on_join): batches partitioned
            # under the old ring re-validate before deciding.
            with self._mu:
                self.epoch += 1
                epoch = self.epoch
            kb, tats, exps = self._export_owned_by(
                old_ring, self.self_index
            )
            moved: dict = {}
            if kb:
                new_owners = new_ring.owners_of(batch_crc32(kb))
                for j, dest in enumerate(new_owners):
                    dest = int(dest)
                    if dest != self.self_index:
                        rows = moved.setdefault(dest, ([], [], []))
                        rows[0].append(kb[j])
                        rows[1].append(int(tats[j]))
                        rows[2].append(int(exps[j]))
            with self._mu:
                self.ring = new_ring
        # Sends happen OUTSIDE device_lock (same rationale as on_join:
        # a send blocked on socket buffers must not stall decides, and
        # two nodes reweighting at each other simultaneously —
        # correlated device failures — would otherwise mutually
        # deadlock).  Per-connection ordering still holds: each gaining
        # peer's migrate precedes its OP_RING below, sent sequentially
        # by this thread; the post-flip race window before the bytes
        # land is the same bounded, GCRA-clamped divergence regime as
        # the heal path.
        for dest in sorted(moved):
            ks, ts, es = moved[dest]
            self._send_migrate(
                dest, epoch,
                ks, np.asarray(ts, np.int64), np.asarray(es, np.int64),
            )
        frame = encode_ring(OP_RING, epoch, new_ring.weight_vector())
        for d, peer in enumerate(self.peers):
            if peer is None:
                continue
            try:
                with peer.lock:
                    peer.send_frame(frame)
            except (OSError, PeerUnavailable) as e:
                _note_peer_error(peer, e)
        # The broadcast is fire-and-forget; arm the pump's anti-entropy
        # window so a lost frame (either direction of the transition)
        # cannot strand peers on stale weights.
        import time

        self._reweight_heal_until = time.monotonic() + 30.0

    # ------------------------------------------------------------------ #

    #: Feature marker for the engine: dispatch_many/rate_limit_many
    #: accept a per-batch `deadlines` argument (forward-budget
    #: propagation); plain limiters never see the kwarg.
    accepts_deadlines = True

    def rate_limit_many(
        self, batches, wire: bool = False, deadlines=None
    ) -> list:
        """K batches in arrival order.

        Windows whose keys are ALL locally owned take the local scan path
        (one launch for the whole window, under the device lock).  A
        window containing any remote-owned key decides batch by batch —
        each batch still forwards its remote sub-batches as whole frames,
        but the window is a simple sequential composition (no cross-batch
        frame pipelining).  Per-key arrival order holds either way
        because a key always routes to the same node.
        """
        return self.dispatch_many(
            batches, wire=wire, deadlines=deadlines
        ).fetch()

    def dispatch_wire_window(self, frames, now_ns: int):
        """Cluster front for the fully-native wire path: windows whose
        keys are ALL locally owned delegate to the local limiter's
        dispatch_wire_window (ownership checked on the raw key bytes —
        no decode); any remote-owned key returns None, routing the
        window through the per-batch forwarding path."""
        inner = getattr(self.local, "dispatch_wire_window", None)
        if inner is None:
            return None
        n_nodes = len(self.nodes)
        if n_nodes > 1 and self.ring is not None:
            with self._mu:
                if self._pending_from:
                    # Mid-handoff: route through the per-batch path,
                    # which gates on the inbound migration.
                    return None
                epoch0 = self.epoch
            frame_kbs = [
                [
                    blob[offsets[i] : offsets[i + 1]]
                    for i in range(len(offsets) - 1)
                ]
                for blob, offsets, _params in frames
            ]
            kb = [k for fk in frame_kbs for k in fk]
            owners = self._owners_for(kb, np.zeros(len(kb), bool))
            if (owners != self.self_index).any():
                return None
            with self.device_lock:
                if self.epoch != epoch0:
                    # Membership flipped under us: let the per-batch
                    # path re-partition.
                    return None
                handle = inner(frames, now_ns)
            if handle is not None and self._replicating():
                # The native transports' fast path decides exactly the
                # rows warm replication exists to protect — wrap the
                # handle so they feed the pump like every other path.
                return _ReplicatingWireLaunch(
                    self, handle, frame_kbs,
                    [params for _b, _o, params in frames], now_ns,
                )
            return handle
        elif n_nodes > 1:
            for blob, offsets, _params in frames:
                for i in range(len(offsets) - 1):
                    kb = blob[offsets[i] : offsets[i + 1]]
                    if node_of_key(kb, n_nodes) != self.self_index:
                        return None
        with self.device_lock:
            return inner(frames, now_ns)

    def dispatch_many(self, batches, wire: bool = False, deadlines=None):
        """Dispatch/fetch split for the engine's double-buffered flush
        loop.  Windows whose keys are ALL locally owned dispatch through
        the local limiter's own split (the device lock covers only the
        dispatch; launches are ordered on the card's stream, which
        updates the table in place, so the fetch can run lock-free
        later).  Windows with remote keys
        decide synchronously inside this call — peer RPC and device work
        interleave per batch — and return ready results.  `deadlines`
        (one i64 array per batch, or None) rides the per-batch path so
        forwarded rows carry their remaining client budget; the engine
        already shed rows expired at flush time, so the local fast path
        has nothing to do with them."""
        if not batches:
            return _ReadyLaunch([])
        if deadlines is None:
            deadlines = [None] * len(batches)
        can_async = hasattr(self.local, "dispatch_many")
        can_scan = hasattr(self.local, "rate_limit_many")
        # Partition each batch exactly once: the local-only probe hands its
        # partitions to the per-batch path instead of discarding them.
        parts = [self._encode_and_partition(b[0]) for b in batches]
        local_only = (can_async or can_scan) and all(
            not bad.any()
            and not any(
                len(ix)
                for d, ix in enumerate(by_node)
                if d != self.self_index
            )
            for _, bad, by_node, _e in parts
        )
        if local_only:
            if self.ring is not None:
                self._wait_handoff()
            stale = False
            with self.device_lock:
                if self.ring is not None and any(
                    e != self.epoch for *_rest, e in parts
                ):
                    # Membership flipped since partitioning: abandon
                    # the fast path and re-partition per batch (same
                    # re-validation rate_limit_batch does).
                    stale = True
                else:
                    if can_async:
                        handle = self.local.dispatch_many(
                            batches, wire=wire
                        )
                    else:
                        handle = _ReadyLaunch(
                            self.local.rate_limit_many(batches, wire=wire)
                        )
            if stale:
                return _ReadyLaunch(
                    [
                        self.rate_limit_batch(
                            *b, wire=wire, deadlines_ns=dl
                        )
                        for b, dl in zip(batches, deadlines)
                    ]
                )
            if self._replicating():
                return _ReplicatingLaunch(self, handle, batches, parts, wire)
            return handle
        return _ReadyLaunch(
            [
                self.rate_limit_batch(
                    *b, wire=wire, _part=part, deadlines_ns=dl
                )
                for b, part, dl in zip(batches, parts, deadlines)
            ]
        )

    # ------------------------------------------------------------------ #

    def sweep(self, now_ns: int) -> int:
        """Sweep the local shard only — each node owns its cleanup, like
        independent reference instances."""
        with self.device_lock:
            return self.local.sweep(now_ns)

    def __len__(self) -> int:
        return len(self.local)

    @property
    def total_capacity(self) -> int:
        return getattr(self.local, "total_capacity", 1 << 62)

    def close(self) -> None:
        if self._pump is not None:
            self._pump.stop()
        for peer in self.peers:
            if peer is not None:
                peer.close()


class _ReplicatingLaunch:
    """Wraps a local dispatch handle so the decided rows feed the warm-
    standby replica pump once the results are actually on the host."""

    def __init__(self, cluster, handle, batches, parts, wire) -> None:
        self._cluster = cluster
        self._handle = handle
        self._batches = batches
        self._parts = parts
        self._wire = wire

    def fetch(self) -> list:
        results = self._handle.fetch()
        cl = self._cluster
        for batch, part, res in zip(self._batches, self._parts, results):
            kb, bad, _by_node, _epoch = part
            if bad.any():
                # Unreachable on the local-only fast path (its guard
                # requires no rejected keys), but a subset ix with
                # full-length result arrays would corrupt the replica
                # flush — refuse rather than misalign.
                continue
            ix = np.flatnonzero(~bad)
            n = len(batch[0])
            cl._queue_replicas(
                kb, ix,
                cl._broadcast(batch[1], n), cl._broadcast(batch[2], n),
                cl._broadcast(batch[3], n), batch[5], res, self._wire,
            )
        return results


class _ReplicatingWireLaunch:
    """Wraps a dispatch_wire_window handle so the native transports'
    fast-path decisions feed the warm-standby pump too (their windows
    are all locally-owned by construction — exactly the range a
    successor would need after this node dies)."""

    def __init__(self, cluster, handle, frame_kbs, frame_params,
                 now_ns) -> None:
        self._cluster = cluster
        self._handle = handle
        self._frame_kbs = frame_kbs
        self._frame_params = frame_params
        self._now_ns = now_ns

    def fetch(self):
        results = self._handle.fetch()
        cl = self._cluster
        for kb, params, res in zip(
            self._frame_kbs, self._frame_params, results
        ):
            params = np.asarray(params, np.int64)
            cl._queue_replicas(
                kb, np.arange(len(kb)),
                params[:, 0], params[:, 1], params[:, 2],
                self._now_ns, res, True,
            )
        return results


class _ClusterPump(threading.Thread):
    """The cluster tier's background worker: replica pushes, membership
    (re)announcements, scheduled ring reweights, and handoff-deadline
    wakeups — everything that must never ride (or block) the decide
    path."""

    POLL_S = 0.2
    MAX_QUEUE = 256  # decided sub-batches awaiting replication

    def __init__(self, cluster: "ClusterLimiter") -> None:
        super().__init__(name="throttlecrab-cluster-pump", daemon=True)
        import collections

        self.cluster = cluster
        self._cv = threading.Condition()
        self._stopped = False
        self._announce = False
        self._weight = None
        self._queue = collections.deque()
        self._reannounce_at: dict = {}
        self._rebroadcast_at = 0.0

    def submit(self, entry) -> None:
        with self._cv:
            if len(self._queue) >= self.MAX_QUEUE:
                self._queue.popleft()
                self.cluster.replica_drops += 1
            self._queue.append(entry)
            self._cv.notify()

    def request_announce(self) -> None:
        with self._cv:
            self._announce = True
            self._cv.notify()

    def request_weight(self, weight: float) -> None:
        with self._cv:
            self._weight = float(weight)
            self._cv.notify()

    def stop(self) -> None:
        with self._cv:
            self._stopped = True
            self._cv.notify()
        if self.is_alive():
            self.join(timeout=2.0)

    def run(self) -> None:  # pragma: no cover - exercised via cluster tests
        import time

        while True:
            with self._cv:
                if not (
                    self._stopped
                    or self._announce
                    or self._weight is not None
                    or self._queue
                ):
                    self._cv.wait(timeout=self.POLL_S)
                if self._stopped:
                    return
                announce = self._announce
                self._announce = False
                weight = self._weight
                self._weight = None
                entries = list(self._queue)
                self._queue.clear()
            cl = self.cluster
            try:
                if announce:
                    cl.announce_join_all()
                if weight is not None:
                    cl.announce_weight(weight)
                if entries:
                    cl._flush_replicas(entries)
                # Handoff deadlines: wake any decide thread blocked on a
                # handoff whose deadline lapsed (it purges and proceeds).
                with cl._handoff_cv:
                    if cl._pending_from:
                        cl._handoff_cv.notify_all()
                # Weight anti-entropy: while degraded (weight < 1) or
                # inside the heal window after ANY weight transition
                # (incl. restore-to-1.0 and restart-with-stale-peers),
                # a lost OP_RING frame must not strand peers on stale
                # routing — re-announce every couple of seconds under
                # fresh epochs until the window closes.
                now = time.monotonic()
                if (
                    cl.ring is not None
                    and not cl._lame_duck
                    and now >= self._rebroadcast_at
                    and (
                        abs(
                            cl.ring.weights.get(cl.self_index, 1.0)
                            - 1.0
                        ) > 1e-9
                        or now < cl._reweight_heal_until
                    )
                ):
                    self._rebroadcast_at = now + 2.0
                    cl.rebroadcast_ring()
                # Partition-heal probe: periodically re-announce to
                # peers whose breaker is open; a successful round trip
                # heals the link and migrates their range back.  A
                # lame duck stops probing (it is on its way out), and
                # a DEPARTED peer's closed socket must not be read as
                # a partition to heal — it left on purpose; only its
                # own OP_JOIN re-registers it.
                if cl._lame_duck:
                    continue
                with cl._mu:
                    departed = set(cl._departed)
                for d, peer in enumerate(cl.peers):
                    if peer is None or not peer.breaker_open:
                        continue
                    if d in departed:
                        continue
                    if now < self._reannounce_at.get(d, 0.0):
                        continue
                    self._reannounce_at[d] = now + max(
                        peer.breaker_cooldown_s, 1.0
                    )
                    with cl._handoff_cv:
                        cl._handoff_done.discard(d)
                    if cl.announce_join_to(d):
                        # The link is back: hand their range back (the
                        # symmetric direction of their own re-announce;
                        # our decides gate until their migrate returns
                        # ours).
                        cl.on_join(d)
            except Exception:
                log.exception("cluster pump iteration failed")


class ClusterServer:
    """The RPC listener: peers' forwarded batches decided on the local
    limiter, plus the elastic-lifecycle ops (ring mode) — ownership-
    checked OP_ROUTE_BATCH, OP_MIGRATE/OP_REPLICA state transfer, and
    OP_JOIN/OP_RING membership.  Transport-shaped (start/serve_forever/
    stop) so the server lifecycle treats it like HTTP/gRPC/RESP."""

    name = "cluster"

    def __init__(
        self, host: str, port: int, limiter, limiter_lock, now_fn=None,
        cluster: Optional[ClusterLimiter] = None,
    ) -> None:
        self.host = host
        self.port = port
        self.limiter = limiter
        self.limiter_lock = limiter_lock
        self.now_fn = now_fn
        self.cluster = cluster
        self._server: Optional[asyncio.AbstractServer] = None
        self._conn_tasks: set = set()
        # Lifecycle ops (migrate/replica/join) get their own executor:
        # on the shared default pool a joining node's decide threads —
        # all blocked in _wait_handoff — could starve the very
        # apply_migrate call that releases them.
        self._lifecycle_pool = None
        # Ring-state ops (OP_RING adoption, the OP_JOIN ack snapshot)
        # are pure host work under _mu — milliseconds, never network —
        # but they must not run on the event loop (a contended _mu
        # would stall every connection) NOR share the lifecycle pool
        # (an on_join there can legitimately block on peer I/O for its
        # whole request_lock window, and an ack queued behind it turns
        # into a cross-node join convoy — observed as a breaker heal
        # landing seconds late).  One dedicated worker keeps them both
        # off the loop and unstarvable.
        self._ring_pool = None
        if cluster is not None and cluster.ring is not None:
            from concurrent.futures import ThreadPoolExecutor

            self._lifecycle_pool = ThreadPoolExecutor(
                max_workers=2,
                thread_name_prefix="throttlecrab-cluster-lifecycle",
            )
            self._ring_pool = ThreadPoolExecutor(
                max_workers=1,
                thread_name_prefix="throttlecrab-cluster-ring",
            )

    async def start(self) -> None:
        self._server = await asyncio.start_server(
            self._handle, self.host, self.port
        )
        log.info(
            "cluster RPC listening on %s:%d", self.host, self.port
        )

    async def serve_forever(self) -> None:
        if self._server is None:
            await self.start()
        async with self._server:
            await self._server.serve_forever()

    async def stop(self) -> None:
        if self._server is not None:
            self._server.close()
            for task in list(self._conn_tasks):
                task.cancel()
            try:
                await asyncio.wait_for(
                    self._server.wait_closed(), timeout=2.0
                )
            except asyncio.TimeoutError:
                pass
        if self._lifecycle_pool is not None:
            self._lifecycle_pool.shutdown(wait=False)
        if self._ring_pool is not None:
            self._ring_pool.shutdown(wait=False)

    @property
    def bound_port(self) -> int:
        return self._server.sockets[0].getsockname()[1]

    def _decide_frame(self, keys, params, now_ns, hops: Optional[int],
                      deadlines=None):
        """Decide a forwarded batch (executor thread) and encode the
        reply.  `hops=None` is the legacy decide-all contract; an int
        routes through the cluster's ownership check, which may forward
        non-owned keys onward (membership skew) up to MAX_HOPS.
        `deadlines` (absolute ns in THIS node's clock, 0 = none) sheds
        rows whose client budget ran out in flight."""
        try:
            if hops is None or self.cluster is None:
                with self.limiter_lock:
                    res = self.limiter.rate_limit_batch(
                        keys, params[:, 0], params[:, 1], params[:, 2],
                        params[:, 3], now_ns,
                    )
            else:
                # The ClusterLimiter takes device_lock itself for the
                # locally-owned slice and forwards the rest.
                res = self.cluster.rate_limit_batch(
                    keys, params[:, 0], params[:, 1], params[:, 2],
                    params[:, 3], now_ns, _hops=hops,
                    deadlines_ns=deadlines,
                )
            return encode_reply(
                res.status, res.allowed, res.limit, res.remaining,
                res.reset_after_ns, res.retry_after_ns,
            )
        except Exception:
            log.exception("cluster decide failed")
            n = len(keys)
            zeros = np.zeros(n, np.int64)
            return encode_reply(
                np.full(n, STATUS_INTERNAL, np.uint8),
                np.zeros(n, bool), zeros, zeros, zeros, zeros,
            )

    async def _handle(self, reader, writer) -> None:
        task = asyncio.current_task()
        self._conn_tasks.add(task)
        loop = asyncio.get_running_loop()
        ring_ops = self.cluster is not None and self.cluster.ring is not None
        try:
            while True:
                head = await reader.readexactly(_HDR.size)
                body_len, op = _HDR.unpack(head)
                batch_ops = (OP_THROTTLE_BATCH,)
                if ring_ops:
                    batch_ops = (
                        OP_THROTTLE_BATCH, OP_ROUTE_BATCH, OP_MIGRATE,
                        OP_REPLICA, OP_RING, OP_JOIN, OP_LEAVE,
                        OP_DROUTE_BATCH,
                    )
                if body_len > MAX_FRAME or op not in batch_ops:
                    log.warning("bad cluster frame (op=%d len=%d)", op,
                                body_len)
                    break
                body = await reader.readexactly(body_len)
                cl = self.cluster
                if op == OP_MIGRATE:
                    origin, epoch, mkeys, tats, exps = decode_rows(body)
                    await loop.run_in_executor(
                        self._lifecycle_pool, cl.apply_migrate, origin,
                        epoch, mkeys, tats, exps,
                    )
                    continue  # fire-and-forget: no reply frame
                if op == OP_REPLICA:
                    origin, _epoch, rkeys, tats, exps = decode_rows(body)
                    await loop.run_in_executor(
                        self._lifecycle_pool, cl.apply_replica, origin,
                        rkeys, tats, exps,
                    )
                    continue
                if op == OP_RING:
                    epoch, weights = decode_ring(body)
                    # The ring rebuild (vnodes x nodes hash pass) and
                    # its _mu hold run on the dedicated ring executor,
                    # never the event loop — a decide thread holding
                    # _mu mid-flip would stall every connection this
                    # loop serves.
                    await loop.run_in_executor(
                        self._ring_pool, cl.apply_ring, epoch, weights,
                    )
                    continue
                if op == OP_JOIN:
                    origin = decode_join(body)
                    # Ack first, migrate after: the joiner's handoff
                    # gate (pending until our OP_MIGRATE lands) covers
                    # the window, and an ack that waited on the export
                    # would deadlock two nodes joining each other
                    # (each ack blocked on a migrate whose connection
                    # the other side's announce is still holding).
                    # ring_state takes _mu — off the loop, but on the
                    # DEDICATED ring executor, never the lifecycle
                    # pool: an on_join occupying that pool can block
                    # on peer I/O for its whole request_lock window,
                    # and an ack queued behind it convoys every
                    # concurrent join in the cluster.
                    epoch, weights = await loop.run_in_executor(
                        self._ring_pool, cl.ring_state
                    )
                    writer.write(
                        encode_ring(OP_RING_STATE, epoch, weights)
                    )
                    await writer.drain()
                    await loop.run_in_executor(
                        self._lifecycle_pool, cl.on_join, origin
                    )
                    continue
                if op == OP_LEAVE:
                    origin, epoch = decode_leave(body)
                    # Pure host work under _mu (a ring rebuild), like
                    # apply_ring — the dedicated ring executor keeps
                    # it off the loop and unstarvable.
                    await loop.run_in_executor(
                        self._ring_pool, cl.on_leave, origin, epoch,
                    )
                    continue  # fire-and-forget: no reply frame
                hops: Optional[int] = None
                budgets = None
                if op == OP_DROUTE_BATCH:
                    hops, keys, params, now_ns, budgets = decode_droute(
                        body
                    )
                elif op == OP_ROUTE_BATCH:
                    hops, keys, params, now_ns = decode_route(body)
                else:
                    keys, params, now_ns = decode_batch(body)
                if not limiter_uses_bytes_keys(self.limiter):
                    # surrogateescape keeps arbitrary bytes unique and
                    # lossless while matching str-keyed transports.
                    keys = [
                        k.decode("utf-8", "surrogateescape") for k in keys
                    ]
                if self.now_fn is not None:
                    now_ns = self.now_fn()
                deadlines = None
                if budgets is not None:
                    # Rebase the carried budget onto THIS node's clock
                    # (now_ns was just refreshed) — no cross-node clock
                    # comparison ever happens.  Each hop deducts its
                    # own dwell time before re-forwarding, so the
                    # budget shrinks monotonically across hops.
                    deadlines = np.where(budgets > 0, now_ns + budgets, 0)
                frame = await loop.run_in_executor(
                    None, self._decide_frame, keys, params, now_ns,
                    hops, deadlines,
                )
                writer.write(frame)
                await writer.drain()
        except (asyncio.IncompleteReadError, ConnectionResetError):
            pass
        except asyncio.CancelledError:
            pass
        except ClusterProtocolError as e:
            log.warning("malformed cluster frame: %s", e)
        except Exception:
            log.exception("cluster connection error")
        finally:
            self._conn_tasks.discard(task)
            writer.close()
            try:
                await writer.wait_closed()
            except Exception:
                pass
