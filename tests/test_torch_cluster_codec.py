"""The cluster's wire codecs and hash ring, port against JAX.

Every `encode_*` of the port's `parallel/cluster.py` gives the JAX
package's bytes for the same seeded inputs, every `decode_*` gives the
same values for a good frame and refuses the same malformed frames
(truncations at every length, inflated counts, trailing bytes) with the
typed `ClusterProtocolError`.  The ring (`parallel/ring.py`) places the
same points and gives the same owners, successors and weight vectors for
the same node list, weights and vnodes, also after a reweight and with
excluded nodes; legacy modulo routing (`node_of_key`) agrees key for key.
"""

import struct

import numpy as np
import pytest

from throttlecrab_tpu.parallel import cluster as jc
from throttlecrab_tpu.parallel import ring as jr
from throttlecrab_tpu.parallel.sharded import shard_of_key
from throttlecrab_tpu_torch.parallel import cluster as pc
from throttlecrab_tpu_torch.parallel import ring as pr

NS = 1_000_000_000
T0 = 1_700_000_000 * NS


def _keys(rng, n, max_len=40):
    return [bytes(rng.integers(0, 256, int(rng.integers(0, max_len)),
                               dtype=np.uint8)) for _ in range(n)]


def _frames(seed):
    """(name, encoder args) for every encoder, from one seed."""
    rng = np.random.default_rng(seed)
    n = int(rng.integers(0, 12))
    keys = _keys(rng, n) + [b"", "ünïcode".encode(), b"x" * 300]
    n = len(keys)
    params = rng.integers(-(1 << 62), 1 << 62, (n, 4))
    tats = rng.integers(-(1 << 62), 1 << 62, n)
    exps = rng.integers(-(1 << 62), 1 << 62, n)
    budgets = np.where(rng.random(n) < 0.3, 0,
                       rng.integers(0, 1 << 40, n))
    now = int(rng.integers(0, 1 << 62))
    status = rng.integers(0, 7, n).astype(np.uint8)
    allowed = rng.random(n) < 0.5
    rep = [rng.integers(-(1 << 62), 1 << 62, n) for _ in range(4)]
    weights = [float(w) for w in rng.choice([0.0, 0.25, 0.5, 1.0], 5)]
    return [
        ("batch", (keys, params, now)),
        ("route", (keys, params, now, int(rng.integers(0, 4)))),
        ("droute", (keys, params, now, int(rng.integers(0, 4)), budgets)),
        ("reply", (status, allowed, *rep)),
        ("migrate", (jc.OP_MIGRATE, int(rng.integers(0, 8)),
                     int(rng.integers(0, 1 << 32)), keys, tats, exps)),
        ("replica", (jc.OP_REPLICA, 1, 0, keys, tats, exps)),
        ("ring", (jc.OP_RING, int(rng.integers(0, 1 << 32)), weights)),
        ("ring-state", (jc.OP_RING_STATE, 3, weights)),
        ("join", (int(rng.integers(0, 256)),)),
        ("leave", (int(rng.integers(0, 256)),
                   int(rng.integers(0, 1 << 32)))),
    ]


ENCODER = {"batch": "encode_batch", "route": "encode_route",
           "droute": "encode_droute", "reply": "encode_reply",
           "migrate": "encode_rows", "replica": "encode_rows",
           "ring": "encode_ring", "ring-state": "encode_ring",
           "join": "encode_join", "leave": "encode_leave"}
DECODER = {"batch": "decode_batch", "route": "decode_route",
           "droute": "decode_droute", "reply": "decode_reply",
           "migrate": "decode_rows", "replica": "decode_rows",
           "ring": "decode_ring", "ring-state": "decode_ring",
           "join": "decode_join", "leave": "decode_leave"}


def _norm(v):
    """A decoded value as plain Python (arrays and records to lists)."""
    if isinstance(v, tuple):
        return tuple(_norm(x) for x in v)
    if isinstance(v, np.ndarray):
        if v.dtype.names:
            return [tuple(r) for r in v.tolist()]
        return v.tolist()
    if isinstance(v, list):
        return [_norm(x) for x in v]
    return v


def _decode(mod, kind, body):
    try:
        return ("ok", _norm(getattr(mod, DECODER[kind])(body)))
    except mod.ClusterProtocolError as e:
        return ("refused", str(e))


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("kind", sorted(ENCODER))
def test_encoder_bytes_and_decode_equal_jax(kind, seed):
    args = dict(_frames(seed))[kind]
    jf = getattr(jc, ENCODER[kind])(*args)
    pf = getattr(pc, ENCODER[kind])(*args)
    assert pf == jf
    body = jf[pc._HDR.size:]
    assert pc._HDR.unpack(jf[:pc._HDR.size])[0] == len(body)
    got = _decode(pc, kind, body)
    assert got == _decode(jc, kind, body)
    assert got[0] == "ok"


@pytest.mark.parametrize("kind", sorted(ENCODER))
def test_malformed_frames_refused_as_in_jax(kind):
    """Every truncation of a good body, the body with trailing bytes,
    and the body with its leading count inflated: each decodes to the
    same values or is refused with the same message in both packages."""
    args = dict(_frames(99))[kind]
    body = getattr(jc, ENCODER[kind])(*args)[jc._HDR.size:]
    bad = [body[:i] for i in range(len(body))]
    bad += [body + b"\x00", body + b"\x00" * 9]
    for off in range(0, min(len(body), 8)):
        # A count field overwritten by a huge value must never size an
        # allocation: the decoders compare it against the frame first.
        bad.append(body[:off] + b"\xff\xff\xff\xff" + body[off + 4:])
    refused = 0
    for b in bad:
        want = _decode(jc, kind, b)
        assert _decode(pc, kind, b) == want, (kind, len(b))
        refused += want[0] == "refused"
    assert refused >= len(body) // 2


def test_frame_decoders_table_equals_jax():
    assert {op: name for op, (name, _f) in pc.FRAME_DECODERS.items()} == {
        op: name for op, (name, _f) in jc.FRAME_DECODERS.items()}
    for name in ("MAX_FRAME", "MAX_KEY_BYTES", "MAX_HOPS", "OP_MIGRATE",
                 "OP_RING", "OP_JOIN", "OP_RING_STATE", "OP_REPLICA",
                 "OP_ROUTE_BATCH", "OP_LEAVE", "OP_DROUTE_BATCH",
                 "OP_THROTTLE_BATCH", "OP_THROTTLE_REPLY"):
        assert getattr(pc, name) == getattr(jc, name), name


def test_frame_roundtrip():
    keys = [b"alpha", b"b" * 300, b"", "ünïcode".encode()]
    params = [(10, 100, 60, 1), (5, 50, 30, 2), (1, 1, 1, 0),
              (2 ** 40, 2 ** 41, 2 ** 42, 2 ** 43)]
    frame = pc.encode_batch(keys, params, T0)
    dkeys, dparams, dnow = pc.decode_batch(frame[5:])
    assert dkeys == keys
    assert dparams.tolist() == [list(p) for p in params]
    assert dnow == T0


def test_malformed_counts_refused():
    with pytest.raises(pc.ClusterProtocolError):
        pc.decode_batch(pc._REQ_HEAD.pack(0xFFFFFFFF, T0))
    with pytest.raises(pc.ClusterProtocolError):
        pc.decode_reply(pc._REP_HEAD.pack(0xFFFFFFFF))
    with pytest.raises(pc.ClusterProtocolError):
        pc.decode_reply(pc._REP_HEAD.pack(2) + b"\x00" * 10)
    bad = pc._REQ_HEAD.pack(1, T0) + struct.pack("<H", 500) + b"k"
    with pytest.raises(pc.ClusterProtocolError):
        pc.decode_batch(bad)
    with pytest.raises(pc.ClusterProtocolError):
        pc.decode_rows(pc._ROWS_HEAD.pack(0, 0, 0xFFFFFFFF))
    with pytest.raises(pc.ClusterProtocolError):
        pc.decode_route(b"")
    assert pc._HDR.size == 5


def test_leave_and_droute_roundtrip_and_harden():
    frame = pc.encode_leave(3, 17)
    assert pc.decode_leave(frame[5:]) == (3, 17)
    with pytest.raises(pc.ClusterProtocolError):
        pc.decode_leave(frame[5:-1])
    keys = [b"a", b"bb", b"ccc"]
    params = np.array([[4, 10, 60, 1], [5, 11, 61, 2], [6, 12, 62, 3]])
    budgets = np.array([7 * NS, 0, 3 * NS], np.int64)
    frame = pc.encode_droute(keys, params, T0, 2, budgets)
    hops, k2, p2, now2, b2 = pc.decode_droute(frame[5:])
    assert hops == 2 and k2 == keys and now2 == T0
    np.testing.assert_array_equal(p2, params)
    np.testing.assert_array_equal(b2, budgets)
    for cut in (1, 10, 30):
        with pytest.raises(pc.ClusterProtocolError):
            pc.decode_droute(frame[5:-cut])


# ---------------------------------------------------------------- ring #

RINGS = [
    (3, 128, {}), (5, 64, {2: 0.5}), (2, 8, {0: 0.0}),
    (4, 128, {1: 0.25, 3: 0.75}), (1, 16, {}), (7, 32, {6: 0.5, 0: 0.1}),
]


@pytest.mark.parametrize("n,vnodes,weights", RINGS,
                         ids=[f"n{r[0]}-v{r[1]}-w{len(r[2])}" for r in RINGS])
def test_ring_points_and_owners_equal_jax(n, vnodes, weights):
    nodes = [f"10.0.{i}.7:{9000 + i}" for i in range(n)]
    jring = jr.HashRing(nodes, vnodes, weights=weights)
    pring = pr.HashRing(nodes, vnodes, weights=weights)
    np.testing.assert_array_equal(pring._points, jring._points)
    np.testing.assert_array_equal(pring._owners, jring._owners)
    assert pring.weight_vector() == jring.weight_vector()
    assert len(pring) == len(jring)
    rng = np.random.default_rng(n * 1000 + vnodes)
    keys = _keys(rng, 3000) + [b"k:%d" % i for i in range(500)]
    crcs = pr.batch_crc32(keys)
    np.testing.assert_array_equal(crcs, jr.batch_crc32(keys))
    np.testing.assert_array_equal(pring.owners_of(crcs),
                                  jring.owners_of(crcs))
    for k in keys[:200]:
        assert pring.owner_of(k) == jring.owner_of(k)
    live = [i for i in range(n) if jring.weights[i] > 0]
    for dead in live[:-1]:
        ex = frozenset({dead})
        np.testing.assert_array_equal(pring.owners_of(crcs, exclude=ex),
                                      jring.owners_of(crcs, exclude=ex))
        for k in keys[:50]:
            assert pring.successor_of(k, dead) == jring.successor_of(k, dead)
    if len(live) > 2:
        ex = frozenset(live[:2])
        np.testing.assert_array_equal(pring.owners_of(crcs, exclude=ex),
                                      jring.owners_of(crcs, exclude=ex))
    # A reweight builds the same new ring.
    for node, w in ((0, 0.5), (n - 1, 0.25), (0, 1.0)):
        jring2 = jring.with_weight(node, w)
        pring2 = pring.with_weight(node, w)
        assert pring2.weight_vector() == jring2.weight_vector()
        np.testing.assert_array_equal(pring2.owners_of(crcs),
                                      jring2.owners_of(crcs))


def test_ring_refusals_as_in_jax():
    for args, kw in ((([], 8), {}), ((["a:1"], 0), {}),
                     ((["a:1"], 8), {"weights": {0: 1.5}}),
                     ((["a:1"], 8), {"weights": {0: 0.0}})):
        with pytest.raises(ValueError) as je:
            jr.HashRing(*args, **kw)
        with pytest.raises(ValueError) as pe:
            pr.HashRing(*args, **kw)
        assert str(pe.value) == str(je.value)
    ring = pr.HashRing(["a:1", "b:2"], 8)
    with pytest.raises(ValueError, match="every ring node excluded"):
        ring.owners_of(pr.batch_crc32([b"k"]), exclude=frozenset({0, 1}))


def test_ring_vectorized_matches_oracle_and_excludes():
    nodes = [f"10.0.0.{i}:9000" for i in range(5)]
    ring = pr.HashRing(nodes, 128)
    keys = [b"rk:%d" % i for i in range(3000)]
    owners = ring.owners_of(pr.batch_crc32(keys))
    counts = np.bincount(owners, minlength=5)
    assert counts.min() > 300, counts
    o2 = ring.owners_of(pr.batch_crc32(keys), exclude=frozenset({2}))
    moved = owners != o2
    assert (owners[moved] == 2).all() and (o2 != 2).all()
    o4 = pr.HashRing(nodes[:4], 128).owners_of(pr.batch_crc32(keys))
    assert (o4 == owners).mean() > 0.70


@pytest.mark.parametrize("n_nodes", [1, 2, 3, 4, 7])
def test_node_of_key_equals_jax(n_nodes):
    rng = np.random.default_rng(n_nodes)
    keys = _keys(rng, 2000) + [b"user:%d" % i for i in range(2000)]
    assert [pc.node_of_key(k, n_nodes) for k in keys] == [
        jc.node_of_key(k, n_nodes) for k in keys]
    if n_nodes == 2:
        # Decorrelated from the device-shard hash: node 0's keys still
        # spread over 2 local shards.
        node0 = [k for k in keys if pc.node_of_key(k, 2) == 0]
        local = np.bincount([shard_of_key(k, 2) for k in node0],
                            minlength=2)
        assert local.min() > len(node0) // 4
