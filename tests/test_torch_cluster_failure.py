"""The port's cluster tier under failure, against the JAX package's.

The failure contracts of JAX `tests/test_cluster.py` and the fault-site
tests of `tests/test_cluster_chaos.py`, run on both packages where the
outcome is a value (results, statuses, fired faults, counters) and on the
port alone where it is a time bound: a single node is a passthrough; an
oversized or unencodable key fails only itself; in legacy modulo mode
(`vnodes=0`) a dead peer fails only its own range; a silent peer costs at
most its deadline; the breaker opens, fails fast and lets one probe
through after its cooldown; reconnects back off; the native wire window
delegates only all-local windows; the `peer`, `migrate` and `leave`
fault sites fire where JAX's do, with JAX's consequences; a lame duck
forwards; rows past their deadline shed before any decide or forward.
"""

import socket
import threading
import time

import numpy as np
import pytest

from throttlecrab_tpu import faults as jax_faults
from throttlecrab_tpu.parallel import cluster as jc
from throttlecrab_tpu.tpu.limiter import TpuRateLimiter
from throttlecrab_tpu_torch import faults as port_faults
from throttlecrab_tpu_torch.parallel import cluster as pc
from throttlecrab_tpu_torch.tpu.limiter import (
    STATUS_DEADLINE,
    STATUS_INTERNAL,
    TorchRateLimiter,
)
from torch_cluster import NS, T0, Cluster, Ports, result_planes, wait_for

pytestmark = pytest.mark.filterwarnings("ignore::DeprecationWarning")

PKGS = {
    "jax": (jc, jax_faults, lambda cap, **kw: TpuRateLimiter(capacity=cap,
                                                            **kw)),
    "port": (pc, port_faults,
             lambda cap, **kw: TorchRateLimiter(capacity=cap, device="cpu",
                                                **kw)),
}


def both(fn):
    """fn(cluster module, make limiter) in each package; the outcomes."""
    return {name: fn(mod, make) for name, (mod, _f, make) in PKGS.items()}


def _key_on(n_nodes, node, prefix):
    return next(f"{prefix}:{i}" for i in range(10_000)
                if pc.node_of_key(f"{prefix}:{i}".encode(), n_nodes) == node)


def test_single_node_cluster_is_passthrough():
    keys = [f"k{i % 20}" for i in range(64)]

    def run(mod, make):
        plain = make(256)
        cl = mod.ClusterLimiter(make(256), ["127.0.0.1:1"], 0)
        out = []
        for t, wire in ((T0, False), (T0 + NS, True)):
            a = plain.rate_limit_batch(keys, 5, 100, 60, 1, t, wire=wire)
            b = cl.rate_limit_batch(keys, 5, 100, 60, 1, t, wire=wire)
            assert result_planes(a) == result_planes(b)
            out.append(result_planes(b))
        cl.close()
        return out
    got = both(run)
    assert got["port"] == got["jax"]


@pytest.mark.parametrize("bad", ["x" * 70_000, "\ud800bad"],
                         ids=["oversized", "unencodable"])
def test_bad_key_fails_only_itself_as_in_jax(bad):
    keys = ["ok1", bad, "ok2"]

    def run(mod, make):
        cl = mod.ClusterLimiter(make(64), ["127.0.0.1:1"], 0, vnodes=16)
        res = cl.rate_limit_batch(keys, 5, 100, 60, 1, T0)
        cl.close()
        return result_planes(res)
    got = both(run)
    assert got["port"] == got["jax"]
    allowed, *_, status = got["port"]
    assert allowed == [True, False, True]
    assert status[1] != 0 and status[0] == 0 and status[2] == 0


def test_legacy_modulo_dead_peer_fails_only_its_range():
    remote, local = _key_on(2, 0, "lm"), _key_on(2, 1, "ll")

    def run(mod, make):
        cl = mod.ClusterLimiter(
            make(256), ["127.0.0.1:1", "127.0.0.1:2"], 1,
            io_timeout_s=0.2, connect_timeout_s=0.2)
        assert cl.ring is None and cl._pump is None
        res = cl.rate_limit_batch([remote, local], 5, 100, 60, 1, T0)
        stats = cl.peer_stats()
        cl.close()
        return result_planes(res), stats
    got = both(run)
    assert got["port"] == got["jax"]
    (allowed, *_, status), stats = got["port"]
    assert allowed == [False, True]
    assert status == [STATUS_INTERNAL, 0]
    assert stats["127.0.0.1:1"]["failed"] == 1


def _silent_listener():
    """Accepts and never replies: a hung peer, worse than a dead one."""
    srv = socket.socket()
    srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    srv.bind(("127.0.0.1", 0))
    srv.listen(8)
    conns = []
    stop = threading.Event()

    def loop():
        srv.settimeout(0.2)
        while not stop.is_set():
            try:
                conns.append(srv.accept()[0])
            except OSError:
                continue

    t = threading.Thread(target=loop, daemon=True)
    t.start()

    def close():
        stop.set()
        t.join(timeout=2)
        for c in conns:
            c.close()
        srv.close()
    return srv.getsockname()[1], close


def test_silent_peer_fails_within_deadline_local_keys_unaffected():
    port, close = _silent_listener()
    try:
        cl = pc.ClusterLimiter(
            TorchRateLimiter(capacity=256, device="cpu"),
            [f"127.0.0.1:{port}", "127.0.0.1:1"], 1,
            io_timeout_s=0.3, breaker_failures=99)
        remote, local = _key_on(2, 0, "sp"), _key_on(2, 1, "sl")
        t0 = time.monotonic()
        res = cl.rate_limit_batch([remote, local], 5, 100, 60, 1, T0)
        assert time.monotonic() - t0 < 2.0
        assert res.allowed.tolist() == [False, True]
        assert res.status[0] == STATUS_INTERNAL and res.status[1] == 0
        cl.close()
    finally:
        close()


def test_circuit_breaker_opens_and_recovers_as_in_jax():
    """N consecutive failures open the breaker (fail fast without the
    network); after the cooldown one probe goes through.  The sequence
    of outcomes is JAX's."""
    def run(mod, _make):
        now = [0.0]
        peer = mod.PeerConnection(
            "127.0.0.1", 1, io_timeout_s=0.1, connect_timeout_s=0.1,
            breaker_failures=3, breaker_cooldown_s=5.0,
            clock=lambda: now[0])
        seen = []
        for _ in range(3):
            now[0] += 10.0
            with pytest.raises(OSError) as e:
                peer.send_frame(b"x")
            seen.append(type(e.value).__name__)
            peer.record_failure()
        seen.append(peer.breaker_open)
        with pytest.raises(mod.PeerUnavailable):
            peer.send_frame(b"x")
        now[0] += 5.1
        with pytest.raises(OSError) as e:
            peer.send_frame(b"x")
        seen.append(isinstance(e.value, mod.PeerUnavailable))
        peer.heal()
        seen += [peer.breaker_open, peer.failed, peer.forwarded]
        return seen
    got = both(run)
    assert got["port"] == got["jax"]
    assert got["port"][3] is True and got["port"][4] is False


def test_reconnect_backoff_gates_attempts():
    now = [100.0]
    peer = pc.PeerConnection("127.0.0.1", 1, connect_timeout_s=0.1,
                             breaker_failures=99, clock=lambda: now[0])
    with pytest.raises(OSError):
        peer.send_frame(b"x")
    peer.record_failure()
    with pytest.raises(pc.PeerUnavailable):
        peer.send_frame(b"x")
    now[0] += 0.06  # past the first 50 ms backoff
    with pytest.raises(OSError) as exc:
        peer.send_frame(b"x")
    assert not isinstance(exc.value, pc.PeerUnavailable)


def test_cluster_batch_failfast_when_breaker_open():
    remote, local = _key_on(2, 0, "bf"), _key_on(2, 1, "bl")

    def run(mod, make):
        cl = mod.ClusterLimiter(
            make(256), ["127.0.0.1:1", "127.0.0.1:2"], 1,
            io_timeout_s=0.1, connect_timeout_s=0.1,
            breaker_failures=1, breaker_cooldown_s=60.0)
        cl.rate_limit_batch([local], 5, 100, 60, 1, T0)
        cl.rate_limit_batch([remote], 5, 100, 60, 1, T0)  # opens it
        t0 = time.monotonic()
        res = cl.rate_limit_batch([remote, local], 5, 100, 60, 1, T0 + NS)
        elapsed = time.monotonic() - t0
        stats = cl.peer_stats()
        cl.close()
        return result_planes(res), stats, elapsed < 0.5
    got = both(run)
    assert got["port"][:2] == got["jax"][:2]
    (allowed, *_), stats, fast = got["port"]
    assert allowed == [False, True] and fast
    assert stats["127.0.0.1:1"]["failed"] >= 2


def test_cluster_wire_window_delegates_when_local():
    from throttlecrab_tpu_torch.native import native_available

    assert native_available()

    def frames(keys):
        blob = b"".join(keys)
        offsets = np.zeros(len(keys) + 1, np.int64)
        np.cumsum([len(k) for k in keys], out=offsets[1:])
        params = np.array([[3, 10, 3600, 1]] * len(keys), np.int64)
        return [(blob, offsets, params)]

    def lim():
        return TorchRateLimiter(capacity=128, keymap="native", device="cpu")

    cl1 = pc.ClusterLimiter(lim(), ["127.0.0.1:1"], 0)
    handle = cl1.dispatch_wire_window(frames([b"w:a", b"w:b"]), T0)
    assert handle.fetch()[0].allowed.tolist() == [True, True]
    local_key = _key_on(2, 0, "wl").encode()
    remote_key = _key_on(2, 1, "wr").encode()
    cl2 = pc.ClusterLimiter(lim(), ["127.0.0.1:1", "127.0.0.1:2"], 0,
                            vnodes=0)
    assert cl2.dispatch_wire_window(frames([local_key]), T0) is not None
    assert cl2.dispatch_wire_window(
        frames([local_key, remote_key]), T0) is None
    for c in (cl1, cl2):
        c.close()


def test_peer_fault_site_raises_the_connection_shape_as_in_jax():
    """The `peer` site raises the ConnectionError shape the forwarder's
    breaker and backoff path catch, on send and on receive."""
    got = {}
    for pkg, (mod, flt, _make) in PKGS.items():
        flt.arm(flt.FaultInjector(flt.parse_spec("peer:persistent"),
                                  seed=1))
        try:
            peer = mod.PeerConnection("127.0.0.1", 1)
            shapes = []
            for op in (lambda: peer.send_frame(b"frame"), peer.recv_frame):
                with pytest.raises(ConnectionError) as e:
                    op()
                shapes.append((type(e.value).__name__, str(e.value)))
            got[pkg] = (shapes, flt.active_injector().stats())
        finally:
            flt.disarm()
    assert got["port"] == got["jax"]
    assert got["port"][1]["peer"] >= 1


def _two(pkg, ports, **kw):
    cl = Cluster(ports, [pkg, pkg], **kw)
    cl.boot(0)
    cl.boot(1)
    return cl


def _owned_by(cl, node, prefix):
    ring = cl.nodes[0].cl.ring
    return next(k for k in (f"{prefix}:{i}" for i in range(4000))
                if ring.owner_of(k.encode()) == node)


def _exhaust(node, key, now, burst=2):
    for i in range(burst + 2):
        node.cl.rate_limit_batch([key], burst, 2, 600, 1, now + i)
    return now + burst + 2


def _migrate_fault(pkg, ports):
    """A `migrate` fault loses the join's handoff: the joiner's gate
    expires (handoff_timeouts counts it) and serving goes on."""
    _mod, flt, _ = PKGS[pkg]
    cl = Cluster(ports, [pkg, pkg], handoff_timeout_s=0.5)
    try:
        a = cl.boot(0)
        keys = [f"mf:{i}" for i in range(64)]
        a.cl.rate_limit_batch(keys, 4, 10, 60, 1, T0)
        flt.arm(flt.FaultInjector(flt.parse_spec("migrate:persistent"),
                                  seed=7))
        b = cl.boot(1, join=False)
        b.cl.announce_join_all()
        res = b.cl.rate_limit_batch(keys, 4, 10, 60, 1, T0 + NS)
        fired = flt.active_injector().stats()
        return (result_planes(res), b.cl.handoff_timeouts, fired,
                b.cl.migrated_in)
    finally:
        flt.disarm()
        cl.close()


def _leave_fault(pkg, ports):
    """A `leave` fault breaks the announcement: leave() says so, and the
    kill path's takeover still serves the range from the replica."""
    _mod, flt, _ = PKGS[pkg]
    cl = _two(pkg, ports)
    try:
        a, b = cl.nodes
        hot = _owned_by(cl, 1, "lf")
        now = _exhaust(b, hot, T0)
        cl.quiesce()
        assert hot.encode() in a.cl.replica_store
        flt.arm(flt.FaultInjector(flt.parse_spec("leave:persistent"),
                                  seed=3))
        left = b.cl.leave()
        fired = flt.active_injector().stats()
        flt.disarm()
        cl.kill(1)
        res = a.cl.rate_limit_batch([hot], 2, 2, 600, 1, now)
        return left, fired, result_planes(res), a.cl.takeover_count
    finally:
        flt.disarm()
        cl.close()


@pytest.mark.parametrize("drill", [_migrate_fault, _leave_fault],
                         ids=["migrate", "leave"])
def test_fault_site_fires_as_in_jax(drill):
    ports = Ports(2)
    got = {pkg: drill(pkg, ports) for pkg in ("jax", "port")}
    assert got["port"] == got["jax"]
    if drill is _migrate_fault:
        planes, timeouts, fired, migrated = got["port"]
        assert all(s == 0 for s in planes[-1]) and timeouts >= 1
        assert fired.get("migrate", 0) >= 1 and migrated == 0
    else:
        left, fired, planes, takeovers = got["port"]
        assert left is False and fired.get("leave", 0) >= 1
        assert planes[-1] == [0] and planes[0] == [False]
        assert takeovers == 1


def _lame_duck(pkg, ports):
    cl = _two(pkg, ports)
    try:
        a, b = cl.nodes
        keys = [f"ld:{i}" for i in range(16)]
        first = a.cl.rate_limit_batch(keys, 4, 10, 60, 1, T0)
        assert a.cl.leave()
        cl.quiesce()
        fwd0 = a.cl.peers[1].forwarded
        res = a.cl.rate_limit_batch(keys, 4, 10, 60, 1, T0 + NS)
        return (result_planes(first), result_planes(res),
                a.cl.peers[1].forwarded - fwd0, a.cl._lame_duck,
                b.cl.cluster_view()["leaves"])
    finally:
        cl.close()


def test_lame_duck_forwards_not_decides_as_in_jax():
    ports = Ports(2)
    got = {pkg: _lame_duck(pkg, ports) for pkg in ("jax", "port")}
    assert got["port"] == got["jax"]
    _first, (allowed, _lim, remaining, *_r, status), fwd, lame, leaves = (
        got["port"])
    assert all(allowed) and set(status) == {0}
    assert remaining == [2] * 16  # the handoff carried the first hit
    assert fwd >= 1 and lame and leaves == 1


def _deadline(pkg, ports):
    cl = _two(pkg, ports)
    try:
        a, b = cl.nodes
        pool = [f"dl:{i}" for i in range(32)]
        out = [result_planes(a.cl.rate_limit_batch(pool, 4, 10, 60, 1, T0))]
        now = T0 + NS
        dl = np.zeros(len(pool), np.int64)
        dl[::2] = now - 1
        dl[1::2] = now + 5 * NS
        out.append(result_planes(a.cl.rate_limit_batch(
            pool, 4, 10, 60, 1, now, deadlines_ns=dl)))
        for i, via in enumerate((b, a)):
            out.append(result_planes(via.cl.rate_limit_batch(
                pool, 4, 10, 60, 1, now + (i + 1) * NS)))
        return out
    finally:
        cl.close()


def test_deadline_shed_as_in_jax():
    """Rows past their client deadline shed with STATUS_DEADLINE before
    any decide or forward, and consume nothing."""
    ports = Ports(2)
    got = {pkg: _deadline(pkg, ports) for pkg in ("jax", "port")}
    assert got["port"] == got["jax"]
    shed = got["port"][1]
    assert set(shed[-1][::2]) == {STATUS_DEADLINE}
    assert set(shed[-1][1::2]) == {0} and not any(shed[0][::2])
    # The live half spent one token, the shed half none.
    assert shed[2][1::2] == [2] * 16 and got["port"][2][2][::2] == [2] * 16


def test_breaker_open_failover_is_fast():
    cl = _two("port", Ports(2))
    try:
        a = cl.nodes[0]
        key = _owned_by(cl, 1, "bo")
        cl.kill(1)
        wait_for(lambda: a.cl.peers[1].breaker_open, "the breaker")
        t0 = time.monotonic()
        res = a.cl.rate_limit_batch([key], 5, 100, 60, 1, T0 + 10)
        assert res.status[0] == 0
        assert time.monotonic() - t0 < 0.5
    finally:
        cl.close()


def _degrade_reweight(pkg, ports):
    """run_server's wiring: a degraded node announces weight 0.5 through
    the pump, its re-promotion 1.0; the peer adopts each ring."""
    from throttlecrab_tpu.server.supervisor import (
        SupervisedLimiter as JaxSupervised,
    )
    from throttlecrab_tpu_torch.server.supervisor import SupervisedLimiter

    _mod, flt, _ = PKGS[pkg]
    sup_cls = JaxSupervised if pkg == "jax" else SupervisedLimiter
    sups = []

    def wrap(_pkg, lim):
        sups.append(sup_cls(lim, retries=0, probe_interval_ms=1,
                            sleep_fn=lambda s: None))
        return sups[-1]
    cl = Cluster(ports, [pkg, pkg], wrap=wrap)
    try:
        a, b = cl.boot(0), cl.boot(1)
        sup = sups[0]
        sup.on_degrade = lambda: a.cl.schedule_reweight(0.5)
        sup.on_repromote = lambda: a.cl.schedule_reweight(1.0)
        key = _owned_by(cl, 0, "dg")
        seen = []
        flt.arm(flt.FaultInjector(flt.parse_spec("launch:count:1"), seed=3))
        res = a.cl.rate_limit_batch([key], 5, 100, 60, 1, T0)
        flt.disarm()
        seen.append((sup.state, result_planes(res)))
        wait_for(lambda: b.cl.cluster_view()["weights"] == [0.5, 1.0],
                 "the peer to adopt weight 0.5")
        cl.quiesce()
        seen.append((a.cl.cluster_view()["weights"],
                     b.cl.cluster_view()["epoch"]))
        # A key node 0 still owns at weight 0.5: its decide is the one
        # that probes the device and re-promotes.
        key = next(k for k in (f"dg2:{i}" for i in range(4000))
                   if a.cl.ring.owner_of(k.encode()) == 0)
        res = a.cl.rate_limit_batch([key], 5, 100, 60, 1, T0 + NS)
        seen.append((sup.state, result_planes(res)))
        wait_for(lambda: b.cl.cluster_view()["weights"] == [1.0, 1.0],
                 "the peer to adopt weight 1.0")
        cl.quiesce()
        return seen
    finally:
        flt.disarm()
        cl.close()


def test_degrade_reweights_the_ring_as_in_jax():
    ports = Ports(2)
    got = {pkg: _degrade_reweight(pkg, ports) for pkg in ("jax", "port")}
    assert got["port"] == got["jax"]
    assert got["port"][0][0] == "degraded" and got["port"][2][0] == "ok"
    assert got["port"][1][0] == [0.5, 1.0]
