"""Shared helpers of the cluster tests: in-process cluster nodes of either
package, driven over real TCP on the same ports, so the port's cluster
can be held against the JAX package's on the same seeded traffic.

A node is one limiter (`TpuRateLimiter`, or the port's `TorchRateLimiter`
on the CPU), one `ClusterLimiter` and one `ClusterServer` on a dedicated
event-loop thread: the shape of the JAX chaos suite's `Node` and of the
replay player's `_ReplayNode`.  Both packages speak one wire format, so a
cluster may mix them.

The cluster's background pump re-broadcasts weights every 2 s and probes
dead peers every cooldown; both timers are frozen here, in both packages
alike, and a kill is followed by one such probe from each survivor, so
every counter is a function of the traffic and the lifecycle steps
alone.  `quiesce` then waits, by condition and with a deadline,
until every replica push and every migration sent has been applied by its
receiver, and `settle` until every joiner's handoff gate has drained.
"""

import asyncio
import collections
import socket
import threading
import time

import numpy as np

from throttlecrab_tpu.parallel import cluster as jax_cluster
from throttlecrab_tpu.tpu import snapshot as jax_snapshot
from throttlecrab_tpu.tpu.limiter import TpuRateLimiter
from throttlecrab_tpu_torch.parallel import cluster as port_cluster
from throttlecrab_tpu_torch.tpu import snapshot as port_snapshot
from throttlecrab_tpu_torch.tpu.limiter import TorchRateLimiter

NS = 1_000_000_000
T0 = 1_760_000_000 * NS
CAP = 2048
INF = float("inf")

PACKAGES = {
    "jax": (jax_cluster, jax_snapshot,
            lambda cap: TpuRateLimiter(capacity=cap)),
    "port": (port_cluster, port_snapshot,
             lambda cap: TorchRateLimiter(capacity=cap, device="cpu")),
}
WIRE_FIELDS = ("allowed", "limit", "remaining", "reset_after_s",
               "retry_after_s", "status")
NS_FIELDS = ("allowed", "limit", "remaining", "reset_after_ns",
             "retry_after_ns", "status")


def free_ports(n: int):
    """`n` port numbers that were free when asked (the sockets are
    closed): for a process that binds them itself."""
    socks = [socket.socket() for _ in range(n)]
    try:
        for s in socks:
            s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            s.bind(("127.0.0.1", 0))
        return [s.getsockname()[1] for s in socks]
    finally:
        for s in socks:
            s.close()


class Ports(list):
    """The port numbers of one `Cluster`'s nodes, each held by a bound,
    non-listening socket whenever no node of the cluster serves it.

    A connection to a held port is refused, exactly as a dead node's
    is; and while it is held no other process can be handed it (a
    `bind(("", 0))` elsewhere, an ephemeral client port) between a
    node's kill and its next boot, or between two clusters on the same
    ports.  `Cluster` releases a port right before its index boots and
    holds it again once the node is down; `close()` (or dropping the
    object) releases them all."""

    def __init__(self, n: int):
        socks = [self._bind(0) for _ in range(n)]
        super().__init__(s.getsockname()[1] for s in socks)
        self._held = dict(enumerate(socks))

    @staticmethod
    def _bind(port: int) -> socket.socket:
        s = socket.socket()
        # SO_REUSEADDR: the port may still carry a dead node's TIME_WAIT
        # connections; a bound socket that never listens keeps the port
        # out of every other socket's automatic choice all the same.
        s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        s.bind(("127.0.0.1", port))
        return s

    def hold(self, i: int) -> None:
        if i not in self._held:
            self._held[i] = self._bind(self[i])

    def release(self, i: int) -> None:
        s = self._held.pop(i, None)
        if s is not None:
            s.close()

    def close(self) -> None:
        for i in list(self._held):
            self.release(i)

    def __del__(self):
        self.close()


def wait_for(cond, what, deadline_s=60.0):
    """Poll `cond()` until true; fail loudly at the deadline."""
    t_end = time.monotonic() + deadline_s
    while time.monotonic() < t_end:
        if cond():
            return
        time.sleep(0.005)
    raise AssertionError(f"timed out waiting for {what}")


class Node:
    """One in-process cluster node of package `pkg` ("jax" or "port")."""

    def __init__(self, pkg, index, nodes, capacity=CAP, wrap=None, **kw):
        """`wrap(pkg, limiter)`, when given, returns what the cluster
        tier wraps instead of the bare limiter (a supervisor)."""
        cmod, smod, make = PACKAGES[pkg]
        kw.setdefault("vnodes", 64)
        kw.setdefault("replicate", True)
        kw.setdefault("io_timeout_s", 120.0)
        kw.setdefault("handoff_timeout_s", 120.0)
        kw.setdefault("breaker_failures", 1)
        kw.setdefault("breaker_cooldown_s", 600.0)
        self.pkg, self.index, self.snapshot = pkg, index, smod
        self.limiter = make(capacity)
        # First-touch compile (JAX) outside any cluster deadline; the
        # port's node takes the same key so both tables hold it.
        self.limiter.rate_limit_batch(["__warm__"], 5, 100, 60, 1, T0 - NS)
        local = self.limiter if wrap is None else wrap(pkg, self.limiter)
        self.cl = cmod.ClusterLimiter(local, nodes, index, **kw)
        self._instrument()
        port = int(nodes[index].rpartition(":")[2])
        self.srv = cmod.ClusterServer(
            "127.0.0.1", port, self.cl.local, self.cl.device_lock,
            cluster=self.cl,
        )
        self.loop = asyncio.new_event_loop()
        self._thread = threading.Thread(
            target=self._run, name=f"{pkg}-node{index}", daemon=True)
        self._thread.start()
        asyncio.run_coroutine_threadsafe(
            self.srv.start(), self.loop).result(timeout=10)
        self.dead = False

    def _run(self):
        asyncio.set_event_loop(self.loop)
        self.loop.run_forever()

    def _instrument(self):
        """Count what the pump submits and flushes, the replica and
        migrate frames this node sends per destination, and the frames
        it applies per origin; freeze the pump's timers."""
        cl = self.cl
        self.submitted = 0
        self.flushed = 0
        self.sent = collections.Counter()      # (kind, dest) -> frames
        self.applied = collections.Counter()   # (kind, origin) -> frames
        mu = threading.Lock()
        pump = cl._pump
        if pump is not None:
            pump._rebroadcast_at = INF
            pump._reannounce_at.update(
                {d: INF for d in range(len(cl.nodes))})
            submit = pump.submit

            def counted_submit(entry):
                with mu:
                    self.submitted += 1
                submit(entry)
            pump.submit = counted_submit
        flush = cl._flush_replicas

        def counted_flush(entries):
            try:
                flush(entries)
            finally:
                with mu:
                    self.flushed += len(entries)
        cl._flush_replicas = counted_flush

        def sender(kind, fn):
            def wrapped(dest, *a, **k):
                ok = fn(dest, *a, **k)
                if ok:
                    with mu:
                        self.sent[kind, dest] += 1
                return ok
            return wrapped
        cl._push_replica_rows = sender("replica", cl._push_replica_rows)
        cl._send_migrate = sender("migrate", cl._send_migrate)

        def receiver(kind, fn):
            def wrapped(origin, *a, **k):
                try:
                    return fn(origin, *a, **k)
                finally:
                    with mu:
                        self.applied[kind, origin] += 1
            return wrapped
        cl.apply_replica = receiver("replica", cl.apply_replica)
        cl.apply_migrate = receiver("migrate", cl.apply_migrate)

    def kill(self):
        """Hard stop: listener down, pump stopped, sockets dropped.  Every
        thread the node ran is joined, so none can reconnect to a later
        run's node on the same port with a stale frame."""
        if self.dead:
            return
        self.dead = True
        asyncio.run_coroutine_threadsafe(
            self.srv.stop(), self.loop).result(timeout=10)
        self.cl.close()
        for pool in (self.srv._lifecycle_pool, self.srv._ring_pool):
            if pool is not None:
                pool.shutdown(wait=True)
        if self.cl._pump is not None:
            self.cl._pump.join(timeout=30)
        asyncio.run_coroutine_threadsafe(
            self.loop.shutdown_default_executor(), self.loop
        ).result(timeout=30)
        self.loop.call_soon_threadsafe(self.loop.stop)
        self._thread.join(timeout=5)
        self.cl.close()  # sockets a drained thread may have reopened

    def state(self) -> dict:
        """The node's table as key bytes -> (tat, expiry), through the
        package's own export_state (the row kernels' path on a card)."""
        keys, _s, _sh, tat, exp, _c, _d = self.snapshot.export_state(
            self.cl.local)
        kb = [k if isinstance(k, bytes) else k.encode() for k in keys]
        return dict(zip(kb, zip(np.asarray(tat).tolist(),
                                np.asarray(exp).tolist())))


class Cluster:
    """Up to N nodes on the held ports of one `Ports`; a node index may mix
    packages."""

    def __init__(self, ports: Ports, pkgs, **kw):
        self.ports = ports
        self.nodes_spec = [f"127.0.0.1:{p}" for p in ports]
        self.pkgs = list(pkgs)
        self.kw = kw
        self.nodes = [None] * len(ports)

    def boot(self, i, join=True):
        self.ports.release(i)
        node = Node(self.pkgs[i], i, self.nodes_spec, **self.kw)
        for other in self.live():
            # A fresh incarnation of `i` counts from zero: frames sent to
            # the old one are not its to apply, and frames the old one
            # sent (all applied before it died) are not its sends.
            for kind in ("replica", "migrate"):
                other.sent.pop((kind, i), None)
                other.applied.pop((kind, i), None)
        self.nodes[i] = node
        if join:
            self.join(i)
        self.probe_absent()
        return node

    def join(self, i):
        """announce_join_all for node `i`, one peer at a time: each
        peer's migrate lands before the next peer hears the announcement,
        so the order in which overlapping rows (a peer's table row and
        another's replica of it) reach the joiner, and with it the
        reconcile count, is fixed."""
        node = self.nodes[i]
        with node.cl._handoff_cv:
            node.cl._handoff_done.clear()
        for d in sorted(n.index for n in self.live() if n is not node):
            assert node.cl.announce_join_to(d)
            wait_for(lambda: d not in node.cl._pending_from,
                     f"the migrate from node {d}")
        self.settle()

    def probe_absent(self):
        """Each live node probes each index that is not up, as the pump's
        partition-heal probe would: the refused connection opens its
        breaker (one failure) before traffic can race a replica push
        against a forward to it."""
        up = {n.index for n in self.live()}
        for n in self.live():
            for d in range(len(self.nodes)):
                if d in up or n.cl.peers[d].breaker_open:
                    continue
                assert not n.cl.announce_join_to(d, register_pending=False)
                assert n.cl.peers[d].breaker_open

    def live(self):
        return [n for n in self.nodes if n is not None and not n.dead]

    def kill(self, i):
        """Kill node `i`, then let each survivor probe it once, as the
        pump's partition-heal probe would: the refused connection opens
        the breaker (one failure) before any traffic races a replica
        push against a forward to the dead peer."""
        self.quiesce()
        self.nodes[i].kill()
        self.nodes[i] = None
        self.ports.hold(i)
        self.probe_absent()

    def settle(self):
        wait_for(lambda: all(not n.cl._pending_from for n in self.live()),
                 "handoff gates to drain")

    def quiesce(self):
        """Every submitted replica entry flushed, every frame sent to a
        live node applied there."""
        live = {n.index: n for n in self.live()}

        def done():
            for n in live.values():
                pump = n.cl._pump
                drops = n.cl.replica_drops
                if pump is not None and (
                    n.submitted != n.flushed + drops or pump._queue
                ):
                    return False
                for (kind, dest), k in list(n.sent.items()):
                    if dest in live and (
                        live[dest].applied[kind, n.index] < k
                    ):
                        return False
            return True
        wait_for(done, "replica and migrate frames to land")

    def close(self):
        for i, n in enumerate(self.nodes):
            if n is not None:
                try:
                    n.kill()
                except Exception:
                    pass
            self.ports.hold(i)


def result_planes(res):
    """A batch result as a tuple of lists, every field of its tier."""
    fields = WIRE_FIELDS if hasattr(res, "reset_after_s") else NS_FIELDS
    return tuple(np.asarray(getattr(res, f)).tolist() for f in fields)


def node_record(node) -> dict:
    """Everything the differential tests compare about one node."""
    cl = node.cl
    with cl._replica_mu:
        replica = sorted(cl.replica_store.items())
    view = cl.cluster_view()
    return {
        "state": sorted(node.state().items()),
        "replica": replica,
        "view": view,
    }


def seeded_traffic(seed, n_keys, n_batches, batch):
    """Per batch (keys, burst, count, period, quantity): a key keeps its
    params, quantities 0..2 (0 probes without spending)."""
    rng = np.random.default_rng(seed)
    pool = [f"ck{seed}:{i}" for i in range(n_keys)]
    burst = rng.integers(1, 6, n_keys)
    count = rng.integers(1, 20, n_keys)
    period = rng.choice([1, 10, 60, 600], n_keys)
    out = []
    for _ in range(n_batches):
        ix = rng.integers(0, n_keys, batch)
        q = rng.integers(0, 3, n_keys)[ix]
        out.append(([pool[i] for i in ix], burst[ix], count[ix],
                     period[ix], q))
    return out


def _drive(cl, traffic, now, via, wire_every=3):
    """Each batch through the frontends in `via`, round robin; every
    `wire_every`-th batch through rate_limit_many(wire=True)."""
    out = []
    for i, (keys, b, c, p, q) in enumerate(traffic):
        node = cl.nodes[via[i % len(via)]]
        if i % wire_every == wire_every - 1:
            res = node.cl.rate_limit_many(
                [(keys, b, c, p, q, now)], wire=True)[0]
        else:
            res = node.cl.rate_limit_batch(keys, b, c, p, q, now)
        out.append(result_planes(res))
        now += NS // 5
    return out, now


def _records(cl):
    cl.quiesce()
    return {n.index: node_record(n) for n in cl.live()}


def run_lifecycle(pkgs, ports, seed=11):
    """Boot 0 and 1, join 2 under load, kill 1, rejoin 1, reweight 2 to
    0.5, leave 0; returns [(step, batch results, node records)]."""
    traffic = seeded_traffic(seed, n_keys=40, n_batches=36, batch=32)
    chunks = [traffic[i:i + 6] for i in range(0, 36, 6)]
    cl = Cluster(ports, pkgs)
    steps = []
    now = T0
    try:
        cl.boot(0)
        cl.boot(1)
        res, now = _drive(cl, chunks[0], now, [0, 1])
        steps.append(("boot", res, _records(cl)))
        cl.boot(2)
        res, now = _drive(cl, chunks[1], now, [0, 1, 2])
        steps.append(("join", res, _records(cl)))
        cl.kill(1)
        res, now = _drive(cl, chunks[2], now, [0, 2])
        steps.append(("kill", res, _records(cl)))
        cl.boot(1)
        res, now = _drive(cl, chunks[3], now, [1, 0, 2])
        steps.append(("rejoin", res, _records(cl)))
        cl.nodes[2].cl.announce_weight(0.5)
        cl.quiesce()
        res, now = _drive(cl, chunks[4], now, [2, 1, 0])
        steps.append(("reweight", res, _records(cl)))
        assert cl.nodes[0].cl.leave()
        cl.quiesce()
        res, now = _drive(cl, chunks[5], now, [1, 2, 0])
        steps.append(("leave", res, _records(cl)))
    finally:
        cl.close()
    return steps


def compare_runs(ref, got, step):
    """One step of two lifecycle runs: batch results, then per node the
    table, the replica store and the cluster view."""
    ref_steps, got_steps = (dict((s, (r, rec)) for s, r, rec in run)
                            for run in (ref, got))
    r_res, r_rec = ref_steps[step]
    g_res, g_rec = got_steps[step]
    assert len(r_res) == len(g_res)
    for i, (a, b) in enumerate(zip(r_res, g_res)):
        assert a == b, (step, "batch", i)
    assert sorted(r_rec) == sorted(g_rec), step
    for node in r_rec:
        for part in ("state", "replica", "view"):
            a, b = r_rec[node][part], g_rec[node][part]
            assert a == b, (step, node, part, _diff(a, b))


def _diff(a, b):
    """The entries of two records that differ (for the failure text)."""
    a, b = dict(a), dict(b)
    return {k: (a.get(k), b.get(k)) for k in sorted(set(a) | set(b), key=repr)
            if a.get(k) != b.get(k)}
