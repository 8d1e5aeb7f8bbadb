"""Record/replay over the cluster lifecycle, port against JAX.

A three-node port cluster with capture on at every frontend records its
client-visible decisions and its membership timeline (join, kill with a
replica takeover, rejoin) into one trace through the port's flight
recorder.  The port's `ClusterReplayer` (nodes on the CPU) and the JAX
package's both rebuild the membership from the recorded events and
replay the trace, and both give the recorded outcome planes, so they
give each other's.  An exhausted key stays denied across the takeover
in the replays too.
"""

import pytest

from throttlecrab_tpu.replay.player import ClusterReplayer as JaxReplayer
from throttlecrab_tpu.replay.trace import Trace as JaxTrace
from throttlecrab_tpu_torch import replay as port_replay
from throttlecrab_tpu_torch.replay.player import (
    ClusterReplayer,
    outcome_vector,
)
from throttlecrab_tpu_torch.replay.trace import Trace
from torch_cluster import CAP, NS, T0, Cluster, Ports

pytestmark = pytest.mark.filterwarnings("ignore::DeprecationWarning")


def _record(tmp_path):
    recorder = port_replay.FlightRecorder(capacity=4096,
                                          out_dir=str(tmp_path))
    port_replay.arm(recorder)
    cl = Cluster(Ports(3), ["port"] * 3)
    try:
        a = cl.boot(0, join=False)
        b = cl.boot(1, join=False)
        cl.join(1)  # node 0 heals its breaker on node 1's announcement
        cl.join(0)
        for n in (a, b):
            n.cl.capture = True
        ring = a.cl.ring
        pool = [f"rr:{i}" for i in range(32)]
        hot = next(k for k in (f"rrhot:{i}" for i in range(4000))
                   if ring.owner_of(k.encode()) == 1)
        now = T0
        for step in range(6):
            (a, b)[step % 2].cl.rate_limit_batch(pool, 8, 100, 60, 1, now)
            now += NS // 4
        c = cl.boot(2)
        c.cl.capture = True
        for step in range(6):
            (a, b, c)[step % 3].cl.rate_limit_batch(
                pool, 8, 100, 60, 1, now)
            now += NS // 4
        for i in range(4):
            res = b.cl.rate_limit_batch([hot], 2, 2, 600, 1, now + i)
        now += 4
        assert not res.allowed[0]
        cl.kill(1)
        for _ in range(3):
            res = a.cl.rate_limit_batch([hot], 2, 2, 600, 1, now)
            assert res.status[0] == 0 and not res.allowed[0]
            now += NS // 4
        a.cl.rate_limit_batch(pool, 8, 100, 60, 1, now)
        now += NS // 4
        b2 = cl.boot(1)
        b2.cl.capture = True
        res = b2.cl.rate_limit_batch([hot], 2, 2, 600, 1, now)
        assert res.status[0] == 0 and not res.allowed[0]
        b2.cl.rate_limit_batch(pool, 8, 100, 60, 1, now + NS // 4)
        path, _n = recorder.dump()
    finally:
        port_replay.disarm()
        cl.close()
    return path


@pytest.fixture(scope="module")
def trace_path(tmp_path_factory):
    return _record(tmp_path_factory.mktemp("cluster-trace"))


def test_recorded_membership_timeline(trace_path):
    trace = Trace.load(trace_path)
    kinds = [e.kind for e in trace.events]
    assert "cluster-join" in kinds and "cluster-takeover" in kinds
    assert {w.source for w in trace.windows} == {16, 17, 18}
    # The JAX reader decodes the port's file to the same records.
    jtrace = JaxTrace.load(trace_path)
    assert jtrace.outcome_vector() == trace.outcome_vector()
    assert [e.kind for e in jtrace.events] == kinds


@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_cluster_replay_gives_the_recorded_planes(trace_path, pkg):
    if pkg == "port":
        trace = Trace.load(trace_path)
        replayer = ClusterReplayer(3, capacity=CAP, device="cpu")
    else:
        trace = JaxTrace.load(trace_path)
        replayer = JaxReplayer(3, capacity=CAP)
    try:
        replayed = replayer.replay(trace, settle_s=1.0)
    finally:
        replayer.close()
    assert outcome_vector(replayed) == trace.outcome_vector()
