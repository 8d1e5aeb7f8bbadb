"""The port's cluster tier against the JAX package's: three in-process
nodes over real TCP through the whole elastic lifecycle.

The same seeded traffic runs through a JAX cluster and then through a
port cluster bound to the same ports (so both build the same ring), and
every batch's results, statuses and wire words must be equal, and so
must each node's table (through `export_state`), its warm-replica store
and its `cluster_view` (epoch, weights, takeovers, migrations, leaves,
and the per-peer `peer_stats` counters) after each step: join, kill
(replica takeover), rejoin (migrate back), reweight and planned leave.
The JAX nodes run the composed XLA decide (the Pallas kernel is off by
default); the port's nodes run the plain version on the CPU.
"""

import pytest

from torch_cluster import compare_runs, free_ports, run_lifecycle

pytestmark = pytest.mark.filterwarnings("ignore::DeprecationWarning")


@pytest.fixture(scope="module")
def lifecycle_runs():
    ports = free_ports(3)
    return (run_lifecycle(["jax"] * 3, ports),
            run_lifecycle(["port"] * 3, ports))


@pytest.mark.parametrize("step", ["boot", "join", "kill", "rejoin",
                                  "reweight", "leave"])
def test_lifecycle_step_equals_jax(lifecycle_runs, step):
    """Per step: batch results (ns and wire tiers), then per node the
    table, the replica store and the cluster view with its counters."""
    compare_runs(*lifecycle_runs, step)


def test_lifecycle_exercised_every_branch(lifecycle_runs):
    """The run really took the lifecycle's branches: a takeover after
    the kill, migrations in on the join and the rejoin, a reweighted
    ring, and the leaver a lame duck its peers saw depart."""
    steps = {s: rec for s, _r, rec in lifecycle_runs[1]}
    assert steps["join"][2]["view"]["migrated_in"] > 0
    assert sum(steps["kill"][n]["view"]["takeovers"] for n in (0, 2)) >= 1
    assert steps["rejoin"][1]["view"]["migrated_in"] > 0
    assert steps["reweight"][0]["view"]["weights"] == [1.0, 1.0, 0.5]
    assert steps["leave"][0]["view"]["lame_duck"] is True
    assert steps["leave"][1]["view"]["leaves"] >= 1
    assert sum(steps["leave"][n]["view"]["migrated_in"] for n in (1, 2)) > (
        sum(steps["reweight"][n]["view"]["migrated_in"] for n in (1, 2)))
    assert all(len(steps[s][n]["replica"]) > 0
               for s in ("boot", "join") for n in steps[s])
