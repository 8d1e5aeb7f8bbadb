"""One cluster, two packages: JAX nodes and port nodes serve together
over TCP and decide exactly as the all-JAX cluster does.

The wire format is the contract between nodes, so this pins it from both
sides: every frame kind (forwarded and routed batches, replies, joins
and ring states, migrations, replicas, weight broadcasts and leaves)
crosses from a JAX node to a port node and back.  Each mixed run goes
through the same lifecycle as `test_torch_cluster.py` (join, kill,
rejoin, reweight, leave) on the same ports and traffic as an all-JAX
run, and must match it batch by batch and node by node.
"""

import pytest

from torch_cluster import compare_runs, free_ports, run_lifecycle

pytestmark = pytest.mark.filterwarnings("ignore::DeprecationWarning")

MIXES = {"jax-port-jax": ["jax", "port", "jax"],
         "port-jax-port": ["port", "jax", "port"]}
STEPS = ["boot", "join", "kill", "rejoin", "reweight", "leave"]


@pytest.fixture(scope="module")
def runs():
    ports = free_ports(3)
    out = {"jax": run_lifecycle(["jax"] * 3, ports, seed=23)}
    for name, pkgs in MIXES.items():
        out[name] = run_lifecycle(pkgs, ports, seed=23)
    return out


@pytest.mark.parametrize("mix", sorted(MIXES))
@pytest.mark.parametrize("step", STEPS)
def test_mixed_cluster_decides_as_all_jax(runs, mix, step):
    compare_runs(runs["jax"], runs[mix], step)
