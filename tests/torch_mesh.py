"""Shared helpers of the mesh tests: the port's sharded limiter beside the
JAX package's on the same seeded traffic.

JAX runs its composed-XLA mesh on the 8 forced host devices of
`tests/conftest.py` (the fused Pallas mesh cannot run under the installed
jax); the port runs its shards on the CPU device (`make_mesh(D,
device="cpu")`, the plain version of the window kernel).
"""

import numpy as np

from throttlecrab_tpu.parallel import sharded as jax_sharded
from throttlecrab_tpu.parallel import tenants as jax_tenants
from throttlecrab_tpu_torch.parallel import sharded as port_sharded
from throttlecrab_tpu_torch.parallel import tenants as port_tenants

NS = 1_000_000_000
T0 = 1_700_000_000 * NS
WIRE_FIELDS = ("allowed", "limit", "remaining", "reset_after_s",
               "retry_after_s", "status")
NS_FIELDS = ("allowed", "limit", "remaining", "reset_after_ns",
             "retry_after_ns", "status")


def pair(D, capacity_per_shard=256, tenants=None, **kw):
    """(JAX limiter, port limiter) over D shards; `tenants` is a dict of
    TenantRegistry keywords (one registry per package)."""
    jt = pt = None
    if tenants is not None:
        jt = jax_tenants.TenantRegistry(**tenants)
        pt = port_tenants.TenantRegistry(**tenants)
    jl = jax_sharded.ShardedTpuRateLimiter(
        capacity_per_shard=capacity_per_shard,
        mesh=jax_sharded.make_mesh(D), tenants=jt, **kw,
    )
    pl = port_sharded.ShardedTorchRateLimiter(
        capacity_per_shard=capacity_per_shard,
        mesh=port_sharded.make_mesh(D, device="cpu"), tenants=pt, **kw,
    )
    return jl, pl


def same_result(a, b, where=""):
    """Two batch results agree field by field (every lane: invalid lanes
    are zeros in both)."""
    fields = WIRE_FIELDS if hasattr(a, "reset_after_s") else NS_FIELDS
    assert type(a).__name__ == type(b).__name__, where
    for name in fields:
        np.testing.assert_array_equal(
            np.asarray(getattr(a, name)), np.asarray(getattr(b, name)),
            err_msg=f"{where} {name}",
        )


def same_state(jl, pl, where=""):
    """Keymaps, real-slot state per shard (tat, expiry and the deny
    column), mesh-wide certificates and every counter agree."""
    assert jl.n_shards == pl.n_shards
    assert jl.table.capacity == pl.table.capacity, where
    for d in range(jl.n_shards):
        assert dict(jl.keymaps[d].items()) == dict(
            pl.keymaps[d].items()
        ), (where, d)
    cols = ["tat", "expiry"] + (["deny"] if jl.table.insight else [])
    for col in cols:
        np.testing.assert_array_equal(
            np.asarray(getattr(jl.table, col)),
            getattr(pl.table, col).numpy(), err_msg=f"{where} {col}",
        )
    for name in ("cur_safe", "tol_hwm", "now_hwm"):
        assert getattr(jl.table, name) == getattr(pl.table, name), (
            where, name)
    for name in ("total_allowed", "total_denied", "total_expired_hits"):
        assert getattr(jl, name) == getattr(pl, name), (where, name)
    assert jl.table.insight_counts() == pl.table.insight_counts(), where
    assert jl.tenant_stats() == pl.tenant_stats(), where
    if jl._tenant_used is not None:
        for d in range(jl.n_shards):
            np.testing.assert_array_equal(
                jl._tenant_used[d], pl._tenant_used[d])
            np.testing.assert_array_equal(
                jl._tenant_of_slot[d], pl._tenant_of_slot[d])


def tier_of(handle):
    """The output tier a pending mesh window took, in either package."""
    if hasattr(handle, "_tier"):
        return handle._tier
    if handle._w32:
        return "w32"
    return "cur" if handle._now_list is not None else None


def tenant_keys(rng, n, tenants=6, per_tenant=24):
    return [
        f"t{rng.integers(tenants)}:k{rng.integers(per_tenant)}"
        for _ in range(n)
    ]
