"""The port's sharded limiter (`parallel/sharded.py`) against the JAX
package's composed-XLA mesh, at D = 1, 2 and 4 shards.

Every case of tests/test_sharded.py runs through both packages on the
same inputs (and, where the reference test does, against the scalar
oracle): the results must be identical field for field, and the per-shard
keymaps, the real-slot state of every shard, the mesh-wide certificates
and the counters must agree after each step.  On top: K-deep
`dispatch_many` windows on each output tier (w32 words, cur words, the
4-plane wire output and the full-ns planes), with the tier the ladder
picked pinned equal, and growth under a K-deep window.
"""

import numpy as np
import pytest

from throttlecrab_tpu.parallel import shard_of_key as jax_shard_of_key
from throttlecrab_tpu_torch.core.rate_limiter import RateLimiter
from throttlecrab_tpu_torch.core.store.periodic import PeriodicStore
from throttlecrab_tpu_torch.parallel import (
    ShardedTorchRateLimiter,
    make_mesh,
    shard_of_key,
)
from torch_mesh import NS, T0, pair, same_result, same_state, tier_of

SHARDS = [1, 2, 4]


@pytest.fixture(autouse=True)
def _composed_mesh(monkeypatch):
    """JAX's fused mesh cannot run under the installed jax: hold the port
    against the composed-XLA mesh."""
    monkeypatch.setenv("THROTTLECRAB_PALLAS_FUSED", "0")


def oracle():
    return RateLimiter(PeriodicStore())


def _fields(decision):
    """(allowed, limit, remaining, reset, retry) of a scalar decision,
    from either package's RateLimitResult."""
    allowed, r = decision
    return (allowed, r.limit, r.remaining, r.reset_after_ns,
            r.retry_after_ns)


def test_keys_spread_across_shards():
    ids = [shard_of_key(f"key-{i}".encode(), 8) for i in range(256)]
    assert len(set(ids)) == 8  # CRC32 routing actually uses the whole mesh
    assert ids == [jax_shard_of_key(f"key-{i}".encode(), 8)
                   for i in range(256)]


@pytest.mark.parametrize("D", SHARDS)
def test_scalar_parity_across_shards(D):
    jl, pl = pair(D)
    ora = oracle()
    for i in range(40):
        key = f"user-{i % 7}"
        now = T0 + i * 137_000_000
        got = pl.rate_limit(key, 3, 10, 60, 1, now)
        assert got == ora.rate_limit(key, 3, 10, 60, 1, now), i
        assert _fields(got) == _fields(
            jl.rate_limit(key, 3, 10, 60, 1, now)), i
    same_state(jl, pl)


@pytest.mark.parametrize("D", SHARDS)
def test_batch_parity_uniform_params(D):
    jl, pl = pair(D)
    ora = oracle()
    rng = np.random.default_rng(42)
    keys = [f"k{int(x)}" for x in rng.integers(0, 50, 300)]
    res = pl.rate_limit_batch(keys, 5, 100, 60, 1, T0)
    same_result(jl.rate_limit_batch(keys, 5, 100, 60, 1, T0), res)
    for i, key in enumerate(keys):
        allowed, r = ora.rate_limit(key, 5, 100, 60, 1, T0)
        assert bool(res.allowed[i]) == allowed, i
        assert int(res.remaining[i]) == r.remaining
        assert int(res.reset_after_ns[i]) == r.reset_after_ns
        assert int(res.retry_after_ns[i]) == r.retry_after_ns
    same_state(jl, pl)


@pytest.mark.parametrize("D", SHARDS)
def test_batch_parity_heterogeneous_params(D):
    jl, pl = pair(D)
    ora = oracle()
    rng = np.random.default_rng(7)
    n = 200
    keys = [f"k{int(x)}" for x in rng.integers(0, 30, n)]
    burst = rng.integers(1, 6, n)
    count = rng.integers(1, 50, n)
    period = rng.integers(1, 120, n)
    qty = rng.integers(0, 3, n)
    args = (keys, burst, count, period, qty, T0)
    res = pl.rate_limit_batch(*args)
    same_result(jl.rate_limit_batch(*args), res)
    for i, key in enumerate(keys):
        allowed, r = ora.rate_limit(
            key, int(burst[i]), int(count[i]), int(period[i]), int(qty[i]),
            T0,
        )
        assert bool(res.allowed[i]) == allowed, i
        assert int(res.remaining[i]) == r.remaining, i
    same_state(jl, pl)


@pytest.mark.parametrize("D", SHARDS)
def test_counters_are_global(D):
    jl, pl = pair(D)
    keys = [f"c{i}" for i in range(64)]
    res = pl.rate_limit_batch(keys, 1, 1, 60, 2, T0)
    same_result(jl.rate_limit_batch(keys, 1, 1, 60, 2, T0), res)
    # quantity 2 > burst 1: every request denied.
    assert not res.allowed.any()
    assert (pl.total_allowed, pl.total_denied) == (0, 64)
    res = pl.rate_limit_batch(keys, 10, 10, 60, 1, T0)
    same_result(jl.rate_limit_batch(keys, 10, 10, 60, 1, T0), res)
    assert res.allowed.all() and pl.total_allowed == 64
    same_state(jl, pl)


@pytest.mark.parametrize("D", SHARDS)
def test_sweep_frees_across_all_shards(D):
    jl, pl = pair(D)
    keys = [f"s{i}" for i in range(80)]
    for lim in (jl, pl):
        lim.rate_limit_batch(keys, 2, 10, 1, 1, T0)
    assert len(pl) == len(jl) == 80
    freed = pl.sweep(T0 + 3600 * NS)
    assert freed == jl.sweep(T0 + 3600 * NS) == 80
    assert len(pl) == 0
    same_state(jl, pl)


@pytest.mark.parametrize("D", SHARDS)
def test_duplicate_keys_serialize_within_batch(D):
    jl, pl = pair(D)
    keys = ["dup"] * 20
    res = pl.rate_limit_batch(keys, 10, 100, 3600, 1, T0)
    same_result(jl.rate_limit_batch(keys, 10, 100, 3600, 1, T0), res)
    assert int(res.allowed.sum()) == 10
    assert res.allowed[:10].all() and not res.allowed[10:].any()
    same_state(jl, pl)


@pytest.mark.parametrize("D", SHARDS)
def test_param_change_mid_batch(D):
    jl, pl = pair(D)
    ora = oracle()
    args = (["p", "p", "p", "p"], [5, 5, 2, 2], [10] * 4, [60] * 4, [1] * 4)
    res = pl.rate_limit_batch(*args, T0)
    same_result(jl.rate_limit_batch(*args, T0), res)
    for i in range(4):
        allowed, r = ora.rate_limit("p", args[1][i], 10, 60, 1, T0)
        assert bool(res.allowed[i]) == allowed, i
        assert int(res.remaining[i]) == r.remaining, i
    same_state(jl, pl)


@pytest.mark.parametrize("D", SHARDS)
def test_invalid_requests_do_not_poison_batch(D):
    jl, pl = pair(D)
    args = (["a", "b", "c"], [5, -1, 5], 10, 60, [1, 1, -2], T0)
    res = pl.rate_limit_batch(*args)
    same_result(jl.rate_limit_batch(*args), res)
    assert res.status[0] == 0 and res.status[1] != 0 and res.status[2] != 0
    assert res.allowed[0] and not res.allowed[1] and not res.allowed[2]
    same_state(jl, pl)


@pytest.mark.parametrize("D", SHARDS)
def test_table_grow_preserves_state(D):
    jl, pl = pair(D, capacity_per_shard=4)
    # Exhaust burst for one key, then overflow capacity to force growth.
    for _ in range(3):
        assert _fields(pl.rate_limit("grow-key", 3, 10, 3600, 1, T0)) == (
            _fields(jl.rate_limit("grow-key", 3, 10, 3600, 1, T0)))
    keys = [f"g{i}" for i in range(200)]
    same_result(jl.rate_limit_batch(keys, 3, 10, 3600, 1, T0),
                pl.rate_limit_batch(keys, 3, 10, 3600, 1, T0))
    assert pl.table.capacity > 4
    # State must survive the reallocation: the key is still exhausted.
    allowed, _ = pl.rate_limit("grow-key", 3, 10, 3600, 1, T0 + 1)
    assert not allowed
    jl.rate_limit("grow-key", 3, 10, 3600, 1, T0 + 1)
    same_state(jl, pl)


# --------------------------------------------------------------------- #
# K-deep windows on every output tier, and growth inside a window.

_TIERS = {
    # name: (wire, (burst, count, period), quantity, expected tier)
    "w32": (True, (5, 10, 60), 1, "w32"),
    # A 3,000 s tolerance pushes reset past the w32 field.
    "cur": (True, (5_000, 100, 60), 1, "cur"),
    # quantity-0 probes need the degenerate machinery: 4-plane output.
    "planes": (True, (5, 10, 60), 0, None),
    "ns": (False, (5, 10, 60), 1, None),
}


@pytest.mark.parametrize("tier", list(_TIERS))
@pytest.mark.parametrize("D", SHARDS)
def test_dispatch_many_tiers_as_in_jax(D, tier):
    wire, (burst, count, period), q0, want = _TIERS[tier]
    jl, pl = pair(D, capacity_per_shard=512)
    rng = np.random.default_rng(D * 10 + len(tier))
    for w in range(4):
        batches = []
        for j in range(1 + w % 3 * 2):
            n = int(rng.integers(1, 90))
            ids = rng.integers(0, 120, n)
            keys = [f"u{int(x)}" for x in ids]
            # Per-key quantities: a key whose params change mid-batch
            # would take the sequential fallback instead of one window.
            qty = np.where(ids % 3 == 0, q0, 1)
            now = T0 + (w * 8 + j) * NS // 4
            batches.append((keys, burst, count, period, qty, now))
        hj = jl.dispatch_many(batches, wire=wire)
        hp = pl.dispatch_many(batches, wire=wire)
        assert tier_of(hj) == tier_of(hp) == want, (w, tier_of(hj))
        for j, (a, b) in enumerate(zip(hj.fetch(), hp.fetch())):
            same_result(a, b, f"window {w} batch {j}")
        same_state(jl, pl, f"window {w}")


@pytest.mark.parametrize("insight", [False, True], ids=["w4", "w6"])
@pytest.mark.parametrize("D", SHARDS)
def test_growth_inside_a_window_as_in_jax(D, insight):
    jl, pl = pair(D, capacity_per_shard=16, insight=insight)
    rng = np.random.default_rng(D)
    for w in range(3):
        batches = [
            ([f"g{int(x)}" for x in rng.integers(0, 400, 64)], 3, 10, 60, 1,
             T0 + (w * 4 + j) * NS)
            for j in range(4)
        ]
        for a, b in zip(jl.rate_limit_many(batches, wire=True),
                        pl.rate_limit_many(batches, wire=True)):
            same_result(a, b, f"window {w}")
        same_state(jl, pl, f"window {w}")
    assert pl.table.capacity >= 128


def test_mesh_devices():
    mesh = make_mesh(3, device="cpu")
    assert mesh.n_shards == 3 and {d.type for d in mesh.devices} == {"cpu"}
    assert make_mesh(device="cpu").n_shards == 1
    assert make_mesh(devices=["cpu", "cpu"]).n_shards == 2
    lim = ShardedTorchRateLimiter(64, mesh=mesh)
    assert [s.state.device.type for s in lim.table.shards] == ["cpu"] * 3
    assert len({s.state.data_ptr() for s in lim.table.shards}) == 3
