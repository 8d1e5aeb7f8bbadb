"""TorchRateLimiter (device="cpu") against TpuRateLimiter, result for result.

Both limiters see the same Zipf-skewed corpus — per-key heterogeneous
(burst, count, period), mid-batch parameter changes (the
sequential_fallback path), quantity-0 probes, negative quantities and
invalid params — through rate_limit_batch (wire on and off,
collect_cur), rate_limit_many / dispatch_many (the w32, cur and 4-plane
tiers), sweeps and table growth.  Every result field, the output tier
chosen, and the stored table state must be identical.
"""

from dataclasses import astuple

import numpy as np
import pytest

import jax.numpy as jnp

from throttlecrab_tpu.tpu.limiter import TpuRateLimiter
from throttlecrab_tpu_torch.tpu.limiter import TorchRateLimiter

NS = 1_000_000_000
T0 = 1_753_700_000 * NS
I64_MAX = (1 << 63) - 1

_FIELDS = ("allowed", "limit", "remaining", "status")


def _pair(capacity=256, insight=False):
    return (
        TpuRateLimiter(capacity=capacity, keymap="python", insight=insight),
        TorchRateLimiter(capacity=capacity, device="cpu", insight=insight),
    )


def _zipf_keys(rng, n_keys, n, a=1.1):
    p = np.arange(1, n_keys + 1, dtype=np.float64) ** -a
    return [f"user:{i}" for i in rng.choice(n_keys, size=n, p=p / p.sum())]


def _batch(rng, n_keys, n, *, probes=0.0, drift=0.0, bad=0.0, big=False):
    """One batch: keys, params per key id, with optional quantity-0
    probes, mid-batch parameter drift and invalid requests."""
    keys = _zipf_keys(rng, n_keys, n)
    kid = np.array([int(k.split(":")[1]) for k in keys], np.int64)
    burst = 2 + kid % 9
    count = 5 + kid % 50
    period = 1 + kid % 30
    if big:
        # minutes-scale buckets: out of the w32 field widths
        period = period * 5000
    q = np.ones(n, np.int64)
    if probes:
        # quantity-0 probes per key, so they need no param-change rounds
        q[kid % int(1 / probes) == 0] = 0
    drifted = rng.random(n) < drift
    burst = np.where(drifted, burst + 3, burst)
    broken = rng.random(n) < bad
    burst = np.where(broken & (rng.random(n) < 0.5), 0, burst)
    q = np.where(broken & (burst > 0), -1, q)
    return keys, burst, count, period, q


def _assert_same(r_j, r_t, wire):
    for f in _FIELDS + (
        ("reset_after_s", "retry_after_s") if wire
        else ("reset_after_ns", "retry_after_ns")
    ):
        a, b = np.asarray(getattr(r_j, f)), np.asarray(getattr(r_t, f))
        assert a.shape == b.shape and (a == b).all(), f
    if r_j.cur_ns is None:
        assert r_t.cur_ns is None
    else:
        ok = np.asarray(r_j.status) == 0
        assert (r_j.cur_ns[ok] == r_t.cur_ns[ok]).all(), "cur_ns"


def _assert_state(jl, tl):
    cap = jl.table.capacity
    assert tl.table.capacity == cap
    assert (
        np.asarray(jl.table.state)[:cap] == tl.table.state.numpy()[:cap]
    ).all(), "stored state"
    assert jl.table.expired_hits() == tl.table.expired_hits()
    assert jl.table.insight_counts() == tl.table.insight_counts()
    assert jl.table.cur_safe == tl.table.cur_safe
    assert (jl.table.tol_hwm, jl.table.now_hwm) == (
        tl.table.tol_hwm, tl.table.now_hwm
    )
    assert sorted(jl.keymap.items()) == sorted(tl.keymap.items())


@pytest.mark.parametrize(
    "wire,collect_cur", [(False, False), (True, False), (True, True)]
)
@pytest.mark.parametrize("insight", [False, True])
def test_rate_limit_batch_result_for_result(wire, collect_cur, insight):
    rng = np.random.default_rng(10 + 2 * wire + collect_cur)
    jl, tl = _pair(insight=insight)
    now = T0
    for step in range(6):
        b = _batch(rng, 40, int(rng.integers(1, 40)),
                   probes=0.1 * (step % 2), drift=0.1 * (step % 3 == 0),
                   bad=0.05)
        r_j = jl.rate_limit_batch(*b, now, wire=wire, collect_cur=collect_cur)
        r_t = tl.rate_limit_batch(*b, now, wire=wire, collect_cur=collect_cur)
        _assert_same(r_j, r_t, wire)
        _assert_state(jl, tl)
        now += int(rng.integers(1, 3 * NS))


@pytest.mark.parametrize(
    "case,tier",
    [
        ("plain", "w32"),       # certified, seconds-scale buckets
        ("collect_cur", "cur"),  # the cur tier preferred
        ("big", "cur"),         # out of w32's fields: cur
        ("probes", "planes"),   # quantity-0 probes: exact path, 4-plane
        ("drift", "ready"),     # a mid-batch param change: sequential
        ("not_wire", "planes"),  # ns planes
    ],
)
@pytest.mark.parametrize("insight", [False, True])
def test_dispatch_many_tiers_result_for_result(case, tier, insight):
    rng = np.random.default_rng(sum(map(ord, case)))
    jl, tl = _pair(insight=insight)
    wire = case != "not_wire"
    collect_cur = case == "collect_cur"
    now = T0
    for step in range(4):
        batches = []
        for j in range(3):
            b = _batch(
                rng, 60, int(rng.integers(2, 50)),
                probes=0.15 if case == "probes" else 0.0,
                drift=0.3 if case == "drift" else 0.0,
                big=case == "big",
            )
            batches.append((*b, now + j * NS // 7))
        h_j = jl.dispatch_many(batches, wire=wire, collect_cur=collect_cur)
        h_t = tl.dispatch_many(batches, wire=wire, collect_cur=collect_cur)
        got_tier = (
            "ready" if not hasattr(h_t, "_w32")
            else "w32" if h_t._w32 else "cur" if h_t._cur else "planes"
        )
        assert got_tier == tier
        assert type(h_j).__name__ == type(h_t).__name__
        if tier != "ready":
            assert (h_j._w32, h_j._cur) == (h_t._w32, h_t._cur)
        for r_j, r_t in zip(h_j.fetch(), h_t.fetch()):
            _assert_same(r_j, r_t, wire)
        _assert_state(jl, tl)
        now += int(rng.integers(1, 2 * NS))


def test_rate_limit_many_and_sweep_with_growth():
    """Table growth (capacity 16 -> 1024 mid-batch), expiry sweeps that
    recycle slots, and the expired-hit accumulator the adaptive cleanup
    policy reads."""
    rng = np.random.default_rng(77)
    jl, tl = _pair(capacity=16)
    now = T0
    for step in range(5):
        batches = [
            (*_batch(rng, 90, 40, probes=0.05), now + j * NS)
            for j in range(2)
        ]
        for r_j, r_t in zip(
            jl.rate_limit_many(batches, wire=True),
            tl.rate_limit_many(batches, wire=True),
        ):
            _assert_same(r_j, r_t, True)
        _assert_state(jl, tl)
        now += 20 * NS
        assert jl.sweep(now) == tl.sweep(now)
        _assert_state(jl, tl)
        assert jl.take_expired_hits(now) == tl.take_expired_hits(now)
        now += 7 * NS


def _hostile_state(rng, rows, width, n_keys):
    """Table rows the serving path meets rarely: empty rows, immortal
    expiries (I64_MAX), TATs near 2^62, expired rows, deny counts."""
    from throttlecrab_tpu_torch.tpu.kernel import pack_state
    import torch

    tat = np.zeros(rows, np.int64)
    exp = np.full(rows, -(1 << 63), np.int64)
    kind = rng.integers(0, 5, n_keys)
    for s in range(n_keys):
        if kind[s] == 1:
            tat[s], exp[s] = T0 + 5 * NS, I64_MAX
        elif kind[s] == 2:
            tat[s] = (1 << 62) - int(rng.integers(0, 1 << 40))
            exp[s] = tat[s] + 100 * NS
        elif kind[s] == 3:
            tat[s], exp[s] = T0 - 500 * NS, T0 - 400 * NS  # expired
        elif kind[s] == 4:
            tat[s], exp[s] = T0 + 2 * NS, T0 + 60 * NS
    st = pack_state(torch.from_numpy(tat), torch.from_numpy(exp)).numpy()
    if width > 4:
        deny = rng.integers(0, 1 << 40, rows).astype(np.int64)
        deny[n_keys:] = 0
        st = np.concatenate(
            [st, deny.view(np.int32).reshape(rows, 2)], axis=1
        )
    return st


@pytest.mark.parametrize("insight", [False, True])
def test_load_numpy_hostile_state(insight):
    """Both packages start from the same non-trivial table (handed over
    as numpy + (key, slot) pairs) and stay identical."""
    rng = np.random.default_rng(5 + insight)
    cap, n_keys = 64, 30
    jl = TpuRateLimiter(capacity=cap, keymap="python", insight=insight)
    keys = [f"user:{i}" for i in range(n_keys)]
    jl.keymap.resolve(keys, np.ones(n_keys, bool))
    state = _hostile_state(
        rng, cap + jl.table.SCRATCH, 6 if insight else 4, n_keys
    )
    jl.table.state = jnp.asarray(state)
    jl.table.cur_safe = False  # TATs near 2^62 are stored
    jl.table.tol_hwm = 100 * NS
    jl.table.now_hwm = T0
    tl = TorchRateLimiter(capacity=cap, device="cpu")
    tl.load_numpy(
        np.asarray(jl.table.state), jl.keymap.items(),
        exp_acc=jl.table.expired_hits(),
        ins_counts=jl.table.insight_counts() if insight else None,
        tol_hwm=jl.table.tol_hwm, now_hwm=jl.table.now_hwm,
        cur_safe=jl.table.cur_safe,
    )
    _assert_state(jl, tl)
    now = T0
    for step in range(4):
        batches = [
            (*_batch(rng, 40, 30, probes=0.1 * (step == 2)), now + j * NS)
            for j in range(2)
        ]
        for r_j, r_t in zip(
            jl.rate_limit_many(batches, wire=True, collect_cur=step == 1),
            tl.rate_limit_many(batches, wire=True, collect_cur=step == 1),
        ):
            _assert_same(r_j, r_t, True)
        _assert_state(jl, tl)
        now += 3 * NS
    assert jl.sweep(now + 200 * NS) == tl.sweep(now + 200 * NS)
    _assert_state(jl, tl)


def test_scalar_rate_limit_matches():
    """The scalar library API (ScalarCompatMixin) over both engines,
    including the pre-epoch clock fallback's validation errors."""
    jl, tl = _pair()
    for i in range(12):
        ok_j, res_j = jl.rate_limit("k", 3, 1, 3600, 1, T0 + i * NS)
        ok_t, res_t = tl.rate_limit("k", 3, 1, 3600, 1, T0 + i * NS)
        assert (ok_j, astuple(res_j)) == (ok_t, astuple(res_t))
    for bad in ((0, 1, 1, 1), (3, 1, 1, -1)):
        with pytest.raises(Exception) as e_j:
            jl.rate_limit("k", *bad, T0)
        with pytest.raises(Exception) as e_t:
            tl.rate_limit("k", *bad, T0)
        assert type(e_j.value).__name__ == type(e_t.value).__name__
        assert str(e_j.value) == str(e_t.value)


@pytest.mark.parametrize("insight", [False, True])
def test_bucket_table_entry_points_match_jax(insight):
    """BucketTable.check_batch / check_many (unpacked arrays) and
    live_count against the JAX package's table: outputs of the exact and
    certified paths, stored state and the expired-hit accumulator."""
    from throttlecrab_tpu.tpu.table import BucketTable as JaxTable
    from throttlecrab_tpu_torch.tpu.limiter import derive_params, segment_info
    from throttlecrab_tpu_torch.tpu.table import BucketTable

    rng = np.random.default_rng(21 + insight)
    cap, K, B = 48, 2, 16
    jt, tt = JaxTable(cap, insight=insight), BucketTable(
        cap, device="cpu", insight=insight
    )
    now = T0
    for step in range(3):
        slots = rng.integers(0, cap, (K, B)).astype(np.int32)
        kid = slots.astype(np.int64)
        em, tol, _ = derive_params(2 + kid % 5, 3 + kid % 7, 1 + kid % 4)
        q = np.ones((K, B), np.int64)
        valid = rng.random((K, B)) < 0.9
        rank = np.zeros((K, B), np.int32)
        last = np.ones((K, B), bool)
        for k in range(K):
            rank[k], last[k] = segment_info(slots[k], valid[k])
        nows = np.array([now, now + NS], np.int64)
        for compact, with_degen in ((False, True), (True, False)):
            args = (slots, rank, last, em, tol, q, valid)
            out_j = np.asarray(jt.check_many(
                *args, nows, with_degen=with_degen, compact=compact
            ))
            out_t = tt.check_many(
                *args, nows, with_degen=with_degen, compact=compact
            ).numpy()
            mask = valid[:, None, :]
            assert not ((out_j != out_t) & mask).any()
            one = tuple(a[0] for a in args)
            out_j = np.asarray(jt.check_batch(
                *one, now + 2 * NS, with_degen=with_degen, compact=compact
            ))
            out_t = tt.check_batch(
                *one, now + 2 * NS, with_degen=with_degen, compact=compact
            ).numpy()
            assert not ((out_j != out_t) & valid[0][None, :]).any()
        assert (np.asarray(jt.state)[:cap] == tt.state.numpy()[:cap]).all()
        assert jt.expired_hits() == tt.expired_hits()
        assert jt.insight_counts() == tt.insight_counts()
        assert jt.live_count(now) == tt.live_count(now)
        now += int(rng.integers(1, 20)) * NS
