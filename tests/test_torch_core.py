"""The port's scalar core (core/) against the JAX package's.

A hypothesis differential test drives random `rate_limit` sequences —
keys from a small pool, parameters from ordinary to i64-scale, quantity
probes and negative quantities, time steps forward and back — through
both packages' `RateLimiter` over each of the four stores (adaptive,
periodic and probabilistic with cleanup knobs small enough to fire, and
a bare map store without cleanup).  Every result and every error (type
and message) must be identical, and so must the stores' contents after.
The i64 edge cases of the JAX package's own math and rate tests run on
both packages.  Tolerance: exact equality.
"""

import math

import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

import throttlecrab_tpu as jax_pkg
import throttlecrab_tpu_torch as port_pkg
from throttlecrab_tpu.core import i64 as jax_i64
from throttlecrab_tpu.core.store.mapstore import MapStore as JaxMapStore
from throttlecrab_tpu_torch.core import i64 as port_i64
from throttlecrab_tpu_torch.core.store.mapstore import MapStore as PortMapStore

NS = 1_000_000_000
BASE = 1_700_000_000 * NS
I64_MAX = (1 << 63) - 1
U64_MAX = (1 << 64) - 1


class _JaxBare(JaxMapStore):
    def _maybe_cleanup(self, now_ns):
        pass


class _PortBare(PortMapStore):
    def _maybe_cleanup(self, now_ns):
        pass


PACKAGES = {"jax": (jax_pkg, _JaxBare), "port": (port_pkg, _PortBare)}


def _store(pkg_name, kind):
    pkg, bare = PACKAGES[pkg_name]
    if kind == "adaptive":
        return pkg.AdaptiveStore(capacity=4, min_interval_ns=NS,
                                 max_interval_ns=8 * NS, max_operations=7)
    if kind == "periodic":
        return pkg.PeriodicStore(cleanup_interval_ns=2 * NS)
    if kind == "probabilistic":
        return pkg.ProbabilisticStore(cleanup_probability=3)
    return bare()


STORES = ["adaptive", "periodic", "probabilistic", "map"]

_burst = st.one_of(st.integers(-1, 12), st.sampled_from(
    [I64_MAX // 1000, (1 << 32) + 1, (1 << 31) - 1]))
_count = st.one_of(st.integers(-1, 120), st.sampled_from(
    [I64_MAX // 1000, 1 << 40]))
_period = st.one_of(st.integers(-1, 3600), st.sampled_from(
    [1 << 33, 86_400 * 365]))
_quantity = st.one_of(st.integers(-2, 6), st.sampled_from(
    [I64_MAX // 2, I64_MAX, 1 << 40]))
_step = st.one_of(st.integers(0, 3 * NS), st.integers(-NS, 0),
                  st.sampled_from([0, 1, 600 * NS]))
_op = st.tuples(st.sampled_from(["a", "b", "c", "d", "e", "f"]),
                _burst, _count, _period, _quantity, _step)


def _outcome(limiter, op, now):
    key, burst, count, period, q, _ = op
    try:
        return limiter.rate_limit(key, burst, count, period, q, now)
    except Exception as e:  # the error is part of the contract
        return type(e).__name__, str(e)


@pytest.mark.parametrize("kind", STORES)
@settings(max_examples=60, deadline=None)
@given(ops=st.lists(_op, min_size=1, max_size=40))
def test_rate_limit_sequences_match_jax(kind, ops):
    jl = jax_pkg.RateLimiter(_store("jax", kind))
    pl = port_pkg.RateLimiter(_store("port", kind))
    now = BASE
    for op in ops:
        now = max(now + op[5], 0)
        got_j, got_p = _outcome(jl, op, now), _outcome(pl, op, now)
        if isinstance(got_j, tuple) and len(got_j) == 2 and isinstance(
            got_j[0], bool
        ):
            assert got_j[0] == got_p[0]
            assert vars(got_j[1]) == vars(got_p[1])
        else:
            assert got_j == got_p
    assert jl.store._data == pl.store._data
    assert len(jl.store) == len(pl.store)


@pytest.fixture(params=sorted(PACKAGES))
def pkg(request):
    return PACKAGES[request.param][0]


@pytest.fixture(params=STORES)
def limiter(request, pkg):
    name = "jax" if pkg is jax_pkg else "port"
    return pkg.RateLimiter(_store(name, request.param))


def test_library_surface(pkg):
    lim = pkg.RateLimiter(pkg.AdaptiveStore())
    allowed, r = lim.rate_limit("k", 3, 1, 60, 1, BASE)
    assert allowed and r.remaining == 2
    assert isinstance(r, pkg.RateLimitResult)
    names = set(jax_pkg.__all__) - {"__version__"}
    assert names <= set(port_pkg.__all__)


def test_negative_quantity_and_invalid_params(limiter, pkg):
    with pytest.raises(pkg.CellError):
        limiter.rate_limit("t", 10, 10, 60, -1, BASE)
    for bad in ((0, 10, 60), (10, 0, 60), (10, 10, 0)):
        with pytest.raises(pkg.CellError):
            limiter.rate_limit("t", *bad, 1, BASE)


def test_large_quantity_overflow_protection(limiter):
    allowed, _ = limiter.rate_limit("o", 10, 10, 60, I64_MAX // 2, BASE)
    assert not allowed


def test_saturating_arithmetic(limiter):
    limiter.rate_limit("s1", I64_MAX // 1000, 100, 60, 1, BASE)
    limiter.rate_limit("s2", 10, I64_MAX // 1000, 60, 1, BASE)


def test_burst_one_never_denies(limiter):
    for t in (BASE, BASE, BASE + 1):
        assert limiter.rate_limit("b1", 1, 1, 60, 1, t)[0]


def test_retry_after_when_denied(limiter):
    allowed, r = limiter.rate_limit("r", 2, 60, 60, 1, BASE)
    assert allowed and r.retry_after_ns == 0 and r.reset_after_ns == NS
    allowed, r = limiter.rate_limit("r", 2, 60, 60, 1, BASE)
    assert allowed and r.remaining == 0 and r.reset_after_ns == 2 * NS
    allowed, r = limiter.rate_limit("r", 2, 60, 60, 1, BASE)
    assert not allowed and r.retry_after_ns == NS


def test_rate_constructors(pkg):
    Rate = pkg.Rate
    assert Rate.per_second(10).period() == 100_000_000
    assert Rate.per_minute(1).period() == 60 * NS
    assert Rate.per_hour(3600).period() == NS
    assert Rate.per_day(1).period() == 86400 * NS
    assert Rate.from_count_and_period(7, 60).period() == 8571428571
    assert Rate.from_count_and_period(3, 1).period() == int(1e9 / 3.0)
    for bad in ((0, 60), (-5, 60), (10, 0), (10, -1)):
        assert Rate.from_count_and_period(*bad).period() == U64_MAX * NS
    with pytest.raises(ValueError):
        Rate.per_second(0)


_EDGES = [0, 1, -1, I64_MAX, -I64_MAX - 1, I64_MAX - 1, 1 << 62, -(1 << 62),
          U64_MAX, 1 << 64, 123_456_789_012]


@pytest.mark.parametrize(
    "name,arity",
    [("wrap_i64", 1), ("wrap_u64", 1), ("sat_i64", 1), ("sat_add", 2),
     ("sat_sub", 2), ("sat_mul", 2), ("sat_add_u64", 2), ("sat_mul_u64", 2),
     ("rust_div", 2)],
)
def test_i64_helpers_match_jax(name, arity):
    fj, fp = getattr(jax_i64, name), getattr(port_i64, name)
    if arity == 1:
        cases = [(a,) for a in _EDGES]
    else:
        cases = [(a, b) for a in _EDGES for b in _EDGES
                 if not (name == "rust_div" and b == 0)]
        if name.endswith("u64"):
            cases = [(a, b) for a, b in cases if a >= 0 and b >= 0]
    for args in cases:
        assert fj(*args) == fp(*args), args


def test_f64_to_u64_sat_matches_jax():
    for x in (math.nan, -1.0, 0.0, 0.5, 1.9, 2.0 ** 63, float(U64_MAX),
              1e300, math.inf, -math.inf, 8571428571.43):
        assert jax_i64.f64_to_u64_sat(x) == port_i64.f64_to_u64_sat(x), x


@pytest.mark.parametrize("sub", ["", ".tpu", ".parallel", ".harness",
                                 ".core", ".replay", ".control"])
def test_public_names_as_in_jax(sub):
    """Each package's public surface (`__all__`) names what JAX's does,
    with the backend's limiter classes named for their device; and
    `tpu.gcra_batch` decides a batch as JAX's does."""
    import importlib

    jax_mod = importlib.import_module("throttlecrab_tpu" + sub)
    port_mod = importlib.import_module("throttlecrab_tpu_torch" + sub)
    rename = {"TpuRateLimiter": "TorchRateLimiter",
              "ShardedTpuRateLimiter": "ShardedTorchRateLimiter"}
    want = {rename.get(n, n) for n in jax_mod.__all__}
    got = set(port_mod.__all__)
    assert want <= got, sorted(want - got)
    assert all(hasattr(port_mod, n) for n in got)
    if sub == "":
        assert port_mod.__version__ == jax_mod.__version__
    if sub == ".tpu":
        import numpy as np
        import torch
        from throttlecrab_tpu.tpu import kernel as jk
        from throttlecrab_tpu_torch.tpu import kernel as pk

        B, N = 8, 32
        rng = np.random.default_rng(3)
        slots = np.array([1, 2, 3, 1, 4, 5, 6, 7], np.int32)
        rank = np.array([0, 0, 0, 1, 0, 0, 0, 0], np.int32)
        is_last = np.array([0, 1, 1, 1, 1, 1, 1, 1], bool)
        em = np.full(B, 10**9, np.int64)
        tol = np.full(B, 3 * 10**9, np.int64)
        q = rng.integers(0, 3, B).astype(np.int64)
        q[0] = q[3]
        valid = np.ones(B, bool)
        now = 1_700_000_000 * 10**9
        j_state = jk.pack_state(np.zeros(N, np.int64),
                                np.full(N, jk.EMPTY_EXPIRY, np.int64))
        p_state = pk.pack_state(torch.zeros(N, dtype=torch.int64),
                                torch.full((N,), pk.EMPTY_EXPIRY,
                                           dtype=torch.int64))
        j_state, j_out = jax_mod.gcra_batch(
            j_state, slots, rank, is_last, em, tol, q, valid, now)
        t = torch.from_numpy
        p_state, p_out = port_mod.gcra_batch(
            p_state, t(slots), t(rank), t(is_last), t(em), t(tol), t(q),
            t(valid), now)
        np.testing.assert_array_equal(np.asarray(j_out), p_out.numpy())
        np.testing.assert_array_equal(np.asarray(j_state)[:N - B],
                                      p_state.numpy()[:N - B])
