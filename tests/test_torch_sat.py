"""The port's saturating lattice and row packers against the JAX package's.

A property sweep over random int64 values spliced with the 2^31 / 2^32 /
2^62 / 2^63 edges: every helper of throttlecrab_tpu_torch/tpu/sat.py and
every packer of its kernel.py must be bit-identical to
throttlecrab_tpu/tpu/sat.py and kernel.py.  Exact equality.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from throttlecrab_tpu.tpu import kernel as jk
from throttlecrab_tpu.tpu import sat as jsat
from throttlecrab_tpu_torch.tpu import kernel as tk
from throttlecrab_tpu_torch.tpu import sat as tsat

NS = 1_000_000_000

I64_EDGES = np.array(
    [
        0, 1, -1, 2, -2, (1 << 31) - 1, 1 << 31, -(1 << 31),
        -(1 << 31) - 1, (1 << 32) - 1, 1 << 32, -(1 << 32), (1 << 61),
        (1 << 62) - 1, 1 << 62, -(1 << 62), (1 << 63) - 1, -(1 << 63),
        -(1 << 63) + 1, NS, -NS, 977,
    ],
    dtype=np.int64,
)


def _rand_i64(rng, n):
    vals = rng.integers(-(1 << 63), 1 << 63, n, dtype=np.int64)
    idx = rng.choice(n, size=len(I64_EDGES), replace=False)
    vals[idx] = I64_EDGES
    return vals


def _pairs(seed, n=1024):
    rng = np.random.default_rng(seed)
    a, b = _rand_i64(rng, n), _rand_i64(rng, n)
    # every edge against every edge, too
    ea, eb = np.meshgrid(I64_EDGES, I64_EDGES)
    return np.concatenate([a, ea.ravel()]), np.concatenate([b, eb.ravel()])


def _t(x):
    return torch.from_numpy(np.array(x, copy=True))


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize(
    "name", ["sat_add", "sat_sub", "sat_add_nn", "sat_sub_nn",
             "sat_mul_nonneg", "div_trunc"],
)
def test_sat_helpers_match_jax(seed, name):
    a, b = _pairs(seed)
    if name in ("sat_add_nn", "sat_sub_nn"):
        b = np.abs(b) % (1 << 62)  # nn forms: b >= 0 contract
    if name == "sat_mul_nonneg":
        # the contract's domain, plus operands outside it (rejected
        # lanes reach the helper too and must still match)
        a = np.where(np.arange(len(a)) % 2 == 0, np.abs(a) % (1 << 62), a)
    want = np.asarray(getattr(jsat, name)(jnp.asarray(a), jnp.asarray(b)))
    got = getattr(tsat, name)(_t(a), _t(b)).numpy()
    assert got.dtype == np.int64
    bad = got != want
    assert not bad.any(), (name, a[bad][:4], b[bad][:4])


@pytest.mark.parametrize("seed", [0, 1])
def test_state_packers_match_jax(seed):
    a, b = _pairs(seed)
    want = np.asarray(jk.pack_state(jnp.asarray(a), jnp.asarray(b)))
    got = tk.pack_state(_t(a), _t(b)).numpy()
    assert got.dtype == np.int32 and (got == want).all()
    tat, exp = tk.unpack_state(_t(want))
    assert (tat.numpy() == a).all() and (exp.numpy() == b).all()
    # the insight deny columns use the same split
    six = np.concatenate([want, want[:, :2]], axis=1)
    assert (tk.unpack_deny(_t(six)).numpy() == a).all()
    assert (
        np.asarray(jk.unpack_deny(jnp.asarray(six))) == a
    ).all()


def test_lo_hi_split_matches_numpy_view():
    """The wrapping i64 -> (lo, hi) i32 split against numpy's byte view,
    at the 2^31 / 2^32 / 2^63 edges."""
    x = I64_EDGES
    lohi = tk._split_cols(_t(x)).numpy()
    view = x.view(np.int32).reshape(-1, 2)  # little-endian: lo, hi
    assert (lohi == view).all()


@pytest.mark.parametrize("seed", [0, 1])
def test_request_packer_matches_jax(seed):
    rng = np.random.default_rng(seed)
    shape = (3, 40)
    slots = rng.integers(-5, 1 << 20, shape).astype(np.int32)
    rank = rng.integers(0, 1 << 16, shape).astype(np.int32)
    is_last = rng.random(shape) < 0.5
    valid = rng.random(shape) < 0.5
    em, tol = (_rand_i64(rng, 120).reshape(shape) for _ in range(2))
    q = _rand_i64(rng, 120).reshape(shape)
    args = (slots, rank, is_last, em, tol, q, valid)
    assert (tk.pack_requests(*args) == jk.pack_requests(*args)).all()


def test_host_certificates_match_jax():
    """fits_w32_wire / cur_wire_safe / finish_cur / finish_w32 on the
    same inputs: the tier choice and the host finishing must agree."""
    rng = np.random.default_rng(5)
    for _ in range(40):
        n = 32
        valid = rng.random(n) < 0.8
        em = rng.choice([1, 1000, NS, 7 * NS, 60 * NS], n).astype(np.int64)
        tol = rng.choice(
            [1, NS, 100 * NS, 3000 * NS, (1 << 61) + 1], n
        ).astype(np.int64)
        q = rng.choice([1, 2, 5], n).astype(np.int64)
        now = int(rng.choice([NS, 1 << 60, (1 << 61) + 5]))
        hwm = int(rng.choice([0, 50 * NS, 1 << 61]))
        now_hwm = int(rng.choice([0, now, now + 1]))
        assert tk.fits_w32_wire(valid, em, tol, q, now, hwm, now_hwm) == (
            jk.fits_w32_wire(valid, em, tol, q, now, hwm, now_hwm)
        )
        assert tk.cur_wire_safe(valid, tol, now) == jk.cur_wire_safe(
            valid, tol, now
        )
        assert tk.fits_cur_wire(tol, now) == jk.fits_cur_wire(tol, now)
        agg = (int(tol.max()), int(tol.min()), int((em * q).max()), 3)
        assert tk.fits_w32_wire_agg(*agg, now, hwm, now_hwm) == (
            jk.fits_w32_wire_agg(*agg, now, hwm, now_hwm)
        )
        cur2 = rng.integers(-(1 << 40), 1 << 62, n)
        for a, b in zip(
            tk.finish_cur(cur2, em, tol, q, now),
            jk.finish_cur(cur2, em, tol, q, now),
        ):
            assert (a == b).all()
        words = rng.integers(-(1 << 31), 1 << 31, n).astype(np.int32)
        for a, b in zip(tk.finish_w32(words), jk.finish_w32(words)):
            assert (a == b).all()
