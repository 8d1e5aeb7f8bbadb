"""The port's native keymap (throttlecrab_tpu_torch/native.py) and the paths
that need it, against the JAX package's.

Both packages build the same unmodified native/keymap.cpp, each through
its own loader; the port's goes into throttlecrab_tpu_torch/build/ under
a name keyed by a hash of the source and flags.  `NativeKeyMap` is held
against the JAX one method by method on the same call sequence;
`TorchRateLimiter(keymap="native", device="cpu")` against
`TpuRateLimiter(keymap="native")` through str-keyed batches (the bytes
key encoding) and `dispatch_wire_window` on the same frames, across the
output tiers.  Tolerance: exact equality.
"""

import threading

import numpy as np
import pytest

from throttlecrab_tpu import native as jn
from throttlecrab_tpu.tpu.limiter import TpuRateLimiter
from throttlecrab_tpu.tpu.limiter import (
    limiter_uses_bytes_keys as jax_uses_bytes,
)
from throttlecrab_tpu_torch import native as tn
from throttlecrab_tpu_torch.tpu.keymap import PyKeyMap
from throttlecrab_tpu_torch.tpu.limiter import (
    TorchRateLimiter,
    limiter_uses_bytes_keys,
)

NS = 1_000_000_000
T0 = 1_753_700_000 * NS


@pytest.fixture
def pair():
    """(JAX keymap, port keymap); a missing toolchain fails, not skips."""
    assert tn.toolchain_available(), "g++ is needed to build the keymap"
    assert tn.keymap_build_error() is None, tn.keymap_build_error()
    return jn.NativeKeyMap(64), tn.NativeKeyMap(64)


def both(pair, method, *args, **kw):
    """Call `method` on both keymaps; assert equal results and state."""
    a = getattr(pair[0], method)(*args, **kw)
    b = getattr(pair[1], method)(*args, **kw)
    _assert_same(a, b, method)
    assert len(pair[0]) == len(pair[1]) and (
        pair[0].capacity == pair[1].capacity
    ), method
    assert pair[0].mutations == pair[1].mutations, method
    return b


def _assert_same(a, b, what):
    if isinstance(a, tuple):
        assert len(a) == len(b), what
        for x, y in zip(a, b):
            _assert_same(x, y, what)
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype, what
        np.testing.assert_array_equal(a, b, err_msg=what)
    else:
        assert a == b, what


def test_build_is_keyed_by_source_and_flags():
    assert tn.native_available()
    lib_path = next(tn.BUILD_DIR.glob("libtkkeymap_*.so"), None)
    assert lib_path is not None
    assert len(lib_path.stem.rsplit("_", 1)[1]) == 16


def test_concurrent_builds_never_expose_a_partial_library(tmp_path,
                                                          monkeypatch):
    """Builders racing on one build directory each rename a finished
    library into place; every one of them gets a loadable path."""
    monkeypatch.setattr(tn, "BUILD_DIR", tmp_path)
    results = []

    def build():
        results.append(tn._compile(tn._SRC, "libtkkeymap"))

    threads = [threading.Thread(target=build) for _ in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    assert len(results) == 3 and all(err is None for _, err in results)
    assert len({path for path, _ in results}) == 1
    assert [p.name for p in tmp_path.iterdir()] == [results[0][0].name]
    import ctypes

    assert ctypes.CDLL(str(results[0][0])).tk_len is not None


def test_build_failure_carries_the_compiler_error(tmp_path, monkeypatch):
    bad = tmp_path / "broken.cpp"
    bad.write_text("int main( {\n")
    monkeypatch.setattr(tn, "BUILD_DIR", tmp_path / "build")
    path, error = tn._compile(bad, "libbroken")
    assert path is None and "broken.cpp" in error and "error" in error
    assert not any((tmp_path / "build").glob("*.tmp"))


def test_resolve_free_grow_items(pair):
    rng = np.random.default_rng(4)
    keys = [b"k:%d" % i for i in rng.integers(0, 40, 48)]
    valid = rng.random(48) < 0.9
    slots, _, _, n_full = both(pair, "resolve", keys, valid)
    assert n_full == 0
    both(pair, "free_slots", np.unique(slots[slots >= 0])[:5])
    both(pair, "resolve", keys[::-1], np.ones(48, bool))
    big = [b"g:%d" % i for i in range(80)]
    _, _, _, n_full = both(pair, "resolve", big, np.ones(80, bool))
    assert n_full > 0
    both(pair, "grow", 256)
    both(pair, "resolve", big + ["été".encode(), b"x" * 300],
         np.ones(82, bool))
    assert sorted(pair[0].items()) == sorted(pair[1].items())


def test_intern_assemble_and_finish(pair):
    """intern -> resolve_all -> assemble / assemble_ids -> finish,
    finish_ids, finish_raw on the same ids and device words."""
    n = 40
    assert both(pair, "intern", [b"id:%d" % i for i in range(n)]) == 0
    assert both(pair, "intern", [b"late:%d" % i for i in range(4)]) == n
    n += 4
    rng = np.random.default_rng(8)
    em = (np.arange(n, dtype=np.int64) % 7 + 1) * 250_000_000
    tol = em * (np.arange(n, dtype=np.int64) % 5 + 2)
    ids = rng.integers(0, n, 96).astype(np.int32)
    ids[[3, 50]] = -1
    ids[60] = n + 5  # not interned
    packed, _ = both(pair, "assemble", ids, 32, em, tol, 1)
    slots = both(pair, "resolve_all")
    assert pair[1].last_resolve_failures == 0
    words, n_bad = both(pair, "assemble_ids", ids, 32)
    assert n_bad == 1
    cur2 = rng.integers(0, 1 << 61, 96) * 2 + rng.integers(0, 2, 96)
    both(pair, "finish", packed, cur2, T0)
    both(pair, "finish_ids", words, em, tol, 1, cur2, T0)
    raw = np.where((ids >= 0) & (ids < n), ids, -1).astype(np.int32)
    both(pair, "finish_raw", raw, em, tol, 1, cur2, T0)
    assert (slots >= 0).all()
    for km in pair:
        with pytest.raises(ValueError):
            km.assemble(ids, 32, em[:3], tol, 1)
        with pytest.raises(ValueError):
            km.assemble_ids(ids, 1 << 15)
        with pytest.raises(ValueError):
            km.finish_raw(np.array([0, n], np.int32), em, tol, 1,
                          np.zeros(2, np.int64), T0)


def test_resolve_all_on_a_full_table(pair):
    both(pair, "intern", [b"f:%d" % i for i in range(80)])
    with pytest.warns(RuntimeWarning):
        pair[0].resolve_all()
    with pytest.warns(RuntimeWarning):
        slots = pair[1].resolve_all()
    assert (slots == -1).sum() == pair[1].last_resolve_failures == 16
    for km in pair:
        with pytest.raises(ValueError):
            km.resolve_all(strict=True)


def _frame(keys, params):
    blob = b"".join(keys)
    offsets = np.zeros(len(keys) + 1, np.int64)
    np.cumsum([len(k) for k in keys], out=offsets[1:])
    return blob, offsets, np.asarray(params, np.int64)


def test_prepare_batch(pair):
    rng = np.random.default_rng(12)
    keys = [b"p:%d" % i for i in rng.integers(0, 30, 64)]
    kid = np.array([int(k[2:]) for k in keys], np.int64)
    params = np.stack([2 + kid % 9, 5 + kid % 50, 1 + kid % 30,
                       np.ones(64, np.int64)], 1)
    params[5] = [0, 1, 1, 1]    # invalid params
    params[9, 3] = -1           # negative quantity
    blob, offsets, params = _frame(keys, params)
    agg_j, agg_t = np.empty(4, np.int64), np.empty(4, np.int64)
    a = pair[0].prepare_batch(blob, offsets, params, agg=agg_j)
    b = pair[1].prepare_batch(blob, offsets, params, agg=agg_t)
    _assert_same(a, b, "prepare_batch")
    np.testing.assert_array_equal(agg_j, agg_t)
    assert tn.PREP_DEGEN == jn.PREP_DEGEN and tn.PREP_BIGTOL == jn.PREP_BIGTOL
    assert (tn.PREP_CONFLICT, tn.PREP_FULL) == (jn.PREP_CONFLICT,
                                                jn.PREP_FULL)


# ---- the limiter on the native keymap ------------------------------------ #


def _limiters(capacity=256):
    return (
        TpuRateLimiter(capacity=capacity, keymap="native"),
        TorchRateLimiter(capacity=capacity, keymap="native", device="cpu"),
    )


def test_keymap_choice_and_key_identity():
    jl, tl = _limiters()
    assert isinstance(tl.keymap, tn.NativeKeyMap)
    assert limiter_uses_bytes_keys(tl) and jax_uses_bytes(jl)
    assert isinstance(
        TorchRateLimiter(capacity=64, keymap="auto", device="cpu").keymap,
        tn.NativeKeyMap,
    )
    py = TorchRateLimiter(capacity=64, device="cpu")
    assert isinstance(py.keymap, PyKeyMap) and not limiter_uses_bytes_keys(py)
    # A str key and its bytes are one bucket, as in the JAX limiter.
    for lim in (jl, tl):
        lim.rate_limit_batch(["u:1", b"u:1", "u:2"], 3, 1, 60, 1, T0)
    assert sorted(jl.keymap.items()) == sorted(tl.keymap.items())
    assert len(tl) == 2


@pytest.mark.parametrize("wire", [False, True])
def test_str_keyed_batches_match_jax(wire):
    rng = np.random.default_rng(21 + wire)
    jl, tl = _limiters(64)  # small: the keymap grows mid-run
    now = T0
    for _ in range(4):
        kid = rng.integers(0, 90, 128)
        keys = [f"user:{i}" for i in kid]
        q = np.where(kid % 11 == 0, 0, 1)
        batches = [(keys[:64], 2 + kid[:64] % 9, 5 + kid[:64] % 50,
                    1 + kid[:64] % 30, q[:64], now),
                   (keys[64:], 2 + kid[64:] % 9, 5 + kid[64:] % 50,
                    1 + kid[64:] % 30, q[64:], now + NS)]
        ra = jl.rate_limit_many(batches, wire=wire)
        rb = tl.rate_limit_many(batches, wire=wire)
        for a, b in zip(ra, rb):
            for f in ("allowed", "limit", "remaining", "status"):
                np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
        now += 3 * NS
    assert sorted(jl.keymap.items()) == sorted(tl.keymap.items())
    np.testing.assert_array_equal(
        np.asarray(jl.table.state)[: jl.table.capacity],
        tl.table.state.numpy()[: tl.table.capacity],
    )


def _wire_window(rng, n_frames, n, *, degen=False, big=False,
                 conflict=False):
    frames = []
    for _ in range(n_frames):
        kid = rng.integers(0, 50, n)
        keys = [b"w:%d" % i for i in kid]
        period = 1 + kid % 30
        if big:
            period = period * 100_000
        params = np.stack([2 + kid % 9, 5 + kid % 50, period,
                           np.ones(n, np.int64)], 1)
        if degen:
            params[kid % 7 == 0, 3] = 0
        if conflict:
            params[-1, 0] += 1
            keys[-1] = keys[0]
        frames.append(_frame(keys, params))
    return frames


def _tier(handle):
    return "w32" if handle._w32 else (
        "cur" if handle._finish is not None else "planes")


@pytest.mark.parametrize("kind", ["w32", "cur", "planes", "big"])
def test_dispatch_wire_window_matches_jax(kind):
    """Three windows of frames: the tier chosen, every result field and
    the real-slot state equal the JAX limiter's."""
    rng = np.random.default_rng(40 + len(kind))
    jl, tl = _limiters()
    now = T0
    for _ in range(3):
        frames = _wire_window(rng, 3, 40, degen=kind == "planes",
                              big=kind == "big")
        kw = dict(collect_cur=kind == "cur")
        hj = jl.dispatch_wire_window(frames, now, **kw)
        ht = tl.dispatch_wire_window(frames, now, **kw)
        assert _tier(hj) == _tier(ht)
        if kind in ("w32", "cur", "planes"):
            assert _tier(ht) == kind
        for a, b in zip(hj.fetch(), ht.fetch()):
            for f in ("allowed", "limit", "remaining", "reset_after_s",
                      "retry_after_s", "status", "cur_ns"):
                np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
        np.testing.assert_array_equal(
            np.asarray(jl.table.state)[:256], tl.table.state.numpy()[:256]
        )
        now += 2 * NS


def test_dispatch_wire_window_falls_back():
    """None where the window needs the exact Python path: a mid-batch
    parameter change, a full table, or a keymap without prepare_batch."""
    rng = np.random.default_rng(3)
    jl, tl = _limiters()
    frames = _wire_window(rng, 2, 16, conflict=True)
    assert jl.dispatch_wire_window(frames, T0) is None
    assert tl.dispatch_wire_window(frames, T0) is None
    small = TorchRateLimiter(capacity=8, keymap="native", device="cpu")
    assert small.dispatch_wire_window(_wire_window(rng, 1, 40), T0) is None
    py = TorchRateLimiter(capacity=64, device="cpu")
    assert py.dispatch_wire_window(_wire_window(rng, 1, 8), T0) is None
    with pytest.raises(ValueError):
        tl.dispatch_wire_window(_wire_window(rng, 1, 8), -1)
