"""The compact="w32" output's host finish (`kernel.finish_w32`): the
native pass (csrc/finish_w32.cpp `tk_finish_w32`) against the numpy
expression and the JAX package's `finish_w32`, bit for bit.

Checked: every size from empty to a 1M-word window, on random words,
all-ones words, each field at its maximum and negative words; input
given as int64, as a non-contiguous slice and as a CPU torch tensor, and
a 2-D window keeping its shape; a result still held is unchanged after
twenty later calls of its size (the pooled buffers never alias one in
use), a dropped large result's buffer is handed out again and a small
one's is not kept; sixteen threads finishing at once each get their own
answers and the counter of natively decoded words loses no update; and
without the native library the numpy expression is the path, with the
same results.  The probe that times these ways of decoding on a host
(`tools/probe_finish_w32.py`) runs each arm and decodes alike."""

import sys
import threading

import numpy as np
import pytest
import torch

from throttlecrab_tpu.tpu import kernel as jax_kernel
from throttlecrab_tpu_torch import native
from throttlecrab_tpu_torch.tpu import kernel
from throttlecrab_tpu_torch.tpu.kernel import (
    W32_REM_MAX,
    W32_RESET_MAX,
    W32_RETRY_MAX,
    finish_w32,
)

SIZES = [0, 1, 255, 4097, 1 << 20]
POOLED = kernel._W32_POOL_MIN + 1  # a window large enough for the pool


@pytest.fixture(autouse=True)
def needs_native():
    if native.get_finish_lib() is None:
        if native.toolchain_available():
            pytest.fail(f"finish build failed: {native.finish_build_error()}")
        pytest.skip("no C++ toolchain: the numpy path alone is left")


def numpy_finish(words):
    """The numpy expression finish_w32 ran before the native pass."""
    u = np.ascontiguousarray(words, np.int32).view(np.uint32)
    return (
        (u & 1).astype(np.int32),
        ((u >> 1) & np.uint32(W32_REM_MAX)).astype(np.int32),
        ((u >> 11) & np.uint32(W32_RESET_MAX)).astype(np.int32),
        ((u >> 22) & np.uint32(W32_RETRY_MAX)).astype(np.int32),
    )


def make_words(kind, n, seed=7):
    rng = np.random.default_rng([seed, n])
    if kind == "random":
        return rng.integers(-(1 << 31), 1 << 31, n, dtype=np.int64).astype(
            np.int32)
    if kind == "ones":
        return np.full(n, -1, np.int32)
    if kind == "field_max":  # each field alone at its maximum, in turn
        one = np.array([1, W32_REM_MAX << 1, W32_RESET_MAX << 11,
                        W32_RETRY_MAX << 22], np.int64)
        return np.resize(one, n).astype(np.uint32).view(np.int32)
    if kind == "negative":
        return rng.integers(-(1 << 31), 0, n, dtype=np.int64).astype(np.int32)
    raise ValueError(kind)


def assert_same(got, want):
    assert len(got) == 4 == len(want)
    for g, w in zip(got, want):
        assert isinstance(g, np.ndarray) and g.dtype == np.int32
        assert g.shape == w.shape
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("kind", ["random", "ones", "field_max", "negative"])
@pytest.mark.parametrize("n", SIZES)
def test_native_pass_matches_numpy_and_the_reference(n, kind):
    words = make_words(kind, n)
    got = finish_w32(words)
    assert_same(got, numpy_finish(words))
    assert_same(got, jax_kernel.finish_w32(words))


@pytest.mark.parametrize("given", ["int64", "strided", "torch", "2d"])
def test_input_conversion(given):
    words = make_words("random", 2 * 4097)
    arg = {
        "int64": words.astype(np.int64),
        "strided": words[::2],
        "torch": torch.from_numpy(words),
        "2d": words.reshape(2, 4097),
    }[given]
    want = numpy_finish(arg)
    assert_same(finish_w32(arg), want)
    assert_same(finish_w32(arg), jax_kernel.finish_w32(np.asarray(arg)))


def test_a_held_result_is_never_overwritten():
    words = make_words("random", POOLED)
    held = finish_w32(words)
    want = [p.copy() for p in held]
    for k in range(20):
        out = finish_w32(make_words("random", POOLED, seed=100 + k))
        assert all(not np.shares_memory(o, h) for o in out for h in held)
        del out
    assert_same(held, want)
    # A view that outlives the tuple keeps the buffer out of the pool.
    tail = held[3][1:]
    del held
    for k in range(20):
        finish_w32(make_words("ones", POOLED))
    np.testing.assert_array_equal(tail, want[3][1:])


def test_a_dropped_result_is_reused():
    words = make_words("random", POOLED)
    first = finish_w32(words)
    at = first[0].__array_interface__["data"][0]
    del first
    again = finish_w32(make_words("ones", POOLED))
    assert again[0].__array_interface__["data"][0] == at
    assert_same(again, numpy_finish(make_words("ones", POOLED)))


@pytest.mark.parametrize("n", [1, 4096, kernel._W32_POOL_MIN - 1])
def test_a_small_result_stays_out_of_the_pool(n):
    with kernel._w32_lock:
        kept = {k: len(v) for k, v in kernel._w32_free.items()}
    got = finish_w32(make_words("random", n))
    assert_same(got, numpy_finish(make_words("random", n)))
    del got
    with kernel._w32_lock:
        assert {k: len(v) for k, v in kernel._w32_free.items()} == kept
        assert n not in kernel._w32_free


def test_many_threads_share_the_pool_and_the_counter():
    """16 threads, each finishing its own words over and over with the
    interpreter switching threads every microsecond: a buffer handed to
    two threads at once, or a lost update of the counter, shows."""
    n, rounds, threads = POOLED, 20, 16
    inputs = [make_words("random", n, seed=200 + t) for t in range(threads)]
    wants = [numpy_finish(w) for w in inputs]
    bad, done = [], []

    def worker(t):
        for _ in range(rounds):
            got = finish_w32(inputs[t])
            if not all(np.array_equal(g, w) for g, w in zip(got, wants[t])):
                bad.append(t)
        done.append(t)

    before = kernel.FINISH_W32_NATIVE_WORDS
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        pool = [threading.Thread(target=worker, args=(t,))
                for t in range(threads)]
        for th in pool:
            th.start()
        for th in pool:
            th.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(th.is_alive() for th in pool)
    assert sorted(done) == list(range(threads)) and not bad
    assert kernel.FINISH_W32_NATIVE_WORDS - before == threads * rounds * n


@pytest.mark.parametrize("n", [0, 4097])
def test_without_the_native_library_numpy_decodes(monkeypatch, n):
    words = make_words("random", n)
    native_out = finish_w32(words)
    before = kernel.FINISH_W32_NATIVE_WORDS
    monkeypatch.setattr(native, "get_finish_lib", lambda: None)
    got = finish_w32(words)
    assert kernel.FINISH_W32_NATIVE_WORDS == before
    assert_same(got, numpy_finish(words))
    assert_same(got, native_out)


@pytest.mark.parametrize("served", [False, True], ids=["pool", "served"])
def test_the_probe_times_every_arm(capsys, served):
    """tools/probe_finish_w32.py: each arm decodes as the numpy expression
    (it checks that first) and prints its line."""
    from throttlecrab_tpu_torch.tools import probe_finish_w32 as probe

    words = make_words("random", POOLED)
    for name, fn in probe.ARMS.items():
        assert_same(fn(words), numpy_finish(words))
    argv = ["--words", str(POOLED), "--threads", "2", "--rounds", "3"]
    assert probe.main(argv + (["--served"] if served else [])) == 0
    lines = capsys.readouterr().out.splitlines()
    want = ["numpy", "native"] if served else list(probe.ARMS)
    assert [ln.split()[1 if served else 0] for ln in lines] == want
