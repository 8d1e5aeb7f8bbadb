"""The port's decision window (throttlecrab_tpu_torch/tpu/fused.py) against
the JAX package's.

On the CPU the port's wrappers run the plain version of the CUDA kernel
(tpu/kernel.py), so these tests pin that plain version — the oracle the
kernel is held against on the card — to both JAX references: the fused
Pallas kernel in interpret mode and the composed-XLA packed scan.
Tolerance: exact equality (integer arithmetic throughout) on valid-lane
outputs, real-slot state rows, the expired-hit accumulator and the
insight totals.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from throttlecrab_tpu.tpu import pallas_fused as jax_fused
from throttlecrab_tpu.tpu.kernel import (
    gcra_scan_packed_acc as jax_scan_acc,
    gcra_scan_packed_ins as jax_scan_ins,
)
from throttlecrab_tpu_torch.tpu import fused, kernel
from torch_windows import (
    NS,
    T0,
    TIERS,
    fresh_state,
    out_mask,
    rand_window,
)


def _run(which, seed, K, B, cap, width, compact, with_degen, steps=2):
    """Drive the port's wrapper and one JAX reference over the same
    windows; assert bit-identity at every step."""
    rng = np.random.default_rng(seed)
    N = cap + B
    st_j = jnp.asarray(fresh_state(N, width))
    st_t = torch.from_numpy(fresh_state(N, width))
    acc_j, acc_t = jnp.zeros((), jnp.int64), torch.zeros((), dtype=torch.int64)
    ic_j, ic_t = jnp.zeros((2,), jnp.int64), torch.zeros(2, dtype=torch.int64)
    kw = dict(with_degen=with_degen, compact=compact)
    for step in range(steps):
        packed, now, valid = rand_window(rng, K, B, cap, with_degen)
        now = now + step * 200 * NS
        pj, nj = jnp.asarray(packed), jnp.asarray(now)
        pt, nt = torch.from_numpy(packed), torch.from_numpy(now)
        if width > 4:
            ref = (
                jax_fused.gcra_scan_packed_fused_ins
                if which == "interpret" else jax_scan_ins
            )
            st_j, acc_j, ic_j, out_j = ref(st_j, acc_j, ic_j, pj, nj, **kw)
            st_t, acc_t, ic_t, out_t = fused.gcra_scan_packed_fused_ins(
                st_t, acc_t, ic_t, pt, nt, **kw
            )
            assert (np.asarray(ic_j) == ic_t.numpy()).all(), "insight totals"
        else:
            ref = (
                jax_fused.gcra_scan_packed_fused_acc
                if which == "interpret" else jax_scan_acc
            )
            st_j, acc_j, out_j = ref(st_j, acc_j, pj, nj, **kw)
            st_t, acc_t, out_t = fused.gcra_scan_packed_fused_acc(
                st_t, acc_t, pt, nt, **kw
            )
        oj, ot = np.asarray(out_j), out_t.numpy()
        assert oj.shape == ot.shape and oj.dtype == ot.dtype
        bad = (oj != ot) & out_mask(valid, compact)
        assert not bad.any(), (
            f"out diverged ({which}, {compact=}, {with_degen=}, {width=}, "
            f"{step=}): {np.argwhere(bad)[:4]}"
        )
        assert (
            np.asarray(st_j)[:cap] == st_t.numpy()[:cap]
        ).all(), "stored state diverged"
        assert int(acc_j) == int(acc_t), "expired-hit accumulator"


@pytest.mark.parametrize("which", ["interpret", "xla"])
@pytest.mark.parametrize("width", [4, 6])
@pytest.mark.parametrize("compact,with_degen", TIERS)
def test_window_bit_identical_to_jax(which, width, compact, with_degen):
    """Every output tier, both row widths, exact and certified paths, on
    hostile windows (duplicate segments, degenerate orbits, invalid
    lanes), with state carried over two windows."""
    _run(which, 7 * width + len(str(compact)), K=2, B=16, cap=32,
         width=width, compact=compact, with_degen=with_degen)


@pytest.mark.parametrize("K,B", [(1, 4), (1, 16), (3, 8), (2, 48)])
def test_ring_and_shape_edges(K, B):
    """Batch widths below / at / above the TPU kernel's DMA ring depth and
    non-power-of-two lane counts (the port has no ring; the shapes pin
    the lane indexing and the scratch rows N - B + i)."""
    _run("xla", 99 + K * B, K=K, B=B, cap=64, width=4, compact=True,
         with_degen=True, steps=1)


def test_scratch_tail_takes_suppressed_writes():
    """A denied-everywhere window leaves the real rows identical to the
    JAX package's, and the suppressed lanes' rows land in the scratch
    tail, never on a real slot."""
    B, cap = 16, 8
    slots = np.zeros((1, B), np.int32)
    rank = np.arange(B, dtype=np.int32)[None]
    is_last = np.zeros((1, B), bool)
    is_last[0, -1] = True
    em = np.full((1, B), NS, np.int64)
    tol = np.zeros((1, B), np.int64)
    q = np.full((1, B), 2, np.int64)
    valid = np.ones((1, B), bool)
    packed = kernel.pack_requests(slots, rank, is_last, em, tol, q, valid)
    now = np.array([T0], np.int64)
    st_j, _, out_j = jax_scan_acc(
        jnp.asarray(fresh_state(cap + B, 4)), jnp.zeros((), jnp.int64),
        jnp.asarray(packed), jnp.asarray(now),
        with_degen=True, compact=True,
    )
    st_t = torch.from_numpy(fresh_state(cap + B, 4))
    _, _, out_t = fused.gcra_scan_packed_fused_acc(
        st_t, torch.zeros((), dtype=torch.int64), torch.from_numpy(packed),
        torch.from_numpy(now), with_degen=True, compact=True,
    )
    assert (np.asarray(out_j) == out_t.numpy()).all()
    assert (np.asarray(st_j)[:cap] == st_t.numpy()[:cap]).all()
    # Only slot 0 and the scratch rows may have been written.
    untouched = fresh_state(cap + B, 4)[1:cap]
    assert (st_t.numpy()[1:cap] == untouched).all()


def test_certified_tiers_refuse_exact_path():
    """compact "cur"/"w32" have no closed form on the degenerate views:
    asking for them with with_degen=True raises instead of deciding."""
    rng = np.random.default_rng(3)
    packed, now, _ = rand_window(rng, 1, 8, 16, True)
    for compact in ("cur", "w32"):
        with pytest.raises(ValueError):
            fused.fused_window(
                torch.from_numpy(fresh_state(24, 4)),
                torch.from_numpy(packed), torch.from_numpy(now),
                with_degen=True, compact=compact,
            )


def test_cpu_tensor_takes_plain_version_and_counts_no_launch():
    """On a CPU tensor the wrapper runs the plain version and the launch
    counter does not move (it counts kernel launches only)."""
    before = fused.LAUNCHES
    rng = np.random.default_rng(4)
    packed, now, _ = rand_window(rng, 2, 8, 16, False)
    fused.fused_window(
        torch.from_numpy(fresh_state(24, 4)), torch.from_numpy(packed),
        torch.from_numpy(now), with_degen=False, compact="w32",
    )
    assert fused.LAUNCHES == before
