"""The port's row gather/scatter (tpu/row_ops.py) against the JAX package's
Pallas row kernels.

On the CPU the wrappers take their plain version (`index_select` /
`index_copy_`), the oracle the CUDA kernels are held against on the card
(tests/test_torch_card.py, chip_smoke.py).  Here that plain version is
pinned to `throttlecrab_tpu/tpu/pallas_ops.py` run in interpret mode, as
tests/test_pallas_ops.py runs it (4-wide rows, the only width the
Pallas kernels take), and to numpy indexing at both widths.  The
wrappers' argument checks raise on the CPU as they do on the card.

Tolerance: exact equality.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from throttlecrab_tpu.tpu import pallas_ops
from throttlecrab_tpu_torch.tpu import row_ops

I32 = (-(2**31), 2**31 - 1)


@pytest.mark.parametrize("B", [64, 512])
def test_gather_matches_pallas(B):
    rng = np.random.default_rng(1)
    N = 8192
    table = rng.integers(*I32, (N, 4)).astype(np.int32)
    idx = rng.integers(0, N, B).astype(np.int32)
    idx[:2] = [0, N - 1]
    want = np.asarray(pallas_ops.row_gather(jnp.asarray(table),
                                            jnp.asarray(idx)))
    got = row_ops.row_gather(torch.from_numpy(table), torch.from_numpy(idx))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("B", [64, 512])
def test_scatter_matches_pallas(B):
    rng = np.random.default_rng(2)
    N = 8192
    base = rng.integers(*I32, (N, 4)).astype(np.int32)
    # Unique target rows, as the callers guarantee (scratch redirection).
    idx = np.concatenate(
        [[0, N - 1], 1 + rng.choice(N - 2, B - 2, replace=False)]
    ).astype(np.int32)
    rows = rng.integers(*I32, (B, 4)).astype(np.int32)
    want = np.asarray(pallas_ops.row_scatter(
        jnp.asarray(base), jnp.asarray(idx), jnp.asarray(rows)
    ))
    table = torch.from_numpy(base.copy())
    out = row_ops.row_scatter(table, torch.from_numpy(idx),
                              torch.from_numpy(rows))
    assert out is table  # in place
    np.testing.assert_array_equal(table.numpy(), want)


@pytest.mark.parametrize("W", row_ops.WIDTHS)
def test_roundtrip_matches_numpy(W):
    """Both widths against numpy indexing; the wrappers and the PLAIN
    namespace (the composed decide's plain row movement) agree."""
    rng = np.random.default_rng(3 + W)
    N, B = 4096, 256
    base = rng.integers(*I32, (N, W)).astype(np.int32)
    idx = rng.choice(N, B, replace=False).astype(np.int32)
    rows = rng.integers(*I32, (B, W)).astype(np.int32)
    t_idx, t_rows = torch.from_numpy(idx), torch.from_numpy(rows)
    for ops in (row_ops, row_ops.PLAIN):
        table = torch.from_numpy(base.copy())
        np.testing.assert_array_equal(
            ops.row_gather(table, t_idx).numpy(), base[idx]
        )
        ops.row_scatter(table, t_idx, t_rows)
        want = base.copy()
        want[idx] = rows
        np.testing.assert_array_equal(table.numpy(), want)


def test_cpu_tensors_never_count_launches():
    before = (row_ops.GATHER_LAUNCHES, row_ops.SCATTER_LAUNCHES)
    table = torch.zeros((16, 4), dtype=torch.int32)
    idx = torch.arange(4, dtype=torch.int32)
    row_ops.row_scatter(table, idx, row_ops.row_gather(table, idx) + 1)
    assert (row_ops.GATHER_LAUNCHES, row_ops.SCATTER_LAUNCHES) == before


def _bad_calls():
    t4 = torch.zeros((16, 4), dtype=torch.int32)
    idx = torch.arange(4, dtype=torch.int32)
    rows = torch.zeros((4, 4), dtype=torch.int32)
    return [
        (TypeError, lambda: row_ops.row_gather(t4.long(), idx)),
        (TypeError, lambda: row_ops.row_gather(t4, idx.long())),
        (TypeError, lambda: row_ops.row_scatter(t4, idx, rows.long())),
        (ValueError, lambda: row_ops.row_gather(
            torch.zeros((16, 5), dtype=torch.int32), idx)),
        (ValueError, lambda: row_ops.row_gather(t4[:, :2], idx)),
        (ValueError, lambda: row_ops.row_gather(t4.t(), idx)),
        (ValueError, lambda: row_ops.row_gather(t4, idx[::2])),
        (ValueError, lambda: row_ops.row_gather(t4, idx[:0])),
        (ValueError, lambda: row_ops.row_gather(
            t4, torch.zeros(17, dtype=torch.int32))),
        (ValueError, lambda: row_ops.row_gather(t4, idx[None])),
        (ValueError, lambda: row_ops.row_scatter(t4, idx, rows[:3])),
        (ValueError, lambda: row_ops.row_scatter(
            t4, idx, torch.zeros((4, 6), dtype=torch.int32))),
    ]


@pytest.mark.parametrize("case", range(len(_bad_calls())))
def test_wrappers_reject_what_the_kernels_do_not_take(case):
    err, call = _bad_calls()[case]
    with pytest.raises(err):
        call()
