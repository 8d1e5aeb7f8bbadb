"""The CUDA decision-window kernel against its plain version, on the card.

Needs a CUDA card: the tests carry the `cuda` marker and skip elsewhere
(decided in a fixture when they run).  The file imports nothing of jax,
so it runs where only the port is installed:

    python -m pytest tests/test_torch_card.py --noconftest -q

Tolerance: exact equality (integer arithmetic) on valid-lane outputs,
real-slot state and the expired-hit counts.
"""

import numpy as np
import pytest
import torch

from throttlecrab_tpu_torch.tpu import fused, kernel
from torch_windows import TIERS, fresh_state, out_mask, rand_window


@pytest.fixture
def cuda_device():
    """The card, or a skip: decided when the test runs, never at import."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; run on the chip (README)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_kernel_matches_plain_version_on_card(cuda_device):
    """Every tier and width, two consecutive hostile windows."""
    for width in (4, 6):
        for compact, with_degen in TIERS:
            rng = np.random.default_rng(width + len(str(compact)))
            K, B, cap = 4, 256, 512
            st_k = torch.from_numpy(fresh_state(cap + B, width)).to(
                cuda_device
            )
            st_p = st_k.clone()
            for _ in range(2):
                packed, now, valid = rand_window(rng, K, B, cap, with_degen)
                p = torch.from_numpy(packed).to(cuda_device)
                n = torch.from_numpy(now).to(cuda_device)
                out_k, ne_k = fused.fused_window(
                    st_k, p, n, with_degen=with_degen, compact=compact
                )
                out_p, ne_p = kernel.decide_window(
                    st_p, p, n, with_degen=with_degen, compact=compact
                )
                torch.cuda.synchronize()
                mask = out_mask(valid, compact)
                assert not (
                    (out_k.cpu().numpy() != out_p.cpu().numpy()) & mask
                ).any()
                assert torch.equal(st_k[:cap], st_p[:cap])
                assert torch.equal(ne_k, ne_p)


@pytest.mark.cuda
def test_wrapper_rejects_what_the_kernel_does_not_take(cuda_device):
    """Wrong dtype, width or batch raises before any launch; nothing
    falls back to the plain version."""
    rng = np.random.default_rng(9)
    packed, now, _ = rand_window(rng, 1, 8, 16, True)
    p = torch.from_numpy(packed).to(cuda_device)
    n = torch.from_numpy(now).to(cuda_device)
    before = fused.LAUNCHES
    with pytest.raises(ValueError):
        fused.fused_window(torch.zeros((24, 5), dtype=torch.int32,
                                       device=cuda_device), p, n)
    with pytest.raises(TypeError):
        fused.fused_window(torch.zeros((24, 4), dtype=torch.int64,
                                       device=cuda_device), p, n)
    with pytest.raises(ValueError):
        fused.fused_window(torch.zeros((4, 4), dtype=torch.int32,
                                       device=cuda_device), p, n)
    assert fused.LAUNCHES == before
    fused.fused_window(torch.from_numpy(fresh_state(24, 4)).to(cuda_device),
                       p, n)
    assert fused.LAUNCHES == before + 1
