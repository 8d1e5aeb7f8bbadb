"""The tiny cell on the card: the timed path is the window kernel, the
traced run's profiler session reads every launch, and the reference
agrees.  Skips where there is no CUDA card (decided in the fixture)."""

import pytest

from portbench import run
from portbench.tests.tiny import make_root


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the window kernel has no CPU twin "
                    "in this run")


@pytest.mark.cuda
@pytest.mark.parametrize("traced", [False, True])
def test_tiny_cell_on_the_card(card, tmp_path, traced):
    out = run.run_cell(make_root(tmp_path), "tiny", 11, 1.0, traced,
                       device="cuda", log=lambda *a, **k: None)
    assert out["correct"], out["compared"]
    assert out["compared"]["fused_launches_off"]["value"] == 0
    if traced:
        assert 0 < out["device"]["busy_s"] <= out["device"]["window_s"]
        assert 0 < out["metrics"]["ids_window_roofline"]["value"] <= 100
