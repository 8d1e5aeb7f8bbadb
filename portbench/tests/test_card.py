"""The tiny cell on the card: the timed path is the window kernel, the
traced run's profiler session reads every launch, and the reference
agrees.  Each run is a process of its own, as a benchmark run is: a
process's later profiler sessions can lose records.  Skips where there
is no CUDA card (decided in the fixture)."""

import multiprocessing
from concurrent.futures import ProcessPoolExecutor

import pytest

from portbench import run
from portbench.tests.tiny import TINY_MIX, TINY_STRIDED_MIX, make_root


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the window kernel has no CPU twin "
                    "in this run")


def quiet(*_a, **_k):
    pass


def run_tiny(root, traced):
    return run.run_cell(root, "tiny", 11, 1.0, traced, device="cuda",
                        log=quiet)


@pytest.mark.cuda
@pytest.mark.parametrize("mix", [TINY_MIX, TINY_STRIDED_MIX],
                         ids=["plain", "strided"])
@pytest.mark.parametrize("traced", [False, True])
def test_tiny_cell_on_the_card(card, tmp_path, traced, mix):
    spawn = multiprocessing.get_context("spawn")
    with ProcessPoolExecutor(1, mp_context=spawn) as pool:
        out = pool.submit(run_tiny, make_root(tmp_path, mix=mix),
                          traced).result()
    assert out["correct"], out["compared"]
    assert out["compared"]["fused_launches_off"]["value"] == 0
    if traced:
        assert 0 < out["device"]["busy_s"] <= out["device"]["window_s"]
        assert 0 < out["metrics"]["ids_window_roofline"]["value"] <= 100
