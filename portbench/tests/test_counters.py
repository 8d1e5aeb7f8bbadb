"""`python3 -m portbench.counters`: the program's counters beside a run.

A tiny by-id run on device="cpu" decodes every word of every launch
natively, and its plain versions launch no decision window; a program
without the native finish's counter (the parent of the change that
added it) reads null there, and the check that reads it is null too."""

import pytest

from portbench import counters, run
from portbench.loops import byid
from portbench.tests.tiny import TINY_CONFIG, TINY_MIX, make_root
from throttlecrab_tpu_torch import native
from throttlecrab_tpu_torch.tpu import fused, kernel


def quiet(*_a, **_k):
    pass


def test_a_tiny_cpu_run_finishes_every_word_natively(tmp_path, monkeypatch):
    if native.get_finish_lib() is None:
        pytest.skip("no C++ toolchain: the finish decodes with numpy")
    monkeypatch.setattr(kernel, "FINISH_W32_NATIVE_WORDS", 0)
    monkeypatch.setattr(fused, "LAUNCHES", 0)
    monkeypatch.setattr(fused, "BLOCK_LAUNCHES", 0)
    made, close = [], byid.Loop.close
    monkeypatch.setattr(byid.Loop, "close",
                        lambda self: (made.append(self.n), close(self)))
    out = run.run_cell(make_root(tmp_path), "tiny", 3, 0.5, False,
                       device="cpu", log=quiet)
    assert out["correct"]
    words = TINY_MIX["depth"] * TINY_CONFIG["batch"]
    (launches,) = made
    got = counters.counters(launches, words)
    assert launches > TINY_MIX["warm_launches"]
    assert got["finish_w32_native_words"] == launches * words
    assert got["all_words_native"] is True
    assert (got["fused_launches"], got["cluster_launches"]) == (0, 0)
    assert got["all_cluster"] is False


def test_a_program_without_the_counter_reads_null(monkeypatch):
    monkeypatch.delattr(kernel, "FINISH_W32_NATIVE_WORDS")
    monkeypatch.setattr(fused, "LAUNCHES", 7)
    monkeypatch.setattr(fused, "BLOCK_LAUNCHES", 0)
    got = counters.counters(7, 4096)
    assert got["finish_w32_native_words"] is None
    assert got["all_words_native"] is None
    assert (got["cluster_launches"], got["all_cluster"]) == (7, True)
