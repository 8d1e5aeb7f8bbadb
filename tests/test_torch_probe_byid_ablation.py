"""The port's by-id ablation probe (`tools/probe_byid_ablation.py`) on the
CPU, against the JAX script it ports (`scripts/probe_byid_ablation.py`,
its functions loaded without running it), and the id-row width of
`kernel.pack_id_rows` against the JAX package's.

On the CPU every arm runs its plain version, so these tests hold what
the probe decides, prints and counts: each of the five body modes at id
rows 8 and 5 wide equals the JAX script's own `make_scan(mode)` on the
same staged words (on `row_ops.PLAIN`; the row-kernel arm needs the
card), and the kernel arm (`kernel.byid_window`, then the window kernel's
plain version) equals JAX's composed `gcra_scan_byid`.  Tolerance: exact
(integer outputs and table state).  The shapes draw duplicate ids inside
a sub-batch and deny lanes in later sub-batches.  The printed lines
follow JAX's labels, the report carries the card line and the launch
counts, and without a card asking for cuda raises.
tests/test_torch_card.py runs the kernel and row-kernel arms on the card.
"""

import json
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from throttlecrab_tpu.tpu.kernel import gcra_scan_byid
from throttlecrab_tpu.tpu.kernel import pack_id_rows as jax_pack_id_rows
from throttlecrab_tpu_torch.tools import card
from throttlecrab_tpu_torch.tools import probe_byid_ablation as ba
from throttlecrab_tpu_torch.tpu import fused, kernel, row_ops
from torch_jax_scripts import load_script

CPU = torch.device("cpu")

# (K, B, n_ids, cap): sparse ids, and 8 ids over a 128-lane sub-batch
# (duplicates in every sub-batch, denials from the second on); the
# scratch tail [cap - B, cap) never holds a real slot.
SHAPES = [(4, 64, 1000, 4096), (3, 128, 8, 256)]


def _jax(B, K, n_ids, cap):
    return load_script("probe_byid_ablation", B=B, K=K, N_IDS=n_ids,
                       CAP=cap, NOW=ba.NOW)


def _jax_words(rng, n_ids, K, B):
    """The JAX script's `stage`, line for line, without the upload."""
    ids = rng.integers(0, n_ids, (K, B)).astype(np.int64)
    meta = (1 << 14) | (1 << 15)
    return (np.int64(meta) << 32) | ids


def _id_rows(n_ids, width):
    slots, em, tol = ba.id_params(n_ids)
    return ba.pack_id_rows(slots, em, tol, width=width)


@pytest.mark.parametrize("width", [5, 8, 12])
def test_pack_id_rows_width_equals_jax(width):
    rng = np.random.default_rng(width)
    slots = rng.integers(0, 1 << 20, 300).astype(np.int32)
    em = rng.integers(0, 1 << 62, 300)
    tol = rng.integers(-(1 << 62), 1 << 62, 300)
    got = kernel.pack_id_rows(slots, em, tol, width=width)
    want = jax_pack_id_rows(slots, em, tol, width=width)
    assert got.dtype == want.dtype and got.shape == (300, width)
    np.testing.assert_array_equal(got, want)
    if width == kernel.IDROW_WIDTH:
        np.testing.assert_array_equal(kernel.pack_id_rows(slots, em, tol),
                                      want)


def test_pack_id_rows_refuses_fewer_than_five_columns():
    args = (np.arange(3, dtype=np.int32), np.ones(3, np.int64),
            np.ones(3, np.int64))
    with pytest.raises(ValueError, match="at least 5 columns"):
        jax_pack_id_rows(*args, width=4)
    with pytest.raises(ValueError, match="at least 5 columns"):
        kernel.pack_id_rows(*args, width=4)


@pytest.mark.parametrize("K,B,n_ids,cap", SHAPES)
def test_five_wide_id_rows_decide_as_eight_wide(K, B, n_ids, cap):
    words = torch.from_numpy(_jax_words(np.random.default_rng(1), n_ids, K,
                                        B))
    now = torch.full((K,), ba.NOW, dtype=torch.int64)
    got = {}
    for width in (8, 5):
        packed = kernel.byid_window(torch.from_numpy(_id_rows(n_ids, width)),
                                    words, 1)
        state = ba.make_state(cap, CPU)
        out, n_exp = fused.fused_window(state, packed, now, with_degen=False,
                                        compact="cur")
        got[width] = (packed, out, n_exp, state)
    for a, b in zip(got[8], got[5]):
        assert torch.equal(a, b)


@pytest.mark.parametrize("width", ba.WIDTHS)
@pytest.mark.parametrize("mode", ba.MODES)
@pytest.mark.parametrize("K,B,n_ids,cap", SHAPES)
def test_mode_equals_jax_make_scan(K, B, n_ids, cap, mode, width):
    js = _jax(B, K, n_ids, cap)
    words = _jax_words(np.random.default_rng(5), n_ids, K, B)
    rows = _id_rows(n_ids, width)
    now = np.full(K, ba.NOW, np.int64)
    state = ba.make_state(cap, CPU)
    out = ba.make_scan(mode)(state, torch.from_numpy(rows),
                             torch.from_numpy(words), torch.from_numpy(now))
    j_state, j_out = js.make_scan(mode)(
        js.make_state(), jnp.asarray(rows), jnp.asarray(words),
        jnp.asarray(now))
    assert out.dtype == torch.int64 and out.shape == (K, B)
    np.testing.assert_array_equal(out.numpy(), np.asarray(j_out))
    np.testing.assert_array_equal(state.numpy(), np.asarray(j_state))


@pytest.mark.parametrize("K,B,n_ids,cap", SHAPES)
def test_kernel_arm_equals_jax_composed_byid_window(K, B, n_ids, cap):
    arms, launcher = ba._arms(CPU, False, n_ids, K, B, cap, 2)
    arm, label, make = arms[-1]
    assert (arm, label) == ("kernel/fused_window", "fused_window")
    run = make()
    out = run()
    assert launcher.count == 1
    words = dict(ba.arm_words(n_ids, K, B, 2))[arm][0]
    j_state, j_out = gcra_scan_byid(
        jnp.asarray(ba.make_state(cap, CPU).numpy()),
        jnp.asarray(_id_rows(n_ids, 8)), jnp.asarray(words),
        jnp.full(K, ba.NOW, jnp.int64), 1, with_degen=False, compact="cur")
    np.testing.assert_array_equal(out.numpy(), np.asarray(j_out))
    np.testing.assert_array_equal(run.state.numpy(), np.asarray(j_state))


def test_staged_words_are_jax_draws_in_jax_order():
    K, B, n_ids, r = 2, 16, 50, 3
    rng = np.random.default_rng(5)
    staged = ba.arm_words(n_ids, K, B, r)
    assert [arm for arm, _ in staged] == (
        [f"mode/{m}" for m in ba.MODES] + ["width/8", "width/5",
                                           "kernel/fused_window"])
    for _, blocks in staged:
        for block in blocks:
            np.testing.assert_array_equal(block, _jax_words(rng, n_ids, K, B))


SMALL = dict(n_ids=50, K=3, B=64, cap=256, r=2)
LINE = (r"(full|noidrow|nostate|noscatter|elementwise|fused_window|"
        r"width [58]) *: +\d+\.\d\d ms/launch  \( *\d+\.\d{3} ms/batch, *"
        r"\d+\.\d\d M dec/s\)")


@pytest.mark.parametrize("row_kernels", [False, True])
def test_run_prints_jax_labels_and_counts_its_launches(row_kernels, capsys,
                                                       monkeypatch):
    monkeypatch.delenv("THROTTLECRAB_PALLAS", raising=False)
    lines = []
    report = ba.run(CPU, row_kernels=row_kernels, out=lines.append, **SMALL)
    labels = [re.match(LINE, ln).group(1) for ln in lines
              if re.match(LINE, ln)]
    assert labels == list(ba.MODES) + ["width 8", "width 5", "fused_window"]
    assert [ln[:12] for ln in lines if re.match(LINE, ln)][:5] == [
        f"{m:12s}" for m in ba.MODES]
    err = capsys.readouterr().err
    assert f"pallas=0  row_kernels={int(row_kernels)}" in err
    # first + R scans; the profiler does not run on cpu
    assert report["launches_counted"] == 1 + SMALL["r"]
    assert set(report["scans"].values()) == {1 + SMALL["r"]}
    assert report["fused_launches_before"] == report["fused_launches_after"]
    # on the CPU the row route runs the plain versions, which count nothing
    assert all(v == {"row_gather": 0, "row_scatter": 0}
               for v in report["row_launches"].values())
    assert report["card"] == card.card_line(CPU)
    assert report["row_kernels"] is row_kernels
    assert report["mode"]["full"]["device_ms"] is None
    assert report["first"] == ba.first_scans(CPU, row_kernels, **SMALL)


def test_row_route_is_the_row_kernels_module_or_the_plain_one():
    assert ba.row_route(True) is row_ops
    assert ba.row_route(False) is row_ops.PLAIN


def test_main_reads_the_jax_switch_and_checks_the_cpu(monkeypatch, capsys):
    for name, value in (("N_IDS", 50), ("K", 3), ("B", 64), ("CAP", 256),
                        ("R", 2)):
        monkeypatch.setattr(ba, name, value)
    monkeypatch.setenv("THROTTLECRAB_PALLAS", "1")
    assert ba.main(["--cpu", "--check-cpu"]) == 0
    out, err = capsys.readouterr()
    report = json.loads(out.strip().splitlines()[-1])
    assert "pallas=1  row_kernels=1" in err
    assert report["row_kernels"] is True
    assert report["first_equals_cpu"] is True
    assert (report["platform"], report["K"], report["n_ids"]) == ("cpu", 3,
                                                                  50)


def test_the_probe_asks_for_the_card_by_default():
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ba.main(["--row-kernels"])
