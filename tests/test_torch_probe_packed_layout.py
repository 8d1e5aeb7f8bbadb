"""The port's packed-layout probe (`tools/probe_packed_layout.py`) on the
CPU, against the JAX script it ports (`scripts/probe_packed_layout.py`,
its functions loaded without running it) and the JAX package's scans.

On the CPU every arm runs its plain version, so these tests hold what
the probe decides, prints and counts: the row-major arm equals JAX's
`gcra_scan_packed`, the field-major arm the script's own
`scan_fieldmajor`, the unpacked arm JAX's `gcra_scan(..., with_degen=False,
compact=True)`, and the kernel arm (the window kernel's plain version)
JAX's composed window; the arms equal each other.  Tolerance: exact
(integer outputs and table state).  The printed lines follow JAX's
labels, the report carries the card line and the launch counts, and
without a card asking for cuda raises.  tests/test_torch_card.py runs the
kernel arm on the card.
"""

import json
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from throttlecrab_tpu.tpu.kernel import gcra_scan, gcra_scan_packed
from throttlecrab_tpu.tpu.table import BucketTable as JaxBucketTable
from throttlecrab_tpu_torch.tools import card
from throttlecrab_tpu_torch.tools import probe_packed_layout as pl
from torch_jax_scripts import load_script

CPU = torch.device("cpu")

# (K, B, cap): distinct slots, and a table smaller than a sub-batch, so
# every sub-batch repeats slots.
SHAPES = [(4, 64, 4096), (3, 128, 64)]


def _jax(K, B, cap):
    slots, em, tol, now = pl.inputs(cap, K, B)
    return load_script("probe_packed_layout", B=B, K=K, CAP=cap, slots=slots,
                       em=em, tol=tol, now=now)


def _jax_payload(K, B, cap):
    """The JAX script's module-level draw, line for line."""
    rng = np.random.default_rng(3)
    return (rng.integers(0, cap - 1, (K, B)).astype(np.int32),
            np.full((K, B), 20_000_000, np.int64),
            np.full((K, B), 1_000_000_000, np.int64),
            np.full(K, 1_753_000_000_000_000_000, np.int64))


def _port(K, B, cap):
    """{arm: (out, state)} of every arm's first call, as numpy."""
    arms, launcher = pl.make_arms(CPU, K, B, cap)
    got = {}
    for arm in pl.ARMS:
        table, call = arms[arm]
        out = call()
        got[arm] = (out.numpy(), table.state.numpy())
    assert launcher.count == 1
    return got


@pytest.mark.parametrize("K,B,cap", SHAPES)
def test_payload_and_layouts_are_jax(K, B, cap):
    js = _jax(K, B, cap)
    for a, b in zip(pl.inputs(cap, K, B), _jax_payload(K, B, cap)):
        np.testing.assert_array_equal(a, b)
        assert a.dtype == b.dtype
    slots, em, tol, _ = pl.inputs(cap, K, B)
    np.testing.assert_array_equal(pl.kernel_packed(slots, em, tol),
                                  js.pack_rowmajor())


@pytest.mark.parametrize("K,B,cap", SHAPES)
def test_every_arm_equals_its_jax_scan_and_the_others(K, B, cap):
    js = _jax(K, B, cap)
    slots, em, tol, now = _jax_payload(K, B, cap)
    pk_row = js.pack_rowmajor()
    pk_field = np.ascontiguousarray(pk_row.transpose(0, 2, 1))

    def fresh():
        return JaxBucketTable(cap).state

    want = {}
    state, out = gcra_scan_packed(fresh(), jnp.asarray(pk_row),
                                  jnp.asarray(now), with_degen=False,
                                  compact=True)
    want["row-major"] = want["kernel"] = (out, state)
    state, out = js.scan_fieldmajor(fresh(), jnp.asarray(pk_field),
                                    jnp.asarray(now))
    want["field-major"] = (out, state)
    state, out = gcra_scan(
        fresh(), *(jnp.asarray(a) for a in (
            slots, np.zeros((K, B), np.int32), np.ones((K, B), bool), em,
            tol, np.ones((K, B), np.int64), np.ones((K, B), bool), now)),
        with_degen=False, compact=True)
    want["unpacked"] = (out, state)
    got = _port(K, B, cap)
    for arm in pl.ARMS:
        out, state = got[arm]
        assert out.dtype == np.int32 and out.shape == (K, 4, B)
        np.testing.assert_array_equal(out, np.asarray(want[arm][0]), arm)
        np.testing.assert_array_equal(state, np.asarray(want[arm][1]), arm)
        np.testing.assert_array_equal(out, got["row-major"][0], arm)
        np.testing.assert_array_equal(state, got["row-major"][1], arm)


LINE = (r"(row-major  \[K,B,9\] numpy arg |field-major \[K,9,B\] numpy arg|"
        r"unpacked 8-array, resident   |fused_window \[K,B,9\] numpy arg): "
        r"fetched +\d+\.\d\d ms  queued +\d+\.\d\d ms  \( *\d+\.\d\d M dec/s "
        r"queued\)")


def test_run_prints_jax_labels_and_counts_its_windows():
    lines = []
    report = pl.run(CPU, K=3, B=64, cap=4096, n=2, out=lines.append)
    labels = [re.match(LINE, ln).group(1) for ln in lines]
    assert labels == [pl.LABELS[arm] for arm in pl.ARMS]
    assert all(ln.endswith("device not measured") for ln in lines)
    # first + 2 untimed + n fetched + n queued; no profiler on cpu
    assert report["launches_counted"] == 1 + 2 + 2 + 2
    assert report["fused_launches_before"] == report["fused_launches_after"]
    assert report["card"] == card.card_line(CPU)
    assert report["arms"]["unpacked"]["device_ms"] is None
    assert report["first"] == pl.first_scans(CPU, K=3, B=64, cap=4096)
    assert len({f["out"] for f in report["first"].values()}) == 1


def test_main_checks_its_first_calls_against_the_cpu(monkeypatch, capsys):
    for name, value in (("K", 2), ("B", 64), ("CAP", 1024), ("N_CALLS", 1)):
        monkeypatch.setattr(pl, name, value)
    assert pl.main(["--cpu", "--check-cpu"]) == 0
    report = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert report["first_equals_cpu"] is True
    assert (report["platform"], report["K"], report["cap"]) == ("cpu", 2,
                                                                1024)
    assert report["launches_counted"] == 1 + 2 + 1 + 1


def test_the_probe_asks_for_the_card_by_default():
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pl.main([])
