"""The port's launch-cost tools on the CPU, against the JAX package's
scripts of the same names: `tools/profile_launch.py`
(`scripts/profile_launch.py`), the transfer probes `probe_async`,
`probe_d2h` and `probe_duplex`, and the 1-device mesh probe
`probe_sharded_1dev`.

On the CPU every window runs the kernel's plain version, so these tests
hold what the tools decide and count, not what they time: step 3's
window equals JAX's `gcra_scan(..., with_degen=False, compact=True)` on
the same numpy payload (tolerance: exact), the report carries every key
JAX's report has, the probes run every strategy and count their window
launches, and the 1-device probe prints JAX's JSON.  Without a card,
asking for cuda raises.  tests/test_torch_card.py runs the profile on the
card.
"""

import importlib.util
import json
import pathlib
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from throttlecrab_tpu.tpu.kernel import gcra_scan
from throttlecrab_tpu.tpu.table import BucketTable as JaxBucketTable
from throttlecrab_tpu_torch.tools import (
    probe_async,
    probe_d2h,
    probe_duplex,
    probe_sharded_1dev,
)
from throttlecrab_tpu_torch.tools import profile_launch as pl

REPO = pathlib.Path(__file__).resolve().parent.parent
CPU = torch.device("cpu")


def _jax_script(name):
    spec = importlib.util.spec_from_file_location(
        f"jax_{name}", REPO / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _jax_payload(seed, K, B, cap):
    """The payload as scripts/profile_launch.py draws it, line for line."""
    rng = np.random.default_rng(seed)
    slots = rng.integers(0, cap - 1, (K, B)).astype(np.int32)
    rank = np.zeros((K, B), np.int32)
    is_last = np.ones((K, B), bool)
    emission = np.full((K, B), 20_000_000, np.int64)
    tol = np.full((K, B), 1_000_000_000, np.int64)
    qty = np.ones((K, B), np.int64)
    valid = np.ones((K, B), bool)
    now = np.full(K, 1_753_000_000_000_000_000, np.int64)
    return (slots, rank, is_last, emission, tol, qty, valid, now)


# (K, B, cap): distinct slots, and a table smaller than a sub-batch, so
# every sub-batch repeats slots and each window reads what the last wrote.
SHAPES = [(4, 64, 4096), (3, 128, 64), (2, 256, 1 << 12)]


@pytest.mark.parametrize("K,B,cap", SHAPES)
def test_step3_window_equals_jax_gcra_scan(K, B, cap):
    want = _jax_payload(3, K, B, cap)
    for a, b in zip(pl.make_payload(np.random.default_rng(3), K, B, cap),
                    want):
        np.testing.assert_array_equal(a, b)
        assert a.dtype == b.dtype
    out, state = pl.first_window("cpu", B=B, K=K, cap=cap)
    j_state, j_out = gcra_scan(JaxBucketTable(cap).state,
                               *(jnp.asarray(a) for a in want),
                               with_degen=False, compact=True)
    assert out.dtype == torch.int32 and tuple(out.shape) == (K, 4, B)
    np.testing.assert_array_equal(out.numpy(), np.asarray(j_out))
    np.testing.assert_array_equal(state.numpy(), np.asarray(j_state))


def test_profile_report_has_jax_keys_and_counts(tmp_path, capsys):
    src = (REPO / "scripts" / "profile_launch.py").read_text()
    jax_keys = set(re.findall(r'report\["(\w+)"\]', src)) | {
        "device", "platform", "B", "K"}
    assert pl.main(["--cpu", "--batch", "64", "--depth", "4",
                    "--trace", str(tmp_path)]) == 0
    report = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert jax_keys <= set(report), jax_keys - set(report)
    assert (report["B"], report["K"], report["platform"]) == (64, 4, "cpu")
    assert report["h2d_bytes"] == 4 * 64 * 34 + 4 * 8
    assert report["h2d_fused_bytes"] == 4 * 64 * 36 + 4 * 8
    assert report["d2h_bytes"] == 4 * 4 * 64 * 4
    # warm 3 + timed 10 of steps 3 and 5, 1 first window, 1 for step 4,
    # pipelined 2 + 3 x 8, and 4 traced end-to-end launches
    assert report["launches_counted"] == 1 + 13 + 1 + 13 + 26 + 4
    # the plain version counts no kernel launch
    assert report["fused_launches_before"] == report["fused_launches_after"]
    assert report["compute_device_ms"] is None
    assert report["h2d_pinned_ms"] is None
    assert pathlib.Path(report["trace_path"]).stat().st_size > 0


def test_tools_ask_for_the_card_by_default():
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pl.main(["--batch", "16", "--depth", "1"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        probe_sharded_1dev.main([])
    for probe in (probe_async, probe_d2h, probe_duplex):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            probe.main([])


def test_probe_async_runs_every_question():
    lines = []
    rec = probe_async.run(CPU, b=64, cap=4096, depths=(2, 4),
                          out=lines.append)
    text = "\n".join(lines)
    for label in ("a) .to(dev, non_blocking=True) 8MB pageable",
                  "a) pinned source: not measured", "b) 8 launches",
                  "b2) 8 launches", "b3) 8 launches", "c) window K=   4"):
        assert label in text
    # 1 first launch, b) 1+2+4+8, b2) and b3) 1+4+8 each, c) 1+3 per K
    assert rec == {"launches": 1 + 15 + 13 + 13 + 8, "fused_launches": 0}


def test_probe_d2h_runs_every_strategy():
    lines = []
    res = probe_d2h.run(CPU, n=2, mb=1, chain=5, out=lines.append)
    assert set(res) == {"a", "c", "d", "e16", "e1", "f", "g", "h_ready",
                        "h_chain"}
    assert any(line.startswith("b) ") and "not measured" in line
               for line in lines)
    assert [line[:2] for line in lines[1:]] == [
        "a)", "b)", "c)", "d)", "e)", "e)", "f)", "g)", "h)"]


def test_probe_duplex_measures_both_directions():
    lines = []
    res = probe_duplex.run(CPU, mb=1, n=2, out=lines.append)
    assert res["pinned"] is None
    assert set(res["pageable"]) == {"h2d", "d2h", "both", "ratio"}
    assert sum("serialization ratio" in line for line in lines) == 1
    assert probe_duplex.arg(["--mb", "3"], "--mb", 8) == 3
    assert probe_duplex.arg([], "--n", 6) == 6


def test_probe_sharded_1dev_prints_jax_json(capsys):
    assert _jax_script("probe_sharded_1dev").main() == 0
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert probe_sharded_1dev.main(["--cpu"]) == 0
    got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert got == want
    assert got["sharded_allowed"] == [True] * 10 + [False] * 6
    report, counts = probe_sharded_1dev.run(CPU)
    assert report == want and counts == {"launches": 0, "windows": 0}
