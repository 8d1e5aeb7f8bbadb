"""A configuration, a traffic mix and a per-layer metric added as new
files and entries, with no file of the harness edited, are found by
name and run (on the CPU, at a tiny size)."""

import json

from portbench import run
from portbench.registry import Spec
from portbench.tests.tiny import TINY_CONFIG, TINY_MIX, make_root, write

NEW_METRIC = '''"""launches_timed: launches the traced window made."""


def read(run):
    return len(run.win["starts"])
'''


def test_added_files_are_found_and_run(tmp_path):
    root = make_root(tmp_path)
    config = dict(TINY_CONFIG, name="tiny-uniform", keys=500,
                  key_dist={"kind": "uniform"}, batch=32,
                  params={"burst": {"base": 10}, "count": {"base": 100},
                          "period_s": {"base": 60}})
    write(root / "portbench" / "configs" / "tiny-uniform.json", config)
    write(root / "portbench" / "traffic" / "tiny-deep.json",
          dict(TINY_MIX, depth=8, in_flight=3))
    (root / "portbench" / "metrics" / "launches_timed.py").write_text(
        NEW_METRIC)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "tiny-uniform", "source": "test",
                             "file": "portbench/configs/tiny-uniform.json",
                             "reduced": [], "why": "test"})
    bench["workloads"].append({"name": "tiny2", "config": "tiny-uniform",
                               "traffic": "tiny-deep", "chips": 1,
                               "why": "test"})
    bench["per_layer"].append({"name": "launches_timed", "unit": "launches",
                               "better": "higher",
                               "source": "program_counter",
                               "layer": "by-id launch",
                               "moves": "decisions_per_s",
                               "workloads": ["tiny2"]})
    write(root / "BENCHMARK.json", bench)

    spec = Spec(root)
    cell = spec.cell("tiny2")
    assert spec.config(cell)["keys"] == 500
    assert spec.mix(cell)["depth"] == 8
    names = [m["name"] for m in spec.metrics(cell, traced=True)]
    assert "launches_timed" in names
    assert "launches_timed" not in [
        m["name"] for m in spec.metrics(spec.cell("tiny"), traced=True)]

    out = run.run_cell(root, "tiny2", 4, 0.5, True, device="cpu",
                       log=lambda *a, **k: None)
    assert out["correct"], out["compared"]
    assert out["metrics"]["launches_timed"]["value"] == (
        out["info"]["launches_timed"])
