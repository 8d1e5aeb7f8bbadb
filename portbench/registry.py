"""Everything a cell needs, found by name: the cell in BENCHMARK.json,
its configuration file (`file` of the configuration entry), its traffic
mix (`traffic/<mix>.json` beside this file) and a reader per metric
(`metrics/<metric>.py`, a `read(run)` that returns a number, or None
where the run holds nothing to read).  Adding a configuration, a mix or
a metric adds files and entries and edits none."""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


class Spec:
    """BENCHMARK.json at `root`, and what its names lead to."""

    def __init__(self, root: Path) -> None:
        self.root = Path(root)
        self.bench = load_json(self.root / "BENCHMARK.json")

    def cell(self, name: str) -> dict:
        for w in self.bench["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, cell: dict) -> dict:
        for c in self.bench["configs"]:
            if c["name"] == cell["config"]:
                return load_json(self.root / c["file"])
        raise KeyError(f"no config {cell['config']!r} in BENCHMARK.json")

    def mix(self, cell: dict) -> dict:
        return load_json(self.root / "portbench" / "traffic"
                         / f"{cell['traffic']}.json")

    def metrics(self, cell: dict, traced: bool) -> list:
        """The metric entries this cell reports in a run: end-to-end ones
        untraced, per-layer ones traced; a metric with `workloads`
        only in those cells, one without it in every cell that reports
        the end-to-end metric it moves."""
        name = cell["name"]
        e2e = [m for m in self.bench["end_to_end"]
               if name in m.get("workloads", [name])]
        if not traced:
            return e2e
        reported = {m["name"] for m in e2e}
        return [m for m in self.bench["per_layer"]
                if (name in m["workloads"] if "workloads" in m
                    else m["moves"] in reported)]

    def reader(self, metric: str):
        path = self.root / "portbench" / "metrics" / f"{metric}.py"
        spec = importlib.util.spec_from_file_location(
            f"portbench_metric_{metric.replace('.', '_')}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod.read
