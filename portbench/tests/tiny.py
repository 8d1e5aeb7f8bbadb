"""A tiny benchmark root for the CPU tests: BENCHMARK.json, a small
configuration of config 3's shape and a small mix (or the strided one),
beside copies of the real metric readers."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

PKG = Path(__file__).resolve().parent.parent
BENCH = json.loads((PKG.parent / "BENCHMARK.json").read_text())

TINY_CONFIG = {
    "name": "tiny-zipf", "keys": 300, "key_name": "t:%d",
    "key_dist": {"kind": "zipf", "s": 1.1}, "batch": 64,
    "params": {"burst": {"base": 5, "mod": 60},
               "count": {"base": 50, "mod": 1000},
               "period_s": {"base": 30, "mod": 120}},
    "quantity": 1, "capacity": 1024, "tier": "w32", "reduced": [],
}
TINY_MIX = {
    "loop": "byid", "depth": 4, "in_flight": 2, "workers": 2,
    "step_ns": 50_000_000, "t0_ns": 1_800_000_000_000_000_000, "pool": 3,
    "warm_launches": 2,
    "check": {"hot": 4, "drawn": 40, "uniform": 40, "stride": 2},
}
# Config 3's mix at a tiny size: deeper launches, the hot and drawn keys'
# lanes compared in one sub-batch in 4.
TINY_STRIDED_MIX = dict(TINY_MIX, depth=16, check=dict(
    TINY_MIX["check"], hot_sub_stride=4))


def write(path: Path, obj) -> None:
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(obj, indent=1))


def make_root(tmp: Path, config=None, mix=None, name="tiny") -> Path:
    """A root holding one cell `name` over the tiny configuration and mix
    and the real end-to-end and per-layer metrics."""
    config = dict(TINY_CONFIG if config is None else config)
    mix = TINY_MIX if mix is None else mix
    shutil.copytree(PKG / "metrics", tmp / "portbench" / "metrics",
                    dirs_exist_ok=True)
    write(tmp / "portbench" / "configs" / f"{config['name']}.json", config)
    write(tmp / "portbench" / "traffic" / "tiny-mix.json", mix)
    bench = dict(BENCH)
    bench["configs"] = [{"name": config["name"], "source": "test",
                         "file": f"portbench/configs/{config['name']}.json",
                         "reduced": [], "why": "test"}]
    bench["workloads"] = [{"name": name, "config": config["name"],
                           "traffic": "tiny-mix", "chips": 1, "why": "test"}]
    bench["end_to_end"] = [{k: v for k, v in m.items() if k != "workloads"}
                           for m in BENCH["end_to_end"]]
    bench["per_layer"] = [{k: v for k, v in m.items() if k != "workloads"}
                          for m in BENCH["per_layer"]]
    write(tmp / "BENCHMARK.json", bench)
    return tmp
