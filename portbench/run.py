"""Run one cell of the benchmark once and print its result line.

    python3 -m portbench.run --workload NAME --seed N --seconds S --trace 0|1

From the root of a checkout: the port's CUDA libraries are built into
(or found in) `throttlecrab_tpu_torch/build/`, the cell's inputs are
made from `--seed`, its one shape is set up and warmed, the window runs
for `--seconds`, the comparison with the plain reference decides
`correct`, and the last line of standard output is one JSON object.
With `--trace 1` one profiler session covers the window and the line
carries the cell's per-layer metrics instead of its end-to-end ones.
Exits nonzero, printing no result, without enough CUDA cards, when
JAX or the JAX package got loaded, or when anything fails.
"""

from __future__ import annotations

import time

_T_IMPORT = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "throttlecrab_tpu")
CACHE_DIRS = {  # fixed paths inside the checkout, so a second run hits
    "TRITON_CACHE_DIR": "triton",
    "TORCH_EXTENSIONS_DIR": "torch_extensions",
    "CUDA_CACHE_PATH": "cuda",
}


def _process_age() -> float:
    """Seconds since this process started (/proc), so `setup_s` counts
    the interpreter's start too."""
    try:
        with open("/proc/self/stat") as f:
            start = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            up = float(f.read().split()[0])
        return max(up - start / os.sysconf("SC_CLK_TCK"), 0.0)
    except (OSError, ValueError, IndexError):
        return 0.0


T_ORIGIN = _T_IMPORT - _process_age()
T_STAGES = {"interpreter": _T_IMPORT - T_ORIGIN}  # set-up before run_cell


class Run:
    """What the metric readers read: the window's host-clock record
    (`win`), the traced run's reduction (`trace`, None untraced or off
    the card), set-up time and the schedule."""

    def __init__(self, sched, setup_s, win, first, trace, tier) -> None:
        self.sched, self.setup_s, self.win = sched, setup_s, win
        self.first, self.trace, self.tier = first, trace, tier
        self._bounds, self._lanes = {}, {}

    def lanes(self, i: int) -> int:
        w = self.sched.window_of(i)
        if w not in self._lanes:
            self._lanes[w] = int((self.sched.windows[w] >= 0).sum())
        return self._lanes[w]

    def launches(self):
        return range(self.first, self.first + len(self.win["starts"]))

    def bound_ms(self, i: int) -> float:
        from .bounds import OUT_BYTES, byid_bound_ms

        w = self.sched.window_of(i)
        if w not in self._bounds:
            self._bounds[w] = byid_bound_ms(self.sched.windows[w],
                                            OUT_BYTES[self.tier])[0]
        return self._bounds[w]


def forbidden_modules() -> list:
    return sorted({m.split(".", 1)[0] for m in sys.modules}
                  & set(FORBIDDEN))


def _per_second(sec, values) -> list:
    """Mean of `values` over the launches dispatched in each second."""
    import numpy as np

    n = np.bincount(sec)
    total = np.bincount(sec, weights=values)
    return [round(float(t / c), 4) if c else None for t, c in zip(total, n)]


def _diagnostics(win, red, seconds) -> dict:
    """Per-second launches done, dispatch ms and host finish ms (and,
    traced, window kernel ms): where in the window the pace moved."""
    import numpy as np

    done = win["ends"] <= win["t_end"]
    sec = (win["starts"] - win["t_start"]).astype(int)
    disp = (win["dispatch"][:, 1] - win["dispatch"][:, 0]) * 1e3
    out = {
        "launches_timed": len(win["starts"]),
        "launches_in_window": int(done.sum()),
        "launches_each_second": np.bincount(
            (win["ends"] - win["t_start"])[done].astype(int),
            minlength=int(seconds)).tolist(),
        "dispatch_ms_each_second": _per_second(sec, disp),
    }
    fin = win["finish"]
    if len(fin):
        out["finish_ms_each_second"] = _per_second(
            (fin[:, 1] - win["t_start"]).astype(int),
            (fin[:, 2] - fin[:, 1]) * 1e3)
    if red is not None:
        out["kernels_a_launch"] = red["kernels_a_launch"]
        out["window_ms_each_second"] = _per_second(sec, red["window_ms"])
    return out


def run_cell(root: Path, workload: str, seed: int, seconds: float,
             traced: bool, device: str = "cuda", log=print) -> dict:
    """One run of one cell on `device`; returns the result object (the
    caller prints it).  A run on "cpu" is for tests: it drives the plain
    versions and reads no device."""
    import torch

    from . import check, generate
    from .registry import Spec
    from .trace import Tracer, reduce

    parts = dict(T_STAGES)  # set-up, by stage, in seconds

    def stage(name):
        parts[name] = time.perf_counter() - T_ORIGIN - sum(parts.values())

    stage("cuda_start")
    spec = Spec(root)
    cell = spec.cell(workload)
    cfg, mix = spec.config(cell), spec.mix(cell)
    sched = generate.Schedule(cfg, mix, seed)
    keys, rule = generate.check_sample(sched)
    index = generate.SampleIndex.build(sched, keys, rule)
    stage("inputs")
    loops = importlib.import_module(f"portbench.loops.{mix['loop']}")
    loop = loops.Loop(sched, keys, index, device)
    loop.setup()
    stage("limiter")
    loop.populate()
    stage("populate")
    loop.run_untimed(int(mix["warm_launches"]))
    cuda = loop.limiter.table.device.type == "cuda"
    if cuda:
        torch.cuda.synchronize()
    stage("warm")
    first = loop.n
    fused0, rows0 = loop.launch_counts()
    setup_s = time.perf_counter() - T_ORIGIN

    red = None
    if traced:
        tracer = Tracer()
        loop.traced = True
        with tracer:
            win = loop.window(seconds)
            if cuda:
                torch.cuda.synchronize()
        loop.traced = False
        if cuda:
            red = reduce(*tracer.records(), win, len(win["starts"]))
    else:
        win = loop.window(seconds)

    fused1, rows1 = loop.launch_counts()
    n_timed = len(win["starts"])
    log(f"launches: loop {n_timed}, fused_window {fused1 - fused0}, "
        f"row kernels {rows1 - rows0}", file=sys.stderr)
    device_line = {"platform": "gpu" if cuda else "cpu",
                   "kind": torch.cuda.get_device_name() if cuda else "cpu",
                   "count": 1,
                   "memory_peak_bytes": int(torch.cuda.max_memory_allocated()
                                            if cuda else 0)}
    result = {"launches": loop.n, "kept": loop.kept,
              "rows": loop.sampled_rows()}
    loop.close()
    del loop
    if cuda:
        torch.cuda.empty_cache()

    run = Run(sched, setup_s, win, first, red, cfg["tier"])
    metrics = {}
    for m in spec.metrics(cell, traced):
        value = spec.reader(m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    report = check.compare(sched, keys, index, result)
    numbers = report["numbers"] + [
        # the plain version on the CPU counts no launch
        ["fused_launches_off", abs(fused1 - fused0 - (n_timed if cuda else 0)),
         0],
        ["row_launches", rows1 - rows0, 0],
    ]
    out = {
        "correct": check.correct(report)
        and all(v <= lim for _, v, lim in numbers),
        "attempted": sum(run.lanes(i) for i in run.launches()),
        "failed": 0,
        "metrics": metrics,
        "device": device_line,
    }
    if red is not None:
        device_line["busy_s"] = red["busy_s"]
        device_line["window_s"] = red["window_s"]
        out["breakdown"] = {
            "device_ops": [[n, s] for n, s in red["device_ops"]],
            "idle_gaps": [[n, s] for n, s in red["idle_gaps"]],
        }
    out["info"] = dict(
        _diagnostics(win, red, seconds), seed=seed, setup_parts_s=parts,
        **{k: report[k] for k in ("lanes_checked", "hot_lanes_checked",
                                  "launches_compared", "keys_checked",
                                  "reference_s")})
    out["compared"] = {n: {"value": v, "limit": lim} for n, v, lim in numbers}
    for n, v, lim in numbers:
        log(f"{n} {v} limit {lim}", file=sys.stderr)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    root = Path.cwd()
    for var, sub in CACHE_DIRS.items():
        os.environ[var] = str(root / ".portbench_cache" / sub)
    # Python's bytecode is a compile cache too.  Where the interpreter
    # may not write it beside the sources (PYTHONDONTWRITEBYTECODE, or
    # sources that ship without it), every process would compile torch's
    # ~2,000 modules anew, seconds of a core; kept at a fixed path in the
    # checkout, only the checkout's first run compiles them.
    sys.pycache_prefix = str(root / ".portbench_cache" / "pycache")
    sys.dont_write_bytecode = False
    import torch

    from .registry import Spec

    chips = Spec(root).cell(args.workload)["chips"]
    T_STAGES["torch_import"] = (time.perf_counter() - T_ORIGIN
                                - sum(T_STAGES.values()))
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"needs {chips} CUDA card(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    out = run_cell(root, args.workload, args.seed, args.seconds,
                   bool(args.trace))
    bad = forbidden_modules()
    if bad:
        print(f"loaded in the measuring process: {bad}", file=sys.stderr)
        return 3
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
