"""The control of the comparison: the reference put in the program's
place with one of the configuration's guarantees broken, which the
comparison has to find wrong.

    python3 -m portbench.control --workload NAME --seeds 1,2,3 --launches N

The configuration computes in integer nanoseconds and states no float
precision, so each control breaks a guarantee it states, that a request
sees the writes of its key's requests before it:

- `subbatch`: requests of one key inside a sub-batch decided against
  the state the sub-batch started with, one write for the lot
  (`reference.gcra.group_independent`): the shortcut of leaving out the
  front end's duplicate-segment sorts, most of a launch's device time;
- `launch`: every sub-batch of a launch decided against the state the
  launch started with, the last write kept
  (`reference.gcra.follow_launch_start`): the shortcut of deciding the
  window's sub-batches side by side, where the kernel runs them in
  order.

A control's answers for N launches of the cell's traffic go through
`check.compare` against the sound reference; it prints, per seed and
control, the numbers compared beside their limits.  It runs on the host
alone and reads no card.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

from . import check, generate
from .reference import gcra
from .registry import Spec


def control_result(sched, keys, index, launches, control):
    """What `check.compare` reads from a run, made by the `control` walk
    in the program's place over `launches` launches."""
    if control == "subbatch":
        kw = {"decide": gcra.group_independent}
    elif control == "launch":
        kw = {"walk": lambda em, tol, g, c: gcra.follow_launch_start(
            em, tol, g, c, sched.K)}
    else:
        raise ValueError(f"unknown control {control!r}")
    lanes, tats, exps = check.reference_run(sched, keys, index, launches,
                                            **kw)
    return {"launches": launches, "kept": lanes, "rows": (tats, exps)}


def run_control(root, workload, seed, launches, control) -> dict:
    spec = Spec(root)
    cell = spec.cell(workload)
    sched = generate.Schedule(spec.config(cell), spec.mix(cell), seed)
    keys, rule = generate.check_sample(sched)
    index = generate.SampleIndex.build(sched, keys, rule)
    result = control_result(sched, keys, index, launches, control)
    return check.compare(sched, keys, index, result)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--launches", type=int, required=True)
    ap.add_argument("--controls", default="subbatch,launch")
    args = ap.parse_args(argv)
    failed_all = True
    runs = [(int(s), c) for s in args.seeds.split(",")
            for c in args.controls.split(",")]
    for seed, control in runs:
        rep = run_control(Path.cwd(), args.workload, seed, args.launches,
                          control)
        failed_all &= not check.correct(rep)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "control": control, "launches": args.launches,
                          "correct": check.correct(rep),
                          "numbers": rep["numbers"],
                          "lanes_checked": rep["lanes_checked"],
                          "reference_s": rep["reference_s"]}))
    return 0 if failed_all else 1


if __name__ == "__main__":
    sys.exit(main())
