"""The program's own counters over one run of a cell.

    python3 -m portbench.counters --workload NAME --seed N --seconds S [--trace 0|1]

Runs the cell once as `python3 -m portbench.run` does, in this process,
and prints a second JSON line after the result line: the port's module
counters since the process started (populate and warm-up included),

- `fused_launches` (`tpu/fused.py` `LAUNCHES`, one a decision window);
- `block_launches` (`BLOCK_LAUNCHES`, those on the one-block schedule)
  and `cluster_launches`, the rest: the windows on the cluster schedule;
- `finish_w32_native_words` (`tpu/kernel.py` `FINISH_W32_NATIVE_WORDS`,
  the words the host finish decoded natively),

beside the loop's `launches` and `words_a_launch` (depth x batch), and
two checks of them: `all_cluster` (every window on the cluster
schedule) and `all_words_native` (the native pass decoded every word
of every launch).  A counter the program does not have is null, and so
are the checks that read it; the exit code is `run.py`'s.

The benchmark does not run this: it reads no program counter yet
(PERF.md section 7).  It is the record of what the counters read in a
cell's runs on the card.
"""

from __future__ import annotations

import json
import sys


def counters(launches: int, words_a_launch: int) -> dict:
    """The program's counters now, and the checks against a loop that
    made `launches` launches of `words_a_launch` words each."""
    from throttlecrab_tpu_torch.tpu import fused, kernel

    fl = getattr(fused, "LAUNCHES", None)
    bl = getattr(fused, "BLOCK_LAUNCHES", None)
    nw = getattr(kernel, "FINISH_W32_NATIVE_WORDS", None)
    cluster = None if fl is None or bl is None else fl - bl
    return {
        "fused_launches": fl,
        "block_launches": bl,
        "cluster_launches": cluster,
        "finish_w32_native_words": nw,
        "launches": launches,
        "words_a_launch": words_a_launch,
        "all_cluster": None if cluster is None
        else cluster == fl == launches,
        "all_words_native": None if nw is None
        else nw == launches * words_a_launch,
    }


def main(argv=None) -> int:
    from . import run
    from .loops import byid
    from .registry import Spec

    made, seen = [], {}
    close = byid.Loop.close

    def close_counting(self):
        made.append(self.n)  # the loop's launches, populate and warm-up in
        return close(self)

    inner = run.run_cell

    def run_cell(root, workload, *a, **kw):
        out = inner(root, workload, *a, **kw)
        spec = Spec(root)
        cell = spec.cell(workload)
        cfg, mix = spec.config(cell), spec.mix(cell)
        seen.update(counters(made[-1], int(mix["depth"]) * int(cfg["batch"])))
        return out

    byid.Loop.close = close_counting
    run.run_cell = run_cell
    rc = run.main(argv)
    if seen:
        print(json.dumps({"counters": seen}))
    return rc


if __name__ == "__main__":
    sys.exit(main())
