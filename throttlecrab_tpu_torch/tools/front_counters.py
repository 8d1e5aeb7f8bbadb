"""The by-id front end's counters over one run of a benchmark cell.

    python3 -m throttlecrab_tpu_torch.tools.front_counters \\
        --workload NAME --seed N --seconds S [--trace 0|1]

Run from the root of the checkout.  Runs the cell once as `python3 -m
portbench.counters` does, in this process (its result line and its
counters line), then prints a third JSON line, `front_counters`: since
the process started, `tpu/ids_front.py`'s `LAUNCHES` (windows the
front-end kernel expanded) and `PLAIN_WINDOWS` (windows on the card
that took the plain ops for their width), beside `fused.LAUNCHES`
(every decision window: the cell's populate, warm-up and timed launches
all go through `check_many_ids`), and the check `all_windows_kernel`:
every window's front end was the kernel.  The exit code is the run's.
"""

from __future__ import annotations

import json
import sys


def main(argv=None) -> int:
    from portbench import counters

    from ..tpu import fused, ids_front

    rc = counters.main(argv)
    front = {
        "ids_front_launches": ids_front.LAUNCHES,
        "ids_front_plain_windows": ids_front.PLAIN_WINDOWS,
        "fused_launches": fused.LAUNCHES,
    }
    front["all_windows_kernel"] = (
        front["ids_front_plain_windows"] == 0
        and front["ids_front_launches"] == front["fused_launches"] > 0)
    print(json.dumps({"front_counters": front}))
    return rc


if __name__ == "__main__":
    sys.exit(main())
