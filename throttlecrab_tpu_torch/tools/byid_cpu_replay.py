"""Time the by-id path's device="cpu" route in a fresh process.

Replays `chip_smoke.py` phase 6's plan on the CPU: a native-keymap
limiter with a 2^21-row table, 1M interned keys with BASELINE config 3's
per-key params, every key populated once, then three Zipf-1.1 windows
each of `check_many_byid`, `check_many_ids` and `check_many_ids20` at
K=64 x B=4096.  It uses that checkout's own `chip_smoke.run_byid`, so two
trees compare on the same code of theirs:

    python3 throttlecrab_tpu_torch/tools/byid_cpu_replay.py --root DIR

`--root` names the checkout to time (default: the one holding this
file).  Prints one JSON line: decisions/s per variant over the windows
after each variant's first (host clock: prep, decide, fetch, finish),
and the seconds of every window.  Needs no card unless `--cuda-first`
drives the plan on the card first, as phase 6 does before its replay.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[2]),
                    help="checkout whose package and chip_smoke.py run")
    ap.add_argument("--seed", type=int, default=6,
                    help="plan seed (phase 6 uses 6)")
    ap.add_argument("--keys", type=int, default=None,
                    help="interned keys (default: phase 6's 1M)")
    ap.add_argument("--cuda-first", action="store_true",
                    help="drive the plan on cuda before the timed cpu "
                         "replay, as phase 6 does (needs a card)")
    args = ap.parse_args(argv)
    root = str(Path(args.root).resolve())
    sys.path.insert(0, root)

    import numpy as np
    import torch

    import chip_smoke as cs

    if not cs.__file__.startswith(root):
        raise SystemExit(f"chip_smoke came from {cs.__file__}, not {root}")
    n_keys = args.keys or cs.N_KEYS
    keys, em, tol = cs.config3_params(n_keys)
    plan = cs.byid_plan(np.random.default_rng(args.seed), n_keys)
    if args.cuda_first:
        cs.run_byid("cuda", keys, em, tol, plan)
        torch.cuda.synchronize()
    t = time.perf_counter()
    result = cs.run_byid("cpu", keys, em, tol, plan)
    total = time.perf_counter() - t
    # run_byid returns (limiter, wires, valids, seconds) in trees without
    # the per-part split, (limiter, rows, wires, valids, seconds, splits)
    # in trees with it.
    seconds = result[3] if len(result) == 4 else result[4]
    print(json.dumps({
        "root": root,
        "cuda_first": args.cuda_first,
        "torch_threads": torch.get_num_threads(),
        "decisions_per_s": cs.byid_rates(plan, seconds),
        "window_s": [round(s, 4) for s in seconds],
        "variants": [v for v, _ in plan],
        "total_s": round(total, 2),
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
