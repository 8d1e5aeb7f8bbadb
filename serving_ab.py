#!/usr/bin/env python3
"""A/B timing of the port's host-bound paths of one checkout on the card.

    python3 serving_ab.py [--root DIR] [--front] [--commands N]

Runs the package and the `chip_smoke.py` of the checkout at DIR (by
default the one this script sits in), so two trees compare on their own
code:

* phase 3: config-3 windows of K x B through `dispatch_many(wire=True)`
  and fetch on the python keymap (decisions/s over the 8 steady
  windows, host clock);
* phase 6: the by-id windows through the table's `byid`, `ids` and
  `ids20` routes (decisions/s per route after each one's first window,
  host clock);
* phase 7: phase 3's windows as native wire frames through
  `dispatch_wire_window` (decisions/s over the 8 steady windows, host
  clock);
* phase 9: 655,360 pipelined THROTTLEs from 8 client processes into an
  in-process `NativeRedisTransport` (replies/s on the clients' clock;
  its device="cpu" replay check included);
* N of phase 9's commands (default 98,304, phase 11b's count) through
  the same clients into a plain `NativeRedisTransport` on a fresh
  limiter, over the default `FrontTier` with `--front` (for a checkout
  that has one): replies/s on the clients' clock.

Builds the checkout's kernels first and prints one JSON line last.  Run it
for the trees alternately, one fresh process per run, to compare them
on one card.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path


def resp_rate(cs, n, front):
    """Replies/s on the clients' clock for `n` of phase 9's commands
    through the NativeRedisTransport of the checkout whose chip_smoke is
    `cs`, on a fresh cuda limiter, over its default FrontTier when
    `front`."""
    import asyncio
    import tempfile

    import numpy as np

    from throttlecrab_tpu_torch.server.metrics import Metrics
    from throttlecrab_tpu_torch.server.native_redis import (
        NativeRedisTransport,
    )
    from throttlecrab_tpu_torch.tpu.limiter import TorchRateLimiter

    kid, frames = cs.resp_commands(np.random.default_rng(12), n)
    limiter = TorchRateLimiter(capacity=cs.CAPACITY, keymap="native")
    metrics = Metrics()
    kw = {}
    if front:
        from throttlecrab_tpu_torch.server.config import Config
        from throttlecrab_tpu_torch.server.store import create_front_tier

        kw["front"] = create_front_tier(Config(), metrics, limiter)
    transport = NativeRedisTransport("127.0.0.1", 0, limiter, metrics,
                                     batch_size=cs.B, max_scan_depth=cs.K,
                                     **kw)
    loop = asyncio.new_event_loop()
    loop.run_until_complete(transport.start())
    try:
        with tempfile.TemporaryDirectory() as tmp:
            runs = cs.run_resp_clients(transport.bound_port, kid, frames,
                                       tmp, "ab")
    finally:
        loop.run_until_complete(transport.stop())
        loop.close()
    for sent, _, clock in runs:
        if clock["replies"] != len(sent):
            raise AssertionError(f"{clock['replies']} replies for "
                                 f"{len(sent)} commands")
    clocks = [c for _, _, c in runs]
    return n / (max(c["end"] for c in clocks)
                - min(c["start"] for c in clocks))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parent),
                    help="checkout whose package and chip_smoke.py run")
    ap.add_argument("--front", action="store_true",
                    help="serve the N commands over the default FrontTier")
    ap.add_argument("--commands", type=int, default=98_304,
                    help="commands in the last run (default: phase 11b's)")
    args = ap.parse_args(argv)
    root = str(Path(args.root).resolve())
    sys.path.insert(0, root)

    import numpy as np
    import torch

    import chip_smoke as cs
    import throttlecrab_tpu_torch

    for mod in (cs, throttlecrab_tpu_torch):
        if not mod.__file__.startswith(root):
            raise SystemExit(f"{mod.__name__} came from {mod.__file__}, "
                             f"not {root}")
    from throttlecrab_tpu_torch.tpu.limiter import TorchRateLimiter

    cs.build_kernels()
    windows = cs.config3_windows(np.random.default_rng(3), cs.N_KEYS, 10,
                                 cs.K, cs.B, 9)
    limiter = TorchRateLimiter(capacity=cs.CAPACITY)
    _, seconds = cs.run_main_path(limiter, windows)
    torch.cuda.synchronize()
    steady = seconds[1:9]
    main_rate = cs.K * cs.B * len(steady) / sum(steady)
    del limiter
    keys, em, tol = cs.config3_params(cs.N_KEYS)
    plan = cs.byid_plan(np.random.default_rng(6), cs.N_KEYS)
    limiter, _, _, _, seconds, _ = cs.run_byid(torch.device("cuda"), keys,
                                               em, tol, plan)
    torch.cuda.synchronize()
    byid = cs.byid_rates(plan, seconds)
    del limiter
    limiter = TorchRateLimiter(capacity=cs.CAPACITY, keymap="native")
    _, seconds = cs.run_wire(limiter, cs.wire_frames(windows))
    torch.cuda.synchronize()
    steady = seconds[1:9]
    wire_rate = cs.K * cs.B * len(steady) / sum(steady)
    del limiter
    resp = cs.run_native_resp(cs.card_line(), wire_rate)
    rate = resp_rate(cs, args.commands, args.front)
    print(json.dumps({
        "root": root,
        "card": cs.card_line(),
        "main_path_decisions_per_s": main_rate,
        "byid_decisions_per_s": byid,
        "wire_window_decisions_per_s": wire_rate,
        "resp_replies_per_s": resp["resp_replies_per_s"],
        "resp_windows": resp["resp_windows"],
        "front": args.front,
        "commands": args.commands,
        "commands_replies_per_s": rate,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
