"""Control CLI: offline policy search over recorded traces.

    python -m throttlecrab_tpu_torch.control rank day.tctr
    python -m throttlecrab_tpu_torch.control rank dump.tctr -k 12 --json
    python -m throttlecrab_tpu_torch.control simulate day.tctr --mode aimd

``rank`` replays the trace (any capture — including dump-on-degrade
flight-recorder artifacts) against K candidate policies under virtual
time and ranks them by the declared multi-objective score.  The whole
run is deterministic: same trace + same candidates ⇒ byte-identical
ranking output, the same bytes as `python -m throttlecrab_tpu.control`.
"""

from __future__ import annotations

import argparse
import json
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="throttlecrab-tpu-torch-control")
    sub = ap.add_subparsers(dest="command", required=True)

    p = sub.add_parser(
        "rank", help="rank K candidate policies against a trace"
    )
    p.add_argument("path", help="trace file (.tctr)")
    p.add_argument("-k", "--candidates", type=int, default=8)
    p.add_argument(
        "--service-rate", type=float, default=None,
        help="virtual device drain rate, rows/s "
             "(default: half the trace's offered rate)",
    )
    p.add_argument("--max-pending", type=int, default=100_000)
    p.add_argument(
        "--json", action="store_true",
        help="canonical one-line JSON (the byte-diff target)",
    )

    p = sub.add_parser(
        "simulate", help="simulate one policy against a trace"
    )
    p.add_argument("path")
    p.add_argument("--mode", default="both",
                   choices=["off", "aimd", "hill", "both"])
    p.add_argument("--target-wait-us", type=float, default=5000.0)
    p.add_argument("--tick-ms", type=int, default=250)
    p.add_argument("--service-rate", type=float, default=None)
    p.add_argument("--max-pending", type=int, default=100_000)
    p.add_argument(
        "--log", action="store_true",
        help="also print the canonical actuation log",
    )

    args = ap.parse_args(argv)

    from ..replay.trace import Trace, TraceError
    from .replayer import (
        ControlReplayer,
        Policy,
        default_candidates,
        rank,
        rank_json,
    )

    try:
        trace = Trace.load(args.path)
    except (TraceError, OSError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 2

    if args.command == "rank":
        if args.candidates < 1:
            print("error: need at least one candidate", file=sys.stderr)
            return 2
        ranking = rank(
            trace,
            default_candidates(args.candidates),
            service_rate=args.service_rate,
            max_pending=args.max_pending,
        )
        if args.json:
            print(rank_json(ranking))
        else:
            for row in ranking:
                print(json.dumps(row, sort_keys=True))
        return 0

    # simulate
    policy = Policy(
        name=args.mode,
        mode=args.mode,
        target_wait_us=args.target_wait_us,
        tick_ms=args.tick_ms,
    )
    sim = ControlReplayer(
        trace, policy,
        service_rate=args.service_rate,
        max_pending=args.max_pending,
    )
    res = sim.run()
    print(json.dumps(res.to_dict(), sort_keys=True))
    if args.log:
        print(json.dumps(res.actuation_log, sort_keys=True))
    return 0


if __name__ == "__main__":
    sys.exit(main())
