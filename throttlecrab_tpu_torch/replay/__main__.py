"""Replay CLI: synthesize, inspect, diff, and differentially replay.

    python -m throttlecrab_tpu_torch.replay synth --pattern diurnal -o day.tctr
    python -m throttlecrab_tpu_torch.replay info day.tctr
    python -m throttlecrab_tpu_torch.replay replay day.tctr --target device
    python -m throttlecrab_tpu_torch.replay diff a.tctr b.tctr

The port of `python -m throttlecrab_tpu.replay`, printing the same JSON
(``replay`` adds the ``device`` it ran on).  ``replay`` re-runs the
trace against ``--target`` (oracle / device, the latter on ``--device``
cuda, the default, or cpu) and diffs the outcomes against the scalar
oracle AND the trace's recorded planes; any mismatch is a non-zero
exit.  ``--target sharded:D`` is refused (the mesh limiter is not part
of the port).  ``diff`` compares two traces' outcome vectors
byte-for-byte.
"""

from __future__ import annotations

import argparse
import json
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="throttlecrab-tpu-torch-replay")
    sub = ap.add_subparsers(dest="command", required=True)

    p = sub.add_parser("synth", help="generate a synthetic trace")
    p.add_argument("--pattern", default="diurnal",
                   choices=["diurnal", "flash-crowd", "slow-drift"])
    p.add_argument("--windows", type=int, default=64)
    p.add_argument("--batch", type=int, default=256)
    p.add_argument("--key-space", type=int, default=2048)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("-o", "--out", required=True)

    p = sub.add_parser("info", help="summarize a trace")
    p.add_argument("path")

    p = sub.add_parser("replay", help="differential replay")
    p.add_argument("path")
    p.add_argument("--target", default="device",
                   help="oracle | device")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="torch device of the device target (cuda: the "
                        "card; cpu: the plain version)")

    p = sub.add_parser("diff", help="byte-diff two traces' outcomes")
    p.add_argument("a")
    p.add_argument("b")

    args = ap.parse_args(argv)

    from .trace import Trace, TraceError

    if args.command == "synth":
        from .generators import save, synthesize

        trace = synthesize(
            args.pattern, windows=args.windows, batch=args.batch,
            key_space=args.key_space, seed=args.seed,
        )
        save(trace, args.out)
        print(json.dumps({
            "pattern": args.pattern, "path": args.out,
            "windows": len(trace.windows), "rows": trace.n_rows(),
        }))
        return 0

    if args.command == "info":
        try:
            trace = Trace.load(args.path)
        except TraceError as e:
            print(f"error: {e}", file=sys.stderr)
            return 2
        print(json.dumps({
            "windows": len(trace.windows),
            "rows": trace.n_rows(),
            "distinct_keys": trace.distinct_keys(),
            "events": [
                {"now_ns": e.now_ns, "kind": e.kind, "detail": e.detail}
                for e in trace.events[:32]
            ],
            "injections": len(trace.injections),
        }))
        return 0

    if args.command == "replay":
        from .player import differential_replay, make_target

        trace = Trace.load(args.path)
        kw = {"device": args.device} if args.target == "device" else {}
        try:
            target = make_target(args.target, trace, **kw)
        except ValueError as e:  # an unknown or unported target
            print(f"error: {e}", file=sys.stderr)
            return 2
        report = differential_replay(trace, target)
        summary = {**report.summary(), **kw}
        print(json.dumps(summary))
        for m in (report.vs_oracle + report.vs_recorded)[:16]:
            print(str(m), file=sys.stderr)
        return 0 if report.ok else 1

    # diff
    a, b = Trace.load(args.a), Trace.load(args.b)
    va, vb = a.outcome_vector(), b.outcome_vector()
    same = va == vb
    print(json.dumps({
        "a_windows": len(a.windows), "b_windows": len(b.windows),
        "bytes": len(va), "identical": same,
    }))
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main())
