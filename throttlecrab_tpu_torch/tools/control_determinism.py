"""Control-determinism gate: run the control plane under virtual time
twice over one synthetic trace and byte-diff everything it did.

The counterpart of the JAX package's `scripts/control_determinism.py`
(run by its CI), with its three contracts, each a hard failure, and its
PASS line:

1. two armed simulations of one trace produce byte-identical actuation
   logs (the controller is a pure function of the trace);
2. `control rank` over the default candidate grid produces the identical
   canonical ranking twice (offline policy search is reproducible);
3. with the controller OFF, the outcome vector is byte-identical to a
   plain scalar-oracle replay of the same trace (the kill switch: the
   subsystem invisible at stock knobs).

The control replayer decides every row with the scalar oracle on the
host (control/replayer.py), so the gate touches no device and takes no
device flag.

    python -m throttlecrab_tpu_torch.tools.control_determinism [--windows N]
"""

from __future__ import annotations

import argparse
import json
import sys

from ..control import (
    ControlReplayer,
    Policy,
    default_candidates,
    rank,
    rank_json,
)
from ..replay.generators import synthesize
from ..replay.player import make_target, outcome_vector, replay


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--windows", type=int, default=48)
    args = ap.parse_args(argv)

    trace = synthesize(
        "flash-crowd", windows=args.windows, batch=512,
        key_space=8192, seed=23,
    )

    armed = Policy(name="both", mode="both")
    logs = []
    for _ in range(2):
        res = ControlReplayer(trace, armed).run()
        logs.append(json.dumps(res.actuation_log, sort_keys=True))
    if logs[0] != logs[1]:
        print(
            "FAIL: two armed runs produced different actuation logs",
            file=sys.stderr,
        )
        return 1
    n_act = len(json.loads(logs[0]))
    if n_act == 0:
        print(
            "FAIL: armed controller never actuated (the diff above "
            "compared two empty logs — gate is vacuous)",
            file=sys.stderr,
        )
        return 1

    rankings = [
        rank_json(rank(trace, default_candidates(8))) for _ in range(2)
    ]
    if rankings[0] != rankings[1]:
        print("FAIL: rank() diverged across two runs", file=sys.stderr)
        return 1

    off = ControlReplayer(trace, Policy(name="static", mode="off")).run()
    plain = outcome_vector(replay(trace, make_target("oracle", trace)))
    if off.vector() != plain:
        print(
            "FAIL: controller-off outcomes differ from plain replay "
            "(kill-switch bit-identity broken)",
            file=sys.stderr,
        )
        return 1

    top = json.loads(rankings[0])[0]
    print(
        f"PASS: {len(trace.windows)} windows / {trace.n_rows()} rows — "
        f"actuation log x2 byte-identical ({n_act} actuations), "
        f"rank x2 byte-identical (top: {top['policy']['name']}), "
        "controller-off == plain replay"
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
