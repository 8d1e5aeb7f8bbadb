"""The cross-batch state-carry scenario on a 1-device mesh of the card.

The counterpart of the JAX package's `scripts/probe_sharded_1dev.py`,
which re-checks a round-4 known issue (one real-TPU run of this scenario
failed on a silently degraded 1-device mesh while CPU meshes of every
size passed).  The same scenario — 4 batches of 4 x "hot", burst 10 —
runs on `ShardedTorchRateLimiter(mesh=make_mesh(1))` and on the plain
`TorchRateLimiter`, on the card unless `--cpu` asks for the plain
version; both must give `[True] * 10 + [False] * 6`.

    python -m throttlecrab_tpu_torch.tools.probe_sharded_1dev [--cpu]

Prints one JSON line (JAX's fields) and exits 1 unless both agree.  On
the card `fused.LAUNCHES` must move by exactly the windows the two
limiters hand their tables, or the probe raises.
"""

from __future__ import annotations

import json
import sys

from ..parallel.sharded import ShardedTorchRateLimiter, make_mesh
from ..tpu import fused
from ..tpu.limiter import TorchRateLimiter
from .card import WindowCount, card_line, pick_device, sync

T0 = 1_700_000_000 * 10**9


def scenario(lim):
    batches = [(["hot"] * 4, 10, 100, 3600, 1, T0 + k) for k in range(4)]
    results = lim.rate_limit_many(batches)
    return [bool(a) for r in results for a in r.allowed]


def run(dev):
    """The scenario on both limiters: (JAX's report, {"launches": what
    fused.LAUNCHES moved by, "windows": windows handed to the card})."""
    want = [True] * 10 + [False] * 6
    count = WindowCount()
    before = fused.LAUNCHES

    sharded = count.watch(ShardedTorchRateLimiter(
        capacity_per_shard=64, mesh=make_mesh(1, device=dev.type)
    ))
    got_sharded = scenario(sharded)

    plain = count.watch(TorchRateLimiter(capacity=64, device=dev))
    got_plain = scenario(plain)

    sync(dev)
    counts = {"launches": fused.LAUNCHES - before, "windows": count.windows}
    if dev.type == "cuda" and counts["launches"] != counts["windows"]:
        raise AssertionError(f"fused.LAUNCHES moved by {counts['launches']} "
                             f"for {counts['windows']} windows on the card")
    return {
        "platform": dev.type,
        "sharded_1dev_ok": got_sharded == want,
        "plain_ok": got_plain == want,
        "sharded_allowed": got_sharded,
        "sharded_counters": [sharded.total_allowed, sharded.total_denied],
    }, counts


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    dev = pick_device("--cpu" in argv)
    print(f"device: {dev} ({card_line(dev)})", file=sys.stderr, flush=True)
    report, _ = run(dev)
    print(json.dumps(report))
    return 0 if report["sharded_1dev_ok"] and report["plain_ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
