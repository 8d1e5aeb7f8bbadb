"""The minimum-wire-bytes launch path: raw key ids against
device-resident parameter rows.

The port's counterpart of the JAX package's `examples/byid_launch.py`:
when the key universe and its limits are known up front (the common
serving shape: per-tenant/per-user configs), each decision ships 4 bytes
up (the i32 key id; the device derives the duplicate-segment structure
itself) and 8 bytes down (one i64 `cur*2+allowed` word, completed to the
exact i32 wire values by the native keymap's `finish_raw`).  The
narrower tiers shrink both directions further when their certificates
hold — 20-bit packed ids (2.5 B/request up, tables under 2^20 − 1 keys)
and the `w32` output (4 B/request down, the device packs the exact wire
values) — shown at the end.  Each window is one launch of the
decision-window kernel, on the card unless `--cpu` asks for the plain
version.

    python -m throttlecrab_tpu_torch.examples.byid_launch [--cpu]
"""

import argparse
import sys
import time

import numpy as np

from ..tpu.kernel import finish_w32, fits_w32_wire, pack_ids20
from ..tpu.limiter import TorchRateLimiter, derive_params


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args(argv)
    limiter = TorchRateLimiter(
        capacity=1 << 16, keymap="native", device="cpu" if args.cpu else None
    )
    km, table = limiter.keymap, limiter.table

    # ---- setup (once): intern the key universe, upload its limits ----
    n_keys = 10_000
    keys = [b"tenant:%d/user:%d" % (i % 64, i) for i in range(n_keys)]
    kid = np.arange(n_keys, dtype=np.int64)
    burst = 5 + (kid % 20)
    count = 50 + (kid % 500)
    period = 30 + (kid % 90)
    em, tol, invalid = derive_params(burst, count, period)
    if invalid.any():
        raise ValueError("invalid limits in the key universe")

    km.intern(keys)
    rows = table.upload_id_rows(km.resolve_all(), em, tol, keymap=km)

    # ---- steady state: ship NOTHING but ids -------------------------
    now = time.time_ns()
    rng = np.random.default_rng(0)
    ids = rng.integers(0, n_keys, 4096).astype(np.int32)
    cur2 = table.check_many_ids(
        rows, ids.reshape(1, 4096), np.array([now], np.int64),
        quantity=1, with_degen=False, compact="cur",
    ).cpu().numpy().reshape(-1)
    wire = km.finish_raw(ids, em, tol, 1, cur2, now)
    allowed, remaining = wire[:, 0], wire[:, 1]
    print(
        f"decided {len(ids)} requests: {int(allowed.sum())} allowed; "
        f"remaining[0..4] = {remaining[:4].tolist()}"
    )

    # Hot key inside one launch: exact sequential burst semantics, with
    # the duplicate-segment structure derived on the device.
    hot_id = np.full(64, 7, np.int32)
    cur2 = table.check_many_ids(
        rows, hot_id.reshape(1, 64), np.array([now], np.int64),
        quantity=1, with_degen=False, compact="cur",
    ).cpu().numpy().reshape(-1)
    wire = km.finish_raw(hot_id, em, tol, 1, cur2, now)
    print(
        f"hot key: {int(wire[:, 0].sum())}/64 allowed "
        f"(burst {int(burst[7])}, minus any tokens the random batch "
        f"above already spent on id 7)"
    )

    # ---- the minimum: 2.5 B up, 4 B down ----------------------------
    # 20-bit packed ids + the w32 device-packed wire word.  fits_w32_wire
    # certifies this key universe (small tolerances), so the unpack is
    # three shifts — no reconstruction arithmetic at all.
    if not fits_w32_wire(
        np.ones(n_keys, bool), em, tol, np.ones(n_keys, np.int64),
        now, table.tol_hwm, table.now_hwm,
    ):
        raise AssertionError("the w32 certificate refused this key universe")
    ids2 = rng.integers(0, n_keys, 4096).astype(np.int32)
    w = table.check_many_ids20(
        rows, pack_ids20(ids2.reshape(1, 4096)),
        np.array([now + 1_000_000], np.int64),
        quantity=1, with_degen=False, compact="w32",
    ).cpu().numpy().reshape(-1)
    allowed, remaining, reset_s, retry_s = finish_w32(w)
    print(
        f"ids20+w32 (6.5 B/request): {int(allowed.sum())} allowed; "
        f"reset_s[0..4] = {reset_s[:4].tolist()}"
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
