"""Time the by-id front end on the card: the hand-written kernel
(`tpu/ids_front.py`) or its plain version (`kernel.ids_window`, the torch
ops), one of them a process, at a benchmark cell's shape:

  c2   K=4,096 x B=256 ids of 10,000 uniform keys over 16,384 slots
       (`c2-ids-uniform`)
  c3   K=1,024 x B=4,096 ids of 1,000,000 Zipf-1.1 keys over 1,048,576
       slots (`c3-ids-zipf-k1024`)

The ids and the id rows' slots are drawn from `--seed`; the emission and
tolerance words do not change the front end's work.  Prints one JSON
line: the card, the arm and shape, the device ms a window (the sum of
torch.profiler's records of a call, one session, `tools/card.py`
`device_times`) and its records a call, the ms a window between CUDA
events around `--calls` back-to-back calls, and the bound: the ids read,
one 32-byte sector of each distinct valid id's row and the packed rows
written, at 3.35 TB/s (nothing else bounds it: a few hundred integer
operations a lane).  The first window's packed rows are held to the
plain version's on the card (`same_as_plain`).

    python -m throttlecrab_tpu_torch.tools.probe_ids_front \\
        --arm kernel|plain --shape c2|c3 [--seed 1] [--calls 20]
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from ..tpu import ids_front, kernel
from .card import card_line, device_ms, event_ms, pick_device

HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3, NVIDIA data sheet
SECTOR = 32

SHAPES = {  # K, B, keys, slots, Zipf exponent (None: uniform)
    "c2": (4096, 256, 10_000, 1 << 14, None),
    "c3": (1024, 4096, 1_000_000, 1 << 20, 1.1),
}


def inputs(shape: str, seed: int):
    """(id rows i32[keys, 8], ids i32[K, B]) on the host."""
    K, B, keys, slots, s = SHAPES[shape]
    rng = np.random.default_rng(seed)
    slot = rng.permutation(slots)[:keys].astype(np.int32)
    em = rng.integers(1, 10**10, keys)
    rows = kernel.pack_id_rows(slot, em, em * 5)
    if s is None:
        ids = rng.integers(0, keys, (K, B))
    else:
        p = 1.0 / np.arange(1, keys + 1) ** s
        cdf = np.cumsum(p / p.sum())
        ids = np.minimum(np.searchsorted(cdf, rng.random((K, B))), keys - 1)
    return rows, ids.astype(np.int32)


def bound_ms(ids) -> float:
    """ids read, one sector of each distinct id's row, packed rows
    written, at the HBM rate."""
    distinct = int(np.unique(ids[ids >= 0]).size)
    moved = ids.size * 4 + distinct * SECTOR + ids.size * kernel.PACK_WIDTH * 4
    return moved / HBM_BYTES_PER_S * 1e3


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arm", choices=("kernel", "plain"), required=True)
    ap.add_argument("--shape", choices=sorted(SHAPES), required=True)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--calls", type=int, default=20)
    args = ap.parse_args(argv)
    dev = pick_device(False)
    rows_h, ids_h = inputs(args.shape, args.seed)
    rows = torch.from_numpy(rows_h).to(dev)
    ids = torch.from_numpy(ids_h).to(dev)
    front = ids_front.ids_window if args.arm == "kernel" else \
        kernel.ids_window
    launches = ids_front.LAUNCHES
    first = front(rows, ids, 1)
    same = torch.equal(first, kernel.ids_window(rows, ids, 1))
    if args.arm == "kernel" and ids_front.LAUNCHES != launches + 1:
        raise AssertionError("the kernel arm did not launch the kernel")
    dev_ms, records = device_ms(dev, lambda: front(rows, ids, 1), n=3)
    ev_ms = event_ms(dev, lambda: front(rows, ids, 1), n=args.calls)
    K, B = ids_h.shape
    print(json.dumps({
        "card": card_line(dev), "arm": args.arm, "shape": args.shape,
        "K": K, "B": B, "seed": args.seed,
        "device_ms": dev_ms, "records_a_call": records,
        "event_ms": ev_ms, "bound_ms": bound_ms(ids_h),
        "same_as_plain": same,
    }))
    return 0 if same else 1


if __name__ == "__main__":
    raise SystemExit(main())
