#!/usr/bin/env python3
"""A/B timing of the row kernels on the card: this checkout's against
another checkout's and against the library calls.

    python3 row_ab.py --root DIR [--rounds 3] [--out FILE]

Builds this checkout's `csrc/row_ops.cu` (through `tpu/row_ops.py`) and
DIR's `throttlecrab_tpu_torch/csrc/row_ops.cu` (the same nvcc flags,
into a temporary directory; its `tc_row_gather` / `tc_row_scatter` take
the same arguments), then for each width W = 4 and 6 at the two batches
the paths launch, B = 4,096 over phase 8's by-id table (2^21 + 2^16
rows) and B = 65,536 over phase 10's serving table (2^20 + 2^16 rows),
checks every side against the plain version once and times:

`root`, DIR's kernels; `kernel`, this checkout's; `library`,
`index_select` / `index_copy_` on an int64 index made once; in
`--rounds` rounds, each side once a round, the order reversed every
other round.

Each time is `torch.profiler` device time per launch (chip_smoke.py's
`profile_device`): warm, the table resident in L2 and each launch on the
next of 8 index sets; and cold, with 128 MB read before each launch
(`cold_device_ms`).  Prints one line per case and side, the card's name
and power limit, and one JSON line last (also written to FILE).
"""

from __future__ import annotations

import argparse
import ctypes
import itertools
import json
import statistics
import subprocess
import sys
import tempfile
import threading
from pathlib import Path

import chip_smoke as cs

# (B, table rows): phase 8's by-id batch, phase 10's snapshot chunk.
CASES = ((cs.B, cs.BYID_CAPACITY + (1 << 16)),
         (1 << 16, cs.CAPACITY + (1 << 16)))


def build_root(root: Path, out_dir: Path) -> ctypes.CDLL:
    """DIR's row-kernel library, bound like tpu/row_ops.py binds ours."""
    from throttlecrab_tpu_torch.tpu import nvcc

    csrc = root / "throttlecrab_tpu_torch" / "csrc"
    out = out_dir / "libtc_row_ops_root.so"
    subprocess.run(
        [nvcc._nvcc(), *nvcc.NVCC_FLAGS, "-I", str(csrc), "-o", str(out),
         str(csrc / "row_ops.cu")],
        check=True, capture_output=True, text=True,
    )
    lib = ctypes.CDLL(str(out))
    p = ctypes.c_void_p
    for fn in (lib.tc_row_gather, lib.tc_row_scatter):
        fn.argtypes = [p, ctypes.c_longlong, ctypes.c_int, p, ctypes.c_int,
                       p, p]
        fn.restype = ctypes.c_int
    return lib


def build_both(root: Path, out_dir: Path) -> ctypes.CDLL:
    """This checkout's library and DIR's, one nvcc each, together."""
    from throttlecrab_tpu_torch.tpu import row_ops

    got, errors = {}, []

    def run(key, fn):
        try:
            got[key] = fn()
        except Exception as e:  # re-raised below
            errors.append(e)

    threads = [threading.Thread(target=run, args=a) for a in (
        ("ours", row_ops.build), ("root", lambda: build_root(root, out_dir)))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    return got["root"]


def sides(lib_root, table, idxs, rows):
    """{side: (gather(k), scatter(k))} on index set k: the gather returns
    a fresh output, the scatter writes `rows` into `table`."""
    import torch

    from throttlecrab_tpu_torch.tpu import row_ops

    n, w = table.shape
    b = rows.shape[0]
    longs = [i.long() for i in idxs]
    stream = torch.cuda.current_stream().cuda_stream

    def root(fn, dense_of):
        def call(k):
            dense = dense_of()
            rc = fn(table.data_ptr(), n, w, idxs[k].data_ptr(), b,
                    dense.data_ptr(), stream)
            if rc:
                raise RuntimeError(f"root kernel: CUDA error {rc}")
            return dense
        return call

    def fresh():
        return table.new_empty((b, w))

    return {
        "root": (root(lib_root.tc_row_gather, fresh),
                 root(lib_root.tc_row_scatter, lambda: rows)),
        "kernel": (lambda k: row_ops.row_gather(table, idxs[k]),
                   lambda k: row_ops.row_scatter(table, idxs[k], rows)),
        "library": (lambda k: table.index_select(0, longs[k]),
                    lambda k: table.index_copy_(0, longs[k], rows)),
    }


def check_sides(table, idxs, rows, fns):
    """Every side's gather and scatter on index set 0 equal the plain
    version's; the table is restored after each scatter."""
    from throttlecrab_tpu_torch.tpu import row_ops

    want_rows = row_ops.row_gather_plain(table, idxs[0])
    saved = table.clone()
    want_table = row_ops.row_scatter_plain(saved.clone(), idxs[0], rows)
    for side, (gather, scatter) in fns.items():
        if not gather(0).equal(want_rows):
            raise AssertionError(f"{side} gather differs from plain")
        scatter(0)
        ok = table.equal(want_table)
        table.copy_(saved)
        if not ok:
            raise AssertionError(f"{side} scatter differs from plain")


def time_case(lib_root, w, b, n, rng, rounds, flush):
    """({side: {kind: {"warm": [ms], "cold": [ms]}}}, the index sets'
    sector-counted bounds) for one (W, B)."""
    table, _, rows = cs.row_case(rng, n, b, w, "cuda")
    idxs = [cs.row_case_idx(rng, n, b, "cuda") for _ in range(8)]
    fns = sides(lib_root, table, idxs, rows)
    check_sides(table, idxs, rows, fns)
    out = {side: {k: {"warm": [], "cold": []} for k in ("gather", "scatter")}
           for side in fns}
    order = list(fns)
    for r in range(rounds):
        for side in order if r % 2 == 0 else order[::-1]:
            for kind, fn in zip(("gather", "scatter"), fns[side]):
                nxt = itertools.cycle(range(len(idxs))).__next__

                def call(fn=fn, nxt=nxt):
                    fn(nxt())

                out[side][kind]["warm"].append(
                    cs.profile_device(call, 50)[1])
                out[side][kind]["cold"].append(
                    cs.cold_device_ms(call, flush))
    return out, [cs.row_sector_bound_ms(i.cpu().numpy(), w) for i in idxs]


def median(v):
    v = [x for x in v if x is not None]
    return statistics.median(v) if v else None


def main() -> int:
    import numpy as np
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", required=True, type=Path,
                    help="the other checkout (e.g. the parent commit)")
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--out", type=Path)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("row_ab: needs a CUDA card", file=sys.stderr)
        return 2
    card = cs.card_line()
    with tempfile.TemporaryDirectory() as tmp:
        lib_root = build_both(args.root.resolve(), Path(tmp))
        flush = cs.l2_flusher("cuda")
        rng = np.random.default_rng(10)
        result = {"card": card, "root": str(args.root), "cases": {}}
        for b, n in CASES:
            for w in (4, 6):
                times, sector = time_case(lib_root, w, b, n, rng,
                                          args.rounds, flush)
                bound = cs.row_bound_ms(b, w)
                key = f"W={w} B={b}"
                result["cases"][key] = {
                    "n": n, "bound_ms": bound,
                    "sector_bound_ms": float(np.mean(sector)),
                    "times": times,
                }
                for side, kinds in times.items():
                    for kind, t in kinds.items():
                        warm, cold = median(t["warm"]), median(t["cold"])
                        print(f"{key} {kind:7} {side:24} warm {warm} ms "
                              f"{t['warm']}, cold {cold} ms {t['cold']}; "
                              f"share of bound warm "
                              f"{bound / warm if warm else None}, cold "
                              f"{bound / cold if cold else None}")
    print(f"card: {card}")
    line = json.dumps(result)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
