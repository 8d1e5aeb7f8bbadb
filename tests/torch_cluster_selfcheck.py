"""Run one cluster lifecycle of `torch_cluster.py` many times under load
and count where the runs differ from an all-JAX reference run.

`test_torch_cluster_mixed.py` holds each mixed cluster against one
all-JAX run of the same lifecycle (seed 23), inside a tier-1 run of six
pytest workers.  This script asks whether the reference itself repeats:
each of `--workers` processes at once (the load of a six-worker run)
holds one set of ports, as the test's fixture does, runs the all-JAX
lifecycle once as its reference and then the `--mix` lifecycle `--reps`
times on the same ports, and compares every run with its reference step
by step, exactly as `compare_runs` does (batch results, then each node's
table, replica store and cluster view).  The ring hashes each node's
address, so runs are comparable only on the same ports.  `--busy N`
adds N processes that only spin, for a heavier load than the workers'.

    JAX_PLATFORMS=cpu python tests/torch_cluster_selfcheck.py \
        [--mix jax,jax,jax] [--workers 6] [--reps 4] [--seed 23] [--busy 0]

Prints one JSON line: the runs, the runs that differ, and the
differences by step, node and part, with the first few entries of each.
"""

from __future__ import annotations

import argparse
import collections
import json
import multiprocessing
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))


def _setup():
    sys.path.insert(0, HERE)
    sys.path.insert(0, os.path.dirname(HERE))
    os.environ["JAX_PLATFORMS"] = "cpu"
    import throttlecrab_tpu  # noqa: F401  (x64 before any tracing)
    import jax

    jax.config.update("jax_platforms", "cpu")


def _spin(stop):
    while not stop.is_set():
        pass


def differences(ref, got):
    """[(step, node or "batch", part, detail)] between two runs."""
    from torch_cluster import _diff

    out = []
    got_steps = {s: (r, rec) for s, r, rec in got}
    for step, r_res, r_rec in ref:
        g_res, g_rec = got_steps[step]
        for i, (a, b) in enumerate(zip(r_res, g_res)):
            if a != b:
                out.append((step, "batch", str(i), "results differ"))
        if len(r_res) != len(g_res) or sorted(r_rec) != sorted(g_rec):
            out.append((step, "batch", "count", "batches or nodes differ"))
            continue
        for node in r_rec:
            for part in ("state", "replica", "view"):
                a, b = r_rec[node][part], g_rec[node][part]
                if a != b:
                    out.append((step, str(node), part,
                                repr(_diff(a, b))[:300]))
    return out


def _worker(args):
    pkgs, seed, reps = args
    _setup()
    from torch_cluster import Ports, run_lifecycle

    ports = Ports(3)  # held between runs, as the test's fixture holds them
    try:
        ref = run_lifecycle(["jax"] * 3, ports, seed=seed)
        return [differences(ref, run_lifecycle(pkgs, ports, seed=seed))
                for _ in range(reps)]
    finally:
        ports.close()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--mix", default="jax,jax,jax")
    ap.add_argument("--workers", type=int, default=6)
    ap.add_argument("--reps", type=int, default=4)
    ap.add_argument("--seed", type=int, default=23)
    ap.add_argument("--busy", type=int, default=0)
    args = ap.parse_args(argv)
    pkgs = args.mix.split(",")
    ctx = multiprocessing.get_context("spawn")
    stop = ctx.Event()
    spinners = [ctx.Process(target=_spin, args=(stop,))
                for _ in range(args.busy)]
    for p in spinners:
        p.start()
    try:
        with ctx.Pool(args.workers) as pool:
            runs = [d for part in pool.map(
                _worker, [(pkgs, args.seed, args.reps)] * args.workers)
                for d in part]
    finally:
        stop.set()
        for p in spinners:
            p.join(timeout=10)
    where = collections.Counter()
    first = {}
    for diffs in runs:
        for step, node, part, detail in diffs:
            key = f"{step}/{node}/{part}"
            where[key] += 1
            first.setdefault(key, detail)
    print(json.dumps({
        "mix": pkgs, "seed": args.seed, "workers": args.workers,
        "busy": args.busy,
        "runs": len(runs), "runs_differing": sum(bool(d) for d in runs),
        "differences": dict(where), "first": first,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
