"""Run the port's invariant suite over a tree and report findings.

    python -m throttlecrab_tpu_torch.analysis            # report, exit 0
    python -m throttlecrab_tpu_torch.analysis --strict   # exit 1 on
                                                         # unwaived findings
                                                         # or stale waivers
    python -m throttlecrab_tpu_torch.analysis --json     # machine-readable
    python -m throttlecrab_tpu_torch.analysis --checks i64,twin,ktwin
    python -m throttlecrab_tpu_torch.analysis --max-seconds 30

Pure stdlib and AST-based: finishes in seconds and never imports torch,
numpy or jax (checked at exit and reported in the JSON as
``torch_imported`` / ``numpy_imported`` / ``jax_imported``; any of them
true is an internal error, exit 2).  Audited exceptions live in
``throttlecrab_tpu_torch/analysis/baseline.toml``; everything else fails
strict mode.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

from . import (
    CHECKER_CODES,
    CHECKERS,
    apply_baseline,
    load_baseline,
    run_timed,
)

REPO_ROOT = Path(__file__).resolve().parent.parent.parent
BASELINE_REL = Path("throttlecrab_tpu_torch") / "analysis" / "baseline.toml"

#: Modules whose presence means a checker executed the tree (or pulled
#: in a heavyweight dependency) instead of parsing it.
HEAVY = ("torch", "numpy", "jax")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m throttlecrab_tpu_torch.analysis",
        description="throttlecrab-tpu port invariant linter suite",
    )
    parser.add_argument(
        "--root",
        type=Path,
        default=REPO_ROOT,
        help="repo root to analyze (default: this checkout)",
    )
    parser.add_argument(
        "--strict",
        action="store_true",
        help="exit 1 on unwaived findings or stale waivers",
    )
    parser.add_argument("--json", action="store_true", help="JSON output")
    parser.add_argument(
        "--checks",
        default="",
        help="comma-separated subset of checkers "
        f"({','.join(CHECKERS)})",
    )
    parser.add_argument(
        "--baseline",
        type=Path,
        default=None,
        help="waiver file (default: throttlecrab_tpu_torch/analysis/"
        "baseline.toml under --root)",
    )
    parser.add_argument(
        "--max-seconds",
        type=float,
        default=0.0,
        help="runtime budget: exit 1 when the suite takes longer "
        "(0 disables)",
    )
    args = parser.parse_args(argv)

    checks = None
    if args.checks:
        checks = {c.strip() for c in args.checks.split(",") if c.strip()}
        unknown = checks - set(CHECKERS)
        if unknown:
            parser.error(
                f"unknown checks {sorted(unknown)}; "
                f"available: {sorted(CHECKERS)}"
            )
    baseline_path = args.baseline or args.root / BASELINE_REL

    t0 = time.monotonic()
    findings, timings = run_timed(args.root, checks=checks)
    waivers = load_baseline(baseline_path)
    if checks is not None:
        # Partial runs can't judge waiver staleness for skipped checkers.
        prefixes = {c for check in checks for c in CHECKER_CODES[check]}
        waivers = [w for w in waivers if w.code.split("-")[0] in prefixes]
    unwaived, stale = apply_baseline(findings, waivers)
    elapsed = time.monotonic() - t0
    imported = {name: name in sys.modules for name in HEAVY}

    if args.json:
        print(
            json.dumps(
                {
                    "findings": [
                        {**vars(f), "id": _finding_id(f)} for f in unwaived
                    ],
                    "waived": len(findings) - len(unwaived),
                    "stale_waivers": [vars(w) for w in stale],
                    "elapsed_s": round(elapsed, 3),
                    "checker_s": timings,
                    **{f"{n}_imported": v for n, v in imported.items()},
                },
                indent=2,
            )
        )
    else:
        for f in unwaived:
            print(f.format())
        for w in stale:
            print(
                f"{baseline_path.name}: violated waiver "
                f"({w.code} {w.path} {w.symbol or w.line}): matches no "
                "current finding (stale — delete the entry) or a "
                "different number than its pinned count (re-audit and "
                "update)"
            )
        print(
            f"invariants: {len(unwaived)} unwaived finding(s), "
            f"{len(findings) - len(unwaived)} waived, "
            f"{len(stale)} violated waiver(s) in {elapsed:.2f}s"
        )
    loaded = sorted(n for n, v in imported.items() if v)
    if loaded:
        print(
            f"invariants: INTERNAL ERROR — the analysis imported {loaded}",
            file=sys.stderr,
        )
        return 2
    if args.max_seconds and elapsed > args.max_seconds:
        print(
            f"invariants: runtime budget exceeded — {elapsed:.1f}s > "
            f"{args.max_seconds:.0f}s (per-checker: {timings})",
            file=sys.stderr,
        )
        return 1
    if args.strict and (unwaived or stale):
        return 1
    return 0


def _finding_id(f) -> str:
    return f"{f.path}:{f.symbol or f.line}:{f.code}"


if __name__ == "__main__":
    sys.exit(main())
