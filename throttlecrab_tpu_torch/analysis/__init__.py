"""Static invariant analysis for the PyTorch/CUDA port's own tree.

The counterpart of ``throttlecrab_tpu/analysis``: the same twelve
checkers under the same names, emitting the same finding codes, over
``throttlecrab_tpu_torch/``, its CUDA sources in ``csrc/`` and the
shared ``native/*.cpp`` the port builds unmodified.  Where the JAX
suite's subject has no counterpart in the port, the checker takes the
port's own subject for the same invariant:

  * ``i64_hygiene``  — raw ``+``/``-``/``*`` on int64 TAT/tolerance/
    expiry expressions in the port's hot-path modules that are neither
    routed through the saturating helpers nor dominated by an explicit
    ``>= 2**61`` refusal guard;
  * ``twin_drift``   — wire constants, status codes, prep flags, error
    strings and the 2^61/2^62 certificates of the Python side against
    ``native/keymap.cpp`` / ``native/wire_server.cpp``, AND the
    ``constexpr`` layout, flag, tier and batch constants of the CUDA
    sources (``csrc/gcra_lane.cuh``, ``csrc/row_tile.cuh``) against
    ``tpu/kernel.py``, ``tpu/fused.py`` and ``tpu/row_ops.py``;
  * ``jit_boundary`` — what the port compiles for the card: host-only
    calls (``printf``, allocation, ``std::`` clocks, randomness, I/O)
    inside ``__global__`` kernels and ``TC_HD``/``TC_ROW_HD`` bodies
    of ``csrc/``, and Python ``if``/``while``/``assert`` on a device
    tensor's value in the launch wrappers (a hidden device sync);
  * ``registry``     — every ``THROTTLECRAB_*`` knob the port reads is
    documented (README or the port's ``KNOBS.md``), every knob the
    port's own doc promises is still read, ``config._SPEC`` flags pair
    with their env knobs, and the port's metrics match its
    ``server/metrics.py`` METRIC_NAMES registry (both directions);
  * ``lock`` / ``block`` / ``async`` — the port's locks against the
    canonical order in ``lockorder.toml``, blocking calls (socket,
    device launch or sync, sleep, waits, I/O, subprocess) under ranked
    locks, and the event-loop/thread boundary;
  * ``wire`` / ``harden`` — the port's cluster frame kinds and trace
    records: decoder, encoder, dispatch, fuzz (the port's own mutation
    cases) and replayer arms, and the decode-hardening contract;
  * ``status``       — status-taxonomy totality across the port's
    transports and the C++ responder;
  * ``fault``        — the port's fault sites against hooks, typed
    errors, modes and the README table;
  * ``ktwin``        — the saturating lattice of ``tpu/sat.py``
    against its C++ copy in ``csrc/gcra_lane.cuh``, both normalized
    into one op-DAG IR, and the decide's closed forms in
    ``tpu/kernel.py`` against the lane body.

Pure stdlib, AST-based plus a small C++ token scanner: importing this
package (or running ``python -m throttlecrab_tpu_torch.analysis``)
never imports torch, numpy, jax, nor the package under analysis —
sources are parsed, not executed.  Audited exceptions live in
``baseline.toml`` next to this file; the suite ratchets from zero
unwaived findings.
"""

from __future__ import annotations

import time
from pathlib import Path
from typing import Dict, List, Tuple

from .common import Finding, apply_baseline, load_baseline
from . import (
    async_boundary,
    blocking,
    fault_surface,
    i64_hygiene,
    jit_boundary,
    kernel_twins,
    lock_order,
    registry,
    status_surface,
    twin_drift,
    wire_surface,
)

#: name -> check(root) callables, in report order.
CHECKERS = {
    "i64": i64_hygiene.check,
    "twin": twin_drift.check,
    "jit": jit_boundary.check,
    "registry": registry.check,
    "lock": lock_order.check,
    "block": blocking.check,
    "async": async_boundary.check,
    "wire": wire_surface.check_surface,
    "harden": wire_surface.check_hardening,
    "status": status_surface.check,
    "fault": fault_surface.check,
    "ktwin": kernel_twins.check,
}

#: checker name -> the finding-code prefixes it emits.  The CLI uses
#: this to scope baseline waivers on partial ``--checks`` runs; keeping
#: it next to CHECKERS means registering a checker without declaring
#: its codes is a KeyError at import time, not a silent waiver leak.
CHECKER_CODES = {
    "i64": ("i64",),
    "twin": ("twin",),
    "jit": ("jit",),
    "registry": ("knob", "metric", "flag"),
    "lock": ("lock",),
    "block": ("block",),
    "async": ("async",),
    "wire": ("wire",),
    "harden": ("harden",),
    "status": ("status",),
    "fault": ("fault",),
    "ktwin": ("ktwin",),
}
assert set(CHECKER_CODES) == set(CHECKERS)

DEFAULT_BASELINE = Path(__file__).with_name("baseline.toml")


def run_timed(
    root, checks=None
) -> Tuple[List[Finding], Dict[str, float]]:
    """Run the selected checkers (default: all); findings plus
    per-checker wall time (the CI budget assertion and ``--json``
    timings both read it).  Unknown checker names raise ValueError —
    a typo'd programmatic selection must not silently run nothing."""
    root = Path(root)
    if checks is not None:
        unknown = set(checks) - set(CHECKERS)
        if unknown:
            raise ValueError(
                f"unknown checks {sorted(unknown)}; "
                f"available: {sorted(CHECKERS)}"
            )
    findings: List[Finding] = []
    timings: Dict[str, float] = {}
    for name, fn in CHECKERS.items():
        if checks is None or name in checks:
            t0 = time.monotonic()
            findings.extend(fn(root))
            timings[name] = round(time.monotonic() - t0, 3)
    findings.sort(key=lambda f: (f.path, f.line, f.code))
    return findings, timings


def run_all(root, checks=None) -> List[Finding]:
    """Run the selected checkers (default: all) over a repo tree."""
    return run_timed(root, checks=checks)[0]


__all__ = [
    "CHECKERS",
    "CHECKER_CODES",
    "DEFAULT_BASELINE",
    "Finding",
    "apply_baseline",
    "load_baseline",
    "run_all",
    "run_timed",
]
