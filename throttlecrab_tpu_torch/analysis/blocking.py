"""Blocking calls while a ranked lock is held.

An entire class of availability bugs was found by hand in the
cluster tier: socket sends riding ``device_lock`` (two nodes healing
each other deadlock on full TCP buffers), executor waits behind the
handoff gate, migrate streams stalling every local decision.  This
checker ratchets the fixed state: every call matching the blocking taxonomy in
``lockorder.toml`` (``[[blocking]]`` — net / device / sleep / wait /
io / subprocess) that is reachable while a ranked lock is held must be
a kind that lock's ``allow`` list sanctions.  ``device_lock`` allows
``device`` (serializing launches is its job) but not ``net``;
re-introducing a send under it fails strict mode instead of waiting
for the next review.

Reachability is direct (the call appears inside the ``with`` body or
after a sticky ``.acquire()``) or transitive through the conservative
call graph; awaited calls are excluded here (the async-boundary
checker owns the event-loop side).
"""

from __future__ import annotations

from pathlib import Path
from typing import List

from .common import Finding, pragma_codes
from .concurrency import SCAN_DIR, build_model

BLOCK = "block-under-lock"


def check(root) -> List[Finding]:
    root = Path(root)
    if not (root / SCAN_DIR).is_dir():
        return []
    model = build_model(root)
    if model.spec is None:
        return []  # lock_order reports the missing config
    spec = model.spec
    findings: List[Finding] = []
    seen = set()

    def emit(fn, held, kind, call, line, via=""):
        decl = spec.decls.get(held)
        if decl is None or kind in decl.allow:
            return
        key = (fn.rel, line, held, kind)
        if key in seen:
            return
        seen.add(key)
        mod = model.modules[fn.rel]
        if BLOCK in pragma_codes(mod.lines, line):
            return
        findings.append(
            Finding(
                code=BLOCK,
                path=fn.rel,
                line=line,
                symbol=mod.qualname(fn.node),
                message=(
                    f"blocking call `{call}` ({kind}) while {held} is "
                    f"held{via} — {held} allows "
                    f"[{', '.join(sorted(decl.allow)) or 'nothing'}]; "
                    "move the call outside the lock or extend the "
                    "audited allow list in lockorder.toml"
                ),
            )
        )

    for fid, fn in sorted(model.fns.items()):
        for kind, call, line, held_stack, awaited in fn.blocks:
            if awaited:
                continue
            for held in held_stack:
                emit(fn, held, kind, call, line)
        for spec_t, line, held_stack, awaited in fn.calls:
            if not held_stack or awaited:
                continue
            callee = model.resolve(spec_t, fn.rel, fn.cls, awaited)
            if callee is None or model.fns[callee].is_async:
                continue
            for kind, call in sorted(model.closure_blk[callee]):
                chain = model.witness(callee, blocks_pred(model, kind, call))
                via = (
                    " (via " + " -> ".join(chain) + ")" if chain else ""
                )
                for held in held_stack:
                    emit(fn, held, kind, call, line, via)

    findings.sort(key=lambda f: (f.path, f.line, f.message))
    return findings


def blocks_pred(model, kind, call):
    """Witness predicate: does this function directly make the call?"""
    def pred(fid):
        return any(
            b[0] == kind and b[1] == call
            for b in model.fns[fid].blocks
        )

    return pred
