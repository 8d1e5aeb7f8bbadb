"""Lock-acquisition order: the whole-program deadlock ratchet.

Every ``with lock:`` / ``.acquire()`` region is threaded through the
conservative intra-package call graph (analysis/concurrency.py) and
validated against the canonical total order declared in
``lockorder.toml``: acquiring a lock whose rank is <= the rank of any
lock already held is an inversion (``lock-order``).  Because the
declared order is total, any would-be cycle between two ranked locks
necessarily contains an inversion, so cycles need no separate search.

The declaration and the tree ratchet against each other:

  * ``lock-unranked``     — a ``threading.Lock()``/``RLock()``/
    ``Condition()`` creation site with no ``[[lock]]`` entry: new locks
    must take a position in the canonical order before they ship;
  * ``lock-decl-stale``   — a ``[[lock]]`` (or ``[[alias]]``) entry
    whose creation site no longer exists: the order file can only ever
    shrink with the code, never outlive it;
  * ``lock-config-missing`` — the package is present but
    ``lockorder.toml`` is not (the checker would silently pass
    otherwise).

Same-lock self-edges are skipped: lock identity is per class
attribute, and acquiring peer B's ``PeerConnection.lock`` inside peer
A's region is the cluster's normal pipelined forwarding (the
cross-instance protocol — index-ordered acquisition — is documented at
the site and out of static scope).
"""

from __future__ import annotations

from pathlib import Path
from typing import List

from .common import Finding, pragma_codes
from .concurrency import LOCKORDER_REL, SCAN_DIR, build_model

INVERSION = "lock-order"
UNRANKED = "lock-unranked"
DECL_STALE = "lock-decl-stale"
CONFIG_MISSING = "lock-config-missing"


def check(root) -> List[Finding]:
    root = Path(root)
    if not (root / SCAN_DIR).is_dir():
        return []
    model = build_model(root)
    findings: List[Finding] = []

    spec = model.spec
    if spec is None:
        if model.created:
            findings.append(
                Finding(
                    code=CONFIG_MISSING,
                    path=LOCKORDER_REL,
                    line=1,
                    message=(
                        "lockorder.toml is missing but the tree "
                        f"creates {len(model.created)} lock(s) — the "
                        "canonical order must be declared"
                    ),
                )
            )
        return findings

    # ---- declaration <-> creation-site ratchet -------------------- #
    for lock_id in sorted(spec.decls):
        if lock_id not in model.created:
            findings.append(
                Finding(
                    code=DECL_STALE,
                    path=LOCKORDER_REL,
                    line=spec.decls[lock_id].line or 1,
                    message=(
                        f"[[lock]] entry {lock_id} matches no "
                        "threading.Lock/RLock/Condition creation site "
                        "in the tree (delete or update the entry)"
                    ),
                )
            )
    for (cls, name), target in sorted(spec.aliases.items()):
        if target not in spec.decls:
            findings.append(
                Finding(
                    code=DECL_STALE,
                    path=LOCKORDER_REL,
                    line=spec.alias_lines.get((cls, name), 0) or 1,
                    message=(
                        f"[[alias]] {cls}.{name} targets undeclared "
                        f"lock {target}"
                    ),
                )
            )
    aliased = {
        f"{cls}.{name}" for (cls, name) in spec.aliases
    }
    for lock_id in sorted(model.created):
        if lock_id not in spec.decls and lock_id not in aliased:
            rel, line = model.created[lock_id]
            findings.append(
                Finding(
                    code=UNRANKED,
                    path=rel,
                    line=line,
                    message=(
                        f"lock {lock_id} is created here but has no "
                        "[[lock]] entry in lockorder.toml — every lock "
                        "must take a position in the canonical order"
                    ),
                )
            )

    ranked = set(spec.decls)

    def rank(lock_id: str) -> int:
        return spec.decls[lock_id].rank

    # ---- nested-acquisition validation ---------------------------- #
    seen = set()

    def emit(fn, held, acquired, line, via=""):
        if held == acquired:
            return  # per-instance self-nesting: out of static scope
        if held not in ranked or acquired not in ranked:
            return
        if rank(acquired) > rank(held):
            return
        key = (fn.rel, line, held, acquired)
        if key in seen:
            return
        seen.add(key)
        mod = model.modules[fn.rel]
        if INVERSION in pragma_codes(mod.lines, line):
            return
        findings.append(
            Finding(
                code=INVERSION,
                path=fn.rel,
                line=line,
                symbol=mod.qualname(fn.node),
                message=(
                    f"lock-order inversion: {acquired} (rank "
                    f"{rank(acquired)}) acquired while {held} "
                    f"(rank {rank(held)}) is held{via} — the "
                    "canonical order in lockorder.toml says "
                    f"{acquired} comes first"
                ),
            )
        )

    for fid, fn in sorted(model.fns.items()):
        for acquired, line, held_stack in fn.acquires:
            for held in held_stack:
                emit(fn, held, acquired, line)
        for spec_t, line, held_stack, awaited in fn.calls:
            if not held_stack:
                continue
            callee = model.resolve(spec_t, fn.rel, fn.cls, awaited)
            if callee is None or model.fns[callee].is_async:
                continue  # awaited async callees: async checker's beat
            for acquired in sorted(model.closure_acq[callee]):
                for held in held_stack:
                    if (
                        held == acquired
                        or held not in ranked
                        or acquired not in ranked
                        or rank(acquired) > rank(held)
                    ):
                        continue
                    chain = model.witness(callee, _acquires(model, acquired))
                    via = (
                        " (via " + " -> ".join(chain) + ")"
                        if chain
                        else ""
                    )
                    emit(fn, held, acquired, line, via)

    findings.sort(key=lambda f: (f.path, f.line, f.message))
    return findings


def _acquires(model, lock_id):
    """Witness predicate: does this function directly acquire lock_id?"""
    def pred(fid):
        return any(a[0] == lock_id for a in model.fns[fid].acquires)

    return pred
