"""i64 overflow hygiene for the port's GCRA hot paths.

The bug class (a big-tolerance lane wrapping ``fits_w32_wire``'s bound
sums): TAT/tolerance/expiry values are int64 on every backend (numpy
host math, torch int64 tensors, the CUDA lane body, the C++ twins), so
a raw ``+``/``-``/``*`` wraps silently where Rust's
``saturating_*`` semantics — or an explicit ``>= 2**61`` refusal guard
— were required.  This lint walks the hot-path modules and flags every
such raw operator whose operands touch the TAT/tolerance domain, unless

  * every sensitive identifier in the expression is *dominated* by an
    explicit big-value refusal guard earlier in the same function — a
    comparison of that identifier against a constant >= 2**61 (or a
    recognized bound alias such as ``_BOUND``/``I64_MAX``), the pattern
    the wire certificates use;
  * the expression is provably plain-Python/float math: operands built
    from ``int(...)``/``float(...)``/``len(...)`` coercions, constants,
    ``min``/``max`` over those, or ``.astype(np.float64)`` — Python
    ints cannot wrap and f64 cannot wrap i64-style;
  * an ``# inv: allow(i64-raw-op)`` pragma marks a deliberately
    *wrapping* site (the reference's own semantics wrap in two audited
    places), or a ``baseline.toml`` waiver records the audit.

Saturating calls (``sat_add(a, b)`` etc.) contain no raw BinOp, so
routing through the helpers passes by construction.
"""

from __future__ import annotations

import ast
import re
from pathlib import Path
from typing import List, Optional, Set, Tuple

from .common import (
    Finding,
    PyModule,
    attached_exprs,
    child_stmt_lists,
    dotted_name,
    fold_int,
    names_in,
    pragma_codes,
)

CODE = "i64-raw-op"

#: The port's modules whose int64 arithmetic is decision-critical (the
#: counterparts of the JAX suite's list).
HOT_PATHS = (
    "throttlecrab_tpu_torch/tpu/kernel.py",
    "throttlecrab_tpu_torch/tpu/limiter.py",
    "throttlecrab_tpu_torch/tpu/snapshot.py",
    "throttlecrab_tpu_torch/tpu/table.py",
    "throttlecrab_tpu_torch/front/deny_cache.py",
    "throttlecrab_tpu_torch/parallel/sharded.py",
    "throttlecrab_tpu_torch/parallel/cluster.py",
)

#: Identifier fragments that put an expression in the TAT/tolerance
#: domain (matched against _-separated words, case-insensitive).
_SENSITIVE = re.compile(
    r"(?:^|_)(tats?|tol|tolerances?|expiry|expiries|ttl|hwm|incs?|"
    r"increment|em|emission|cur|cur2|allow_at)(?:_|$)"
)

#: The refusal-guard threshold: any comparison against >= this bound
#: counts as an overflow guard (2**61 is the wire certificates' bound;
#: 2**62 and I64_MAX guards are stricter still).
GUARD_MIN = 1 << 61

#: Names conventionally bound to the 2**61 bound (deny_cache._BOUND) or
#: to i64 extremes / the 2**62 segment certificate.
_BOUND_ALIASES = {"_BOUND", "BOUND", "I64_MAX", "I64_MIN", "_MUL_SAFE"}

_RAW_OPS = {ast.Add: "+", ast.Sub: "-", ast.Mult: "*"}

#: Calls whose result is a plain Python int/float (wrap-free).
_COERCIONS = {"int", "float", "len", "bool", "abs"}
_SAFE_COMBINATORS = {"min", "max", "sum"}

_SCOPES = (ast.FunctionDef, ast.AsyncFunctionDef)


def is_sensitive_name(name: str) -> bool:
    # ALL_CAPS identifiers are compile-time constants (I64_MAX,
    # EMPTY_EXPIRY, field-width masks), not runtime TAT/tolerance
    # values; a wrap involving one still flags via the other operand.
    if name.isupper():
        return False
    return _SENSITIVE.search(name.lower()) is not None


def _sensitive_idents(node: ast.AST) -> Set[str]:
    return {n for n in names_in(node) if is_sensitive_name(n)}


def _terminal(node: ast.AST) -> Optional[str]:
    if isinstance(node, ast.Name):
        return node.id
    if isinstance(node, ast.Attribute):
        return node.attr
    return None


class _SafetyEnv:
    """Per-scope forward dataflow: which locals are provably plain
    Python ints/floats (assigned from coercions of the same)."""

    def __init__(self) -> None:
        self.safe: Set[str] = set()

    def is_safe(self, node: ast.AST) -> bool:
        if isinstance(node, ast.Constant):
            return isinstance(node.value, (int, float))
        if isinstance(node, ast.Name):
            return node.id in self.safe
        if isinstance(node, ast.UnaryOp):
            return self.is_safe(node.operand)
        if isinstance(node, ast.BinOp):
            return self.is_safe(node.left) and self.is_safe(node.right)
        if isinstance(node, ast.IfExp):
            return self.is_safe(node.body) and self.is_safe(node.orelse)
        if isinstance(node, ast.Call):
            fn = node.func
            if isinstance(fn, ast.Name):
                if fn.id in _COERCIONS:
                    return True  # coercion: result is plain Python
                if fn.id in _SAFE_COMBINATORS:
                    return bool(node.args) and all(
                        self.is_safe(a) for a in node.args
                    )
            # x.astype(np.float64) / x.astype(float): f64 lattice —
            # cannot wrap i64-style (loses precision instead, which the
            # certificates account for explicitly).
            if isinstance(fn, ast.Attribute) and fn.attr == "astype":
                for arg in node.args:
                    if _terminal(arg) in ("float64", "float"):
                        return True
        return False

    def observe_assign(self, stmt: ast.stmt) -> None:
        if isinstance(stmt, ast.Assign):
            targets, value = stmt.targets, stmt.value
        elif isinstance(stmt, ast.AnnAssign) and stmt.value is not None:
            targets, value = [stmt.target], stmt.value
        elif isinstance(stmt, ast.AugAssign):
            if isinstance(stmt.target, ast.Name) and not (
                stmt.target.id in self.safe and self.is_safe(stmt.value)
            ):
                self.safe.discard(stmt.target.id)
            return
        else:
            return
        safe = self.is_safe(value)
        for t in targets:
            if isinstance(t, ast.Name):
                (self.safe.add if safe else self.safe.discard)(t.id)
            else:
                # Tuple/starred/subscript targets rebind to values of
                # unknown provenance: revoke, never grant.
                for sub in ast.walk(t):
                    if isinstance(sub, ast.Name):
                        self.safe.discard(sub.id)


def _is_bound(node: ast.expr) -> bool:
    v = fold_int(node)
    if v is not None and abs(v) >= GUARD_MIN:
        return True
    return _terminal(node) in _BOUND_ALIASES


def _directional_guards(test: ast.expr) -> Tuple[Set[str], Set[str]]:
    """(true_side, false_side): identifiers known to sit BELOW the
    2**61 bound when the test evaluates true / false respectively.

    Direction matters: in ``if tol >= 2**61: <body>`` the body is the
    OVERFLOW side — only the else/after-refusal path may treat ``tol``
    as bounded.  Handles comparison chains (``0 <= x < bound``),
    ``not``, and and/or combinations; anything undecidable contributes
    to neither side.
    """
    if isinstance(test, ast.UnaryOp) and isinstance(test.op, ast.Not):
        t, f = _directional_guards(test.operand)
        return f, t
    if isinstance(test, ast.BoolOp):
        parts = [_directional_guards(v) for v in test.values]
        if isinstance(test.op, ast.And):
            # All conjuncts hold on the true side; the false side is
            # "some conjunct failed" — nothing is known.
            true: Set[str] = set()
            for t, _ in parts:
                true |= t
            return true, set()
        # Or: the false side means every disjunct failed, so each
        # disjunct's false-side knowledge holds; the true side is
        # "some disjunct held" — nothing is known.
        false: Set[str] = set()
        for _, f in parts:
            false |= f
        return set(), false
    if isinstance(test, ast.Call):
        # See through truth-preserving wrappers only: bool(x) and
        # any-reductions (np.any false ⇒ every lane false).  np.all
        # must NOT pass — its false branch means only SOME lane failed
        # the comparison, which bounds nothing.
        name = dotted_name(test.func) or ""
        if (
            len(test.args) == 1
            and not test.keywords
            and (name in ("bool", "any") or name.endswith(".any"))
        ):
            return _directional_guards(test.args[0])
        return set(), set()
    if not isinstance(test, ast.Compare):
        return set(), set()
    sides = [test.left, *test.comparators]
    true: Set[str] = set()
    false: Set[str] = set()
    for j, side in enumerate(sides):
        if not _is_bound(side):
            continue
        # The operand adjacent to the bound decides the direction;
        # everything on the small side of the operator chain is
        # bounded on that branch.
        if j > 0:
            op = test.ops[j - 1]
            idents = {
                n
                for s in sides[:j]
                for n in names_in(s)
                if n not in _BOUND_ALIASES
            }
            if isinstance(op, (ast.Lt, ast.LtE)):
                true |= idents  # x < bound: true side is bounded
            elif isinstance(op, (ast.Gt, ast.GtE)):
                false |= idents  # x >= bound: false side is bounded
        if j < len(sides) - 1:
            op = test.ops[j]
            idents = {
                n
                for s in sides[j + 1 :]
                for n in names_in(s)
                if n not in _BOUND_ALIASES
            }
            if isinstance(op, (ast.Gt, ast.GtE)):
                true |= idents  # bound > x
            elif isinstance(op, (ast.Lt, ast.LtE)):
                false |= idents  # bound <= x
    return true, false


def _assigned_names(stmt: ast.stmt) -> Set[str]:
    """Names (re)bound by this statement — assignment targets and loop
    variables."""
    targets: List[ast.expr] = []
    if isinstance(stmt, ast.Assign):
        targets = list(stmt.targets)
    elif isinstance(stmt, (ast.AnnAssign, ast.AugAssign, ast.For)):
        targets = [stmt.target]
    out: Set[str] = set()
    for t in targets:
        for sub in ast.walk(t):
            if isinstance(sub, ast.Name):
                out.add(sub.id)
    return out


def _block_refuses(block: List[ast.stmt]) -> bool:
    """Does this branch bail out — return, raise, or continue?  The
    certificate shape is ``if x >= bound: return False``;
    clamp-and-fall-through is not a refusal."""
    for sub in block:
        for node in ast.walk(sub):
            if isinstance(node, (ast.Return, ast.Raise, ast.Continue)):
                return True
    return False


def refusal_guards(fn: ast.AST) -> Set[str]:
    """Identifiers protected by a *refusing* 2**61 guard anywhere in a
    function: an ``if`` against the bound whose overflow branch
    returns/raises, an assert, or a boolean ``return`` certificate.
    Shared with the twin-drift guard manifest so both checkers agree
    on what counts as a guard."""
    out: Set[str] = set()
    for node in ast.walk(fn):
        if isinstance(node, ast.If):
            true, false = _directional_guards(node.test)
            if _block_refuses(node.body):
                out |= false
            if node.orelse and _block_refuses(node.orelse):
                out |= true
        elif isinstance(node, ast.Assert):
            out |= _directional_guards(node.test)[0]
        elif isinstance(node, ast.Return) and node.value is not None:
            # A boolean certificate (`return now < 2**61 and not
            # np.any(valid & (tol >= 2**61))`) refuses by returning
            # False; masked/elementwise forms defeat the directional
            # analysis, so any bound comparison inside the returned
            # expression counts as the guard's presence.
            for sub in ast.walk(node.value):
                if isinstance(sub, ast.Compare) and any(
                    _is_bound(s) for s in [sub.left, *sub.comparators]
                ):
                    out |= {
                        n
                        for s in [sub.left, *sub.comparators]
                        if not _is_bound(s)
                        for n in names_in(s)
                        if n not in _BOUND_ALIASES
                    }
    return out


def _check_scope(
    mod: PyModule, body: List[ast.stmt], findings: List[Finding]
) -> None:
    """Scan one scope's statement tree in source order, threading the
    guard set and the plain-Python safety env through it.  Nested defs
    are skipped (they are their own scopes); class bodies share the
    enclosing scope's walk."""
    env = _SafetyEnv()
    guarded: Set[str] = set()

    def flag(op_str, lineno, node, *operands) -> None:
        """Shared core of the raw-op check: BinOp and AugAssign route
        here so the two spellings can never diverge in treatment."""
        idents: Set[str] = set()
        for operand in operands:
            idents |= _sensitive_idents(operand)
        if not idents:
            return
        if all(env.is_safe(o) for o in operands):
            return  # plain Python / f64 math: wrap-free
        unguarded = sorted(
            i for i in idents if i not in guarded and i not in env.safe
        )
        if not unguarded:
            return
        if CODE in pragma_codes(mod.lines, lineno):
            return
        findings.append(
            Finding(
                code=CODE,
                path=mod.rel,
                line=lineno,
                symbol=mod.qualname(node),
                message=(
                    f"raw i64 `{op_str}` on TAT/tolerance-domain "
                    f"value(s) {', '.join(unguarded)} without a "
                    "saturating helper (core/i64.py, tpu/sat.py) or "
                    "a dominating >= 2**61 refusal guard"
                ),
            )
        )

    def scan_expr(expr: ast.expr) -> None:
        for sub in ast.walk(expr):
            if isinstance(sub, ast.BinOp) and type(sub.op) in _RAW_OPS:
                flag(
                    _RAW_OPS[type(sub.op)], sub.lineno, sub,
                    sub.left, sub.right,
                )

    def walk_nested(block: List[ast.stmt], license_: Set[str]) -> None:
        """Walk a nested block with an extra branch license.  On exit,
        knowledge is intersected, not overwritten: guards/safety
        established INSIDE the block must not leak past it (the branch
        may never run), while revocations made inside it — a
        reassignment killing a license, a coercion undone — must
        persist (the branch may WELL have run)."""
        saved_guards = set(guarded)
        saved_safe = set(env.safe)
        guarded.update(license_)
        walk(block)
        guarded.intersection_update(saved_guards)
        env.safe.intersection_update(saved_safe)

    def walk(stmts: List[ast.stmt]) -> None:
        for stmt in stmts:
            if isinstance(stmt, _SCOPES):
                continue  # separate scope
            # Only a REFUSING guard dominates code after the
            # statement: an `if` against the bound whose OVERFLOW
            # branch returns/raises (the wire-certificate shape), or
            # an assert.  A telemetry-only comparison must not license
            # later arithmetic (the checker would miss the exact
            # fits_w32_wire wrap class otherwise).  Within the `if` itself, each
            # branch is licensed only for the identifiers its side of
            # the comparison actually bounds.
            if isinstance(stmt, ast.If):
                for expr in attached_exprs(stmt):
                    scan_expr(expr)
                true_side, false_side = _directional_guards(stmt.test)
                walk_nested(stmt.body, true_side)
                walk_nested(stmt.orelse, false_side)
                # The refusal license applies only to statements AFTER
                # the if — never to the overflow branch itself.
                if _block_refuses(stmt.body):
                    guarded.update(false_side)
                if stmt.orelse and _block_refuses(stmt.orelse):
                    guarded.update(true_side)
                continue
            if isinstance(stmt, ast.Assert):
                guarded.update(_directional_guards(stmt.test)[0])
            for expr in attached_exprs(stmt):
                scan_expr(expr)
            if isinstance(stmt, ast.AugAssign) and type(stmt.op) in _RAW_OPS:
                flag(
                    _RAW_OPS[type(stmt.op)] + "=", stmt.lineno, stmt,
                    stmt.target, stmt.value,
                )
            env.observe_assign(stmt)
            # Reassignment invalidates a refusal license: the new
            # value was never checked against the bound.  Loop targets
            # likewise revoke plain-Python safety (observe_assign only
            # sees Assign-family statements).
            guarded.difference_update(_assigned_names(stmt))
            if isinstance(stmt, ast.For):
                env.safe.difference_update(_assigned_names(stmt))
            for block in child_stmt_lists(stmt):
                walk_nested(block, set())

    walk(body)


def _check_module(mod: PyModule) -> List[Finding]:
    findings: List[Finding] = []
    _check_scope(mod, mod.tree.body, findings)
    for node in ast.walk(mod.tree):
        if isinstance(node, _SCOPES):
            _check_scope(mod, node.body, findings)
    return findings


def check(root) -> List[Finding]:
    root = Path(root)
    findings: List[Finding] = []
    for rel in HOT_PATHS:
        if not (root / rel).exists():
            continue
        findings.extend(_check_module(PyModule.load(root, rel)))
    return findings
