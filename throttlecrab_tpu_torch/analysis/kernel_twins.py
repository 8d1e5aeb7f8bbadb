"""Kernel-twin contract: the Python closed forms ↔ the CUDA lane body.

Every saturating closed form of the port exists twice: once in Python
on int64 tensors (``tpu/sat.py``, consumed by ``tpu/kernel.py``, the
plain version every kernel is held against) and once in C++ on native
64-bit integers (``csrc/gcra_lane.cuh``, compiled into the window
kernel).  This checker makes the relationship mechanical by normalizing
both sides into one small op-DAG IR (add/sub/mul/div/lt/eq/not/and/or/
sel/max/min over vars and constants) and enforcing a manifest:

  * STRUCTURAL pairs (``sat_add`` ↔ ``sat_add`` … ``div_trunc`` ↔
    ``div_trunc``, the same names on both sides) must normalize to the
    *identical* IR — an edit to one side's overflow predicate that is
    not mirrored is ``ktwin-drift``;
  * TRANSCRIBED bodies (``_request_outputs`` ↔ ``request_outputs``,
    ``_gcra_body`` ↔ ``decide_lane``) are too large for IR equality;
    instead every twin-mapped op kind the Python body uses must have
    its C++ counterpart referenced by the C++ body or the header
    functions it reaches (``ktwin-coverage``) — a new
    ``torch.minimum`` lane with no ``imin`` in the lane body cannot
    land silently.

Any other closed form that reaches the sat helpers must either join
the manifest or carry an explicit ``# twin: torch-only(reason)`` marker
on (or immediately above) its ``def`` line (``ktwin-unmarked``; an
empty reason is ``ktwin-marker``).  ``ktwin-missing`` marks an
unreadable anchor, a manifest name that vanished, or a body the
normalizer cannot reduce — extraction failure is loud, never a silent
pass.

The C++ side is read by a small expression parser that covers what the
header's closed forms use: declarations with initializers, ``if (c)
return x;`` chains, ``return``, the operators ``?: || && == != < <= >
>= + - * / ! -`` and calls.  The header's wrapping helpers map to IR
ops (``wadd``→add, ``wsub``→sub, ``wmul``→mul, ``imax``→max,
``imin``→min) and C's ``/`` is truncating division, the IR's ``div``.
Both sides then go through the same canonicalization, each rule exact:

  * ``&``/``&&`` and ``|``/``||`` chains flatten into sorted n-ary
    and/or (the operators commute);
  * ``x > y ? x : y`` and ``clamp(x, min=y)`` are ``max(x, y)``, and
    likewise ``min`` (max/min arguments sorted);
  * the overflow probe of a product: the Python reference's
    ``a > I64_MAX // max(b, 1)`` holds exactly when a > 0, b > 0 and
    the exact a·b exceeds I64_MAX; the header's ``a > 0 && b > 0 &&
    mul_exceeds_i64(a, b)`` says the same (``mul_exceeds_i64`` is the
    header's high-half test, defined for positive operands).  Both
    become ``mul_ovf(a, b)``, which implies ``a > 0`` and ``b > 0``:
    those conjuncts next to it are dropped;
  * ``x // y`` with x a non-negative constant and y ≥ 1 is ``div``
    (floor and truncation agree there).
"""

from __future__ import annotations

import ast
import re
from pathlib import Path
from typing import Dict, List, Optional, Set, Tuple

from .common import (
    CSRC,
    Finding,
    PyModule,
    cpp_function_range,
    names_in,
    strip_cpp_comments,
)

MISSING = "ktwin-missing"
DRIFT = "ktwin-drift"
COVERAGE = "ktwin-coverage"
UNMARKED = "ktwin-unmarked"
MARKER = "ktwin-marker"

SAT = "throttlecrab_tpu_torch/tpu/sat.py"
KERNEL = "throttlecrab_tpu_torch/tpu/kernel.py"
LANE = CSRC + "/gcra_lane.cuh"

#: Python closed form -> C++ twin that must normalize to the same IR.
STRUCTURAL_PAIRS = {
    "sat_add": "sat_add",
    "sat_sub": "sat_sub",
    "sat_add_nn": "sat_add_nn",
    "sat_sub_nn": "sat_sub_nn",
    "sat_mul_nonneg": "sat_mul_nonneg",
    "div_trunc": "div_trunc",
}

#: kernel.py decision bodies -> the C++ transcription that must cover
#: every twin-mapped op kind they use.
TRANSCRIBED = {
    "_request_outputs": "request_outputs",
    "_gcra_body": "decide_lane",
}

#: op name on the Python side -> required C++ counterpart token.
OP_TWINS = {
    "sat_add": "sat_add",
    "sat_sub": "sat_sub",
    "sat_add_nn": "sat_add_nn",
    "sat_sub_nn": "sat_sub_nn",
    "sat_mul_nonneg": "sat_mul_nonneg",
    "div_trunc": "div_trunc",
    "where": "?",
    "maximum": "imax",
    "minimum": "imin",
    "clamp": "imax",
}

_MARKER = re.compile(r"#\s*twin:\s*torch-only\(([^)]*)\)")

I64_MAX = (1 << 63) - 1
I64_MIN = -(1 << 63)

#: constant names both sides may reference.
_CONSTS = {"I64_MAX": I64_MAX, "I64_MIN": I64_MIN}

#: Python call name -> IR op for twin-mapped intrinsics.
_PY_CALL_OPS = {"where": "sel", "maximum": "max", "minimum": "min"}

#: C++ call name -> IR op: the header's wrapping helpers.
_CPP_CALL_OPS = {
    "wadd": "add",
    "wsub": "sub",
    "wmul": "mul",
    "imax": "max",
    "imin": "min",
    "mul_exceeds_i64": "mul_hi",
}


class _Unnormalizable(Exception):
    pass


# ----------------------------------------------------------------- #
# Canonical form (both sides)


def _canon(ir: tuple) -> tuple:
    """Bottom-up canonicalization (the exact rules in the module
    docstring)."""
    if ir[0] in ("var", "const"):
        return ir
    op, args = ir[0], [_canon(a) for a in ir[1:]]
    if op in ("and", "or"):
        flat: List[tuple] = []
        for a in args:
            flat.extend(a[1:] if a[0] == op else [a])
        if op == "and":
            flat = _mul_lemma(flat)
        flat = sorted(set(flat), key=repr)
        return flat[0] if len(flat) == 1 else (op, *flat)
    if op in ("max", "min"):
        return (op, *sorted(args, key=repr))
    if op == "sel":
        c, x, y = args
        if c[0] == "lt" and {c[1], c[2]} == {x, y}:
            # x > y ? x : y -> max; x < y ? x : y -> min
            return ("max" if c[1] == y else "min", *sorted((x, y), key=repr))
        if c[0] == "not" and c[1][0] == "lt" and {c[1][1], c[1][2]} == {x, y}:
            return ("max" if c[1][1] == x else "min", *sorted((x, y), key=repr))
    if op == "fdiv":
        x, y = args
        if (
            x[0] == "const"
            and x[1] >= 0
            and y[0] == "max"
            and any(a[0] == "const" and a[1] >= 1 for a in y[1:])
        ):
            op = "div"
    if op == "lt":
        x, y = args
        # a > I64_MAX // max(b, 1): the exact product overflow probe.
        if (
            x[0] == "div"
            and x[1] == ("const", I64_MAX)
            and x[2][0] == "max"
            and ("const", 1) in x[2][1:]
            and len(x[2]) == 3
        ):
            b = next(a for a in x[2][1:] if a != ("const", 1))
            return ("mul_ovf", y, b)
    return (op, *args)


def _mul_lemma(conj: List[tuple]) -> List[tuple]:
    """a > 0 && b > 0 && mul_hi(a, b) is mul_ovf(a, b); mul_ovf(a, b)
    implies a > 0 and b > 0."""
    out = list(conj)
    for c in conj:
        if c[0] == "mul_hi":
            a, b = c[1], c[2]
            pos = {("lt", ("const", 0), a), ("lt", ("const", 0), b)}
            if pos <= set(out):
                out = [x for x in out if x != c and x not in pos]
                out.append(("mul_ovf", a, b))
    for c in list(out):
        if c[0] == "mul_ovf":
            implied = {("lt", ("const", 0), c[1]), ("lt", ("const", 0), c[2])}
            out = [x for x in out if x not in implied]
    return out


# ----------------------------------------------------------------- #
# Python side


def _callee(node: ast.Call) -> str:
    f = node.func
    if isinstance(f, ast.Name):
        return f.id
    if isinstance(f, ast.Attribute):
        return f.attr
    return ""


def _kwargs(node: ast.Call) -> Dict[str, ast.expr]:
    return {k.arg: k.value for k in node.keywords if k.arg is not None}


def _norm(node: ast.AST, env: Dict[str, tuple]) -> tuple:
    """Normalize one Python expression into the op-DAG IR."""
    if isinstance(node, ast.Name):
        if node.id in env:
            return env[node.id]
        if node.id in _CONSTS:
            return ("const", _CONSTS[node.id])
        raise _Unnormalizable(f"free name {node.id}")
    if isinstance(node, ast.Constant):
        if isinstance(node.value, bool) or not isinstance(node.value, int):
            raise _Unnormalizable(f"constant {node.value!r}")
        return ("const", node.value)
    if isinstance(node, ast.BinOp):
        ops = {
            ast.Add: "add", ast.Sub: "sub", ast.Mult: "mul",
            ast.FloorDiv: "fdiv", ast.BitAnd: "and", ast.BitOr: "or",
        }
        op = ops.get(type(node.op))
        if op is None:
            raise _Unnormalizable(type(node.op).__name__)
        return (op, _norm(node.left, env), _norm(node.right, env))
    if isinstance(node, ast.UnaryOp):
        if isinstance(node.op, ast.Invert):
            return ("not", _norm(node.operand, env))
        if isinstance(node.op, ast.USub):
            inner = _norm(node.operand, env)
            if inner[0] == "const":
                return ("const", -inner[1])
        raise _Unnormalizable(type(node.op).__name__)
    if isinstance(node, ast.Compare):
        if len(node.ops) != 1:
            raise _Unnormalizable("chained compare")
        return _compare(
            type(node.ops[0]).__name__,
            _norm(node.left, env),
            _norm(node.comparators[0], env),
        )
    if isinstance(node, ast.Call):
        name = _callee(node)
        kw = _kwargs(node)
        args = [_norm(a, env) for a in node.args]
        if name == "clamp" and len(args) == 1 and set(kw) <= {"min", "max"}:
            out = args[0]
            if "min" in kw:
                out = ("max", out, _norm(kw["min"], env))
            if "max" in kw:
                out = ("min", out, _norm(kw["max"], env))
            return out
        if name == "div" and len(args) == 2:
            mode = kw.get("rounding_mode")
            if mode is None and not kw:  # lax.div: C semantics
                return ("div", *args)
            if isinstance(mode, ast.Constant) and mode.value == "trunc":
                return ("div", *args)
            raise _Unnormalizable("div without truncation")
        if name == "full_like" and len(args) == 2 and not kw:
            return args[1]
        op = _PY_CALL_OPS.get(name)
        if op is None or kw:
            raise _Unnormalizable(f"call {name}")
        return (op, *args)
    raise _Unnormalizable(type(node).__name__)


def _compare(kind: str, a: tuple, b: tuple) -> tuple:
    """Canonical compares: everything becomes lt / not(lt) / eq."""
    if kind == "Lt":
        return ("lt", a, b)
    if kind == "Gt":
        return ("lt", b, a)
    if kind == "GtE":
        return ("not", ("lt", a, b))
    if kind == "LtE":
        return ("not", ("lt", b, a))
    if kind == "Eq":
        return ("eq", a, b)
    if kind == "NotEq":
        return ("not", ("eq", a, b))
    raise _Unnormalizable(kind)


def _normalize_function(fn: ast.FunctionDef) -> tuple:
    """Symbolically evaluate a straight-line closed form to its return IR."""
    env: Dict[str, tuple] = {
        a.arg: ("var", i) for i, a in enumerate(fn.args.args)
    }
    body = fn.body
    if (
        body
        and isinstance(body[0], ast.Expr)
        and isinstance(body[0].value, ast.Constant)
        and isinstance(body[0].value.value, str)
    ):
        body = body[1:]  # docstring
    for stmt in body:
        if isinstance(stmt, ast.Assign):
            if len(stmt.targets) == 1 and isinstance(
                stmt.targets[0], ast.Name
            ):
                env[stmt.targets[0].id] = _norm(stmt.value, env)
                continue
            raise _Unnormalizable("non-scalar assignment")
        if isinstance(stmt, ast.Return) and stmt.value is not None:
            return _canon(_norm(stmt.value, env))
        raise _Unnormalizable(type(stmt).__name__)
    raise _Unnormalizable("no return")


# ----------------------------------------------------------------- #
# C++ side


_TOKEN = re.compile(
    r"\s*(?:(\d+)(?:[uU]?[lL]{0,2})\b|([A-Za-z_]\w*(?:::\w+)*)"
    r"|(\|\||&&|==|!=|<=|>=|[-+*/<>!?:(),;=&|~{}]))"
)


def _tokens(text: str) -> List[Tuple[str, str]]:
    """(kind, text) tokens: kind is num / name / op."""
    out: List[Tuple[str, str]] = []
    pos = 0
    text = text.rstrip()
    while pos < len(text):
        m = _TOKEN.match(text, pos)
        if m is None or m.end() == pos:
            raise _Unnormalizable(f"token at {text[pos:pos + 20]!r}")
        pos = m.end()
        if m.group(1) is not None:
            out.append(("num", m.group(1)))
        elif m.group(2) is not None:
            out.append(("name", m.group(2)))
        else:
            out.append(("op", m.group(3)))
    return out


#: binary operator -> (precedence, IR builder)
_BINARY = {
    "||": (1, lambda a, b: ("or", a, b)),
    "&&": (2, lambda a, b: ("and", a, b)),
    "==": (3, lambda a, b: _compare("Eq", a, b)),
    "!=": (3, lambda a, b: _compare("NotEq", a, b)),
    "<": (4, lambda a, b: _compare("Lt", a, b)),
    "<=": (4, lambda a, b: _compare("LtE", a, b)),
    ">": (4, lambda a, b: _compare("Gt", a, b)),
    ">=": (4, lambda a, b: _compare("GtE", a, b)),
    "+": (5, lambda a, b: ("add", a, b)),
    "-": (5, lambda a, b: ("sub", a, b)),
    "*": (6, lambda a, b: ("mul", a, b)),
    "/": (6, lambda a, b: ("div", a, b)),
}

_TYPES = {"int64_t", "int32_t", "bool", "int", "uint64_t", "auto"}


class _CppExpr:
    """Precedence-climbing parser over one token list."""

    def __init__(self, toks: List[Tuple[str, str]], env: Dict[str, tuple]):
        self.toks, self.i, self.env = toks, 0, env

    def peek(self) -> Optional[Tuple[str, str]]:
        return self.toks[self.i] if self.i < len(self.toks) else None

    def take(self, want: Optional[str] = None) -> Tuple[str, str]:
        tok = self.peek()
        if tok is None or (want is not None and tok[1] != want):
            raise _Unnormalizable(f"expected {want!r}, got {tok!r}")
        self.i += 1
        return tok

    def parse(self) -> tuple:
        out = self.ternary()
        if self.peek() is not None:
            raise _Unnormalizable(f"trailing {self.peek()!r}")
        return out

    def ternary(self) -> tuple:
        cond = self.binary(1)
        if self.peek() == ("op", "?"):
            self.take("?")
            x = self.ternary()
            self.take(":")
            y = self.ternary()
            return ("sel", cond, x, y)
        return cond

    def binary(self, min_prec: int) -> tuple:
        left = self.unary()
        while True:
            tok = self.peek()
            if tok is None or tok[0] != "op" or tok[1] not in _BINARY:
                return left
            prec, build = _BINARY[tok[1]]
            if prec < min_prec:
                return left
            self.take()
            left = build(left, self.binary(prec + 1))

    def unary(self) -> tuple:
        tok = self.take()
        if tok == ("op", "!"):
            return ("not", self.unary())
        if tok == ("op", "-"):
            inner = self.unary()
            if inner[0] == "const":
                return ("const", -inner[1])
            raise _Unnormalizable("unary minus")
        if tok == ("op", "("):
            inner = self.ternary()
            self.take(")")
            return inner
        if tok[0] == "num":
            return ("const", int(tok[1]))
        if tok[0] == "name":
            name = tok[1]
            if self.peek() == ("op", "("):
                self.take("(")
                args: List[tuple] = []
                while self.peek() != ("op", ")"):
                    args.append(self.ternary())
                    if self.peek() == ("op", ","):
                        self.take(",")
                self.take(")")
                op = _CPP_CALL_OPS.get(name)
                if op is None:
                    raise _Unnormalizable(f"call {name}")
                return (op, *args)
            if name in self.env:
                return self.env[name]
            if name in _CONSTS:
                return ("const", _CONSTS[name])
            raise _Unnormalizable(f"free name {name}")
        raise _Unnormalizable(f"token {tok!r}")


def _split_statements(toks: List[Tuple[str, str]]) -> List[List[Tuple[str, str]]]:
    """Top-level statements of a brace body, split on ``;`` at paren
    depth 0 (a nested ``{`` block is unnormalizable)."""
    stmts: List[List[Tuple[str, str]]] = []
    cur: List[Tuple[str, str]] = []
    depth = 0
    for tok in toks:
        if tok in (("op", "{"), ("op", "}")):
            raise _Unnormalizable("nested block")
        if tok == ("op", "("):
            depth += 1
        elif tok == ("op", ")"):
            depth -= 1
        if tok == ("op", ";") and depth == 0:
            stmts.append(cur)
            cur = []
        else:
            cur.append(tok)
    if cur:
        raise _Unnormalizable("unterminated statement")
    return stmts


def _cpp_params(sig: str) -> List[str]:
    inner = sig[sig.index("(") + 1 : sig.rindex(")")]
    out = []
    for part in inner.split(","):
        words = re.findall(r"[A-Za-z_]\w*", part)
        if not words:
            raise _Unnormalizable("parameter list")
        out.append(words[-1])
    return out


def normalize_cpp_function(span: str) -> tuple:
    """Symbolically evaluate one header closed form to its return IR:
    declarations with initializers, ``if (c) return x;`` chains and a
    final ``return``."""
    if "#" in span:
        raise _Unnormalizable("preprocessor branch")
    brace = span.index("{")
    params = _cpp_params(span[:brace])
    env: Dict[str, tuple] = {p: ("var", i) for i, p in enumerate(params)}
    guards: List[Tuple[tuple, tuple]] = []
    for stmt in _split_statements(_tokens(span[brace + 1 : span.rindex("}")])):
        if stmt[:1] == [("name", "return")]:
            out = _CppExpr(stmt[1:], env).parse()
            for cond, val in reversed(guards):
                out = ("sel", cond, val, out)
            return _canon(out)
        if stmt[:2] == [("name", "if"), ("op", "(")]:
            depth, j = 0, 1
            for j in range(1, len(stmt)):
                if stmt[j] == ("op", "("):
                    depth += 1
                elif stmt[j] == ("op", ")"):
                    depth -= 1
                    if depth == 0:
                        break
            if stmt[j + 1 : j + 2] != [("name", "return")]:
                raise _Unnormalizable("if without return")
            cond = _CppExpr(stmt[2:j], env).parse()
            guards.append((cond, _CppExpr(stmt[j + 2 :], env).parse()))
            continue
        words = stmt
        while words and words[0][1] in ("const", "constexpr"):
            words = words[1:]
        if (
            len(words) >= 4
            and words[0][1] in _TYPES
            and words[1][0] == "name"
            and words[2] == ("op", "=")
        ):
            env[words[1][1]] = _CppExpr(words[3:], env).parse()
            continue
        raise _Unnormalizable(f"statement {' '.join(t for _, t in stmt)}")
    raise _Unnormalizable("no return")


def _cpp_functions(text: str) -> Dict[str, Tuple[int, int]]:
    """name -> (start, end) of every function or struct defined in the
    header (first definition of each name)."""
    out: Dict[str, Tuple[int, int]] = {}
    for m in re.finditer(r"\b([A-Za-z_]\w*)\s*\(", text):
        name = m.group(1)
        if name in out or name in ("if", "for", "while", "return", "sizeof"):
            continue
        span = cpp_function_range(text, name)
        if span is not None and span[0] == m.start():
            out[name] = span
    for m in re.finditer(r"\bstruct\s+(\w+)\s*(?:<[^>{;]*>)?\s*\{", text):
        name = m.group(1)
        depth = 0
        for j in range(m.end() - 1, len(text)):
            if text[j] == "{":
                depth += 1
            elif text[j] == "}":
                depth -= 1
                if depth == 0:
                    prev = out.get(name)
                    # every specialization of a struct counts as its body
                    out[name] = (m.start(), j + 1) if prev is None else (
                        min(prev[0], m.start()), max(prev[1], j + 1)
                    )
                    break
    return out


def _reach_tokens(text: str, fns: Dict[str, Tuple[int, int]], start: str) -> Set[str]:
    """Identifier and ``?`` tokens of a header function and of every
    header function or struct it reaches by name."""
    seen: Set[str] = set()
    toks: Set[str] = set()
    stack = [start]
    while stack:
        name = stack.pop()
        if name in seen or name not in fns:
            continue
        seen.add(name)
        a, b = fns[name]
        body = text[a:b]
        words = set(re.findall(r"[A-Za-z_]\w*", body))
        if "?" in body:
            words.add("?")
        toks |= words
        stack.extend(words & set(fns))
    return toks


# ----------------------------------------------------------------- #


def _load(root: Path, rel: str, findings: List[Finding]) -> Optional[PyModule]:
    try:
        return PyModule.load(root, rel)
    except (OSError, SyntaxError):
        findings.append(Finding(MISSING, rel, 1, "anchor file unreadable"))
        return None


def _top_functions(mod: PyModule) -> Dict[str, ast.FunctionDef]:
    return {
        s.name: s
        for s in mod.tree.body
        if isinstance(s, ast.FunctionDef)
    }


def _marker_reason(
    mod: PyModule, fn: ast.FunctionDef
) -> Optional[Tuple[str, int]]:
    """(reason, line) of a def-adjacent ``# twin: torch-only(...)``."""
    for lineno in (fn.lineno, fn.lineno - 1):
        if 1 <= lineno <= len(mod.lines):
            m = _MARKER.search(mod.lines[lineno - 1])
            if m:
                return m.group(1), lineno
    return None


def check(root) -> List[Finding]:
    root = Path(root)
    findings: List[Finding] = []
    sat = _load(root, SAT, findings)
    kernel = _load(root, KERNEL, findings)
    lane_path = root / LANE
    if not lane_path.exists():
        findings.append(Finding(MISSING, LANE, 1, "anchor file unreadable"))
        return findings
    if sat is None:
        return findings
    raw = lane_path.read_text()
    text = strip_cpp_comments(raw)
    cpp_fns = _cpp_functions(text)

    sat_fns = _top_functions(sat)
    kernel_fns = _top_functions(kernel) if kernel is not None else {}

    def cpp_line(name: str) -> int:
        return text.count("\n", 0, cpp_fns[name][0]) + 1

    def require_py(name: str, twin: str) -> Optional[ast.FunctionDef]:
        fn = sat_fns.get(name)
        if fn is None:
            findings.append(
                Finding(
                    MISSING, SAT, 1,
                    f"manifest function {name} not found (twin of {twin})",
                    symbol=name,
                )
            )
        return fn

    def require_cpp(name: str, twin: str) -> bool:
        if name not in cpp_fns:
            findings.append(
                Finding(
                    MISSING, LANE, 1,
                    f"manifest function {name} not found (twin of {twin})",
                    symbol=name,
                )
            )
            return False
        return True

    # ---- structural pairs: identical op-DAG IR -------------------- #
    for py_name, cpp_name in sorted(STRUCTURAL_PAIRS.items()):
        pf = require_py(py_name, f"{LANE}:{cpp_name}")
        has_cpp = require_cpp(cpp_name, f"{SAT}:{py_name}")
        if pf is None or not has_cpp:
            continue
        irs: Dict[str, tuple] = {}
        try:
            irs[SAT] = _normalize_function(pf)
        except _Unnormalizable as e:
            findings.append(
                Finding(
                    MISSING, SAT, pf.lineno,
                    f"{py_name} not normalizable to the twin IR ({e})",
                    symbol=py_name,
                )
            )
        a, b = cpp_fns[cpp_name]
        try:
            irs[LANE] = normalize_cpp_function(text[a:b])
        except _Unnormalizable as e:
            findings.append(
                Finding(
                    MISSING, LANE, cpp_line(cpp_name),
                    f"{cpp_name} not normalizable to the twin IR ({e})",
                    symbol=cpp_name,
                )
            )
        if len(irs) == 2 and irs[SAT] != irs[LANE]:
            findings.append(
                Finding(
                    DRIFT, LANE, cpp_line(cpp_name),
                    f"{cpp_name} IR diverges from its Python twin "
                    f"{py_name} — the saturation predicates no longer "
                    "match",
                    symbol=cpp_name,
                )
            )

    # ---- transcribed bodies: op-kind coverage --------------------- #
    for py_name, cpp_name in sorted(TRANSCRIBED.items()):
        xf = kernel_fns.get(py_name)
        if xf is None:
            if kernel is not None:
                findings.append(
                    Finding(
                        MISSING, KERNEL, 1,
                        f"manifest function {py_name} not found "
                        f"(transcribed into {cpp_name})",
                        symbol=py_name,
                    )
                )
            continue
        if not require_cpp(cpp_name, f"{KERNEL}:{py_name}"):
            continue
        used = names_in(xf)
        have = _reach_tokens(text, cpp_fns, cpp_name)
        for op in sorted(used & set(OP_TWINS)):
            twin = OP_TWINS[op]
            if twin not in have:
                findings.append(
                    Finding(
                        COVERAGE, LANE, cpp_line(cpp_name),
                        f"{py_name} uses {op} but {cpp_name} (and the "
                        f"header code it reaches) never references its "
                        f"C++ twin {twin}",
                        symbol=cpp_name,
                    )
                )

    # ---- every other sat-reaching closed form is marked ----------- #
    manifest = set(STRUCTURAL_PAIRS) | set(TRANSCRIBED)
    sat_helper_names = set(sat_fns)
    scope: List[Tuple[PyModule, ast.FunctionDef]] = [
        (sat, fn) for fn in sat_fns.values()
    ]
    if kernel is not None:
        scope += [
            (kernel, fn)
            for fn in kernel_fns.values()
            if names_in(fn) & sat_helper_names
        ]
    for mod, fn in scope:
        if fn.name in manifest:
            continue
        marker = _marker_reason(mod, fn)
        if marker is None:
            findings.append(
                Finding(
                    UNMARKED, mod.rel, fn.lineno,
                    f"{fn.name} reaches the sat closed forms but has "
                    f"no C++ twin in the manifest and no "
                    f"'# twin: torch-only(reason)' marker",
                    symbol=fn.name,
                )
            )
        elif not marker[0].strip():
            findings.append(
                Finding(
                    MARKER, mod.rel, marker[1],
                    f"{fn.name}: torch-only marker has an empty reason",
                    symbol=fn.name,
                )
            )
    return findings
