"""Shared plumbing for the port's invariant checkers.

Findings, the baseline waiver file, inline pragmas, the small AST
utilities (constant folding, source caching) every checker uses, and
the C++ token helpers (comment stripping, ``constexpr`` extraction,
function spans) that the checkers reading ``csrc/`` and ``native/``
share.  Pure stdlib — the analysis must run without torch/numpy
installed, so the baseline TOML is read by a minimal purpose-built
parser instead of tomllib (absent on 3.10) or tomli (a third-party
wheel).
"""

from __future__ import annotations

import ast
import re
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

#: The package under analysis, and this suite's own directory (skipped
#: by every tree walk).
PACKAGE = "throttlecrab_tpu_torch"
ANALYSIS_DIR = PACKAGE + "/analysis/"
CSRC = PACKAGE + "/csrc"

# ----------------------------------------------------------------- #
# Findings


@dataclass(frozen=True)
class Finding:
    """One checker hit, machine-readable.

    ``path`` is repo-relative POSIX; ``symbol`` is the enclosing
    function/class qualname chain (empty at module level).
    """

    code: str
    path: str
    line: int
    message: str
    symbol: str = ""

    def format(self) -> str:
        sym = f" [{self.symbol}]" if self.symbol else ""
        return f"{self.path}:{self.line}: {self.code}{sym} {self.message}"


# ----------------------------------------------------------------- #
# Baseline waivers


@dataclass(frozen=True)
class Waiver:
    """One audited exception from baseline.toml.

    Matches a finding when codes and paths are equal, the symbol (when
    given) equals the finding's symbol or its trailing component, and
    the line (when given) equals the finding's line.  ``count`` (when
    nonzero) pins the EXACT number of findings the waiver may absorb:
    new, unaudited arithmetic inside a waived function then changes
    the count and fails strict mode instead of riding the old audit.
    """

    code: str
    path: str
    symbol: str = ""
    line: int = 0
    count: int = 0
    reason: str = ""

    def matches(self, f: Finding) -> bool:
        if self.code != f.code or self.path != f.path:
            return False
        if self.symbol and not (
            self.symbol == f.symbol
            or f.symbol.endswith("." + self.symbol)
        ):
            return False
        if self.line and self.line != f.line:
            return False
        return True


_TOML_STR = re.compile(r'^(\w+)\s*=\s*"((?:[^"\\]|\\.)*)"\s*$')
_TOML_INT = re.compile(r"^(\w+)\s*=\s*(\d+)\s*$")
_TOML_TABLE = re.compile(r"^\[\[(\w+)\]\]$")


def parse_tables(
    text: str, file_label: str = "baseline.toml"
) -> Dict[str, List[Dict[str, object]]]:
    """Parse the analysis TOML subset shared by ``baseline.toml`` and
    ``lockorder.toml``: comments, blank lines, and ``[[name]]`` array
    tables of string/int scalar keys.  Returns ``{table_name: [entry
    dicts, ...]}``; each entry carries its table's source line under
    the reserved ``_line`` key (error messages point at the right
    table).  Anything else is a hard error — these files are part of
    the invariant surface, not a place for silent typos."""
    out: Dict[str, List[Dict[str, object]]] = {}
    current: Optional[Dict[str, object]] = None
    for n, raw in enumerate(text.splitlines(), 1):
        line = raw.strip()
        if not line or line.startswith("#"):
            continue
        table = _TOML_TABLE.match(line)
        if table is not None:
            current = {"_line": n}
            out.setdefault(table.group(1), []).append(current)
            continue
        m = _TOML_STR.match(line)
        if m is None:
            m = _TOML_INT.match(line)
            if m is None:
                raise ValueError(
                    f"{file_label}:{n}: unsupported syntax: {raw!r}"
                )
            key, value = m.group(1), int(m.group(2))
        else:
            key, value = m.group(1), _unescape(m.group(2))
        if current is None:
            raise ValueError(
                f"{file_label}:{n}: key outside a [[...]] table"
            )
        current[key] = value
    return out


def parse_baseline(text: str) -> List[Waiver]:
    """Parse the baseline's TOML subset (``[[waiver]]`` tables of
    string/int scalars) into Waiver records."""
    tables = parse_tables(text, "baseline.toml")
    unknown = set(tables) - {"waiver"}
    if unknown:
        raise ValueError(
            f"baseline.toml: unknown table(s) {sorted(unknown)}"
        )
    return [
        _build_waiver(entry, int(entry.pop("_line", 0)))  # type: ignore[arg-type]
        for entry in tables.get("waiver", [])
    ]


def _unescape(s: str) -> str:
    return s.replace('\\"', '"').replace("\\\\", "\\")


def _build_waiver(d: Dict[str, object], line_no: int) -> Waiver:
    allowed = {"code", "path", "symbol", "line", "count", "reason"}
    unknown = set(d) - allowed
    if unknown:
        raise ValueError(
            f"baseline.toml: unknown waiver keys {sorted(unknown)}"
        )
    for req in ("code", "path", "reason"):
        if not d.get(req):
            raise ValueError(
                f"baseline.toml: waiver near line {line_no} missing "
                f"required key {req!r}"
            )
    return Waiver(
        code=str(d["code"]),
        path=str(d["path"]),
        symbol=str(d.get("symbol", "")),
        line=int(d.get("line", 0)),  # type: ignore[arg-type]
        count=int(d.get("count", 0)),  # type: ignore[arg-type]
        reason=str(d["reason"]),
    )


def load_baseline(path) -> List[Waiver]:
    path = Path(path)
    if not path.exists():
        return []
    return parse_baseline(path.read_text())


def apply_baseline(
    findings: Sequence[Finding], waivers: Sequence[Waiver]
) -> Tuple[List[Finding], List[Waiver]]:
    """Split findings into (unwaived, violated_waivers).

    A waiver that matches no current finding is *stale*, and a waiver
    whose ``count`` is pinned but absorbs a different number of
    findings has been outgrown by unaudited code — either way the
    entry is returned as violated, keeping the baseline a ratchet
    rather than a landfill.
    """
    matched = [0] * len(waivers)
    unwaived: List[Finding] = []
    for f in findings:
        waived = False
        for i, w in enumerate(waivers):
            if w.matches(f):
                matched[i] += 1
                waived = True
        if not waived:
            unwaived.append(f)
    violated = [
        w
        for i, w in enumerate(waivers)
        if matched[i] == 0 or (w.count and matched[i] != w.count)
    ]
    return unwaived, violated


# ----------------------------------------------------------------- #
# Inline pragmas

_PRAGMA = re.compile(r"inv:\s*allow\(([a-z0-9_,\s-]+)\)")


def pragma_codes(source_lines: Sequence[str], lineno: int) -> Set[str]:
    """Codes allowed by an ``# inv: allow(code[, code])`` pragma on the
    given 1-based source line."""
    if not 1 <= lineno <= len(source_lines):
        return set()
    m = _PRAGMA.search(source_lines[lineno - 1])
    if m is None:
        return set()
    return {c.strip() for c in m.group(1).split(",") if c.strip()}


# ----------------------------------------------------------------- #
# Source / AST helpers


@dataclass
class PyModule:
    path: Path
    rel: str
    source: str
    lines: List[str]
    tree: ast.Module
    _parents: Dict[int, ast.AST] = field(default_factory=dict)

    @classmethod
    def load(cls, root: Path, rel: str) -> "PyModule":
        path = Path(root) / rel
        source = path.read_text()
        return cls(
            path=path,
            rel=rel,
            source=source,
            lines=source.splitlines(),
            tree=ast.parse(source, filename=str(path)),
        )

    def qualname(self, node: ast.AST) -> str:
        """Enclosing def/class chain of a node ("Cls.method" style)."""
        if not self._parents:
            for parent in ast.walk(self.tree):
                for child in ast.iter_child_nodes(parent):
                    self._parents[id(child)] = parent
        parts: List[str] = []
        cur: Optional[ast.AST] = node
        while cur is not None:
            if isinstance(
                cur,
                (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef),
            ):
                parts.append(cur.name)
            cur = self._parents.get(id(cur))
        return ".".join(reversed(parts))


def iter_py_files(root: Path, rel_dir: str) -> Iterable[str]:
    """Repo-relative POSIX paths of .py files under rel_dir, skipping
    caches, generated protobuf stubs, build outputs, and this analysis
    package (whose own fixture-like literals must not feed the
    checkers)."""
    base = Path(root) / rel_dir
    for p in sorted(base.rglob("*.py")):
        rel = p.relative_to(root).as_posix()
        if "__pycache__" in rel or rel.endswith("_pb2.py"):
            continue
        if rel.endswith("_pb2_grpc.py"):
            continue
        if rel.startswith(ANALYSIS_DIR):
            continue
        yield rel


def fold_int(node: ast.AST) -> Optional[int]:
    """Evaluate a constant integer expression (literals combined with
    ``+ - * ** <<``, unary ``-``, and ``int()``/``float()`` coercions
    of the same); None when not statically constant."""
    if (
        isinstance(node, ast.Call)
        and isinstance(node.func, ast.Name)
        and node.func.id in ("int", "float")
        and len(node.args) == 1
        and not node.keywords
    ):
        return fold_int(node.args[0])
    if isinstance(node, ast.Constant) and isinstance(node.value, int):
        # bool is an int subclass; reject it — True << 61 is not a bound.
        if isinstance(node.value, bool):
            return None
        return node.value
    if isinstance(node, ast.UnaryOp) and isinstance(node.op, ast.USub):
        v = fold_int(node.operand)
        return None if v is None else -v
    if isinstance(node, ast.BinOp):
        left, right = fold_int(node.left), fold_int(node.right)
        if left is None or right is None:
            return None
        if isinstance(node.op, ast.LShift):
            return left << right
        if isinstance(node.op, ast.Add):
            return left + right
        if isinstance(node.op, ast.Sub):
            return left - right
        if isinstance(node.op, ast.Mult):
            return left * right
        if isinstance(node.op, ast.Pow):
            return left**right
    return None


def attached_exprs(stmt: ast.stmt) -> Iterable[ast.expr]:
    """Expressions directly attached to a statement (its tests, values,
    targets, decorators…) — child *statements* and nested scopes are
    excluded so every expression is visited exactly once, in source
    order, by a statement-tree walk."""
    for _, value in ast.iter_fields(stmt):
        if isinstance(value, ast.expr):
            yield value
        elif isinstance(value, list):
            for item in value:
                if isinstance(item, ast.expr):
                    yield item
                elif isinstance(item, ast.withitem):
                    yield item.context_expr
                    if item.optional_vars is not None:
                        yield item.optional_vars
                elif isinstance(item, ast.keyword):
                    yield item.value
                elif isinstance(item, ast.match_case):
                    if item.guard is not None:
                        yield item.guard


def child_stmt_lists(stmt: ast.stmt) -> Iterable[List[ast.stmt]]:
    """The statement blocks nested directly under a compound statement."""
    for field in ("body", "orelse", "finalbody"):
        block = getattr(stmt, field, None)
        if block and isinstance(block[0], ast.stmt):
            yield block
    for handler in getattr(stmt, "handlers", []) or []:
        yield handler.body
    for case in getattr(stmt, "cases", []) or []:
        yield case.body


def names_in(node: ast.AST) -> Set[str]:
    """Every Name identifier and Attribute terminal in an expression."""
    out: Set[str] = set()
    for sub in ast.walk(node):
        if isinstance(sub, ast.Name):
            out.add(sub.id)
        elif isinstance(sub, ast.Attribute):
            out.add(sub.attr)
    return out


def dotted_name(node: ast.AST) -> Optional[str]:
    """'a.b.c' for a Name/Attribute chain, else None."""
    if isinstance(node, ast.Name):
        return node.id
    if isinstance(node, ast.Attribute):
        base = dotted_name(node.value)
        return None if base is None else f"{base}.{node.attr}"
    return None


# ----------------------------------------------------------------- #
# C++ helpers (token scans, not a parser)

_CPP_CONSTEXPR = re.compile(
    r"constexpr\s+(?:[A-Za-z_][\w:]*\s+)+?(\w+)\s*=\s*([^;]+);"
)


def strip_cpp_comments(text: str) -> str:
    """The source with ``/* */`` and ``//`` comments blanked; newlines
    inside block comments are kept so line numbers survive."""
    text = re.sub(
        r"/\*.*?\*/", lambda m: "\n" * m.group(0).count("\n") or " ",
        text, flags=re.S,
    )
    return re.sub(r"//[^\n]*", "", text)


def join_adjacent_strings(text: str) -> str:
    """Collapse C++ adjacent string-literal concatenation ("a" "b",
    possibly across lines) so message substrings can be searched."""
    return re.sub(r'"\s*\n\s*"', "", text)


def eval_cpp_int(expr: str) -> Optional[int]:
    """Evaluate a simple C++ integer constant expression: literals with
    LL/ULL suffixes, ``*`` products, ``<<`` shifts, ``int64_t(1)``
    style casts, parentheses, and the ``<stdint.h>`` extremes."""
    expr = expr.strip()
    expr = {
        "INT64_MAX": str((1 << 63) - 1),
        "INT64_MIN": str(-(1 << 63)),
        "INT32_MAX": str((1 << 31) - 1),
    }.get(expr, expr)
    expr = re.sub(r"(?<=\d)[uU]?[lL]{1,2}\b", "", expr)
    expr = re.sub(r"\b(?:int64_t|uint64_t|int32_t|size_t)\s*\(", "(", expr)
    expr = re.sub(r"'\s*", "", expr)  # digit separators
    if not re.fullmatch(r"[\d\s()*+<-]+", expr):
        return None
    try:
        tree = ast.parse(expr, mode="eval")
    except SyntaxError:
        return None
    return fold_int(tree.body)


def cpp_consts(text: str) -> Dict[str, int]:
    """Every ``constexpr <type> NAME = <int expr>;`` of a comment-free
    C++ source, folded."""
    out: Dict[str, int] = {}
    for m in _CPP_CONSTEXPR.finditer(text):
        v = eval_cpp_int(m.group(2))
        if v is not None:
            out[m.group(1)] = v
    return out


def cpp_const_lines(text: str) -> Dict[str, int]:
    """1-based line of each ``constexpr`` definition."""
    return {
        m.group(1): text.count("\n", 0, m.start()) + 1
        for m in _CPP_CONSTEXPR.finditer(text)
    }


def cpp_function_span(text: str, name: str) -> Optional[str]:
    """Source text of one function body, by brace matching from the
    first ``name(...)  {`` definition."""
    span = cpp_function_range(text, name)
    return None if span is None else text[span[0] : span[1]]


def cpp_function_range(text: str, name: str) -> Optional[Tuple[int, int]]:
    """(start, end) offsets of the first ``name(...) {...}``
    definition — a call or declaration (``;`` before ``{``) is
    skipped."""
    for m in re.finditer(rf"\b{re.escape(name)}\s*\(", text):
        depth = 0
        i = m.end() - 1
        while i < len(text):
            if text[i] == "(":
                depth += 1
            elif text[i] == ")":
                depth -= 1
                if depth == 0:
                    break
            i += 1
        rest = i + 1
        while rest < len(text) and text[rest] not in "{;(":
            rest += 1
        if rest >= len(text) or text[rest] != "{":
            continue
        depth = 0
        for j in range(rest, len(text)):
            if text[j] == "{":
                depth += 1
            elif text[j] == "}":
                depth -= 1
                if depth == 0:
                    return m.start(), j + 1
        return None
    return None


def line_of(text: str, needle: str) -> int:
    idx = text.find(needle)
    return text.count("\n", 0, idx) + 1 if idx >= 0 else 1
