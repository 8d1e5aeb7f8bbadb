"""Python ↔ C++ twin parity: constants, status codes, guards, strings.

The port implements its wire and kernel contracts twice: in Python
(``tpu/kernel.py``, ``tpu/limiter.py``, the launch wrappers) and in C++
— the shared hot paths ``native/keymap.cpp`` / ``native/wire_server.cpp``
the port builds unmodified, and its own CUDA sources in ``csrc/``.
Nothing at runtime checks they agree.  This checker extracts both sides
— Python via AST constant folding, C++ via a small ``constexpr`` token
scanner — and fails on any divergence:

  * against ``native/``: packed-row layout (``PACK_WIDTH`` vs
    ``PACK_W``), prep flag bits (``PREP_*`` vs ``TK_PREP_*``),
    per-request status codes (``STATUS_*``), RESP frame limits
    (``MAX_BULK``/``MAX_ARRAY``); the 2^61 big-tolerance refusal guards
    the wire certificates hang on (``fits_*`` in kernel.py vs
    ``TK_PREP_BIGTOL`` in tk_prepare_batch), per *identifier*, so
    dropping just the ``tol`` guard from ``fits_w32_wire`` is caught
    even while the function's other 2^61 compares survive; the 2^62
    segment-arithmetic certificate (``_MUL_SAFE`` / ``MAX_SEGMENT`` vs
    tk_prepare_batch's float literals); the status→error-string
    taxonomy (engine ``STATUS_MESSAGES`` + admission
    ``OVERLOAD_MESSAGE`` vs the C++ wire payloads, and the set of
    status codes the C++ responder branches on);
  * against ``csrc/``: the window kernel's request-row layout, flag
    bits, expiry sentinel, tier codes and sub-batch bound in
    ``gcra_lane.cuh`` (``PACK_WIDTH``, ``FLAG_IS_LAST``/``FLAG_VALID``,
    ``EMPTY_EXPIRY``, ``TIER_*``, ``MAX_BATCH``) vs ``tpu/kernel.py``
    and ``tpu/fused.py``; and the row kernels' widths, batch bound and
    per-width part (the alignment the wrapper demands of the dense
    rows) in ``row_tile.cuh`` vs ``tpu/row_ops.py``.

Finding codes: ``twin-drift`` (values differ), ``twin-missing`` (one
side could not be extracted — extraction failure is drift of the
anchor, never a silent pass), ``twin-guard-missing`` (a required 2^61
guard identifier is gone).
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
    cpp_const_lines,
    cpp_consts,
    cpp_function_span,
    eval_cpp_int,
    fold_int,
    join_adjacent_strings,
    line_of,
    strip_cpp_comments,
)
from .i64_hygiene import GUARD_MIN, refusal_guards

DRIFT = "twin-drift"
MISSING = "twin-missing"
GUARD = "twin-guard-missing"

KERNEL = "throttlecrab_tpu_torch/tpu/kernel.py"
LIMITER = "throttlecrab_tpu_torch/tpu/limiter.py"
NATIVE_PY = "throttlecrab_tpu_torch/native.py"
RESP = "throttlecrab_tpu_torch/server/resp.py"
ADMISSION = "throttlecrab_tpu_torch/front/admission.py"
ENGINE = "throttlecrab_tpu_torch/server/engine.py"
TABLE = "throttlecrab_tpu_torch/tpu/table.py"
KEYMAP_CPP = "native/keymap.cpp"
WIRE_CPP = "native/wire_server.cpp"
FUSED = "throttlecrab_tpu_torch/tpu/fused.py"
ROW_OPS = "throttlecrab_tpu_torch/tpu/row_ops.py"
LANE_CUH = CSRC + "/gcra_lane.cuh"
ROW_TILE_CUH = CSRC + "/row_tile.cuh"

#: (python_file, python_const, cpp_file, cpp_const) integer pairs that
#: must be equal.  Python consts may be class-scoped ("Cls.NAME").
CONST_PAIRS: Tuple[Tuple[str, str, str, str], ...] = (
    (KERNEL, "PACK_WIDTH", KEYMAP_CPP, "PACK_W"),
    (NATIVE_PY, "PREP_DEGEN", KEYMAP_CPP, "TK_PREP_DEGEN"),
    (NATIVE_PY, "PREP_CONFLICT", KEYMAP_CPP, "TK_PREP_CONFLICT"),
    (NATIVE_PY, "PREP_FULL", KEYMAP_CPP, "TK_PREP_FULL"),
    (NATIVE_PY, "PREP_BIGTOL", KEYMAP_CPP, "TK_PREP_BIGTOL"),
    (LIMITER, "STATUS_OK", KEYMAP_CPP, "STATUS_OK"),
    (
        LIMITER,
        "STATUS_NEGATIVE_QUANTITY",
        KEYMAP_CPP,
        "STATUS_NEGATIVE_QUANTITY",
    ),
    (
        LIMITER,
        "STATUS_INVALID_PARAMS",
        KEYMAP_CPP,
        "STATUS_INVALID_PARAMS",
    ),
    (RESP, "MAX_BULK_STRING_SIZE", WIRE_CPP, "MAX_BULK"),
    (RESP, "MAX_ARRAY_SIZE", WIRE_CPP, "MAX_ARRAY"),
)

#: kernel.py wire-certificate functions → identifiers that must each be
#: dominated by an explicit >= 2^61 comparison inside the function.
#: ``tol`` in fits_w32_wire is the known regression: its absence
#: falsely certified w32 for big-tolerance lanes while the C++ twin
#: (TK_PREP_BIGTOL) refused them.
GUARD_MANIFEST: Dict[str, Set[str]] = {
    "fits_cur_wire": {"now_ns", "tolerance"},
    "fits_w32_wire": {"now_ns", "hwm", "tol"},
    "fits_w32_wire_agg": {"now_ns", "hwm"},
    "cur_wire_safe": {"now_ns", "tolerance"},
}

#: (python_file, python_const, csrc_file, cpp_const) pairs of the CUDA
#: sources: the window kernel's request row, flags, sentinel, output
#: tiers and sub-batch bound.
CSRC_PAIRS: Tuple[Tuple[str, str, str, str], ...] = (
    (KERNEL, "PACK_WIDTH", LANE_CUH, "PACK_WIDTH"),
    (KERNEL, "PACK_FLAG_IS_LAST", LANE_CUH, "FLAG_IS_LAST"),
    (KERNEL, "PACK_FLAG_VALID", LANE_CUH, "FLAG_VALID"),
    (KERNEL, "EMPTY_EXPIRY", LANE_CUH, "EMPTY_EXPIRY"),
    (KERNEL, "_NS_PER_SEC", LANE_CUH, "NS_PER_SEC"),
    (KERNEL, "_I32_MAX", LANE_CUH, "I32_MAX"),
    (FUSED, "TIER_NS", LANE_CUH, "TIER_NS"),
    (FUSED, "TIER_WIRE", LANE_CUH, "TIER_WIRE"),
    (FUSED, "TIER_CUR", LANE_CUH, "TIER_CUR"),
    (FUSED, "TIER_W32", LANE_CUH, "TIER_W32"),
    (FUSED, "MAX_BATCH", LANE_CUH, "MAX_BATCH"),
)

#: C++ functions that must contain a << 61 guard expression.
CPP_GUARD_FUNCS = ("tk_prepare_batch",)

#: Python status code name (module, const) → the C++ responder must
#: branch on its value (``status[i] == N``) and carry the message.
STATUS_BRANCHES: Tuple[Tuple[str, str], ...] = (
    (LIMITER, "STATUS_NEGATIVE_QUANTITY"),
    (LIMITER, "STATUS_INVALID_PARAMS"),
    (ADMISSION, "STATUS_OVERLOADED"),
)


# ----------------------------------------------------------------- #
# Python-side extraction


def _py_consts(mod: PyModule) -> Dict[str, int]:
    """Module- and class-level integer constant assignments, folded."""
    out: Dict[str, int] = {}

    def scan(body, prefix: str) -> None:
        for stmt in body:
            if isinstance(stmt, ast.ClassDef):
                scan(stmt.body, prefix + stmt.name + ".")
            elif isinstance(stmt, ast.Assign):
                v = fold_int(stmt.value)
                if v is None:
                    continue
                for t in stmt.targets:
                    if isinstance(t, ast.Name):
                        out[prefix + t.id] = v

    scan(mod.tree.body, "")
    return out


def _py_functions(mod: PyModule) -> Dict[str, ast.FunctionDef]:
    return {
        node.name: node
        for node in ast.walk(mod.tree)
        if isinstance(node, ast.FunctionDef)
    }


def _py_string_map(mod: PyModule, dict_name: str) -> Dict[str, str]:
    """A module-level ``NAME = {CONST_NAME: "string", ...}`` mapping,
    keyed by the key's source name."""
    for stmt in mod.tree.body:
        if not (
            isinstance(stmt, ast.Assign)
            and any(
                isinstance(t, ast.Name) and t.id == dict_name
                for t in stmt.targets
            )
            and isinstance(stmt.value, ast.Dict)
        ):
            continue
        out: Dict[str, str] = {}
        for k, v in zip(stmt.value.keys, stmt.value.values):
            if (
                isinstance(k, ast.Name)
                and isinstance(v, ast.Constant)
                and isinstance(v.value, str)
            ):
                out[k.id] = v.value
        return out
    return {}


def _py_str_const(mod: PyModule, name: str) -> Optional[str]:
    for stmt in mod.tree.body:
        if isinstance(stmt, ast.Assign) and any(
            isinstance(t, ast.Name) and t.id == name
            for t in stmt.targets
        ):
            if isinstance(stmt.value, ast.Constant) and isinstance(
                stmt.value.value, str
            ):
                return stmt.value.value
    return None


# ----------------------------------------------------------------- #


def check(root) -> List[Finding]:
    root = Path(root)
    findings: List[Finding] = []

    mods: Dict[str, Optional[PyModule]] = {}
    for rel in (KERNEL, LIMITER, NATIVE_PY, RESP, ADMISSION, ENGINE):
        try:
            mods[rel] = PyModule.load(root, rel)
        except OSError:
            mods[rel] = None
            findings.append(
                Finding(MISSING, rel, 1, "twin anchor file unreadable")
            )

    cpp_raw: Dict[str, Optional[str]] = {}
    for rel in (KEYMAP_CPP, WIRE_CPP):
        path = root / rel
        if path.exists():
            cpp_raw[rel] = path.read_text()
        else:
            cpp_raw[rel] = None
            findings.append(
                Finding(MISSING, rel, 1, "twin anchor file unreadable")
            )

    cpp_clean = {
        rel: strip_cpp_comments(text) if text is not None else None
        for rel, text in cpp_raw.items()
    }
    cpp_values = {
        rel: cpp_consts(text) if text is not None else {}
        for rel, text in cpp_clean.items()
    }
    py_consts = {
        rel: _py_consts(mod) if mod is not None else {}
        for rel, mod in mods.items()
    }

    # ---- integer constant pairs ---------------------------------- #
    for py_rel, py_name, cpp_rel, cpp_name in CONST_PAIRS:
        pv = py_consts.get(py_rel, {}).get(py_name)
        cv = cpp_values.get(cpp_rel, {}).get(cpp_name)
        if pv is None and mods.get(py_rel) is not None:
            findings.append(
                Finding(
                    MISSING,
                    py_rel,
                    1,
                    f"expected constant {py_name} not extractable "
                    f"(twin of {cpp_rel}:{cpp_name})",
                )
            )
        if cv is None and cpp_clean.get(cpp_rel) is not None:
            findings.append(
                Finding(
                    MISSING,
                    cpp_rel,
                    1,
                    f"expected constant {cpp_name} not extractable "
                    f"(twin of {py_rel}:{py_name})",
                )
            )
        if pv is not None and cv is not None and pv != cv:
            findings.append(
                Finding(
                    DRIFT,
                    py_rel,
                    1,
                    f"{py_name} = {pv} but C++ twin "
                    f"{cpp_rel}:{cpp_name} = {cv}",
                )
            )

    # ---- 2^61 guard manifest (kernel.py) ------------------------- #
    kernel = mods.get(KERNEL)
    if kernel is not None:
        fns = _py_functions(kernel)
        for fn_name, required in GUARD_MANIFEST.items():
            fn = fns.get(fn_name)
            if fn is None:
                findings.append(
                    Finding(
                        MISSING,
                        KERNEL,
                        1,
                        f"wire-certificate function {fn_name} not "
                        "found (guard manifest anchor)",
                    )
                )
                continue
            guarded = refusal_guards(fn)
            for ident in sorted(required - guarded):
                findings.append(
                    Finding(
                        GUARD,
                        KERNEL,
                        fn.lineno,
                        symbol=fn_name,
                        message=(
                            f"{fn_name} lost its >= 2**61 refusal "
                            f"guard on `{ident}` — the C++ twin "
                            "(TK_PREP_BIGTOL, native/keymap.cpp) "
                            "refuses such lanes before any arithmetic "
                            "can wrap"
                        ),
                    )
                )

    # ---- 2^61 guard presence (C++) ------------------------------- #
    keymap_text = cpp_clean.get(KEYMAP_CPP)
    if keymap_text is not None:
        for fn_name in CPP_GUARD_FUNCS:
            span = cpp_function_span(keymap_text, fn_name)
            if span is None:
                findings.append(
                    Finding(
                        MISSING,
                        KEYMAP_CPP,
                        1,
                        f"function {fn_name} not found (guard anchor)",
                    )
                )
            elif not re.search(r"<<\s*61\b", span):
                findings.append(
                    Finding(
                        GUARD,
                        KEYMAP_CPP,
                        line_of(cpp_raw[KEYMAP_CPP] or "", fn_name),
                        symbol=fn_name,
                        message=(
                            f"{fn_name} lost its 1 << 61 big-tolerance "
                            "guard (twin of kernel.py fits_* "
                            "certificates)"
                        ),
                    )
                )

    # ---- 2^62 segment-arithmetic certificate --------------------- #
    limiter = mods.get(LIMITER)
    if limiter is not None and keymap_text is not None:
        mul_safe = py_consts[LIMITER].get("_MUL_SAFE")
        if mul_safe != GUARD_MIN * 2:
            findings.append(
                Finding(
                    DRIFT,
                    LIMITER,
                    1,
                    f"_MUL_SAFE = {mul_safe} != 2**62 — the certified "
                    "plain-multiply bound the kernel and "
                    "tk_prepare_batch both assume",
                )
            )
        span = cpp_function_span(keymap_text, "tk_prepare_batch") or ""
        if "4611686018427387904.0" not in span:
            findings.append(
                Finding(
                    GUARD,
                    KEYMAP_CPP,
                    line_of(cpp_raw[KEYMAP_CPP] or "", "tk_prepare_batch"),
                    symbol="tk_prepare_batch",
                    message=(
                        "tk_prepare_batch lost the 2**62 segment-"
                        "arithmetic certificate (limiter._MUL_SAFE "
                        "twin)"
                    ),
                )
            )
        # MAX_SEGMENT: limiter binds it to BucketTable.SCRATCH; the C++
        # certificate hard-codes the float.  Extract SCRATCH from
        # table.py and require the literal to match.
        try:
            table = PyModule.load(root, TABLE)
            scratch = _py_consts(table).get("BucketTable.SCRATCH")
        except OSError:
            scratch = None
        if scratch is None:
            findings.append(
                Finding(
                    MISSING,
                    TABLE,
                    1,
                    "BucketTable.SCRATCH not extractable (MAX_SEGMENT "
                    "twin anchor)",
                )
            )
        elif f"{float(scratch):.1f}" not in span:
            findings.append(
                Finding(
                    DRIFT,
                    KEYMAP_CPP,
                    line_of(cpp_raw[KEYMAP_CPP] or "", "tk_prepare_batch"),
                    symbol="tk_prepare_batch",
                    message=(
                        f"MAX_SEGMENT is {scratch} "
                        f"(BucketTable.SCRATCH) but tk_prepare_batch's "
                        f"certificate does not use {float(scratch):.1f}"
                    ),
                )
            )

    # ---- status codes the C++ responder branches on -------------- #
    wire_text = cpp_clean.get(WIRE_CPP)
    if wire_text is not None:
        handled = {
            int(m.group(1))
            for m in re.finditer(r"status\[i\]\s*==\s*(\d+)", wire_text)
        }
        for mod_rel, const in STATUS_BRANCHES:
            mod = mods.get(mod_rel)
            if mod is None:
                continue
            value = _py_consts(mod).get(const)
            if value is None:
                findings.append(
                    Finding(
                        MISSING,
                        mod_rel,
                        1,
                        f"status constant {const} not extractable",
                    )
                )
            elif value not in handled:
                findings.append(
                    Finding(
                        DRIFT,
                        WIRE_CPP,
                        1,
                        f"ws_respond does not branch on status "
                        f"{const} = {value} ({mod_rel}); C++ clients "
                        "would get the generic internal error",
                    )
                )

    # ---- error-string taxonomy ----------------------------------- #
    engine = mods.get(ENGINE)
    admission = mods.get(ADMISSION)
    if wire_text is not None and engine is not None:
        joined = join_adjacent_strings(wire_text)
        messages = dict(_py_string_map(engine, "STATUS_MESSAGES"))
        if not messages:
            findings.append(
                Finding(
                    MISSING,
                    ENGINE,
                    1,
                    "STATUS_MESSAGES not extractable (error-string "
                    "taxonomy anchor)",
                )
            )
        if admission is not None:
            overload = _py_str_const(admission, "OVERLOAD_MESSAGE")
            if overload is None:
                findings.append(
                    Finding(
                        MISSING,
                        ADMISSION,
                        1,
                        "OVERLOAD_MESSAGE not extractable",
                    )
                )
            else:
                messages["STATUS_OVERLOADED"] = overload
        for const, msg in sorted(messages.items()):
            escaped = msg.replace('"', '\\"')
            if f"-ERR {escaped}" not in joined:
                findings.append(
                    Finding(
                        DRIFT,
                        WIRE_CPP,
                        1,
                        f"RESP payload for {const} "
                        f"(\"-ERR {msg}\") missing or drifted from "
                        "the Python error taxonomy",
                    )
                )

    findings.extend(check_csrc(root, py_consts.get(KERNEL)))
    return findings


# ----------------------------------------------------------------- #
# The CUDA sources (csrc/)


def _read_cpp(root: Path, rel: str, findings: List[Finding]):
    """(raw, comment-free) text of a C++ anchor, or None (and a
    twin-missing finding)."""
    path = root / rel
    if not path.exists():
        findings.append(Finding(MISSING, rel, 1, "twin anchor file unreadable"))
        return None
    raw = path.read_text()
    return raw, strip_cpp_comments(raw)


def _py_int_tuple(mod: PyModule, name: str) -> Optional[Tuple[int, ...]]:
    """A module-level ``NAME = (int, ...)`` tuple, folded."""
    for stmt in mod.tree.body:
        if (
            isinstance(stmt, ast.Assign)
            and any(
                isinstance(t, ast.Name) and t.id == name
                for t in stmt.targets
            )
            and isinstance(stmt.value, ast.Tuple)
        ):
            vals = [fold_int(e) for e in stmt.value.elts]
            if any(v is None for v in vals):
                return None
            return tuple(vals)  # type: ignore[arg-type]
    return None


def _py_row_align(mod: PyModule) -> Optional[Dict[int, int]]:
    """The dense rows' alignment per width that ``row_ops._check``
    demands: its ``A if W == w else B`` expression, as {w: A, other: B}
    keyed by the widths it names (``-1`` = every other width)."""
    fns = _py_functions(mod)
    fn = fns.get("_check")
    if fn is None:
        return None
    for node in ast.walk(fn):
        if not (
            isinstance(node, ast.IfExp)
            and isinstance(node.test, ast.Compare)
            and len(node.test.ops) == 1
            and isinstance(node.test.ops[0], ast.Eq)
            and isinstance(node.test.left, ast.Name)
            and node.test.left.id == "W"
        ):
            continue
        w, a, b = (
            fold_int(node.test.comparators[0]),
            fold_int(node.body),
            fold_int(node.orelse),
        )
        if None not in (w, a, b):
            return {w: a, -1: b}  # type: ignore[dict-item]
    return None


def check_csrc(root, kernel_consts=None) -> List[Finding]:
    """The CUDA sources against the Python they mirror."""
    root = Path(root)
    findings: List[Finding] = []
    mods: Dict[str, Optional[PyModule]] = {}
    for rel in (KERNEL, FUSED, ROW_OPS):
        try:
            mods[rel] = PyModule.load(root, rel)
        except (OSError, SyntaxError):
            mods[rel] = None
            if rel != KERNEL:  # check() already reported the kernel
                findings.append(
                    Finding(MISSING, rel, 1, "twin anchor file unreadable")
                )
    py = {
        rel: (_py_consts(m) if m is not None else {})
        for rel, m in mods.items()
    }
    if kernel_consts is not None:
        py[KERNEL] = kernel_consts
    cpp = {
        rel: _read_cpp(root, rel, findings)
        for rel in (LANE_CUH, ROW_TILE_CUH)
    }

    # ---- constexpr pairs (gcra_lane.cuh) ------------------------- #
    lane = cpp[LANE_CUH]
    if lane is not None:
        consts, lines = cpp_consts(lane[1]), cpp_const_lines(lane[1])
        for py_rel, py_name, cpp_rel, cpp_name in CSRC_PAIRS:
            pv = py[py_rel].get(py_name)
            cv = consts.get(cpp_name)
            if pv is None and mods[py_rel] is not None:
                findings.append(
                    Finding(
                        MISSING, py_rel, 1,
                        f"expected constant {py_name} not extractable "
                        f"(twin of {cpp_rel}:{cpp_name})",
                    )
                )
            if cv is None:
                findings.append(
                    Finding(
                        MISSING, cpp_rel, 1,
                        f"expected constexpr {cpp_name} not extractable "
                        f"(twin of {py_rel}:{py_name})",
                    )
                )
            if pv is not None and cv is not None and pv != cv:
                findings.append(
                    Finding(
                        DRIFT, cpp_rel, lines.get(cpp_name, 1),
                        f"{cpp_name} = {cv} but its Python twin "
                        f"{py_rel}:{py_name} = {pv}",
                        symbol=cpp_name,
                    )
                )

    # ---- row kernels' tile (row_tile.cuh) ------------------------ #
    tile = cpp[ROW_TILE_CUH]
    row_ops = mods[ROW_OPS]
    if tile is not None and row_ops is not None:
        raw, text = tile
        make = cpp_function_span(text, "make_tile") or ""
        part = cpp_function_span(text, "part_words") or ""
        widths = {int(w) for w in re.findall(r"\bwidth\s*!=\s*(\d+)", make)}
        bound = re.search(r"\bb\s*>\s*([^|)]+\))", make)
        bound_v = eval_cpp_int(bound.group(1)) if bound else None
        part_m = re.search(
            r"width\s*==\s*(\d+)\s*\?\s*(\d+)\s*:\s*(\d+)", part
        )
        line_make = line_of(raw, "make_tile(")
        py_widths = _py_int_tuple(row_ops, "WIDTHS")
        py_batch = py[ROW_OPS].get("MAX_BATCH")
        py_align = _py_row_align(row_ops)
        for what, got in (
            ("make_tile's accepted widths", widths or None),
            ("make_tile's batch bound", bound_v),
            ("part_words", part_m),
        ):
            if got is None:
                findings.append(
                    Finding(
                        MISSING, ROW_TILE_CUH, 1,
                        f"{what} not extractable (twin of {ROW_OPS})",
                    )
                )
        for name, got in (
            ("WIDTHS", py_widths),
            ("MAX_BATCH", py_batch),
            ("_check's row alignment", py_align),
        ):
            if got is None:
                findings.append(
                    Finding(
                        MISSING, ROW_OPS, 1,
                        f"{name} not extractable (twin of {ROW_TILE_CUH})",
                    )
                )
        if widths and py_widths is not None and widths != set(py_widths):
            findings.append(
                Finding(
                    DRIFT, ROW_TILE_CUH, line_make,
                    f"make_tile takes widths {sorted(widths)} but "
                    f"{ROW_OPS}:WIDTHS = {py_widths}",
                    symbol="make_tile",
                )
            )
        if (
            bound_v is not None
            and py_batch is not None
            and bound_v != py_batch
        ):
            findings.append(
                Finding(
                    DRIFT, ROW_TILE_CUH, line_make,
                    f"make_tile's batch bound is {bound_v} but "
                    f"{ROW_OPS}:MAX_BATCH = {py_batch}",
                    symbol="make_tile",
                )
            )
        if part_m is not None and py_align is not None and widths:
            w0, p_eq, p_else = (int(g) for g in part_m.groups())
            for w in sorted(widths):
                cpp_align = 4 * (p_eq if w == w0 else p_else)
                want = py_align.get(w, py_align[-1])
                if cpp_align != want:
                    findings.append(
                        Finding(
                            DRIFT, ROW_TILE_CUH,
                            line_of(raw, "part_words("),
                            f"a W={w} row moves in {cpp_align}-byte parts "
                            f"but {ROW_OPS}:_check aligns its rows to "
                            f"{want} bytes",
                            symbol="part_words",
                        )
                    )
    return findings
