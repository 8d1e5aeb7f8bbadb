"""Device-boundary purity: no host calls in what the port compiles for
the card, no Python control flow on a device value where it launches.

The JAX suite's subject is what XLA traces: inside a ``jax.jit`` /
Pallas function a Python ``if`` on a tracer freezes a trace-time value
and a host call runs once at trace time.  The port traces nothing; its
counterparts of the same two invariants are:

  * ``jit-host-call`` — what nvcc compiles for the card: every
    ``__global__`` kernel and every ``TC_HD`` / ``TC_ROW_HD`` body in
    ``csrc/``.  A host-only call there (``printf``/``fprintf``/
    ``puts``, ``malloc``/``calloc``/``free``/``new``/``delete``,
    ``std::`` clocks, threads, randomness or streams, ``rand``,
    ``time``, ``clock``, ``getenv``, file I/O, ``exit``) either breaks
    the device build, stalls every lane on a host round trip, or —
    in a ``__host__ __device__`` body shared with the host shims —
    makes the CPU replay diverge from the kernel it stands for;
  * ``jit-branch`` — a Python ``if``/``while``/``assert`` on a device
    tensor's *value* in the launch wrappers (``tpu/fused.py``,
    ``tpu/row_ops.py``).  On the card such a branch reads the value
    back: a hidden device sync per launch, the eager counterpart of
    branching on a tracer.  A wrapper's tensor parameters are those
    whose tensor metadata it reads (``.shape``, ``.dtype``,
    ``.device``, ``.data_ptr()``, …); locals derived from them, and
    results of ``torch.*`` calls, are device values; metadata reads,
    identity tests (``is None``) and module-local helpers that return
    only host values are not.

The JAX suite's decorator rule stays: a def decorated with ``jax.jit``
/ ``jit`` / ``partial(jax.jit, …)`` / ``jax.pmap``, or passed to
``pallas_call``, is scanned as the JAX suite scans it (the port has
none; one brought into the tree is checked the same way).

A tree that has the CUDA sources or the wrappers but yields no kernel,
device body or wrapper to check is ``jit-missing`` — the checker never
passes over nothing.
"""

from __future__ import annotations

import ast
import re
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Set, Tuple

from .common import (
    CSRC,
    Finding,
    PyModule,
    attached_exprs,
    child_stmt_lists,
    dotted_name,
    iter_py_files,
    pragma_codes,
    strip_cpp_comments,
)

BRANCH = "jit-branch"
HOST = "jit-host-call"
MISSING = "jit-missing"

#: The launch wrappers: where the port hands device tensors to kernels.
WRAPPERS = (
    "throttlecrab_tpu_torch/tpu/fused.py",
    "throttlecrab_tpu_torch/tpu/row_ops.py",
)

#: CUDA sources compiled for the card (the .cpp host shims are not).
CUDA_SUFFIXES = (".cu", ".cuh")

#: Markers of a body nvcc compiles for the device.
_DEVICE_MARKERS = re.compile(r"\b(__global__|__device__|TC_HD|TC_ROW_HD)\b")

#: Host-only calls (bare names) and std:: families in device code.
_CPP_HOST_BARE = {
    "printf", "fprintf", "puts", "malloc", "calloc", "realloc", "free",
    "rand", "srand", "time", "clock", "getenv", "fopen", "fread",
    "fwrite", "fclose", "exit", "abort", "sleep", "usleep",
}
_CPP_HOST_STD = re.compile(
    r"\bstd::(chrono|this_thread|thread|random_device|mt19937\w*|"
    r"uniform_\w+|rand|srand|time|clock|cout|cerr|clog|cin|printf|"
    r"fprintf|puts|ifstream|ofstream|fstream|fopen|malloc|calloc|free|"
    r"getenv|exit|abort|system)\b"
)
_CPP_NEW = re.compile(r"\b(new|delete)\b(?!\s*\()")
_CPP_CALL = re.compile(r"(?<![\w:.>])([A-Za-z_]\w*)\s*\(")

#: Tensor reads that return host metadata (no device sync), and the
#: torch calls whose result is a host value.
_TENSOR_META = {
    "shape", "dtype", "ndim", "size", "device", "is_cuda", "layout",
    "data_ptr", "get_device", "dim", "is_contiguous", "numel", "stride",
    "storage_offset", "element_size", "nbytes", "itemsize",
}
_TORCH_HOST = {"torch.device", "torch.Size", "torch.cuda.device"}

SCAN_DIR = "throttlecrab_tpu_torch"

#: Attribute-chain roots that mean host-side effects at trace time.
_HOST_ROOTS = {"time", "random", "os", "sys", "socket", "subprocess"}
_HOST_CHAINS = {"np.random", "numpy.random"}
_HOST_BARE = {"open", "input", "print"}

#: Attributes whose access on a tracer yields a static (Python) value.
_STATIC_ATTRS = {"shape", "dtype", "ndim", "size"}


def _decorator_jit_info(dec: ast.expr) -> Optional[Set[str]]:
    """If this decorator compiles the function, return its
    static_argnames set; else None."""
    name = dotted_name(dec)
    if name in ("jax.jit", "jit", "jax.pmap"):
        return set()
    if isinstance(dec, ast.Call):
        fn = dotted_name(dec.func)
        if fn in ("jax.jit", "jit", "jax.pmap"):
            return _static_argnames(dec)
        if fn in ("partial", "functools.partial") and dec.args:
            inner = dotted_name(dec.args[0])
            if inner in ("jax.jit", "jit", "jax.pmap"):
                return _static_argnames(dec)
    return None


def _static_argnames(call: ast.Call) -> Set[str]:
    out: Set[str] = set()
    for kw in call.keywords:
        if kw.arg == "static_argnames":
            for node in ast.walk(kw.value):
                if isinstance(node, ast.Constant) and isinstance(
                    node.value, str
                ):
                    out.add(node.value)
    return out


def _pallas_kernel_names(tree: ast.Module) -> Set[str]:
    """Function names passed (by name) as pallas_call's kernel arg."""
    out: Set[str] = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Call):
            fn = dotted_name(node.func)
            if fn and fn.split(".")[-1] == "pallas_call" and node.args:
                first = node.args[0]
                if isinstance(first, ast.Name):
                    out.add(first.id)
    return out


def _param_names(fn: ast.FunctionDef) -> List[str]:
    a = fn.args
    names = [p.arg for p in (*a.posonlyargs, *a.args, *a.kwonlyargs)]
    if a.vararg:
        names.append(a.vararg.arg)
    if a.kwarg:
        names.append(a.kwarg.arg)
    return names


class _TraceEnv:
    """Name classification inside one compiled function."""

    def __init__(self, traced: Set[str], static: Set[str]) -> None:
        self.traced = set(traced)
        self.static = set(static)

    def expr_is_traced(self, node: ast.expr) -> bool:
        """Does evaluating this expression touch a traced value in a
        way that yields a tracer (shape/dtype reads are static)?"""
        return bool(self._traced_names(node))

    def _traced_names(self, node: ast.expr) -> Set[str]:
        out: Set[str] = set()
        for sub in _walk_value_positions(node):
            if isinstance(sub, ast.Name) and sub.id in self.traced:
                out.add(sub.id)
        return out

    def observe(self, stmt: ast.stmt) -> None:
        if isinstance(stmt, ast.Assign):
            targets, value = stmt.targets, stmt.value
        elif isinstance(stmt, ast.AnnAssign) and stmt.value is not None:
            targets, value = [stmt.target], stmt.value
        elif isinstance(stmt, ast.AugAssign):
            if isinstance(stmt.target, ast.Name):
                if self.expr_is_traced(stmt.value):
                    self.traced.add(stmt.target.id)
                    self.static.discard(stmt.target.id)
            return
        else:
            return
        traced = self.expr_is_traced(value)
        for t in targets:
            for sub in ast.walk(t):
                if isinstance(sub, ast.Name):
                    if traced:
                        self.traced.add(sub.id)
                        self.static.discard(sub.id)
                    else:
                        self.static.add(sub.id)
                        self.traced.discard(sub.id)


def _walk_value_positions(node: ast.expr):
    """Walk an expression, pruning subtrees that read only static
    metadata (``x.shape``, ``x.dtype[...]`` …) — their result is a
    plain Python value even when ``x`` is traced."""
    stack = [node]
    while stack:
        cur = stack.pop()
        if isinstance(cur, ast.Attribute) and cur.attr in _STATIC_ATTRS:
            continue
        if (
            isinstance(cur, ast.Subscript)
            and isinstance(cur.value, ast.Attribute)
            and cur.value.attr in _STATIC_ATTRS
        ):
            continue
        yield cur
        stack.extend(ast.iter_child_nodes(cur))


def _host_call_name(node: ast.Call) -> Optional[str]:
    name = dotted_name(node.func)
    if name is None:
        return None
    if name in _HOST_BARE:
        return name
    root = name.split(".")[0]
    if root in _HOST_ROOTS:
        return name
    for chain in _HOST_CHAINS:
        if name == chain or name.startswith(chain + "."):
            return name
    return None


def _scan_compiled(
    mod: PyModule,
    fn: ast.FunctionDef,
    static_names: Set[str],
    findings: List[Finding],
    outer: Optional[_TraceEnv] = None,
) -> None:
    params = _param_names(fn)
    env = _TraceEnv(
        traced={p for p in params if p not in static_names},
        static=set(static_names),
    )
    if outer is not None:
        # Closure visibility: enclosing statics stay static unless the
        # nested def shadows them with a (traced) parameter.
        env.static |= outer.static - env.traced
        env.traced |= outer.traced - env.static

    def visit(stmts: Sequence[ast.stmt]) -> None:
        for stmt in stmts:
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
                _scan_compiled(mod, stmt, set(), findings, outer=env)
                continue
            if isinstance(stmt, ast.For):
                # A loop variable bound from a traced iterable is a
                # tracer; from a static one (range, shape tuples) it
                # stays static.  Classify before scanning the body so
                # `if v > 0:` on a traced `v` is caught.
                traced_iter = env.expr_is_traced(stmt.iter)
                for sub in ast.walk(stmt.target):
                    if isinstance(sub, ast.Name):
                        if traced_iter:
                            env.traced.add(sub.id)
                            env.static.discard(sub.id)
                        else:
                            env.static.add(sub.id)
                            env.traced.discard(sub.id)
            test: Optional[ast.expr] = None
            if isinstance(stmt, (ast.If, ast.While)):
                test = stmt.test
            elif isinstance(stmt, ast.Assert):
                test = stmt.test
            if test is not None and env.expr_is_traced(test):
                kind = type(stmt).__name__.lower()
                if BRANCH not in pragma_codes(mod.lines, stmt.lineno):
                    names = sorted(env._traced_names(test))
                    findings.append(
                        Finding(
                            code=BRANCH,
                            path=mod.rel,
                            line=stmt.lineno,
                            symbol=mod.qualname(stmt),
                            message=(
                                f"Python `{kind}` on traced value(s) "
                                f"{', '.join(names)} inside a "
                                "jit/Pallas-compiled function — use "
                                "jnp.where/lax.cond or move the check "
                                "to the host certificate"
                            ),
                        )
                    )
            for expr in attached_exprs(stmt):
                for sub in ast.walk(expr):
                    if not isinstance(sub, ast.Call):
                        continue
                    host = _host_call_name(sub)
                    if host is not None and HOST not in pragma_codes(
                        mod.lines, sub.lineno
                    ):
                        findings.append(
                            Finding(
                                code=HOST,
                                path=mod.rel,
                                line=sub.lineno,
                                symbol=mod.qualname(sub),
                                message=(
                                    f"host call `{host}` inside a "
                                    "jit/Pallas-compiled function "
                                    "executes once at trace time, not "
                                    "per launch"
                                ),
                            )
                        )
            env.observe(stmt)
            for block in child_stmt_lists(stmt):
                visit(block)

    visit(fn.body)


def _check_module(mod: PyModule) -> List[Finding]:
    findings: List[Finding] = []
    pallas_kernels = _pallas_kernel_names(mod.tree)
    seen: Set[int] = set()
    for node in ast.walk(mod.tree):
        if not isinstance(node, ast.FunctionDef) or id(node) in seen:
            continue
        static: Optional[Set[str]] = None
        for dec in node.decorator_list:
            info = _decorator_jit_info(dec)
            if info is not None:
                static = info
                break
        if static is None and node.name in pallas_kernels:
            static = set()
        if static is None:
            continue
        seen.add(id(node))
        _scan_compiled(mod, node, static, findings)
    return findings


def check(root) -> List[Finding]:
    root = Path(root)
    findings: List[Finding] = []
    for rel in iter_py_files(root, SCAN_DIR):
        try:
            mod = PyModule.load(root, rel)
        except (OSError, SyntaxError):
            continue
        findings.extend(_check_module(mod))
    kernels, wrappers = subjects(root)
    for rel, text, bodies in kernels:
        findings.extend(_check_device_bodies(rel, text, bodies))
    for mod, fns in wrappers:
        for fn, tensors in fns:
            _scan_wrapper(mod, fn, tensors, findings)
    if (root / CSRC).is_dir() and not any(b for _, _, b in kernels):
        findings.append(
            Finding(
                MISSING, CSRC, 1,
                "no __global__ kernel or device body found in the CUDA "
                "sources — the device-purity check would pass over "
                "nothing",
            )
        )
    for rel in WRAPPERS:
        found = [fns for mod, fns in wrappers if mod.rel == rel]
        if (root / rel).exists() and not (found and found[0]):
            findings.append(
                Finding(
                    MISSING, rel, 1,
                    "no launch wrapper with tensor parameters found — the "
                    "hidden-sync check would pass over nothing",
                )
            )
    return findings


# ----------------------------------------------------------------- #
# Subjects


def subjects(root) -> Tuple[list, list]:
    """(device bodies per CUDA source, wrapper functions per launch
    module): ``[(rel, comment-free text, [(symbol, start, end)])]`` and
    ``[(PyModule, [(FunctionDef, tensor params)])]``."""
    root = Path(root)
    kernels = []
    base = root / CSRC
    if base.is_dir():
        for path in sorted(base.iterdir()):
            if path.suffix not in CUDA_SUFFIXES:
                continue
            text = strip_cpp_comments(path.read_text())
            kernels.append(
                (path.relative_to(root).as_posix(), text, _device_bodies(text))
            )
    wrappers = []
    for rel in WRAPPERS:
        try:
            mod = PyModule.load(root, rel)
        except (OSError, SyntaxError):
            continue
        fns = []
        for node in mod.tree.body:
            if isinstance(node, ast.FunctionDef):
                tensors = _tensor_params(node)
                if tensors:
                    fns.append((node, tensors))
        wrappers.append((mod, fns))
    return kernels, wrappers


def _device_bodies(text: str) -> List[Tuple[str, int, int]]:
    """(symbol, body start, body end) of every function definition
    carrying a device marker (``__global__``, ``__device__``,
    ``TC_HD``, ``TC_ROW_HD``) — macro definitions excluded."""
    out: List[Tuple[str, int, int]] = []
    for m in _DEVICE_MARKERS.finditer(text):
        line_start = text.rfind("\n", 0, m.start()) + 1
        if text[line_start:m.start()].lstrip().startswith("#"):
            continue  # `#define TC_HD ...`
        depth, i, last_open = 0, m.end(), -1
        while i < len(text):
            ch = text[i]
            if ch == "(":
                if depth == 0:
                    last_open = i
                depth += 1
            elif ch == ")":
                depth -= 1
            elif depth == 0 and ch in ";{":
                break
            i += 1
        if i >= len(text) or text[i] != "{" or last_open < 0:
            continue  # a declaration
        name = re.search(r"([A-Za-z_]\w*)\s*$", text[m.end():last_open])
        depth = 0
        for j in range(i, len(text)):
            if text[j] == "{":
                depth += 1
            elif text[j] == "}":
                depth -= 1
                if depth == 0:
                    out.append((name.group(1) if name else "", i, j + 1))
                    break
    return out


def _check_device_bodies(
    rel: str, text: str, bodies: List[Tuple[str, int, int]]
) -> List[Finding]:
    findings: List[Finding] = []
    seen: Set[Tuple[int, str]] = set()
    for symbol, start, end in bodies:
        body = re.sub(r'"(?:[^"\\\n]|\\.)*"', '""', text[start:end])
        hits: List[Tuple[int, str]] = []
        for m in _CPP_CALL.finditer(body):
            if m.group(1) in _CPP_HOST_BARE:
                hits.append((m.start(), m.group(1)))
        for m in _CPP_HOST_STD.finditer(body):
            hits.append((m.start(), m.group(0)))
        for m in _CPP_NEW.finditer(body):
            hits.append((m.start(), m.group(1)))
        for off, call in sorted(hits):
            line = text.count("\n", 0, start + off) + 1
            if (line, call) in seen:
                continue
            seen.add((line, call))
            findings.append(
                Finding(
                    code=HOST,
                    path=rel,
                    line=line,
                    symbol=symbol,
                    message=(
                        f"host-only call `{call}` inside {symbol}, which "
                        "nvcc compiles for the card — device code cannot "
                        "make it, or makes it per lane through a host "
                        "round trip"
                    ),
                )
            )
    return findings


def _tensor_params(fn: ast.FunctionDef) -> Set[str]:
    """Parameters whose tensor metadata the function reads."""
    params = set(_param_names(fn))
    out: Set[str] = set()
    for node in ast.walk(fn):
        if (
            isinstance(node, ast.Attribute)
            and node.attr in _TENSOR_META | {"new_empty", "is_cuda"}
            and isinstance(node.value, ast.Name)
            and node.value.id in params
        ):
            out.add(node.value.id)
    return out


def _host_returning(fn: ast.FunctionDef, tensors: Set[str], local) -> bool:
    """Does every return of a module-local helper yield host values only
    (given its tensor parameters)?"""
    env = _WrapperEnv(tensors, local)
    for stmt in ast.walk(fn):
        if isinstance(stmt, (ast.Assign, ast.AnnAssign, ast.AugAssign, ast.For)):
            env.observe(stmt)
    returns = [
        n for n in ast.walk(fn) if isinstance(n, ast.Return) and n.value
    ]
    return bool(returns) and not any(
        env.expr_is_traced(r.value) for r in returns
    )


class _WrapperEnv(_TraceEnv):
    """Device-value classification in a launch wrapper."""

    def __init__(self, tensors: Set[str], local: Dict[str, bool]) -> None:
        super().__init__(traced=set(tensors), static=set())
        self.local = local  # module-local helper -> returns host only

    def _traced_names(self, node: ast.expr) -> Set[str]:
        out: Set[str] = set()
        stack = [node]
        while stack:
            cur = stack.pop()
            if isinstance(cur, ast.Attribute) and cur.attr in _TENSOR_META:
                continue
            if isinstance(cur, ast.Compare) and all(
                isinstance(op, (ast.Is, ast.IsNot)) for op in cur.ops
            ):
                continue  # identity: no value read
            if isinstance(cur, ast.Call):
                name = dotted_name(cur.func) or ""
                if self.local.get(name):
                    continue
                if name.startswith("torch.") and name not in _TORCH_HOST:
                    out.add(name)  # a fresh device tensor
            if isinstance(cur, ast.Name) and cur.id in self.traced:
                out.add(cur.id)
            stack.extend(ast.iter_child_nodes(cur))
        return out

    def observe(self, stmt: ast.stmt) -> None:
        if isinstance(stmt, ast.For):
            for name, traced in self._loop_targets(stmt):
                (self.traced.add if traced else self.traced.discard)(name)
            return
        super().observe(stmt)

    def _loop_targets(self, stmt: ast.For) -> List[Tuple[str, bool]]:
        """Each loop variable with whether it takes a device value.  A
        literal tuple of equal-arity tuples destructured into a tuple
        target is classified position by position."""
        it, target = stmt.iter, stmt.target
        if (
            isinstance(target, ast.Tuple)
            and all(isinstance(t, ast.Name) for t in target.elts)
            and isinstance(it, (ast.Tuple, ast.List))
            and it.elts
            and all(
                isinstance(e, ast.Tuple) and len(e.elts) == len(target.elts)
                for e in it.elts
            )
        ):
            return [
                (
                    t.id,  # type: ignore[attr-defined]
                    any(self.expr_is_traced(e.elts[k]) for e in it.elts),
                )
                for k, t in enumerate(target.elts)
            ]
        traced = self.expr_is_traced(it)
        return [
            (sub.id, traced)
            for sub in ast.walk(target)
            if isinstance(sub, ast.Name)
        ]


def _scan_wrapper(
    mod: PyModule,
    fn: ast.FunctionDef,
    tensors: Set[str],
    findings: List[Finding],
) -> None:
    local = {
        node.name: _host_returning(node, _tensor_params(node), {})
        for node in mod.tree.body
        if isinstance(node, ast.FunctionDef) and node is not fn
    }
    env = _WrapperEnv(tensors, local)

    def visit(stmts: Sequence[ast.stmt]) -> None:
        for stmt in stmts:
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            if isinstance(stmt, ast.For):
                env.observe(stmt)
            test = None
            if isinstance(stmt, (ast.If, ast.While, ast.Assert)):
                test = stmt.test
            if test is not None and env.expr_is_traced(test):
                if BRANCH not in pragma_codes(mod.lines, stmt.lineno):
                    kind = type(stmt).__name__.lower()
                    names = sorted(env._traced_names(test))
                    findings.append(
                        Finding(
                            code=BRANCH,
                            path=mod.rel,
                            line=stmt.lineno,
                            symbol=mod.qualname(stmt),
                            message=(
                                f"Python `{kind}` on device value(s) "
                                f"{', '.join(names)} in a launch wrapper "
                                "— reading a device tensor's value syncs "
                                "the card on every launch; decide on "
                                "host metadata or inside the kernel"
                            ),
                        )
                    )
            if not isinstance(stmt, ast.For):
                env.observe(stmt)
            for block in child_stmt_lists(stmt):
                visit(block)

    visit(fn.body)
