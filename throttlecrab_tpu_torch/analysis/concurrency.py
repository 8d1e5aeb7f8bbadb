"""Shared concurrency model for the lock/block/async checkers.

The model is built once per tree and answers three questions the
checkers ask:

  * **which locks exist** — every ``self.X = threading.Lock()`` /
    ``RLock()`` / ``Condition()`` creation site in the package (plus
    module-level ones), each identified as ``Class.attr`` (or
    ``module.attr``).  ``threading.Condition(self.y)`` is an automatic
    alias of the lock it wraps.  The canonical acquisition order,
    per-lock blocking allowances and async-context permissions are
    declared in ``lockorder.toml`` next to this file — the declaration
    and the discovered creation sites ratchet against each other
    (``lock-unranked`` / ``lock-decl-stale``).
  * **where locks are held** — ``with <lock>:`` regions,
    ``<lock>.acquire()`` (held for the remainder of the function — the
    held-dict pattern the cluster's pipelined forwarding uses), and
    ``stack.enter_context(<lock>)``.
  * **what runs while they are held** — a conservative intra-package
    call graph.  Resolution is deliberately *precise over complete*:
    bare names resolve within the defining module, ``self.m()`` within
    the enclosing class, and ``obj.m()`` only when exactly one function
    in the package bears that name (a non-awaited call never resolves
    to an ``async def``).  Ambiguous names (``rate_limit_batch`` exists
    on five limiter classes) stay unresolved — the blocking checker
    covers those through its *name-based* taxonomy instead, so a
    ``.send_frame(...)`` under a ranked lock is flagged no matter what
    the receiver is.  Unresolvable receivers under-approximate the
    graph; they can hide a path, never invent one.

Lock identity is per *class attribute*, not per instance: two
``PeerConnection`` objects share the id ``PeerConnection.lock``.
Same-lock self-edges are therefore skipped (acquiring peer A's lock
inside peer B's region is legal and common); the cross-instance
acquisition protocol (index-ordered acquires in the pipelined round)
is documented in cluster.py and out of static scope.
"""

from __future__ import annotations

import ast
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Set, Tuple

from .common import PyModule, dotted_name, iter_py_files, parse_tables

SCAN_DIR = "throttlecrab_tpu_torch"
LOCKORDER_REL = "throttlecrab_tpu_torch/analysis/lockorder.toml"

_LOCK_CTORS = {"threading.Lock", "threading.RLock"}
_COND_CTOR = "threading.Condition"

#: Terminal method names too generic to resolve by package-wide
#: uniqueness — they collide with stdlib/builtin methods on arbitrary
#: receivers (``subprocess.run`` must never resolve to a Thread
#: subclass's ``run``).  Calls on these names stay unresolved; the
#: name-based blocking taxonomy still sees them.
_GENERIC_NAMES = {
    "run", "get", "put", "pop", "popleft", "close", "read", "write",
    "join", "wait", "acquire", "release", "shutdown", "send", "recv",
    "sleep", "start", "stop", "clear", "update", "copy", "append",
    "add", "remove", "discard", "keys", "values", "items", "result",
    "cancel", "done", "flush", "connect", "accept", "submit", "encode",
    "decode", "strip", "split", "sort", "format", "count", "index",
    "insert", "extend", "open", "next", "set", "match", "search",
    "group", "mkdir", "exists", "unlink", "tolist", "reshape",
}

#: asyncio APIs that must only run on the event-loop thread.
LOOP_AFFINE = {
    "get_running_loop",
    "get_event_loop",
    "create_task",
    "ensure_future",
    "call_soon",
    "call_later",
    "current_task",
    "add_signal_handler",
}


# ----------------------------------------------------------------- #
# lockorder.toml


@dataclass(frozen=True)
class LockDecl:
    lock_id: str  # "Class.attr" or "module.attr"
    rank: int
    allow: frozenset  # blocking kinds permitted while held
    async_ok: bool
    line: int = 0  # lockorder.toml source line of the [[lock]] table


@dataclass
class LockSpec:
    decls: Dict[str, LockDecl]
    #: (enclosing class, attr) -> canonical lock id (declared aliases +
    #: discovered Condition(self.x) wrappers).
    aliases: Dict[Tuple[str, str], str]
    #: (pattern, kind): "a.b" = exact dotted, "root.*" = module root,
    #: bare = terminal attribute/function name.
    blocking: List[Tuple[str, str]]
    #: (class, attr) -> lockorder.toml line of the [[alias]] table.
    alias_lines: Dict[Tuple[str, str], int] = field(
        default_factory=dict
    )

    def rank(self, lock_id: str) -> int:
        return self.decls[lock_id].rank

    def kinds_of(self, name: str) -> Set[str]:
        """Blocking kinds a dotted call name matches (terminal-name
        entries match the last segment)."""
        out: Set[str] = set()
        terminal = name.rsplit(".", 1)[-1]
        root = name.split(".", 1)[0]
        for pattern, kind in self.blocking:
            if pattern.endswith(".*"):
                if root == pattern[:-2]:
                    out.add(kind)
            elif "." in pattern:
                if name == pattern:
                    out.add(kind)
            elif terminal == pattern:
                out.add(kind)
        return out


def load_lockspec(root) -> Optional[LockSpec]:
    path = Path(root) / LOCKORDER_REL
    if not path.exists():
        return None
    tables = parse_tables(path.read_text(), "lockorder.toml")
    unknown = set(tables) - {"lock", "alias", "blocking"}
    if unknown:
        raise ValueError(
            f"lockorder.toml: unknown table(s) {sorted(unknown)}"
        )
    decls: Dict[str, LockDecl] = {}
    for entry in tables.get("lock", []):
        line = int(entry.pop("_line", 0))  # type: ignore[arg-type]
        for req in ("name", "class", "rank"):
            if req not in entry:
                raise ValueError(
                    f"lockorder.toml:{line}: [[lock]] entry missing "
                    f"{req!r}"
                )
        lock_id = f"{entry['class']}.{entry['name']}"
        allow = frozenset(
            k.strip()
            for k in str(entry.get("allow", "")).split(",")
            if k.strip()
        )
        decls[lock_id] = LockDecl(
            lock_id=lock_id,
            rank=int(entry["rank"]),  # type: ignore[arg-type]
            allow=allow,
            async_ok=bool(int(entry.get("async_ok", 0))),  # type: ignore[arg-type]
            line=line,
        )
    aliases: Dict[Tuple[str, str], str] = {}
    alias_lines: Dict[Tuple[str, str], int] = {}
    for entry in tables.get("alias", []):
        line = int(entry.pop("_line", 0))  # type: ignore[arg-type]
        for req in ("name", "class", "target"):
            if req not in entry:
                raise ValueError(
                    f"lockorder.toml:{line}: [[alias]] entry missing "
                    f"{req!r}"
                )
        key = (str(entry["class"]), str(entry["name"]))
        aliases[key] = str(entry["target"])
        alias_lines[key] = line
    blocking = [
        (str(entry["call"]), str(entry["kind"]))
        for entry in tables.get("blocking", [])
    ]
    return LockSpec(
        decls=decls,
        aliases=aliases,
        blocking=blocking,
        alias_lines=alias_lines,
    )


# ----------------------------------------------------------------- #
# Per-function facts


@dataclass
class FnInfo:
    fid: str
    rel: str
    cls: str  # innermost enclosing class name ("" at module level)
    name: str
    qualname: str
    node: ast.AST
    is_async: bool
    #: (lock_id, line, held-stack-at-acquisition)
    acquires: List[Tuple[str, int, Tuple[str, ...]]] = field(
        default_factory=list
    )
    #: (kind, dotted call, line, held stack, awaited)
    blocks: List[Tuple[str, str, int, Tuple[str, ...], bool]] = field(
        default_factory=list
    )
    #: (target spec, line, held stack, awaited); spec is ("bare"|"self"
    #: |"attr", name)
    calls: List[
        Tuple[Tuple[str, str], int, Tuple[str, ...], bool]
    ] = field(default_factory=list)
    #: (lock_id, with-line): sync lock region containing an `await`.
    lock_across_await: List[Tuple[str, int]] = field(
        default_factory=list
    )
    #: loop-affine asyncio API calls: (dotted name, line)
    loop_affine: List[Tuple[str, int]] = field(default_factory=list)


@dataclass
class Model:
    root: Path
    spec: Optional[LockSpec]
    modules: Dict[str, PyModule]
    fns: Dict[str, FnInfo]
    by_name: Dict[str, List[str]]  # terminal def name -> fids
    by_cls: Dict[Tuple[str, str], List[str]]  # (class, name) -> fids
    #: lock_id -> (rel, line) creation site
    created: Dict[str, Tuple[str, int]]
    #: function names referenced as thread entry points
    thread_entries: Set[str]
    #: transitive lock ids / blocking (kind, call) pairs per fid
    closure_acq: Dict[str, Set[str]] = field(default_factory=dict)
    closure_blk: Dict[str, Set[Tuple[str, str]]] = field(
        default_factory=dict
    )

    # -- call resolution ------------------------------------------- #

    def resolve(
        self, spec: Tuple[str, str], rel: str, cls: str, awaited: bool
    ) -> Optional[str]:
        kind, name = spec

        def ok(fid: str) -> bool:
            # A non-awaited call to an async def only builds a
            # coroutine — the body runs wherever it is later awaited
            # or scheduled, and reports its own findings there.
            return awaited or not self.fns[fid].is_async

        if kind == "bare":
            for fid in self.by_cls.get(("", name), []):
                if self.fns[fid].rel == rel:
                    return fid if ok(fid) else None
            return None
        if kind == "self" and cls:
            own = self.by_cls.get((cls, name), [])
            if own:
                return own[0] if ok(own[0]) else None
        if name in _GENERIC_NAMES:
            return None  # stdlib-shaped: uniqueness proves nothing
        candidates = [f for f in self.by_name.get(name, []) if ok(f)]
        if len(candidates) == 1:
            return candidates[0]
        return None

    # -- transitive closures --------------------------------------- #

    def compute_closures(self) -> None:
        """Fixpoint: everything a function may acquire/block on,
        including through resolved callees."""
        edges: Dict[str, Set[str]] = {}
        for fid, fn in self.fns.items():
            self.closure_acq[fid] = {a[0] for a in fn.acquires}
            self.closure_blk[fid] = {
                (b[0], b[1]) for b in fn.blocks
            }
            out: Set[str] = set()
            for spec, _line, _held, awaited in fn.calls:
                target = self.resolve(spec, fn.rel, fn.cls, awaited)
                if target is not None:
                    out.add(target)
            edges[fid] = out
        changed = True
        while changed:
            changed = False
            for fid, out in edges.items():
                acq = self.closure_acq[fid]
                blk = self.closure_blk[fid]
                for callee in out:
                    extra_a = self.closure_acq[callee] - acq
                    if extra_a:
                        acq |= extra_a
                        changed = True
                    extra_b = self.closure_blk[callee] - blk
                    if extra_b:
                        blk |= extra_b
                        changed = True
        self._edges = edges

    def callees(self, fid: str) -> Set[str]:
        return getattr(self, "_edges", {}).get(fid, set())

    def witness(self, start: str, pred) -> List[str]:
        """BFS chain of qualnames from `start` to the first function
        satisfying `pred` (for "via a -> b" messages)."""
        from collections import deque

        seen = {start}
        queue = deque([(start, [start])])
        while queue:
            fid, path = queue.popleft()
            if pred(fid):
                return [self.fns[f].qualname for f in path]
            for nxt in self.callees(fid):
                if nxt not in seen:
                    seen.add(nxt)
                    queue.append((nxt, path + [nxt]))
        return []


# ----------------------------------------------------------------- #
# Lock discovery


def _lock_ctor_kind(expr: ast.expr) -> Optional[str]:
    """"lock" | "cond" when `expr` constructs a *threading* primitive
    (dotted through the module: asyncio.Lock must not count).  The
    ``injected or threading.Lock()`` default-argument idiom counts —
    the attribute IS a lock either way."""
    if isinstance(expr, ast.BoolOp):
        for operand in expr.values:
            kind = _lock_ctor_kind(operand)
            if kind is not None:
                return kind
        return None
    if not isinstance(expr, ast.Call):
        return None
    name = dotted_name(expr.func)
    if name in _LOCK_CTORS:
        return "lock"
    if name == _COND_CTOR:
        return "cond"
    return None


def discover_locks(
    modules: Dict[str, PyModule],
) -> Tuple[Dict[str, Tuple[str, int]], Dict[Tuple[str, str], str]]:
    """(creation sites by lock id, Condition->wrapped-lock aliases)."""
    created: Dict[str, Tuple[str, int]] = {}
    cond_aliases: Dict[Tuple[str, str], str] = {}
    for rel, mod in modules.items():
        stem = Path(rel).stem
        for node in ast.walk(mod.tree):
            if not isinstance(node, ast.Assign) or len(node.targets) != 1:
                continue
            kind = _lock_ctor_kind(node.value)
            if kind is None:
                continue
            target = node.targets[0]
            owner = attr = None
            if (
                isinstance(target, ast.Attribute)
                and isinstance(target.value, ast.Name)
                and target.value.id == "self"
            ):
                qual = mod.qualname(node)
                owner = qual.split(".")[0] if qual else ""
                attr = target.attr
            elif isinstance(target, ast.Name) and not mod.qualname(node):
                owner = stem
                attr = target.id
            if not owner or attr is None:
                continue
            wrapped = None
            if kind == "cond":
                ctor = node.value
                if isinstance(ctor, ast.BoolOp):
                    ctor = next(
                        v
                        for v in ctor.values
                        if _lock_ctor_kind(v) is not None
                    )
                args = ctor.args  # type: ignore[union-attr]
                if (
                    args
                    and isinstance(args[0], ast.Attribute)
                    and isinstance(args[0].value, ast.Name)
                    and args[0].value.id == "self"
                ):
                    wrapped = f"{owner}.{args[0].attr}"
            if wrapped is not None:
                cond_aliases[(owner, attr)] = wrapped
            else:
                created.setdefault(
                    f"{owner}.{attr}", (rel, node.lineno)
                )
    return created, cond_aliases


# ----------------------------------------------------------------- #
# Function scanning


def _fn_params(node) -> Set[str]:
    a = node.args
    return {p.arg for p in (*a.posonlyargs, *a.args, *a.kwonlyargs)}


class _Scanner:
    """Walks one function body (nested defs excluded) recording lock
    acquisitions, blocking calls, call sites and their held-lock
    context."""

    def __init__(
        self,
        model_ctx: "_BuildCtx",
        mod: PyModule,
        fn: FnInfo,
    ) -> None:
        self.ctx = model_ctx
        self.mod = mod
        self.fn = fn
        self.active: List[str] = []

    # -- lock expression resolution -------------------------------- #

    def _lock_of(self, expr: ast.expr) -> Optional[str]:
        """Canonical lock id for an acquisition expression, or None."""
        ctx = self.ctx
        if isinstance(expr, ast.Attribute):
            attr = expr.attr
            alias = ctx.aliases.get((self.fn.cls, attr))
            if alias is not None:
                return alias
            is_self = (
                isinstance(expr.value, ast.Name)
                and expr.value.id == "self"
            )
            if is_self and f"{self.fn.cls}.{attr}" in ctx.lock_ids:
                return f"{self.fn.cls}.{attr}"
            owners = ctx.locks_by_attr.get(attr, [])
            if len(owners) == 1:
                return owners[0]
            if owners and ctx.spec is not None:
                ranks = {
                    ctx.spec.decls[o].rank
                    for o in owners
                    if o in ctx.spec.decls
                }
                if len(ranks) == 1 and all(
                    o in ctx.spec.decls for o in owners
                ):
                    # All candidates share a rank (e.g. the engine's and
                    # the native driver's limiter_lock): any is exact
                    # enough for ordering purposes.
                    return sorted(owners)[0]
            return None
        if isinstance(expr, ast.Name):
            stem = Path(self.fn.rel).stem
            lock_id = f"{stem}.{expr.id}"
            if lock_id in self.ctx.lock_ids:
                return lock_id
        return None

    # -- expression events ----------------------------------------- #

    def _scan_expr(self, expr: ast.expr, awaited: bool = False) -> None:
        if isinstance(expr, ast.Await):
            self._scan_expr(expr.value, awaited=True)
            return
        if isinstance(expr, ast.Call):
            if self._scan_call(expr, awaited):
                return  # acquire/executor forms scan their own args
            for arg in expr.args:
                self._scan_expr(
                    arg.value if isinstance(arg, ast.Starred) else arg
                )
            for kw in expr.keywords:
                self._scan_expr(kw.value)
            # The receiver expression may itself nest calls (a().b()).
            if isinstance(expr.func, ast.Attribute):
                self._scan_expr(expr.func.value)
            return
        if isinstance(expr, ast.Lambda):
            return  # deferred body: not executed here
        for sub in ast.iter_child_nodes(expr):
            if isinstance(sub, ast.expr):
                self._scan_expr(sub, awaited=False)

    def _scan_call(self, call: ast.Call, awaited: bool) -> bool:
        """Record this call's events; True when the call form was fully
        consumed (its arguments already handled)."""
        fn = self.fn
        held = tuple(self.active)
        name = dotted_name(call.func) or ""
        terminal = name.rsplit(".", 1)[-1] if name else ""
        # Explicit acquire: <lock>.acquire() holds to end of function.
        if (
            isinstance(call.func, ast.Attribute)
            and call.func.attr == "acquire"
        ):
            lock = self._lock_of(call.func.value)
            if lock is not None:
                fn.acquires.append((lock, call.lineno, held))
                if lock not in self.active:
                    self.active.append(lock)
                return True
        # ExitStack.enter_context(<lock>): same sticky semantics.
        if (
            isinstance(call.func, ast.Attribute)
            and call.func.attr == "enter_context"
            and call.args
        ):
            lock = self._lock_of(call.args[0])
            if lock is not None:
                fn.acquires.append((lock, call.lineno, held))
                if lock not in self.active:
                    self.active.append(lock)
                return True
        # run_in_executor(pool, fn, ...) / Thread(target=fn): the
        # referenced functions run on a thread, not here.
        if terminal == "run_in_executor":
            for arg in call.args[1:2]:
                ref = dotted_name(arg)
                if ref:
                    self.ctx.thread_entries.add(ref.rsplit(".", 1)[-1])
            for arg in call.args[2:]:
                self._scan_expr(arg)
            return True
        if terminal == "Thread":
            for kw in call.keywords:
                if kw.arg == "target":
                    ref = dotted_name(kw.value)
                    if ref:
                        self.ctx.thread_entries.add(
                            ref.rsplit(".", 1)[-1]
                        )
        if terminal in LOOP_AFFINE:
            fn.loop_affine.append((name, call.lineno))
        # Blocking taxonomy (name-based; receiver-independent).
        if self.ctx.spec is not None and name:
            for kind in sorted(self.ctx.spec.kinds_of(name)):
                fn.blocks.append(
                    (kind, name, call.lineno, held, awaited)
                )
        # Call-graph edge spec.
        if isinstance(call.func, ast.Name):
            fn.calls.append(
                (("bare", call.func.id), call.lineno, held, awaited)
            )
        elif isinstance(call.func, ast.Attribute):
            recv_self = (
                isinstance(call.func.value, ast.Name)
                and call.func.value.id == "self"
            )
            fn.calls.append(
                (
                    ("self" if recv_self else "attr", call.func.attr),
                    call.lineno,
                    held,
                    awaited,
                )
            )
        return False

    # -- statement walk -------------------------------------------- #

    def scan(self, body: Sequence[ast.stmt]) -> None:
        self._walk(body)

    def _walk(self, stmts: Sequence[ast.stmt]) -> None:
        from .common import attached_exprs, child_stmt_lists

        for stmt in stmts:
            if isinstance(
                stmt,
                (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef),
            ):
                continue  # separate scopes, scanned on their own
            if isinstance(stmt, (ast.With, ast.AsyncWith)):
                pushed: List[str] = []
                for item in stmt.items:
                    lock = (
                        self._lock_of(item.context_expr)
                        if isinstance(stmt, ast.With)
                        else None
                    )
                    if lock is not None:
                        self.fn.acquires.append(
                            (lock, stmt.lineno, tuple(self.active))
                        )
                        self.active.append(lock)
                        pushed.append(lock)
                        if self.fn.is_async and _contains_await(
                            stmt.body
                        ):
                            self.fn.lock_across_await.append(
                                (lock, stmt.lineno)
                            )
                    else:
                        self._scan_expr(item.context_expr)
                self._walk(stmt.body)
                for lock in reversed(pushed):
                    self.active.remove(lock)
                continue
            for expr in attached_exprs(stmt):
                self._scan_expr(expr)
            for block in child_stmt_lists(stmt):
                self._walk(block)


def _contains_await(stmts: Sequence[ast.stmt]) -> bool:
    """Any await/async-for/async-with in these statements, NOT counting
    nested function bodies (those run later, elsewhere)."""
    stack: List[ast.AST] = list(stmts)
    while stack:
        node = stack.pop()
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        if isinstance(node, (ast.Await, ast.AsyncFor, ast.AsyncWith)):
            return True
        stack.extend(ast.iter_child_nodes(node))
    return False


# ----------------------------------------------------------------- #
# Model build


class _BuildCtx:
    """Shared lookups the scanner needs while the model is being
    assembled."""

    def __init__(self, spec: Optional[LockSpec]) -> None:
        self.spec = spec
        self.lock_ids: Set[str] = set()
        self.locks_by_attr: Dict[str, List[str]] = {}
        self.aliases: Dict[Tuple[str, str], str] = {}
        self.thread_entries: Set[str] = set()


_MODEL_MEMO: Dict[str, Tuple[tuple, Model]] = {}


def _tree_stamp(root: Path) -> tuple:
    out = []
    for rel in iter_py_files(root, SCAN_DIR):
        p = root / rel
        try:
            st = p.stat()
        except OSError:
            continue
        out.append((rel, st.st_mtime_ns, st.st_size))
    toml = root / LOCKORDER_REL
    if toml.exists():
        st = toml.stat()
        out.append((LOCKORDER_REL, st.st_mtime_ns, st.st_size))
    return tuple(out)


def build_model(root) -> Model:
    """Build (or reuse) the concurrency model for a tree."""
    root = Path(root).resolve()
    stamp = _tree_stamp(root)
    memo = _MODEL_MEMO.get(str(root))
    if memo is not None and memo[0] == stamp:
        return memo[1]

    spec = load_lockspec(root)
    modules: Dict[str, PyModule] = {}
    for rel in iter_py_files(root, SCAN_DIR):
        try:
            modules[rel] = PyModule.load(root, rel)
        except (OSError, SyntaxError):
            continue

    created, cond_aliases = discover_locks(modules)
    ctx = _BuildCtx(spec)
    ctx.aliases.update(cond_aliases)
    if spec is not None:
        ctx.aliases.update(spec.aliases)
        ctx.lock_ids = set(spec.decls) | set(created)
    else:
        ctx.lock_ids = set(created)
    # Only locks with a declared rank participate in resolution-by-attr
    # (undeclared discoveries surface as lock-unranked instead).
    for lock_id in sorted(ctx.lock_ids):
        attr = lock_id.rsplit(".", 1)[-1]
        ctx.locks_by_attr.setdefault(attr, []).append(lock_id)

    model = Model(
        root=root,
        spec=spec,
        modules=modules,
        fns={},
        by_name={},
        by_cls={},
        created=created,
        thread_entries=ctx.thread_entries,
    )

    for rel, mod in modules.items():
        for node in ast.walk(mod.tree):
            if not isinstance(
                node, (ast.FunctionDef, ast.AsyncFunctionDef)
            ):
                continue
            qual = mod.qualname(node)
            fid = f"{rel}::{qual}"
            # Innermost enclosing *class*: `self` resolution — nested
            # defs inherit the enclosing class through the closure.
            cls = _enclosing_class(mod, node)
            fn = FnInfo(
                fid=fid,
                rel=rel,
                cls=cls,
                name=node.name,
                qualname=f"{rel}:{qual}",
                node=node,
                is_async=isinstance(node, ast.AsyncFunctionDef),
            )
            model.fns[fid] = fn
            model.by_name.setdefault(node.name, []).append(fid)
            model.by_cls.setdefault((cls, node.name), []).append(fid)
            scanner = _Scanner(ctx, mod, fn)
            scanner.scan(node.body)

    model.compute_closures()
    if len(_MODEL_MEMO) > 8:  # fixture trees churn; keep this bounded
        _MODEL_MEMO.clear()
    _MODEL_MEMO[str(root)] = (stamp, model)
    return model


def _enclosing_class(mod: PyModule, node: ast.AST) -> str:
    """Innermost ClassDef name on the parent chain ("" when none)."""
    mod.qualname(node)  # ensure parent map built
    cur = mod._parents.get(id(node))
    while cur is not None:
        if isinstance(cur, ast.ClassDef):
            return cur.name
        cur = mod._parents.get(id(cur))
    return ""
