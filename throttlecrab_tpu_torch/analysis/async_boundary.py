"""Async/thread boundary hygiene.

The serving stack is one event loop over a pool of device/driver
threads; the boundary rules this checker pins:

  * ``async-lock-await``   — a *threading* lock held across ``await``:
    the coroutine parks holding the lock, every thread needing it
    wedges, and the loop may deadlock against its own executor.
  * ``async-lock-acquire`` — a ranked lock without ``async_ok = 1``
    acquired (directly or through resolved sync callees) inside an
    ``async def``: device/cluster locks are held for milliseconds by
    design, and a contended acquire stalls the whole event loop, not
    one request.  Leaf pure-math locks (deny cache, metrics…) declare
    ``async_ok = 1`` in lockorder.toml.
  * ``async-blocking-call`` — a blocking-taxonomy call (net / device /
    sleep / wait / io / subprocess) executed on the loop instead of
    via ``run_in_executor``.  Awaited expressions are exempt
    (``await asyncio.sleep`` is the point), and functions *referenced*
    as executor arguments are never treated as called here.
  * ``async-loop-affinity`` — loop-affine asyncio APIs
    (``get_running_loop``, ``create_task``, ``call_soon``, …) invoked
    from thread context: functions passed to ``run_in_executor`` /
    ``Thread(target=…)`` (and ``run()`` methods of Thread subclasses),
    plus their resolved sync callees.

Transitive traversal never descends into ``async def`` callees — an
async callee's body is its own direct finding surface, so each defect
reports exactly once, at its source.
"""

from __future__ import annotations

import ast
from collections import deque
from pathlib import Path
from typing import List, Set

from .blocking import blocks_pred
from .common import Finding, pragma_codes
from .concurrency import SCAN_DIR, build_model

LOCK_AWAIT = "async-lock-await"
LOCK_ACQUIRE = "async-lock-acquire"
BLOCKING = "async-blocking-call"
LOOP_AFFINITY = "async-loop-affinity"


def check(root) -> List[Finding]:
    root = Path(root)
    if not (root / SCAN_DIR).is_dir():
        return []
    model = build_model(root)
    if model.spec is None:
        return []
    spec = model.spec
    findings: List[Finding] = []
    seen = set()

    def emit(code, fn, line, message):
        key = (code, fn.rel, line, message)
        if key in seen:
            return
        seen.add(key)
        mod = model.modules[fn.rel]
        if code in pragma_codes(mod.lines, line):
            return
        findings.append(
            Finding(
                code=code,
                path=fn.rel,
                line=line,
                symbol=mod.qualname(fn.node),
                message=message,
            )
        )

    def sync_callees(fn) -> list:
        """Resolved non-async callees with their call lines."""
        out = []
        for spec_t, line, _held, awaited in fn.calls:
            callee = model.resolve(spec_t, fn.rel, fn.cls, awaited)
            if callee is not None and not model.fns[callee].is_async:
                out.append((callee, line))
        return out

    # ---- async-context rules -------------------------------------- #
    for fid, fn in sorted(model.fns.items()):
        if not fn.is_async:
            continue
        for lock, line in fn.lock_across_await:
            emit(
                LOCK_AWAIT,
                fn,
                line,
                f"threading lock {lock} held across `await` — the "
                "coroutine parks holding it and every thread needing "
                "it wedges; restructure so the lock never spans a "
                "suspension point",
            )
        for lock, line, _held in fn.acquires:
            decl = spec.decls.get(lock)
            if decl is not None and not decl.async_ok:
                emit(
                    LOCK_ACQUIRE,
                    fn,
                    line,
                    f"ranked lock {lock} acquired inside `async def` "
                    f"{fn.name} — a contended acquire stalls the whole "
                    "event loop; move the work to run_in_executor (or "
                    "declare async_ok in lockorder.toml with an audit)",
                )
        for kind, call, line, _held, awaited in fn.blocks:
            if awaited or _coroutine_shaped(model, kind, call):
                continue
            emit(
                BLOCKING,
                fn,
                line,
                f"blocking call `{call}` ({kind}) inside `async def` "
                f"{fn.name} runs on the event loop — route it through "
                "run_in_executor",
            )
        # Transitive: resolved sync callees executed on the loop.
        for callee, line in sync_callees(fn):
            for lock in sorted(model.closure_acq[callee]):
                decl = spec.decls.get(lock)
                if decl is None or decl.async_ok:
                    continue
                chain = model.witness(callee, _acq_pred(model, lock))
                via = (
                    " (via " + " -> ".join(chain) + ")" if chain else ""
                )
                emit(
                    LOCK_ACQUIRE,
                    fn,
                    line,
                    f"ranked lock {lock} acquired on the event loop"
                    f"{via} — a contended acquire stalls every "
                    "connection; move the call to run_in_executor",
                )
            for kind, call in sorted(model.closure_blk[callee]):
                if _coroutine_shaped(model, kind, call):
                    continue
                chain = model.witness(
                    callee, blocks_pred(model, kind, call)
                )
                via = (
                    " (via " + " -> ".join(chain) + ")" if chain else ""
                )
                emit(
                    BLOCKING,
                    fn,
                    line,
                    f"blocking call `{call}` ({kind}) reachable on the "
                    f"event loop{via} — route it through "
                    "run_in_executor",
                )

    # ---- thread-context rule (loop-affine APIs) ------------------- #
    thread_fids: Set[str] = set()
    queue = deque()
    for name in sorted(model.thread_entries):
        fids = model.by_name.get(name, [])
        if len(fids) == 1 and not model.fns[fids[0]].is_async:
            queue.append(fids[0])
    for fid, fn in model.fns.items():
        if fn.name == "run" and _subclasses_thread(model, fn):
            queue.append(fid)
    while queue:
        fid = queue.popleft()
        if fid in thread_fids:
            continue
        thread_fids.add(fid)
        for callee in model.callees(fid):
            if not model.fns[callee].is_async:
                queue.append(callee)

    for fid in sorted(thread_fids):
        fn = model.fns[fid]
        for name, line in fn.loop_affine:
            emit(
                LOOP_AFFINITY,
                fn,
                line,
                f"loop-affine asyncio API `{name}` invoked from thread "
                "context (this function runs on an executor/Thread) — "
                "use the *_threadsafe variants or hand the work back "
                "to the loop",
            )

    findings.sort(key=lambda f: (f.path, f.line, f.message))
    return findings


def _acq_pred(model, lock_id):
    def pred(fid):
        return any(a[0] == lock_id for a in model.fns[fid].acquires)

    return pred


def _coroutine_shaped(model, kind: str, call: str) -> bool:
    """Inside ``async def``, a name that is also an async method in
    the package (``connect``, ``throttle``) or a bare ``.wait()`` /
    ``wait_for`` is almost certainly an asyncio coroutine being built
    for gather/wait_for — not a blocking call.  Only those two
    terminal names earn the wait-kind exemption: ``Future.result()``
    shares the kind and must STAY visible (an executor wait on the
    loop is exactly the wedge class this checker ratchets).  The
    sync-context blocking checker keeps the full taxonomy."""
    terminal = call.rsplit(".", 1)[-1]
    if kind == "wait" and terminal in ("wait", "wait_for"):
        return True
    return any(
        model.fns[f].is_async
        for f in model.by_name.get(terminal, [])
    )


def _subclasses_thread(model, fn) -> bool:
    """Does fn's enclosing class subclass threading.Thread?"""
    mod = model.modules[fn.rel]
    for node in ast.walk(mod.tree):
        if isinstance(node, ast.ClassDef) and node.name == fn.cls:
            for base in node.bases:
                name = ""
                if isinstance(base, ast.Name):
                    name = base.id
                elif isinstance(base, ast.Attribute):
                    name = base.attr
                if name == "Thread":
                    return True
    return False
