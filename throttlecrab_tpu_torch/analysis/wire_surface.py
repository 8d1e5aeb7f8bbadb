"""Wire-frame exhaustiveness and decode-hardening contracts of the port.

The port's cluster wire protocol (``parallel/cluster.py``) and trace
codec (``replay/trace.py``) are hand-wired surfaces: every frame kind
needs an encoder, a decoder, a dispatch arm, and a mutation case, and
every decoder must uphold the hardening contract the RPC port promises
(count-vs-size before allocation, typed rejection, no trailing bytes).
This module makes both contracts mechanical:

``check_surface`` (codes ``wire-*``) — exhaustiveness:

  * every ``OP_*`` constant is a key of ``FRAME_DECODERS`` (the
    protocol's single source of truth, which the frame fuzzer also
    consumes at runtime), and every entry maps to a real top-level
    ``decode_*`` function;
  * every top-level ``decode_*`` function is reachable from the table
    — an orphan decoder is dead wire surface;
  * every op has encoder evidence (the name appears inside an
    ``encode_*`` function or as an argument to an ``encode_*`` call)
    and dispatch evidence (a compare or membership tuple inside some
    function);
  * every op has a mutation arm in each of the port's fuzzers: the
    op-keyed ``MUTATION_ARMS`` table of its codec mutation cases
    (``tests/test_torch_cluster_codec.py``: truncations at every
    length, trailing bytes and inflated counts, refused as the JAX
    package refuses them) and the ``makers`` table of the port's
    campaign's cluster-frame arm (``tools/fuzz_wire_tiers.py``, as
    JAX's checker reads ``scripts/fuzz_wire_tiers.py``) each cover
    exactly the declared ops;
  * membership ops (``OP_JOIN``/``OP_LEAVE``) are recorded as trace
    events in cluster.py AND replayed by the trace player's
    ``apply_event`` arms;
  * the same ladder for trace frame kinds: ``REC_*`` vs ``_DECODERS``,
    encoders, compare dispatch, and mutation coverage by the port's
    malformed-trace cases (``tests/test_torch_replay.py``) and the
    campaign's trace-frame arm: a kind is covered when each reaches its
    decoder or the table.

``check_hardening`` (codes ``harden-*``) — per top-level ``decode_*``
function, detected structurally from the AST:

  * ``harden-guard``: a ``len(body)``-checking raise-guard dominates
    the first unpack site (struct.error cannot escape);
  * ``harden-count``: every allocation sized by an unpacked count
    (``np.empty``/``np.zeros``/``np.frombuffer``/``range``) is
    dominated by a raise-guard that mentions that count;
  * ``harden-trailing``: the function rejects trailing bytes (an
    ``==``/``!=`` compare against ``len(body)``) or delegates its tail
    to another ``decode_*`` that does;
  * ``harden-typed``: every ``raise`` inside a decoder raises the
    module's typed error (``ClusterProtocolError``/``TraceError``).

``wire-missing`` marks an anchor file or table that could not be read
or extracted — extraction failure is loud, never a silent pass.
"""

from __future__ import annotations

import ast
from pathlib import Path
from typing import Dict, List, Optional, Set, Tuple

from .common import Finding, PyModule, names_in

MISSING = "wire-missing"
DECODER = "wire-decoder"
ENCODER = "wire-encoder"
DISPATCH = "wire-dispatch"
FUZZ = "wire-fuzz"
REPLAYER = "wire-replayer"
ORPHAN = "wire-orphan"

GUARD = "harden-guard"
COUNT = "harden-count"
TRAILING = "harden-trailing"
TYPED = "harden-typed"

CLUSTER = "throttlecrab_tpu_torch/parallel/cluster.py"
TRACE = "throttlecrab_tpu_torch/replay/trace.py"
PLAYER = "throttlecrab_tpu_torch/replay/player.py"
CAMPAIGN = "throttlecrab_tpu_torch/tools/fuzz_wire_tiers.py"
#: frame-family prefix -> the port's fuzzers of that family: its mutation
#: cases and the campaign's frame arm.
FUZZERS = {
    "OP_": ("tests/test_torch_cluster_codec.py", CAMPAIGN),
    "REC_": ("tests/test_torch_replay.py", CAMPAIGN),
}

#: membership op -> the trace event kind that must be recorded on the
#: cluster side and handled by ClusterReplayer.apply_event.
MEMBERSHIP_EVENTS = {"OP_JOIN": "cluster-join", "OP_LEAVE": "cluster-leave"}

TYPED_ERRORS = {CLUSTER: "ClusterProtocolError", TRACE: "TraceError"}


# ----------------------------------------------------------------- #
# shared extraction


def _load(root: Path, rel: str, findings: List[Finding]) -> Optional[PyModule]:
    try:
        return PyModule.load(root, rel)
    except (OSError, SyntaxError):
        findings.append(Finding(MISSING, rel, 1, "anchor file unreadable"))
        return None


def _const_names(mod: PyModule, prefix: str) -> Dict[str, int]:
    """Module-level ``PREFIX_X = <int>`` assignments -> {name: line}."""
    out: Dict[str, int] = {}
    for stmt in mod.tree.body:
        if not isinstance(stmt, ast.Assign):
            continue
        for t in stmt.targets:
            if isinstance(t, ast.Name) and t.id.startswith(prefix):
                out[t.id] = stmt.lineno
    return out


def _top_functions(mod: PyModule) -> Dict[str, ast.FunctionDef]:
    return {
        s.name: s
        for s in mod.tree.body
        if isinstance(s, ast.FunctionDef)
    }


def _decoder_table(
    mod: PyModule, table_name: str
) -> Optional[Tuple[Dict[str, str], int]]:
    """Parse ``TABLE = {OP_NAME: ... decode_fn ...}`` ->
    ({op_name: decoder_name}, line).  The value may be the decoder Name
    itself (trace ``_DECODERS``) or a tuple containing it
    (``FRAME_DECODERS``)."""
    for stmt in mod.tree.body:
        if not (
            isinstance(stmt, ast.Assign)
            and any(
                isinstance(t, ast.Name) and t.id == table_name
                for t in stmt.targets
            )
            and isinstance(stmt.value, ast.Dict)
        ):
            continue
        entries: Dict[str, str] = {}
        for k, v in zip(stmt.value.keys, stmt.value.values):
            key = k.id if isinstance(k, ast.Name) else ""
            dec = ""
            for n in ast.walk(v):
                if isinstance(n, ast.Name) and n.id.startswith("decode"):
                    dec = n.id
                    break
            entries[key] = dec
        return entries, stmt.lineno
    return None


def _names_in_encoders(mod: PyModule) -> Set[str]:
    """Names referenced inside encode_* defs or as args of encode_* calls."""
    out: Set[str] = set()
    for fn in _top_functions(mod).values():
        if fn.name.startswith("encode"):
            out |= names_in(fn)
    for node in ast.walk(mod.tree):
        if isinstance(node, ast.Call):
            f = node.func
            callee = f.id if isinstance(f, ast.Name) else (
                f.attr if isinstance(f, ast.Attribute) else ""
            )
            if callee.startswith("encode"):
                for a in node.args:
                    out |= names_in(a)
    return out


def _dispatch_names(mod: PyModule) -> Set[str]:
    """Names used in compares or tuple/list literals inside functions."""
    out: Set[str] = set()
    for fn in ast.walk(mod.tree):
        if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        for node in ast.walk(fn):
            if isinstance(node, (ast.Compare, ast.Tuple, ast.List)):
                out |= names_in(node)
    return out


def _fuzz_op_keys(mod: PyModule, prefix: str) -> Set[str]:
    """Union of ``PREFIX_*`` names used as dict-literal keys anywhere in
    the fuzzer — the op-keyed maker table(s)."""
    out: Set[str] = set()
    for node in ast.walk(mod.tree):
        if isinstance(node, ast.Dict):
            for k in node.keys:
                if isinstance(k, ast.Name) and k.id.startswith(prefix):
                    out.add(k.id)
    return out


def _string_compares(mod: PyModule) -> Set[str]:
    out: Set[str] = set()
    for node in ast.walk(mod.tree):
        if isinstance(node, ast.Compare):
            for side in [node.left, *node.comparators]:
                if isinstance(side, ast.Constant) and isinstance(
                    side.value, str
                ):
                    out.add(side.value)
    return out


def _recorded_event_kinds(mod: PyModule) -> Set[str]:
    """First string argument of every maybe_record_event(...) call."""
    out: Set[str] = set()
    for node in ast.walk(mod.tree):
        if not isinstance(node, ast.Call):
            continue
        f = node.func
        callee = f.id if isinstance(f, ast.Name) else (
            f.attr if isinstance(f, ast.Attribute) else ""
        )
        if callee == "maybe_record_event" and node.args:
            a = node.args[0]
            if isinstance(a, ast.Constant) and isinstance(a.value, str):
                out.add(a.value)
    return out


# ----------------------------------------------------------------- #
# exhaustiveness


def _check_frame_family(
    findings: List[Finding],
    mod: PyModule,
    *,
    prefix: str,
    table_name: str,
    fuzzers: List[PyModule],
    fuzz_table_driven: bool,
    dispatch_mods: List[PyModule],
) -> None:
    ops = _const_names(mod, prefix)
    if not ops:
        findings.append(
            Finding(MISSING, mod.rel, 1, f"no {prefix}* constants found")
        )
        return
    table = _decoder_table(mod, table_name)
    if table is None:
        findings.append(
            Finding(
                MISSING, mod.rel, 1,
                f"decoder table {table_name} not found",
            )
        )
        return
    entries, table_line = table
    decoders = {
        n for n in _top_functions(mod) if n.startswith("decode")
    }

    for bad in sorted(set(entries) - set(ops) - {""}):
        findings.append(
            Finding(
                ORPHAN, mod.rel, table_line,
                f"{table_name} key {bad} is not a declared {prefix}* op",
                symbol=table_name,
            )
        )
    if "" in entries:
        findings.append(
            Finding(
                ORPHAN, mod.rel, table_line,
                f"{table_name} has a key that is not an {prefix}* name",
                symbol=table_name,
            )
        )

    enc_names = _names_in_encoders(mod)
    disp_names: Set[str] = set()
    for m in dispatch_mods:
        disp_names |= _dispatch_names(m)
    fuzz_keys = {f.rel: _fuzz_op_keys(f, prefix) for f in fuzzers}
    fuzz_names = {f.rel: names_in(f.tree) for f in fuzzers}

    for op, line in sorted(ops.items()):
        if op not in entries:
            findings.append(
                Finding(
                    DECODER, mod.rel, line,
                    f"{op} has no {table_name} entry (no decoder wired)",
                    symbol=op,
                )
            )
        elif entries[op] not in decoders:
            findings.append(
                Finding(
                    DECODER, mod.rel, line,
                    f"{op} maps to {entries[op] or '<non-name>'} which is "
                    f"not a top-level decode_* function",
                    symbol=op,
                )
            )
        if op not in enc_names:
            findings.append(
                Finding(
                    ENCODER, mod.rel, line,
                    f"{op} has no encoder (never packed by or passed to "
                    f"an encode_* function)",
                    symbol=op,
                )
            )
        if op not in disp_names:
            findings.append(
                Finding(
                    DISPATCH, mod.rel, line,
                    f"{op} has no dispatch arm (no compare or membership "
                    f"tuple references it)",
                    symbol=op,
                )
            )
        for fuzzer in fuzzers:
            covered = (
                op in fuzz_keys[fuzzer.rel]
                if fuzz_table_driven
                else (
                    table_name in fuzz_names[fuzzer.rel]
                    or entries.get(op, "") in fuzz_names[fuzzer.rel]
                )
            )
            if not covered:
                findings.append(
                    Finding(
                        FUZZ, mod.rel, line,
                        f"{op} has no mutation arm in {fuzzer.rel}",
                        symbol=op,
                    )
                )

    # orphan decoders: reachable-from-table is the liveness contract.
    used = {d for d in entries.values() if d}
    for dead in sorted(decoders - used):
        fn = _top_functions(mod)[dead]
        findings.append(
            Finding(
                ORPHAN, mod.rel, fn.lineno,
                f"decoder {dead} is not referenced by {table_name}",
                symbol=dead,
            )
        )

    for fuzzer in fuzzers if fuzz_table_driven else ():
        for bad in sorted(fuzz_keys[fuzzer.rel] - set(ops)):
            findings.append(
                Finding(
                    ORPHAN, fuzzer.rel, 1,
                    f"fuzzer maker key {bad} is not a declared "
                    f"{prefix}* op in {mod.rel}",
                    symbol=bad,
                )
            )


def check_surface(root) -> List[Finding]:
    root = Path(root)
    findings: List[Finding] = []
    cluster = _load(root, CLUSTER, findings)
    trace = _load(root, TRACE, findings)
    player = _load(root, PLAYER, findings)
    fuzzers = {
        p: [m for m in (_load(root, rel, findings) for rel in rels) if m]
        for p, rels in FUZZERS.items()
    }

    if cluster is not None:
        _check_frame_family(
            findings, cluster,
            prefix="OP_", table_name="FRAME_DECODERS",
            fuzzers=fuzzers["OP_"], fuzz_table_driven=True,
            dispatch_mods=[cluster],
        )
        # membership ops must round-trip through the flight recorder:
        # recorded as events on the cluster side, replayed by the
        # player's apply_event arms.
        recorded = _recorded_event_kinds(cluster)
        replayed = _string_compares(player) if player is not None else set()
        ops = _const_names(cluster, "OP_")
        for op, kind in sorted(MEMBERSHIP_EVENTS.items()):
            if op not in ops:
                continue
            if kind not in recorded:
                findings.append(
                    Finding(
                        REPLAYER, CLUSTER, ops[op],
                        f"membership op {op} never records a "
                        f"{kind!r} trace event",
                        symbol=op,
                    )
                )
            if player is not None and kind not in replayed:
                findings.append(
                    Finding(
                        REPLAYER, PLAYER, 1,
                        f"trace player has no apply_event arm for "
                        f"{kind!r} (membership op {op})",
                        symbol=op,
                    )
                )

    if trace is not None:
        _check_frame_family(
            findings, trace,
            prefix="REC_", table_name="_DECODERS",
            fuzzers=fuzzers["REC_"], fuzz_table_driven=False,
            dispatch_mods=[trace] + ([player] if player is not None else []),
        )

    return findings


# ----------------------------------------------------------------- #
# decode hardening


def _callee_name(node: ast.Call) -> str:
    f = node.func
    if isinstance(f, ast.Name):
        return f.id
    if isinstance(f, ast.Attribute):
        return f.attr
    return ""


def _unpack_sites(fn: ast.FunctionDef) -> List[ast.Call]:
    return [
        n
        for n in ast.walk(fn)
        if isinstance(n, ast.Call)
        and _callee_name(n) in ("unpack", "unpack_from")
    ]


def _mentions_len_of(node: ast.AST, param: str) -> bool:
    for n in ast.walk(node):
        if (
            isinstance(n, ast.Call)
            and isinstance(n.func, ast.Name)
            and n.func.id == "len"
            and n.args
            and isinstance(n.args[0], ast.Name)
            and n.args[0].id == param
        ):
            return True
    return False


def _raise_guards(fn: ast.FunctionDef) -> List[ast.If]:
    return [
        n
        for n in ast.walk(fn)
        if isinstance(n, ast.If)
        and any(isinstance(s, ast.Raise) for s in n.body)
    ]


def _tainted_names(fn: ast.FunctionDef) -> Set[str]:
    """Names bound from struct unpack results — attacker-controlled."""
    out: Set[str] = set()
    for node in ast.walk(fn):
        if not isinstance(node, ast.Assign):
            continue
        if not any(
            isinstance(n, ast.Call)
            and _callee_name(n) in ("unpack", "unpack_from")
            for n in ast.walk(node.value)
        ):
            continue
        for t in node.targets:
            for n in ast.walk(t):
                if isinstance(n, ast.Name):
                    out.add(n.id)
    return out


def _alloc_sites(fn: ast.FunctionDef) -> List[Tuple[ast.Call, ast.AST]]:
    """(call, size-expr) for count-sized allocations."""
    out: List[Tuple[ast.Call, ast.AST]] = []
    for node in ast.walk(fn):
        if not isinstance(node, ast.Call):
            continue
        callee = _callee_name(node)
        if callee in ("empty", "zeros", "range") and node.args:
            out.append((node, node.args[0]))
        elif callee == "frombuffer":
            for kw in node.keywords:
                if kw.arg == "count":
                    out.append((node, kw.value))
    return out


def _check_decoder(
    findings: List[Finding], mod: PyModule, fn: ast.FunctionDef, typed: str
) -> None:
    param = fn.args.args[0].arg if fn.args.args else ""
    guards = _raise_guards(fn)
    unpacks = _unpack_sites(fn)

    if unpacks:
        first = min(u.lineno for u in unpacks)
        if not any(
            g.lineno < first and _mentions_len_of(g.test, param)
            for g in guards
        ):
            findings.append(
                Finding(
                    GUARD, mod.rel, fn.lineno,
                    f"no len({param})-checking raise-guard before the "
                    f"first unpack at line {first}",
                    symbol=fn.name,
                )
            )

    tainted = _tainted_names(fn)
    for call, size in _alloc_sites(fn):
        used = names_in(size) & tainted
        if not used:
            continue
        if not any(
            g.lineno < call.lineno and (names_in(g.test) & used)
            for g in guards
        ):
            findings.append(
                Finding(
                    COUNT, mod.rel, call.lineno,
                    f"allocation sized by unpacked count "
                    f"{sorted(used)} with no dominating raise-guard",
                    symbol=fn.name,
                )
            )

    has_exact = any(
        isinstance(n, ast.Compare)
        and any(isinstance(o, (ast.Eq, ast.NotEq)) for o in n.ops)
        and _mentions_len_of(n, param)
        for n in ast.walk(fn)
    )
    delegates = any(
        isinstance(n, ast.Call)
        and _callee_name(n).startswith("decode")
        and any(
            isinstance(m, ast.Name) and m.id == param
            for a in n.args
            for m in ast.walk(a)
        )
        for n in ast.walk(fn)
    )
    if not (has_exact or delegates):
        findings.append(
            Finding(
                TRAILING, mod.rel, fn.lineno,
                f"no trailing-bytes rejection: no ==/!= compare against "
                f"len({param}) and no delegation to another decode_*",
                symbol=fn.name,
            )
        )

    for node in ast.walk(fn):
        if not isinstance(node, ast.Raise) or node.exc is None:
            continue
        name = ""
        if isinstance(node.exc, ast.Call):
            name = _callee_name(node.exc)
        elif isinstance(node.exc, ast.Name):
            name = node.exc.id
        if name != typed:
            findings.append(
                Finding(
                    TYPED, mod.rel, node.lineno,
                    f"decoder raises {name or '<expr>'} instead of the "
                    f"typed {typed}",
                    symbol=fn.name,
                )
            )


def check_hardening(root) -> List[Finding]:
    root = Path(root)
    findings: List[Finding] = []
    for rel, typed in TYPED_ERRORS.items():
        mod = _load(root, rel, findings)
        if mod is None:
            continue
        fns = [
            f
            for n, f in _top_functions(mod).items()
            if n.startswith("decode")
        ]
        if not fns:
            findings.append(
                Finding(MISSING, rel, 1, "no decode_* functions found")
            )
            continue
        for fn in fns:
            _check_decoder(findings, mod, fn, typed)
    return findings
