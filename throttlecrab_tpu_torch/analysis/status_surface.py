"""Status-taxonomy totality across every transport and the C++ twin.

The per-request status taxonomy (``STATUS_*`` in ``tpu/limiter.py``
plus ``STATUS_OVERLOADED`` in ``front/admission.py``) fans out through
five surfaces: the engine's message map and typed exceptions, the HTTP/
gRPC/RESP transports' exception arms, the native in-process driver, and
the C++ ``wire_server.cpp`` responder.  Each was hand-wired — the
HTTP-503-not-500 status mapping was a human review catch.  This checker
makes the totality mechanical so a future status 7 cannot ship
half-wired (the twin-parity extractor pins the *values*; this pins the
*arms*).  The port shares ``native/wire_server.cpp`` with the JAX
package, so it stays the C++ responder here:

  * ``status-message``: every non-OK status is keyed in the engine's
    ``STATUS_MESSAGES`` map (``STATUS_OVERLOADED`` instead requires the
    admission tier's ``OVERLOAD_MESSAGE`` constant — it is raised
    before the engine sees it);
  * ``status-transport``: each transport module has explicit
    ``except`` arms for the full exception ladder
    (``OverloadError``/``DeadlineError``/``ThrottleError``);
  * ``status-native``: the native RESP driver references the statuses
    it must branch on before dispatching to C++, and every ``STATUS_*``
    name it references exists in the canonical taxonomy;
  * ``status-cpp``: every status value except the documented
    ``STATUS_INTERNAL`` fallback appears as a ``status[i] == N`` branch
    at least twice in ``wire_server.cpp`` (once per HTTP and RESP
    responder section), and every value the C++ branches on is a
    declared Python status;
  * ``status-orphan``: two ``STATUS_*`` names sharing one value.

``status-missing`` marks an unreadable anchor — extraction failure is
loud, never a silent pass.
"""

from __future__ import annotations

import ast
import re
from pathlib import Path
from typing import Dict, List, Optional, Set

from .common import Finding, PyModule, strip_cpp_comments
from .twin_drift import _py_consts, _py_str_const

MISSING = "status-missing"
MESSAGE = "status-message"
TRANSPORT = "status-transport"
NATIVE = "status-native"
CPP = "status-cpp"
ORPHAN = "status-orphan"

LIMITER = "throttlecrab_tpu_torch/tpu/limiter.py"
ADMISSION = "throttlecrab_tpu_torch/front/admission.py"
ENGINE = "throttlecrab_tpu_torch/server/engine.py"
WIRE_CPP = "native/wire_server.cpp"
NATIVE_RESP = "throttlecrab_tpu_torch/server/native_redis.py"

TRANSPORTS = (
    "throttlecrab_tpu_torch/server/http.py",
    "throttlecrab_tpu_torch/server/grpc.py",
    "throttlecrab_tpu_torch/server/redis.py",
)

#: the typed-exception ladder every transport must map explicitly.
EXCEPTION_LADDER = ("OverloadError", "DeadlineError", "ThrottleError")

#: statuses with no STATUS_MESSAGES entry by design: OK is success,
#: OVERLOADED is raised by the admission tier (OVERLOAD_MESSAGE) before
#: the engine's completion path ever sees it.
NO_MESSAGE = {"STATUS_OK", "STATUS_OVERLOADED"}

#: the documented C++ fallback: every unrecognized status renders as
#: the internal-error payload, so an explicit branch would be dead code.
CPP_FALLBACK = {"STATUS_INTERNAL"}

#: statuses the native driver must branch on before dispatching to the
#: C++ responder (deadline expiry, admission overload, cache sentinel
#: normalization all happen Python-side).
NATIVE_REQUIRED = {"STATUS_OVERLOADED", "STATUS_DEADLINE", "STATUS_INTERNAL"}

_CPP_BRANCH = re.compile(r"status\[i\]\s*==\s*(\d+)")


def _load(root: Path, rel: str, findings: List[Finding]) -> Optional[PyModule]:
    try:
        return PyModule.load(root, rel)
    except (OSError, SyntaxError):
        findings.append(Finding(MISSING, rel, 1, "anchor file unreadable"))
        return None


def _statuses(
    root: Path, findings: List[Finding]
) -> Dict[str, int]:
    """The canonical taxonomy: STATUS_* consts from limiter + admission."""
    out: Dict[str, int] = {}
    for rel in (LIMITER, ADMISSION):
        mod = _load(root, rel, findings)
        if mod is None:
            continue
        for name, value in _py_consts(mod).items():
            if name.startswith("STATUS_"):
                if name in out and out[name] != value:
                    findings.append(
                        Finding(
                            ORPHAN, rel, 1,
                            f"{name} redeclared with value {value} "
                            f"(elsewhere {out[name]})",
                            symbol=name,
                        )
                    )
                out[name] = value
    if not out:
        findings.append(
            Finding(MISSING, LIMITER, 1, "no STATUS_* constants found")
        )
    by_value: Dict[int, str] = {}
    for name, value in sorted(out.items()):
        if value in by_value:
            findings.append(
                Finding(
                    ORPHAN, LIMITER, 1,
                    f"{name} and {by_value[value]} share status "
                    f"value {value}",
                    symbol=name,
                )
            )
        else:
            by_value[value] = name
    return out


def _dict_keys(mod: PyModule, dict_name: str) -> Set[str]:
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
        return {
            k.id
            for k in stmt.value.keys
            if isinstance(k, ast.Name)
        }
    return set()


def _handler_names(mod: PyModule) -> Set[str]:
    """Exception names with an explicit ``except`` arm anywhere."""
    out: Set[str] = set()
    for node in ast.walk(mod.tree):
        if not isinstance(node, ast.ExceptHandler) or node.type is None:
            continue
        types = (
            node.type.elts
            if isinstance(node.type, ast.Tuple)
            else [node.type]
        )
        for t in types:
            if isinstance(t, ast.Name):
                out.add(t.id)
            elif isinstance(t, ast.Attribute):
                out.add(t.attr)
    return out


def _referenced_statuses(mod: PyModule) -> Set[str]:
    return {
        n.id
        for n in ast.walk(mod.tree)
        if isinstance(n, ast.Name) and n.id.startswith("STATUS_")
    }


def check(root) -> List[Finding]:
    root = Path(root)
    findings: List[Finding] = []
    statuses = _statuses(root, findings)
    if not statuses:
        return findings

    # ---- engine message map -------------------------------------- #
    engine = _load(root, ENGINE, findings)
    if engine is not None:
        keyed = _dict_keys(engine, "STATUS_MESSAGES")
        if not keyed:
            findings.append(
                Finding(
                    MISSING, ENGINE, 1,
                    "STATUS_MESSAGES map not found or empty",
                )
            )
        for name in sorted(set(statuses) - NO_MESSAGE - keyed):
            findings.append(
                Finding(
                    MESSAGE, ENGINE, 1,
                    f"{name} has no STATUS_MESSAGES entry — the engine "
                    f"would report it as a bare internal error",
                    symbol=name,
                )
            )
    if "STATUS_OVERLOADED" in statuses:
        admission = _load(root, ADMISSION, findings)
        if admission is not None and not _py_str_const(
            admission, "OVERLOAD_MESSAGE"
        ):
            findings.append(
                Finding(
                    MESSAGE, ADMISSION, 1,
                    "OVERLOAD_MESSAGE missing: STATUS_OVERLOADED has no "
                    "client-visible message",
                    symbol="STATUS_OVERLOADED",
                )
            )

    # ---- transport exception arms -------------------------------- #
    for rel in TRANSPORTS:
        mod = _load(root, rel, findings)
        if mod is None:
            continue
        handled = _handler_names(mod)
        for exc in EXCEPTION_LADDER:
            if exc not in handled:
                findings.append(
                    Finding(
                        TRANSPORT, rel, 1,
                        f"no except arm for {exc} — its statuses would "
                        f"fall through to a generic 500",
                        symbol=exc,
                    )
                )

    # ---- native driver ------------------------------------------- #
    native = _load(root, NATIVE_RESP, findings)
    if native is not None:
        refs = _referenced_statuses(native)
        for name in sorted(NATIVE_REQUIRED & set(statuses)):
            if name not in refs:
                findings.append(
                    Finding(
                        NATIVE, NATIVE_RESP, 1,
                        f"native driver never references {name} — its "
                        f"pre-dispatch branch is gone",
                        symbol=name,
                    )
                )
        for name in sorted(refs - set(statuses)):
            findings.append(
                Finding(
                    NATIVE, NATIVE_RESP, 1,
                    f"native driver references undeclared status {name}",
                    symbol=name,
                )
            )

    # ---- C++ responder branches ---------------------------------- #
    cpp_path = root / WIRE_CPP
    if not cpp_path.exists():
        findings.append(
            Finding(MISSING, WIRE_CPP, 1, "anchor file unreadable")
        )
        return findings
    text = strip_cpp_comments(cpp_path.read_text())
    branched = {int(m) for m in _CPP_BRANCH.findall(text)}
    counts = {
        v: len([m for m in _CPP_BRANCH.findall(text) if int(m) == v])
        for v in branched
    }
    for name, value in sorted(statuses.items()):
        if name in CPP_FALLBACK:
            continue
        if counts.get(value, 0) < 2:
            findings.append(
                Finding(
                    CPP, WIRE_CPP, 1,
                    f"{name} (= {value}) branched {counts.get(value, 0)} "
                    f"time(s); both the HTTP and RESP responder sections "
                    f"must handle it",
                    symbol=name,
                )
            )
    declared = set(statuses.values())
    for value in sorted(branched - declared):
        findings.append(
            Finding(
                CPP, WIRE_CPP, 1,
                f"C++ responder branches on undeclared status {value}",
            )
        )
    return findings
