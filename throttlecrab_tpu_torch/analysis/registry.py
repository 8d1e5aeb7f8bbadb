"""Knob and metric registry consistency for the port.

Two user-facing name surfaces accrete silently:

  * **Knobs** — every ``THROTTLECRAB_*`` environment variable the
    port reads (the ``server/config.py`` ``_SPEC`` table plus ad-hoc
    ``os.environ`` reads) must be documented: in README.md, which the
    port shares with the JAX package, or in the port's own
    ``throttlecrab_tpu_torch/KNOBS.md`` for the knobs only the port
    reads.  An undocumented knob is operationally invisible —
    deployments can't set what they can't find (``knob-undocumented``).
    Port-only knobs live in the package's file rather than README.md
    because the JAX suite holds README.md to the knobs *it* reads.
  * **Metrics** — every ``throttlecrab_*`` metric name emitted anywhere
    in the package must appear in the ``METRIC_NAMES`` registry in
    ``server/metrics.py`` (``metric-unregistered``), and every registry
    entry must still be emitted somewhere (``metric-stale``) — the
    registry is the dashboard contract, so both directions are drift.
  * **Flag ↔ knob parity** — every CLI flag row in ``server/config.py``
    ``_SPEC`` must pair with its canonically-derived env knob
    (``--cluster-vnodes`` ↔ ``THROTTLECRAB_CLUSTER_VNODES``); a row
    whose env name diverges from the flag name is
    ``flag-knob-mismatch``.  And the reverse direction: every
    ``THROTTLECRAB_*`` name the port's own doc (KNOBS.md) promises must
    still be read somewhere in the port (``knob-stale``) — the
    README's knobs of the JAX package (``THROTTLECRAB_PALLAS`` …) are
    that package's to keep, not the port's.  Wildcard doc references
    (``THROTTLECRAB_*``) are prose, not knobs, and are skipped.

String literals are collected from the AST (full-string matches only,
so prose mentions inside docstrings don't count as reads), including
the constant heads of f-strings for labeled metrics like
``throttlecrab_requests_by_transport{transport="…"}``.
"""

from __future__ import annotations

import ast
import re
from pathlib import Path
from typing import Dict, List, Optional, Set, Tuple

from .common import Finding, PyModule, iter_py_files

KNOB_UNDOCUMENTED = "knob-undocumented"
KNOB_STALE = "knob-stale"
FLAG_KNOB_MISMATCH = "flag-knob-mismatch"
METRIC_UNREGISTERED = "metric-unregistered"
METRIC_STALE = "metric-stale"
REGISTRY_MISSING = "metric-registry-missing"

PACKAGE_DIR = "throttlecrab_tpu_torch"
METRICS_PY = "throttlecrab_tpu_torch/server/metrics.py"
CONFIG_PY = "throttlecrab_tpu_torch/server/config.py"
#: The port's own knob doc: what it promises is held both ways.
PORT_DOC = "throttlecrab_tpu_torch/KNOBS.md"
DOC_FILES = ("README.md", PORT_DOC)

#: A documented knob reference: full env-var name NOT followed by a
#: wildcard (`THROTTLECRAB_CLUSTER_*` is prose for a family).
_DOC_KNOB = re.compile(r"THROTTLECRAB_[A-Z0-9_]*[A-Z0-9](?![A-Z0-9_*])")

_KNOB = re.compile(r"^THROTTLECRAB_[A-Z0-9_]+$")
_METRIC = re.compile(r"^throttlecrab_[a-z0-9_]+")

#: Strings that match the metric shape but are not metrics.
_METRIC_IGNORE = {"throttlecrab_tpu", "throttlecrab_tpu_torch", "throttlecrab"}


def _is_metric_name(name: str) -> bool:
    if name in _METRIC_IGNORE or "_pb2" in name:
        return False
    return _METRIC.match(name) is not None


def _collect_strings(
    mod: PyModule,
) -> Tuple[Dict[str, int], Dict[str, List[int]]]:
    """(knobs name -> first line, metrics name -> all lines)."""
    knobs: Dict[str, int] = {}
    metrics: Dict[str, List[int]] = {}
    # Docstrings are prose, not emissions: a doc line starting with a
    # metric name must not mask a stale registry entry.  f-string
    # constant parts are handled by the JoinedStr branch below, not as
    # standalone constants.
    skip = set()
    for node in ast.walk(mod.tree):
        if isinstance(
            node,
            (ast.Module, ast.ClassDef, ast.FunctionDef, ast.AsyncFunctionDef),
        ):
            body = node.body
            if (
                body
                and isinstance(body[0], ast.Expr)
                and isinstance(body[0].value, ast.Constant)
                and isinstance(body[0].value.value, str)
            ):
                skip.add(id(body[0].value))
        elif isinstance(node, ast.JoinedStr):
            skip.update(id(v) for v in node.values)
    for node in ast.walk(mod.tree):
        if id(node) in skip:
            continue
        if isinstance(node, ast.Constant) and isinstance(node.value, str):
            value = node.value
            if _KNOB.match(value):
                knobs.setdefault(value, node.lineno)
            m = _METRIC.match(value)
            # A metric emission literal is the bare name, or the name
            # followed by a label block or sample value ("name{…}",
            # "name 5"); prose never starts with the name.
            if (
                m
                and (
                    m.end() == len(value)
                    or value[m.end()] in " {"
                )
                and _is_metric_name(m.group(0))
            ):
                metrics.setdefault(m.group(0), []).append(node.lineno)
        elif isinstance(node, ast.JoinedStr):
            # f'throttlecrab_x{{label="{v}"}} {count}': the constant
            # head carries the metric name.
            head = node.values[0] if node.values else None
            if isinstance(head, ast.Constant) and isinstance(
                head.value, str
            ):
                m = _METRIC.match(head.value)
                # Emission f-strings carry a label block right after
                # the name (`f'name{{label="{v}"}} …'` → literal `{`
                # in the constant head) or interpolate immediately;
                # a space boundary here is prose, unlike in plain
                # constants where "name 5" is a sample line.
                if (
                    m
                    and (
                        m.end() == len(head.value)
                        or head.value[m.end()] == "{"
                    )
                    and _is_metric_name(m.group(0))
                ):
                    metrics.setdefault(m.group(0), []).append(
                        node.lineno
                    )
    return knobs, metrics


def _registry(mod: PyModule) -> Tuple[Set[str], int, int]:
    """(names, first_line, last_line) of the METRIC_NAMES assignment in
    server/metrics.py; empty set when absent."""
    for stmt in mod.tree.body:
        if isinstance(stmt, ast.Assign) and any(
            isinstance(t, ast.Name) and t.id == "METRIC_NAMES"
            for t in stmt.targets
        ):
            names = {
                n.value
                for n in ast.walk(stmt.value)
                if isinstance(n, ast.Constant)
                and isinstance(n.value, str)
            }
            return names, stmt.lineno, stmt.end_lineno or stmt.lineno
    return set(), 0, 0


def _spec_rows(mod: PyModule) -> List[Tuple[str, str, int]]:
    """(flag name, env name, line) rows of the config.py _SPEC table."""
    rows: List[Tuple[str, str, int]] = []
    for stmt in mod.tree.body:
        if not (
            isinstance(stmt, ast.Assign)
            and any(
                isinstance(t, ast.Name) and t.id == "_SPEC"
                for t in stmt.targets
            )
            and isinstance(stmt.value, ast.List)
        ):
            continue
        for elt in stmt.value.elts:
            if not isinstance(elt, ast.Tuple) or len(elt.elts) < 2:
                continue
            name_n, env_n = elt.elts[0], elt.elts[1]
            if (
                isinstance(name_n, ast.Constant)
                and isinstance(name_n.value, str)
                and isinstance(env_n, ast.Constant)
                and isinstance(env_n.value, str)
            ):
                rows.append((name_n.value, env_n.value, elt.lineno))
    return rows


def check(root) -> List[Finding]:
    root = Path(root)
    findings: List[Finding] = []

    knob_sites: Dict[str, Tuple[str, int]] = {}
    metric_occ: Dict[str, List[Tuple[str, int]]] = {}
    metrics_mod: Optional[PyModule] = None
    config_mod: Optional[PyModule] = None
    for rel in iter_py_files(root, PACKAGE_DIR):
        try:
            mod = PyModule.load(root, rel)
        except (OSError, SyntaxError):
            continue
        if rel == METRICS_PY:
            metrics_mod = mod
        if rel == CONFIG_PY:
            config_mod = mod
        knobs, metrics = _collect_strings(mod)
        for name, line in knobs.items():
            knob_sites.setdefault(name, (rel, line))
        for name, lines in metrics.items():
            metric_occ.setdefault(name, []).extend(
                (rel, line) for line in lines
            )

    # ---- knobs vs docs ------------------------------------------- #
    docs = ""
    doc_knob_lines: Dict[str, Tuple[str, int]] = {}
    for doc in DOC_FILES:
        path = root / doc
        if path.exists():
            text = path.read_text()
            docs += text
            if doc != PORT_DOC:
                continue
            for n, line in enumerate(text.splitlines(), 1):
                for m in _DOC_KNOB.finditer(line):
                    doc_knob_lines.setdefault(m.group(0), (doc, n))
    for name in sorted(knob_sites):
        rel, line = knob_sites[name]
        # Word-boundary match: THROTTLECRAB_HTTP must not count as
        # documented just because THROTTLECRAB_HTTP_BACKEND is.
        if not re.search(re.escape(name) + r"(?![A-Z0-9_])", docs):
            findings.append(
                Finding(
                    code=KNOB_UNDOCUMENTED,
                    path=rel,
                    line=line,
                    message=(
                        f"knob {name} is read here but documented in "
                        f"neither {' nor '.join(DOC_FILES)}"
                    ),
                )
            )
    # Reverse direction: a documented knob nobody reads misconfigures
    # every deployment that trusts the docs.
    for name in sorted(set(doc_knob_lines) - set(knob_sites)):
        doc, line = doc_knob_lines[name]
        findings.append(
            Finding(
                code=KNOB_STALE,
                path=doc,
                line=line,
                message=(
                    f"documented knob {name} is never read anywhere "
                    "in the package — stale documentation (or a "
                    "dropped knob that deployments may still set)"
                ),
            )
        )

    # ---- CLI-flag <-> env-knob parity (config._SPEC) -------------- #
    if config_mod is not None:
        for flag, env, line in _spec_rows(config_mod):
            want = "THROTTLECRAB_" + flag.upper()
            if env != want:
                findings.append(
                    Finding(
                        code=FLAG_KNOB_MISMATCH,
                        path=CONFIG_PY,
                        line=line,
                        message=(
                            f"flag --{flag.replace('_', '-')} pairs "
                            f"with env knob {env}, but the canonical "
                            f"derivation is {want} — a flag whose knob "
                            "diverges breaks the CLI>env>default "
                            "precedence contract both directions"
                        ),
                    )
                )

    # ---- metrics vs registry ------------------------------------- #
    if metrics_mod is None:
        findings.append(
            Finding(
                code=REGISTRY_MISSING,
                path=METRICS_PY,
                line=1,
                message="server/metrics.py unreadable (metric registry)",
            )
        )
        return findings
    registry, reg_first, reg_last = _registry(metrics_mod)
    if not registry:
        findings.append(
            Finding(
                code=REGISTRY_MISSING,
                path=METRICS_PY,
                line=1,
                message=(
                    "METRIC_NAMES registry not found in "
                    "server/metrics.py"
                ),
            )
        )
        return findings

    def outside_registry(site: Tuple[str, int]) -> bool:
        rel, line = site
        return rel != METRICS_PY or not reg_first <= line <= reg_last

    for name in sorted(metric_occ):
        sites = [s for s in metric_occ[name] if outside_registry(s)]
        if sites and name not in registry:
            rel, line = sites[0]
            findings.append(
                Finding(
                    code=METRIC_UNREGISTERED,
                    path=rel,
                    line=line,
                    message=(
                        f"metric {name} is emitted here but missing "
                        "from the METRIC_NAMES registry "
                        "(server/metrics.py)"
                    ),
                )
            )
    emitted = {
        name
        for name, sites in metric_occ.items()
        if any(outside_registry(s) for s in sites)
    }
    for name in sorted(registry - emitted):
        findings.append(
            Finding(
                code=METRIC_STALE,
                path=METRICS_PY,
                line=reg_first,
                message=(
                    f"registry entry {name} is never emitted anywhere "
                    "in the package"
                ),
            )
        )
    return findings
