"""Fault-site registry consistency: SITES ↔ hooks ↔ errors ↔ docs.

``faults/injector.py`` declares the fault surface as data (``SITES`` /
``MODES``) but the surface itself is spread across the tree: every site
is armed at real call sites (``maybe_fail``/``send_with_faults``),
mapped to the exact exception type the un-injected failure would raise
(``_site_error``), replayed from recorded schedules, and documented in
the README fault-site table, which the port shares with the JAX
package.  Nothing else would catch a hook landing with a typo'd site
string or a site that silently stopped being injected.  Rules:

  * ``fault-site``: ``SITES`` and the set of site strings passed to
    ``maybe_fail``/``send_with_faults`` across the package must be
    bidirectionally equal — a declared-but-never-armed site is dead
    chaos surface, an undeclared string is a typo ``parse_spec`` would
    reject at runtime;
  * ``fault-arm``: every site maps to an explicit typed-error arm in
    ``_site_error`` (its string appears in the function); at most one
    site may ride the documented fallback return, and no arm may name
    an undeclared site;
  * ``fault-mode``: every ``MODES`` entry has a ``spec.mode == ...``
    arm in the armed-fault ``fire`` path, the replay path only names
    declared modes, and ``parse_spec`` validates against ``MODES``;
  * ``fault-doc``: the README fault-site table lists exactly ``SITES``
    (the table the checker reads is the one operators read).

``fault-missing`` marks an unreadable anchor or an unextractable
``SITES``/``MODES`` tuple — extraction failure is loud, never a silent
pass.
"""

from __future__ import annotations

import ast
import re
from pathlib import Path
from typing import Dict, List, Optional, Set, Tuple

from .common import Finding, PyModule, iter_py_files

MISSING = "fault-missing"
SITE = "fault-site"
ARM = "fault-arm"
MODE = "fault-mode"
DOC = "fault-doc"

INJECTOR = "throttlecrab_tpu_torch/faults/injector.py"
README = "README.md"
PACKAGE = "throttlecrab_tpu_torch"

HOOKS = ("maybe_fail", "send_with_faults")

#: README table row: | `site` | ... (first cell is a backticked site).
_DOC_ROW = re.compile(r"^\|\s*`([a-z_]+)`\s*\|")


def _load(root: Path, rel: str, findings: List[Finding]) -> Optional[PyModule]:
    try:
        return PyModule.load(root, rel)
    except (OSError, SyntaxError):
        findings.append(Finding(MISSING, rel, 1, "anchor file unreadable"))
        return None


def _str_tuple(mod: PyModule, name: str) -> Optional[Tuple[str, ...]]:
    for stmt in mod.tree.body:
        if not (
            isinstance(stmt, ast.Assign)
            and any(
                isinstance(t, ast.Name) and t.id == name
                for t in stmt.targets
            )
            and isinstance(stmt.value, (ast.Tuple, ast.List))
        ):
            continue
        vals = []
        for e in stmt.value.elts:
            if not (
                isinstance(e, ast.Constant) and isinstance(e.value, str)
            ):
                return None
            vals.append(e.value)
        return tuple(vals)
    return None


def _callee_name(node: ast.Call) -> str:
    f = node.func
    if isinstance(f, ast.Name):
        return f.id
    if isinstance(f, ast.Attribute):
        return f.attr
    return ""


def _hook_sites(root: Path) -> Dict[str, List[Tuple[str, int]]]:
    """site -> [(rel, line)] over every hook call in the package."""
    out: Dict[str, List[Tuple[str, int]]] = {}
    for rel in iter_py_files(root, PACKAGE):
        if rel == INJECTOR:
            continue
        try:
            mod = PyModule.load(root, rel)
        except (OSError, SyntaxError):
            continue
        for node in ast.walk(mod.tree):
            if not (
                isinstance(node, ast.Call)
                and _callee_name(node) in HOOKS
                and node.args
            ):
                continue
            a = node.args[0]
            if isinstance(a, ast.Constant) and isinstance(a.value, str):
                out.setdefault(a.value, []).append((rel, node.lineno))
    return out


def _function(mod: PyModule, name: str) -> Optional[ast.FunctionDef]:
    for node in ast.walk(mod.tree):
        if isinstance(node, ast.FunctionDef) and node.name == name:
            return node
    return None


def _strings_in(node: ast.AST) -> Set[str]:
    return {
        n.value
        for n in ast.walk(node)
        if isinstance(n, ast.Constant) and isinstance(n.value, str)
    }


def _mode_arm_strings(mod: PyModule) -> Set[str]:
    """Strings compared against a ``.mode`` attribute anywhere."""
    out: Set[str] = set()
    for node in ast.walk(mod.tree):
        if not isinstance(node, ast.Compare):
            continue
        sides = [node.left, *node.comparators]
        if not any(
            isinstance(s, ast.Attribute) and s.attr == "mode"
            for s in sides
        ):
            continue
        for s in sides:
            if isinstance(s, ast.Constant) and isinstance(s.value, str):
                out.add(s.value)
    return out


def _doc_sites(root: Path, findings: List[Finding]) -> Optional[Set[str]]:
    path = root / README
    if not path.exists():
        findings.append(Finding(MISSING, README, 1, "README unreadable"))
        return None
    sites: Set[str] = set()
    in_table = False
    for i, line in enumerate(path.read_text().splitlines(), 1):
        low = line.lower()
        if "fault" in low and "site" in low and line.startswith("#"):
            in_table = True
            continue
        if in_table and line.startswith("#"):
            break
        if in_table:
            m = _DOC_ROW.match(line)
            if m and m.group(1) not in ("site",):
                sites.add(m.group(1))
    if not in_table:
        findings.append(
            Finding(
                DOC, README, 1,
                "no fault-site section found (a heading naming "
                "'fault' and 'site' followed by a table)",
            )
        )
        return None
    return sites


def check(root) -> List[Finding]:
    root = Path(root)
    findings: List[Finding] = []
    inj = _load(root, INJECTOR, findings)
    if inj is None:
        return findings

    sites = _str_tuple(inj, "SITES")
    modes = _str_tuple(inj, "MODES")
    for name, got in (("SITES", sites), ("MODES", modes)):
        if got is None:
            findings.append(
                Finding(
                    MISSING, INJECTOR, 1,
                    f"{name} tuple not extractable as string literals",
                    symbol=name,
                )
            )
    if sites is None or modes is None:
        return findings

    # ---- declared sites <-> armed hook call sites ----------------- #
    armed = _hook_sites(root)
    for site in sorted(set(sites) - set(armed)):
        findings.append(
            Finding(
                SITE, INJECTOR, 1,
                f"site {site!r} is declared in SITES but no "
                f"maybe_fail/send_with_faults call arms it",
                symbol=site,
            )
        )
    for site in sorted(set(armed) - set(sites)):
        rel, line = armed[site][0]
        findings.append(
            Finding(
                SITE, rel, line,
                f"hook call arms undeclared site {site!r} "
                f"(not in injector SITES)",
                symbol=site,
            )
        )

    # ---- typed-error arms ----------------------------------------- #
    site_err = _function(inj, "_site_error")
    if site_err is None:
        findings.append(
            Finding(
                MISSING, INJECTOR, 1, "_site_error not found",
                symbol="_site_error",
            )
        )
    else:
        named = _strings_in(site_err) & set(sites)
        unnamed = sorted(set(sites) - named)
        if len(unnamed) > 1:
            for site in unnamed:
                findings.append(
                    Finding(
                        ARM, INJECTOR, site_err.lineno,
                        f"site {site!r} has no explicit _site_error arm "
                        f"and the single fallback is already taken "
                        f"({', '.join(unnamed)} all unnamed)",
                        symbol=site,
                    )
                )

    # ---- mode arms ------------------------------------------------ #
    mode_arms = _mode_arm_strings(inj)
    for mode in sorted(set(modes) - mode_arms):
        findings.append(
            Finding(
                MODE, INJECTOR, 1,
                f"mode {mode!r} has no spec.mode arm in the fire path",
                symbol=mode,
            )
        )
    for mode in sorted(mode_arms - set(modes)):
        findings.append(
            Finding(
                MODE, INJECTOR, 1,
                f"fire path compares against undeclared mode {mode!r}",
                symbol=mode,
            )
        )
    parse = _function(inj, "parse_spec")
    if parse is None or "MODES" not in {
        n.id for n in ast.walk(parse) if isinstance(n, ast.Name)
    }:
        findings.append(
            Finding(
                MODE, INJECTOR, 1,
                "parse_spec does not validate against MODES",
                symbol="parse_spec",
            )
        )

    # ---- README fault-site table ---------------------------------- #
    doc = _doc_sites(root, findings)
    if doc is not None:
        for site in sorted(set(sites) - doc):
            findings.append(
                Finding(
                    DOC, README, 1,
                    f"site {site!r} missing from the README "
                    f"fault-site table",
                    symbol=site,
                )
            )
        for site in sorted(doc - set(sites)):
            findings.append(
                Finding(
                    DOC, README, 1,
                    f"README fault-site table lists unknown "
                    f"site {site!r}",
                    symbol=site,
                )
            )
    return findings
