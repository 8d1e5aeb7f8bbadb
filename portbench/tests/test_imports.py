"""What the benchmark runs on the card imports neither JAX nor the JAX
package, and its reference imports nothing of the program either.

Every module under portbench/ but its tests is read (imports at any
depth, relative ones resolved), and the top-level name of each import,
the part before the first dot, is compared whole: `throttlecrab_tpu_torch`
begins with `throttlecrab_tpu` and is the program, not the JAX package.
"""

import ast
from pathlib import Path

import pytest

PKG = Path(__file__).resolve().parent.parent
JAX_SIDE = {"jax", "jaxlib", "flax", "throttlecrab_tpu"}
PROGRAM = "throttlecrab_tpu_torch"
RUN = sorted(p for p in PKG.rglob("*.py") if "tests" not in p.parts)
REFERENCE = [p for p in RUN if p.parent.name == "reference"]


def top_names(path: Path) -> set:
    """Top-level names of every module `path` imports; a relative import
    resolves inside portbench."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".", 1)[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            if node.level:
                names.add("portbench")
            elif node.module:
                names.add(node.module.split(".", 1)[0])
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", "")
              == "import_module" and node.args
              and isinstance(node.args[0], ast.JoinedStr)):
            head = node.args[0].values[0]
            names.add(head.value.split(".", 1)[0])
    return names


def test_the_walk_sees_every_module():
    assert len(RUN) >= 15 and REFERENCE


@pytest.mark.parametrize("path", RUN, ids=lambda p: str(p.relative_to(PKG)))
def test_no_jax_on_the_card(path):
    assert not top_names(path) & JAX_SIDE


@pytest.mark.parametrize("path", REFERENCE,
                         ids=lambda p: str(p.relative_to(PKG)))
def test_the_reference_takes_nothing_of_the_program(path):
    names = top_names(path)
    assert PROGRAM not in names and not names & JAX_SIDE
    assert names <= {"__future__", "bisect", "portbench"}


def test_names_compare_whole():
    assert PROGRAM.split(".", 1)[0] not in JAX_SIDE
    assert PROGRAM.startswith("throttlecrab_tpu")
