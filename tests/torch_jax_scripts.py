"""Load a JAX script of `scripts/` as a module without running it.

The JAX probes run their whole benchmark at import.  `load_script` execs
only what their functions need: the imports and the function
definitions.  The top-level constants the functions read (`B`, `K`,
`CAP`, `N_IDS`, `NOW`, the payload arrays) are bound to the values the
test gives in place of their assignments.  Every other statement (the
prints, the loops, the device claims) is skipped.
"""

import ast
import pathlib
import types

REPO = pathlib.Path(__file__).resolve().parent.parent


def load_script(name, **consts):
    """The functions of `scripts/{name}.py`, with `consts` bound in its
    namespace."""
    path = REPO / "scripts" / f"{name}.py"
    tree = ast.parse(path.read_text(), str(path))
    kept = (ast.Import, ast.ImportFrom, ast.FunctionDef)
    body = [node for node in tree.body if isinstance(node, kept)]
    mod = types.ModuleType(f"jax_script_{name}")
    mod.__file__ = str(path)
    code = compile(ast.Module(body=body, type_ignores=[]), str(path), "exec")
    mod.__dict__.update(consts)
    exec(code, mod.__dict__)
    return mod
