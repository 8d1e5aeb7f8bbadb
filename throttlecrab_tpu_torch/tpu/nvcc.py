"""Build and load the port's hand-written CUDA kernels.

Each kernel source in `csrc/` is compiled with nvcc (sm_90a) into a
plain-C shared library at first use, into `throttlecrab_tpu_torch/build/`
under a name keyed by a hash of its sources and the nvcc flags, and bound
with ctypes by its wrapper module (`fused.py`, `row_ops.py`).  Nothing
here runs at import: the CPU tests import every module on a box without
nvcc.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


def library_path(stem: str, sources) -> Path:
    """Where the build of the current `sources` (names under csrc/) lives."""
    h = hashlib.sha256()
    for name in sources:
        h.update((CSRC / name).read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{stem}_{h.hexdigest()[:16]}.so"


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def build(stem: str, sources) -> Path:
    """Compile `sources[0]` (the translation unit; the other names are
    headers it includes) unless this revision is built; returns the
    library's path.  The output is renamed into place, so concurrent
    builders never load a half-written file.  nvcc's report (ptxas
    registers, stack and spills per kernel) is kept beside it as
    `<library>.log`."""
    path = library_path(stem, sources)
    if path.exists():
        return path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(f".{os.getpid()}.tmp")
    cmd = [
        _nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
        str(CSRC / sources[0]),
    ]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(
            f"nvcc failed on {sources[0]} ({res.returncode}):\n"
            f"{res.stdout}\n{res.stderr}"
        )
    path.with_suffix(".log").write_text(res.stdout + res.stderr)
    os.replace(tmp, path)
    return path


def load(stem: str, sources) -> ctypes.CDLL:
    """Build if needed, then load the library (the caller declares each
    function's argtypes and restype and keeps the handle)."""
    return ctypes.CDLL(str(build(stem, sources)))
