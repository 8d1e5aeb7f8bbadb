"""ctypes bridges to the C++ keymap (`native/keymap.cpp`), the C++
wire server (`native/wire_server.cpp`) and the port's own host finish of
the w32 tier (`csrc/finish_w32.cpp`).

The counterpart of `throttlecrab_tpu/native.py`.  The sources (the
reference's two unmodified) are compiled with g++ at first use into
`throttlecrab_tpu_torch/build/`, under names keyed by a hash of the
source and flags; each build is renamed into place, so concurrent
builds never load a half-written file.  Without a toolchain the limiter's "auto" keymap falls back to the
pure-Python one, and the native transports are unavailable.  No
pybind11: the ABIs are small C surfaces and the batch arrays travel as
numpy pointers.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional, Sequence

import numpy as np

from .spans import span

_PKG = Path(__file__).resolve().parent
_SRC = _PKG.parent / "native" / "keymap.cpp"
BUILD_DIR = _PKG / "build"

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_build_error: Optional[str] = None


def _compile(src: Path, stem: str, extra=()):
    """Build `src` into a shared library unless this revision is built;
    returns (path, None) or (None, error string with the compiler's
    stderr).  `extra` flags (e.g. -pthread) join the hash with the rest.
    THROTTLECRAB_NATIVE_CFLAGS overrides the optimisation/arch flags
    (container images build for a portable baseline instead of the build
    machine's -march=native)."""
    flags = os.environ.get(
        "THROTTLECRAB_NATIVE_CFLAGS", "-O3 -march=native"
    ).split()
    cmd_flags = [*flags, "-std=c++17", "-shared", "-fPIC", *extra]
    digest = hashlib.sha256(
        src.read_bytes() + " ".join(cmd_flags).encode()
    ).hexdigest()
    out = BUILD_DIR / f"{stem}_{digest[:16]}.so"
    if out.exists():
        return out, None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    try:
        subprocess.run(
            ["g++", *cmd_flags, str(src), "-o", str(tmp)],
            check=True, capture_output=True, timeout=120,
        )
        os.replace(tmp, out)
        return out, None
    except FileNotFoundError as e:
        error = f"g++ not found: {e}"
    except subprocess.CalledProcessError as e:
        stderr = (e.stderr or b"").decode(errors="replace")
        error = f"{src.name} failed to compile:\n{stderr[-2000:]}"
    except subprocess.SubprocessError as e:
        error = f"{src.name} build error: {e}"
    tmp.unlink(missing_ok=True)
    return None, error


def _build() -> Optional[ctypes.CDLL]:
    global _build_error
    path, _build_error = _compile(_SRC, "libtkkeymap")
    if path is None:
        return None
    lib = ctypes.CDLL(str(path))
    lib.tk_create.restype = ctypes.c_void_p
    lib.tk_create.argtypes = [ctypes.c_int64]
    lib.tk_destroy.argtypes = [ctypes.c_void_p]
    lib.tk_len.restype = ctypes.c_int64
    lib.tk_len.argtypes = [ctypes.c_void_p]
    lib.tk_capacity.restype = ctypes.c_int64
    lib.tk_capacity.argtypes = [ctypes.c_void_p]
    lib.tk_grow.argtypes = [ctypes.c_void_p, ctypes.c_int64]
    lib.tk_lookup_insert_batch.restype = ctypes.c_int64
    lib.tk_lookup_insert_batch.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_void_p, ctypes.c_int64,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ]
    lib.tk_free_slots.restype = ctypes.c_int64
    lib.tk_free_slots.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
    ]
    lib.tk_intern_keys.restype = ctypes.c_int64
    lib.tk_intern_keys.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_void_p, ctypes.c_int64,
    ]
    lib.tk_assemble.restype = ctypes.c_int64
    lib.tk_assemble.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
    ]
    lib.tk_finish.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_void_p,
    ]
    lib.tk_resolve_all.restype = ctypes.c_int64
    lib.tk_resolve_all.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    lib.tk_assemble_ids.restype = ctypes.c_int64
    lib.tk_assemble_ids.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_void_p,
    ]
    lib.tk_finish_ids.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p,
    ]
    lib.tk_finish_raw.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p,
    ]
    lib.tk_prepare_batch.restype = ctypes.c_int64
    lib.tk_prepare_batch.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_void_p, ctypes.c_int64,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ]
    lib.tk_export_sizes.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ]
    lib.tk_export.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ]
    return lib


def get_lib() -> Optional[ctypes.CDLL]:
    global _lib
    with _lock:
        if _lib is None and _build_error is None:
            _lib = _build()
        return _lib


def native_available() -> bool:
    return get_lib() is not None


def toolchain_available() -> bool:
    """True when a C++ compiler exists: build failures are then bugs, not
    gaps in the environment, and tests must fail rather than skip."""
    return shutil.which("g++") is not None


def keymap_build_error() -> Optional[str]:
    """The keymap build failure (with compiler stderr), or None."""
    get_lib()
    return _build_error


# ------------------------------------------------------------------ #
# Wire-server library (native/wire_server.cpp): the C++ epoll front end
# of the native RESP and HTTP transports (server/native_redis.py).

_WS_SRC = _PKG.parent / "native" / "wire_server.cpp"
_ws_lib: Optional[ctypes.CDLL] = None
_ws_error: Optional[str] = None


def _build_wire() -> Optional[ctypes.CDLL]:
    global _ws_error
    path, _ws_error = _compile(_WS_SRC, "libtkwire", extra=("-pthread",))
    if path is None:
        return None
    lib = ctypes.CDLL(str(path))
    lib.ws_create.restype = ctypes.c_void_p
    lib.ws_create.argtypes = []
    lib.ws_start.restype = ctypes.c_int
    lib.ws_start.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_uint16, ctypes.c_int,
    ]
    for name in ("ws_set_metrics", "ws_set_health", "ws_set_stats"):
        getattr(lib, name).argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int64,
        ]
        getattr(lib, name).restype = None
    lib.ws_port.restype = ctypes.c_uint16
    lib.ws_port.argtypes = [ctypes.c_void_p]
    lib.ws_stop.argtypes = [ctypes.c_void_p]
    lib.ws_stop.restype = None
    lib.ws_destroy.argtypes = [ctypes.c_void_p]
    lib.ws_destroy.restype = None
    lib.ws_next_batch.restype = ctypes.c_int64
    lib.ws_next_batch.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_char_p,
        ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p,
    ]
    lib.ws_respond.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p,
    ]
    lib.ws_respond.restype = None
    lib.ws_stats.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ]
    lib.ws_stats.restype = None
    lib.ws_queue_depth.restype = ctypes.c_int64
    lib.ws_queue_depth.argtypes = [ctypes.c_void_p]
    return lib


def get_wire_lib() -> Optional[ctypes.CDLL]:
    global _ws_lib
    with _lock:
        if _ws_lib is None and _ws_error is None:
            _ws_lib = _build_wire()
        return _ws_lib


def wire_available() -> bool:
    return get_wire_lib() is not None


def wire_build_error() -> Optional[str]:
    """The wire-server build failure (with compiler stderr), or None."""
    get_wire_lib()
    return _ws_error


# Host finish of the w32 tier (csrc/finish_w32.cpp, the port's own):
# one pass from output words to the four planes, for tpu/kernel.py
# finish_w32.

_FIN_SRC = _PKG / "csrc" / "finish_w32.cpp"
_fin_lib: Optional[ctypes.CDLL] = None
_fin_error: Optional[str] = None


def _build_finish() -> Optional[ctypes.CDLL]:
    global _fin_error
    path, _fin_error = _compile(_FIN_SRC, "libtkfinish")
    if path is None:
        return None
    lib = ctypes.CDLL(str(path))
    lib.tk_finish_w32.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_uint32, ctypes.c_uint32,
        ctypes.c_uint32, ctypes.c_void_p,
    ]
    lib.tk_finish_w32.restype = None
    return lib


def get_finish_lib() -> Optional[ctypes.CDLL]:
    global _fin_lib
    with _lock:
        if _fin_lib is None and _fin_error is None:
            _fin_lib = _build_finish()
        return _fin_lib


def finish_build_error() -> Optional[str]:
    """The host finish's build failure (with compiler stderr), or None."""
    get_finish_lib()
    return _fin_error


# Flag bits returned by NativeKeyMap.prepare_batch (keymap.cpp TK_PREP_*).
PREP_DEGEN = 1
PREP_CONFLICT = 2
PREP_FULL = 4
PREP_BIGTOL = 8  # tol >= 2^61: compact="cur" wire word would overflow


class NativeKeyMap:
    """C++-backed key→slot table; drop-in for PyKeyMap via `resolve`."""

    BYTES_KEYS = True

    def __init__(self, capacity: int) -> None:
        lib = get_lib()
        if lib is None:
            raise RuntimeError(f"native keymap unavailable: {_build_error}")
        self._lib = lib
        self._h = lib.tk_create(capacity)
        # Bumped by every slot-remapping operation (sweep frees, growth);
        # device-resident id rows (table.ResidentIdRows) pin the value
        # they were built at and refuse to serve once it moves.
        self.mutations = 0
        # Failure count of the most recent resolve_all (0 before any).
        self.last_resolve_failures = 0
        # Ids interned so far (ids are sequential across intern calls).
        self._n_ids = 0

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.tk_destroy(self._h)
            self._h = None

    def __len__(self) -> int:
        return self._lib.tk_len(self._h)

    @property
    def capacity(self) -> int:
        return self._lib.tk_capacity(self._h)

    def resolve(self, keys: Sequence[bytes], valid: np.ndarray):
        """(slots, rank, is_last, n_full) for a batch of byte keys."""
        n = len(keys)
        buf = b"".join(keys)
        offsets = np.zeros(n + 1, np.int64)
        np.cumsum([len(k) for k in keys], out=offsets[1:])
        slots = np.empty(n, np.int32)
        rank = np.empty(n, np.int32)
        is_last = np.empty(n, np.uint8)
        valid_u8 = np.ascontiguousarray(valid, np.uint8)
        n_full = self._lib.tk_lookup_insert_batch(
            self._h,
            buf,
            offsets.ctypes.data_as(ctypes.c_void_p),
            n,
            valid_u8.ctypes.data_as(ctypes.c_void_p),
            slots.ctypes.data_as(ctypes.c_void_p),
            rank.ctypes.data_as(ctypes.c_void_p),
            is_last.ctypes.data_as(ctypes.c_void_p),
        )
        return slots, rank, is_last.astype(bool), int(n_full)

    def intern(self, keys: Sequence[bytes]) -> int:
        """Register keys for id-based assembly; returns the first new id
        (ids are sequential in call order across intern calls)."""
        n = len(keys)
        buf = b"".join(keys)
        offsets = np.zeros(n + 1, np.int64)
        np.cumsum([len(k) for k in keys], out=offsets[1:])
        first = int(
            self._lib.tk_intern_keys(
                self._h, buf, offsets.ctypes.data_as(ctypes.c_void_p), n
            )
        )
        self._n_ids = first + n
        if n:
            # New ids are not covered by previously-uploaded id rows —
            # the ResidentIdRows guard must force a re-upload.
            self.mutations += 1
        return first

    def assemble(
        self,
        ids: np.ndarray,
        batch: int,
        em_by_id: np.ndarray,
        tol_by_id: np.ndarray,
        quantity: int = 1,
        out: Optional[np.ndarray] = None,
    ):
        """Build a packed launch buffer (kernel.PACK_WIDTH layout) straight
        from interned key ids: one C++ call assembles the whole K×B launch,
        re-hashing each key through the table (allocating slots on miss) and
        emitting the duplicate-segment structure per `batch`-sized
        micro-batch.  Returns (packed i32[total, PACK_WIDTH], n_full)."""
        from .tpu.kernel import PACK_WIDTH

        if batch <= 0:
            raise ValueError("batch must be positive")
        # The C side indexes em/tol by id with no bounds check — the
        # parameter tables must cover every interned id.
        n_ids = self._n_ids
        if len(em_by_id) < n_ids or len(tol_by_id) < n_ids:
            raise ValueError(
                f"parameter tables must cover all {n_ids} interned ids "
                f"(got {len(em_by_id)}/{len(tol_by_id)})"
            )
        ids = np.ascontiguousarray(ids, np.int32)
        total = len(ids)
        if out is None:
            out = np.empty((total, PACK_WIDTH), np.int32)
        elif (
            out.shape != (total, PACK_WIDTH)
            or out.dtype != np.int32
            or not out.flags.c_contiguous
        ):
            raise ValueError(
                "out must be a C-contiguous i32[total, PACK_WIDTH] buffer"
            )
        em_by_id = np.ascontiguousarray(em_by_id, np.int64)
        tol_by_id = np.ascontiguousarray(tol_by_id, np.int64)
        n_full = self._lib.tk_assemble(
            self._h,
            ids.ctypes.data_as(ctypes.c_void_p),
            total,
            batch,
            em_by_id.ctypes.data_as(ctypes.c_void_p),
            tol_by_id.ctypes.data_as(ctypes.c_void_p),
            quantity,
            out.ctypes.data_as(ctypes.c_void_p),
        )
        return out, int(n_full)

    def resolve_all(self, *, strict: bool = False) -> np.ndarray:
        """Resolve every interned id to a slot (allocating on miss);
        returns the id→slot array (i32[n_ids], -1 where the table is
        full).  The host half of BucketTable.upload_id_rows.

        Partial coverage (a full table) is surfaced like assemble()'s
        n_full: a warning by default, ValueError under strict=True; the
        count of the last call is kept in `last_resolve_failures`.  The
        -1 rows themselves are safe downstream — both by-id kernels mask
        slot<0 lanes invalid — but callers deserve the signal."""
        n_ids = self._n_ids
        slots = np.empty(n_ids, np.int32)
        n_failed = int(
            self._lib.tk_resolve_all(
                self._h, slots.ctypes.data_as(ctypes.c_void_p)
            )
        )
        self.last_resolve_failures = n_failed
        if n_failed:
            msg = (
                f"resolve_all: {n_failed}/{n_ids} interned ids could not "
                "get a slot (table full); their id rows carry slot -1 "
                "and will be decided as invalid"
            )
            if strict:
                raise ValueError(msg)
            import warnings

            warnings.warn(msg, RuntimeWarning, stacklevel=2)
        return slots

    def assemble_ids(
        self,
        ids: np.ndarray,
        batch: int,
        out: Optional[np.ndarray] = None,
    ):
        """Build the 8-byte-per-request launch words (see kernel
        gcra_scan_byid) straight from interned key ids: low 32 bits id,
        high 32 rank/is_last/valid, duplicate segments tracked per slot
        exactly like assemble().  Returns (words i64[total], n_bad)."""
        if not 0 < batch <= 1 << 14:
            raise ValueError("batch must be in (0, 16384] (14-bit rank)")
        ids = np.ascontiguousarray(ids, np.int32)
        total = len(ids)
        if out is None:
            out = np.empty(total, np.int64)
        elif (
            out.shape != (total,)
            or out.dtype != np.int64
            or not out.flags.c_contiguous
        ):
            raise ValueError("out must be a C-contiguous i64[total] buffer")
        n_bad = self._lib.tk_assemble_ids(
            self._h,
            ids.ctypes.data_as(ctypes.c_void_p),
            total,
            batch,
            out.ctypes.data_as(ctypes.c_void_p),
        )
        return out, int(n_bad)

    def finish_ids(
        self,
        words: np.ndarray,
        em_by_id: np.ndarray,
        tol_by_id: np.ndarray,
        quantity: int,
        cur2: np.ndarray,
        now_ns: int,
        out: Optional[np.ndarray] = None,
    ) -> np.ndarray:
        """tk_finish for the by-id path: parameters come from the host
        tables indexed by each request word's id.  Returns i32[n, 4]
        (allowed, remaining, reset_after_secs, retry_after_secs)."""
        words = np.ascontiguousarray(words, np.int64).reshape(-1)
        cur2 = np.ascontiguousarray(cur2, np.int64).reshape(-1)
        n = len(cur2)
        if len(words) != n:
            raise ValueError("words and cur2 row counts differ")
        em_by_id = np.ascontiguousarray(em_by_id, np.int64)
        tol_by_id = np.ascontiguousarray(tol_by_id, np.int64)
        n_ids = self._n_ids
        if len(em_by_id) < n_ids or len(tol_by_id) < n_ids:
            raise ValueError(
                f"parameter tables must cover all {n_ids} interned ids"
            )
        if out is None:
            out = np.empty((n, 4), np.int32)
        elif (
            out.shape != (n, 4)
            or out.dtype != np.int32
            or not out.flags.c_contiguous
        ):
            raise ValueError("out must be a C-contiguous i32[n, 4] buffer")
        self._lib.tk_finish_ids(
            words.ctypes.data_as(ctypes.c_void_p),
            em_by_id.ctypes.data_as(ctypes.c_void_p),
            tol_by_id.ctypes.data_as(ctypes.c_void_p),
            quantity,
            cur2.ctypes.data_as(ctypes.c_void_p),
            n,
            now_ns,
            out.ctypes.data_as(ctypes.c_void_p),
        )
        return out

    def finish_raw(
        self,
        ids: np.ndarray,
        em_by_id: np.ndarray,
        tol_by_id: np.ndarray,
        quantity: int,
        cur2: np.ndarray,
        now_ns: int,
        out: Optional[np.ndarray] = None,
    ) -> np.ndarray:
        """tk_finish for the raw-ids path (gcra_scan_ids): the request
        stream is bare i32 ids (negative = padding).  Returns i32[n, 4]
        (allowed, remaining, reset_after_secs, retry_after_secs)."""
        with span("tc.finish.raw"):
            ids = np.ascontiguousarray(ids, np.int32).reshape(-1)
            cur2 = np.ascontiguousarray(cur2, np.int64).reshape(-1)
            n = len(cur2)
            if len(ids) != n:
                raise ValueError("ids and cur2 row counts differ")
            em_by_id = np.ascontiguousarray(em_by_id, np.int64)
            tol_by_id = np.ascontiguousarray(tol_by_id, np.int64)
            n_ids = self._n_ids
            if len(em_by_id) < n_ids or len(tol_by_id) < n_ids:
                raise ValueError(
                    f"parameter tables must cover all {n_ids} interned ids"
                )
            # Raw ids carry no assembler guarantee — bound-check before the
            # C loop indexes the tables (the kernel marks such lanes invalid
            # and their cur words are don't-care, but C must not read OOB).
            if n and int(ids.max()) >= min(len(em_by_id), len(tol_by_id)):
                raise ValueError(
                    "ids contain values beyond the parameter tables"
                )
            if out is None:
                out = np.empty((n, 4), np.int32)
            elif (
                out.shape != (n, 4)
                or out.dtype != np.int32
                or not out.flags.c_contiguous
            ):
                raise ValueError("out must be a C-contiguous i32[n, 4] buffer")
            self._lib.tk_finish_raw(
                ids.ctypes.data_as(ctypes.c_void_p),
                em_by_id.ctypes.data_as(ctypes.c_void_p),
                tol_by_id.ctypes.data_as(ctypes.c_void_p),
                quantity,
                cur2.ctypes.data_as(ctypes.c_void_p),
                n,
                now_ns,
                out.ctypes.data_as(ctypes.c_void_p),
            )
            return out

    def finish(
        self,
        packed: np.ndarray,
        cur2: np.ndarray,
        now_ns: int,
        out: Optional[np.ndarray] = None,
    ) -> np.ndarray:
        """Complete a compact="cur" device output into the exact 4-plane
        wire values: i32[n, 4] rows (allowed, remaining, reset_after_secs,
        retry_after_secs), reading emission/tolerance/quantity from the
        same packed rows that built the launch.  Bit-exact twin of
        kernel.finish_cur; see native/keymap.cpp tk_finish."""
        from .tpu.kernel import PACK_WIDTH

        packed = np.ascontiguousarray(packed, np.int32).reshape(
            -1, PACK_WIDTH
        )
        cur2 = np.ascontiguousarray(cur2, np.int64).reshape(-1)
        n = len(cur2)
        if len(packed) != n:
            raise ValueError("packed and cur2 row counts differ")
        if out is None:
            out = np.empty((n, 4), np.int32)
        elif (
            out.shape != (n, 4)
            or out.dtype != np.int32
            or not out.flags.c_contiguous
        ):
            raise ValueError("out must be a C-contiguous i32[n, 4] buffer")
        self._lib.tk_finish(
            packed.ctypes.data_as(ctypes.c_void_p),
            cur2.ctypes.data_as(ctypes.c_void_p),
            n,
            now_ns,
            out.ctypes.data_as(ctypes.c_void_p),
        )
        return out

    def prepare_batch(
        self,
        key_blob: bytes,
        offsets: np.ndarray,
        params: np.ndarray,
        out: Optional[np.ndarray] = None,
        agg: Optional[np.ndarray] = None,
    ):
        """The fully-native serving prep: validate + derive GCRA params
        (exact f64 pipeline) + resolve slots + segment structure + packed
        rows, in ONE C++ pass over the wire-shaped batch.

        `key_blob`/`offsets[n+1]` frame the keys; `params` is i64[n, 4]
        (burst, count, period, quantity).  Returns (packed i32[n, 9],
        status u8[n], flags).  flags & (PREP_CONFLICT | PREP_FULL) means
        the caller must fall back to the Python path (mid-batch param
        change / table growth); PREP_DEGEN means decide with the exact
        kernel (with_degen=True).

        `agg` (i64[4], optional) receives the valid-lane bounds for the
        dispatcher's O(1) w32 certificate: [max_tol, min_tol, max_inc,
        max remaining-bound] (kernel.fits_w32_wire_agg consumes it)."""
        from .tpu.kernel import PACK_WIDTH

        n = len(offsets) - 1
        params = np.ascontiguousarray(params, np.int64)
        if params.shape != (n, 4):
            raise ValueError("params must be i64[n, 4]")
        offsets = np.ascontiguousarray(offsets, np.int64)
        if out is None:
            out = np.empty((n, PACK_WIDTH), np.int32)
        status = np.empty(n, np.uint8)
        if agg is not None and (
            agg.shape != (4,) or agg.dtype != np.int64
            or not agg.flags.c_contiguous
        ):
            raise ValueError("agg must be a C-contiguous i64[4] buffer")
        flags = self._lib.tk_prepare_batch(
            self._h,
            key_blob,
            offsets.ctypes.data_as(ctypes.c_void_p),
            n,
            params.ctypes.data_as(ctypes.c_void_p),
            out.ctypes.data_as(ctypes.c_void_p),
            status.ctypes.data_as(ctypes.c_void_p),
            agg.ctypes.data_as(ctypes.c_void_p) if agg is not None else None,
        )
        return out, status, int(flags)

    def free_slots(self, slot_indices: np.ndarray) -> int:
        arr = np.ascontiguousarray(slot_indices, np.int32)
        n = int(
            self._lib.tk_free_slots(
                self._h, arr.ctypes.data_as(ctypes.c_void_p), len(arr)
            )
        )
        if n:
            self.mutations += 1
        return n

    def grow(self, new_capacity: int) -> None:
        self._lib.tk_grow(self._h, new_capacity)
        self.mutations += 1

    def items(self):
        """(key_bytes, slot) pairs for every live entry (snapshot export)."""
        n = ctypes.c_int64()
        total = ctypes.c_int64()
        self._lib.tk_export_sizes(
            self._h, ctypes.byref(n), ctypes.byref(total)
        )
        n, total = n.value, total.value
        slots = np.empty(n, np.int32)
        offsets = np.empty(n + 1, np.int64)
        blob = ctypes.create_string_buffer(max(total, 1))
        self._lib.tk_export(
            self._h,
            slots.ctypes.data_as(ctypes.c_void_p),
            offsets.ctypes.data_as(ctypes.c_void_p),
            blob,
        )
        raw = blob.raw[:total]
        # Python ints, not numpy scalars, in the per-key loop.
        bounds = offsets.tolist()
        return list(zip(
            [raw[a:b] for a, b in zip(bounds, bounds[1:])], slots.tolist()
        ))
