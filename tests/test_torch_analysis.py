"""The port's static invariant suite (throttlecrab_tpu_torch/analysis).

Four layers:

  * the port's real tree is clean under ``--strict`` — zero unwaived
    findings, zero stale waivers, inside the JAX suite's 30 s budget —
    and the CLI, run in a subprocess, imports none of torch, numpy or
    jax;
  * differential cases: every fixture case of the matching classes in
    ``tests/test_invariants.py`` is run as written against the JAX
    suite, and each checker call it makes is replayed on a mirror of
    its tree in the port's layout (``throttlecrab_tpu/`` ->
    ``throttlecrab_tpu_torch/``, the JAX fuzzer -> the port's mutation
    cases, README -> also the port's KNOBS.md, ``# twin: xla-only`` ->
    ``# twin: torch-only``).  The port's checker must report the same
    codes at the same lines with the same symbols.  Two checkers carry
    port-only subjects, compared as follows: ``twin`` also reads the
    CUDA sources (their findings are the port's own and left out), and
    ``ktwin``'s pair side is the C++ lane header instead of the i32
    pair library (a pair-side mutation is applied to the header as its
    C++ counterpart, and pair-side findings are compared by code and by
    the twin's Python name);
  * mutation cases on temporary copies of the port's real files: each
    planted defect must fire its code;
  * the CLI's flags, the checker roster and the finding codes, equal
    to the JAX suite's.
"""

from __future__ import annotations

import inspect
import json
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

import test_invariants as ti
from throttlecrab_tpu import analysis as jax_analysis
from throttlecrab_tpu_torch import analysis as port_analysis
from throttlecrab_tpu_torch.analysis import (
    CHECKER_CODES,
    CHECKERS,
    DEFAULT_BASELINE,
    jit_boundary,
    kernel_twins,
    load_baseline,
    registry,
    run_timed,
    wire_surface,
)

REPO = Path(__file__).resolve().parent.parent
JAX_PKG, PORT_PKG = "throttlecrab_tpu/", "throttlecrab_tpu_torch/"
JAX_FUZZER = "scripts/fuzz_wire_tiers.py"
#: The port's fuzzers, which JAX's one fuzzer file stands for.
PORT_FUZZERS = sorted({rel for rels in wire_surface.FUZZERS.values()
                       for rel in rels})
LANE = PORT_PKG + "csrc/gcra_lane.cuh"

#: Port files a checker reads beyond what the JAX fixtures provide.
PORT_EXTRAS = {
    "twin": (LANE, PORT_PKG + "csrc/row_tile.cuh",
             PORT_PKG + "tpu/fused.py", PORT_PKG + "tpu/row_ops.py"),
    "ktwin": (LANE,),
}

#: ktwin: a JAX pair-side mutation (old, new in pallas_fused.py) -> the
#: same defect in the C++ lane header.
KTWIN_PAIR_MUTATIONS = (
    ("pos_of = _is_pos(a) & _is_pos(b) & _is_neg(s)",
     "pos_of = _is_pos(a) & _is_neg(b) & _is_neg(s)",
     "if (a > 0 && b > 0 && s < 0) return I64_MAX;",
     "if (a > 0 && b < 0 && s < 0) return I64_MAX;"),
    ("def _sat_add64(", "def _renamed_sat_add64(",
     "TC_HD int64_t sat_add(int64_t a", "TC_HD int64_t renamed_sat_add(int64_t a"),
)

#: ktwin pair-side symbols: the JAX pair name -> the C++ twin's name.
KTWIN_SYMBOLS = {
    **{pair: xla for xla, pair in
       {**jax_analysis.kernel_twins.STRUCTURAL_PAIRS,
        **jax_analysis.kernel_twins.DECLARED_PAIRS}.items()},
    "_gcra_pairs": "decide_lane",
}

DIFF_CLASSES = (
    "TestI64Hygiene", "TestTwinDrift", "TestJitBoundary", "TestRegistry",
    "TestLockOrder", "TestBlockingUnderLock", "TestAsyncBoundary",
    "TestRegistryParity", "TestWireSurface", "TestDecodeHardening",
    "TestStatusSurface", "TestFaultSurface", "TestKernelTwins",
)

CASES = [
    (cls, name)
    for cls in DIFF_CLASSES
    for name, _fn in inspect.getmembers(getattr(ti, cls), inspect.isfunction)
    if name.startswith("test_") and "real_tree" not in name
]


# ------------------------------------------------------------------ #
# The mirror


def _port_rels(rel: str, checker: str):
    if rel == JAX_FUZZER:
        return PORT_FUZZERS
    if rel.startswith(JAX_PKG):
        return [PORT_PKG + rel[len(JAX_PKG):]]
    if rel == "README.md" and checker == "registry":
        return [rel, registry.PORT_DOC]
    return [rel]


def _mirror(root: Path, checker: str, n: int) -> Path:
    """The JAX-layout tree `root` in the port's layout."""
    dst = root.parent / f"{root.name}-port{n}"
    for path in sorted(root.rglob("*")):
        if not path.is_file():
            continue
        rel = path.relative_to(root).as_posix()
        data = path.read_bytes()
        if rel.endswith(".py"):
            data = data.replace(b"# twin: xla-only(", b"# twin: torch-only(")
        for prel in _port_rels(rel, checker):
            out = dst / prel
            out.parent.mkdir(parents=True, exist_ok=True)
            out.write_bytes(data)
    for rel in PORT_EXTRAS.get(checker, ()):
        if not (dst / rel).exists():
            (dst / rel).parent.mkdir(parents=True, exist_ok=True)
            shutil.copy(REPO / rel, dst / rel)
    pairs = root / JAX_PKG / "tpu/pallas_fused.py"
    if checker == "ktwin" and pairs.exists():
        src = pairs.read_text()
        lane = dst / LANE
        text = lane.read_text()
        for old, new, c_old, c_new in KTWIN_PAIR_MUTATIONS:
            if new in src and old not in src:
                assert c_old in text, c_old
                text = text.replace(c_old, c_new)
        if "_min64(" not in src:  # the pair side's minimum stripped
            text = text.replace("imin(", "imax(")
        lane.write_text(text)
    return dst


def _keys(findings, checker: str):
    out = set()
    for f in findings:
        path, line, symbol = f.path, f.line, f.symbol
        if checker == "twin" and path.startswith(PORT_PKG + "csrc/"):
            continue  # the port's own CUDA twins: no JAX counterpart
        if path == registry.PORT_DOC:
            path = "README.md"
        for pkg in (PORT_PKG, JAX_PKG):
            if path.startswith(pkg):
                path = "<pkg>/" + path[len(pkg):]
                break
        if path == JAX_FUZZER or path in PORT_FUZZERS:
            path = "<fuzzer>"
        if checker == "ktwin" and path in (
            "<pkg>/tpu/pallas_fused.py", "<pkg>/csrc/gcra_lane.cuh",
        ):
            path, line = "<pair>", 0
            symbol = KTWIN_SYMBOLS.get(symbol, symbol)
        out.add((f.code, path, line, symbol))
    return out


@pytest.mark.parametrize("cls,method", CASES,
                         ids=[f"{c}.{m}" for c, m in CASES])
def test_checker_case_matches_jax(cls, method, tmp_path, monkeypatch):
    """One fixture case of tests/test_invariants.py: its checker calls
    go through the JAX checker (whose findings the case's own
    assertions read) and, on the mirrored tree, through the port's,
    with equal codes, lines and symbols."""
    calls = []

    def differential(name, jax_fn, port_fn):
        def run(root):
            got = jax_fn(root)
            mirror = _mirror(Path(root), name, len(calls))
            want, have = _keys(got, name), _keys(port_fn(mirror), name)
            assert have == want, (
                f"{name}: only JAX {sorted(want - have)}; "
                f"only port {sorted(have - want)}"
            )
            calls.append(name)
            return got
        return run

    for name, jax_fn in jax_analysis.CHECKERS.items():
        module = sys.modules[jax_fn.__module__]
        monkeypatch.setattr(
            module, jax_fn.__name__,
            differential(name, jax_fn, CHECKERS[name]),
        )
    case = getattr(getattr(ti, cls)(), method)
    if "tmp_path" in inspect.signature(case).parameters:
        case(tmp_path)
    else:
        case()
    assert calls, "the case ran no checker"


# ------------------------------------------------------------------ #
# The port's real tree


@pytest.fixture(scope="module")
def strict_report():
    """One run of ``python -m throttlecrab_tpu_torch.analysis --strict
    --json`` over the repo, in a subprocess, through chip_smoke.py's
    phase 17 (which needs no card and raises on any finding, stale or
    violated waiver, heavy import or nonzero exit)."""
    import chip_smoke

    return chip_smoke.run_invariants("no card")


def test_port_tree_clean_under_strict_and_fast(strict_report):
    assert strict_report["findings"] == []
    assert strict_report["stale_waivers"] == []
    assert strict_report["elapsed_s"] < 30.0, "budget 30 s"


def test_baseline_waivers_all_used_and_pinned(strict_report):
    """Every waiver has its reason and pinned count, and the run used
    them all (strict reports a count that differs as a violated
    waiver)."""
    waivers = load_baseline(DEFAULT_BASELINE)
    for w in waivers:
        assert w.reason and w.count, w
    assert strict_report["waived"] == sum(w.count for w in waivers)


def test_cli_strict_json_imports_no_torch_numpy_or_jax(strict_report):
    assert set(strict_report["checker_s"]) == set(CHECKERS)
    for mod in ("torch", "numpy", "jax"):
        assert strict_report[f"{mod}_imported"] is False


def test_cli_partial_run_budget_and_unknown_checks():
    def cli(*args):
        return subprocess.run(
            [sys.executable, "-m", "throttlecrab_tpu_torch.analysis", *args],
            capture_output=True, text=True, timeout=120, cwd=REPO,
        )
    proc = cli("--json", "--checks", "twin,ktwin,jit")
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert set(json.loads(proc.stdout)["checker_s"]) == {"twin", "ktwin", "jit"}
    proc = cli("--checks", "twin", "--max-seconds", "0.000001")
    assert proc.returncode == 1
    assert "runtime budget exceeded" in proc.stderr
    proc = cli("--checks", "bogus")
    assert proc.returncode == 2
    assert "ktwin" in proc.stderr
    with pytest.raises(ValueError):
        run_timed(REPO, checks={"bogus"})


def test_roster_and_codes_equal_jax():
    assert list(CHECKERS) == list(jax_analysis.CHECKERS)
    assert CHECKER_CODES == jax_analysis.CHECKER_CODES


def test_subjects_are_the_ports_own():
    """twin reads csrc/, ktwin pairs sat.py with the lane header, and
    jit has device bodies and launch wrappers to check."""
    kernels, wrappers = jit_boundary.subjects(REPO)
    bodies = {sym for _rel, _text, b in kernels for sym, _s, _e in b}
    assert {"window_kernel", "gather_kernel", "scatter_kernel",
            "decide_lane", "sat_add", "make_tile"} <= bodies
    assert {fn.name for _mod, fns in wrappers for fn, _t in fns} >= {
        "fused_window", "row_gather", "row_scatter"}
    assert kernel_twins.SAT.endswith("throttlecrab_tpu_torch/tpu/sat.py")
    assert kernel_twins.LANE == LANE
    assert set(kernel_twins.STRUCTURAL_PAIRS) == {
        "sat_add", "sat_sub", "sat_add_nn", "sat_sub_nn", "sat_mul_nonneg",
        "div_trunc"}


# ------------------------------------------------------------------ #
# Mutations of the port's real files


def _port_copy(tmp_path: Path) -> Path:
    shutil.copytree(
        REPO / PORT_PKG, tmp_path / PORT_PKG,
        ignore=shutil.ignore_patterns("__pycache__", "build"),
    )
    for rel in ("native/keymap.cpp", "native/wire_server.cpp", "README.md",
                *PORT_FUZZERS):
        (tmp_path / rel).parent.mkdir(parents=True, exist_ok=True)
        shutil.copy(REPO / rel, tmp_path / rel)
    return tmp_path


def _edit(root: Path, rel: str, old: str, new: str) -> int:
    """Replace `old` (which must occur once) and return its line."""
    path = root / rel
    src = path.read_text()
    assert src.count(old) == 1, (rel, old)
    path.write_text(src.replace(old, new))
    return src[: src.index(old)].count("\n") + 1


MUTATIONS = {
    # name: (checker, rel, old, new, code, symbol)
    "tier-w32-drift": (
        "twin", LANE, "constexpr int TIER_W32 = 3;",
        "constexpr int TIER_W32 = 4;", "twin-drift", "TIER_W32"),
    "sat-add-predicate-cpp": (
        "ktwin", LANE, "if (a > 0 && b > 0 && s < 0) return I64_MAX;",
        "if (a > 0 && b >= 0 && s < 0) return I64_MAX;", "ktwin-drift",
        "sat_add"),
    "sat-add-predicate-python": (
        "ktwin", PORT_PKG + "tpu/sat.py",
        "pos_of = (a > 0) & (b > 0) & (s < 0)",
        "pos_of = (a > 0) & (b > 0) & (s <= 0)", "ktwin-drift", "sat_add"),
    "printf-in-device-body": (
        "jit", LANE, "{ return a / (b > 1 ? b : 1); }",
        '{ printf("%lld", (long long)a); return a / (b > 1 ? b : 1); }',
        "jit-host-call", "div_trunc"),
    "device-value-branch-in-wrapper": (
        "jit", PORT_PKG + "tpu/fused.py",
        "    LAUNCHES += 1\n    return out, n_exp\n",
        "    LAUNCHES += 1\n    if n_exp.sum() > 0:\n        pass\n"
        "    return out, n_exp\n", "jit-branch", "fused_window"),
    "dropped-pragma": (
        "i64", PORT_PKG + "tpu/kernel.py",
        "    burst_limit = now + tol  # inv: allow(i64-raw-op)\n"
        "    room = sat_sub(burst_limit, cur)\n",
        "    burst_limit = now + tol\n    room = sat_sub(burst_limit, cur)\n",
        "i64-raw-op", "_request_outputs"),
    "new-unranked-lock": (
        "lock", PORT_PKG + "server/native_redis.py",
        "_count_lock = threading.Lock()\n",
        "_count_lock = threading.Lock()\n_extra_lock = threading.Lock()\n",
        "lock-unranked", ""),
    "undocumented-knob": (
        "registry", PORT_PKG + "KNOBS.md",
        "| `THROTTLECRAB_DEVICE` |", "| `--device` env |",
        "knob-undocumented", ""),
    "sleep-under-counter-lock": (
        "block", PORT_PKG + "parallel/sharded.py",
        "        with self._counter_lock:\n"
        "            self.total_allowed += allowed\n",
        "        with self._counter_lock:\n            time.sleep(0.001)\n"
        "            self.total_allowed += allowed\n",
        "block-under-lock", "ShardedTorchRateLimiter._bump_counters"),
    "sleep-on-the-event-loop": (
        "async", PORT_PKG + "server/redis.py",
        "        if not isinstance(value, Array):\n",
        "        time.sleep(0.001)\n        if not isinstance(value, Array):\n",
        "async-blocking-call", "RedisTransport._process_command"),
    "op-without-mutation-arm": (
        "wire", "tests/test_torch_cluster_codec.py",
        "    OP_RING: \"ring\",\n", "",
        "wire-fuzz", "OP_RING"),
    "op-without-campaign-arm": (
        "wire", wire_surface.CAMPAIGN, "        OP_RING: mk_ring,\n", "",
        "wire-fuzz", "OP_RING"),
    "trace-kind-without-campaign-arm": (
        "wire", wire_surface.CAMPAIGN, "sorted(_DECODERS.items())",
        "sorted({}.items())", "wire-fuzz", "REC_WINDOW"),
    "untyped-decoder-raise": (
        "harden", PORT_PKG + "parallel/cluster.py",
        '        raise ClusterProtocolError("bad join frame size")',
        '        raise ValueError("bad join frame size")',
        "harden-typed", "decode_join"),
    "status-without-message": (
        "status", PORT_PKG + "server/engine.py",
        '    STATUS_TENANT_QUOTA: "tenant capacity quota exceeded",\n', "",
        "status-message", "STATUS_TENANT_QUOTA"),
    "mode-without-fire-arm": (
        "fault", PORT_PKG + "faults/injector.py",
        '"truncate", "fsyncfail",', '"truncate", "fsyncfail", "jitter",',
        "fault-mode", "jitter"),
}


@pytest.mark.parametrize("name", sorted(MUTATIONS))
def test_mutation_of_port_file_fires(name, tmp_path):
    checker, rel, old, new, code, symbol = MUTATIONS[name]
    root = _port_copy(tmp_path)
    before = {(f.code, f.symbol) for f in CHECKERS[checker](root)}
    assert (code, symbol) not in before
    line = _edit(root, rel, old, new)
    hits = [f for f in CHECKERS[checker](root)
            if f.code == code and f.symbol == symbol]
    assert hits, f"{name}: no {code} [{symbol}]"
    if checker in ("i64", "jit", "lock", "block", "async"):
        assert any(f.line in (line, line + 1) for f in hits), hits


def test_every_checker_has_a_mutation_case():
    assert {m[0] for m in MUTATIONS.values()} == set(CHECKERS)


def test_stale_waiver_fails_strict(tmp_path):
    baseline = tmp_path / "baseline.toml"
    baseline.write_text(
        DEFAULT_BASELINE.read_text()
        + '\n[[waiver]]\ncode = "i64-raw-op"\n'
        'path = "throttlecrab_tpu_torch/tpu/kernel.py"\n'
        'symbol = "no_such_function"\nreason = "stale on purpose"\n'
    )
    proc = subprocess.run(
        [sys.executable, "-m", "throttlecrab_tpu_torch.analysis", "--strict",
         "--json", "--baseline", str(baseline)],
        capture_output=True, text=True, timeout=120, cwd=REPO,
    )
    assert proc.returncode == 1
    report = json.loads(proc.stdout)
    assert report["findings"] == []
    assert [w["symbol"] for w in report["stale_waivers"]] == [
        "no_such_function"]


def test_analysis_modules_are_the_ports_own():
    """Every checker the port registers lives in the port's package."""
    for fn in CHECKERS.values():
        assert fn.__module__.startswith("throttlecrab_tpu_torch.analysis.")
    assert port_analysis.DEFAULT_BASELINE.parent == (
        REPO / PORT_PKG / "analysis")
