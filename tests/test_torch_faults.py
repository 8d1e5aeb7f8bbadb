"""The port's fault injector (throttlecrab_tpu_torch/faults/) against the
JAX package's (throttlecrab_tpu/faults/), firing for firing.

`parse_spec` must accept and refuse the same specs, with the same
messages.  Given the same spec and seed, the same sequence of `check`
calls must fire at the same indices with the same exception types and
messages in both packages (the per-fault 64-bit LCG is the replay
contract), stall through the injected `sleep_fn` with the same
arguments, and report the same `stats()` and `fired_schedule()`;
`from_schedule` must replay a schedule identically in both.  The file
and socket chokepoints (`truncate`, `fsyncfail`, `partial`) must leave
the same bytes behind.  Exact equality throughout: it is integer math
and string formatting.
"""

import io
import socket

import numpy as np
import pytest

from throttlecrab_tpu import faults as jax_faults
from throttlecrab_tpu_torch import faults as port_faults

PACKAGES = (jax_faults, port_faults)


@pytest.fixture(autouse=True)
def _disarm_both():
    yield
    for pkg in PACKAGES:
        pkg.disarm()


def _outcome(fn, *args):
    """(exception class name, message) of fn(*args), or None when it
    passed."""
    try:
        fn(*args)
    except Exception as e:  # every shape the sites raise
        return type(e).__name__, str(e)
    return None


_SPECS = [
    "launch:transient:0.5",
    "launch:persistent",
    "fetch:count:3",
    "launch:hang:0.25",
    "peer:slow:1.5",
    "peer:partial",
    "snapshot:truncate:0.3",
    "snapshot:fsyncfail",
    "keymap:persistent",
    "migrate:transient:0.2, leave:count:2",
    "launch:transient:0.3,fetch:transient:0.7,keymap:count:1",
    " launch:count:0 ,, fetch:hang:0",
    "launch:transient:1e-1",
    "nope:persistent",
    "launch:explode",
    "launch:transient",
    "launch:transient:2.0",
    "launch:transient:-0.1",
    "launch",
    "launch:count:-1",
    "launch:hang:-2",
    "snapshot:truncate:1.0",
    "snapshot:truncate:0",
    "launch:count:x",
    "launch:count:1:2",
    "",
]


@pytest.mark.parametrize("spec", _SPECS)
def test_parse_spec_accepts_and_refuses_as_in_jax(spec):
    got = []
    for pkg in PACKAGES:
        try:
            got.append([(s.site, s.mode, s.arg) for s in pkg.parse_spec(spec)])
        except ValueError as e:
            got.append(("ValueError", str(e)))
    assert got[0] == got[1]


def test_sites_and_modes_as_in_jax():
    assert port_faults.SITES == jax_faults.SITES
    assert port_faults.MODES == jax_faults.MODES


# Specs that mix every raising and stalling mode over several sites.
_FIRING_SPECS = [
    "launch:transient:0.5",
    "launch:transient:0.05,fetch:transient:0.3",
    "launch:count:4,fetch:count:2,keymap:count:1",
    "launch:hang:0.5,launch:transient:0.4",
    "peer:slow:2,peer:transient:0.25,migrate:partial",
    "snapshot:truncate:0.25,snapshot:transient:0.5,leave:fsyncfail",
    "launch:persistent,fetch:transient:0.9",
]


def _drive(pkg, spec, seed, sites, heal_at):
    """Arm `spec`, run `check` over `sites` (healing the first site at
    index `heal_at`), and return what a replay must reproduce."""
    slept = []
    inj = pkg.FaultInjector(pkg.parse_spec(spec), seed=seed,
                            sleep_fn=slept.append)
    outcomes = []
    for i, site in enumerate(sites):
        if i == heal_at:
            inj.heal(sites[0])
        outcomes.append((site, _outcome(inj.check, site),
                         len(slept)))
    return outcomes, slept, inj.stats(), inj.fired_schedule()


@pytest.mark.parametrize("spec", _FIRING_SPECS)
@pytest.mark.parametrize("seed", [0, 1, 7, 2**40 + 3])
def test_same_spec_and_seed_fire_identically(spec, seed):
    rng = np.random.default_rng(seed % 1000)
    pool = sorted({s.site for s in jax_faults.parse_spec(spec)} | {"launch"})
    sites = [pool[i] for i in rng.integers(0, len(pool), 300)]
    jax_run = _drive(jax_faults, spec, seed, sites, heal_at=250)
    port_run = _drive(port_faults, spec, seed, sites, heal_at=250)
    assert port_run == jax_run
    assert jax_run[3], "the schedule never fired"


@pytest.mark.parametrize("spec", _FIRING_SPECS)
def test_from_schedule_replays_identically(spec):
    """A recorded schedule replays at the same check indices with the
    same errors and stalls in both packages, and replays the live run's
    raising pattern."""
    rng = np.random.default_rng(5)
    pool = sorted({s.site for s in jax_faults.parse_spec(spec)})
    sites = [pool[i] for i in rng.integers(0, len(pool), 200)]
    live, _, _, schedule = _drive(jax_faults, spec, 11, sites, heal_at=-1)
    replays = []
    for pkg in PACKAGES:
        slept = []
        inj = pkg.FaultInjector.from_schedule(schedule, sleep_fn=slept.append)
        out = [(s, _outcome(inj.check, s)) for s in sites]
        replays.append((out, slept, inj.fired_schedule()))
    assert replays[0] == replays[1]
    raised_live = [o is not None for _, o, _ in live]
    assert [o is not None for _, o in replays[1][0]] == raised_live


def test_global_hooks_fire_identically():
    """arm / maybe_fail / active_injector / disarm: the process-wide
    plumbing fires the armed injector and is a no-op when disarmed."""
    got = []
    for pkg in PACKAGES:
        assert pkg.active_injector() is None
        quiet = _outcome(pkg.maybe_fail, "launch")
        inj = pkg.FaultInjector(pkg.parse_spec("launch:count:2"), seed=3)
        pkg.arm(inj)
        assert pkg.active_injector() is inj
        fired = [_outcome(pkg.maybe_fail, "launch") for _ in range(3)]
        other = _outcome(pkg.maybe_fail, "fetch")
        pkg.disarm()
        got.append((quiet, fired, other, inj.stats(),
                    _outcome(pkg.maybe_fail, "launch")))
    assert got[0] == got[1]
    assert got[1][1][0] == (
        "InjectedDeviceError", "UNAVAILABLE: injected launch fault (count, 1 left)"
    )


def test_keymap_site_raises_the_bucket_table_full_shape():
    got = [_outcome(pkg.FaultInjector(
        pkg.parse_spec("keymap:persistent")).check, "keymap")
        for pkg in PACKAGES]
    assert got[0] == got[1] == ("InternalError", "bucket table full")


@pytest.mark.parametrize("frac", [0.01, 0.3, 0.75, 0.99])
def test_truncated_file_write_leaves_the_same_prefix(frac):
    data = bytes(range(256)) * 7
    got = []
    for pkg in PACKAGES:
        pkg.arm(pkg.FaultInjector(pkg.parse_spec(f"snapshot:truncate:{frac}")))
        f = io.BytesIO()
        err = _outcome(
            pkg.file_write_with_faults, "snapshot", f, data)
        pkg.disarm()
        clean = io.BytesIO()
        pkg.file_write_with_faults("snapshot", clean, data)
        got.append((err, f.getvalue(), clean.getvalue()))
    assert got[0] == got[1]
    assert got[1][0][0] == "TruncatedWriteError"
    assert got[1][1] == data[: max(1, int(len(data) * frac))]
    assert got[1][2] == data


def test_fsync_chokepoint_raises_before_durability(tmp_path):
    got = []
    for pkg in PACKAGES:
        path = tmp_path / pkg.__name__
        with open(path, "wb") as f:
            f.write(b"x")
            pkg.arm(pkg.FaultInjector(pkg.parse_spec("snapshot:fsyncfail")))
            err = _outcome(pkg.fsync_with_faults, "snapshot", f.fileno())
            pkg.disarm()
            ok = _outcome(pkg.fsync_with_faults, "snapshot", f.fileno())
        got.append((err, ok))
    assert got[0] == got[1]
    assert got[1][0][0] == "FsyncFailError" and got[1][1] is None


def test_partial_socket_send_puts_the_same_prefix_on_the_wire():
    frame = b"*5\r\n" + b"x" * 101
    got = []
    for pkg in PACKAGES:
        a, b = socket.socketpair()
        try:
            pkg.arm(pkg.FaultInjector(pkg.parse_spec("peer:partial")))
            err = _outcome(pkg.send_with_faults, "peer", a, frame)
            pkg.disarm()
            b.settimeout(5)
            received = b""
            while chunk := b.recv(4096):
                received += chunk
        finally:
            a.close()
            b.close()
        got.append((err, received))
    assert got[0] == got[1]
    assert got[1][0][0] == "PartialWriteError"
    assert got[1][1] == frame[: len(frame) // 2]


def test_site_errors_are_the_classifier_shapes():
    """Every site's raising shape, as each package's supervisor
    classifies it: device sites transient, keymap deterministic."""
    from throttlecrab_tpu.server.supervisor import (
        classify_exception as jax_classify,
    )
    from throttlecrab_tpu_torch.server.supervisor import classify_exception

    got = []
    for pkg, classify in zip(PACKAGES, (jax_classify, classify_exception)):
        row = []
        for site in pkg.SITES:
            inj = pkg.FaultInjector(pkg.parse_spec(f"{site}:persistent"))
            try:
                inj.check(site)
            except Exception as e:
                row.append((site, type(e).__name__, classify(e)))
        got.append(row)
    assert got[0] == got[1]
    assert dict((s, c) for s, _, c in got[1]) == {
        "launch": "transient", "fetch": "transient", "peer": "transient",
        "keymap": "deterministic", "snapshot": "deterministic",
        "migrate": "transient", "leave": "transient",
    }

