"""Fault injection (chaos) subsystem: the port of `throttlecrab_tpu/faults/`.

Deterministic, virtual-time-friendly fault injection threaded through
the port's failure surfaces: device launch and deferred fetch
(tpu/limiter.py), keymap capacity exhaustion (`_prepare_one`) and
snapshot I/O (tpu/snapshot.py).  The cluster sites (peer, migrate,
leave) parse as in the JAX package but nothing in the port checks them
until the cluster tier is ported.  Armed via the ``THROTTLECRAB_FAULTS``
knob or :func:`arm`; see injector.py for the spec grammar and the
exception taxonomy each site reproduces.
"""

from .injector import (  # noqa: F401  (re-exported API)
    MODES,
    SITES,
    FaultInjector,
    FaultSpec,
    FsyncFailError,
    InjectedDeviceError,
    PartialWriteError,
    TruncatedWriteError,
    active_injector,
    arm,
    disarm,
    file_write_with_faults,
    fsync_with_faults,
    maybe_fail,
    parse_spec,
    send_with_faults,
)
