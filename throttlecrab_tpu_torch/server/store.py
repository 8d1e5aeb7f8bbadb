"""Limiter/policy factory: config -> engine parts (reference: store.rs:57-87).

The "store" choice selects the cleanup policy; the bucket table itself is
always the device table of `TorchRateLimiter`.  The launch supervisor, the
front tier and the insight tier wrap, front and watch it, and the
control plane tunes their knobs, as the JAX server's factories do
(`throttlecrab_tpu/server/store.py`).
"""

from __future__ import annotations

import dataclasses
import inspect
import logging

from ..front import AdmissionController, DenyCache, FrontTier
from ..insight import InsightTier
from ..tpu.cleanup import CleanupPolicy, make_policy
from ..tpu.limiter import TorchRateLimiter, limiter_uses_bytes_keys
from .supervisor import SupervisedLimiter

log = logging.getLogger("throttlecrab.store")


def create_limiter(config) -> TorchRateLimiter:
    """The single-device limiter the engine will drive, on
    `config.device` (raises when that device is absent).  With the
    insight tier on (the default) its table stores the 6-wide rows and
    every window accumulates the insight totals."""
    return TorchRateLimiter(
        capacity=config.store_capacity,
        keymap=config.keymap,
        device=config.device,
        insight=config.insight,
    )


def create_supervised_limiter(config, limiter, metrics=None):
    """Wrap the device limiter in the failure-domain supervisor: transient
    launch/fetch faults retry with bounded backoff, persistent device
    failure degrades to the host scalar oracle
    (THROTTLECRAB_SUPERVISOR_MODE=degrade), and recovery re-promotes.
    One wrapper supervises every transport, because they all share the
    same limiter."""
    return SupervisedLimiter(
        limiter,
        retries=config.supervisor_retries,
        backoff_us=config.supervisor_backoff_us,
        backoff_max_us=config.supervisor_backoff_max_us,
        probe_interval_ms=config.supervisor_probe_interval_ms,
        mode=config.supervisor_mode,
        metrics=metrics,
    )


def create_front_tier(config, metrics, limiter):
    """The front tier (exact deny cache + admission control) from the
    THROTTLECRAB_FRONT_* knobs, or None when both halves are disabled.
    One instance is shared by the asyncio engine and every native
    transport driving the same limiter."""
    # Probe the DEVICE limiter, not a supervision wrapper, whose uniform
    # signatures would make a cur-less limiter look certifiable.
    limiter = getattr(limiter, "inner", limiter)
    # A deny cache certifies entries only from the exact observed TAT:
    # the cur tier (collect_cur) or, for non-wire limiters, the full-ns
    # result planes.  Without either only admission is built.
    try:
        params = inspect.signature(limiter.rate_limit_batch).parameters
    except (AttributeError, TypeError, ValueError):
        params = {}
    certifiable = "collect_cur" in params or "wire" not in params
    if config.front_deny_cache > 0 and not certifiable:
        default = next(f.default for f in dataclasses.fields(type(config))
                       if f.name == "front_deny_cache")
        emit = (log.info if config.front_deny_cache == default
                else log.warning)
        emit(
            "front-tier deny cache configured "
            "(THROTTLECRAB_FRONT_DENY_CACHE=%d) but this limiter "
            "cannot certify entries (no exact observed-TAT surface); "
            "building admission control only — set "
            "THROTTLECRAB_FRONT_DENY_CACHE=0 to silence",
            config.front_deny_cache,
        )
    deny = (
        DenyCache(config.front_deny_cache)
        if config.front_deny_cache > 0 and certifiable
        else None
    )
    admission = None
    if config.front_max_pending or config.front_max_wait_us:
        admission = AdmissionController(
            max_pending=config.front_max_pending,
            max_wait_us=config.front_max_wait_us,
            peek_frac=config.front_peek_frac,
        )
    if deny is None and admission is None:
        return None
    front = FrontTier(
        deny, admission, metrics=metrics,
        bytes_keys=limiter_uses_bytes_keys(limiter),
    )
    if metrics is not None:
        metrics.set_front_stats_provider(front.stats)
    return front


def create_insight(config, metrics, limiter, front):
    """The insight tier (device-resident traffic analytics + the
    deny-cache/admission feedback loop) from the THROTTLECRAB_INSIGHT_*
    knobs, or None when disabled or the limiter cannot carry it: a
    limiter whose table has no insight columns drops the tier loudly."""
    if not config.insight:
        return None
    dev = getattr(limiter, "inner", limiter)
    table = getattr(dev, "table", None)
    if table is None or not getattr(table, "insight", False):
        log.warning(
            "insight tier requested (THROTTLECRAB_INSIGHT=1) but the "
            "%s limiter's table does not carry the insight "
            "accumulators; serving WITHOUT /stats analytics or the "
            "admission/deny-cache feedback loop — set "
            "THROTTLECRAB_INSIGHT=0 to silence",
            type(dev).__name__,
        )
        return None
    insight = InsightTier(
        limiter=dev,
        sketch_capacity=config.insight_sketch,
        topk=config.insight_topk,
        window_s=config.insight_window_s,
        poll_ms=config.insight_poll_ms,
        decay_s=config.insight_decay_s,
        prewarm=config.insight_prewarm,
        hot_denies=config.insight_hot_denies,
        shed_weight=config.insight_shed_weight,
        front=front,
    )
    if metrics is not None:
        metrics.set_insight_stats_provider(insight.metric_stats)
    # Pay the poll ops' first calls at boot, not inside the first
    # serving flush under the limiter lock.
    insight.prime()
    return insight


def create_control(config, metrics, limiter, front, insight,
                   cleanup_policy):
    """The control plane (L3.9: adaptive feedback over the knob
    surface) from the THROTTLECRAB_CONTROL_* knobs, or None when
    disabled — the kill switch builds NOTHING, so decisions and every
    knob value are bit-identical to the subsystem absent.  Sensors and
    actuators register only for the subsystems this deployment built
    (a front-less boot simply has fewer knobs to move)."""
    from ..control import create_control_plane

    plane = create_control_plane(
        config,
        front=front,
        insight=insight,
        cleanup_policy=cleanup_policy,
        limiter=limiter,
        metrics=metrics,
    )
    if plane is not None:
        log.info(
            "control plane armed: mode=%s tick=%dms actuators=%s",
            config.control_mode, config.control_tick_ms,
            ",".join(plane.registry.names()),
        )
    return plane


def create_cleanup_policy(config) -> CleanupPolicy:
    """store.rs:57-87: the store type decides when cleanup runs."""
    if config.store == "periodic":
        return make_policy(
            "periodic", cleanup_interval_secs=config.store_cleanup_interval
        )
    if config.store == "probabilistic":
        return make_policy(
            "probabilistic",
            cleanup_probability=config.store_cleanup_probability,
        )
    return make_policy(
        "adaptive",
        min_interval_secs=config.store_min_interval,
        max_interval_secs=config.store_max_interval,
        max_operations=config.store_max_operations,
    )
