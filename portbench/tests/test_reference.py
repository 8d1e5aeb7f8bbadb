"""The plain reference against the JAX package's scalar GCRA, on the CPU.

This file alone of the benchmark imports JAX's package: its scalar
`throttlecrab_tpu.core.RateLimiter` (here over a `PeriodicStore`, whose
cleanup changes no answer) is the upstream's semantics in Python, and
the reference must give the same answers request for request.  It also holds the reference's skipping walks to
walks over every group.
"""

from bisect import bisect_left

import numpy as np
import pytest

from throttlecrab_tpu.core.rate_limiter import RateLimiter, derive_intervals
from throttlecrab_tpu.core.store.periodic import PeriodicStore

from portbench.reference import gcra


class ListGroups:
    """A key's groups as explicit sorted lists (positions, times, counts),
    as `gcra.follow` reads them."""

    def __init__(self, pos, times, counts) -> None:
        self.pos, self.times, self.counts = list(pos), list(times), list(
            counts)

    def _at(self, p):
        i = bisect_left(self.pos, p)
        if i == len(self.pos) or self.pos[i] != p:
            raise KeyError(p)
        return i

    def first(self, p, t_min):
        i = bisect_left(self.pos, p)
        if t_min is not None:
            i = max(i, bisect_left(self.times, t_min))
        return self.pos[i] if i < len(self.pos) else None

    def time(self, p):
        return self.times[self._at(p)]

    def count(self, p):
        return self.counts[self._at(p)]


T0 = 1_800_000_000_000_000_000
LIMITS = [(1, 1, 1), (2, 7, 3), (5, 50, 30), (64, 1049, 149), (10, 100, 60),
          (3, 1, 3600), (1000, 3, 1), (7, 1000, 1)]


@pytest.mark.parametrize("limit", LIMITS)
def test_derive_matches_the_scalar_limiter(limit):
    assert gcra.derive(*limit) == derive_intervals(*limit)


def stream(seed, n_groups, limit):
    """Groups (t, n) of one key: instants that repeat, gaps under and over
    the key's expiry, up to 40 requests an instant."""
    rng = np.random.default_rng(seed)
    em, tol = derive_intervals(*limit)
    t, out = T0, []
    for _ in range(n_groups):
        gap = rng.choice([0, 1, em // 3 + 1, em, tol + em + 1, 250_000_000])
        t += int(gap) + int(rng.integers(0, 1000))
        out.append((t, int(rng.choice([1, 1, 2, 3, 40]))))
    return out


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("limit", LIMITS)
def test_request_by_request_equals_the_scalar_limiter(seed, limit):
    em, tol = gcra.derive(*limit)
    lim = RateLimiter(PeriodicStore())
    tat = exp = None
    for t, n in stream(seed, 60, limit):
        answers, tat, exp = gcra.group(tat, exp, t, n, em, tol)
        for r in range(n):
            ok, res = lim.rate_limit("k", *limit, 1, t)
            want = (int(ok), res.remaining, res.reset_after_secs,
                    res.retry_after_secs)
            assert answers[min(r, len(answers) - 1)] == want


def walk_all(em, tol, groups_list, compared):
    """Every group visited, one request at a time."""
    tat = exp = None
    out = {}
    for p, (t, n) in enumerate(groups_list):
        answers, tat, exp = gcra.group(tat, exp, t, n, em, tol)
        if p in compared:
            out[p] = answers
    return out, tat, exp


@pytest.mark.parametrize("seed", range(8))
@pytest.mark.parametrize("limit", LIMITS)
def test_skipping_walk_equals_visiting_every_group(seed, limit):
    em, tol = gcra.derive(*limit)
    groups_list = stream(seed, 200, limit)
    g = ListGroups(range(len(groups_list)), [t for t, _ in groups_list],
                        [n for _, n in groups_list])
    compared = sorted(np.random.default_rng(seed).choice(
        len(groups_list), 30, replace=False).tolist())
    want = walk_all(em, tol, groups_list, set(compared))
    assert gcra.follow(em, tol, g, compared) == want
    assert gcra.follow(em, tol, g, compared, skip=False) == want


@pytest.mark.parametrize("seed", range(8))
@pytest.mark.parametrize("per_launch", [1, 3, 16])
def test_launch_start_walk_skips_nothing_it_should_not(seed, per_launch):
    limit = LIMITS[seed % len(LIMITS)]
    em, tol = gcra.derive(*limit)
    groups_list = stream(seed, 200, limit)
    g = ListGroups(range(len(groups_list)), [t for t, _ in groups_list],
                        [n for _, n in groups_list])
    compared = list(range(0, len(groups_list), 3))
    assert (gcra.follow_launch_start(em, tol, g, compared, per_launch)
            == gcra.follow_launch_start(em, tol, g, compared, per_launch,
                                        skip=False))
    if per_launch == 1:  # one group a launch: nothing to break
        assert (gcra.follow_launch_start(em, tol, g, compared, 1)
                == gcra.follow(em, tol, g, compared))
