"""The comparison that decides `correct`.

After the window has closed, the reference (`reference/gcra.py`, plain
Python over the same inputs, nothing taken from the program) follows
every sampled key through all the launches the run made, populate and
warm-up included, and gives:

- the answer of every lane of a sampled key in one launch in `stride`
  (drawn from the seed), and in every launch the answers of the sampled
  keys' lanes in sub-batches that hold their key more than once; for
  the hot and drawn keys (the distribution's head, hundreds of lanes a
  sub-batch) only in one sub-batch in `hot_sub_stride`, also drawn from
  the seed (`SampleIndex.compared` decides, for the loop too); each
  held to the wire values (allowed, remaining, reset_after, retry_after)
  that the program's timed path finished for that lane;
- the sampled keys' state (TAT, expiry) after the last launch, held to
  the program's table rows at the keys' slots.

Both are exact: each limit is 0.  A key's answers depend on its own
requests only, so a sample of keys is judged on its whole history.
"""

from __future__ import annotations

import time
from bisect import bisect_left

import numpy as np

from .generate import is_compared, limits
from .reference import gcra


class KeyGroups:
    """One key's groups (its requests at one instant) over a run: the
    populate launches' explicitly, then the pool's, which repeat every
    `pool` launches.  Positions are global sub-batch numbers i*K + k."""

    def __init__(self, sched, pop, pool, n_launches) -> None:
        self.sched = sched
        self.pop_pos = [p for p, _ in pop]
        self.pop_n = [n for _, n in pop]
        self.off = [o for o, _ in pool]  # sorted, within one period
        self.off_n = [n for _, n in pool]
        self.base = sched.n_pop * sched.K
        self.period = (len(sched.windows) - sched.n_pop) * sched.K
        self.end = n_launches * sched.K

    def first(self, pos, t_min):
        if t_min is not None:
            pos = max(pos, self.sched.first_sub_at(t_min))
        if pos >= self.end:
            return None
        if pos < self.base:
            i = bisect_left(self.pop_pos, pos)
            if i < len(self.pop_pos):
                return self.pop_pos[i] if self.pop_pos[i] < self.end else None
            pos = self.base
        if not self.off:
            return None
        m, r = divmod(pos - self.base, self.period)
        i = bisect_left(self.off, r)
        if i == len(self.off):
            m, i = m + 1, 0
        p = self.base + m * self.period + self.off[i]
        return p if p < self.end else None

    def time(self, pos):
        return self.sched.time_of(pos)

    def count(self, pos):
        if pos < self.base:
            return self.pop_n[self.pop_pos.index(pos)]
        r = (pos - self.base) % self.period
        return self.off_n[bisect_left(self.off, r)]


def key_groups(sched, index, n_keys_sampled, n_launches):
    """[KeyGroups] for every sampled key."""
    pop = [[] for _ in range(n_keys_sampled)]
    pool = [[] for _ in range(n_keys_sampled)]
    for w, (key, sub, cnt) in enumerate(index.groups):
        if w < sched.n_pop:
            for s, k, n in zip(key.tolist(), sub.tolist(), cnt.tolist()):
                pop[s].append((w * sched.K + k, n))
        else:
            base = (w - sched.n_pop) * sched.K
            for s, k, n in zip(key.tolist(), sub.tolist(), cnt.tolist()):
                pool[s].append((base + k, n))
    return [KeyGroups(sched, sorted(pop[s]), sorted(pool[s]), n_launches)
            for s in range(n_keys_sampled)]


def expected_lanes(sched, index, n_launches, per_key):
    """{launch: i64[lanes, 4]}: the reference's answer of every compared
    lane of each launch (`SampleIndex.compared`), from
    `per_key[s][pos]` (answers up to the group's first denial; later
    lanes repeat it)."""
    out = {}
    for i in range(n_launches):
        sel = index.compared(i)
        if not len(sel):
            continue
        w = sched.window_of(i)
        key, sub = index.lane_key[w][sel], index.lane_sub[w][sel]
        rank = index.lane_rank[w][sel]
        gid = key * sched.K + sub
        ug, ginv = np.unique(gid, return_inverse=True)
        flat, off, length = [], [], []
        for g in ug.tolist():
            ans = per_key[g // sched.K][i * sched.K + g % sched.K]
            off.append(len(flat))
            length.append(len(ans))
            flat.extend(ans)
        flat = np.asarray(flat, np.int64).reshape(-1, 4)
        off, length = np.asarray(off), np.asarray(length)
        out[i] = flat[off[ginv] + np.minimum(rank, length[ginv] - 1)]
    return out


def wanted_positions(sched, index, n_launches, n_keys):
    """Per sampled key, the sorted positions of its groups whose answers
    are compared: those that hold a lane `SampleIndex.compared` picks."""
    gids = []
    for i in range(n_launches):
        sel = index.compared(i)
        w = sched.window_of(i)
        gids.append(np.unique(index.lane_key[w][sel] * (n_launches * sched.K)
                              + i * sched.K + index.lane_sub[w][sel]))
    gid = np.concatenate(gids) if gids else np.zeros(0, np.int64)
    keys, pos = np.divmod(gid, n_launches * sched.K)
    order = np.lexsort((pos, keys))
    cuts = np.searchsorted(keys[order], np.arange(n_keys + 1))
    pos = pos[order]
    return [pos[cuts[s]:cuts[s + 1]].tolist() for s in range(n_keys)]


def reference_run(sched, keys, index, n_launches, decide=None, walk=None):
    """Follow every sampled key (`gcra.follow`, or `walk`, which takes
    (em, tol, groups, compared positions)); returns (expected lanes per
    launch, final tat i64[S] (None as I64_MIN), final expiry i64[S])."""
    burst, count, period = (a[keys] for a in limits(sched.cfg))
    groups = key_groups(sched, index, len(keys), n_launches)
    wanted = wanted_positions(sched, index, n_launches, len(keys))
    per_key, tats, exps = [], [], []
    if walk is None:
        kw = {} if decide is None else {"decide": decide}

        def walk(em, tol, g, c):
            return gcra.follow(em, tol, g, c, **kw)

    for s in range(len(keys)):
        em, tol = gcra.derive(int(burst[s]), int(count[s]), int(period[s]))
        ans, tat, exp = walk(em, tol, groups[s], wanted[s])
        per_key.append(ans)
        tats.append(gcra.I64_MIN if tat is None else tat)
        exps.append(gcra.I64_MIN if exp is None else exp)
    lanes = expected_lanes(sched, index, n_launches, per_key)
    return lanes, np.asarray(tats, np.int64), np.asarray(exps, np.int64)


def compare(sched, keys, index, result) -> dict:
    """The numbers that decide `correct`, each with its limit, from a
    run's `result`: the launches it made, its finished answers of the
    compared lanes of each launch (`kept`), and its final rows of the
    sampled keys.  The compared lanes follow from the seed and the
    traffic, not from what the run kept: a launch it did not keep counts
    every compared lane of it wrong."""
    t = time.perf_counter()
    n = result["launches"]
    lanes, tats, exps = reference_run(sched, keys, index, n)
    lanes_wrong = lanes_checked = hot_checked = 0
    for i, want in lanes.items():
        lanes_checked += len(want)
        hot_checked += index.strided_lanes(i, index.compared(i))
        got = result["kept"].get(i)
        if got is None or np.shape(got) != want.shape:
            lanes_wrong += len(want)
            continue
        lanes_wrong += int((np.asarray(got, np.int64) != want).any(axis=1)
                           .sum())
    got_tat, got_exp = result["rows"]
    rows_wrong = int(((got_tat != tats) | (got_exp != exps)).sum())
    return {
        "numbers": [
            ["lanes_wrong", lanes_wrong, 0],
            ["rows_wrong", rows_wrong, 0],
        ],
        "lanes_checked": lanes_checked,
        "hot_lanes_checked": hot_checked,
        "launches_compared": sum(is_compared(i, index.rule)
                                 for i in range(n)),
        "keys_checked": len(keys),
        "reference_s": time.perf_counter() - t,
    }


def correct(report: dict) -> bool:
    return report["lanes_checked"] > 0 and all(
        v <= lim for _, v, lim in report["numbers"])
