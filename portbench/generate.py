"""The one traffic generator: a configuration and a mix, both data files,
and `--seed` give every key, its limits, and the ids of every launch.

A run is a sequence of launches, each K sub-batches of B raw key ids.
The first launches touch every key once (`populate`, as bench.py's
`_populate`); every later launch takes the next window of a pool of
`pool` windows drawn from the configuration's key distribution, in
turn.  Launch i's sub-batch k is decided at t0 + i*step + (k*step)//K
ns, so the clock advances `step_ns` a launch, as bench.py's does, with
the sub-batches spread over it.  The same seed gives the same ids,
limits and times, whatever the program does with them.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

SEED_MASK = (1 << 64) - 1


def rng_for(seed: int, stream: int) -> np.random.Generator:
    """An independent generator per purpose, all from `--seed`."""
    return np.random.default_rng([int(seed) & SEED_MASK, stream])


def key_names(cfg: dict) -> list:
    """The configuration's key names as bytes (`key_name` % id)."""
    fmt = cfg["key_name"].encode()
    return [fmt % i for i in range(cfg["keys"])]


def limits(cfg: dict) -> tuple:
    """(burst, count, period_s) i64[keys]: each `base + id % mod` (`mod`
    absent: the same for every key).  Config 3's per-key formula is
    bench.py's (burst 5 + id%60, count 50 + id%1000, period 30 + id%120),
    as `chip_smoke.py::config3_params` has it."""
    kid = np.arange(cfg["keys"], dtype=np.int64)
    out = []
    for name in ("burst", "count", "period_s"):
        p = cfg["params"][name]
        out.append(p["base"] + (kid % p["mod"] if "mod" in p else 0 * kid))
    return tuple(out)


def key_pmf(cfg: dict):
    """The probability of each key id, None for uniform.  Zipf with
    exponent s over ids 0..n-1, id 0 hottest: `chip_smoke.py::
    byid_plan`'s distribution (bench.py's `zipf_indices`)."""
    dist = cfg["key_dist"]
    if dist["kind"] == "uniform":
        return None
    if dist["kind"] != "zipf":
        raise ValueError(f"unknown key distribution {dist['kind']!r}")
    p = np.arange(1, cfg["keys"] + 1, dtype=np.float64) ** -dist["s"]
    return p / p.sum()


def draw_ids(rng, cfg: dict, pmf, n: int) -> np.ndarray:
    """`n` independent draws of a key id.  A skewed one as how many times
    each id comes (a multinomial) in a random order: the same law as `n`
    draws one by one, at half the cost of searching a CDF for each."""
    if pmf is None:
        return rng.integers(0, cfg["keys"], n).astype(np.int32)
    counts = rng.multinomial(n, pmf)
    return rng.permutation(np.repeat(np.arange(cfg["keys"], dtype=np.int32),
                                     counts))


@dataclass
class Schedule:
    """Every launch's ids and times for one (configuration, mix, seed)."""

    cfg: dict
    mix: dict
    seed: int
    windows: list = field(default_factory=list)  # distinct id windows
    n_pop: int = 0

    def __post_init__(self) -> None:
        self.K = int(self.mix["depth"])
        self.B = int(self.cfg["batch"])
        self.step = int(self.mix["step_ns"])
        self.t0 = int(self.mix["t0_ns"])
        per = self.K * self.B
        order = rng_for(self.seed, 1).permutation(
            self.cfg["keys"]).astype(np.int32)
        for start in range(0, len(order), per):
            ids = np.full(per, -1, np.int32)
            chunk = order[start:start + per]
            ids[:len(chunk)] = chunk
            self.windows.append(ids.reshape(self.K, self.B))
        self.n_pop = len(self.windows)
        rng, pmf = rng_for(self.seed, 2), key_pmf(self.cfg)
        for _ in range(int(self.mix["pool"])):
            self.windows.append(
                draw_ids(rng, self.cfg, pmf, per).reshape(self.K, self.B))
        self.sub_offsets = (np.arange(self.K, dtype=np.int64)
                            * self.step) // self.K

    def window_of(self, i: int) -> int:
        """Index into `windows` of launch i."""
        if i < self.n_pop:
            return i
        return self.n_pop + (i - self.n_pop) % (len(self.windows)
                                                - self.n_pop)

    def ids(self, i: int) -> np.ndarray:
        return self.windows[self.window_of(i)]

    def now(self, i: int) -> np.ndarray:
        """i64[K]: sub-batch k of launch i is decided at
        t0 + i*step + (k*step)//K."""
        return self.t0 + i * self.step + self.sub_offsets

    def time_of(self, j: int) -> int:
        """The time of global sub-batch j = i*K + k."""
        i, k = divmod(j, self.K)
        return self.t0 + i * self.step + (k * self.step) // self.K

    def first_sub_at(self, t: int) -> int:
        """The first global sub-batch whose time is at least `t`."""
        if t <= self.t0:
            return 0
        i, r = divmod(t - self.t0, self.step)
        # (k*step)//K >= r  <=>  k*step >= r*K
        k = -(-(r * self.K) // self.step)
        return i * self.K + k  # k == K rolls over to launch i+1


@dataclass(frozen=True, eq=False)
class Rule:
    """Which of a run's answers the check compares, all from the seed:
    launches compared whole (one in `stride`, `salt`), and for the
    `strided` sampled keys (the hot and drawn ones, bool[S] over the
    sample) the sub-batches compared (one in `sub_stride`, `sub_salt`)."""

    stride: int
    salt: int
    sub_stride: int
    sub_salt: int
    strided: np.ndarray


def check_sample(sched: Schedule) -> tuple:
    """(sampled key ids i64[S], `Rule`): the keys whose answers in the
    compared launches and sub-batches, and whose state after the run, the
    check compares.  The mix's `check` says how many: the `hot` most
    likely ids, `drawn` distinct ids drawn from the key distribution
    itself, `uniform` ids drawn uniformly from all keys; and, optionally,
    `hot_sub_stride` (1 where absent) for the hot and drawn keys."""
    chk, cfg = sched.mix["check"], sched.cfg
    rng, n = rng_for(sched.seed, 3), cfg["keys"]
    pmf = key_pmf(cfg)
    hot = np.arange(min(chk["hot"], n), dtype=np.int64)
    picked = set(hot.tolist())
    drawn = []
    while len(drawn) < chk["drawn"] and len(picked) < n:
        for x in draw_ids(rng, cfg, pmf, 4 * chk["drawn"]).tolist():
            if x not in picked and len(drawn) < chk["drawn"]:
                picked.add(x)
                drawn.append(x)
    rest = np.setdiff1d(np.arange(n), np.fromiter(picked, np.int64))
    uni = rng.choice(rest, min(chk["uniform"], len(rest)), replace=False)
    keys = np.unique(np.concatenate([hot, np.asarray(drawn, np.int64),
                                     uni.astype(np.int64)]))
    salt = int(rng.integers(0, 1 << 63))
    # From a stream of its own: the sample and the launch salt are the
    # same whether or not the mix strides.
    sub_salt = int(rng_for(sched.seed, 4).integers(0, 1 << 63))
    head = np.fromiter(picked, np.int64, len(picked))  # hot and drawn
    return keys, Rule(int(chk["stride"]), salt,
                      int(chk.get("hot_sub_stride", 1)), sub_salt,
                      np.isin(keys, head))


def _mix64(x):
    """splitmix64's finaliser: a launch (or sub-batch) number to 64
    well-mixed bits; on a Python int, or elementwise on u64 numpy."""
    if isinstance(x, np.ndarray):
        with np.errstate(over="ignore"):
            x = x + np.uint64(0x9E3779B97F4A7C15)
            x = (x ^ (x >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
            x = (x ^ (x >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
        return x ^ (x >> np.uint64(31))
    x = (x + 0x9E3779B97F4A7C15) & SEED_MASK
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & SEED_MASK
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & SEED_MASK
    return x ^ (x >> 31)


def is_compared(i: int, rule: Rule) -> bool:
    """Whether launch i is compared whole: one launch in `stride`, drawn
    from the seed launch by launch.  A fixed stride would alias with the
    traffic's own periods (the pool's turn, a key's emission interval in
    launches) and could miss every allowance of a key."""
    return _mix64(i ^ rule.salt) % rule.stride == 0


def compared_subs(i: int, K: int, rule: Rule) -> np.ndarray:
    """The sub-batches of launch i (ascending) in which the strided keys'
    lanes are compared: global sub-batch i*K + k is, one in
    `sub_stride`, drawn from the seed as `is_compared` draws launches."""
    if rule.sub_stride == 1:
        return np.arange(K)
    j = np.arange(i * K, (i + 1) * K, dtype=np.uint64)
    return np.flatnonzero(_mix64(j ^ np.uint64(rule.sub_salt))
                          % np.uint64(rule.sub_stride) == 0)


@dataclass
class SampleIndex:
    """Where the sampled keys sit in each distinct window: per window the
    flat lanes (ascending) holding a sampled key, with the key's index in
    the sample, its sub-batch, its rank among that key's lanes in the
    sub-batch (lane order) and whether the sub-batch holds the key more
    than once; per window the (key, sub-batch, count) groups; and what
    `compared` reads: per window the lanes of the keys compared in every
    sub-batch (`plain`, `plain_dup`), and those of the strided keys by
    sub-batch (`by_sub`, `sub_cuts`)."""

    sched: Schedule
    rule: Rule
    lanes: list = field(default_factory=list)
    lane_key: list = field(default_factory=list)
    lane_sub: list = field(default_factory=list)
    lane_rank: list = field(default_factory=list)
    lane_dup: list = field(default_factory=list)
    groups: list = field(default_factory=list)  # (key, sub, count) i64[G]
    plain: list = field(default_factory=list)
    plain_dup: list = field(default_factory=list)
    by_sub: list = field(default_factory=list)
    sub_cuts: list = field(default_factory=list)

    def compared(self, i: int) -> np.ndarray:
        """Indices (ascending) into `lanes[w]`, w launch i's window, of
        the lanes launch i has compared.  In a launch the seed's rule
        picks (`is_compared`) every sampled lane, in the others the lanes
        of sub-batches that hold their key more than once, where a
        request has to see the write of the one before it; for the
        strided keys only in the sub-batches `compared_subs` picks."""
        w, rule = self.sched.window_of(i), self.rule
        whole = is_compared(i, rule)
        plain = self.plain[w] if whole else self.plain_dup[w]
        if rule.sub_stride == 1:
            return plain
        cuts, by_sub = self.sub_cuts[w], self.by_sub[w]
        subs = compared_subs(i, self.sched.K, rule)
        parts = [plain] + [by_sub[cuts[k]:cuts[k + 1]] for k in subs.tolist()]
        sel = np.sort(np.concatenate(parts))
        return sel if whole else sel[self.lane_dup[w][sel]]

    def strided_lanes(self, i: int, sel: np.ndarray) -> int:
        """How many of launch i's compared lanes `sel` are strided keys'."""
        w = self.sched.window_of(i)
        return int(self.rule.strided[self.lane_key[w][sel]].sum())

    @classmethod
    def build(cls, sched: Schedule, keys: np.ndarray,
              rule: Rule) -> "SampleIndex":
        # One more entry, -1, for the padding's id -1 to read.
        lut = np.full(sched.cfg["keys"] + 1, -1, np.int32)
        lut[keys] = np.arange(len(keys))
        out = cls(sched, rule)
        for w in sched.windows:
            loc = lut[w.reshape(-1)]
            lanes = np.flatnonzero(loc >= 0)
            key, sub = loc[lanes].astype(np.int64), lanes // sched.B
            gid = key * sched.K + sub
            order = np.argsort(gid, kind="stable")  # lanes ascend
            g_sorted = gid[order]
            starts = np.flatnonzero(np.r_[True, g_sorted[1:] != g_sorted[:-1]])
            counts = np.diff(np.r_[starts, len(g_sorted)])
            rank_sorted = np.arange(len(g_sorted)) - np.repeat(starts, counts)
            rank = np.empty_like(rank_sorted)
            rank[order] = rank_sorted
            dup = np.empty(len(order), bool)
            dup[order] = np.repeat(counts > 1, counts)
            out.lanes.append(lanes)
            out.lane_key.append(key)
            out.lane_sub.append(sub)
            out.lane_rank.append(rank)
            out.lane_dup.append(dup)
            ug = g_sorted[starts]
            out.groups.append((ug // sched.K, ug % sched.K, counts))
            strided = rule.strided[key] & (rule.sub_stride > 1)
            out.plain.append(np.flatnonzero(~strided))
            out.plain_dup.append(np.flatnonzero(~strided & dup))
            at = np.flatnonzero(strided)  # ascending lanes, so by sub too
            out.by_sub.append(at)
            out.sub_cuts.append(np.searchsorted(sub[at],
                                                np.arange(sched.K + 1)))
        return out
