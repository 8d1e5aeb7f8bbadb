"""The benchmark's plain reference: GCRA as the upstream throttlecrab
states it (`src/core/rate_limiter.rs`, `src/core/rate/mod.rs`), one
request at a time, per key, in Python integers.

Nothing here comes from the program under test: the parameters are
worked out from (burst, count, period) again, and the state is the
reference's own.  Requests of one key at one instant (duplicates inside
a sub-batch) are decided one after the other, each seeing the write of
the one before it.

`follow` walks one key's groups (its requests at one instant) in time
order.  It skips a group only where the key's first request there is a
foregone denial, since a denial writes nothing; `tests/test_reference.py`
holds the skipping walk to a walk over every group.
"""

from __future__ import annotations

NS_PER_SEC = 1_000_000_000
I64_MIN = -(1 << 63)
I64_MAX = (1 << 63) - 1
U64_MAX = (1 << 64) - 1


def _wrap_i64(x: int) -> int:
    x &= U64_MAX
    return x - (1 << 64) if x > I64_MAX else x


def derive(burst: int, count: int, period: int) -> tuple[int, int]:
    """(emission_ns, tolerance_ns) of one key: emission is period / count
    through f64 (`rate/mod.rs`), cast to u64 with saturation; tolerance
    is emission * ((burst - 1) as u32); both narrowed to i64 with
    wrapping, as the upstream's `as_nanos() as i64` casts."""
    if burst <= 0 or count <= 0 or period <= 0:
        raise ValueError(f"invalid limit ({burst}, {count}, {period})")
    em_f = float(period) * 1e9 / float(count)
    em = U64_MAX if em_f >= 2.0 ** 64 else int(em_f)
    tol = em * ((burst - 1) & 0xFFFFFFFF)
    return _wrap_i64(em), _wrap_i64(tol)


def _div_trunc(a: int, b: int) -> int:
    q = abs(a) // abs(b)
    return q if (a >= 0) == (b > 0) else -q


def request(tat, exp, t: int, em: int, tol: int):
    """One request of quantity 1 at `t` against the stored (tat, expiry),
    tat None where the key holds nothing.  Returns ((allowed, remaining,
    reset_after_secs, retry_after_secs), tat, expiry) after it."""
    live = tat is not None and exp > t
    base = max(tat, t - tol) if live else t - em
    new = base + em
    allow_at = new - tol
    allowed = t >= allow_at
    cur = new if allowed else base
    if not I64_MIN <= min(base, new, allow_at) <= max(base, new) <= I64_MAX:
        raise OverflowError("times beyond i64: the reference saturates "
                            "nothing, so it refuses them")
    remaining = max(_div_trunc(t + tol - cur, em), 0) if em > 0 else 0
    reset = max(cur - t + tol, 0) // NS_PER_SEC
    retry = 0 if allowed else max(allow_at - t, 0) // NS_PER_SEC
    if allowed:
        ttl = new - t + tol  # > 0 for em > 0, so it always expires
        tat, exp = new, (t + ttl if ttl >= 0 else I64_MAX)
    return (int(allowed), remaining, reset, retry), tat, exp


def group(tat, exp, t: int, n: int, em: int, tol: int):
    """`n` requests of one key at one instant, in order.  Returns (answers,
    tat, expiry): answers holds one entry per request up to and with the
    first denial; every later request of the group gets that denial's
    answer, since a denial writes nothing and the next request meets the
    same state at the same time."""
    answers = []
    for _ in range(n):
        ans, tat2, exp2 = request(tat, exp, t, em, tol)
        answers.append(ans)
        if not ans[0]:
            break
        tat, exp = tat2, exp2
    return answers, tat, exp


def group_independent(tat, exp, t: int, n: int, em: int, tol: int):
    """The control's group: every request of the instant decided against
    the state the instant started with, one write for the lot.  This
    breaks the configuration's guarantee that a request sees the writes
    of the requests of its key before it."""
    ans, tat, exp = request(tat, exp, t, em, tol)
    return [ans], tat, exp


def _foregone(tat, exp, em, tol):
    """The time before which a request meeting (tat, expiry) is a foregone
    denial: while t < expiry the key is live, and while also
    t < tat + em - tol it is denied.  None where nothing is stored."""
    return None if tat is None else min(exp, tat + em - tol)


def follow_launch_start(em: int, tol: int, groups, compared, per_launch,
                        skip=True):
    """The second control's walk: every sub-batch of a launch decided
    against the state the launch started with (`per_launch` sub-batches
    a launch), the launch's last write kept.  This breaks the guarantee
    that a request sees the writes of its key's requests in earlier
    sub-batches.  Returns as `follow`."""
    tat = exp = None
    out = {}
    launch, seen = -1, (None, None)
    pos, ci = 0, 0
    while True:
        nxt = groups.first(pos, _foregone(*seen, em, tol) if skip else None)
        if (tat, exp) != seen:  # a write: the next launch starts from it
            edge = groups.first((launch + 1) * per_launch, None)
            if edge is not None and (nxt is None or edge < nxt):
                nxt = edge
        if ci < len(compared) and (nxt is None or compared[ci] <= nxt):
            nxt = compared[ci]
            ci += 1
        if nxt is None:
            return out, tat, exp
        if nxt // per_launch != launch:
            launch, seen = nxt // per_launch, (tat, exp)
        answers, t2, e2 = group(*seen, groups.time(nxt), groups.count(nxt),
                                em, tol)
        if answers[0][0]:
            tat, exp = t2, e2
        if ci and compared[ci - 1] == nxt:
            out[nxt] = answers
        pos = nxt + 1


def follow(em: int, tol: int, groups, compared, decide=group, skip=True):
    """Walk one key through its groups.  `groups` has `first(pos, t_min)`
    (the position of the key's first group at or after position `pos`
    whose time is at least `t_min`, None past the run; t_min None means
    any time), `time(pos)` and `count(pos)`.  `compared` lists, sorted,
    the positions whose answers are wanted.  Returns ({pos: answers},
    tat, expiry) with answers as `group` gives them."""
    tat = exp = None
    out = {}
    pos, ci = 0, 0
    while True:
        nxt = groups.first(pos, _foregone(tat, exp, em, tol) if skip
                           else None)
        if ci < len(compared) and (nxt is None or compared[ci] <= nxt):
            nxt = compared[ci]
            ci += 1
        if nxt is None:
            return out, tat, exp
        t, n = groups.time(nxt), groups.count(nxt)
        answers, tat, exp = decide(tat, exp, t, n, em, tol)
        if ci and compared[ci - 1] == nxt:
            out[nxt] = answers
        pos = nxt + 1
