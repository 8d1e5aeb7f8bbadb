"""Batched GCRA decision: row layout, host certificates and the plain decide.

The counterpart of `throttlecrab_tpu/tpu/kernel.py`, limited to what the
serving and by-id launch paths reach.  A decision window is K
sub-batches of B requests against a table of packed int32 state rows;
each sub-batch gathers its slots' rows, evaluates the GCRA closed forms,
and writes the surviving state back at unique indices.  The sub-batches
run strictly in order: a slot may recur in sub-batch k+1 and must see
k's write.

Intra-batch duplicate keys
==========================

The host keymap emits the segment structure of each sub-batch: per
request its key's occurrence number `rank` and whether it is the key's
final occurrence `is_last`.  With per-segment uniform parameters the
sequential fold per key has a closed form, so every lane is decided
independently:

- **Main case** (`inc > 0 and tol > 0`): the allowed set is a prefix of
  the segment of length `m_raw = floor((now + tol - t0) / inc)`; rank r
  is allowed iff `r < m_raw` and the write-back at the `is_last` lane
  uses segment size `rank + 1`.
- **Degenerate case** (`inc == 0 or tol == 0`: quantity-0 probes,
  burst 1, zero emission): each request is a transition on the view v
  (the TAT it observes).  The view orbit has pre-period <= 1 and period
  <= 2, so three views v0, v1 = f(v0), v2 = f(v1) describe the segment
  and every lane picks among them by rank parity.

The functions below are the plain version of the decision window: plain
torch ops, one sub-batch at a time.  On CUDA tensors the serving path
runs the hand-written kernel in `fused.py` instead; `decide_window` is
what the CPU path runs and what that kernel is held against.

The by-id launch path decides on the expanded arrays, as the JAX
package's `gcra_scan_byid` says it may: a front end (`byid_window` /
`ids_window` / `ids20_window`, torch ops batched over the whole window)
turns the window's ids into the packed request rows, which then go
through the decision window like any other (`BucketTable.check_many_*`
hand them to `fused.py`).  The composed scans `gcra_scan_byid` /
`gcra_scan_ids` / `gcra_scan_ids20` and their `_acc` twins stay the
counterparts of the JAX functions: one sub-batch at a time, their state
rows moved by the `row_ops` kernels on a CUDA table (the port of
`pallas_ops.py`).  `_gcra_body` takes its row movement explicitly: the
composed scans pass `row_ops`, `decide_window` the plain `row_ops.PLAIN`.
"""

from __future__ import annotations

import numpy as np
import torch

from . import row_ops
from .sat import (
    I64_MAX,
    div_trunc,
    sat_add,
    sat_add_nn,
    sat_mul_nonneg,
    sat_sub,
    sat_sub_nn,
)

EMPTY_EXPIRY = -(1 << 63)  # expiry sentinel: always in the past

_U32 = (1 << 32) - 1

# Packed request row: one i32[PACK_WIDTH] word group per request, so a
# whole window travels host->device as ONE buffer.
#   w0 slot | w1 rank | w2 flags(bit0 is_last, bit1 valid)
#   w3/w4 emission lo/hi | w5/w6 tolerance lo/hi | w7/w8 quantity lo/hi
PACK_WIDTH = 9
PACK_FLAG_IS_LAST = 1
PACK_FLAG_VALID = 2

# Insight-widened row: [tat_lo, tat_hi, exp_lo, exp_hi, deny_lo, deny_hi]
# — the per-slot denied-hit counter rides the same row gather/scatter.
INS_WIDTH = 6

_I32_MAX = (1 << 31) - 1
_NS_PER_SEC = 1_000_000_000


def _to_i32(x):
    """Low 32 bits of an int64 tensor as int32 (two's-complement wrap,
    written out so no narrowing cast of an out-of-range value occurs)."""
    return (((x & _U32) ^ (1 << 31)) - (1 << 31)).to(torch.int32)


def _join(lo, hi):
    """int32 lo/hi halves -> int64."""
    return (hi.to(torch.int64) << 32) | (lo.to(torch.int64) & _U32)


def _split_cols(x):
    """i64[...] -> i32[..., 2] lo/hi column pair."""
    return torch.stack([_to_i32(x), (x >> 32).to(torch.int32)], dim=-1)


def pack_state(tat, expiry):
    """(i64[N], i64[N]) -> i32[N, 4] rows [tat_lo, tat_hi, exp_lo, exp_hi]."""
    return torch.cat([_split_cols(tat), _split_cols(expiry)], dim=-1)


def unpack_state(state):
    """i32[..., W] rows -> (tat i64[...], expiry i64[...]); extra columns
    (the insight-widened layout) are ignored."""
    return (
        _join(state[..., 0], state[..., 1]),
        _join(state[..., 2], state[..., 3]),
    )


def unpack_deny(state):
    """Denied-hit counter column of insight-widened rows (i64[...])."""
    return _join(state[..., 4], state[..., 5])


def pack_requests(slots, rank, is_last, emission, tolerance, quantity, valid):
    """Host-side packing: [...]-shaped request arrays -> i32[..., PACK_WIDTH]
    (numpy)."""
    out = np.empty(np.shape(slots) + (PACK_WIDTH,), np.int32)
    out[..., 0] = slots
    out[..., 1] = rank
    out[..., 2] = np.asarray(is_last, np.int32) * PACK_FLAG_IS_LAST + (
        np.asarray(valid, np.int32) * PACK_FLAG_VALID
    )
    for base, arr in ((3, emission), (5, tolerance), (7, quantity)):
        a = np.asarray(arr, np.int64)
        out[..., base] = (a & _U32).astype(np.uint32).view(np.int32)
        out[..., base + 1] = (a >> 32).astype(np.int32)
    return out


# ---- host certificates for the compact output tiers (numpy) ------------ #


def fits_cur_wire(tolerance, now_ns) -> bool:
    """Certificate for the compact="cur" output mode (8 B/request).

    The mode transmits one i64 per request, `cur * 2 + allowed`; the shift
    never overflows while `now < 2**61 and tol < 2**61` (then cur < 2**62).
    """
    return bool(now_ns < (1 << 61)) and bool(
        np.max(tolerance, initial=0) < (1 << 61)
    )


# compact="w32" field widths: allowed(1) + remaining(10) + reset_s(11)
# + retry_s(10) = 32.
W32_REM_MAX = (1 << 10) - 1
W32_RESET_MAX = (1 << 11) - 1
W32_RETRY_MAX = (1 << 10) - 1


def fits_w32_wire(
    valid, emission, tolerance, quantity, now_ns, tol_hwm, now_hwm=0
) -> bool:
    """Certificate for the compact="w32" output mode (4 B/request).

    Every valid lane's wire values must fit the packed field widths.  From
    cur in [now - max(em, tol), now + max(tol, hwm)], with `tol_hwm` the
    table's high-water mark of valid tolerances ever launched:

      remaining <= (tol + max(em, tol)) // em   <= W32_REM_MAX
      reset_s   <= (tol + hwm) // 1e9           <= W32_RESET_MAX
      retry_s   <= (inc + max(hwm - tol, 0)) // 1e9 <= W32_RETRY_MAX

    The stored-TAT bound also needs `now_ns >= now_hwm` (no clock
    regression against any prior launch).  Callers must ALSO hold the
    with_degen=False certificate (has_degenerate) and now_ns >= 0.
    """
    v = np.asarray(valid, bool)
    if not bool(np.any(v)):
        return True
    if not 0 <= now_ns < (1 << 61):
        return False
    if now_ns < int(now_hwm):
        return False
    hwm = int(tol_hwm)
    if hwm >= (1 << 61):
        return False
    em = np.where(v, np.asarray(emission, np.int64), 1)
    tol = np.where(v, np.asarray(tolerance, np.int64), 0)
    q = np.where(v, np.asarray(quantity, np.int64), 0)
    if int(tol.max(initial=0)) >= (1 << 61):
        # A legal big-tolerance lane would wrap the int64 bound sums
        # below and falsely certify w32: refuse before any arithmetic.
        return False
    hwm = max(hwm, int(tol.max(initial=0)))
    em_safe = np.maximum(em, 1)
    inc = em * q
    rem_bound = (tol + np.maximum(em, tol)) // em_safe
    reset_bound = (tol + hwm) // _NS_PER_SEC
    retry_bound = (inc + np.maximum(hwm - tol, 0)) // _NS_PER_SEC
    return bool(
        (np.where(v, rem_bound, 0) <= W32_REM_MAX).all()
        and (np.where(v, reset_bound, 0) <= W32_RESET_MAX).all()
        and (np.where(v, retry_bound, 0) <= W32_RETRY_MAX).all()
    )


def fits_w32_wire_agg(
    max_tol, min_tol, max_inc, rem_bound, now_ns, tol_hwm, now_hwm=0
) -> bool:
    """fits_w32_wire from precomputed valid-lane aggregates (O(1))."""
    if not 0 <= now_ns < (1 << 61) or now_ns < int(now_hwm):
        return False
    hwm = int(tol_hwm)
    if hwm >= (1 << 61):
        return False
    hwm = max(hwm, int(max_tol))
    if int(rem_bound) > W32_REM_MAX:
        return False
    if (int(max_tol) + hwm) // _NS_PER_SEC > W32_RESET_MAX:
        return False
    retry_bound = int(max_inc) + max(hwm - int(min_tol), 0)
    return retry_bound // _NS_PER_SEC <= W32_RETRY_MAX


def finish_w32(words):
    """Host-side unpack of the compact="w32" output: i32 words ->
    (allowed, remaining, reset_after_secs, retry_after_secs), all i32."""
    u = np.ascontiguousarray(words, np.int32).view(np.uint32)
    return (
        (u & 1).astype(np.int32),
        ((u >> 1) & np.uint32(W32_REM_MAX)).astype(np.int32),
        ((u >> 11) & np.uint32(W32_RESET_MAX)).astype(np.int32),
        ((u >> 22) & np.uint32(W32_RETRY_MAX)).astype(np.int32),
    )


def cur_wire_safe(valid, tolerance, now_ns) -> bool:
    """Valid-lane-masked fits_cur_wire: a rejected request's garbage
    tolerance neither forfeits the launch's cur output nor poisons the
    table's cross-launch `cur_safe` flag."""
    return bool(now_ns < (1 << 61)) and not bool(
        np.any(np.asarray(valid) & (np.asarray(tolerance) >= (1 << 61)))
    )


def finish_cur(cur2, emission, tolerance, quantity, now_ns):
    """Host-side completion of the compact="cur" output (numpy): the exact
    4-plane wire values (allowed, remaining, reset_after_secs,
    retry_after_secs), all i32, from one `cur*2 + allowed` i64 per
    request.  Exact on every VALID lane under the fits_cur_wire +
    with_degen=False certificate."""
    cur2 = np.asarray(cur2, np.int64)
    allowed = (cur2 & 1) != 0
    cur = cur2 >> 1  # arithmetic shift: exact for negative cur too
    em = np.asarray(emission, np.int64)
    tol = np.asarray(tolerance, np.int64)
    inc = em * np.asarray(quantity, np.int64)
    room = now_ns + tol - cur
    remaining = np.maximum(
        np.where(em > 0, room // np.where(em > 0, em, 1), 0), 0
    )
    reset = np.maximum(cur - now_ns + tol, 0)
    retry = np.where(allowed, 0, np.maximum(cur + inc - tol - now_ns, 0))
    i32max = _I32_MAX
    return (
        allowed.astype(np.int32),
        np.minimum(remaining, i32max).astype(np.int32),
        np.minimum(reset // 1_000_000_000, i32max).astype(np.int32),
        np.minimum(retry // 1_000_000_000, i32max).astype(np.int32),
    )


# ---- the plain decide (torch) ------------------------------------------ #


def _unpack_requests(packed, now):
    """i32[B, PACK_WIDTH] -> the _gcra_body batch tuple."""
    flags = packed[..., 2]
    return (
        packed[..., 0],
        packed[..., 1].to(torch.int64),
        (flags & PACK_FLAG_IS_LAST) != 0,
        _join(packed[..., 3], packed[..., 4]),
        _join(packed[..., 5], packed[..., 6]),
        _join(packed[..., 7], packed[..., 8]),
        (flags & PACK_FLAG_VALID) != 0,
        now,
    )


def _request_outputs(t, inc, emission, tol, now):
    """Outcome of one GCRA check from state `t` (all i64, vectorized):
    (allowed, remaining, reset_after, retry_after, new_tat, ttl)."""
    new_tat = sat_add(t, inc)
    allow_at = sat_sub(new_tat, tol)
    allowed = now >= allow_at
    cur = torch.where(allowed, new_tat, t)
    # WRAPPING add: the reference's burst_limit wraps on i64 overflow.
    burst_limit = now + tol
    room = sat_sub(burst_limit, cur)
    remaining = torch.where(
        emission > 0, torch.clamp(div_trunc(room, emission), min=0), 0
    )
    reset_after = torch.clamp(sat_add(sat_sub(cur, now), tol), min=0)
    retry_after = torch.where(
        allowed, 0, torch.clamp(sat_sub(allow_at, now), min=0)
    )
    ttl = sat_add(sat_sub(new_tat, now), tol)
    return allowed, remaining, reset_after, retry_after, new_tat, ttl


def _gcra_body(state, batch, *, rowops, with_degen=True, compact=False):
    """Decide one sub-batch; updates `state` (i32[N, W]) in place and
    returns (out, n_exp).  `rowops` moves the state rows: `row_ops` (the
    CUDA kernels on a CUDA table) or `row_ops.PLAIN` (indexing).

    with_degen=False drops the degenerate-case machinery — legal only
    when the host certifies no quantity-0, burst-1, zero-emission or
    wrapped-negative-tolerance request, a bounded increment, and now >= 0
    (limiter.has_degenerate) — and uses the 2-op nonneg saturating forms
    and plain multiplies the certificate licenses.

    compact: False -> i64[4, B] ns planes; True -> i32[4, B] wire planes
    (whole seconds, saturated at i32::MAX); "cur" -> i64[B] words
    `cur*2 + allowed`; "w32" -> i32[B] bit-packed wire words.  The last
    two need with_degen=False.
    """
    (slots, rank, is_last, emission, tolerance, quantity, valid, now) = batch
    N = state.shape[0]
    ins = state.shape[-1] > 4

    s = torch.clamp(slots, 0, N - 1)  # i32, as the kernels take it
    rows_g = rowops.row_gather(state, s)
    stored_tat, stored_exp = unpack_state(rows_g)
    stored_deny = unpack_deny(rows_g) if ins else None
    v = valid
    live = v & (stored_exp > now)
    em = emission
    tol = tolerance

    if with_degen:
        s_add, s_sub, s_mul = sat_add, sat_sub, sat_mul_nonneg
    else:
        s_add, s_sub = sat_add_nn, sat_sub_nn

        def s_mul(a, b):
            return a * b

    inc = s_mul(em, quantity)
    t0 = torch.where(
        live, torch.maximum(stored_tat, s_sub(now, tol)), s_sub(now, em)
    )

    # ---- main case: prefix closed form ---------------------------------
    num = sat_sub(s_add(now, tol), t0)
    m_raw = torch.clamp(div_trunc(num, inc), min=0)
    allowed_main = rank < m_raw
    new_tat_r = s_add(t0, s_mul(rank + 1, inc))
    tat_denied = s_add(t0, s_mul(m_raw, inc))
    cur_main = torch.where(allowed_main, new_tat_r, tat_denied)
    tat_fin_main = s_add(t0, s_mul(torch.minimum(m_raw, rank + 1), inc))
    burst_limit = now + tol  # wrapping, as the reference
    room_main = sat_sub(burst_limit, cur_main)
    remaining_main = torch.where(
        em > 0, torch.clamp(div_trunc(room_main, em), min=0), 0
    )
    reset_main = torch.clamp(s_add(s_sub(cur_main, now), tol), min=0)
    retry_main = torch.where(
        allowed_main,
        0,
        torch.clamp(s_sub(s_sub(s_add(cur_main, inc), tol), now), min=0),
    )
    # Expired hits: rank-0 valid lane, real stored expiry <= now, allowed.
    exp_hit_base = (
        v & (rank == 0) & (stored_exp != EMPTY_EXPIRY) & (stored_exp <= now)
    )
    seg_n = rank + 1

    if not with_degen:
        allowed_out = allowed_main & v
        remaining_out, reset_out, retry_out = (
            remaining_main, reset_main, retry_main,
        )
        wrote = (m_raw >= 1) & v & is_last
        tat_fin = tat_fin_main
        cur_out = cur_main
        denied_seg = seg_n - torch.minimum(m_raw, seg_n)
        n_exp_mask = exp_hit_base & allowed_main
        f_add, f_sub = s_add, s_sub
    else:
        # ---- degenerate case: three-view closed form -------------------
        degen = (inc == 0) | (tol == 0)

        def view_step(t):
            outs = _request_outputs(t, inc, em, tol, now)
            allowed_t, _, _, _, new_t, ttl_t = outs
            dead = allowed_t & (ttl_t == 0)
            t_next = torch.where(
                ~allowed_t,
                t,
                torch.where(
                    dead,
                    sat_sub(now, em),
                    torch.maximum(new_t, sat_sub(now, tol)),
                ),
            )
            return outs, t_next

        outs0, v1 = view_step(t0)
        outs1, v2 = view_step(v1)
        outs2, _ = view_step(v2)
        a0, a1, a2 = outs0[0], outs1[0], outs2[0]
        alt_even = torch.remainder(rank - 1, 2) == 0

        def pick(main, o0, o1, o2):
            alternating = torch.where(alt_even, o1, o2)
            tail = torch.where(rank == 1, o1, torch.where(a2, alternating, o2))
            degen_out = torch.where(
                ~a0,
                o0,
                torch.where(
                    ~a1,
                    torch.where(rank == 0, o0, o1),
                    torch.where(rank == 0, o0, tail),
                ),
            )
            return torch.where(degen, degen_out, main)

        allowed_out = pick(allowed_main, a0, a0 & a1, a0 & a1 & a2) & v
        remaining_out = pick(remaining_main, outs0[1], outs1[1], outs2[1])
        reset_out = pick(reset_main, outs0[2], outs1[2], outs2[2])
        retry_out = pick(retry_main, outs0[3], outs1[3], outs2[3])

        new0_t, new1_t, new2_t = outs0[4], outs1[4], outs2[4]
        alt_last = torch.where(alt_even, new1_t, new2_t)
        tat_fin_degen = torch.where(
            (rank == 0) | ~a1,
            new0_t,
            torch.where(~a2 | (rank == 1), new1_t, alt_last),
        )
        wrote = torch.where(degen, a0, m_raw >= 1) & v & is_last
        tat_fin = torch.where(degen, tat_fin_degen, tat_fin_main)
        cur_out = None
        allowed_cnt_degen = torch.where(
            ~a0,
            0,
            torch.where(
                ~a1, 1, torch.where(~a2, torch.clamp(seg_n, max=2), seg_n)
            ),
        )
        denied_seg = seg_n - torch.where(
            degen, allowed_cnt_degen, torch.minimum(m_raw, seg_n)
        )
        n_exp_mask = exp_hit_base & allowed_out
        f_add, f_sub = sat_add, sat_sub

    out = _finish(
        state, rowops, s, N, now, tol, allowed_out, remaining_out,
        reset_out, retry_out, wrote, tat_fin, compact, f_add, f_sub,
        cur=cur_out,
        ins_row=(stored_tat, stored_exp, stored_deny, denied_seg,
                 v & is_last) if ins else None,
    )
    return out, n_exp_mask.to(torch.int64).sum()


def _finish(
    state, rowops, s, N, now, tol, allowed, remaining, reset_after,
    retry_after, wrote, tat_fin, compact, s_add, s_sub, cur=None,
    ins_row=None,
):
    """Write back the surviving state (one row scatter, in place) and
    stack the outputs of the `compact` tier."""
    ttl_fin = s_add(s_sub(tat_fin, now), tol)
    # ttl < 0 wraps to a ~584-year duration in the reference: "never".
    expiry_fin = torch.where(ttl_fin < 0, I64_MAX, s_add(tat_fin, tol))
    # Suppressed writes land in the scratch tail (the last B rows) at
    # distinct indices, keeping every scatter index unique.
    B = s.shape[0]
    scratch = N - B + torch.arange(B, dtype=torch.int32, device=s.device)
    if ins_row is None:
        scatter_idx = torch.where(wrote, s, scratch)
        rows = pack_state(tat_fin, expiry_fin)
    else:
        stored_tat, stored_exp, stored_deny, denied_seg, touch = ins_row
        rows = torch.cat(
            [
                pack_state(
                    torch.where(wrote, tat_fin, stored_tat),
                    torch.where(wrote, expiry_fin, stored_exp),
                ),
                _split_cols(stored_deny + denied_seg),
            ],
            dim=-1,
        )
        scatter_idx = torch.where(touch, s, scratch)
    rowops.row_scatter(state, scatter_idx, rows)

    if compact == "cur":
        if cur is None:
            raise ValueError('compact="cur" requires with_degen=False')
        return cur * 2 + allowed.to(torch.int64)
    if compact == "w32":
        if cur is None:
            raise ValueError('compact="w32" requires with_degen=False')
        word = (
            allowed.to(torch.int64)
            | ((remaining & _U32) << 1)
            | ((torch.div(reset_after, _NS_PER_SEC, rounding_mode="floor")
                & _U32) << 11)
            | ((torch.div(retry_after, _NS_PER_SEC, rounding_mode="floor")
                & _U32) << 22)
        )
        return _to_i32(word)
    if compact:
        return torch.stack(
            [
                allowed.to(torch.int32),
                torch.clamp(remaining, max=_I32_MAX).to(torch.int32),
                torch.clamp(
                    torch.div(reset_after, _NS_PER_SEC, rounding_mode="floor"),
                    max=_I32_MAX,
                ).to(torch.int32),
                torch.clamp(
                    torch.div(retry_after, _NS_PER_SEC, rounding_mode="floor"),
                    max=_I32_MAX,
                ).to(torch.int32),
            ]
        )
    return torch.stack(
        [allowed.to(torch.int64), remaining, reset_after, retry_after]
    )


def decide_window(state, packed, now, *, with_degen=True, compact=False):
    """The plain decision window: K sub-batches in order, `state` updated
    in place.  `packed` is i32[K, B, PACK_WIDTH], `now` i64[K], both on
    the state's device.  Returns (out, n_exp i64[K]) with `out` stacked
    over K per the `compact` tier."""
    outs, n_exp = [], []
    for k in range(packed.shape[0]):
        out, n = _gcra_body(
            state, _unpack_requests(packed[k], now[k]),
            rowops=row_ops.PLAIN, with_degen=with_degen, compact=compact,
        )
        outs.append(out)
        n_exp.append(n)
    return torch.stack(outs), torch.stack(n_exp)


def gcra_batch(
    state, slots, rank, is_last, emission, tolerance, quantity, valid, now,
    *, with_degen=True, compact=False,
):
    """Decide B requests against the bucket table (the JAX package's
    single-batch `gcra_batch`, on the plain version): `state` i32[N, W]
    is updated in place (its last B rows are scratch); `slots` i32[B],
    `rank` [B], `is_last` / `valid` bool[B], `emission`, `tolerance`,
    `quantity` i64[B] and `now` an i64 scalar, all on the state's device.
    Duplicate slots must share (emission, tolerance, quantity).  Returns
    (state, out) with out[4, B] = (allowed, remaining, reset_after,
    retry_after) per the `compact` tier."""
    now = torch.as_tensor(now, dtype=torch.int64, device=state.device)
    out, _ = _gcra_body(
        state,
        (slots, rank.to(torch.int64), is_last, emission, tolerance,
         quantity, valid, now),
        rowops=row_ops.PLAIN, with_degen=with_degen, compact=compact,
    )
    return state, out


def _lanes_allowed(out, compact):
    """The valid-masked allowed bit of any output tier, [..., B]."""
    if compact in ("cur", "w32"):
        return (out & 1) != 0
    return out[..., 0, :] != 0


def _insight_totals(ins_counts, valid, out, compact):
    """Advance the [allowed, denied] totals from one window's outputs
    (allowed planes are already masked with `valid`)."""
    allowed = _lanes_allowed(out, compact)
    denied = valid & ~allowed
    return ins_counts + torch.stack(
        [allowed.to(torch.int64).sum(), denied.to(torch.int64).sum()]
    )


def gcra_scan_packed_acc(
    state, exp_acc, packed, now, *, with_degen=True, compact=False
):
    """Plain decision window + expired-hit accumulation; returns
    (state, exp_acc, out) with `state` updated in place."""
    out, n_exp = decide_window(
        state, packed, now, with_degen=with_degen, compact=compact
    )
    return state, exp_acc + n_exp.sum(), out


def gcra_scan_packed_ins(
    state, exp_acc, ins_counts, packed, now, *, with_degen=True,
    compact=False,
):
    """gcra_scan_packed_acc + insight accumulation (INS_WIDTH rows)."""
    out, n_exp = decide_window(
        state, packed, now, with_degen=with_degen, compact=compact
    )
    ins_counts = _insight_totals(
        ins_counts, (packed[..., 2] & PACK_FLAG_VALID) != 0, out, compact
    )
    return state, exp_acc + n_exp.sum(), ins_counts, out


def insight_topk(state, *, capacity, k):
    """Top-K of the denied-hit counter column of an insight-widened table:
    (counts i64[k], slot ids i32[k]), highest first; rows past `capacity`
    (the scratch tail) are excluded.  Equal counts keep the lower slot
    first, as `jax.lax.top_k` orders them (`torch.topk` does not): a
    stable descending sort of the column, then its first k."""
    vals, idx = torch.sort(
        unpack_deny(state[:capacity]), descending=True, stable=True
    )
    return vals[:k], idx[:k].to(torch.int32)


def insight_decay(state):
    """Halve the denied-hit counter columns in place (floor division, as
    the host twin's `// 2`); tat/expiry columns are untouched.  Queued on
    the current stream, so it follows any window still in flight there."""
    halved = torch.div(unpack_deny(state), 2, rounding_mode="floor")
    state[:, 4:] = _split_cols(halved)
    return state


# ---- the by-id launch path ------------------------------------------------ #
# By-id request words (native/keymap.cpp tk_assemble_ids):
#   low 32 bits: key id | high 32: rank(14) | is_last<<14 | valid<<15
# The device gathers (slot, emission, tolerance) from resident id rows,
# an i32[n_ids, IDROW_WIDTH] table built by BucketTable.upload_id_rows,
# so a request costs 8 bytes host->device instead of the 36-byte packed
# row.  The quantity is uniform per launch.
IDROW_WIDTH = 8


def pack_id_rows(slots, emission, tolerance):
    """Host-side build of the resident by-id parameter rows (numpy):
    i32[n, IDROW_WIDTH] = [slot, em_lo, em_hi, tol_lo, tol_hi, pad...]
    (the scans read columns 0-4)."""
    rows = np.zeros((len(slots), IDROW_WIDTH), np.int32)
    rows[:, 0] = slots
    for base, arr in ((1, emission), (3, tolerance)):
        a = np.asarray(arr, np.int64)
        rows[:, base] = (a & _U32).astype(np.uint32).view(np.int32)
        rows[:, base + 1] = (a >> 32).astype(np.int32)
    return rows


def _rows_to_batch(rows, rank, is_last, valid, quantity, now_k):
    """One sub-batch's request fields (`_byid_fields` / `_ids_fields`)
    -> the _gcra_body batch tuple."""
    return (
        rows[:, 0],                                        # slots
        rank,
        is_last,
        _join(rows[:, 1], rows[:, 2]),                     # emission
        _join(rows[:, 3], rows[:, 4]),                     # tolerance
        torch.full(rank.shape, quantity, dtype=torch.int64,
                   device=rank.device),                    # quantity
        valid,
        now_k,
    )


def _id_rows_at(id_rows, idx):
    """id_rows[idx] for an index tensor of any shape: i32[..., IDROW_WIDTH]."""
    rows = id_rows.index_select(0, idx.reshape(-1))
    return rows.reshape(idx.shape + (id_rows.shape[1],))


def _byid_fields(w, id_rows):
    """8-byte request words (i64[..., B]) -> (id rows i32[..., B,
    IDROW_WIDTH], rank i64, is_last, valid), lane for lane.  The id is
    clamped into the resident rows and keeps its valid bit."""
    n_ids = id_rows.shape[0]
    rows = _id_rows_at(id_rows, torch.clamp(_to_i32(w & _U32), 0, n_ids - 1))
    meta = w >> 32
    # An unresolved id row (resolve_all on a full table) carries slot -1,
    # which would otherwise clip to slot 0 and decide against another
    # key's bucket.
    valid = ((meta & (1 << 15)) != 0) & (rows[..., 0] >= 0)
    return rows, meta & 0x3FFF, (meta & (1 << 14)) != 0, valid


def _byid_batch(w, now_k, id_rows, quantity):
    """One sub-batch of 8-byte request words (i64[B]) -> the _gcra_body
    tuple."""
    return _rows_to_batch(*_byid_fields(w, id_rows), quantity, now_k)


def _device_segments(segkey):
    """(rank i64[..., B], is_last bool[..., B]) per lane from a per-lane
    segment key, each row of the last dimension on its own, on the
    device: a stable argsort groups equal keys in arrival order, a
    running max finds each run's start, and the inverse permutation (a
    second stable argsort) maps the ranks back to arrival positions."""
    dev = segkey.device
    order = torch.argsort(segkey, dim=-1, stable=True)
    sk = torch.gather(segkey, -1, order)
    pos = torch.arange(segkey.shape[-1], dtype=torch.int64, device=dev)
    change = sk[..., 1:] != sk[..., :-1]
    edge = torch.ones(sk.shape[:-1] + (1,), dtype=torch.bool, device=dev)
    run_start = torch.cat([edge, change], dim=-1)
    start_pos = torch.cummax(torch.where(run_start, pos, 0), dim=-1).values
    rank_sorted = pos - start_pos
    last_sorted = torch.cat([change, edge], dim=-1)
    inv = torch.argsort(order, dim=-1, stable=True)
    return (torch.gather(rank_sorted, -1, inv),
            torch.gather(last_sorted, -1, inv))


def _ids_fields(w, id_rows):
    """Raw key ids (i32[..., B], negative = padding) -> (id rows, rank
    i64, is_last, valid) as `_byid_fields`, with the duplicate-segment
    structure of each sub-batch derived on the device.  Segments are
    keyed by slot, so two ids sharing a slot still serialise; every
    invalid lane gets its own key beyond any real slot, so it can
    neither join nor split a real segment."""
    n_ids = id_rows.shape[0]
    # An id beyond the resident rows (interned after upload, or corrupt)
    # is invalid, never clipped onto another key.
    valid = (w >= 0) & (w < n_ids)
    rows = _id_rows_at(id_rows, torch.clamp(w, 0, n_ids - 1))
    slots = rows[..., 0]
    valid = valid & (slots >= 0)
    pos = torch.arange(w.shape[-1], dtype=torch.int32, device=w.device)
    segkey = torch.where(valid, slots, _I32_MAX - pos)
    rank, is_last = _device_segments(segkey)
    return rows, rank, is_last, valid


def _ids_batch(w, now_k, id_rows, quantity):
    """One sub-batch of raw key ids (i32[B]) -> the _gcra_body tuple."""
    return _rows_to_batch(*_ids_fields(w, id_rows), quantity, now_k)


# The 20-bit id stream: 2.5 bytes per request in one u16 buffer per
# sub-batch (B low-16 lanes, then B/4 lanes of packed high nibbles),
# decoded on the device, for tables under 2^20 - 1 keys.
IDS20_SENTINEL = (1 << 20) - 1  # padding marker (never a real id)


def pack_ids20(ids):
    """i32[K, B] raw key ids (negative = padding) -> u16[K, B + B//4]
    (numpy).  Needs B % 4 == 0 and every real id < 2^20 - 1: the
    all-ones pattern is the padding sentinel, which decodes to an id out
    of range of any conforming table, so the scan masks it invalid."""
    ids = np.asarray(ids)
    K, B = ids.shape
    if B % 4:
        raise ValueError("ids20 batch width must be a multiple of 4")
    if (ids >= IDS20_SENTINEL).any():
        raise ValueError("ids must be < 2^20 - 1 for the 20-bit id stream")
    u = np.where(ids < 0, IDS20_SENTINEL, ids).astype(np.uint32)
    lo = (u & 0xFFFF).astype(np.uint16)
    hi4 = (u >> 16).astype(np.uint16).reshape(K, B // 4, 4)
    hibuf = (
        hi4[..., 0] | (hi4[..., 1] << 4) | (hi4[..., 2] << 8)
        | (hi4[..., 3] << 12)
    )
    return np.concatenate([lo, hibuf], axis=1)


def _ids20_decode(buf, B):
    """u16[..., B + B//4] streams -> i32[..., B] ids (device), each row of
    the last dimension one sub-batch."""
    b = buf.to(torch.int32)
    pos = torch.arange(B, dtype=torch.int32, device=buf.device)
    hi = (b.index_select(-1, B + (pos >> 2)) >> ((pos & 3) * 4)) & 0xF
    return (hi << 16) | b[..., :B]


def _ids20_width(packed):
    """B of a u16[K, B + B//4] stream; a misaligned buffer (e.g. a raw id
    stream handed to the wrong scan) would mis-split into in-range
    garbage ids, so it raises instead."""
    W = packed.shape[-1]
    if W % 5:
        raise ValueError(
            f"ids20 stream width must be a multiple of 5 (got {W})"
        )
    return W * 4 // 5


# ---- the by-id window front end ------------------------------------------ #
# A whole window's ids become the packed request rows in one pass of
# batched torch ops (no loop over sub-batches), independent of the
# table; the decision window then runs on them as on any packed window.


def _pack_window(rows, rank, is_last, valid, quantity):
    """Request fields over [K, B] lanes -> i32[K, B, PACK_WIDTH] in
    pack_requests' layout: the id row's slot, the rank (up to B - 1, so
    a whole i32 column), the flags, the id row's emission and tolerance
    words verbatim, and the launch-uniform quantity."""
    flags = (is_last.to(torch.int32) * PACK_FLAG_IS_LAST
             + valid.to(torch.int32) * PACK_FLAG_VALID)
    q = rows.new_empty(rank.shape + (2,))
    q[..., 0] = ((quantity & _U32) ^ (1 << 31)) - (1 << 31)
    q[..., 1] = quantity >> 32
    return torch.cat(
        [rows[..., :1], rank.to(torch.int32)[..., None], flags[..., None],
         rows[..., 1:5], q],
        dim=-1,
    )


def byid_window(id_rows, words, quantity):
    """8-byte request words (i64[K, B], tk_assemble_ids layout) against
    resident `id_rows` -> the packed window i32[K, B, PACK_WIDTH] on the
    words' device; `quantity` a launch-uniform int.  Lane for lane the
    rows gcra_scan_byid_acc decides."""
    return _pack_window(*_byid_fields(words, id_rows), quantity)


def ids_window(id_rows, ids, quantity):
    """Raw key ids (i32[K, B], negative = padding) -> the packed window,
    as byid_window; the rows gcra_scan_ids_acc decides."""
    return _pack_window(*_ids_fields(ids, id_rows), quantity)


def ids20_window(id_rows, packed, quantity):
    """The 20-bit id stream (u16[K, B + B//4], pack_ids20) -> the packed
    window, as ids_window; all K sub-batches decoded at once."""
    return ids_window(
        id_rows, _ids20_decode(packed, _ids20_width(packed)), quantity
    )


def _scan_rows(state, exp_acc, batches, *, with_degen, compact):
    """Decide sub-batches in order with the state rows moved by the
    row_ops kernels; returns (state, exp_acc, out stacked over K)."""
    outs, n_exp = [], []
    for batch in batches:
        out, n = _gcra_body(
            state, batch, rowops=row_ops, with_degen=with_degen,
            compact=compact,
        )
        outs.append(out)
        n_exp.append(n)
    return state, exp_acc + torch.stack(n_exp).sum(), torch.stack(outs)


def gcra_scan_byid_acc(
    state, exp_acc, id_rows, words, now, quantity, *, with_degen=True,
    compact=False,
):
    """K sub-batches of 8-byte request words (i64[K, B], tk_assemble_ids
    layout) against resident `id_rows`; `now` i64[K], `quantity` a
    launch-uniform int.  Returns (state, exp_acc, out) with `state`
    updated in place and `out` per the `compact` tier; lanes whose valid
    bit is 0 are padding."""
    return _scan_rows(
        state, exp_acc,
        (_byid_batch(words[k], now[k], id_rows, quantity)
         for k in range(words.shape[0])),
        with_degen=with_degen, compact=compact,
    )


def gcra_scan_ids_acc(
    state, exp_acc, id_rows, ids, now, quantity, *, with_degen=True,
    compact=False,
):
    """K sub-batches of raw key ids (i32[K, B], negative = padding), the
    duplicate-segment structure derived on the device; otherwise as
    gcra_scan_byid_acc."""
    return _scan_rows(
        state, exp_acc,
        (_ids_batch(ids[k], now[k], id_rows, quantity)
         for k in range(ids.shape[0])),
        with_degen=with_degen, compact=compact,
    )


def gcra_scan_ids20_acc(
    state, exp_acc, id_rows, packed, now, quantity, *, with_degen=True,
    compact=False,
):
    """gcra_scan_ids_acc fed by the 20-bit id stream (u16[K, B + B//4],
    pack_ids20)."""
    B = _ids20_width(packed)
    return _scan_rows(
        state, exp_acc,
        (_ids_batch(_ids20_decode(packed[k], B), now[k], id_rows, quantity)
         for k in range(packed.shape[0])),
        with_degen=with_degen, compact=compact,
    )


def _without_acc(scan_acc, state, id_rows, stream, now, quantity, **kw):
    acc = torch.zeros((), dtype=torch.int64, device=state.device)
    state, _, out = scan_acc(state, acc, id_rows, stream, now, quantity, **kw)
    return state, out


def gcra_scan_byid(
    state, id_rows, words, now, quantity, *, with_degen=True, compact=False,
):
    """gcra_scan_byid_acc without the expired-hit count: (state, out)."""
    return _without_acc(
        gcra_scan_byid_acc, state, id_rows, words, now, quantity,
        with_degen=with_degen, compact=compact,
    )


def gcra_scan_ids(
    state, id_rows, ids, now, quantity, *, with_degen=True, compact=False,
):
    """gcra_scan_ids_acc without the expired-hit count: (state, out)."""
    return _without_acc(
        gcra_scan_ids_acc, state, id_rows, ids, now, quantity,
        with_degen=with_degen, compact=compact,
    )


def gcra_scan_ids20(
    state, id_rows, packed, now, quantity, *, with_degen=True,
    compact=False,
):
    """gcra_scan_ids20_acc without the expired-hit count: (state, out)."""
    return _without_acc(
        gcra_scan_ids20_acc, state, id_rows, packed, now, quantity,
        with_degen=with_degen, compact=compact,
    )


def _empty_rows(state):
    """Vacated rows of the state's width: TAT 0, expiry EMPTY_EXPIRY,
    every extra column zero (a recycled slot inherits no deny count)."""
    n = state.shape[0]
    rows = pack_state(
        torch.zeros(n, dtype=torch.int64, device=state.device),
        torch.full((n,), EMPTY_EXPIRY, dtype=torch.int64, device=state.device),
    )
    if state.shape[-1] > 4:
        pad = torch.zeros(
            (n, state.shape[-1] - 4), dtype=torch.int32, device=state.device
        )
        rows = torch.cat([rows, pad], dim=-1)
    return rows


def sweep_expired(now, state, capacity):
    """Cleanup-as-compaction: vacate every expired slot in place; returns
    the expired mask of the first `capacity` rows (the rest is scratch).
    Serves both row widths (the JAX package's sweep_expired and
    sweep_expired_ins): a vacated insight row's deny count dies with it."""
    _, expiry = unpack_state(state)
    expired = expiry <= now
    state.copy_(torch.where(expired[:, None], _empty_rows(state), state))
    return expired[:capacity]
