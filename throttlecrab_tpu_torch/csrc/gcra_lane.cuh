// Per-lane body and launch geometry of the GCRA decision window, shared
// by the CUDA kernel (fused_window.cu, compiled by nvcc for sm_90a) and
// the host shim (lane_host.cpp, compiled by g++ so the arithmetic and
// the schedule are checked on a machine without a card).
//
// One lane = one request of one sub-batch.  Lanes are independent: the
// duplicate-key closed forms (main prefix + degenerate three-view orbit,
// see throttlecrab_tpu_torch/tpu/kernel.py) need no communication
// between positions, so a thread decides its lanes on its own.
//
// Integer semantics are those of throttlecrab_tpu/tpu/sat.py, bit for
// bit, on native 64-bit integers.  Signed overflow is undefined in C++,
// so every deliberately wrapping step (the wrap inside sat_add/sat_sub
// before the clamp, burst_limit = now + tol, the plain products of the
// certified path, the cur*2+allowed word, the deny-counter add) runs on
// uint64_t and is cast back.  Division clamps the divisor to >= 1 and
// truncates toward zero, which is C's `/`.
#pragma once

#include <stdint.h>

#ifdef __CUDACC__
#define TC_HD __host__ __device__ __forceinline__
#define TC_UNROLL _Pragma("unroll")
#else
#define TC_HD inline
#define TC_UNROLL
#endif

namespace tc {

constexpr int PACK_WIDTH = 9;
constexpr int32_t FLAG_IS_LAST = 1;
constexpr int32_t FLAG_VALID = 2;
constexpr int64_t I64_MAX = INT64_MAX;
constexpr int64_t I64_MIN = INT64_MIN;
constexpr int64_t EMPTY_EXPIRY = INT64_MIN;
constexpr int64_t NS_PER_SEC = 1000000000LL;
constexpr int64_t I32_MAX = 2147483647LL;

// Output tiers (the `compact` argument of the Python wrappers).
constexpr int TIER_NS = 0;     // False:  i64[K, 4, B] ns planes
constexpr int TIER_WIRE = 1;   // True:   i32[K, 4, B] whole-second planes
constexpr int TIER_CUR = 2;    // "cur":  i64[K, B] cur*2 + allowed
constexpr int TIER_W32 = 3;    // "w32":  i32[K, B] bit-packed wire word

// ---- launch geometry ----
// One window is one launch.  A batch wider than one block is one thread
// block cluster (the grid is the cluster); a batch of at most
// BLOCK_THREADS lanes is one block, one lane a thread (the one-block
// schedule, fused_window.cu).  Thread t of block b owns lanes
// lane_of(g, b, t, j), j < g.lanes; in the cluster schedule the row each
// lane hands from its gather to its scatter waits in the block's shared
// memory, column-major [W][lanes * threads].
constexpr int CLUSTER_BLOCKS = 16;    // Hopper's largest (non-portable)
constexpr int BLOCK_THREADS = 256;    // 256 x <= 255 registers fit one SM
constexpr int MAX_BATCH = 1 << 16;    // the table's scratch tail
constexpr int SMEM_LIMIT = 232448;    // shared memory a block may use

struct Geometry {
  int blocks;      // blocks of the cluster (= the grid)
  int threads;     // threads per block
  int lanes;       // lanes per thread
  int smem_bytes;  // dynamic shared memory per block
};

// The geometry of a window of B lanes and W-wide rows: the fewest
// blocks (a power of two up to CLUSTER_BLOCKS) whose threads cover B,
// then as many lanes per thread as that leaves.
TC_HD Geometry window_geometry(int B, int W) {
  Geometry g;
  g.threads = BLOCK_THREADS;
  const int need = (B + BLOCK_THREADS - 1) / BLOCK_THREADS;
  g.blocks = 1;
  while (g.blocks < need && g.blocks < CLUSTER_BLOCKS) g.blocks *= 2;
  const int per_lane_round = g.blocks * BLOCK_THREADS;
  g.lanes = (B + per_lane_round - 1) / per_lane_round;
  g.smem_bytes = g.lanes * BLOCK_THREADS * W * 4;
  return g;
}
// Whether a window of B lanes takes the one-block schedule: the one
// rule the kernel's launch, the host shim and the wrapper's count read.
TC_HD bool one_block(int B) { return window_geometry(B, 4).blocks == 1; }
// The lane thread t of block b decides and scatters in round j (>= B:
// none).  Consecutive threads take consecutive lanes.
TC_HD int lane_of(const Geometry& g, int b, int t, int j) {
  return (j * g.blocks + b) * g.threads + t;
}
// Where that lane's row waits in its block's shared memory (column c of
// the row at row_slot + c * row_stride).
TC_HD int row_slot(const Geometry& g, int t, int j) {
  return j * g.threads + t;
}
TC_HD int row_stride(const Geometry& g) { return g.lanes * g.threads; }

TC_HD int64_t wadd(int64_t a, int64_t b) {
  return (int64_t)((uint64_t)a + (uint64_t)b);
}
TC_HD int64_t wsub(int64_t a, int64_t b) {
  return (int64_t)((uint64_t)a - (uint64_t)b);
}
TC_HD int64_t wmul(int64_t a, int64_t b) {
  return (int64_t)((uint64_t)a * (uint64_t)b);
}
TC_HD int64_t imax(int64_t a, int64_t b) { return a > b ? a : b; }
TC_HD int64_t imin(int64_t a, int64_t b) { return a < b ? a : b; }

TC_HD int64_t sat_add(int64_t a, int64_t b) {
  int64_t s = wadd(a, b);
  if (a > 0 && b > 0 && s < 0) return I64_MAX;
  if (a < 0 && b < 0 && s >= 0) return I64_MIN;
  return s;
}
TC_HD int64_t sat_sub(int64_t a, int64_t b) {
  int64_t d = wsub(a, b);
  if (a >= 0 && b < 0 && d < 0) return I64_MAX;
  if (a < 0 && b > 0 && d >= 0) return I64_MIN;
  return d;
}
// b >= 0 forms of the certified path: one compare instead of the
// general sign pattern.
TC_HD int64_t sat_add_nn(int64_t a, int64_t b) {
  int64_t s = wadd(a, b);
  return s < a ? I64_MAX : s;
}
TC_HD int64_t sat_sub_nn(int64_t a, int64_t b) {
  int64_t d = wsub(a, b);
  return d > a ? I64_MIN : d;
}
// Whether the exact product of a, b > 0 exceeds I64_MAX, from its high
// half: for b > 0 the same verdict as the reference's a > I64_MAX / b,
// without a 64-bit division.
TC_HD bool mul_exceeds_i64(int64_t a, int64_t b) {
#ifdef __CUDA_ARCH__
  const uint64_t hi = __umul64hi((uint64_t)a, (uint64_t)b);
#else
  const uint64_t hi =
      (uint64_t)(((unsigned __int128)(uint64_t)a * (uint64_t)b) >> 64);
#endif
  return hi != 0 || wmul(a, b) < 0;
}
TC_HD int64_t sat_mul_nonneg(int64_t a, int64_t b) {
  const bool overflow = a > 0 && b > 0 && mul_exceeds_i64(a, b);
  return overflow ? I64_MAX : wmul(a, b);
}
TC_HD int64_t div_trunc(int64_t a, int64_t b) { return a / (b > 1 ? b : 1); }

TC_HD int64_t join(int32_t lo, int32_t hi) {
  return (int64_t)(((uint64_t)(uint32_t)hi << 32) | (uint64_t)(uint32_t)lo);
}
TC_HD int32_t lo32(int64_t x) { return (int32_t)(uint32_t)(uint64_t)x; }
TC_HD int32_t hi32(int64_t x) { return (int32_t)(uint32_t)((uint64_t)x >> 32); }

// The saturating op set: general on the exact path, nonneg forms and
// wrapping products on the host-certified path (limiter.has_degenerate).
template <bool DEGEN>
struct Ops;
template <>
struct Ops<true> {
  TC_HD static int64_t add(int64_t a, int64_t b) { return sat_add(a, b); }
  TC_HD static int64_t sub(int64_t a, int64_t b) { return sat_sub(a, b); }
  TC_HD static int64_t mul(int64_t a, int64_t b) {
    return sat_mul_nonneg(a, b);
  }
};
template <>
struct Ops<false> {
  TC_HD static int64_t add(int64_t a, int64_t b) { return sat_add_nn(a, b); }
  TC_HD static int64_t sub(int64_t a, int64_t b) { return sat_sub_nn(a, b); }
  TC_HD static int64_t mul(int64_t a, int64_t b) { return wmul(a, b); }
};

// One packed request row (kernel.pack_requests), held in registers.
struct Req {
  int32_t p[PACK_WIDTH];
};
TC_HD Req load_req(const int32_t* packed, int i) {
  Req r;
  const int32_t* src = packed + (int64_t)i * PACK_WIDTH;
  TC_UNROLL
  for (int c = 0; c < PACK_WIDTH; ++c) r.p[c] = src[c];
  return r;
}

// A table row moves as one 16-byte vector (W = 4), or one 16-byte and
// one 8-byte vector (W = 6: a 24-byte row of a 16-byte aligned table
// starts on 16 bytes when its index is even, else on 8, so the 16-byte
// vector is its first or its last four words).  Cached in L2 only: the
// rows change under other blocks of the cluster between the barriers,
// so no SM keeps a copy in its L1.
template <int W>
TC_HD void load_row(const int32_t* src, int32_t* row) {
#ifdef __CUDA_ARCH__
  if (W == 4) {
    const int4 v = __ldcg(reinterpret_cast<const int4*>(src));
    row[0] = v.x, row[1] = v.y, row[2] = v.z, row[3] = v.w;
  } else {
    const bool even = (reinterpret_cast<uintptr_t>(src) & 15) == 0;
    const int4 q = __ldcg(reinterpret_cast<const int4*>(src + (even ? 0 : 2)));
    const int2 d = __ldcg(reinterpret_cast<const int2*>(src + (even ? 4 : 0)));
    row[0] = even ? q.x : d.x, row[1] = even ? q.y : d.y;
    row[2] = even ? q.z : q.x, row[3] = even ? q.w : q.y;
    row[4] = even ? d.x : q.z, row[5] = even ? d.y : q.w;
  }
#else
  for (int c = 0; c < W; ++c) row[c] = src[c];
#endif
}
template <int W>
TC_HD void store_row(int32_t* dst, const int32_t* row) {
#ifdef __CUDA_ARCH__
  if (W == 4) {
    __stcg(reinterpret_cast<int4*>(dst),
           make_int4(row[0], row[1], row[2], row[3]));
  } else {
    const bool even = (reinterpret_cast<uintptr_t>(dst) & 15) == 0;
    __stcg(reinterpret_cast<int4*>(dst + (even ? 0 : 2)),
           even ? make_int4(row[0], row[1], row[2], row[3])
                : make_int4(row[2], row[3], row[4], row[5]));
    __stcg(reinterpret_cast<int2*>(dst + (even ? 4 : 0)),
           even ? make_int2(row[4], row[5]) : make_int2(row[0], row[1]));
  }
#else
  for (int c = 0; c < W; ++c) dst[c] = row[c];
#endif
}

struct ReqOut {
  bool allowed;
  int64_t remaining, reset, retry, new_tat, ttl;
};

// One GCRA check from view t (kernel._request_outputs): always the
// general saturating ops.
TC_HD ReqOut request_outputs(int64_t t, int64_t inc, int64_t em, int64_t tol,
                             int64_t now) {
  ReqOut o;
  o.new_tat = sat_add(t, inc);
  int64_t allow_at = sat_sub(o.new_tat, tol);
  o.allowed = now >= allow_at;
  int64_t cur = o.allowed ? o.new_tat : t;
  int64_t room = sat_sub(wadd(now, tol), cur);
  o.remaining = em > 0 ? imax(div_trunc(room, em), 0) : 0;
  o.reset = imax(sat_add(sat_sub(cur, now), tol), 0);
  o.retry = o.allowed ? 0 : imax(sat_sub(allow_at, now), 0);
  o.ttl = sat_add(sat_sub(o.new_tat, now), tol);
  return o;
}

TC_HD int64_t view_next(int64_t t, const ReqOut& o, int64_t em, int64_t tol,
                        int64_t now) {
  if (!o.allowed) return t;
  if (o.ttl == 0) return sat_sub(now, em);  // dead write: fresh-miss view
  return imax(o.new_tat, sat_sub(now, tol));
}

// The table row lane r reads: its slot, clamped into the table.
TC_HD int64_t gather_index(const Req& r, int64_t N) {
  const int64_t slot = r.p[0];
  return slot < 0 ? 0 : (slot > N - 1 ? N - 1 : slot);
}

// Decide lane i of one sub-batch from the table row it read.
//   r:      the lane's packed request row
//   row:    the lane's table row (W words) as the sub-batch starts
//   ro:     where the row handed to the scatter goes, column c at
//           ro[c * ro_stride]
//   out:    this sub-batch's output slice, laid out per TIER
// Returns whether the lane is an expired hit (kernel._gcra_body n_exp).
template <int W, bool DEGEN, int TIER>
TC_HD bool decide_row(const Req& r, const int32_t* row, int i, int B,
                      int64_t now, int32_t* ro, int ro_stride, void* out) {
  typedef Ops<DEGEN> S;
  const int32_t* p = r.p;
  const int64_t rank = p[1];
  const bool is_last = (p[2] & FLAG_IS_LAST) != 0;
  const bool v = (p[2] & FLAG_VALID) != 0;
  const int64_t em = join(p[3], p[4]);
  const int64_t tol = join(p[5], p[6]);
  const int64_t q = join(p[7], p[8]);
  const int64_t stored_tat = join(row[0], row[1]);
  const int64_t stored_exp = join(row[2], row[3]);
  const bool live = v && stored_exp > now;

  const int64_t inc = S::mul(em, q);
  const int64_t t0 =
      live ? imax(stored_tat, S::sub(now, tol)) : S::sub(now, em);

  // ---- main case: prefix closed form ----
  const int64_t num = sat_sub(S::add(now, tol), t0);
  const int64_t m_raw = imax(div_trunc(num, inc), 0);
  const bool allowed_main = rank < m_raw;
  const int64_t seg_n = rank + 1;
  const int64_t new_tat_r = S::add(t0, S::mul(seg_n, inc));
  const int64_t tat_denied = S::add(t0, S::mul(m_raw, inc));
  const int64_t cur_main = allowed_main ? new_tat_r : tat_denied;
  const int64_t tat_fin_main = S::add(t0, S::mul(imin(m_raw, seg_n), inc));
  const int64_t burst_limit = wadd(now, tol);  // wrapping, as the reference
  const int64_t room_main = sat_sub(burst_limit, cur_main);
  const int64_t remaining_main =
      em > 0 ? imax(div_trunc(room_main, em), 0) : 0;
  const int64_t reset_main = imax(S::add(S::sub(cur_main, now), tol), 0);
  const int64_t retry_main =
      allowed_main ? 0
                   : imax(S::sub(S::sub(S::add(cur_main, inc), tol), now), 0);
  const bool exp_hit_base = v && rank == 0 && stored_exp != EMPTY_EXPIRY &&
                            stored_exp <= now;

  bool allowed, wrote, exp_hit;
  int64_t remaining, reset, retry, tat_fin, denied_seg, cur = 0;
  if (!DEGEN) {
    allowed = allowed_main && v;
    remaining = remaining_main;
    reset = reset_main;
    retry = retry_main;
    wrote = m_raw >= 1 && v && is_last;
    tat_fin = tat_fin_main;
    cur = cur_main;
    denied_seg = seg_n - imin(m_raw, seg_n);
    exp_hit = exp_hit_base && allowed_main;
  } else {
    // ---- degenerate case: three-view orbit, picked by rank parity ----
    const bool degen = inc == 0 || tol == 0;
    const ReqOut o0 = request_outputs(t0, inc, em, tol, now);
    const int64_t v1 = view_next(t0, o0, em, tol, now);
    const ReqOut o1 = request_outputs(v1, inc, em, tol, now);
    const int64_t v2 = view_next(v1, o1, em, tol, now);
    const ReqOut o2 = request_outputs(v2, inc, em, tol, now);
    const bool a0 = o0.allowed, a1 = o1.allowed, a2 = o2.allowed;
    // (rank - 1) even; for rank 0 both this and the floor-mod form of
    // the reference say "odd", and only rank >= 2 reads it anyway.
    const bool alt_even = ((rank - 1) & 1) == 0;
    // Which view a lane reads: 0, 1 or 2 (kernel.py `pick`).
    int view;
    if (!a0) {
      view = 0;
    } else if (!a1) {
      view = rank == 0 ? 0 : 1;
    } else if (rank == 0) {
      view = 0;
    } else if (rank == 1) {
      view = 1;
    } else {
      view = a2 ? (alt_even ? 1 : 2) : 2;
    }
    // Fields are selected by value: a reference to one of the three
    // views would keep them all in local memory.
    const bool allowed_d = view == 0 ? a0 : (view == 1 ? (a0 && a1)
                                                       : (a0 && a1 && a2));
    allowed = (degen ? allowed_d : allowed_main) && v;
    remaining = !degen ? remaining_main
                       : (view == 0 ? o0.remaining
                                    : (view == 1 ? o1.remaining
                                                 : o2.remaining));
    reset = !degen ? reset_main
                   : (view == 0 ? o0.reset
                                : (view == 1 ? o1.reset : o2.reset));
    retry = !degen ? retry_main
                   : (view == 0 ? o0.retry
                                : (view == 1 ? o1.retry : o2.retry));

    const int64_t alt_last = alt_even ? o1.new_tat : o2.new_tat;
    const int64_t tat_fin_degen =
        (rank == 0 || !a1) ? o0.new_tat
                           : ((!a2 || rank == 1) ? o1.new_tat : alt_last);
    wrote = (degen ? a0 : m_raw >= 1) && v && is_last;
    tat_fin = degen ? tat_fin_degen : tat_fin_main;
    const int64_t allowed_cnt_degen =
        !a0 ? 0 : (!a1 ? 1 : (!a2 ? imin(seg_n, 2) : seg_n));
    denied_seg =
        seg_n - (degen ? allowed_cnt_degen : imin(m_raw, seg_n));
    exp_hit = exp_hit_base && allowed;
  }

  // ---- write-back row (kernel._finish) ----
  // A lane whose GCRA write is suppressed hands its gathered row back
  // verbatim, so the scatter addresses never depend on decision data.
  const int64_t ttl_fin = S::add(S::sub(tat_fin, now), tol);
  const int64_t expiry_fin = ttl_fin < 0 ? I64_MAX : S::add(tat_fin, tol);
  const int64_t tat_w = wrote ? tat_fin : stored_tat;
  const int64_t exp_w = wrote ? expiry_fin : stored_exp;
  ro[0] = lo32(tat_w);
  ro[ro_stride] = hi32(tat_w);
  ro[2 * ro_stride] = lo32(exp_w);
  ro[3 * ro_stride] = hi32(exp_w);
  if (W > 4) {
    const int64_t deny = wadd(join(row[4], row[5]), denied_seg);
    ro[4 * ro_stride] = lo32(deny);
    ro[5 * ro_stride] = hi32(deny);
  }

  // ---- output tier ----
  if (TIER == TIER_NS) {
    int64_t* o = (int64_t*)out;
    o[i] = allowed ? 1 : 0;
    o[B + i] = remaining;
    o[2 * B + i] = reset;
    o[3 * B + i] = retry;
  } else if (TIER == TIER_WIRE) {
    int32_t* o = (int32_t*)out;
    o[i] = allowed ? 1 : 0;
    o[B + i] = (int32_t)imin(remaining, I32_MAX);
    o[2 * B + i] = (int32_t)imin(reset / NS_PER_SEC, I32_MAX);
    o[3 * B + i] = (int32_t)imin(retry / NS_PER_SEC, I32_MAX);
  } else if (TIER == TIER_CUR) {
    ((int64_t*)out)[i] = wadd(wmul(cur, 2), allowed ? 1 : 0);
  } else {
    // allowed(1) | remaining(10) | reset_s(11) | retry_s(10), each field
    // the low 32 bits of its value, shifted and OR-ed in 32 bits.
    uint32_t w = (allowed ? 1u : 0u) | ((uint32_t)(uint64_t)remaining << 1) |
                 ((uint32_t)(uint64_t)(reset / NS_PER_SEC) << 11) |
                 ((uint32_t)(uint64_t)(retry / NS_PER_SEC) << 22);
    ((int32_t*)out)[i] = (int32_t)w;
  }
  return exp_hit;
}

// Decide lane i of one sub-batch, gathering its row from `state`
// (i32[N, W], read only here).  Arguments as decide_row's.
template <int W, bool DEGEN, int TIER>
TC_HD bool decide_lane(const Req& r, int i, int B, int64_t N,
                       const int32_t* state, int64_t now, int32_t* ro,
                       int ro_stride, void* out) {
  int32_t row[W];
  load_row<W>(state + gather_index(r, N) * W, row);
  return decide_row<W, DEGEN, TIER>(r, row, i, B, now, ro, ro_stride, out);
}

// The scatter target of lane i: its gathered slot when it is the valid
// is_last lane of its segment (one per slot, so indices are unique),
// else its own scratch row N - B + i.
TC_HD int64_t scatter_index(const Req& r, int i, int B, int64_t N) {
  if ((r.p[2] & FLAG_IS_LAST) && (r.p[2] & FLAG_VALID)) {
    return gather_index(r, N);
  }
  return N - B + i;
}

// Scatter lane i: the row decide_lane left at `ro` goes to its target.
template <int W>
TC_HD void scatter_lane(const Req& r, int i, int B, int64_t N,
                        int32_t* state, const int32_t* ro, int ro_stride) {
  int32_t row[W];
  TC_UNROLL
  for (int c = 0; c < W; ++c) row[c] = ro[c * ro_stride];
  store_row<W>(state + scatter_index(r, i, B, N) * W, row);
}

// ---- the one-block schedule's forwarding table ----
// A one-block window gathers sub-batch k+1's rows while sub-batch k
// decides, so a row it gathered is stale exactly where round k writes
// it.  Round k records every row it writes (each lane's scatter index,
// in `written`) and, in two buckets of an owner table picked by two
// hashes of the index, the lane that writes it, tagged with the round:
// plain stores, the last writer of a bucket wins.  Round k + 1 probes
// its gather index: a bucket of round k whose lane wrote this index is
// a hit (that lane's hand-off row waits in shared memory); a bucket not
// of round k proves the index unwritten, since a written index leaves
// round-k entries in both its buckets; when both buckets hold other
// indices of round k, the answer is a scan of round k's `written`
// (about 1 lane in 1,000 with 2^14 buckets; the kernel scans with the
// whole warp).  So the answer is exact whoever won each bucket, and a
// round takes no atomics and no probe loop: on this card a retry loop of
// shared-memory atomics, a probe loop and a one-thread scan each cost
// microseconds a round.  Two tables alternate by round; tags make
// clearing unnecessary (a tag that wraps only sends a lane to the scan).
constexpr int FWD_LOG2 = 14;
constexpr int FWD_LANE_BITS = 8;
constexpr uint32_t FWD_LANE_MASK = (1u << FWD_LANE_BITS) - 1;
constexpr int FWD_SCAN = -2;  // fwd_probe: only a scan can tell
static_assert(BLOCK_THREADS == 1 << FWD_LANE_BITS, "a lane fits its field");

template <int W, int LOG2>
struct Forward {
  int64_t written[2][BLOCK_THREADS];   // the row each lane writes
  uint32_t owner[2][1 << LOG2];        // round tag | lane
  int32_t rows[2][W * BLOCK_THREADS];  // hand-off rows, [W][BLOCK_THREADS]
};

// The tag of round k's entries.
TC_HD uint32_t fwd_tag(int k) {
  return (uint32_t)(k + 1) << FWD_LANE_BITS;
}
// Bucket h (0 or 1) of row `index`: multiplicative hashes.
template <int LOG2>
TC_HD unsigned fwd_bucket(int64_t index, int h) {
  const uint32_t x =
      (uint32_t)(uint64_t)index ^ (uint32_t)((uint64_t)index >> 32);
  return (x * (h == 0 ? 2654435761u : 2246822519u)) >> (32 - LOG2);
}

// Record that lane `who` of the round tagged `tag` writes row `index`.
template <int LOG2>
TC_HD void fwd_record(uint32_t* owner, int64_t* written, int64_t index,
                      uint32_t tag, int who) {
  written[who] = index;
  owner[fwd_bucket<LOG2>(index, 0)] = tag | (uint32_t)who;
  owner[fwd_bucket<LOG2>(index, 1)] = tag | (uint32_t)who;
}

// The lane of the round tagged `tag` that wrote row `index`, -1 if none
// did, or FWD_SCAN when both buckets hold other rows of that round.
template <int LOG2>
TC_HD int fwd_probe(const uint32_t* owner, const int64_t* written,
                    int64_t index, uint32_t tag) {
  const uint32_t e0 = owner[fwd_bucket<LOG2>(index, 0)];
  const uint32_t e1 = owner[fwd_bucket<LOG2>(index, 1)];
  const bool ours0 = (e0 & ~FWD_LANE_MASK) == tag;
  const bool ours1 = (e1 & ~FWD_LANE_MASK) == tag;
  if (ours0 && written[e0 & FWD_LANE_MASK] == index) {
    return (int)(e0 & FWD_LANE_MASK);
  }
  if (ours1 && written[e1 & FWD_LANE_MASK] == index) {
    return (int)(e1 & FWD_LANE_MASK);
  }
  return ours0 && ours1 ? FWD_SCAN : -1;
}

// The lane < `lanes` whose `written` row is `index`, or -1.
TC_HD int fwd_scan(const int64_t* written, int lanes, int64_t index) {
  for (int j = 0; j < lanes; ++j) {
    if (written[j] == index) return j;
  }
  return -1;
}

// The 12 instantiations: W in {4, 6} x {exact: ns, wire; certified: ns,
// wire, cur, w32}.  by_kind calls f(Kind<W, DEGEN, TIER>{}) for the one
// the arguments name and returns its result, or -1 for any other.
template <int W, bool DEGEN, int TIER>
struct Kind {
  static constexpr int width = W;
  static constexpr bool degen = DEGEN;
  static constexpr int tier = TIER;
};

template <int W, typename F>
int by_tier(int with_degen, int tier, F&& f) {
  if (with_degen) {
    if (tier == TIER_NS) return f(Kind<W, true, TIER_NS>{});
    if (tier == TIER_WIRE) return f(Kind<W, true, TIER_WIRE>{});
    return -1;  // cur/w32 exist only on the certified path
  }
  if (tier == TIER_NS) return f(Kind<W, false, TIER_NS>{});
  if (tier == TIER_WIRE) return f(Kind<W, false, TIER_WIRE>{});
  if (tier == TIER_CUR) return f(Kind<W, false, TIER_CUR>{});
  if (tier == TIER_W32) return f(Kind<W, false, TIER_W32>{});
  return -1;
}

template <typename F>
int by_kind(int width, int with_degen, int tier, F&& f) {
  if (width == 4) return by_tier<4>(with_degen, tier, f);
  if (width == 6) return by_tier<6>(with_degen, tier, f);
  return -1;
}

}  // namespace tc
