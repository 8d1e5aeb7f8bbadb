// Host build of the decision window (gcra_lane.cuh), for checking the
// kernel's integer arithmetic and its schedules on a machine without a
// card:
//   g++ -O2 -std=c++17 -shared -fPIC -o liblane_host.so lane_host.cpp
// It runs the window the way fused_window.cu does, with the same
// geometry and the same lane-to-(block, thread, round) map, on the
// schedule the kernel would take:
//   - the cluster schedule (B > 256): each block's rows in its own
//     shared-memory image, and per sub-batch two phases in barrier order
//     (every lane decides, then every lane scatters);
//   - the one-block schedule (B <= 256): per round, every lane first
//     gathers the next round's row (before any scatter of this round, so
//     a prefetched row is as stale as the card can ever see it), then
//     records its scatter index, takes its row (forwarded from the
//     previous round on a hit) and decides, then every lane scatters.
// Inside a phase the blocks, and the threads of each block, are visited
// in reversed or shuffled order, as the card is free to run them.

#include <stddef.h>
#include <stdint.h>

#include <algorithm>
#include <memory>
#include <numeric>
#include <vector>

#include "gcra_lane.cuh"

namespace {

// Visit order of a phase: reversed on every other phase, else a
// Fisher-Yates shuffle from a 64-bit LCG.
class Order {
 public:
  explicit Order(unsigned seed) : state_(seed * 2862933555777941757ULL + 1) {}

  template <class F>
  void visit(const tc::Geometry& g, F&& f) {
    const bool reverse = (phase_++ + state_) % 2 == 0;
    std::vector<int> blocks = permutation(g.blocks, reverse);
    for (int b : blocks) {
      for (int t : permutation(g.threads, reverse)) f(b, t);
    }
  }

 private:
  std::vector<int> permutation(int n, bool reverse) {
    std::vector<int> v(n);
    std::iota(v.begin(), v.end(), 0);
    if (reverse) {
      std::reverse(v.begin(), v.end());
      return v;
    }
    for (int i = n - 1; i > 0; --i) {
      state_ = state_ * 6364136223846793005ULL + 1442695040888963407ULL;
      std::swap(v[i], v[(state_ >> 33) % (uint64_t)(i + 1)]);
    }
    return v;
  }

  uint64_t state_;
  uint64_t phase_ = 0;
};

template <int W, bool DEGEN, int TIER>
void run_window(int32_t* state, int64_t N, const int32_t* packed,
                const int64_t* now, int K, int B, void* out, int64_t* n_exp,
                int32_t* visits, unsigned seed) {
  const tc::Geometry g = tc::window_geometry(B, W);
  const int stride = tc::row_stride(g);
  const size_t block_words = (size_t)g.smem_bytes / 4;
  std::vector<int32_t> smem(block_words * g.blocks);
  const int64_t out_stride =
      (TIER == tc::TIER_NS || TIER == tc::TIER_WIRE) ? 4 * (int64_t)B : B;
  const int64_t elem =
      (TIER == tc::TIER_NS || TIER == tc::TIER_CUR) ? 8 : 4;
  Order order(seed);
  for (int k = 0; k < K; ++k) {
    const int32_t* pk = packed + (int64_t)k * B * tc::PACK_WIDTH;
    void* out_k = (char*)out + k * out_stride * elem;
    int64_t hits = 0;
    order.visit(g, [&](int b, int t) {
      for (int j = 0; j < g.lanes; ++j) {
        const int i = tc::lane_of(g, b, t, j);
        if (i >= B) continue;
        hits += tc::decide_lane<W, DEGEN, TIER>(
            tc::load_req(pk, i), i, B, N, state, now[k],
            smem.data() + b * block_words + tc::row_slot(g, t, j), stride,
            out_k);
        if (visits) ++visits[(int64_t)(2 * k) * B + i];
      }
    });
    n_exp[k] = hits;
    // cluster barrier
    order.visit(g, [&](int b, int t) {
      for (int j = 0; j < g.lanes; ++j) {
        const int i = tc::lane_of(g, b, t, j);
        if (i >= B) continue;
        tc::scatter_lane<W>(
            tc::load_req(pk, i), i, B, N, state,
            smem.data() + b * block_words + tc::row_slot(g, t, j), stride);
        if (visits) ++visits[(int64_t)(2 * k + 1) * B + i];
      }
    });
    // cluster barrier
  }
}

// The one-block schedule (fused_window.cu block_window_kernel): thread t
// owns lane t; `forwarded` gains the lanes that took a forwarded row.
// LOG2 sizes the owner tables: the kernel's, or a tiny one under which
// most lookups take the scan.
template <int W, bool DEGEN, int TIER, int LOG2>
void run_block_window(int32_t* state, int64_t N, const int32_t* packed,
                      const int64_t* now, int K, int B, void* out,
                      int64_t* n_exp, int32_t* visits, unsigned seed,
                      int64_t* forwarded) {
  const tc::Geometry g = tc::window_geometry(B, W);
  const int64_t sub = (int64_t)B * tc::PACK_WIDTH;
  const int64_t out_stride =
      (TIER == tc::TIER_NS || TIER == tc::TIER_WIRE) ? 4 * (int64_t)B : B;
  const int64_t elem =
      (TIER == tc::TIER_NS || TIER == tc::TIER_CUR) ? 8 : 4;
  auto fw = std::make_unique<tc::Forward<W, LOG2>>();  // owner zeroed
  std::vector<tc::Req> req(B), req_next(B);
  std::vector<int32_t> rows((size_t)B * W), rows_next((size_t)B * W);
  for (int t = 0; t < B && K > 0; ++t) {
    req[t] = tc::load_req(packed, t);
    tc::load_row<W>(state + tc::gather_index(req[t], N) * W, &rows[t * W]);
  }
  Order order(seed);
  int64_t fwd = 0;
  for (int k = 0; k < K; ++k) {
    const int p = k & 1;
    void* out_k = (char*)out + k * out_stride * elem;
    order.visit(g, [&](int, int t) {
      if (t >= B || k + 1 >= K) return;
      req_next[t] = tc::load_req(packed + (k + 1) * sub, t);
      tc::load_row<W>(state + tc::gather_index(req_next[t], N) * W,
                      &rows_next[t * W]);
    });
    int64_t hits = 0;
    order.visit(g, [&](int, int t) {
      if (t >= B) return;
      const tc::Req& r = req[t];
      int32_t* row = &rows[t * W];
      const int64_t index = tc::gather_index(r, N);
      int from = k > 0 ? tc::fwd_probe<LOG2>(fw->owner[p ^ 1],
                                             fw->written[p ^ 1], index,
                                             tc::fwd_tag(k - 1))
                       : -1;
      if (from == tc::FWD_SCAN) {
        from = tc::fwd_scan(fw->written[p ^ 1], B, index);
      }
      tc::fwd_record<LOG2>(fw->owner[p], fw->written[p],
                           tc::scatter_index(r, t, B, N), tc::fwd_tag(k), t);
      if (from >= 0) {
        ++fwd;
        for (int c = 0; c < W; ++c) {
          row[c] = fw->rows[p ^ 1][c * tc::BLOCK_THREADS + from];
        }
      }
      hits += tc::decide_row<W, DEGEN, TIER>(r, row, t, B, now[k],
                                             fw->rows[p] + t,
                                             tc::BLOCK_THREADS, out_k);
      if (visits) ++visits[(int64_t)(2 * k) * B + t];
    });
    n_exp[k] = hits;
    order.visit(g, [&](int, int t) {
      if (t >= B) return;
      tc::scatter_lane<W>(req[t], t, B, N, state, fw->rows[p] + t,
                          tc::BLOCK_THREADS);
      if (visits) ++visits[(int64_t)(2 * k + 1) * B + t];
    });
    // block barrier
    std::swap(req, req_next);
    std::swap(rows, rows_next);
  }
  if (forwarded) *forwarded += fwd;
}

// The window on the schedule the kernel takes; the one-block replay
// with an owner table of 2^LOG2 buckets.
template <int W, bool DEGEN, int TIER, int LOG2>
void run_kernel_schedule(int32_t* state, int64_t N, const int32_t* packed,
                         const int64_t* now, int K, int B, void* out,
                         int64_t* n_exp, int32_t* visits, unsigned seed,
                         int64_t* forwarded) {
  if (tc::one_block(B)) {
    run_block_window<W, DEGEN, TIER, LOG2>(state, N, packed, now, K, B, out,
                                           n_exp, visits, seed, forwarded);
  } else {
    run_window<W, DEGEN, TIER>(state, N, packed, now, K, B, out, n_exp,
                               visits, seed);
  }
}

}  // namespace

// Same arguments as tc_fused_window, on host memory, without the stream;
// `visits` (i32[K, 2, B], zeroed, or NULL) counts each lane's decides and
// scatters per sub-batch, `seed` picks the visit orders, `forwarded`
// (i64[1], or NULL) gains a one-block window's forwarded lanes.  Returns
// 0, or -1 for an argument it does not take.
extern "C" int tc_host_window(void* state, long long N, int width,
                              const void* packed, const void* now, int K,
                              int B, int with_degen, int tier, void* out,
                              void* n_exp, void* visits, unsigned seed,
                              void* forwarded) {
  if (K < 0 || B < 1 || B > tc::MAX_BATCH || B > N) return -1;
  return tc::by_kind(width, with_degen, tier, [&](auto kind) {
    using T = decltype(kind);
    run_kernel_schedule<T::width, T::degen, T::tier, tc::FWD_LOG2>(
        (int32_t*)state, N, (const int32_t*)packed, (const int64_t*)now, K,
        B, out, (int64_t*)n_exp, (int32_t*)visits, seed,
        (int64_t*)forwarded);
    return 0;
  });
}

// As tc_host_window, with the one-block schedule's owner tables cut to 4
// buckets: nearly every lookup finds both its buckets taken by other
// rows and scans, the path the kernel's 2^14 buckets seldom take.
extern "C" int tc_host_window_tiny_owner(void* state, long long N, int width,
                                         const void* packed, const void* now,
                                         int K, int B, int with_degen,
                                         int tier, void* out, void* n_exp,
                                         void* visits, unsigned seed,
                                         void* forwarded) {
  if (K < 0 || B < 1 || B > tc::MAX_BATCH || B > N) return -1;
  return tc::by_kind(width, with_degen, tier, [&](auto kind) {
    using T = decltype(kind);
    run_kernel_schedule<T::width, T::degen, T::tier, 2>(
        (int32_t*)state, N, (const int32_t*)packed, (const int64_t*)now, K,
        B, out, (int64_t*)n_exp, (int32_t*)visits, seed,
        (int64_t*)forwarded);
    return 0;
  });
}

// The cluster schedule at any width (what every window ran before the
// one-block schedule): the yardstick the one-block replay's table,
// scratch rows included, is held to.  Arguments as tc_host_window's
// without `forwarded`.
extern "C" int tc_host_cluster_window(void* state, long long N, int width,
                                      const void* packed, const void* now,
                                      int K, int B, int with_degen,
                                      int tier, void* out, void* n_exp,
                                      void* visits, unsigned seed) {
  if (K < 0 || B < 1 || B > tc::MAX_BATCH || B > N) return -1;
  return tc::by_kind(width, with_degen, tier, [&](auto kind) {
    using T = decltype(kind);
    run_window<T::width, T::degen, T::tier>(
        (int32_t*)state, N, (const int32_t*)packed, (const int64_t*)now, K,
        B, out, (int64_t*)n_exp, (int32_t*)visits, seed);
    return 0;
  });
}

// tc_fused_window_one_block: 1 when a window of B lanes takes the
// one-block schedule.
extern "C" int tc_host_one_block(int B) { return tc::one_block(B); }

// The kernel's launch for a window of B lanes and W-wide rows, with the
// limits it must respect: out[0..5] = blocks, threads, lanes per thread,
// shared-memory bytes per block, cluster size limit, shared-memory limit.
extern "C" void tc_host_geometry(int B, int width, int* out) {
  const tc::Geometry g = tc::window_geometry(B, width);
  out[0] = g.blocks;
  out[1] = g.threads;
  out[2] = g.lanes;
  out[3] = g.smem_bytes;
  out[4] = tc::CLUSTER_BLOCKS;
  out[5] = tc::SMEM_LIMIT;
}
