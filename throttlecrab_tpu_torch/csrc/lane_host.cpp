// Host build of the decision window (gcra_lane.cuh), for checking the
// kernel's integer arithmetic and its schedule on a machine without a
// card:
//   g++ -O2 -std=c++17 -shared -fPIC -o liblane_host.so lane_host.cpp
// It runs the window the way fused_window.cu does: the same geometry, the
// same lane-to-(block, thread, round) map, each block's rows in its own
// shared-memory image, and per sub-batch two phases in barrier order
// (every lane decides, then every lane scatters).  Inside a phase the
// blocks, and the threads of each block, are visited in reversed or
// shuffled order, as the card is free to run them.

#include <stddef.h>
#include <stdint.h>

#include <algorithm>
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

}  // namespace

// Same arguments as tc_fused_window, on host memory, without the stream;
// `visits` (i32[K, 2, B], zeroed, or NULL) counts each lane's decides and
// scatters per sub-batch, `seed` picks the visit orders.  Returns 0, or
// -1 for an argument it does not take.
extern "C" int tc_host_window(void* state, long long N, int width,
                              const void* packed, const void* now, int K,
                              int B, int with_degen, int tier, void* out,
                              void* n_exp, void* visits, unsigned seed) {
  if (K < 0 || B < 1 || B > tc::MAX_BATCH || B > N) return -1;
  return tc::by_kind(width, with_degen, tier, [&](auto kind) {
    using T = decltype(kind);
    run_window<T::width, T::degen, T::tier>(
        (int32_t*)state, N, (const int32_t*)packed, (const int64_t*)now, K,
        B, out, (int64_t*)n_exp, (int32_t*)visits, seed);
    return 0;
  });
}

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
