// Host build of the by-id front end (ids_front.cuh), for checking the
// kernel's lane logic and rank derivation on a machine without a card:
//   g++ -O2 -std=c++17 -shared -fPIC -o libids_front_host.so ids_front_host.cpp
// It runs each sub-batch the way ids_front.cu does: the block's
// threads * items positions, the padding past B keyed FRONT_PAD_KEY, a
// stable sort on the plan's low end_bit bits of the keys (std::
// stable_sort in place of cub::BlockRadixSort, which is stable), run
// starts and ends off neighbours, the max-scan of the starts, the rank
// words back at the arrival positions, and each lane packed from its
// clamped id row.

#include <stddef.h>
#include <stdint.h>

#include <algorithm>
#include <numeric>
#include <vector>

#include "ids_front.cuh"

// Same arguments as tc_ids_front, on host memory, without the stream.
// Returns 0, or -1 for an argument the kernel does not take (a B outside
// [1, FRONT_MAX_BATCH] among them: such a window keeps the plain ops).
extern "C" int tc_host_ids_front(const void* id_rows, long long n_ids,
                                 int width, const void* ids, int K, int B,
                                 int q_lo, int q_hi, void* packed) {
  const tc::FrontGeometry g = tc::front_geometry(B);
  if (K < 0 || g.threads == 0 || n_ids < 1 || n_ids > INT32_MAX ||
      width < 5) {
    return -1;
  }
  const int n = g.threads * g.items;
  const int32_t* rows = (const int32_t*)id_rows;
  std::vector<int64_t> row(B);
  std::vector<int32_t> slot(B), word(B);
  std::vector<char> valid(B);
  std::vector<uint32_t> key(n);
  std::vector<int> order(n);
  for (int k = 0; k < K; ++k) {
    const int32_t* ids_k = (const int32_t*)ids + (int64_t)k * B;
    int32_t top = -1;
    for (int i = 0; i < B; ++i) {
      row[i] = tc::id_row(ids_k[i], n_ids);
      const int32_t s = rows[row[i] * width];
      valid[i] = tc::lane_valid(tc::id_in_range(ids_k[i], n_ids), s);
      slot[i] = valid[i] ? s : -1;
      if (slot[i] > top) top = slot[i];
    }
    const tc::SortPlan plan = tc::sort_plan(top, B);
    for (int p = 0; p < n; ++p) {
      key[p] = p < B ? tc::sort_key(slot[p], p, plan) : tc::FRONT_PAD_KEY;
    }
    const uint32_t mask =
        plan.end_bit >= 32 ? 0xFFFFFFFFu : (1u << plan.end_bit) - 1u;
    std::iota(order.begin(), order.end(), 0);
    std::stable_sort(order.begin(), order.end(), [&](int a, int b) {
      return (key[a] & mask) < (key[b] & mask);
    });
    int start = 0;  // the max-scan of run starts, in sorted order
    for (int i = 0; i < n; ++i) {
      const int p = order[i];
      const uint32_t before = i > 0 ? key[order[i - 1]] : 0u;
      const uint32_t after = i + 1 < n ? key[order[i + 1]] : 0u;
      if (tc::run_head(key[p], before, i)) start = std::max(start, i);
      if (p < B) {
        word[p] = tc::rank_word(i - start, tc::run_tail(key[p], after, i, B),
                                key[p], plan);
      }
    }
    int32_t* out_k = (int32_t*)packed + (int64_t)k * B * tc::PACK_WIDTH;
    for (int i = 0; i < B; ++i) {
      tc::pack_lane(out_k + (int64_t)i * tc::PACK_WIDTH, rows + row[i] * width,
                    word[i], valid[i], q_lo, q_hi);
    }
  }
  return 0;
}

// tc_ids_front_geometry: out[0..2] = threads, lanes a thread,
// FRONT_MAX_BATCH (threads 0 when the kernel does not take B).
extern "C" void tc_host_ids_front_geometry(int B, int* out) {
  const tc::FrontGeometry g = tc::front_geometry(B);
  out[0] = g.threads;
  out[1] = g.items;
  out[2] = tc::FRONT_MAX_BATCH;
}
