// Host build of the decision window's lane body (gcra_lane.cuh), for
// checking the kernel's integer arithmetic on a machine without a card:
//   g++ -O2 -std=c++17 -shared -fPIC -o liblane_host.so lane_host.cpp
// It runs the window the way fused_window.cu does — per sub-batch, every
// lane decides, then every lane scatters — with loops for the launches.

#include <stddef.h>
#include <stdint.h>

#include <vector>

#include "gcra_lane.cuh"

namespace {

template <int W, bool DEGEN, int TIER>
void run_window(int32_t* state, int64_t N, const int32_t* packed,
                const int64_t* now, int K, int B, void* out,
                int64_t* n_exp) {
  std::vector<int32_t> rows_out((size_t)B * W);
  const int64_t out_stride =
      (TIER == tc::TIER_NS || TIER == tc::TIER_WIRE) ? 4 * (int64_t)B : B;
  const int64_t elem =
      (TIER == tc::TIER_NS || TIER == tc::TIER_CUR) ? 8 : 4;
  for (int k = 0; k < K; ++k) {
    const int32_t* pk = packed + (int64_t)k * B * tc::PACK_WIDTH;
    void* out_k = (char*)out + k * out_stride * elem;
    int64_t hits = 0;
    for (int i = 0; i < B; ++i) {
      hits += tc::decide_lane<W, DEGEN, TIER>(i, B, N, state, pk, now[k],
                                              rows_out.data(), out_k);
    }
    n_exp[k] = hits;
    for (int i = 0; i < B; ++i) {
      int32_t* d = state + tc::scatter_index(i, B, N, pk) * W;
      for (int c = 0; c < W; ++c) d[c] = rows_out[(size_t)i * W + c];
    }
  }
}

template <int W>
int dispatch(int with_degen, int tier, int32_t* state, int64_t N,
             const int32_t* packed, const int64_t* now, int K, int B,
             void* out, int64_t* n_exp) {
  if (with_degen) {
    if (tier == tc::TIER_NS)
      run_window<W, true, tc::TIER_NS>(state, N, packed, now, K, B, out,
                                       n_exp);
    else if (tier == tc::TIER_WIRE)
      run_window<W, true, tc::TIER_WIRE>(state, N, packed, now, K, B, out,
                                         n_exp);
    else
      return -1;
  } else {
    if (tier == tc::TIER_NS)
      run_window<W, false, tc::TIER_NS>(state, N, packed, now, K, B, out,
                                        n_exp);
    else if (tier == tc::TIER_WIRE)
      run_window<W, false, tc::TIER_WIRE>(state, N, packed, now, K, B, out,
                                          n_exp);
    else if (tier == tc::TIER_CUR)
      run_window<W, false, tc::TIER_CUR>(state, N, packed, now, K, B, out,
                                         n_exp);
    else if (tier == tc::TIER_W32)
      run_window<W, false, tc::TIER_W32>(state, N, packed, now, K, B, out,
                                         n_exp);
    else
      return -1;
  }
  return 0;
}

}  // namespace

// Same arguments as tc_fused_window, on host memory, without rows_out
// and stream.  Returns 0, or -1 for an argument it does not take.
extern "C" int tc_host_window(void* state, long long N, int width,
                              const void* packed, const void* now, int K,
                              int B, int with_degen, int tier, void* out,
                              void* n_exp) {
  if (width == 4)
    return dispatch<4>(with_degen, tier, (int32_t*)state, N,
                       (const int32_t*)packed, (const int64_t*)now, K, B,
                       out, (int64_t*)n_exp);
  if (width == 6)
    return dispatch<6>(with_degen, tier, (int32_t*)state, N,
                       (const int32_t*)packed, (const int64_t*)now, K, B,
                       out, (int64_t*)n_exp);
  return -1;
}
