// The GCRA decision window on Hopper (sm_90a), bound with a plain C
// interface and loaded through ctypes by throttlecrab_tpu_torch/tpu/fused.py.
//
// Replaces the TPU kernel throttlecrab_tpu/tpu/pallas_fused.py:fused_window
// (the Pallas kernel body _make_kernel, the pair math _gcra_pairs).  The
// TPU kernel decomposes i64 into (lo, hi) i32 pairs because its vector
// lanes are 32-bit; Hopper has 64-bit integer arithmetic, so the lane
// body here (gcra_lane.cuh) runs sat.py's lattice on int64_t directly.
//
// What bounds it on this card: bytes.  Per request it reads one 36-byte
// packed row and touches two table rows at data-dependent addresses (the
// gather and the scatter), each a whole 32-byte sector although a row is
// 16 or 24 bytes, then writes 4 to 32 bytes of output.  The arithmetic
// (a few hundred integer operations per lane) is far below the card's
// integer rate.  This first design does nothing about the row sectors
// yet: it is one thread per lane, two launches per sub-batch.
//
// Ordering.  On the TPU each grid step finishes its whole gather ring
// before its scatter ring starts, and grid steps run in order.  Blocks on
// the card run in no order, and a slot can appear several times in one
// sub-batch (ranks 0..r gather it, the is_last lane writes it) and again
// in the next.  So each sub-batch is two launches on one stream:
//   1. decide_kernel: gather, closed forms, write rows_out[B, W], the
//      outputs and the expired-hit count;
//   2. scatter_kernel: rows_out -> the table at unique indices.
// Stream order makes every gather of sub-batch k complete before any of
// its scatters, and every scatter of k complete before k+1 gathers.
// 2K launches per window; fusing them into one persistent launch is
// later work.

#include <cuda_runtime.h>
#include <stdint.h>

#include "gcra_lane.cuh"

namespace {

constexpr int THREADS = 256;

template <int W, bool DEGEN, int TIER>
__global__ void decide_kernel(const int32_t* __restrict__ state, int64_t N,
                              const int32_t* __restrict__ packed,
                              const int64_t* __restrict__ now, int k, int B,
                              int32_t* __restrict__ rows_out, void* out,
                              unsigned long long* __restrict__ n_exp) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  bool hit = false;
  if (i < B) {
    hit = tc::decide_lane<W, DEGEN, TIER>(
        i, B, N, state, packed + (int64_t)k * B * tc::PACK_WIDTH, now[k],
        rows_out, out);
  }
  // Per-block count of expired hits; integer atomics are exact in any
  // order.  Every thread of the block reaches the barrier.
  const int count = __syncthreads_count(hit);
  if (threadIdx.x == 0 && count > 0) {
    atomicAdd(n_exp + k, (unsigned long long)count);
  }
}

template <int W>
__global__ void scatter_kernel(int32_t* __restrict__ state, int64_t N,
                               const int32_t* __restrict__ packed, int k,
                               int B, const int32_t* __restrict__ rows_out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= B) return;
  const int64_t dst =
      tc::scatter_index(i, B, N, packed + (int64_t)k * B * tc::PACK_WIDTH);
  const int32_t* src = rows_out + (int64_t)i * W;
  int32_t* d = state + dst * W;
#pragma unroll
  for (int c = 0; c < W; ++c) d[c] = src[c];
}

template <int W, bool DEGEN, int TIER>
void launch_window(int32_t* state, int64_t N, const int32_t* packed,
                   const int64_t* now, int K, int B, void* out,
                   unsigned long long* n_exp, int32_t* rows_out,
                   cudaStream_t stream) {
  const int blocks = (B + THREADS - 1) / THREADS;
  const int64_t out_stride =
      (TIER == tc::TIER_NS || TIER == tc::TIER_WIRE) ? 4 * (int64_t)B : B;
  const int64_t elem =
      (TIER == tc::TIER_NS || TIER == tc::TIER_CUR) ? 8 : 4;
  for (int k = 0; k < K; ++k) {
    void* out_k = (char*)out + k * out_stride * elem;
    decide_kernel<W, DEGEN, TIER><<<blocks, THREADS, 0, stream>>>(
        state, N, packed, now, k, B, rows_out, out_k, n_exp);
    scatter_kernel<W><<<blocks, THREADS, 0, stream>>>(state, N, packed, k, B,
                                                      rows_out);
  }
}

template <int W>
int dispatch_tier(int with_degen, int tier, int32_t* state, int64_t N,
                  const int32_t* packed, const int64_t* now, int K, int B,
                  void* out, unsigned long long* n_exp, int32_t* rows_out,
                  cudaStream_t s) {
  if (with_degen) {
    if (tier == tc::TIER_NS)
      launch_window<W, true, tc::TIER_NS>(state, N, packed, now, K, B, out,
                                          n_exp, rows_out, s);
    else if (tier == tc::TIER_WIRE)
      launch_window<W, true, tc::TIER_WIRE>(state, N, packed, now, K, B, out,
                                            n_exp, rows_out, s);
    else
      return -1;  // cur/w32 exist only on the certified path
  } else {
    if (tier == tc::TIER_NS)
      launch_window<W, false, tc::TIER_NS>(state, N, packed, now, K, B, out,
                                           n_exp, rows_out, s);
    else if (tier == tc::TIER_WIRE)
      launch_window<W, false, tc::TIER_WIRE>(state, N, packed, now, K, B,
                                             out, n_exp, rows_out, s);
    else if (tier == tc::TIER_CUR)
      launch_window<W, false, tc::TIER_CUR>(state, N, packed, now, K, B, out,
                                            n_exp, rows_out, s);
    else if (tier == tc::TIER_W32)
      launch_window<W, false, tc::TIER_W32>(state, N, packed, now, K, B, out,
                                            n_exp, rows_out, s);
    else
      return -1;
  }
  return 0;
}

}  // namespace

// Decide one K-deep window in place on `state` (i32[N, width]).
//   packed   i32[K, B, 9]   now      i64[K]
//   out      per tier (see gcra_lane.cuh), n_exp u64[K] zero-filled
//   rows_out i32[B, width] scratch shared by the sub-batches
// Launches on `stream` without synchronising.  Returns 0, -1 for an
// argument the kernel does not take, or the cudaError_t of the launches.
extern "C" int tc_fused_window(void* state, long long N, int width,
                               const void* packed, const void* now, int K,
                               int B, int with_degen, int tier, void* out,
                               void* n_exp, void* rows_out, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  int rc;
  if (width == 4)
    rc = dispatch_tier<4>(with_degen, tier, (int32_t*)state, N,
                          (const int32_t*)packed, (const int64_t*)now, K, B,
                          out, (unsigned long long*)n_exp,
                          (int32_t*)rows_out, s);
  else if (width == 6)
    rc = dispatch_tier<6>(with_degen, tier, (int32_t*)state, N,
                          (const int32_t*)packed, (const int64_t*)now, K, B,
                          out, (unsigned long long*)n_exp,
                          (int32_t*)rows_out, s);
  else
    rc = -1;
  if (rc != 0) return rc;
  return (int)cudaGetLastError();
}
