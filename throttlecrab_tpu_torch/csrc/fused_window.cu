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
// 16 or 24 bytes, then writes 4 to 32 bytes of output: 6.82 MB for a
// K=16, B=4096 w32 window, 0.00203 ms at 3.35 TB/s (chip_smoke.py
// bound_ms).  The arithmetic (a few hundred integer operations per lane)
// is far below the card's integer rate.  The table (2^20 rows, 16.8 MB
// at W=4, 25 MB at W=6) sits in the 50 MB L2, so what a window really
// waits on is latency: K rounds of gather -> decide -> scatter, each
// ordered after the last.
//
// Ordering.  The TPU kernel is one pallas_call whose grid steps run in
// order, each finishing its gathers before its scatters.  A slot recurs
// within a sub-batch (ranks 0..r gather it, the is_last lane writes it)
// and in the next one, so on the card two facts must hold: every gather
// of sub-batch k happens before any scatter of k, and every scatter of k
// before any gather of k+1.  An earlier design got them from stream
// order, at two launches per sub-batch (2K per window, each paying
// launch latency and ramp).  This one is a single launch per window: one
// thread block cluster (the grid is the cluster, at most 16 blocks of 256
// threads, gcra_lane.cuh window_geometry) loops over the K sub-batches
// itself and puts a cluster barrier where the stream order was:
//
//   for k:  gather + decide its lanes -> rows wait in shared memory
//           cluster barrier
//           scatter its lanes
//           cluster barrier (k+1's first request and now loaded between
//           arrive and wait: they do not depend on the table)
//
// Clusters are co-scheduled, so the barrier cannot deadlock; every
// thread of every block reaches both barriers in every round (no early
// return, lanes >= B only skip their work).  barrier.cluster.arrive /
// wait release / acquire at cluster scope, and every thread that touches
// the table is in the cluster, so the scatter's global writes are
// visible to the next gather without a __threadfence(); the rows are
// read with ld.global.cg (L2 only), so no SM reads a stale L1 copy of a
// row another block wrote.  The card tests' cross-block windows (one
// slot over every lane, a slot at lanes 0 and B-1 of every sub-batch)
// check it.  The expired-hit count is each block's
// __syncthreads_count, added into n_exp[k] (zeroed by block 0 before
// the first barrier) with integer atomics, exact in any order.  A window
// is exactly one CUDA launch: the wrapper fills nothing.
//
// Where the time goes: round trips, not bytes.  Per sub-batch the
// scatter's stores must reach L2 before the barrier releases, the next
// gather then makes its own round trip to L2, and the lane arithmetic
// (two or more 64-bit divisions a lane) runs on the cluster's SMs only.
// So the cluster is the largest Hopper allows (16 blocks, non-portable)
// with 256 threads each rather than 8 x 512: twice the SMs for the
// arithmetic.  A window is K of these chains in a row.

#include <cuda_runtime.h>
#include <stdint.h>

#include "gcra_lane.cuh"

namespace {

// barrier.cluster.arrive / wait: release / acquire at cluster scope by
// default, which orders the table's global writes and reads between the
// cluster's blocks.  Split, so independent loads can go in between.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

template <int W, bool DEGEN, int TIER>
__global__ void __launch_bounds__(tc::BLOCK_THREADS, 1)
    window_kernel(int32_t* __restrict__ state, int64_t N,
                  const int32_t* __restrict__ packed,
                  const int64_t* __restrict__ now, int K, int B,
                  void* __restrict__ out,
                  unsigned long long* __restrict__ n_exp) {
  extern __shared__ __align__(16) int32_t rows[];
  const tc::Geometry g = tc::window_geometry(B, W);
  const int b = blockIdx.x;
  const int t = threadIdx.x;
  const int stride = tc::row_stride(g);
  const int64_t out_stride =
      (TIER == tc::TIER_NS || TIER == tc::TIER_WIRE) ? 4 * (int64_t)B : B;
  const int64_t elem =
      (TIER == tc::TIER_NS || TIER == tc::TIER_CUR) ? 8 : 4;

  if (b == 0) {
    for (int k = t; k < K; k += g.threads) n_exp[k] = 0;
  }
  // The first lane's request and the timestamp of the next sub-batch are
  // loaded a round ahead: they do not depend on the table.
  const int lane0 = tc::lane_of(g, b, t, 0);
  tc::Req next = {};
  int64_t now_next = 0;
  if (K > 0) {
    if (lane0 < B) next = tc::load_req(packed, lane0);
    now_next = now[0];
  }
  for (int k = 0; k < K; ++k) {
    const int32_t* pk = packed + (int64_t)k * B * tc::PACK_WIDTH;
    void* out_k = (char*)out + k * out_stride * elem;
    const tc::Req r0 = next;
    const int64_t now_k = now_next;

    int hits = 0;
    for (int j = 0; j < g.lanes; ++j) {
      const int i = tc::lane_of(g, b, t, j);
      bool hit = false;
      if (i < B) {
        hit = tc::decide_lane<W, DEGEN, TIER>(
            j == 0 ? r0 : tc::load_req(pk, i), i, B, N, state, now_k,
            rows + tc::row_slot(g, t, j), stride, out_k);
      }
      hits += __syncthreads_count(hit);
    }
    cluster_arrive();  // every gather of k before any scatter of k
    cluster_wait();

    if (t == 0 && hits > 0) atomicAdd(n_exp + k, (unsigned long long)hits);
    for (int j = 0; j < g.lanes; ++j) {
      const int i = tc::lane_of(g, b, t, j);
      if (i < B) {
        tc::scatter_lane<W>(j == 0 ? r0 : tc::load_req(pk, i), i, B, N,
                            state, rows + tc::row_slot(g, t, j), stride);
      }
    }
    cluster_arrive();  // every scatter of k before any gather of k+1
    if (k + 1 < K) {
      if (lane0 < B) {
        next = tc::load_req(pk + (int64_t)B * tc::PACK_WIDTH, lane0);
      }
      now_next = now[k + 1];
    }
    cluster_wait();
  }
}

cudaLaunchConfig_t cluster_config(const tc::Geometry& g, cudaStream_t s,
                                  cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(g.blocks, 1, 1);
  cfg.blockDim = dim3(g.threads, 1, 1);
  cfg.dynamicSmemBytes = g.smem_bytes;
  cfg.stream = s;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = g.blocks;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// Allow the most shared memory any batch needs and ask whether the card
// can hold that cluster at all.  0, -2 when it cannot, or a cudaError_t.
template <int W, bool DEGEN, int TIER>
int prepare() {
  const tc::Geometry g = tc::window_geometry(tc::MAX_BATCH, W);
  cudaError_t e = cudaFuncSetAttribute(
      window_kernel<W, DEGEN, TIER>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, g.smem_bytes);
  if (e != cudaSuccess) return (int)e;
  e = cudaFuncSetAttribute(window_kernel<W, DEGEN, TIER>,
                           cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = cluster_config(g, 0, &attr);
  int clusters = 0;
  e = cudaOccupancyMaxActiveClusters(&clusters,
                                     window_kernel<W, DEGEN, TIER>, &cfg);
  if (e != cudaSuccess) return (int)e;
  return clusters >= 1 ? 0 : -2;
}

template <int W, bool DEGEN, int TIER>
int launch(int32_t* state, int64_t N, const int32_t* packed,
           const int64_t* now, int K, int B, void* out,
           unsigned long long* n_exp, cudaStream_t s) {
  const tc::Geometry g = tc::window_geometry(B, W);
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = cluster_config(g, s, &attr);
  return (int)cudaLaunchKernelEx(&cfg, window_kernel<W, DEGEN, TIER>, state,
                                 N, packed, now, K, B, out, n_exp);
}

}  // namespace

// Prepare every instantiation on the current device (shared-memory limit,
// cluster occupancy).  Call once per device before tc_fused_window.
// Returns 0, -2 when the card cannot hold the cluster, or a cudaError_t.
extern "C" int tc_fused_window_prepare() {
  const int kinds[6][2] = {{1, tc::TIER_NS},  {1, tc::TIER_WIRE},
                           {0, tc::TIER_NS},  {0, tc::TIER_WIRE},
                           {0, tc::TIER_CUR}, {0, tc::TIER_W32}};
  const int widths[2] = {4, 6};
  for (int width : widths) {
    for (const auto& k : kinds) {
      const int rc = tc::by_kind(width, k[0], k[1], [](auto kind) {
        using T = decltype(kind);
        return prepare<T::width, T::degen, T::tier>();
      });
      if (rc != 0) return rc;
    }
  }
  return 0;
}

// Decide one K-deep window in place on `state` (i32[N, width]).
//   packed i32[K, B, 9]   now i64[K]   1 <= B <= MAX_BATCH, B <= N
//   out    per tier (see gcra_lane.cuh)   n_exp u64[K], written whole
// One launch on `stream`, without synchronising.  Returns 0, -1 for an
// argument the kernel does not take, or the launch's cudaError_t.
extern "C" int tc_fused_window(void* state, long long N, int width,
                               const void* packed, const void* now, int K,
                               int B, int with_degen, int tier, void* out,
                               void* n_exp, void* stream) {
  if (K < 0 || B < 1 || B > tc::MAX_BATCH || B > N) return -1;
  const int rc = tc::by_kind(width, with_degen, tier, [&](auto kind) {
    using T = decltype(kind);
    return launch<T::width, T::degen, T::tier>(
        (int32_t*)state, N, (const int32_t*)packed, (const int64_t*)now, K,
        B, out, (unsigned long long*)n_exp, (cudaStream_t)stream);
  });
  if (rc > 0) cudaGetLastError();  // clear it: the caller raises instead
  return rc;
}
