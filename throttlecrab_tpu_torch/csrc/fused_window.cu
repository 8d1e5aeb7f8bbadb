// The GCRA decision window on Hopper (sm_90a), bound with a plain C
// interface and loaded through ctypes by throttlecrab_tpu_torch/tpu/fused.py.
//
// Replaces the TPU kernel throttlecrab_tpu/tpu/pallas_fused.py:fused_window
// (the Pallas kernel body _make_kernel, the pair math _gcra_pairs).  The
// TPU kernel decomposes i64 into (lo, hi) i32 pairs because its vector
// lanes are 32-bit; Hopper has 64-bit integer arithmetic, so the lane
// body here (gcra_lane.cuh) runs sat.py's lattice on int64_t directly.
//
// What bounds it on this card: latency, not bytes.  Per request it reads
// one 36-byte packed row and touches two table rows at data-dependent
// addresses (the gather and the scatter), each a whole 32-byte sector
// although a row is 16 or 24 bytes, then writes 4 to 32 bytes of output:
// 6.82 MB for a K=16, B=4096 w32 window, 0.00203 ms at 3.35 TB/s
// (chip_smoke.py bound_ms).  The arithmetic (a few hundred integer
// operations per lane, two or more 64-bit divisions) is far below the
// card's integer rate.  The table (2^20 rows, 16.8 MB at W=4, 25 MB at
// W=6) sits in the 50 MB L2.  What a window waits on is K rounds of
// gather -> decide -> scatter, each ordered after the last.
//
// Ordering.  The TPU kernel is one pallas_call whose grid steps run in
// order, each finishing its gathers before its scatters.  A slot recurs
// within a sub-batch (ranks 0..r gather it, the is_last lane writes it)
// and in the next one, so on the card two facts must hold: every gather
// of sub-batch k reads the table as sub-batch k-1 left it, and no
// scatter of k lands before a gather of k that must not see it.  A
// window is one launch (no memset, no second kernel), and one of two
// schedules, picked by the batch's width (window_geometry):
//
// The cluster schedule (B > BLOCK_THREADS = 256): one thread block
// cluster (the grid is the cluster, at most 16 blocks of 256 threads)
// loops over the K sub-batches and puts a cluster barrier between each
// gather and its scatter and between each scatter and the next gather:
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
// row another block wrote.  The expired-hit count is each block's
// __syncthreads_count, added into n_exp[k] (zeroed by block 0 before
// the first barrier) with integer atomics, exact in any order.  Bound:
// per round the scatter's stores drain to L2 before the release, the
// next gather makes its own L2 round trip, and the lane arithmetic runs
// after it; so the cluster is the largest Hopper allows (16 blocks,
// non-portable) with 256 threads each rather than 8 x 512: twice the SMs
// for the arithmetic.
//
// The one-block schedule (B <= 256: one block, one lane a thread, a
// plain one-block grid).  Every thread that touches the table is in the
// block, so __syncthreads orders everything: the CUDA memory model makes
// every global and shared access before a block barrier visible to the
// whole block after it, and no release to L2 is needed.  Each round has
// one barrier, after its scatter, and the table's latency leaves the
// chain:
//
//   for k:  issue the gather of k+1's rows (and load k+2's requests)
//           take k's row: forwarded from round k-1 on a hit in the
//             forwarding table, else the row gathered during round k-1
//           record k's scatter indices in the forwarding table
//           decide, write the hand-off row to shared memory, scatter it
//             (st.global.cg, not waited on)
//           __syncthreads_count: n_exp[k], written whole by thread 0
//
// The forwarding invariant: a row gathered during round k-1 (after the
// barrier that follows round k-2's scatter) holds every write of rounds
// <= k-2, and is stale exactly where round k-1 wrote, which is every
// index round k-1 recorded (gcra_lane.cuh Forward: a valid is_last
// lane's slot, or a lane's scratch row N - B + i).  Those lanes take the
// hand-off row round k-1 left in shared memory instead, so the table,
// scratch rows included, comes out bit for bit as the cluster
// schedule's.  Round k's own scatters happen after every gather of k
// was issued (the barrier before round k), so no lane of k sees them.
// Recording and looking up take plain shared-memory stores and loads
// (two tagged buckets an index, gcra_lane.cuh fwd_record / fwd_probe);
// the rare lane whose buckets both went to other rows has its warp scan
// the previous round's rows with it.
// The forwarded lanes are counted (one atomic a window into a counter
// the wrapper owns).  Bound: per round, the lookup, the lane arithmetic
// and one barrier; the L2 round trip is hidden behind a round's work.
// A window wider than one block needs cross-block ordering and stays on
// the cluster schedule.

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

// The one-block schedule (see the note at the top).  Thread t owns lane
// t; lanes >= B only reach the barriers.  Its shared memory is one
// Forward (dynamic: the owner tables take 128 KiB).
template <int W>
using BlockForward = tc::Forward<W, tc::FWD_LOG2>;

template <int W, bool DEGEN, int TIER>
__global__ void __launch_bounds__(tc::BLOCK_THREADS, 1)
    block_window_kernel(int32_t* __restrict__ state, int64_t N,
                        const int32_t* __restrict__ packed,
                        const int64_t* __restrict__ now, int K, int B,
                        void* __restrict__ out,
                        unsigned long long* __restrict__ n_exp,
                        unsigned long long* __restrict__ forwarded) {
  extern __shared__ __align__(16) unsigned char block_smem[];
  BlockForward<W>& fw = *reinterpret_cast<BlockForward<W>*>(block_smem);
  __shared__ unsigned long long warp_sums[tc::BLOCK_THREADS / 32];
  const int t = threadIdx.x;
  const bool active = t < B;
  const int64_t sub = (int64_t)B * tc::PACK_WIDTH;
  const int64_t out_stride =
      (TIER == tc::TIER_NS || TIER == tc::TIER_WIRE) ? 4 * (int64_t)B : B;
  const int64_t elem =
      (TIER == tc::TIER_NS || TIER == tc::TIER_CUR) ? 8 : 4;

  // Owner entries start with tag 0, no round's until the tag wraps.
  uint4* owner = reinterpret_cast<uint4*>(&fw.owner[0][0]);
  for (int e = t; e < 2 * (1 << tc::FWD_LOG2) / 4; e += tc::BLOCK_THREADS) {
    owner[e] = make_uint4(0, 0, 0, 0);
  }
  // Round 0's request and row, round 1's request: nothing wrote yet.
  tc::Req r = {}, r_next = {};
  int32_t row[W] = {}, row_next[W] = {};
  if (active && K > 0) {
    r = tc::load_req(packed, t);
    tc::load_row<W>(state + tc::gather_index(r, N) * W, row);
  }
  if (active && K > 1) r_next = tc::load_req(packed + sub, t);
  int64_t now_k = K > 0 ? now[0] : 0;
  unsigned long long fwd = 0;
  __syncthreads();

  for (int k = 0; k < K; ++k) {
    const int p = k & 1;
    // Rounds <= k-1 are ordered before this point, so k+1's rows are
    // stale only where round k writes: gather them now, while k decides.
    tc::Req r_after = {};
    if (active && k + 1 < K) {
      tc::load_row<W>(state + tc::gather_index(r_next, N) * W, row_next);
      if (k + 2 < K) r_after = tc::load_req(packed + (k + 2) * sub, t);
    }
    const int64_t now_next = k + 1 < K ? now[k + 1] : 0;
    const int64_t index = tc::gather_index(r, N);
    int from = active && k > 0
                   ? tc::fwd_probe<tc::FWD_LOG2>(fw.owner[p ^ 1],
                                                 fw.written[p ^ 1], index,
                                                 tc::fwd_tag(k - 1))
                   : -1;
    // The rare lane whose buckets both went to other rows: its warp
    // scans round k-1's rows together, 8 a thread.
    for (unsigned scan = __ballot_sync(~0u, from == tc::FWD_SCAN); scan;
         scan &= scan - 1) {
      const int src = __ffs(scan) - 1;
      const int64_t want = __shfl_sync(~0u, index, src);
      int found = -1;
      for (int j = t & 31; j < B; j += 32) {
        if (fw.written[p ^ 1][j] == want) found = j;
      }
      const unsigned m = __ballot_sync(~0u, found >= 0);
      const int lane_found = __shfl_sync(~0u, found, m ? __ffs(m) - 1 : 0);
      if ((t & 31) == src) from = m ? lane_found : -1;
    }
    bool hit = false;
    if (active) {
      tc::fwd_record<tc::FWD_LOG2>(fw.owner[p], fw.written[p],
                                   tc::scatter_index(r, t, B, N),
                                   tc::fwd_tag(k), t);
      if (from >= 0) {
        ++fwd;
        TC_UNROLL
        for (int c = 0; c < W; ++c) {
          row[c] = fw.rows[p ^ 1][c * tc::BLOCK_THREADS + from];
        }
      }
      int32_t* ro = fw.rows[p] + t;
      hit = tc::decide_row<W, DEGEN, TIER>(
          r, row, t, B, now_k, ro, tc::BLOCK_THREADS,
          (char*)out + k * out_stride * elem);
      tc::scatter_lane<W>(r, t, B, N, state, ro, tc::BLOCK_THREADS);
    }
    const int hits = __syncthreads_count(hit);
    if (t == 0) n_exp[k] = (unsigned long long)hits;
    r = r_next;
    r_next = r_after;
    now_k = now_next;
    TC_UNROLL
    for (int c = 0; c < W; ++c) row[c] = row_next[c];
  }

  // The window's forwarded lanes: warp sums, then one atomic.
  TC_UNROLL
  for (int o = 16; o > 0; o >>= 1) fwd += __shfl_xor_sync(~0u, fwd, o);
  if ((t & 31) == 0) warp_sums[t / 32] = fwd;
  __syncthreads();
  if (t == 0 && forwarded != nullptr) {
    unsigned long long total = 0;
    for (int w = 0; w < tc::BLOCK_THREADS / 32; ++w) total += warp_sums[w];
    atomicAdd(forwarded, total);
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

// Allow the one-block kernel its shared memory and ask whether it runs
// 256 threads; allow the most shared memory any cluster batch needs and
// ask whether the card can hold that cluster at all.  0, -2 when it
// cannot, or a cudaError_t.
template <int W, bool DEGEN, int TIER>
int prepare() {
  // The one-block schedule: 256 threads must fit its registers.
  cudaError_t e = cudaFuncSetAttribute(
      block_window_kernel<W, DEGEN, TIER>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, sizeof(BlockForward<W>));
  if (e != cudaSuccess) return (int)e;
  cudaFuncAttributes fa;
  e = cudaFuncGetAttributes(&fa, block_window_kernel<W, DEGEN, TIER>);
  if (e != cudaSuccess) return (int)e;
  if (fa.maxThreadsPerBlock < tc::BLOCK_THREADS) return -2;
  const tc::Geometry g = tc::window_geometry(tc::MAX_BATCH, W);
  e = cudaFuncSetAttribute(
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
           unsigned long long* n_exp, unsigned long long* forwarded,
           cudaStream_t s) {
  if (tc::one_block(B)) {
    block_window_kernel<W, DEGEN, TIER>
        <<<1, tc::BLOCK_THREADS, sizeof(BlockForward<W>), s>>>(
            state, N, packed, now, K, B, out, n_exp, forwarded);
    return (int)cudaGetLastError();
  }
  const tc::Geometry g = tc::window_geometry(B, W);
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = cluster_config(g, s, &attr);
  return (int)cudaLaunchKernelEx(&cfg, window_kernel<W, DEGEN, TIER>, state,
                                 N, packed, now, K, B, out, n_exp);
}

}  // namespace

// Prepare every instantiation on the current device (one-block kernel,
// shared-memory limit, cluster occupancy).  Call once per device before
// tc_fused_window.  Returns 0, -2 when the card cannot hold a schedule,
// or a cudaError_t.
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

// 1 when a window of B lanes takes the one-block schedule, else 0: the
// wrapper counts its block launches by it.
extern "C" int tc_fused_window_one_block(int B) { return tc::one_block(B); }

// Decide one K-deep window in place on `state` (i32[N, width]).
//   packed i32[K, B, 9]   now i64[K]   1 <= B <= MAX_BATCH, B <= N
//   out    per tier (see gcra_lane.cuh)   n_exp u64[K], written whole
//   forwarded  u64[1]: a one-block window adds its forwarded lanes
// One launch on `stream`, without synchronising.  Returns 0, -1 for an
// argument the kernel does not take, or the launch's cudaError_t.
extern "C" int tc_fused_window(void* state, long long N, int width,
                               const void* packed, const void* now, int K,
                               int B, int with_degen, int tier, void* out,
                               void* n_exp, void* forwarded, void* stream) {
  if (K < 0 || B < 1 || B > tc::MAX_BATCH || B > N) return -1;
  const int rc = tc::by_kind(width, with_degen, tier, [&](auto kind) {
    using T = decltype(kind);
    return launch<T::width, T::degen, T::tier>(
        (int32_t*)state, N, (const int32_t*)packed, (const int64_t*)now, K,
        B, out, (unsigned long long*)n_exp,
        (unsigned long long*)forwarded, (cudaStream_t)stream);
  });
  if (rc > 0) cudaGetLastError();  // clear it: the caller raises instead
  return rc;
}
