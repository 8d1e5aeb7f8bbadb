// The by-id front end on Hopper (sm_90a), bound with a plain C interface
// and loaded through ctypes by throttlecrab_tpu_torch/tpu/ids_front.py.
//
// Replaces no TPU kernel: the JAX package's front end is composed jnp
// ops, and so was the port's (tpu/kernel.py `ids_window`: an id-row
// gather, two stable argsorts, a cummax scan and a concatenation, some
// forty kernels and their intermediates a window).  This kernel writes
// the same packed window, bit for bit, in one launch.
//
// What bounds it on this card: bytes.  Per lane it reads a 4-byte id and
// one 32-byte sector of a resident id row, and writes a 36-byte packed
// row: 17 MB of ids, the distinct rows' sectors and 151 MB of packed
// rows for a K=1,024 x B=4,096 window, ~0.05 ms at 3.35 TB/s.  The
// writes are most of it.  The sort is a few passes over a sub-batch in
// shared memory and no device memory.
//
// One block per sub-batch (the grid is K blocks; sub-batches are
// independent here, so nothing is ordered between blocks), `items`
// lanes a thread (front_geometry: up to 512 x 8 = 4,096 lanes):
//
//   1. load: thread t takes lanes j * threads + t (coalesced ids), reads
//      each lane's slot from its id row and marks it valid; a warp max
//      and one shared atomic a warp give the sub-batch's largest slot,
//      which sizes the sort (sort_plan);
//   2. rank: the lanes' sort keys, in arrival order, go through a
//      block-wide stable radix sort (cub::BlockRadixSort over only the
//      bits the keys need) carrying their positions; in the sorted
//      order a run starts where a key differs from the one before, a
//      block max-scan of the start positions gives each item its run's
//      start, its rank is its distance from it, and it ends a run where
//      the next key differs.  rank << 1 | is_last goes back to the
//      lane's arrival position in shared memory.  No per-key atomics:
//      a Zipf head key holds ~500 lanes of a config-3 sub-batch, and the
//      sort does not care how long a run is;
//   3. pack: per chunk of `threads` lanes, each thread reads its lane's
//      id and id row again (columns 0-4: one 16-byte and one 4-byte load
//      when the rows are 16-byte aligned; the sectors read in step 1,
//      now in L2: held in registers through the sort, they made the
//      widest block spill) and writes the nine words into shared
//      memory; the block then
//      stores the chunk's rows as consecutive words, every warp store
//      128 contiguous bytes.
//
// The lane logic and the rank derivation are ids_front.cuh's, which the
// host shim (ids_front_host.cpp) runs on the CPU with a std::stable_sort
// in place of the block sort.

#include <cuda_runtime.h>
#include <stdint.h>

#include <cub/block/block_radix_sort.cuh>
#include <cub/block/block_scan.cuh>

#include "ids_front.cuh"

namespace {

struct MaxOp {
  __device__ __forceinline__ int32_t operator()(int32_t a, int32_t b) const {
    return a > b ? a : b;
  }
};

// Columns 0-4 of an id row, which the rest of the kernel leaves alone
// (read-only path).
__device__ __forceinline__ void load_id_row(const int32_t* src, bool vec,
                                            int32_t* row) {
  if (vec) {
    const int4 v = __ldg(reinterpret_cast<const int4*>(src));
    row[0] = v.x, row[1] = v.y, row[2] = v.z, row[3] = v.w;
    row[4] = __ldg(src + 4);
  } else {
#pragma unroll
    for (int c = 0; c < 5; ++c) row[c] = __ldg(src + c);
  }
}

template <int THREADS, int ITEMS>
__global__ void __launch_bounds__(THREADS, 1024 / THREADS)
    ids_front_kernel(const int32_t* __restrict__ id_rows, int64_t n_ids,
                     int width, int vec, const int32_t* __restrict__ ids,
                     int B, int32_t q_lo, int32_t q_hi,
                     int32_t* __restrict__ packed) {
  using Sort = cub::BlockRadixSort<uint32_t, THREADS, ITEMS, int32_t>;
  using Scan = cub::BlockScan<int32_t, THREADS>;
  constexpr int N = THREADS * ITEMS;
  union Shared {
    typename Sort::TempStorage sort;
    typename Scan::TempStorage scan;
    int32_t stage[THREADS * tc::PACK_WIDTH];
  };
  __shared__ Shared tmp;
  // Per position: a lane's slot (-1 if invalid) in arrival order, then
  // the sorted keys, then each lane's rank word in arrival order.
  __shared__ int32_t lanes[N];
  __shared__ int32_t max_slot;

  const int t = threadIdx.x;
  const int64_t k = blockIdx.x;
  const int32_t* ids_k = ids + k * B;

  // 1. load
  int32_t top = -1;
  if (t == 0) max_slot = -1;
  __syncthreads();
#pragma unroll
  for (int j = 0; j < ITEMS; ++j) {
    const int lane = j * THREADS + t;
    if (lane < B) {
      const int32_t id = ids_k[lane];
      const int32_t slot =
          __ldg(id_rows + tc::id_row(id, n_ids) * width);
      const bool valid = tc::lane_valid(tc::id_in_range(id, n_ids), slot);
      lanes[lane] = valid ? slot : -1;
      if (valid && slot > top) top = slot;
    }
  }
  top = __reduce_max_sync(0xffffffffu, top);
  if ((t & 31) == 0) atomicMax(&max_slot, top);
  __syncthreads();

  // 2. rank: thread t holds sorted positions t * ITEMS + j
  const tc::SortPlan plan = tc::sort_plan(max_slot, B);
  uint32_t keys[ITEMS];
  int32_t pos[ITEMS];
#pragma unroll
  for (int j = 0; j < ITEMS; ++j) {
    const int p = t * ITEMS + j;
    pos[j] = p;
    keys[j] = p < B ? tc::sort_key(lanes[p], p, plan) : tc::FRONT_PAD_KEY;
  }
  __syncthreads();  // every slot read before the sorted keys overwrite it
  Sort(tmp.sort).Sort(keys, pos, 0, plan.end_bit);
#pragma unroll
  for (int j = 0; j < ITEMS; ++j) lanes[t * ITEMS + j] = (int32_t)keys[j];
  __syncthreads();
  const uint32_t before = t > 0 ? (uint32_t)lanes[t * ITEMS - 1] : 0u;
  const uint32_t after =
      t + 1 < THREADS ? (uint32_t)lanes[t * ITEMS + ITEMS] : 0u;
  int32_t start[ITEMS];
#pragma unroll
  for (int j = 0; j < ITEMS; ++j) {
    const int i = t * ITEMS + j;
    const uint32_t prev = j > 0 ? keys[j > 0 ? j - 1 : 0] : before;
    start[j] = tc::run_head(keys[j], prev, i) ? i : 0;
  }
  // Every neighbour read before the rank words overwrite the keys, and
  // the sort's storage free before the scan takes it.
  __syncthreads();
  Scan(tmp.scan).InclusiveScan(start, start, MaxOp());
#pragma unroll
  for (int j = 0; j < ITEMS; ++j) {
    const int i = t * ITEMS + j;
    if (pos[j] < B) {
      const uint32_t next = j + 1 < ITEMS ? keys[j + 1 < ITEMS ? j + 1 : j]
                                          : after;
      lanes[pos[j]] = tc::rank_word(i - start[j],
                                    tc::run_tail(keys[j], next, i, B),
                                    keys[j], plan);
    }
  }
  __syncthreads();  // (the scan's storage is the stage's too)

  // 3. pack, a chunk of THREADS lanes at a time
  int32_t* out_k = packed + k * B * tc::PACK_WIDTH;
#pragma unroll
  for (int j = 0; j < ITEMS; ++j) {
    const int base = j * THREADS;
    if (base >= B) break;
    const int n = B - base < THREADS ? B - base : THREADS;
    if (t < n) {
      // The lane's id and row again (L2): held from step 1, they would
      // take registers through the sort.
      const int32_t id = ids_k[base + t];
      int32_t row[5];
      load_id_row(id_rows + tc::id_row(id, n_ids) * width, vec, row);
      tc::pack_lane(tmp.stage + t * tc::PACK_WIDTH, row, lanes[base + t],
                    tc::lane_valid(tc::id_in_range(id, n_ids), row[0]),
                    q_lo, q_hi);
    }
    __syncthreads();
    int32_t* dst = out_k + (int64_t)base * tc::PACK_WIDTH;
    for (int w = t; w < n * tc::PACK_WIDTH; w += THREADS) dst[w] = tmp.stage[w];
    __syncthreads();
  }
}

template <int THREADS, int ITEMS>
int launch(const int32_t* id_rows, int64_t n_ids, int width, int vec,
           const int32_t* ids, int K, int B, int32_t q_lo, int32_t q_hi,
           int32_t* packed, cudaStream_t s) {
  ids_front_kernel<THREADS, ITEMS><<<K, THREADS, 0, s>>>(
      id_rows, n_ids, width, vec, ids, B, q_lo, q_hi, packed);
  return (int)cudaGetLastError();
}

}  // namespace

// Expand one by-id window: ids i32[K, B] (negative = padding) against
// the resident id rows i32[n_ids, width] into the packed window
// i32[K, B, 9], written whole.  1 <= B <= FRONT_MAX_BATCH, K >= 1,
// 1 <= n_ids <= 2^31 - 1, width >= 5; q_lo / q_hi are the launch-uniform
// quantity's words.  One launch on `stream`, without synchronising.
// Returns 0, -1 for an argument the kernel does not take, or the
// launch's cudaError_t.
extern "C" int tc_ids_front(const void* id_rows, long long n_ids, int width,
                            const void* ids, int K, int B, int q_lo,
                            int q_hi, void* packed, void* stream) {
  const tc::FrontGeometry g = tc::front_geometry(B);
  if (K < 1 || g.threads == 0 || n_ids < 1 || n_ids > INT32_MAX ||
      width < 5) {
    return -1;
  }
  const int vec = width % 4 == 0 && ((uintptr_t)id_rows & 15) == 0;
  const int32_t* rows = (const int32_t*)id_rows;
  const int32_t* w = (const int32_t*)ids;
  int32_t* out = (int32_t*)packed;
  const cudaStream_t s = (cudaStream_t)stream;
  if (g.threads == 256) {
    return launch<256, 1>(rows, n_ids, width, vec, w, K, B, q_lo, q_hi, out,
                          s);
  }
  switch (g.items) {
    case 2:
      return launch<512, 2>(rows, n_ids, width, vec, w, K, B, q_lo, q_hi,
                            out, s);
    case 4:
      return launch<512, 4>(rows, n_ids, width, vec, w, K, B, q_lo, q_hi,
                            out, s);
    default:
      return launch<512, 8>(rows, n_ids, width, vec, w, K, B, q_lo, q_hi,
                            out, s);
  }
}

// The block a sub-batch of B lanes takes: out[0..2] = threads, lanes a
// thread, FRONT_MAX_BATCH (threads 0 when the kernel does not take B).
extern "C" void tc_ids_front_geometry(int B, int* out) {
  const tc::FrontGeometry g = tc::front_geometry(B);
  out[0] = g.threads;
  out[1] = g.items;
  out[2] = tc::FRONT_MAX_BATCH;
}
