// Row gather and row scatter over the bucket table, for Hopper (sm_90a).
//
//   tc_row_gather:  out[i]        = table[idx[i]]   (i < b)
//   tc_row_scatter: table[idx[i]] = rows[i]         (in place)
//
// Replaces throttlecrab_tpu/tpu/pallas_ops.py row_gather (:128) and
// row_scatter (:162).  On the TPU each grid program walks up to 512 rows
// through a RING=16 window of per-row async DMAs, because one core issues
// them in order; here the card keeps the whole batch's accesses in flight
// at once, so the ring, the chunking and the semaphores have no
// counterpart.  These kernels move every live row of a snapshot save or
// restore, a checkpoint generation or recovery, and the supervisor's
// degrade export and re-promotion, ceil(n / 65,536) launches each, and
// the rows of the composed by-id scans (tpu/kernel.py).
//
// Rows are int32[W] with W = 4 (tat, expiry as lo/hi halves) or W = 6
// (the insight layout, + the deny counter).
//
// What bounds them: bytes, then requests and latency.  A launch reads or
// writes the 4-byte index and the row on the dense side, and touches the
// row's sectors of the table: half a 32-byte sector for a W=4 row, 1.5
// sectors on average for a W=6 row at its 24-byte pitch (rows straddle
// sectors), each partly written by the scatter.  At b = 65,536 that is
// 1.0-1.5 us at the HBM rate, about what a launch costs.  The rest is
// request count and latency: a thread-per-row kernel moves a W=6 row as
// three 8-byte accesses, three L2 requests a row whose partial sector
// writes L2 must merge, and each lane waits for its index, then for its
// row.  With L2 cold, the bytes come from HBM (about 1.5 us more a
// launch at b = 65,536 on the H100, PERF.md).  At small b only launch
// and latency remain.
//
// What the design does (the arithmetic is in row_tile.cuh, shared with
// the host shim row_host.cpp that the CPU tests run): a row's parts go
// to adjacent lanes of one warp (a W=4 row: one 16-byte part; a W=6 row:
// three 8-byte parts), so one warp instruction reaches each row's
// sectors with one request and the dense side with contiguous bytes.
// The scatter's index and row loads do not wait on each other, so where
// one row a lane would take more than half the warps the SMs hold (W=6
// at large b) a lane moves two, all loads issued before any store; the
// gather keeps one.  Blocks are the largest that still give every SM
// one.  The index arithmetic ahead of the first load is kept to a
// thread-per-row kernel's.  The table base must be 16-byte aligned and
// the dense buffer aligned to the part; a launch refuses anything else.

// The scatter's indices are unique by the caller's construction
// (suppressed writes go to distinct scratch rows), as the TPU kernel
// assumes: no two lanes write one part.  An index outside [0, n_rows)
// never touches memory outside the table: the gather reads a zero row
// for it and the scatter drops its write (the JAX scatter's
// mode="drop").  Both kernels are enqueued on the caller's stream and
// never synchronise, so stream order keeps a sub-batch's scatter ahead
// of the next sub-batch's gather.

#include <cstdint>

#include <cuda_runtime.h>

#include "row_tile.cuh"

namespace {

template <int W, int P, int S>
__global__ void __launch_bounds__(tc_row::kMaxThreads)
    gather_kernel(const int32_t* __restrict__ table, int64_t n_rows,
                  const int32_t* __restrict__ idx, int b,
                  int32_t* __restrict__ out) {
  tc_row::gather_lane<W, P, S>(blockIdx.x, threadIdx.x, blockDim.x,
                               gridDim.x, table, n_rows, idx, b, out);
}

template <int W, int P, int S>
__global__ void __launch_bounds__(tc_row::kMaxThreads)
    scatter_kernel(int32_t* __restrict__ table, int64_t n_rows,
                   const int32_t* __restrict__ idx, int b,
                   const int32_t* __restrict__ rows) {
  tc_row::scatter_lane<W, P, S>(blockIdx.x, threadIdx.x, blockDim.x,
                                gridDim.x, table, n_rows, idx, b, rows);
}

// One launch of the gather (scatter = 0) or the scatter (1) over b rows
// of `width` words, on the tile picked from b.  Returns the launch's
// cudaError_t (0 on success); the wrapper raises on anything else.
// `stream` is a cudaStream_t.
int launch(int scatter, int32_t* table, long long n_rows, int width,
           const int32_t* idx, int b, int32_t* dense, void* stream) {
  const tc_row::Tile t = tc_row::make_tile(b, width, scatter != 0);
  if (t.blocks == 0) return static_cast<int>(cudaErrorInvalidValue);
  if (!tc_row::aligned(t, reinterpret_cast<uintptr_t>(table),
                       reinterpret_cast<uintptr_t>(dense))) {
    return static_cast<int>(cudaErrorMisalignedAddress);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  bool ok;
  if (scatter) {
    ok = tc_row::dispatch<true>(width, t, [&](auto w, auto p, auto k) {
      constexpr int W = decltype(w)::value, P = decltype(p)::value;
      constexpr int S = decltype(k)::value;
      scatter_kernel<W, P, S><<<t.blocks, t.threads, 0, s>>>(
          table, n_rows, idx, b, dense);
    });
  } else {
    ok = tc_row::dispatch<false>(width, t, [&](auto w, auto p, auto k) {
      constexpr int W = decltype(w)::value, P = decltype(p)::value;
      constexpr int S = decltype(k)::value;
      gather_kernel<W, P, S><<<t.blocks, t.threads, 0, s>>>(
          table, n_rows, idx, b, dense);
    });
  }
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int tc_row_gather(const int32_t* table, long long n_rows,
                             int width, const int32_t* idx, int b,
                             int32_t* out, void* stream) {
  return launch(0, const_cast<int32_t*>(table), n_rows, width, idx, b, out,
                stream);
}

extern "C" int tc_row_scatter(int32_t* table, long long n_rows, int width,
                              const int32_t* idx, int b, const int32_t* rows,
                              void* stream) {
  return launch(1, table, n_rows, width, idx, b, const_cast<int32_t*>(rows),
                stream);
}
