// Row gather and row scatter over the bucket table, for Hopper (sm_90a).
//
// The port of throttlecrab_tpu/tpu/pallas_ops.py row_gather (:128) and
// row_scatter (:162).  On the TPU each grid program walks up to 512 rows
// through a RING=16 window of per-row async DMAs, because one core
// issues them in order.  Here every row is one thread: the card keeps
// thousands of independent row accesses in flight on its own, so the
// ring, the chunking and the semaphores have no counterpart.
//
//   tc_row_gather:  out[i]        = table[idx[i]]   (i < b)
//   tc_row_scatter: table[idx[i]] = rows[i]         (in place)
//
// Rows are int32[W] with W = 4 (tat, expiry as lo/hi halves) or W = 6
// (the insight layout, + the deny counter).  A W=4 row is one 16-byte
// vector load and store; a W=6 row (24 bytes, 8-byte aligned) is three
// 8-byte ones.  The wrapper (tpu/row_ops.py) checks the alignment.
//
// Bound: bytes.  Each row touched costs one 32-byte sector of the
// table, plus the 4-byte index and the row itself on the dense side;
// at B = 4096 that is ~0.2 MB, some 0.06 us at 3.35 TB/s, so a launch
// is bound by its own launch cost long before the memory system.  So
// these kernels are fused away where speed matters: every window of
// the table's entry points, by-id ones included, moves its rows inside
// fused_window.cu's cluster loop.  What still launches these is the
// composed by-id scans of tpu/kernel.py (gcra_scan_{byid,ids,ids20}),
// the counterparts of the JAX functions, one gather and one scatter per
// sub-batch; their wrapper (tpu/row_ops.py) keeps its host cost small.
//
// The scatter's indices are unique by the caller's construction
// (suppressed writes go to distinct scratch rows), as the TPU kernel
// assumes: no two threads write one row.  An index outside [0, n_rows)
// never touches memory outside the table: the gather reads a zero row
// for it and the scatter drops its write (the JAX scatter's
// mode="drop").  Both kernels are enqueued on the caller's stream and
// never synchronise, so stream order keeps a sub-batch's scatter ahead
// of the next sub-batch's gather.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

template <int W>
__device__ __forceinline__ void copy_row(const int32_t* __restrict__ src,
                                         int32_t* __restrict__ dst) {
  if constexpr (W == 4) {
    *reinterpret_cast<int4*>(dst) = *reinterpret_cast<const int4*>(src);
  } else {
    static_assert(W == 6, "rows are 4 or 6 int32 wide");
    const int2* s = reinterpret_cast<const int2*>(src);
    int2* d = reinterpret_cast<int2*>(dst);
    const int2 a = s[0], b = s[1], c = s[2];
    d[0] = a;
    d[1] = b;
    d[2] = c;
  }
}

template <int W>
__global__ void __launch_bounds__(kThreads)
    gather_kernel(const int32_t* __restrict__ table, int64_t n_rows,
                  const int32_t* __restrict__ idx, int b,
                  int32_t* __restrict__ out) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= b) return;
  const int64_t r = idx[i];
  int32_t* dst = out + static_cast<int64_t>(i) * W;
  if (r < 0 || r >= n_rows) {
#pragma unroll
    for (int c = 0; c < W; ++c) dst[c] = 0;
    return;
  }
  copy_row<W>(table + r * W, dst);
}

template <int W>
__global__ void __launch_bounds__(kThreads)
    scatter_kernel(int32_t* __restrict__ table, int64_t n_rows,
                   const int32_t* __restrict__ idx, int b,
                   const int32_t* __restrict__ rows) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= b) return;
  const int64_t r = idx[i];
  if (r < 0 || r >= n_rows) return;
  copy_row<W>(rows + static_cast<int64_t>(i) * W, table + r * W);
}

inline dim3 grid_for(int b) { return dim3((b + kThreads - 1) / kThreads); }

}  // namespace

// Returns the launch's cudaError_t (0 on success); the wrapper raises on
// anything else.  `stream` is a cudaStream_t.
extern "C" int tc_row_gather(const int32_t* table, long long n_rows,
                             int width, const int32_t* idx, int b,
                             int32_t* out, void* stream) {
  if (b <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (width == 4) {
    gather_kernel<4><<<grid_for(b), kThreads, 0, s>>>(table, n_rows, idx, b,
                                                       out);
  } else if (width == 6) {
    gather_kernel<6><<<grid_for(b), kThreads, 0, s>>>(table, n_rows, idx, b,
                                                       out);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int tc_row_scatter(int32_t* table, long long n_rows, int width,
                              const int32_t* idx, int b, const int32_t* rows,
                              void* stream) {
  if (b <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (width == 4) {
    scatter_kernel<4><<<grid_for(b), kThreads, 0, s>>>(table, n_rows, idx, b,
                                                        rows);
  } else if (width == 6) {
    scatter_kernel<6><<<grid_for(b), kThreads, 0, s>>>(table, n_rows, idx, b,
                                                        rows);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
