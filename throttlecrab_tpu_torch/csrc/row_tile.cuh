// The tile arithmetic of the row kernels (row_ops.cu), written once as
// __host__ __device__ inline C++: nvcc compiles it into the kernels, and
// g++ compiles the same header into the host shim row_host.cpp, which
// walks the kernels' blocks and threads on a machine without a card.
//
// A row of W int32 words moves as W / P parts of P words, one part per
// lane, the parts of a row on adjacent lanes of one warp.  So a warp
// instruction covers whole rows: its accesses to one row's table
// sectors reach L2 as one request, and on the dense side (the batch's
// rows, read by the scatter and written by the gather) a warp's lanes
// touch contiguous bytes.  The part is fixed by the width: a W=4 row is
// one 16-byte part (P = 4), a W=6 row three 8-byte parts on three lanes
// (P = 2; 10 rows per warp, lanes 30 and 31 idle).  The table base is
// 16-byte aligned and the dense buffer aligned to the part (the
// launcher refuses anything else), so every part lies aligned.
//
// Each lane moves `steps` rows (1, or 2 for the W=6 scatter at large b):
// it first loads their indices, then issues their table accesses back
// to back, so the latencies overlap.

#pragma once

#include <stdint.h>

#if defined(__CUDACC__)
#define TC_ROW_HD __host__ __device__ __forceinline__
#define TC_ROW_UNROLL _Pragma("unroll")
#else
#define TC_ROW_HD inline
#define TC_ROW_UNROLL
#endif

// Called with every pointer a part access uses, before the access; the
// host shim defines it to count misaligned parts.
#ifndef TC_ROW_ACCESS
#define TC_ROW_ACCESS(ptr, bytes) ((void)0)
#endif

namespace tc_row {

constexpr int kWarp = 32;
constexpr int kMaxThreads = 256;  // the kernels' __launch_bounds__
constexpr int kMinBlocks = 132;   // one block for each SM of an H100
constexpr int kManyWarps = 32 * 132;  // half the warps the SMs can hold

// One launch's cut of b rows.
struct Tile {
  int part;           // int32 words per access: 4 (W=4) or 2 (W=6)
  int lanes_per_row;  // width / part
  int rows_per_warp;  // rows one warp step moves: kWarp / lanes_per_row
  int steps;          // rows each lane moves
  int threads;        // lanes per block, a multiple of kWarp
  int rows_per_block;
  int blocks;         // 0: the arguments are not a launch the kernels take
};

// int32 words per access for a row of `width` words.
TC_ROW_HD int part_words(int width) { return width == 4 ? 4 : 2; }

TC_ROW_HD int rows_per_block(int rows_per_warp, int threads, int steps) {
  return threads / kWarp * rows_per_warp * steps;
}

// The launch of the gather (scatter = false) or the scatter over b rows
// (1 <= b <= 65,536) of `width` (4 or 6) words, as measured best on the
// H100 (row_ab.py and a tile sweep, PERF.md): the gather moves one row a
// lane, because a second row's table load waits for its index as the
// first's does; the scatter's loads wait for nothing, and it moves two
// rows a lane where one would take more than kManyWarps warps (only a
// W=6 row, which takes three lanes, gets there).  Then the most lanes
// per block, at most 256 lane steps, that still give every SM a block;
// where none does, one warp.
TC_ROW_HD Tile make_tile(int b, int width, bool scatter) {
  Tile t = {0, 0, 0, 0, 0, 0, 0};
  if (b < 1 || b > (1 << 16) || (width != 4 && width != 6)) return t;
  t.part = part_words(width);
  t.lanes_per_row = width / t.part;
  t.rows_per_warp = kWarp / t.lanes_per_row;
  const int warps = (b + t.rows_per_warp - 1) / t.rows_per_warp;
  t.steps = scatter && warps > kManyWarps ? 2 : 1;
  t.threads = kWarp;
  for (int n = kMaxThreads / t.steps; n > kWarp; n -= kWarp) {
    const int per = rows_per_block(t.rows_per_warp, n, t.steps);
    if ((b + per - 1) / per >= kMinBlocks) {
      t.threads = n;
      break;
    }
  }
  t.rows_per_block = rows_per_block(t.rows_per_warp, t.threads, t.steps);
  t.blocks = (b + t.rows_per_block - 1) / t.rows_per_block;
  return t;
}

// Whether a launch may start: the table on 16 bytes, the dense buffer
// on its part (16 bytes for W=4, 8 for W=6).
TC_ROW_HD bool aligned(const Tile& t, uintptr_t table, uintptr_t dense) {
  return table % 16 == 0 && dense % (4 * t.part) == 0;
}

// The row and part that lane `thread` of `block` moves at `step`, of a
// launch of `blocks` blocks of `threads` lanes; -1 for a lane past its
// warp's last whole row.  Step s of the launch's w-th warp moves the
// warp-row w + s * (its warps), so the lanes of a warp instruction hold
// neighbouring rows.  The arithmetic before a lane's first index load
// is on every launch's critical path: for one lane a row it is the
// thread-per-row kernel's one multiply-add.
template <int W, int P>
TC_ROW_HD int row_of(int block, int thread, int threads, int blocks,
                     int step, int* part) {
  constexpr int lanes = W / P;
  constexpr int per_warp = kWarp / lanes;
  const unsigned g = unsigned(block) * unsigned(threads) + unsigned(thread);
  const unsigned total = unsigned(blocks) * unsigned(threads);
  if constexpr (lanes == 1) {
    *part = 0;
    return int(g + unsigned(step) * total);
  } else {
    const int r = int(g % kWarp) / lanes;
    if (r >= per_warp) return -1;
    *part = int(g % kWarp) - r * lanes;
    return int((g / kWarp + unsigned(step) * (total / kWarp)) * per_warp) +
           r;
  }
}

TC_ROW_HD bool in_table(int64_t r, int64_t n_rows) {
  return r >= 0 && r < n_rows;
}

// One access of P words.
#if defined(__CUDACC__)
template <int P> struct Vec;
template <> struct Vec<4> { using T = int4; };
template <> struct Vec<2> { using T = int2; };
#else
template <int P> struct alignas(4 * P) HostVec { int32_t w[P]; };
template <int P> struct Vec { using T = HostVec<P>; };
#endif

template <int P>
TC_ROW_HD typename Vec<P>::T load_part(const int32_t* p) {
  TC_ROW_ACCESS(p, 4 * P);
  return *reinterpret_cast<const typename Vec<P>::T*>(p);
}

template <int P>
TC_ROW_HD void store_part(int32_t* p, typename Vec<P>::T v) {
  TC_ROW_ACCESS(p, 4 * P);
  *reinterpret_cast<typename Vec<P>::T*>(p) = v;
}

// One lane of the gather: out[i] = table[idx[i]] (a zero row for an
// index outside [0, n_rows)) for the parts it owns.
template <int W, int P, int S>
TC_ROW_HD void gather_lane(int block, int thread, int threads, int blocks,
                           const int32_t* __restrict__ table, int64_t n_rows,
                           const int32_t* __restrict__ idx, int b,
                           int32_t* __restrict__ out) {
  using V = typename Vec<P>::T;
  int i[S] = {};
  int64_t r[S] = {};
  V v[S] = {};
  int part = 0;
  TC_ROW_UNROLL
  for (int s = 0; s < S; ++s) {
    i[s] = row_of<W, P>(block, thread, threads, blocks, s, &part);
    if (i[s] >= b) i[s] = -1;
  }
  TC_ROW_UNROLL
  for (int s = 0; s < S; ++s) r[s] = i[s] >= 0 ? idx[i[s]] : -1;
  TC_ROW_UNROLL
  for (int s = 0; s < S; ++s) {
    if (in_table(r[s], n_rows)) {
      v[s] = load_part<P>(table + r[s] * W + part * P);
    }
  }
  TC_ROW_UNROLL
  for (int s = 0; s < S; ++s) {
    if (i[s] >= 0) store_part<P>(out + i[s] * W + part * P, v[s]);
  }
}

// One lane of the scatter: table[idx[i]] = rows[i] for the parts it
// owns; an index outside [0, n_rows) drops its write.
template <int W, int P, int S>
TC_ROW_HD void scatter_lane(int block, int thread, int threads, int blocks,
                            int32_t* __restrict__ table, int64_t n_rows,
                            const int32_t* __restrict__ idx, int b,
                            const int32_t* __restrict__ rows) {
  using V = typename Vec<P>::T;
  int i[S] = {};
  int64_t r[S] = {};
  V v[S] = {};
  int part = 0;
  TC_ROW_UNROLL
  for (int s = 0; s < S; ++s) {
    i[s] = row_of<W, P>(block, thread, threads, blocks, s, &part);
    if (i[s] >= b) i[s] = -1;
  }
  TC_ROW_UNROLL
  for (int s = 0; s < S; ++s) {
    r[s] = -1;
    if (i[s] >= 0) {
      r[s] = idx[i[s]];
      v[s] = load_part<P>(rows + i[s] * W + part * P);
    }
  }
  TC_ROW_UNROLL
  for (int s = 0; s < S; ++s) {
    if (in_table(r[s], n_rows)) {
      store_part<P>(table + r[s] * W + part * P, v[s]);
    }
  }
}

// The tile as the host shim reports it: part, lanes_per_row,
// rows_per_warp, steps, threads, rows_per_block, blocks in out[0..6].
inline void write_tile(const Tile& t, int32_t* out) {
  const int32_t v[7] = {t.part, t.lanes_per_row, t.rows_per_warp, t.steps,
                        t.threads, t.rows_per_block, t.blocks};
  for (int k = 0; k < 7; ++k) out[k] = v[k];
}

template <int N> struct Int { static constexpr int value = N; };

// Calls f(Int<W>, Int<P>, Int<S>) for the tile's instantiation of the
// gather (Scatter = false) or the scatter; false for a tile no kernel
// takes.  Five instantiations exist: both kinds at <4, 4, 1> and
// <6, 2, 1>, and the scatter at <6, 2, 2>.  The kernels' launcher and
// the host shim both dispatch through it.
template <bool Scatter, class F>
inline bool dispatch(int width, const Tile& t, F&& f) {
  if (t.blocks == 0) return false;
  if (width == 4 && t.steps == 1) {
    f(Int<4>{}, Int<4>{}, Int<1>{});
    return true;
  }
  if (width == 6 && t.steps == 1) {
    f(Int<6>{}, Int<2>{}, Int<1>{});
    return true;
  }
  if constexpr (Scatter) {
    if (width == 6 && t.steps == 2) {
      f(Int<6>{}, Int<2>{}, Int<2>{});
      return true;
    }
  }
  return false;
}

}  // namespace tc_row
