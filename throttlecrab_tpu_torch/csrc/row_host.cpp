// Host build of the row kernels (row_tile.cuh), for checking their tile
// arithmetic on a machine without a card:
//   g++ -O2 -std=c++17 -shared -fPIC -o librow_host.so row_host.cpp
// It cuts a launch as row_ops.cu does (the same make_tile, alignment
// check and dispatch), then runs every lane of every block through the
// same gather_lane / scatter_lane, blocks and threads in reversed order.
// Every part access is checked for the alignment its vector width needs,
// and each lane's (row, part) can be counted.

#include <stddef.h>
#include <stdint.h>

static long g_misaligned = 0;

#define TC_ROW_ACCESS(ptr, bytes) \
  (g_misaligned += (reinterpret_cast<uintptr_t>(ptr) % (bytes)) != 0)

#include "row_tile.cuh"

namespace {

template <bool Scatter>
bool run(const tc_row::Tile& t, int32_t* table, long long n_rows, int width,
         const int32_t* idx, int b, int32_t* dense, int32_t* visits) {
  return tc_row::dispatch<Scatter>(width, t, [&](auto w, auto p, auto k) {
    constexpr int W = decltype(w)::value, P = decltype(p)::value;
    constexpr int S = decltype(k)::value;
    for (int blk = t.blocks - 1; blk >= 0; --blk) {
      for (int th = t.threads - 1; th >= 0; --th) {
        if (visits) {
          for (int s = 0; s < S; ++s) {
            int part = 0;
            const int i = tc_row::row_of<W, P>(blk, th, t.threads,
                                               t.blocks, s, &part);
            if (i >= 0 && i < b) ++visits[i * (W / P) + part];
          }
        }
        if constexpr (Scatter) {
          tc_row::scatter_lane<W, P, S>(blk, th, t.threads, t.blocks, table,
                                        n_rows, idx, b, dense);
        } else {
          tc_row::gather_lane<W, P, S>(blk, th, t.threads, t.blocks, table,
                                       n_rows, idx, b, dense);
        }
      }
    }
  });
}

}  // namespace

// The tile of a launch of the gather (scatter = 0) or the scatter (1)
// over b rows: writes part, lanes_per_row, rows_per_warp, steps, threads,
// rows_per_block, blocks to out[0..6] (blocks 0: a launch the kernels
// refuse).
extern "C" void tc_host_row_tile(int scatter, int b, int width,
                                 int32_t* out) {
  tc_row::write_tile(tc_row::make_tile(b, width, scatter != 0), out);
}

// One launch of the gather (scatter = 0) or the scatter (1), as
// tc_row_gather / tc_row_scatter take it.  `visits` (int32[b *
// lanes_per_row] zeros, or null) counts the lanes that own each (row,
// part).  Returns the number of misaligned part accesses, or -1 where the
// CUDA entry refuses the launch.
extern "C" long tc_host_row_move(int scatter, int32_t* table,
                                 long long n_rows, int width,
                                 const int32_t* idx, int b, int32_t* dense,
                                 int32_t* visits) {
  const tc_row::Tile t = tc_row::make_tile(b, width, scatter != 0);
  if (t.blocks == 0 ||
      !tc_row::aligned(t, reinterpret_cast<uintptr_t>(table),
                       reinterpret_cast<uintptr_t>(dense))) {
    return -1;
  }
  g_misaligned = 0;
  const bool ok =
      scatter ? run<true>(t, table, n_rows, width, idx, b, dense, visits)
              : run<false>(t, table, n_rows, width, idx, b, dense, visits);
  return ok ? g_misaligned : -1;
}
