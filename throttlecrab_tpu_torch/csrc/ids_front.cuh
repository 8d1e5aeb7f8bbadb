// Per-lane fields and segment ranks of the by-id front end, shared by
// the CUDA kernel (ids_front.cu, compiled by nvcc for sm_90a) and the
// host shim (ids_front_host.cpp, compiled by g++ so the lane logic and
// the rank derivation are checked on a machine without a card).
//
// The front end turns a window of raw key ids (i32[K, B], negative =
// padding) into the packed request rows the decision window decides
// (i32[K, B, PACK_WIDTH], kernel.pack_requests' layout), lane for lane
// what throttlecrab_tpu_torch/tpu/kernel.py `ids_window` computes:
//
//   valid   = 0 <= id < n_ids and the id row's slot >= 0 (`_ids_fields`)
//   row     = id_rows[clamp(id, 0, n_ids - 1)], columns 0-4
//   segkey  = valid ? slot : I32_MAX - pos   (`_ids_fields`)
//   rank    = the lane's place among its sub-batch's lanes of one
//             segkey, in arrival order; is_last = it is the last one
//             (`_device_segments`)
//   packed  = slot, rank, flags, em lo/hi, tol lo/hi, quantity lo/hi
//             (`_pack_window`)
//
// The kernel ranks by a stable sort of each sub-batch on a segment key
// (sort_key below), then reads run starts and ends off neighbours in the
// sorted order.  Only equality of keys matters to a rank, so the sort
// may use any key with the same equalities as segkey; sort_plan picks
// one that needs few bits.
#pragma once

#include <stdint.h>

#include "gcra_lane.cuh"

namespace tc {

// The widest sub-batch the kernel holds in one block (BASELINE config
// 3's batch); a wider by-id window keeps the plain ops.
constexpr int FRONT_MAX_BATCH = 4096;
// Sort key of the positions past B in a block's last items: above every
// lane's key in any bit range, so the padding sorts after every lane.
constexpr uint32_t FRONT_PAD_KEY = 0xFFFFFFFFu;

// The block a sub-batch of B lanes takes: `threads` threads holding
// `items` lanes each (threads * items >= B), or {0, 0} when B is outside
// [1, FRONT_MAX_BATCH].  The kernel is instantiated for these four.
struct FrontGeometry {
  int threads;
  int items;
};
TC_HD FrontGeometry front_geometry(int B) {
  if (B < 1 || B > FRONT_MAX_BATCH) return {0, 0};
  if (B <= 256) return {256, 1};
  if (B <= 1024) return {512, 2};
  if (B <= 2048) return {512, 4};
  return {512, 8};
}

// Where lane `id` reads its id row, and whether the id lies in the
// resident rows (an id interned after upload, or padding, does not).
TC_HD int64_t id_row(int32_t id, int64_t n_ids) {
  return id < 0 ? 0 : (id >= n_ids ? n_ids - 1 : id);
}
TC_HD bool id_in_range(int32_t id, int64_t n_ids) {
  return id >= 0 && id < n_ids;
}
// An unresolved id row carries slot -1: invalid, never slot 0's bucket.
TC_HD bool lane_valid(bool in_range, int32_t slot) {
  return in_range && slot >= 0;
}

// How a sub-batch is sorted, from its largest valid slot (-1 if none).
// Compact (the rule): a valid lane keys on slot + 1 and every invalid
// lane on 0, so the sort needs only bit_width(max_slot + 1) bits; the
// invalid lanes then form one run, and rank_word gives each the rank 0
// and is_last of a segment of its own, as segkey's I32_MAX - pos does.
// Exact: when a valid slot is within B of I32_MAX, an invalid lane's
// segkey can equal it and join its segment, so the keys are segkey
// itself, over 31 bits.
struct SortPlan {
  bool exact;
  int end_bit;  // the sort orders keys by bits [0, end_bit)
};
TC_HD int bit_width(uint32_t x) {
  int n = 0;
  while (x) {
    ++n;
    x >>= 1;
  }
  return n;
}
TC_HD SortPlan sort_plan(int32_t max_slot, int B) {
  if (max_slot > I32_MAX - B) return {true, 31};
  const int bits = bit_width((uint32_t)(max_slot + 1));
  return {false, bits > 0 ? bits : 1};
}
// The sort key of the lane at arrival position `pos` (< B); `slot` is
// its id row's slot where the lane is valid, else -1.
TC_HD uint32_t sort_key(int32_t slot, int pos, SortPlan plan) {
  if (plan.exact) {
    return (uint32_t)(slot >= 0 ? slot : (int32_t)(I32_MAX - pos));
  }
  return slot >= 0 ? (uint32_t)slot + 1u : 0u;
}

// In the sorted order: whether item i (key `key`, the item before it
// `before`) starts a run, and whether it ends one (`after` the item
// after it; n real lanes, the padding after them).
TC_HD bool run_head(uint32_t key, uint32_t before, int i) {
  return i == 0 || key != before;
}
TC_HD bool run_tail(uint32_t key, uint32_t after, int i, int n) {
  return i == n - 1 || key != after;
}
// A lane's rank and is_last in one word (rank << 1 | is_last): `rank` is
// its sorted position less its run's start.
TC_HD int32_t rank_word(int32_t rank, bool last, uint32_t key,
                        SortPlan plan) {
  if (!plan.exact && key == 0) return 1;  // invalid: a run of its own
  return (rank << 1) | (last ? 1 : 0);
}

// A lane's packed request row: the id row's slot (valid or not), the
// rank, the flags, the id row's emission and tolerance words verbatim
// and the launch-uniform quantity.
TC_HD void pack_lane(int32_t* out, const int32_t* row, int32_t rank_last,
                     bool valid, int32_t q_lo, int32_t q_hi) {
  out[0] = row[0];
  out[1] = rank_last >> 1;
  out[2] = (rank_last & 1) * FLAG_IS_LAST + (valid ? FLAG_VALID : 0);
  out[3] = row[1];
  out[4] = row[2];
  out[5] = row[3];
  out[6] = row[4];
  out[7] = q_lo;
  out[8] = q_hi;
}

}  // namespace tc
