// The count of one range of a chain block's window on count_tile.cuh's
// padded, fingerprinted tile, with one part removed per dissection variant:
// the body of both dissection kernels. r2_kernel_dissect.cu runs it on a
// CTA per chain block, the range its whole window; r2_window_dissect.cu on
// a CTA per window range of a schedule.
//
// A CTA stages its block's 8 KB of keys with 16-byte cp.async copies into a
// flat buffer, loads its first kItems keys a thread (evict-first) while
// they land, then builds the tile from the buffer (rows padded to 9 words,
// a fingerprint word a bucket), counts its range into it and adds the
// nonzero entries into the global counts. What a round of each variant does
// on the tile (block_count.cuh names the variants; each is count_tile.cuh's
// query_rounds):
//
//   kFull, kNoDma  the count (count_query): the bucket's fingerprint word,
//                  then the key words of the candidate lanes only
//                  (kNoDma's query is the tile's key at slot i mod n_slots)
//   kNoMm2         the same candidates and compare; a hit of lane l adds
//                  to row 0, lane l
//   kNoMm1         all 8 slots of the query's own bucket, every round
//   kNoMm1Rolled   all 8 slots of bucket local + p
//   kNoHot         bucket p's fingerprint word and keys
//   kEmpty         staging only: the tile is built, nothing is counted
#pragma once

#include "async_copy.cuh"
#include "count_tile.cuh"

namespace kmt_range {

using namespace kmt_count;
using kmt_copy::aligned16;
using kmt_copy::cp_async16;
using kmt_tile::PaddedTile;

constexpr int kCountThreads = 256;
constexpr int kItems = 4;  // keys a thread loads before it counts them

// The shared memory of a CTA: the tile and the flat buffer its keys land in.
struct RangeSmem {
  PaddedTile tile;
  alignas(16) uint32_t stage[2 * kTileSlots];
};

template <int V>
__device__ __forceinline__ void load_keys(unsigned long long (&key)[kItems],
                                          const unsigned long long* __restrict__ sorted_keys,
                                          int64_t i0, int64_t hi) {
  if (V == kNoDma) return;
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    const int64_t i = i0 + j * kCountThreads;
    key[j] = i < hi ? __ldcs(&sorted_keys[i]) : 0;
  }
}

// One query's rounds under variant V (count_tile.cuh's query_rounds).
template <int V>
__device__ __forceinline__ void dissect_query(PaddedTile& tile, uint32_t m_lo, uint32_t m_hi,
                                              int shift, int64_t bucket0, int bpb, int rounds) {
  using namespace kmt_tile;
  constexpr int kBucket = V == kNoHot ? kRoundP : V == kNoMm1 ? kOwnBucket : kChained;
  constexpr bool kCompare = V != kNoMm1 && V != kNoMm1Rolled;
  query_rounds<kBucket, kCompare, V == kNoMm2>(tile, m_lo, m_hi, shift, bucket0, bpb, rounds);
}

// counts += variant V's contribution of the sorted queries [first, hi) of
// chain block g's window. Every thread of the CTA (kCountThreads) calls it.
template <int V>
__device__ __forceinline__ void count_range(RangeSmem& sm, const uint32_t* __restrict__ key_lo,
                                            const uint32_t* __restrict__ key_hi,
                                            unsigned int* __restrict__ counts,
                                            const unsigned long long* __restrict__ sorted_keys,
                                            const int32_t* __restrict__ block_probe, int64_t g,
                                            int64_t first, int64_t hi, int shift, int bpb,
                                            int max_probe) {
  const int n_slots = bpb * kBucketKeys;
  // 64-bit slot arithmetic: tables past 2^28 buckets have slots past 2^31
  const int64_t slot0 = g * static_cast<int64_t>(n_slots);
  const int n_chunks = n_slots / 4;  // 16-byte chunks of each key word
  for (int c = threadIdx.x; c < 2 * n_chunks; c += kCountThreads) {
    const bool upper = c >= n_chunks;
    const int w = (upper ? c - n_chunks : c) * 4;
    cp_async16(sm.stage + (upper ? kTileSlots : 0) + w, (upper ? key_hi : key_lo) + slot0 + w);
  }
  asm volatile("cp.async.commit_group;\n" ::);
  int64_t i0 = first + threadIdx.x;
  unsigned long long key[kItems];
  load_keys<V>(key, sorted_keys, i0, hi);  // in flight while the keys land
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();
  for (int r = threadIdx.x; r < bpb; r += kCountThreads) {
    uint32_t lo[kBucketKeys], hi_w[kBucketKeys];  // bucket r's keys, from the flat buffer
    const uint4* row_lo = reinterpret_cast<const uint4*>(sm.stage + r * kBucketKeys);
    const uint4* row_hi = reinterpret_cast<const uint4*>(sm.stage + kTileSlots + r * kBucketKeys);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const uint4 a = row_lo[h], b = row_hi[h];
      lo[4 * h] = a.x, lo[4 * h + 1] = a.y, lo[4 * h + 2] = a.z, lo[4 * h + 3] = a.w;
      hi_w[4 * h] = b.x, hi_w[4 * h + 1] = b.y, hi_w[4 * h + 2] = b.z, hi_w[4 * h + 3] = b.w;
    }
    kmt_tile::store_row(sm.tile, r, lo, hi_w);
  }
  __syncthreads();
  if constexpr (V == kEmpty) return;

  const int rounds = kmt_chain::probe_rounds(block_probe, g, 1, max_probe);
  const int64_t bucket0 = g * static_cast<int64_t>(bpb);
  for (;;) {
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      const int64_t i = i0 + j * kCountThreads;
      if (i >= hi) break;
      uint32_t m_lo, m_hi;
      if (V == kNoDma) {  // the key of slot i mod n_slots stands in
        kmt_tile::slot_key(sm.tile, static_cast<int>(i & (n_slots - 1)), m_lo, m_hi);
      } else {
        const unsigned long long u = key[j] ^ kSignBit;
        m_lo = static_cast<uint32_t>(u >> 32);
        m_hi = static_cast<uint32_t>(u);
      }
      dissect_query<V>(sm.tile, m_lo, m_hi, shift, bucket0, bpb, rounds);
    }
    i0 += kCountThreads * kItems;
    if (i0 >= hi) break;
    load_keys<V>(key, sorted_keys, i0, hi);
  }
  __syncthreads();
  kmt_tile::flush_tile(sm.tile, counts, slot0, n_slots, kCountThreads);
}

}  // namespace kmt_range
