// The count tile of one chain block in shared memory, padded and
// fingerprinted: stream_count.cu's stream_count_kernel and the two
// dissection kernels (count_range.cuh's body) count into it. The tile's
// layout lives here alone: the kernels build it with store_slot + seal_row or
// store_row, address a slot with slot_word, and count and flush through
// the functions below.
//
// Lanes of a warp read random buckets of the tile. A tile that stores
// bucket r's lane l at word r*8 + l (the count's first tile) puts each
// l in one of 4 banks: up to 8-way conflicts on every read. This tile:
//  * rows padded to kRow = 9 words: word r*9 + l is in bank (9r + l) % 32,
//    and 9 is odd, so random buckets spread over all 32 banks (a random
//    warp still meets ~3.5-way conflicts, the most of 32 balls in 32 bins);
//  * a fingerprint word a bucket: lane l's 4 bits at bit 4l, 0 for an empty
//    slot (the all-ones pair) and 1 + (15 * m_hi >> 32) for a key, so a
//    query, whose own fingerprint is never 0, reads one word a round, finds
//    the lanes whose 4 bits equal its own with a SWAR test, and reads lo
//    and hi words only for those.
#pragma once

#include "block_count.cuh"

namespace kmt_tile {

using kmt_count::kBucketKeys;
using kmt_count::kChainBlock;
using kmt_count::kInvalid;

constexpr int kRow = kBucketKeys + 1;  // a padded tile row, in words
constexpr uint32_t kNibbles = 0x11111111u;

// The chain block's keys, counts and fingerprints (14.3 KB).
struct PaddedTile {
  uint32_t lo[kChainBlock * kRow];
  uint32_t hi[kChainBlock * kRow];
  unsigned int cnt[kChainBlock * kRow];
  uint32_t fp[kChainBlock];
};

// The word of slot s (bucket s >> 3, lane s & 7) in lo, hi and cnt.
__device__ __forceinline__ int slot_word(int s) { return (s >> 3) * kRow + (s & 7); }

// A key's 4-bit fingerprint, 1..15 from the high bits of m_hi; 0 is kept
// for empty slots.
__device__ __forceinline__ uint32_t fingerprint(uint32_t m_hi) {
  return __umulhi(m_hi, 15u) + 1u;
}

// The fingerprint word of one bucket whose 8 lanes lie at lo[0..7] and
// hi[0..7].
__device__ __forceinline__ uint32_t bucket_fingerprints(const uint32_t* lo,
                                                        const uint32_t* hi) {
  uint32_t word = 0;
#pragma unroll
  for (int l = 0; l < kBucketKeys; ++l) {
    const uint32_t nibble = lo[l] == kInvalid && hi[l] == kInvalid ? 0u : fingerprint(hi[l]);
    word |= nibble << (4 * l);
  }
  return word;
}

// Slot s's key into the tile, its count zeroed; its bucket's fingerprint
// comes with seal_row once all 8 of the bucket's slots are stored.
__device__ __forceinline__ void store_slot(PaddedTile& tile, int s, uint32_t lo, uint32_t hi) {
  const int w = slot_word(s);
  tile.lo[w] = lo;
  tile.hi[w] = hi;
  tile.cnt[w] = 0;
}

// Bucket r's fingerprint word from its 8 stored keys.
__device__ __forceinline__ void seal_row(PaddedTile& tile, int r) {
  tile.fp[r] = bucket_fingerprints(tile.lo + r * kRow, tile.hi + r * kRow);
}

// Bucket r's 8 keys into the tile, their counts zeroed and its fingerprint
// set, from registers.
__device__ __forceinline__ void store_row(PaddedTile& tile, int r,
                                          const uint32_t (&lo)[kBucketKeys],
                                          const uint32_t (&hi)[kBucketKeys]) {
#pragma unroll
  for (int l = 0; l < kBucketKeys; ++l) store_slot(tile, r * kBucketKeys + l, lo[l], hi[l]);
  tile.fp[r] = bucket_fingerprints(lo, hi);
}

// Bit 4l + 3 set where nibble l of x is 0 (no carry crosses a nibble).
__device__ __forceinline__ uint32_t zero_nibbles(uint32_t x) {
  return ~(((x & 0x77777777u) + 0x77777777u) | x) & 0x88888888u;
}

// Which bucket a query's round p reads: its own bucket's chain (local + p,
// the count), its own bucket every round, or bucket p of the block.
enum RoundBucket : int { kChained = 0, kOwnBucket = 1, kRoundP = 2 };

// A query's rounds on the tile. A query is live when it is not the
// all-ones pair and its bucket lies in the block. With kCompare a round
// reads its bucket's fingerprint word, compares the key words of the lanes
// whose fingerprint is the query's only, and adds one to each lane whose
// key equals (m_lo, m_hi), in the bucket's row or, kRowZero, in row 0;
// without it a round adds one to all 8 slots of its bucket.
template <int kBucket, bool kCompare, bool kRowZero>
__device__ __forceinline__ void query_rounds(PaddedTile& tile, uint32_t m_lo, uint32_t m_hi,
                                             int shift, int64_t bucket0, int bpb, int rounds) {
  if (m_lo == kInvalid && m_hi == kInvalid) return;
  // shifting a 32-bit word by 32 is undefined: one bucket holds every query
  const int64_t bucket = shift >= 32 ? 0 : static_cast<int64_t>(m_lo >> shift);
  const int64_t local = bucket - bucket0;
  if (local < 0 || local >= bpb) return;
  const uint32_t mine = fingerprint(m_hi) * kNibbles;
  for (int p = 0; p < rounds; ++p) {
    const int64_t at = kBucket == kChained ? local + p : kBucket == kOwnBucket ? local : p;
    const int r = static_cast<int>(at & (bpb - 1));
    const int row = r * kRow;
    if constexpr (!kCompare) {
#pragma unroll
      for (int l = 0; l < kBucketKeys; ++l) atomicAdd(&tile.cnt[row + l], 1u);
    } else {
      const int dst = kRowZero ? 0 : row;
      for (uint32_t m = zero_nibbles(tile.fp[r] ^ mine); m; m &= m - 1) {
        const int l = (__ffs(m) - 1) >> 2;
        if (tile.lo[row + l] == m_lo && tile.hi[row + l] == m_hi) {
          atomicAdd(&tile.cnt[dst + l], 1u);
        }
      }
    }
  }
}

// The count: adds one to each slot of the query's chain of buckets whose
// key equals (m_lo, m_hi).
__device__ __forceinline__ void count_query(PaddedTile& tile, uint32_t m_lo, uint32_t m_hi,
                                            int shift, int64_t bucket0, int bpb, int rounds) {
  query_rounds<kChained, true, false>(tile, m_lo, m_hi, shift, bucket0, bpb, rounds);
}

// The key stored at slot s.
__device__ __forceinline__ void slot_key(const PaddedTile& tile, int s, uint32_t& lo,
                                         uint32_t& hi) {
  const int w = slot_word(s);
  lo = tile.lo[w];
  hi = tile.hi[w];
}

// Adds each nonzero count-tile entry into the global counts of the block's
// slots [slot0, slot0 + n_slots).
__device__ __forceinline__ void flush_tile(const PaddedTile& tile, unsigned int* __restrict__ counts,
                                           int64_t slot0, int n_slots, int n_threads) {
  for (int i = threadIdx.x; i < n_slots; i += n_threads) {
    const unsigned int c = tile.cnt[slot_word(i)];
    if (c) atomicAdd(&counts[slot0 + i], c);
  }
}

}  // namespace kmt_tile
