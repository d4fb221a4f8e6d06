// Device code of the gather probe, shared by the library path's kernel
// (gather_probe.cu) and its dissection (gather_probe_dissect.cu): the
// table's view, the L2 policies, the row loads and the chain walk.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#include "chain.cuh"
#include "u32mix.cuh"

namespace kmt_gather {

constexpr int kBucketKeys = 8;
constexpr int kChainBlock = 128;
constexpr int kThreads = 256;
constexpr int kMaxProbeHard = 64;  // layout.MAX_PROBE_HARD
constexpr int kMaxBuckets = 1 << 29;  // slots stay below 2**32
constexpr uint32_t kEmpty = 0xFFFFFFFFu;

enum Mode : int { kCount = 0, kSlots = 1 };

enum Priority : int { kEvictLast, kEvictNormal, kEvictFirst };

// The table's buckets [row_offset, row_offset + n_local) of n_buckets: a
// whole table (row_offset 0, n_local n_buckets) or an index shard's bucket
// range (parallel/sharded.py). Buckets, chains and block bounds are the
// whole table's; a round whose bucket lies in another shard compares
// nothing, and slots are the shard's own.
struct Table {
  const uint4* lo;  // (n_local, 8) uint32: two uint4 a bucket
  const uint32_t* hi;
  const int32_t* block_probe;  // per chain block; null: max_probe everywhere
  int shift;  // bucket = m_lo >> shift; 32: one bucket
  int block_shift;  // chain block = bucket >> block_shift
  uint32_t mask;  // bpb - 1
  int max_probe;
  uint32_t seed;
  uint32_t row_offset;
  uint32_t n_local;
};

// The L2 eviction policies of one launch: for the lo rows, and for the hi
// words and count adds of hits.
struct Policies {
  uint64_t rows, hits;
};

// True unless the arguments break the launch contract shared by both
// entry points (gather_probe_launch's comment).
inline bool valid_launch(long long n, int n_buckets, int n_blocks, int max_probe, int mode,
                         const void* key_lo, const void* block_probe) {
  const int bpb = n_buckets < kChainBlock ? n_buckets : kChainBlock;
  return n >= 0 && n_buckets >= 1 && n_buckets <= kMaxBuckets &&
         !(n_buckets & (n_buckets - 1)) && max_probe >= 1 && max_probe <= kMaxProbeHard &&
         (mode == kCount || mode == kSlots) && !(reinterpret_cast<uintptr_t>(key_lo) & 15) &&
         n_blocks == (block_probe == nullptr ? 0 : n_buckets / bpb);
}

// True where [row_offset, row_offset + n_local) is a range of the table.
inline bool valid_shard(int n_buckets, int row_offset, int n_local) {
  return row_offset >= 0 && n_local >= 1 &&
         static_cast<int64_t>(row_offset) + n_local <= n_buckets;
}

inline Table make_table(const void* key_lo, const void* key_hi, const void* block_probe,
                        int n_buckets, int max_probe, unsigned int seed, int row_offset = 0,
                        int n_local = -1) {
  const int bpb = n_buckets < kChainBlock ? n_buckets : kChainBlock;
  Table t;
  t.lo = static_cast<const uint4*>(key_lo);
  t.hi = static_cast<const uint32_t*>(key_hi);
  t.block_probe = static_cast<const int32_t*>(block_probe);
  t.shift = 32;  // u32hash.bucket_shift
  while ((1ll << (32 - t.shift)) < n_buckets) --t.shift;
  t.block_shift = 0;
  while ((1 << t.block_shift) < bpb) ++t.block_shift;
  t.mask = static_cast<uint32_t>(bpb - 1);
  t.max_probe = max_probe;
  t.seed = seed;
  t.row_offset = static_cast<uint32_t>(row_offset);
  t.n_local = static_cast<uint32_t>(n_local < 0 ? n_buckets : n_local);
  return t;
}

__device__ __forceinline__ uint64_t l2_policy(int priority) {
  uint64_t policy;
  if (priority == kEvictLast) {
    asm volatile("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;" : "=l"(policy));
  } else if (priority == kEvictFirst) {
    asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;" : "=l"(policy));
  } else {
    asm volatile("createpolicy.fractional.L2::evict_normal.b64 %0, 1.0;" : "=l"(policy));
  }
  return policy;
}

// Half a bucket's lo row (4 words), through the read-only path under policy.
__device__ __forceinline__ uint4 load_lo(const uint4* p, uint64_t policy) {
  uint4 v;
  asm volatile("ld.global.nc.L2::cache_hint.v4.u32 {%0, %1, %2, %3}, [%4], %5;"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "l"(p), "l"(policy));
  return v;
}

// One hi word, through the read-only path under policy.
__device__ __forceinline__ uint32_t load_hi(const uint32_t* p, uint64_t policy) {
  uint32_t v;
  asm volatile("ld.global.nc.L2::cache_hint.u32 %0, [%1], %2;" : "=r"(v) : "l"(p), "l"(policy));
  return v;
}

// counts[slot] += v (wrapping), performed in L2 under policy.
__device__ __forceinline__ void add_count(unsigned int* p, unsigned int v, uint64_t policy) {
  asm volatile("red.global.add.L2::cache_hint.u32 [%0], %1, %2;"
               :: "l"(p), "r"(v), "l"(policy) : "memory");
}

// Bit l set where lane l of the row (w0, w1) holds lo word x.
__device__ __forceinline__ uint32_t lo_lanes(uint4 w0, uint4 w1, uint32_t x) {
  return (w0.x == x) | (w0.y == x) << 1 | (w0.z == x) << 2 | (w0.w == x) << 3 |
         (w1.x == x) << 4 | (w1.y == x) << 5 | (w1.z == x) << 6 | (w1.w == x) << 7;
}

// Bucket b's row in the table's arrays, or -1 where another shard holds it.
__device__ __forceinline__ int64_t local_row(const Table& t, uint32_t b) {
  const uint32_t r = b - t.row_offset;
  return r < t.n_local ? static_cast<int64_t>(r) : -1;
}

// The slot among the lanes of the table's row `row` whose lo word matched
// (bits of `lanes`) that also holds hi word r, or -1.
__device__ __forceinline__ int64_t check_hi(const Table& t, int64_t row,
                                            uint32_t lanes, uint32_t r,
                                            uint64_t policy) {
  const int64_t slot0 = row * kBucketKeys;
  for (; lanes; lanes &= lanes - 1) {
    const int l = __ffs(lanes) - 1;
    if (load_hi(t.hi + slot0 + l, policy) == r) return slot0 + l;
  }
  return -1;
}

// Rounds p in [first, rounds) of the chain of home bucket b0, one at a time;
// a round whose bucket lies in another shard compares nothing.
__device__ __forceinline__ int64_t walk(const Table& t, uint32_t L, uint32_t R,
                                        uint32_t b0, int first, int rounds,
                                        const Policies& policy) {
  const uint32_t base = b0 & ~t.mask;
  for (int p = first; p < rounds; ++p) {
    const int64_t r = local_row(t, base | ((b0 + p) & t.mask));
    if (r < 0) continue;
    const uint4* row = t.lo + 2 * r;
    const uint32_t lanes =
        lo_lanes(load_lo(row, policy.rows), load_lo(row + 1, policy.rows), L);
    if (lanes) {
      const int64_t slot = check_hi(t, r, lanes, R, policy.hits);
      if (slot >= 0) return slot;
    }
  }
  return -1;
}

// Splits raw word q into its (lo, hi) words and mixes them; false where
// the mixed pair is the empty-slot sentinel, which never matches.
__device__ __forceinline__ bool mixed_words(long long q, uint32_t seed, uint32_t& lo,
                                            uint32_t& hi) {
  lo = static_cast<uint32_t>(q);
  hi = static_cast<uint32_t>(static_cast<unsigned long long>(q) >> 32);
  kmt_mix::feistel_mix(lo, hi, seed);
  return !(lo == kEmpty && hi == kEmpty);
}

// Home bucket of mixed lo word; shifting a 32-bit word by 32 is undefined,
// and one bucket holds every key.
__device__ __forceinline__ uint32_t home_bucket(const Table& t, uint32_t lo) {
  return t.shift < 32 ? lo >> t.shift : 0u;
}

// Rounds the query of home bucket b0 walks: its chain block's bound
// (chain.cuh) capped at max_probe, or max_probe without block bounds.
__device__ __forceinline__ int query_rounds(const Table& t, uint32_t b0) {
  return t.block_probe == nullptr
             ? t.max_probe
             : kmt_chain::probe_rounds(t.block_probe, b0 >> t.block_shift, 0, t.max_probe);
}

}  // namespace kmt_gather
