// The first stream count, one chain block per CTA, and the variants that
// dissect it: r2_kernel_dissect.cu launches every variant of
// block_count_kernel (its kFull is the main path's count before
// stream_count.cu's own kernel). Each variant removes one part of the
// count, as the Pallas variants of scripts/r2_kernel_dissect.py:_kernel_v
// do; r2_window_dissect.cu takes the variant ids and the launch checks. The
// plain twin of the variants is
// kmer_mapper_tpu_torch/scripts/r2_kernel_dissect.py:variant_twin.
//
// A query is live when it is not the all-ones pair and its bucket lies in
// the CTA's chain block; it walks rounds p < rounds, where rounds =
// max(min_rounds, min(block_probe[b], max_rounds)). stream_count passes
// (0, bpb): a chain never leaves its block, so more than bpb rounds would
// only revisit buckets. The dissection kernels pass (1, max_probe), as the
// Pallas kernels always run round 0 and stop at the table's chain bound.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#include "chain.cuh"

namespace kmt_count {

constexpr int kBucketKeys = 8;
constexpr int kChainBlock = 128;
constexpr int kTileSlots = kChainBlock * kBucketKeys;
constexpr int kThreads = 256;
constexpr uint32_t kInvalid = 0xFFFFFFFFu;
constexpr unsigned long long kSignBit = 0x8000000000000000ull;

// the variant ids of kmer_mapper_tpu_torch/scripts/r2_kernel_dissect.py
enum Variant : int {
  kFull = 0,        // the count itself
  kNoMm2 = 1,       // hits are not scattered: lane k's hits all go to bucket 0
  kNoMm1 = 2,       // no compare: each round adds 1 to all 8 slots of the
                    // query's own bucket (r2_kernel_dissect's nomm1)
  kNoHot = 3,       // no bucket addressing: round p compares with bucket p
  kNoDma = 4,       // no query loads: position i stands in the key of slot i
  kEmpty = 5,       // no query loop; the key tile is still staged
  kEmptyNoTb = 6,   // no query loop and no staging
  kNoMm1Rolled = 7  // no compare: round p adds 1 to all 8 slots of bucket
                    // local + p (r2_window_dissect's nomm1)
};

// The chain block's keys and its count tile, in shared memory (12 KB).
struct BlockTile {
  uint32_t lo[kTileSlots];
  uint32_t hi[kTileSlots];
  unsigned int cnt[kTileSlots];
};

// Copies the block's 128x8 keys into the tile and zeroes the count tile.
// kVolatile keeps the copy when nothing reads it (the empty variant).
template <bool kVolatile>
__device__ __forceinline__ void stage_block(BlockTile& tile,
                                            const uint32_t* __restrict__ key_lo,
                                            const uint32_t* __restrict__ key_hi,
                                            int64_t slot0, int n_slots) {
  for (int i = threadIdx.x; i < n_slots; i += blockDim.x) {
    if (kVolatile) {
      reinterpret_cast<volatile uint32_t*>(tile.lo)[i] = key_lo[slot0 + i];
      reinterpret_cast<volatile uint32_t*>(tile.hi)[i] = key_hi[slot0 + i];
    } else {
      tile.lo[i] = key_lo[slot0 + i];
      tile.hi[i] = key_hi[slot0 + i];
    }
    tile.cnt[i] = 0;
  }
}

using kmt_chain::probe_rounds;

// The query at sorted position i: its (m_lo, m_hi) pair, or for kNoDma the
// key stored in slot (i mod n_slots) of the staged tile, a stand-in that
// costs no device-memory load and that the compiler cannot fold away.
template <int V>
__device__ __forceinline__ void query_at(const BlockTile& tile,
                                         const unsigned long long* __restrict__ sorted_keys,
                                         int64_t i, int n_slots,
                                         uint32_t& m_lo, uint32_t& m_hi) {
  if (V == kNoDma) {
    const int s = static_cast<int>(i & (n_slots - 1));
    m_lo = tile.lo[s];
    m_hi = tile.hi[s];
  } else {
    const unsigned long long u = sorted_keys[i] ^ kSignBit;
    m_lo = static_cast<uint32_t>(u >> 32);
    m_hi = static_cast<uint32_t>(u);
  }
}

// Adds one query's contribution to the count tile.
template <int V>
__device__ __forceinline__ void count_query(BlockTile& tile, uint32_t m_lo,
                                            uint32_t m_hi, int shift,
                                            int64_t bucket0, int bpb,
                                            int rounds) {
  if (m_lo == kInvalid && m_hi == kInvalid) return;
  // shifting a 32-bit word by 32 is undefined: one bucket holds every query
  const int64_t bucket = shift >= 32 ? 0 : static_cast<int64_t>(m_lo >> shift);
  const int64_t local = bucket - bucket0;
  if (local < 0 || local >= bpb) return;
  for (int p = 0; p < rounds; ++p) {
    const int64_t bucket_p = V == kNoHot ? p : V == kNoMm1 ? local : local + p;
    const int row = static_cast<int>(bucket_p & (bpb - 1)) * kBucketKeys;
    if (V == kNoMm1) {
#pragma unroll
      for (int l = 0; l < kBucketKeys; ++l) atomicAdd(&tile.cnt[row + l], 1u);
      continue;
    }
    const int dst = V == kNoMm2 ? 0 : row;
#pragma unroll
    for (int l = 0; l < kBucketKeys; ++l) {
      if (tile.lo[row + l] == m_lo && tile.hi[row + l] == m_hi) {
        atomicAdd(&tile.cnt[dst + l], 1u);
      }
    }
  }
}

// Adds each nonzero count-tile entry into the global counts.
__device__ __forceinline__ void flush_block(const BlockTile& tile,
                                            unsigned int* __restrict__ counts,
                                            int64_t slot0, int n_slots) {
  for (int i = threadIdx.x; i < n_slots; i += blockDim.x) {
    const unsigned int c = tile.cnt[i];
    if (c) atomicAdd(&counts[slot0 + i], c);
  }
}

// Checks the launch arguments shared by the count kernels and selects the
// tensors' device (this library links its own CUDA runtime, whose current
// device is not PyTorch's).
inline cudaError_t check_and_select(int bpb, int n_blocks, int max_rounds,
                                    int variant, int device) {
  if (bpb < 1 || bpb > kChainBlock || (bpb & (bpb - 1)) || n_blocks < 0 ||
      max_rounds < 1 || variant < kFull || variant > kNoMm1Rolled) {
    return cudaErrorInvalidValue;
  }
  return cudaSetDevice(device);
}

}  // namespace kmt_count

// Internal linkage: each source that launches the kernel has its own copy.
// A top-level unnamed namespace, because nvcc's launch stubs cannot tell an
// unnamed namespace nested in kmt_count from the source's own.
namespace {

using namespace kmt_count;

// One CTA per chain block b: every query in b's window [off[b], off[b+1])
// touches only b's 128x8 keys, so the CTA stages them in shared memory,
// counts into a shared tile and adds the tile into the global counts.
template <int V>
__global__ void __launch_bounds__(kThreads)
block_count_kernel(const uint32_t* __restrict__ key_lo,
                   const uint32_t* __restrict__ key_hi,
                   unsigned int* __restrict__ counts,
                   const unsigned long long* __restrict__ sorted_keys,
                   const int32_t* __restrict__ off,
                   const int32_t* __restrict__ block_probe, int shift, int bpb,
                   int min_rounds, int max_rounds) {
  __shared__ BlockTile tile;
  const int64_t b = blockIdx.x;
  const int64_t start = off[b];
  const int64_t end = off[b + 1];
  if (V == kEmptyNoTb) {
    // the window bounds stay live: offsets never decrease, so this adds
    // nothing, but the compiler cannot know that
    if (start > end && threadIdx.x == 0) atomicAdd(&counts[0], 0u);
    return;
  }
  // uniform over the CTA: no query, no table read
  if (V != kEmpty && start >= end) return;

  const int n_slots = bpb * kBucketKeys;
  // 64-bit slot arithmetic: tables past 2^28 buckets have slots past 2^31
  const int64_t slot0 = b * static_cast<int64_t>(n_slots);
  stage_block<V == kEmpty>(tile, key_lo, key_hi, slot0, n_slots);
  __syncthreads();
  if (V == kEmpty) return;

  const int rounds = probe_rounds(block_probe, b, min_rounds, max_rounds);
  const int64_t bucket0 = b * static_cast<int64_t>(bpb);
  for (int64_t i = start + threadIdx.x; i < end; i += blockDim.x) {
    uint32_t m_lo, m_hi;
    query_at<V>(tile, sorted_keys, i, n_slots, m_lo, m_hi);
    count_query<V>(tile, m_lo, m_hi, shift, bucket0, bpb, rounds);
  }
  __syncthreads();
  flush_block(tile, counts, slot0, n_slots);
}

template <int V>
void launch_block_count(int n_blocks, cudaStream_t stream, const void* key_lo,
                        const void* key_hi, void* counts,
                        const void* sorted_keys, const void* off,
                        const void* block_probe, int shift, int bpb,
                        int min_rounds, int max_rounds) {
  block_count_kernel<V><<<n_blocks, kThreads, 0, stream>>>(
      static_cast<const uint32_t*>(key_lo), static_cast<const uint32_t*>(key_hi),
      static_cast<unsigned int*>(counts),
      static_cast<const unsigned long long*>(sorted_keys),
      static_cast<const int32_t*>(off), static_cast<const int32_t*>(block_probe),
      shift, bpb, min_rounds, max_rounds);
}

}  // namespace
