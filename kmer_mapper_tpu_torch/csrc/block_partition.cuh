// Device code shared by the block partition (block_partition.cu) and its
// dissection kernels (partition_dissect.cu): a key's bin, a warp's tile of
// keys and the launch checks.
//
// bin(k) = the chain block (k ^ 2**63) >> (64 - log2 n_blocks), the top bits
// of m_lo (0 for a table of one block, where a shift by 64 would be
// undefined), or n_blocks for the all-ones invalid key, which lands in no
// window.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace kmt_partition {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kItems = 4;  // keys a lane loads before it bins them
constexpr int kWarpTile = 32 * kItems;
constexpr long long kInvalidKey = 0x7FFFFFFFFFFFFFFFll;  // the all-ones pair's key
constexpr unsigned long long kSignBit = 0x8000000000000000ull;
constexpr unsigned int kFullMask = 0xFFFFFFFFu;

// The bin of a key: its chain block, or n_blocks for the invalid key.
__device__ __forceinline__ int key_bin(long long key, int log2_blocks) {
  if (key == kInvalidKey) return 1 << log2_blocks;
  // a 64-bit shift by 64 is undefined: one block holds every key
  if (log2_blocks == 0) return 0;
  return static_cast<int>((static_cast<unsigned long long>(key) ^ kSignBit) >>
                          (64 - log2_blocks));
}

// The warp's tile at `base`: lane l holds keys base + 32j + l, j < kItems,
// and their bins (-1 past the end, a group that does nothing).
__device__ __forceinline__ void load_tile(const long long* __restrict__ keys, long long n,
                                          long long base, int lane, int log2_blocks,
                                          long long (&key)[kItems], int (&bin)[kItems]) {
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    const long long i = base + 32 * j + lane;
    key[j] = i < n ? keys[i] : 0;
  }
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    bin[j] = base + 32 * j + lane < n ? key_bin(key[j], log2_blocks) : -1;
  }
}

inline bool valid_args(long long n, int log2_blocks) {
  return n >= 0 && n < (1LL << 31) && log2_blocks >= 0 && log2_blocks <= 30;
}

}  // namespace kmt_partition
