// Stream-count kernel for NVIDIA Hopper (sm_90a).
//
// Replaces kmer_mapper_tpu/ops/stream_probe.py:_kernel, the Pallas kernel
// that stream_count launches there. It computes what that kernel computes,
// not how: counts[slot] += the number of valid queries whose mixed
// (m_lo, m_hi) pair equals the key stored in that slot. The queries come
// grouped by 128-bucket chain block (block_partition.cu): block b's are the
// window [off[b], off[b+1]), in any order inside it. A query of chain
// block b looks in bucket b*bpb + ((local_b + p) & (bpb-1)) for rounds
// p < min(block_probe[b], bpb) and compares all 8 lanes; the all-ones
// invalid pair is skipped. The TPU kernel's plane layout, bf16 one-hot
// matmuls, schedule and multi-stream tiles have no counterpart here.
//
// What bounds it: each query streams its 8-byte sort key once (coalesced,
// a window is contiguous), then reads a bucket's 8 lanes per probe round
// and adds one per hit. Because the queries are grouped, every query in
// block b's window touches only block b's 128x8 keys, so one CTA serves one
// chain block: it stages the block's keys (8 KB) in shared memory, keeps a
// count tile there, sends the random reads and the hit atomics to shared
// memory, and at the end adds each nonzero tile entry into the global
// counts with one atomicAdd. Its bytes are the keys, the table and the
// changed counts (0.150 ms on a 64 Mi-base chunk).
//
// The windows are unordered, so the 32 lanes of a warp read 32 random
// buckets of the tile. block_count.cuh's tile stores bucket r's lane
// l at word r*8 + l, which lies in one of 4 banks for each l: up to 8-way
// conflicts on every read. This kernel's design:
//  * rows padded to kRow = 9 words: word r*9 + l is in bank (9r + l) % 32,
//    and 9 is odd, so random buckets spread over all 32 banks (a random
//    warp still meets ~3.5-way conflicts, the most of 32 balls in 32 bins);
//    the staging's consecutive slots land on distinct banks but for the
//    row ends;
//  * a fingerprint word a bucket: lane l's 4 bits at bit 4l,
//    0 for an empty slot (the all-ones pair) and 1 + (15 * m_hi >> 32) for a
//    key, so a query, whose own fingerprint is never 0, reads one word a
//    round, finds the lanes whose 4 bits equal its own with a SWAR test,
//    and reads lo and hi words only for those. A miss reads ~1 word a round
//    where it read 8 lo words (and more on a match of lo);
//  * each thread loads kItems keys of its window (evict-first, issued
//    together) before it counts them.
// block_count_kernel<kFull>, the first design, stays in block_count.cuh; the
// dissection kernel r2_kernel_dissect.cu launches it as variant `full`.
//
// Bound with ctypes; see kmer_mapper_tpu_torch/native.py.

#include "block_count.cuh"

namespace {

using namespace kmt_count;

constexpr int kRow = kBucketKeys + 1;  // a padded tile row, in words
constexpr int kCountThreads = 256;
constexpr int kItems = 4;  // keys a thread loads before it counts them
constexpr uint32_t kNibbles = 0x11111111u;

// The chain block's keys, counts and fingerprints, in shared memory
// (14.3 KB).
struct PaddedTile {
  uint32_t lo[kChainBlock * kRow];
  uint32_t hi[kChainBlock * kRow];
  unsigned int cnt[kChainBlock * kRow];
  uint32_t fp[kChainBlock];
};

// A key's 4-bit fingerprint, 1..15 from the high bits of m_hi; 0 is kept
// for empty slots.
__device__ __forceinline__ uint32_t fingerprint(uint32_t m_hi) {
  return __umulhi(m_hi, 15u) + 1u;
}

// Bit 4l + 3 set where nibble l of x is 0 (no carry crosses a nibble).
__device__ __forceinline__ uint32_t zero_nibbles(uint32_t x) {
  return ~(((x & 0x77777777u) + 0x77777777u) | x) & 0x88888888u;
}

// Adds one to each slot of the query's buckets whose key equals (m_lo,
// m_hi): a round reads the bucket's fingerprint word and the key words of
// the lanes whose fingerprint is the query's only.
__device__ __forceinline__ void count_query(PaddedTile& tile, uint32_t m_lo, uint32_t m_hi,
                                            int shift, int64_t bucket0, int bpb, int rounds) {
  if (m_lo == kInvalid && m_hi == kInvalid) return;
  // shifting a 32-bit word by 32 is undefined: one bucket holds every query
  const int64_t bucket = shift >= 32 ? 0 : static_cast<int64_t>(m_lo >> shift);
  const int64_t local = bucket - bucket0;
  if (local < 0 || local >= bpb) return;
  const uint32_t mine = fingerprint(m_hi) * kNibbles;
  for (int p = 0; p < rounds; ++p) {
    const int r = static_cast<int>((local + p) & (bpb - 1));
    const int row = r * kRow;
    for (uint32_t m = zero_nibbles(tile.fp[r] ^ mine); m; m &= m - 1) {
      const int l = (__ffs(m) - 1) >> 2;
      if (tile.lo[row + l] == m_lo && tile.hi[row + l] == m_hi) {
        atomicAdd(&tile.cnt[row + l], 1u);
      }
    }
  }
}

// One CTA per chain block b, as block_count_kernel<kFull>, on the padded
// tile and through the fingerprints.
__global__ void __launch_bounds__(kCountThreads)
stream_count_kernel(const uint32_t* __restrict__ key_lo, const uint32_t* __restrict__ key_hi,
                    unsigned int* __restrict__ counts,
                    const unsigned long long* __restrict__ keys,
                    const int32_t* __restrict__ off, const int32_t* __restrict__ block_probe,
                    int shift, int bpb) {
  __shared__ PaddedTile tile;
  const int64_t b = blockIdx.x;
  const int64_t start = off[b];
  const int64_t end = off[b + 1];
  // uniform over the CTA: no query, no table read
  if (start >= end) return;

  const int n_slots = bpb * kBucketKeys;
  // 64-bit slot arithmetic: tables past 2^28 buckets have slots past 2^31
  const int64_t slot0 = b * static_cast<int64_t>(n_slots);
  for (int i = threadIdx.x; i < n_slots; i += kCountThreads) {
    const int w = (i >> 3) * kRow + (i & 7);
    tile.lo[w] = key_lo[slot0 + i];
    tile.hi[w] = key_hi[slot0 + i];
    tile.cnt[w] = 0;
  }
  __syncthreads();
  for (int r = threadIdx.x; r < bpb; r += kCountThreads) {
    uint32_t word = 0;
#pragma unroll
    for (int l = 0; l < kBucketKeys; ++l) {
      const uint32_t lo = tile.lo[r * kRow + l], hi = tile.hi[r * kRow + l];
      const uint32_t nibble = lo == kInvalid && hi == kInvalid ? 0u : fingerprint(hi);
      word |= nibble << (4 * l);
    }
    tile.fp[r] = word;
  }
  __syncthreads();

  const int rounds = kmt_chain::probe_rounds(block_probe, b, 0, bpb);
  const int64_t bucket0 = b * static_cast<int64_t>(bpb);
  for (int64_t i0 = start + threadIdx.x; i0 < end; i0 += kCountThreads * kItems) {
    unsigned long long key[kItems];
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      const int64_t i = i0 + j * kCountThreads;
      key[j] = i < end ? __ldcs(&keys[i]) : 0;
    }
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      if (i0 + j * kCountThreads >= end) break;
      const unsigned long long u = key[j] ^ kSignBit;
      count_query(tile, static_cast<uint32_t>(u >> 32), static_cast<uint32_t>(u), shift,
                  bucket0, bpb, rounds);
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < n_slots; i += kCountThreads) {
    const unsigned int c = tile.cnt[(i >> 3) * kRow + (i & 7)];
    if (c) atomicAdd(&counts[slot0 + i], c);
  }
}

}  // namespace

// counts += hits of the grouped queries; returns cudaGetLastError() after
// the launch (0 on success). All pointers are device pointers: key_lo and
// key_hi uint32[n_blocks*bpb*8], counts uint32[n_blocks*bpb*8], keys
// int64[off[n_blocks]] (the keys grouped by block, in any order inside a
// window; sorted keys are grouped too), off int32[n_blocks+1], block_probe
// int32[n_blocks], all on CUDA device `device`. Launches on `stream` (a
// stream of that device) and does not synchronise.
extern "C" int stream_count_launch(const void* key_lo, const void* key_hi,
                                   void* counts, const void* keys,
                                   const void* off, const void* block_probe,
                                   int n_blocks, int shift, int bpb,
                                   int device, void* stream) {
  const cudaError_t set = check_and_select(bpb, n_blocks, bpb, kFull, device);
  if (set != cudaSuccess) return static_cast<int>(set);
  if (n_blocks == 0) return static_cast<int>(cudaGetLastError());
  stream_count_kernel<<<n_blocks, kCountThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(key_lo), static_cast<const uint32_t*>(key_hi),
      static_cast<unsigned int*>(counts), static_cast<const unsigned long long*>(keys),
      static_cast<const int32_t*>(off), static_cast<const int32_t*>(block_probe), shift, bpb);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* kmt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
