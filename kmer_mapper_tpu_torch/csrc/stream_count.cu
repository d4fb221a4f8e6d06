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
// An index shard (parallel/sharded.py) holds the table's buckets
// [bucket_base, bucket_base + n_blocks*bpb): a query's bucket is the global
// m_lo >> shift (shift of the whole table), its chain block that bucket's
// global block less bucket_base / bpb, and off and block_probe are the
// shard's slices; queries homed in other shards lie in no window. One table
// is the shard with bucket_base 0.
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
// buckets of the tile; the kernel counts into count_tile.cuh's tile (rows
// padded to 9 words, a fingerprint word a bucket), and each thread loads
// kItems keys of its window (evict-first, issued together) before it counts
// them.
//
// The dissection kernel r2_kernel_dissect.cu takes this design apart: its
// variants remove one part each of the same per-block count on the same
// tile (count_range.cuh), and its `full` equals this kernel's counts.
//
// Bound with ctypes; see kmer_mapper_tpu_torch/native.py.

#include "count_tile.cuh"

namespace {

using namespace kmt_count;

using kmt_tile::PaddedTile;

constexpr int kCountThreads = 256;
constexpr int kItems = 4;  // keys a thread loads before it counts them

// One CTA per chain block b: every query in b's window [off[b], off[b+1])
// touches only b's keys, counted on the padded tile through the
// fingerprints.
__global__ void __launch_bounds__(kCountThreads)
stream_count_kernel(const uint32_t* __restrict__ key_lo, const uint32_t* __restrict__ key_hi,
                    unsigned int* __restrict__ counts,
                    const unsigned long long* __restrict__ keys,
                    const int32_t* __restrict__ off, const int32_t* __restrict__ block_probe,
                    int shift, int bpb, int64_t bucket_base) {
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
    kmt_tile::store_slot(tile, i, key_lo[slot0 + i], key_hi[slot0 + i]);
  }
  __syncthreads();
  for (int r = threadIdx.x; r < bpb; r += kCountThreads) kmt_tile::seal_row(tile, r);
  __syncthreads();

  const int rounds = kmt_chain::probe_rounds(block_probe, b, 0, bpb);
  // the block's first bucket in the whole table, which the queries' buckets
  // are counted in
  const int64_t bucket0 = bucket_base + b * static_cast<int64_t>(bpb);
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
      kmt_tile::count_query(tile, static_cast<uint32_t>(u >> 32), static_cast<uint32_t>(u),
                            shift, bucket0, bpb, rounds);
    }
  }
  __syncthreads();
  kmt_tile::flush_tile(tile, counts, slot0, n_slots, kCountThreads);
}

}  // namespace

// counts += hits of the grouped queries; returns cudaGetLastError() after
// the launch (0 on success). All pointers are device pointers: key_lo and
// key_hi uint32[n_blocks*bpb*8], counts uint32[n_blocks*bpb*8] (the shard's
// buckets from bucket_base, a multiple of bpb), keys int64[off[n_blocks]]
// (the keys grouped by block, in any order inside a window; sorted keys are
// grouped too), off int32[n_blocks+1], block_probe int32[n_blocks], all on
// CUDA device `device`. Launches on `stream` (a stream of that device) and
// does not synchronise.
extern "C" int stream_count_launch(const void* key_lo, const void* key_hi,
                                   void* counts, const void* keys,
                                   const void* off, const void* block_probe,
                                   int n_blocks, int shift, int bpb, int bucket_base,
                                   int device, void* stream) {
  const cudaError_t set = check_and_select(bpb, n_blocks, bpb, kFull, device);
  if (set != cudaSuccess) return static_cast<int>(set);
  if (bucket_base < 0 || bucket_base % bpb) return static_cast<int>(cudaErrorInvalidValue);
  if (n_blocks == 0) return static_cast<int>(cudaGetLastError());
  stream_count_kernel<<<n_blocks, kCountThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(key_lo), static_cast<const uint32_t*>(key_hi),
      static_cast<unsigned int*>(counts), static_cast<const unsigned long long*>(keys),
      static_cast<const int32_t*>(off), static_cast<const int32_t*>(block_probe), shift, bpb,
      bucket_base);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* kmt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
