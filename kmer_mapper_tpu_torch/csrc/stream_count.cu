// Stream-count kernel for NVIDIA Hopper (sm_90a).
//
// Replaces kmer_mapper_tpu/ops/stream_probe.py:_kernel, the Pallas kernel
// that stream_count launches there. It computes what that kernel computes,
// not how: counts[slot] += the number of valid sorted queries whose mixed
// (m_lo, m_hi) pair equals the key stored in that slot. A query of chain
// block b looks in bucket b*bpb + ((local_b + p) & (bpb-1)) for rounds
// p < block_probe[b] and compares all 8 lanes; the all-ones invalid pair is
// skipped. The TPU kernel's plane layout, bf16 one-hot matmuls, schedule
// and multi-stream tiles have no counterpart here.
//
// What bounds it: each query streams its 8-byte sort key once (coalesced,
// the keys are sorted), then reads up to 16 table words per probe round at
// a random bucket and adds one per hit. Served from device memory those
// would be random 32-byte reads and global atomics on a table of tens of
// MB. Because the queries are sorted, every query in block b's window
// [off[b], off[b+1]) touches only block b's 128x8 keys. So one CTA serves
// one chain block: it copies the block's keys (8 KB) into shared memory,
// keeps a 128x8 count tile (4 KB) there, sends the random reads and the
// hit atomics to shared memory, and at the end adds each nonzero tile
// entry into the global counts with one atomicAdd. The global atomics keep
// the result right if a later version splits a long window over CTAs.
//
// Bound with ctypes; see kmer_mapper_tpu_torch/native.py.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kBucketKeys = 8;
constexpr int kChainBlock = 128;
constexpr int kThreads = 256;
constexpr uint32_t kInvalid = 0xFFFFFFFFu;
constexpr unsigned long long kSignBit = 0x8000000000000000ull;

__global__ void __launch_bounds__(kThreads)
stream_count_kernel(const uint32_t* __restrict__ key_lo,
                    const uint32_t* __restrict__ key_hi,
                    unsigned int* __restrict__ counts,
                    const unsigned long long* __restrict__ sorted_keys,
                    const int32_t* __restrict__ off,
                    const int32_t* __restrict__ block_probe,
                    int shift, int bpb) {
  __shared__ uint32_t s_lo[kChainBlock * kBucketKeys];
  __shared__ uint32_t s_hi[kChainBlock * kBucketKeys];
  __shared__ unsigned int s_cnt[kChainBlock * kBucketKeys];

  const int64_t b = blockIdx.x;
  const int64_t start = off[b];
  const int64_t end = off[b + 1];
  if (start >= end) return;  // uniform over the CTA: no query, no table read

  const int n_slots = bpb * kBucketKeys;
  // 64-bit slot arithmetic: tables past 2^28 buckets have slots past 2^31
  const int64_t slot0 = b * static_cast<int64_t>(n_slots);
  for (int i = threadIdx.x; i < n_slots; i += blockDim.x) {
    s_lo[i] = key_lo[slot0 + i];
    s_hi[i] = key_hi[slot0 + i];
    s_cnt[i] = 0;
  }
  __syncthreads();

  // a chain never leaves its block, so more than bpb rounds would only
  // revisit buckets
  const int rounds = min(static_cast<int>(block_probe[b]), bpb);
  const int64_t bucket0 = b * static_cast<int64_t>(bpb);
  for (int64_t i = start + threadIdx.x; i < end; i += blockDim.x) {
    const unsigned long long u = sorted_keys[i] ^ kSignBit;
    const uint32_t m_lo = static_cast<uint32_t>(u >> 32);
    const uint32_t m_hi = static_cast<uint32_t>(u);
    if (m_lo == kInvalid && m_hi == kInvalid) continue;
    // shifting a 32-bit word by 32 is undefined: a 1-bucket table has
    // every query in bucket 0
    const int64_t bucket = shift >= 32 ? 0 : static_cast<int64_t>(m_lo >> shift);
    const int64_t local = bucket - bucket0;
    if (local < 0 || local >= bpb) continue;
    for (int p = 0; p < rounds; ++p) {
      const int row = static_cast<int>((local + p) & (bpb - 1)) * kBucketKeys;
#pragma unroll
      for (int l = 0; l < kBucketKeys; ++l) {
        if (s_lo[row + l] == m_lo && s_hi[row + l] == m_hi) {
          atomicAdd(&s_cnt[row + l], 1u);
        }
      }
    }
  }
  __syncthreads();

  for (int i = threadIdx.x; i < n_slots; i += blockDim.x) {
    const unsigned int c = s_cnt[i];
    if (c) atomicAdd(&counts[slot0 + i], c);
  }
}

}  // namespace

// counts += hits of the sorted queries; returns cudaGetLastError() after
// the launch (0 on success). All pointers are device pointers: key_lo and
// key_hi uint32[n_blocks*bpb*8], counts uint32[n_blocks*bpb*8],
// sorted_keys int64[off[n_blocks]], off int32[n_blocks+1], block_probe
// int32[n_blocks], all on CUDA device `device`. Launches on `stream` (a
// stream of that device) and does not synchronise.
extern "C" int stream_count_launch(const void* key_lo, const void* key_hi,
                                   void* counts, const void* sorted_keys,
                                   const void* off, const void* block_probe,
                                   int n_blocks, int shift, int bpb,
                                   int device, void* stream) {
  if (bpb < 1 || bpb > kChainBlock || (bpb & (bpb - 1)) || n_blocks < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // this library links its own CUDA runtime, whose current device is not
  // PyTorch's: select the tensors' device here
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  if (n_blocks > 0) {
    stream_count_kernel<<<n_blocks, kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint32_t*>(key_lo),
        static_cast<const uint32_t*>(key_hi),
        static_cast<unsigned int*>(counts),
        static_cast<const unsigned long long*>(sorted_keys),
        static_cast<const int32_t*>(off),
        static_cast<const int32_t*>(block_probe), shift, bpb);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* kmt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
