// Stream-count kernel for NVIDIA Hopper (sm_90a).
//
// Replaces kmer_mapper_tpu/ops/stream_probe.py:_kernel, the Pallas kernel
// that stream_count launches there. It computes what that kernel computes,
// not how: counts[slot] += the number of valid queries whose mixed
// (m_lo, m_hi) pair equals the key stored in that slot. The queries come
// grouped by 128-bucket chain block (block_partition.cu): block b's are the
// window [off[b], off[b+1]), in any order inside it. A query of chain
// block b looks in bucket b*bpb + ((local_b + p) & (bpb-1)) for rounds
// p < block_probe[b] and compares all 8 lanes; the all-ones invalid pair is
// skipped. The TPU kernel's plane layout, bf16 one-hot matmuls, schedule
// and multi-stream tiles have no counterpart here.
//
// What bounds it: each query streams its 8-byte sort key once (coalesced,
// a window is contiguous), then reads up to 16 table words per probe round at
// a random bucket and adds one per hit. Served from device memory those
// would be random 32-byte reads and global atomics on a table of tens of
// MB. Because the queries are grouped, every query in block b's window
// [off[b], off[b+1]) touches only block b's 128x8 keys. So one CTA serves
// one chain block: it copies the block's keys (8 KB) into shared memory,
// keeps a 128x8 count tile (4 KB) there, sends the random reads and the
// hit atomics to shared memory, and at the end adds each nonzero tile
// entry into the global counts with one atomicAdd. The global atomics keep
// the result right if a later version splits a long window over CTAs.
//
// The kernel is block_count_kernel<kFull> of block_count.cuh, which the
// dissection kernels (r2_kernel_dissect.cu, r2_window_dissect.cu) take
// apart, so their times split this kernel's time.
//
// Bound with ctypes; see kmer_mapper_tpu_torch/native.py.

#include "block_count.cuh"

using namespace kmt_count;

// counts += hits of the grouped queries; returns cudaGetLastError() after
// the launch (0 on success). All pointers are device pointers: key_lo and
// key_hi uint32[n_blocks*bpb*8], counts uint32[n_blocks*bpb*8],
// sorted_keys int64[off[n_blocks]] (the keys grouped by block; sorted
// keys are grouped too), off int32[n_blocks+1], block_probe
// int32[n_blocks], all on CUDA device `device`. Launches on `stream` (a
// stream of that device) and does not synchronise.
extern "C" int stream_count_launch(const void* key_lo, const void* key_hi,
                                   void* counts, const void* sorted_keys,
                                   const void* off, const void* block_probe,
                                   int n_blocks, int shift, int bpb,
                                   int device, void* stream) {
  const cudaError_t set = check_and_select(bpb, n_blocks, bpb, kFull, device);
  if (set != cudaSuccess) return static_cast<int>(set);
  if (n_blocks > 0) {
    launch_block_count<kFull>(n_blocks, static_cast<cudaStream_t>(stream), key_lo,
                              key_hi, counts, sorted_keys, off, block_probe, shift,
                              bpb, 0, bpb);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* kmt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
