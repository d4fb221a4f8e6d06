// Node-count finalize for NVIDIA Hopper (sm_90a): every path's last step on
// the card (KmerMapper.node_counts, the library calls through it, and each
// index shard of ShardedKmerMapper.node_counts).
//
// Replaces kmer_mapper_tpu/parallel/sharded.py:403 make_finalize's finalize,
// XLA code on the TPU (a gather, a where and an `.at[].add`), not a Pallas
// kernel; the single-device JAX path does the same on the host in
// index/kmer_index.py:node_counts. It computes
//   out[node] = sum over entries e with freq[e] <= max_frequency and
//               node[e] == node of counts[slot[e]],
// in unsigned 32-bit arithmetic that wraps as the reference's uint32 adds do.
// Counts are the int32 bits of the wrapping uint32 slot counts in slot
// order; the entries are int32 (slot, node, frequency) arrays that the
// mapper uploads on its first finalize and keeps (KmerIndex.device_entries);
// out is zeroed by the caller.
//
// What bounds it: the bytes. Each entry's slot and frequency are read once
// (streamed, evict-first), its slot's count is gathered from a random
// address (a 32-byte sector), and only an entry whose weight is not zero
// reads its node and issues an atomic add, so an entry whose k-mer was
// never hit (or is filtered) costs neither. One thread an entry, no shared
// memory, no warp aggregation of equal nodes: a node with many weighted
// entries serialises their atomics.
//
// Bound with ctypes; see kmer_mapper_tpu_torch/native.py.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
node_counts_kernel(const unsigned int* __restrict__ counts, const int* __restrict__ slot,
                   const int* __restrict__ node, const int* __restrict__ freq,
                   int max_frequency, unsigned int* __restrict__ out, int64_t n) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= n) return;
  const int s = __ldcs(slot + i);
  if (__ldcs(freq + i) > max_frequency) return;
  const unsigned int w = counts[s];
  if (w == 0u) return;
  atomicAdd(out + __ldcs(node + i), w);
}

}  // namespace

// out[node[e]] += counts[slot[e]] for each of the n entries with
// freq[e] <= max_frequency; returns cudaGetLastError() after the launch (0
// on success). Device pointers: counts uint32[>= max slot + 1], slot, node
// and freq int32[n], out uint32[>= max node + 1], zeroed by the caller, all
// on CUDA device `device`. Launches on `stream` (a stream of that device)
// and does not synchronise.
extern "C" int node_counts_launch(const void* counts, const void* slot, const void* node,
                                  const void* freq, long long n, int max_frequency, void* out,
                                  int device, void* stream) {
  if (n < 0) return static_cast<int>(cudaErrorInvalidValue);
  // this library links its own CUDA runtime, whose current device is not
  // PyTorch's
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  if (n == 0) return static_cast<int>(cudaGetLastError());
  const unsigned int grid = static_cast<unsigned int>((n + kThreads - 1) / kThreads);
  node_counts_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const unsigned int*>(counts), static_cast<const int*>(slot),
      static_cast<const int*>(node), static_cast<const int*>(freq), max_frequency,
      static_cast<unsigned int*>(out), n);
  return static_cast<int>(cudaGetLastError());
}
