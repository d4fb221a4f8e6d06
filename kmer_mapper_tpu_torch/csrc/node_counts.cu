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
// mapper uploads on its first finalize and keeps (KmerIndex.device_entries),
// sorted by slot; out is zeroed by the caller. Any entry order gives the
// same sums; slot order is what makes the gathers cheap.
//
// What bounds it: the bytes, and then the atomics. Each entry's slot and
// frequency are read once (streamed, evict-first) and its slot's count
// gathered; only an entry whose weight is not zero reads its node. In the
// entry order of the index (random in slot) each gather was a 32-byte
// sector of its own and the kernel ran at 28% of its bound; with the
// entries in slot order a warp's 32 gathers fall in a few neighbouring
// sectors and the counts array is read about once, front to back, which
// leaves the atomics to random nodes as the largest cost. Equal nodes of a
// warp are combined before the atomic only where they occur: a majority
// vote over the lanes (ten shuffles) finds the warp's most common node, and
// only a warp where it repeats pays for __match_any_sync (groups the lanes
// by node), __reduce_add_sync (each group's wrapping sum) and one atomic a
// group from its lowest lane. A variant node of a KAGE index, or every
// entry of the hazard case one_node, then takes one atomic a warp instead
// of 32 serialised ones, while a warp of distinct nodes (nearly all of
// them on a real index, where a node's k-mers lie in far-apart slots)
// skips the match, whose cost would be most of the kernel's. One thread an
// entry, no shared memory.
//
// Bound with ctypes; see kmer_mapper_tpu_torch/native.py.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr unsigned int kFullMask = 0xFFFFFFFFu;

__global__ void __launch_bounds__(kThreads)
node_counts_kernel(const unsigned int* __restrict__ counts, const int* __restrict__ slot,
                   const int* __restrict__ node, const int* __restrict__ freq,
                   int max_frequency, unsigned int* __restrict__ out, int64_t n) {
  // every lane of the warp reaches the votes below: a lane past the end, a
  // filtered entry and a zero weight all take node -1 and add nothing
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  int target = -1;
  unsigned int w = 0u;
  if (i < n) {
    const int s = __ldcs(slot + i);
    if (__ldcs(freq + i) <= max_frequency) {
      w = __ldg(counts + s);
      if (w != 0u) target = __ldcs(node + i);
    }
  }
  // the warp's majority node (Boyer-Moore, merged over a butterfly; a tie
  // goes to the smaller node, so every lane ends with the same one)
  int major = target, votes = target >= 0;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const int other = __shfl_xor_sync(kFullMask, major, o);
    const int other_votes = __shfl_xor_sync(kFullMask, votes, o);
    if (other == major) {
      votes += other_votes;
    } else if (other_votes > votes ||
               (other_votes == votes && static_cast<unsigned int>(other) <
                                            static_cast<unsigned int>(major))) {
      major = other;
      votes = other_votes - votes;
    } else {
      votes -= other_votes;
    }
  }
  const unsigned int repeated = __ballot_sync(kFullMask, target >= 0 && target == major);
  if (__popc(repeated) < 2) {  // the lanes' nodes (almost surely) differ
    if (target >= 0) atomicAdd(out + target, w);
    return;
  }
  // a node repeats: every group of equal nodes adds its wrapping sum once
  const unsigned int peers = __match_any_sync(kFullMask, target);
  const unsigned int sum = __reduce_add_sync(peers, w);
  const int lane = threadIdx.x & 31;
  if (target >= 0 && lane == __ffs(peers) - 1) atomicAdd(out + target, sum);
}

}  // namespace

// out[node[e]] += counts[slot[e]] for each of the n entries with
// freq[e] <= max_frequency; returns cudaGetLastError() after the launch (0
// on success). Device pointers: counts uint32[>= max slot + 1], slot, node
// and freq int32[n] (any order; slot order is the fast one), out
// uint32[>= max node + 1], zeroed by the caller, all on CUDA device
// `device`. Launches on `stream` (a stream of that device) and does not
// synchronise.
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
