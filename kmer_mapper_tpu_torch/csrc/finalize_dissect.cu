// The node-count finalize's other designs, for measurement only: the
// alternatives that csrc/node_counts.cu was chosen against, each computing
// what it computes (out[node] = the wrapping sum of counts[slot] over the
// node's entries with freq <= max_frequency). The main path never launches
// them; kmer_mapper_tpu_torch/scripts/finalize_dissect.py times them beside
// node_counts_kernel on the same entries. Variants:
//  0 plain     a thread an entry, one atomic each, no combining (the first
//              design, run on whatever entry order it is given), into an
//              output zeroed by the caller;
//  1 csr       entries sorted by node with their offsets off[n_nodes + 1]:
//              a thread a node sums its entries and stores the sum, with no
//              atomic and no zeroed output; a node with many entries is one
//              thread's serial loop.
//
// Bound with ctypes; see kmer_mapper_tpu_torch/native.py.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
enum Variant { kPlain = 0, kCsr = 1 };

__global__ void __launch_bounds__(kThreads)
finalize_plain_kernel(const unsigned int* __restrict__ counts, const int* __restrict__ slot,
                      const int* __restrict__ node, const int* __restrict__ freq,
                      int max_frequency, unsigned int* __restrict__ out, int64_t n) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= n || __ldcs(freq + i) > max_frequency) return;
  const unsigned int w = __ldg(counts + __ldcs(slot + i));
  if (w != 0u) atomicAdd(out + __ldcs(node + i), w);
}

__global__ void __launch_bounds__(kThreads)
finalize_csr_kernel(const unsigned int* __restrict__ counts, const int* __restrict__ slot,
                    const int* __restrict__ freq, const int* __restrict__ off,
                    int max_frequency, unsigned int* __restrict__ out, int n_nodes) {
  const int v = blockIdx.x * kThreads + threadIdx.x;
  if (v >= n_nodes) return;
  unsigned int sum = 0u;
  const int end = off[v + 1];
  for (int e = off[v]; e < end; ++e) {
    if (freq[e] <= max_frequency) sum += __ldg(counts + slot[e]);
  }
  out[v] = sum;
}

}  // namespace

// One launch of variant `variant` (0-1 above) over n entries (slot, node,
// freq int32[n], in the order the variant needs: 1 by node) of the int32
// slot counts; off int32[n_nodes + 1] for 1 (else unused, may be null);
// out uint32[n_nodes], zeroed by the caller for 0. Returns the first CUDA
// error (0 on success). Device pointers on CUDA device `device`; launches
// on `stream` and does not synchronise.
extern "C" int finalize_dissect_launch(int variant, const void* counts, const void* slot,
                                       const void* node, const void* freq, const void* off,
                                       long long n, int max_frequency, void* out, int n_nodes,
                                       int device, void* stream) {
  if (n < 0 || n_nodes < 1 || variant < kPlain || variant > kCsr ||
      (variant == kCsr && off == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* c = static_cast<const unsigned int*>(counts);
  const auto* sl = static_cast<const int*>(slot);
  const auto* nd = static_cast<const int*>(node);
  const auto* f = static_cast<const int*>(freq);
  auto* o = static_cast<unsigned int*>(out);
  const unsigned int grid = static_cast<unsigned int>((n + kThreads - 1) / kThreads);
  if (variant == kCsr) {
    finalize_csr_kernel<<<(n_nodes + kThreads - 1) / kThreads, kThreads, 0, s>>>(
        c, sl, f, static_cast<const int*>(off), max_frequency, o, n_nodes);
  } else if (n > 0) {
    finalize_plain_kernel<<<grid, kThreads, 0, s>>>(c, sl, nd, f, max_frequency, o, n);
  }
  return static_cast<int>(cudaGetLastError());
}
