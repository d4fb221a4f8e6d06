// Dissection of the stream count, one CTA per chain block (sm_90a).
//
// Replaces scripts/r2_kernel_dissect.py:_kernel_v, the Pallas kernel that
// runs the TPU stream count with parts removed. Here the parts are those of
// the main path's count design, stream_count.cu's: one CTA per chain block
// on count_tile.cuh's padded, fingerprinted tile. Each variant removes one
// of staging the block's keys, the per-query bucket addressing, the
// fingerprinted compare, the shared atomics and the query loads
// (count_range.cuh says what each variant's round does; block_count.cuh
// names them). The CTA runs count_range.cuh's body, r2_window_dissect.cu's
// too, with the range its block's whole window: the keys staged with
// 16-byte cp.async copies while the first queries load, the tile built
// from them, the window counted into it. full equals stream_count.
//
// What bounds it: as stream_count.cu, the 8-byte sort key of each query,
// read once and coalesced, plus 8 KB of keys per chain block; the compare
// and the atomics go to shared memory. The TPU grid's coarsening (8 chain
// blocks per program) has no counterpart: one CTA serves one block, and the
// wrapper refuses tables whose block count is not a multiple of 8, which
// the TPU grid (n_blocks // coarse) would silently cut.
//
// Bound with ctypes; see kmer_mapper_tpu_torch/native.py.

#include "count_range.cuh"

namespace {

using namespace kmt_range;

// One CTA per chain block g: every query in g's window [off[g], off[g+1])
// touches only g's keys. At most 32 registers: 8 CTAs an SM, as
// stream_count_kernel, to hide the latency of the key stream.
template <int V>
__global__ void __launch_bounds__(kCountThreads, 8)
r2_kernel_dissect_kernel(const uint32_t* __restrict__ key_lo,
                         const uint32_t* __restrict__ key_hi,
                         unsigned int* __restrict__ counts,
                         const unsigned long long* __restrict__ sorted_keys,
                         const int32_t* __restrict__ off,
                         const int32_t* __restrict__ block_probe, int shift, int bpb,
                         int max_probe) {
  __shared__ RangeSmem sm;
  const int64_t g = blockIdx.x;
  const int64_t start = off[g];
  const int64_t end = off[g + 1];
  if (V == kEmptyNoTb) {
    // the window bounds stay live: offsets never decrease, so this adds
    // nothing, but the compiler cannot know that
    if (start > end && threadIdx.x == 0) atomicAdd(&counts[0], 0u);
    return;
  }
  // uniform over the CTA: no query, no table read (empty stages every block)
  if (V != kEmpty && start >= end) return;
  count_range<V>(sm, key_lo, key_hi, counts, sorted_keys, block_probe, g, start, end, shift,
                 bpb, max_probe);
}

template <int V>
void launch(int n_blocks, cudaStream_t stream, const void* key_lo, const void* key_hi,
            void* counts, const void* sorted_keys, const void* off, const void* block_probe,
            int shift, int bpb, int max_probe) {
  r2_kernel_dissect_kernel<V><<<n_blocks, kCountThreads, 0, stream>>>(
      static_cast<const uint32_t*>(key_lo), static_cast<const uint32_t*>(key_hi),
      static_cast<unsigned int*>(counts), static_cast<const unsigned long long*>(sorted_keys),
      static_cast<const int32_t*>(off), static_cast<const int32_t*>(block_probe), shift, bpb,
      max_probe);
}

}  // namespace

// counts += the variant's contribution of the sorted queries; returns
// cudaGetLastError() after the launch (0 on success). Pointers as in
// stream_count_launch (stream_count.cu), key_lo and key_hi starting on 16
// bytes; max_probe is the table's chain bound and variant a
// kmt_count::Variant other than kNoMm1Rolled. Launches n_blocks CTAs on
// `stream` and does not synchronise.
extern "C" int r2_kernel_dissect_launch(const void* key_lo, const void* key_hi,
                                        void* counts, const void* sorted_keys,
                                        const void* off, const void* block_probe,
                                        int n_blocks, int shift, int bpb,
                                        int max_probe, int variant, int device,
                                        void* stream) {
  if (variant == kNoMm1Rolled) return static_cast<int>(cudaErrorInvalidValue);
  if (!aligned16(key_lo) || !aligned16(key_hi)) {
    return static_cast<int>(cudaErrorMisalignedAddress);
  }
  const cudaError_t set = check_and_select(bpb, n_blocks, max_probe, variant, device);
  if (set != cudaSuccess) return static_cast<int>(set);
  if (n_blocks == 0) return static_cast<int>(cudaGetLastError());
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define KMT_LAUNCH(V) \
  launch<V>(n_blocks, s, key_lo, key_hi, counts, sorted_keys, off, block_probe, shift, bpb, max_probe)
  switch (variant) {
    case kFull: KMT_LAUNCH(kFull); break;
    case kNoMm2: KMT_LAUNCH(kNoMm2); break;
    case kNoMm1: KMT_LAUNCH(kNoMm1); break;
    case kNoHot: KMT_LAUNCH(kNoHot); break;
    case kNoDma: KMT_LAUNCH(kNoDma); break;
    case kEmpty: KMT_LAUNCH(kEmpty); break;
    default: KMT_LAUNCH(kEmptyNoTb); break;
  }
#undef KMT_LAUNCH
  return static_cast<int>(cudaGetLastError());
}
