// Dissection of the stream count, one CTA per chain block (sm_90a).
//
// Replaces scripts/r2_kernel_dissect.py:_kernel_v, the Pallas kernel that
// runs the TPU stream count with parts removed. Here the parts are those of
// stream_count.cu's own kernel, block_count_kernel of block_count.cuh:
// staging the block's keys, the per-query bucket addressing, the 8-lane
// compare, the shared atomics and the query loads (see block_count.cuh for
// what each variant computes). The full variant is the kernel that
// stream_count launches.
//
// What bounds it: as stream_count.cu, the 8-byte sort key of each query,
// read once and coalesced, plus 8 KB of keys per chain block; the compare
// and the atomics go to shared memory. The TPU grid's coarsening (8 chain
// blocks per program) has no counterpart: one CTA serves one block, and the
// wrapper refuses tables whose block count is not a multiple of 8, which
// the TPU grid (n_blocks // coarse) would silently cut.
//
// Bound with ctypes; see kmer_mapper_tpu_torch/native.py.

#include "block_count.cuh"

using namespace kmt_count;

// counts += the variant's contribution of the sorted queries; returns
// cudaGetLastError() after the launch (0 on success). Pointers as in
// stream_count_launch (stream_count.cu); max_probe is the table's chain
// bound and variant a kmt_count::Variant. Launches n_blocks CTAs on
// `stream` and does not synchronise.
extern "C" int r2_kernel_dissect_launch(const void* key_lo, const void* key_hi,
                                        void* counts, const void* sorted_keys,
                                        const void* off, const void* block_probe,
                                        int n_blocks, int shift, int bpb,
                                        int max_probe, int variant, int device,
                                        void* stream) {
  if (variant == kNoMm1Rolled) return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t set = check_and_select(bpb, n_blocks, max_probe, variant, device);
  if (set != cudaSuccess) return static_cast<int>(set);
  if (n_blocks == 0) return static_cast<int>(cudaGetLastError());
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define KMT_LAUNCH(V)                                                     \
  launch_block_count<V>(n_blocks, s, key_lo, key_hi, counts, sorted_keys, \
                        off, block_probe, shift, bpb, 1, max_probe)
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
