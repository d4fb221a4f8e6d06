// The parts of a grid step's overhead (sm_90a).
//
// Replaces scripts/r9_step_parts.py:make_kernel(variant).kernel, the Pallas
// kernel of GRID steps of TILES tiles each over one block of 16 key groups
// and their counts, with per-step key preparation and a counts
// read-modify-write per tile. Its keys and counts have a constant block
// index and counts_out is set to counts_in at every step, so the result is
// counts_in plus the LAST step's tiles; the earlier steps' work is done and
// dropped. Here r9_steps_kernel (r9_tile.cuh) runs the steps on persistent
// CTAs, each step on its own staged copy of the block, and the earlier
// steps' counts go into a fold in a sink buffer.
//
//   variant    flags
//   newfull    the 3-D plane layout: keys and counts (16, 8, 128)
//   tbstatic   tiles read key group 0
//   rmwstatic  tiles add into count group 0
//   noprep     a CTA stages the keys on its first step only (the Pallas
//              variant writes them at grid step 0 only)
//   oldfull    the 2-D layout: keys and counts (2048, 8), bucket-major
//
// The TPU stages the keys as bf16 byte planes, which for 16 groups would
// take 256 KB of shared memory, more than a CTA's 227 KB. The port stages
// them as packed (lo, hi) words, 128 KB, beside the 64 KB of counts (the
// keys are words, so a compare of the two words is the compare of the 8
// planes): 192 KB of dynamic shared memory, one CTA per SM.
//
// Bound with ctypes; see kmer_mapper_tpu_torch/native.py.

#include "r9_tile.cuh"

using namespace kmt_r9;

// counts_out = counts_in + the last step's counts. key_lo, key_hi,
// counts_in and counts_out are uint32 blocks of 16 x 8 x 128 slots in the
// variant's layout, q uint32 (2, lanes), sink uint32[n_ctas * 1024], all on
// CUDA device `device`. variant 0..4 as above. Returns the launch's error
// code (0 on success) and does not synchronise.
extern "C" int r9_step_parts_launch(const void* key_lo, const void* key_hi,
                                    const void* counts_in, const void* q, void* counts_out,
                                    void* sink, int n_steps, int n_tiles, int lanes,
                                    int n_ctas, int variant, int device, void* stream) {
  const cudaError_t set = check_steps(n_steps, n_tiles, lanes, n_ctas, device);
  if (set != cudaSuccess) return static_cast<int>(set);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto args = [&](auto launch) {
    return launch(n_ctas, s, key_lo, key_hi, counts_in, q, counts_out, sink, n_steps,
                  n_tiles, lanes);
  };
  cudaError_t rc;
  switch (variant) {
    case 0: rc = args(launch_steps<0>); break;
    case 1: rc = args(launch_steps<kTbStatic>); break;
    case 2: rc = args(launch_steps<kRmwStatic>); break;
    case 3: rc = args(launch_steps<kPrepOnce>); break;
    case 4: rc = args(launch_steps<kBucketMajor>); break;
    default: rc = cudaErrorInvalidValue; break;
  }
  return static_cast<int>(rc);
}
