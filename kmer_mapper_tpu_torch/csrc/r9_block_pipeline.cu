// The grid step with its block movement (sm_90a).
//
// Replaces scripts/r9_block_pipeline.py:make_kernel(variant).kernel, the
// Pallas kernel that adds to r9_step_parts' step the movement of a block per
// grid step: step c reads groups 16c .. 16c+15 of the key and count arrays
// (8192 groups, 33.5 MB each) and writes its count block back, so the
// result is counts_in plus every step's tiles on its own block. Here
// r9_steps_kernel<kOwnBlocks> (r9_tile.cuh) runs the steps on persistent
// CTAs; a step stages its 64 KB count block and 128 KB of key words into
// shared memory, runs its tiles and writes the count block out.
//
//   variant   layout
//   new       keys and counts (8192, 8, 128): the 3-D plane layout
//   old       keys and counts (1048576, 8): the 2-D layout, bucket-major
//
// What bounds it: at these sizes the tile body's shared reads (as in
// r9_step_parts), plus 134 MB of block movement that one CTA per SM does
// between its steps, not beside them.
//
// Bound with ctypes; see kmer_mapper_tpu_torch/native.py.

#include "r9_tile.cuh"

using namespace kmt_r9;

// counts_out = counts_in + every step's counts on its block. key_lo,
// key_hi, counts_in and counts_out are uint32 arrays of n_steps x 16 x 8 x
// 128 slots in the variant's layout, q uint32 (2, lanes), sink unused, all
// on CUDA device `device`. variant 0 new, 1 old. Returns the launch's error
// code (0 on success) and does not synchronise.
extern "C" int r9_block_pipeline_launch(const void* key_lo, const void* key_hi,
                                        const void* counts_in, const void* q,
                                        void* counts_out, void* sink, int n_steps,
                                        int n_tiles, int lanes, int n_ctas, int variant,
                                        int device, void* stream) {
  const cudaError_t set = check_steps(n_steps, n_tiles, lanes, n_ctas, device);
  if (set != cudaSuccess) return static_cast<int>(set);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t rc;
  switch (variant) {
    case 0:
      rc = launch_steps<kOwnBlocks>(n_ctas, s, key_lo, key_hi, counts_in, q, counts_out,
                                    sink, n_steps, n_tiles, lanes);
      break;
    case 1:
      rc = launch_steps<kOwnBlocks | kBucketMajor>(n_ctas, s, key_lo, key_hi, counts_in, q,
                                                   counts_out, sink, n_steps, n_tiles, lanes);
      break;
    default: rc = cudaErrorInvalidValue; break;
  }
  return static_cast<int>(rc);
}
