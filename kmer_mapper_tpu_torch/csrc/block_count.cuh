// The constants of a chain block's count, the dissection variants' ids and
// the count kernels' launch checks, shared by stream_count.cu and the two
// dissection kernels, r2_kernel_dissect.cu and r2_window_dissect.cu (their
// body is count_range.cuh's, on count_tile.cuh's tile). Each variant
// removes one part of the count, as the Pallas variants of
// scripts/r2_kernel_dissect.py:_kernel_v do; the plain twin of the variants
// is kmer_mapper_tpu_torch/scripts/r2_kernel_dissect.py:variant_twin.
//
// A query is live when it is not the all-ones pair and its bucket lies in
// the CTA's chain block; it walks rounds p < rounds, where rounds =
// max(min_rounds, min(block_probe[b], max_rounds)). stream_count passes
// (0, bpb): a chain never leaves its block, so more than bpb rounds would
// only revisit buckets. The dissection kernels pass (1, max_probe), as the
// Pallas kernels always run round 0 and stop at the table's chain bound.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#include "chain.cuh"

namespace kmt_count {

constexpr int kBucketKeys = 8;
constexpr int kChainBlock = 128;
constexpr int kTileSlots = kChainBlock * kBucketKeys;
constexpr uint32_t kInvalid = 0xFFFFFFFFu;
constexpr unsigned long long kSignBit = 0x8000000000000000ull;

// the variant ids of kmer_mapper_tpu_torch/scripts/r2_kernel_dissect.py
enum Variant : int {
  kFull = 0,        // the count itself
  kNoMm2 = 1,       // hits are not scattered: lane k's hits all go to bucket 0
  kNoMm1 = 2,       // no compare: each round adds 1 to all 8 slots of the
                    // query's own bucket (r2_kernel_dissect's nomm1)
  kNoHot = 3,       // no bucket addressing: round p compares with bucket p
  kNoDma = 4,       // no query loads: position i stands in the key of slot i
  kEmpty = 5,       // no query loop; the key tile is still staged
  kEmptyNoTb = 6,   // no query loop and no staging
  kNoMm1Rolled = 7  // no compare: round p adds 1 to all 8 slots of bucket
                    // local + p (r2_window_dissect's nomm1)
};

// Checks the launch arguments shared by the count kernels and selects the
// tensors' device (this library links its own CUDA runtime, whose current
// device is not PyTorch's).
inline cudaError_t check_and_select(int bpb, int n_blocks, int max_rounds,
                                    int variant, int device) {
  if (bpb < 1 || bpb > kChainBlock || (bpb & (bpb - 1)) || n_blocks < 0 ||
      max_rounds < 1 || variant < kFull || variant > kNoMm1Rolled) {
    return cudaErrorInvalidValue;
  }
  return cudaSetDevice(device);
}

}  // namespace kmt_count
