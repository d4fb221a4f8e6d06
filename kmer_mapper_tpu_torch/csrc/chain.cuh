// The chain walk's round bound, shared by the stream count
// (stream_count.cu, count_range.cuh) and the gather probe (gather_probe.cu).
//
// A table's chains wrap inside 128-bucket chain blocks, and
// layout.block_max_probe gives each block 1 + the largest distance of one
// of its stored keys from that key's home bucket (1: no chain). A query
// homed in block b therefore finds its key, if the table holds it, within
// block_probe[b] rounds; walking more only revisits buckets or misses.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace kmt_chain {

// Rounds a query of chain block b walks: the block's bound capped at
// max_rounds, and at least min_rounds.
__device__ __forceinline__ int probe_rounds(const int32_t* block_probe,
                                            int64_t b, int min_rounds,
                                            int max_rounds) {
  return max(min_rounds, min(static_cast<int>(block_probe[b]), max_rounds));
}

}  // namespace kmt_chain
