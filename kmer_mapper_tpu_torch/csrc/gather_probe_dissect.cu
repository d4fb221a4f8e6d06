// The gather probe's design points, each switchable, for measurement on the
// card: kmer_mapper_tpu_torch/scripts/gather_probe_dissect.py times each
// against the library path's kernel (gather_probe.cu). Every variant
// computes gather_probe.cu's function; an option bit takes the other side
// of one design point, and 0 is the library path's design:
//  * kPlainStreams: queries loaded and slots stored without the evict-first
//    hint (__ldcs, __stcs);
//  * kPlainTable: the lo rows loaded under the normal L2 policy, not
//    evict-last;
//  * kNoAggregate: counts, one add a hit, no warp aggregation;
//  * kFourPerThread: four queries a thread, every first-round row requested
//    before any compare, then the hi words of all candidate lanes together;
//  * kNormalHits: the hi words and count adds under the normal L2 policy,
//    not evict-first.
// The other two design points need no bit: the caller passes no
// block_probe (every query walks max_probe rounds) or an all-true valid
// array.
//
// Bound with ctypes; see kmer_mapper_tpu_torch/native.py.

#include <cstdint>
#include <cuda_runtime.h>

#include "gather_probe.cuh"

namespace {

using namespace kmt_gather;

constexpr int kPerThread = 4;  // with kFourPerThread

enum Option : int {
  kPlainStreams = 1,
  kPlainTable = 2,
  kNoAggregate = 4,
  kFourPerThread = 8,
  kNormalHits = 16,
  kAllOptions = 31,
};

// Thread x of CTA c takes queries c * kThreads * Q + j * kThreads + x for
// j < Q: each of the Q loads and stores is coalesced over the warp.
template <int M, int Q>
__global__ void __launch_bounds__(kThreads)
gather_probe_dissect_kernel(Table t, const long long* __restrict__ queries,
                            const bool* __restrict__ valid,
                            unsigned int* __restrict__ counts,
                            int32_t* __restrict__ out, int64_t n, int options) {
  const bool streaming = !(options & kPlainStreams);
  const Policies policy = {l2_policy(options & kPlainTable ? kEvictNormal : kEvictLast),
                           l2_policy(options & kNormalHits ? kEvictNormal : kEvictFirst)};
  const int64_t first = static_cast<int64_t>(blockIdx.x) * (kThreads * Q) + threadIdx.x;

  uint32_t L[Q], R[Q], b0[Q];
  bool live[Q];
#pragma unroll
  for (int j = 0; j < Q; ++j) {
    const int64_t i = first + static_cast<int64_t>(j) * kThreads;
    live[j] = i < n;
    long long q = 0;
    if (live[j]) {
      q = streaming ? __ldcs(queries + i) : queries[i];
      if (M == kCount && valid != nullptr && !valid[i]) live[j] = false;
    }
    live[j] = mixed_words(q, t.seed, L[j], R[j]) && live[j];
    b0[j] = live[j] ? home_bucket(t, L[j]) : 0u;
  }

  // round 0 of every query: all rows requested before any compare
  uint4 w0[Q], w1[Q];
#pragma unroll
  for (int j = 0; j < Q; ++j) {
    if (live[j]) {
      const uint4* row = t.lo + 2 * static_cast<int64_t>(b0[j]);
      w0[j] = load_lo(row, policy.rows);
      w1[j] = load_lo(row + 1, policy.rows);
    }
  }
  int rounds[Q];
#pragma unroll
  for (int j = 0; j < Q; ++j) rounds[j] = live[j] ? query_rounds(t, b0[j]) : 0;
  // the hi word of each query's first candidate lane, all requested together
  uint32_t lanes[Q], hv[Q];
#pragma unroll
  for (int j = 0; j < Q; ++j) {
    lanes[j] = live[j] ? lo_lanes(w0[j], w1[j], L[j]) : 0u;
    if (lanes[j]) {
      hv[j] = load_hi(t.hi + static_cast<int64_t>(b0[j]) * kBucketKeys + (__ffs(lanes[j]) - 1),
                      policy.hits);
    }
  }
  int64_t slot[Q];
#pragma unroll
  for (int j = 0; j < Q; ++j) {
    slot[j] = -1;
    if (lanes[j]) {
      if (hv[j] == R[j]) {
        slot[j] = static_cast<int64_t>(b0[j]) * kBucketKeys + (__ffs(lanes[j]) - 1);
      } else {  // a lo word shared by another key: the other candidates
        slot[j] = check_hi(t, b0[j], lanes[j] & (lanes[j] - 1), R[j], policy.hits);
      }
    }
    // the chain beyond the home bucket, where the block has one
    if (live[j] && slot[j] < 0 && rounds[j] > 1) {
      slot[j] = walk(t, L[j], R[j], b0[j], 1, rounds[j], policy);
    }
  }

#pragma unroll
  for (int j = 0; j < Q; ++j) {
    const int64_t i = first + static_cast<int64_t>(j) * kThreads;
    if (M == kSlots) {
      if (i < n) {
        if (streaming) {
          __stcs(out + i, static_cast<int32_t>(slot[j]));
        } else {
          out[i] = static_cast<int32_t>(slot[j]);
        }
      }
    } else if (options & kNoAggregate) {
      if (slot[j] >= 0) add_count(counts + slot[j], 1u, policy.hits);
    } else {
      // every lane of the warp takes part, hit or not; the lowest lane of
      // each group of equal slots adds the group's size
      const unsigned int peers =
          __match_any_sync(0xFFFFFFFFu, static_cast<unsigned long long>(slot[j]));
      if (slot[j] >= 0 && static_cast<int>(threadIdx.x & 31) == __ffs(peers) - 1) {
        add_count(counts + slot[j], static_cast<unsigned int>(__popc(peers)), policy.hits);
      }
    }
  }
}

template <int Q>
void launch(int mode, const Table& t, const long long* q, const bool* valid,
            unsigned int* counts, int32_t* out, int64_t n, int options,
            cudaStream_t s) {
  const int64_t per_cta = static_cast<int64_t>(kThreads) * Q;
  const unsigned int grid = static_cast<unsigned int>((n + per_cta - 1) / per_cta);
  if (mode == kCount) {
    gather_probe_dissect_kernel<kCount, Q><<<grid, kThreads, 0, s>>>(t, q, valid, counts,
                                                                     nullptr, n, options);
  } else {
    gather_probe_dissect_kernel<kSlots, Q><<<grid, kThreads, 0, s>>>(t, q, nullptr, nullptr,
                                                                     out, n, options);
  }
}

}  // namespace

// gather_probe_launch's contract (gather_probe.cu), with `options` the
// Option bits of the variant.
extern "C" int gather_probe_dissect_launch(const void* key_lo, const void* key_hi,
                                           const void* block_probe, const void* queries,
                                           const void* valid, void* counts, void* out,
                                           long long n, int n_buckets, int n_blocks,
                                           int max_probe, unsigned int seed, int mode,
                                           int options, int device, void* stream) {
  if (!valid_launch(n, n_buckets, n_blocks, max_probe, mode, key_lo, block_probe) ||
      (options & ~kAllOptions)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  if (n == 0) return static_cast<int>(cudaGetLastError());
  const Table t = make_table(key_lo, key_hi, block_probe, n_buckets, max_probe, seed);
  const auto* q = static_cast<const long long*>(queries);
  const auto* v = static_cast<const bool*>(valid);
  auto* c = static_cast<unsigned int*>(counts);
  auto* o = static_cast<int32_t*>(out);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (options & kFourPerThread) {
    launch<kPerThread>(mode, t, q, v, c, o, n, options, s);
  } else {
    launch<1>(mode, t, q, v, c, o, n, options, s);
  }
  return static_cast<int>(cudaGetLastError());
}
