// Gather probe for NVIDIA Hopper (sm_90a): the pre-hashed library calls'
// small batches and every membership query.
//
// Replaces kmer_mapper_tpu/ops/probe.py:probe_hits with accumulate_scatter
// (:31, :117) in mode kCount and probe_slots (:78) in mode kSlots. Those are
// XLA code on the TPU, not a Pallas kernel: per probe round they gather a
// bucket row for every query and compare it with an (n, 8) lane mask, which
// torch eager would write to device memory once per round. This kernel
// computes what they compute: for each query i, the raw (lo, hi) words of
// a uint64 k-mer hash are mixed with the three-round Feistel of
// u32hash.feistel_mix; a query whose mixed pair is all-ones (the empty-slot
// sentinel) never matches; bucket b0 = m_lo >> shift (0 for a one-bucket
// table); for rounds p < max_probe the query compares its pair with the 8
// keys of bucket (b0 & ~mask) | ((b0 + p) & mask), mask = min(128,
// n_buckets) - 1. The first hit adds one to counts[b*8 + lane] (kCount,
// valid queries only; an int32 atomicAdd wraps as the reference's uint32)
// or is written as the slot, -1 for a miss (kSlots). Keys are unique in the
// table, so stopping at the first hit gives probe_hits' result.
//
// What bounds it: per query 8 bytes of words in, one 32-byte row of lo
// words per round taken, the hi word only where a lo word matched, and 4
// bytes out or one atomic: device-memory bytes, at random rows. Design,
// simple first: one thread per query; a round reads the row's 8 lo words as
// two 16-byte loads, so a warp issues 2 load instructions per round where
// a word-at-a-time loop issues 8; the hi words stay in memory unless a lo
// word matches. No shared memory: the queries are unsorted, so nothing is
// reused within a CTA, and the 50 MB L2 holds most of a 67 MB table.
//
// Bound with ctypes; see kmer_mapper_tpu_torch/native.py.

#include <cstdint>
#include <cuda_runtime.h>

#include "u32mix.cuh"

namespace {

constexpr int kBucketKeys = 8;
constexpr int kChainBlock = 128;
constexpr int kThreads = 256;
constexpr int kMaxProbeHard = 64;  // layout.MAX_PROBE_HARD
constexpr int kMaxBuckets = 1 << 29;  // slots stay below 2**32
constexpr uint32_t kEmpty = 0xFFFFFFFFu;

enum Mode : int { kCount = 0, kSlots = 1 };

// The slot of the key equal to raw query (lo, hi), or -1.
__device__ __forceinline__ int64_t find_slot(const uint4* __restrict__ key_lo,
                                             const uint32_t* __restrict__ key_hi,
                                             uint32_t lo, uint32_t hi, int shift,
                                             uint32_t mask, int max_probe,
                                             uint32_t seed) {
  uint32_t L = lo, R = hi;
  kmt_mix::feistel_mix(L, R, seed);
  if (L == kEmpty && R == kEmpty) return -1;
  // shifting a 32-bit word by 32 is undefined: one bucket holds every key
  const uint32_t b0 = shift >= 32 ? 0u : L >> shift;
  const uint32_t base = b0 & ~mask;
  for (int p = 0; p < max_probe; ++p) {
    const uint32_t b = base | ((b0 + p) & mask);
    const uint4 w0 = __ldg(key_lo + 2 * static_cast<int64_t>(b));
    const uint4 w1 = __ldg(key_lo + 2 * static_cast<int64_t>(b) + 1);
    const uint32_t w[kBucketKeys] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
    const int64_t row = static_cast<int64_t>(b) * kBucketKeys;
#pragma unroll
    for (int l = 0; l < kBucketKeys; ++l) {
      if (w[l] == L && __ldg(key_hi + row + l) == R) return row + l;
    }
  }
  return -1;
}

template <int M>
__global__ void __launch_bounds__(kThreads)
gather_probe_kernel(const uint4* __restrict__ key_lo,
                    const uint32_t* __restrict__ key_hi,
                    const uint32_t* __restrict__ q_lo,
                    const uint32_t* __restrict__ q_hi,
                    const bool* __restrict__ valid,
                    unsigned int* __restrict__ counts,
                    int32_t* __restrict__ out, int64_t n, int shift,
                    uint32_t mask, int max_probe, uint32_t seed) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= n) return;
  if (M == kCount && !valid[i]) return;
  const int64_t slot =
      find_slot(key_lo, key_hi, q_lo[i], q_hi[i], shift, mask, max_probe, seed);
  if (M == kSlots) {
    out[i] = static_cast<int32_t>(slot);
  } else if (slot >= 0) {
    atomicAdd(&counts[slot], 1u);
  }
}

}  // namespace

// Probes n raw queries; returns cudaGetLastError() after the launch (0 on
// success). Device pointers: key_lo and key_hi uint32[n_buckets*8] in slot
// order (key_lo 16-byte aligned), q_lo and q_hi uint32[n]; mode kCount
// reads valid bool[n] and adds into counts uint32[n_buckets*8]; mode kSlots
// writes out int32[n] (the wrapper refuses tables of 2**31 slots or more).
// Launches on `stream` of CUDA device `device` and does not synchronise.
extern "C" int gather_probe_launch(const void* key_lo, const void* key_hi,
                                   const void* q_lo, const void* q_hi,
                                   const void* valid, void* counts, void* out,
                                   long long n, int n_buckets, int max_probe,
                                   unsigned int seed, int mode, int device,
                                   void* stream) {
  if (n < 0 || n_buckets < 1 || n_buckets > kMaxBuckets ||
      (n_buckets & (n_buckets - 1)) || max_probe < 1 ||
      max_probe > kMaxProbeHard || (mode != kCount && mode != kSlots) ||
      (reinterpret_cast<uintptr_t>(key_lo) & 15)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // this library links its own CUDA runtime, whose current device is not
  // PyTorch's
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  if (n == 0) return static_cast<int>(cudaGetLastError());
  int shift = 32;  // u32hash.bucket_shift
  while ((1ll << (32 - shift)) < n_buckets) --shift;
  const uint32_t mask =
      static_cast<uint32_t>((n_buckets < kChainBlock ? n_buckets : kChainBlock) - 1);
  const unsigned int grid = static_cast<unsigned int>((n + kThreads - 1) / kThreads);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* lo = static_cast<const uint4*>(key_lo);
  const auto* hi = static_cast<const uint32_t*>(key_hi);
  const auto* ql = static_cast<const uint32_t*>(q_lo);
  const auto* qh = static_cast<const uint32_t*>(q_hi);
  if (mode == kCount) {
    gather_probe_kernel<kCount><<<grid, kThreads, 0, s>>>(
        lo, hi, ql, qh, static_cast<const bool*>(valid),
        static_cast<unsigned int*>(counts), nullptr, n, shift, mask, max_probe, seed);
  } else {
    gather_probe_kernel<kSlots><<<grid, kThreads, 0, s>>>(
        lo, hi, ql, qh, nullptr, nullptr, static_cast<int32_t*>(out), n, shift, mask,
        max_probe, seed);
  }
  return static_cast<int>(cudaGetLastError());
}
