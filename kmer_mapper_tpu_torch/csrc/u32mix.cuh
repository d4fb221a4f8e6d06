// 32-bit word arithmetic of the k-mer hash, shared by the CUDA kernels:
// the murmur3 finalizer, the three-round Feistel mix, the window of a
// 2-bit packed stream, the 2-bit reverse complement and the int64 sort key.
// Each is bit-identical to its torch counterpart in
// kmer_mapper_tpu_torch/ops (u32hash.fmix32_torch, feistel_mix_torch,
// hashing._window_words, revcomp_lo_hi, stream_probe.sort_key).
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace kmt_mix {

// murmur3 finalizer (u32hash.fmix32)
__device__ __forceinline__ uint32_t fmix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  x ^= x >> 16;
  return x;
}

// u32hash.feistel_mix: (L, R) <- (R, L ^ fmix32(R ^ (c + seed))) for the
// three round constants c; (c + seed) wraps mod 2**32. (lo, hi) become
// (m_lo, m_hi) in place.
__device__ __forceinline__ void feistel_mix(uint32_t& lo, uint32_t& hi,
                                            uint32_t seed) {
  const uint32_t rounds[3] = {0x9E3779B9u, 0x85EBCA6Bu, 0xC2B2AE35u};
#pragma unroll
  for (int r = 0; r < 3; ++r) {
    const uint32_t t = lo ^ fmix32(hi ^ (rounds[r] + seed));
    lo = hi;
    hi = t;
  }
}

// The (lo, hi) words of the k-mer that starts at base p (p < 16) of word
// w0 in a continuous 2-bit stream (base i in bits [2i, 2i+2) of word
// i / 16; first base least significant). A funnel shift, so p = 0 needs no
// shift by 32; for k <= 16 hi is 0.
__device__ __forceinline__ void window_words(uint32_t w0, uint32_t w1,
                                             uint32_t w2, int p, int k,
                                             uint32_t& lo, uint32_t& hi) {
  const uint32_t lo_mask = k >= 16 ? 0xFFFFFFFFu : (1u << (2 * k)) - 1u;
  const uint32_t hi_mask = k > 16 ? (1u << (2 * k - 32)) - 1u : 0u;
  lo = __funnelshift_r(w0, w1, 2 * p) & lo_mask;
  hi = __funnelshift_r(w1, w2, 2 * p) & hi_mask;
}

// hashing.revcomp_lo_hi: complement every base of the 2k-bit value, reverse
// the order of the 32 two-bit fields of the 64-bit word, shift down by
// 64 - 2k (2 ... 62 for k in [1, 31]). The complemented bits above 2k land
// below 64 - 2k and are shifted out.
__device__ __forceinline__ void revcomp(uint32_t lo, uint32_t hi, int k,
                                        uint32_t& rlo, uint32_t& rhi) {
  uint64_t x = ~((static_cast<uint64_t>(hi) << 32) | lo);
  x = __brevll(x);  // reverses the bits; swap each pair back into base order
  x = ((x >> 1) & 0x5555555555555555ull) | ((x & 0x5555555555555555ull) << 1);
  x >>= 64 - 2 * k;
  rlo = static_cast<uint32_t>(x);
  rhi = static_cast<uint32_t>(x >> 32);
}

// stream_probe.sort_key: (m_lo - 2**31) * 2**32 + m_hi, whose signed order
// is the unsigned (m_lo, m_hi) order; its bits are m_lo ^ 2**31 above m_hi.
__device__ __forceinline__ long long sort_key(uint32_t m_lo, uint32_t m_hi) {
  return static_cast<long long>(
      (static_cast<uint64_t>(m_lo ^ 0x80000000u) << 32) | m_hi);
}

// The sort key of raw k-mer words (lo, hi) under the table's seed.
__device__ __forceinline__ long long mixed_key(uint32_t lo, uint32_t hi,
                                               uint32_t seed) {
  feistel_mix(lo, hi, seed);
  return sort_key(lo, hi);
}

}  // namespace kmt_mix
