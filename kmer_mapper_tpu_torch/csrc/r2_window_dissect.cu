// Dissection of the stream count over a flat tile schedule (sm_90a).
//
// Replaces scripts/r2_window_dissect.py:_kernel_v, the Pallas kernel that
// walks a flat schedule of 1024-query tiles (each tile: one chain block's
// group and an aligned offset into its window) with a 4-slot DMA ring.
// Here one CTA serves one tile: it stages its block's 8 KB of keys, counts
// the tile's queries into a shared count tile and adds the tile into the
// global counts with atomics. A long window (a poly-A block) is thus spread
// over as many CTAs as it has tiles, where stream_count.cu gives it one.
// The variants full, nodma and empty compute what the same variants of
// r2_kernel_dissect.cu compute; this script's nomm1 adds round p's counts
// at bucket local + p, as its Pallas variant rolls them (block_count.cuh).
//
// What bounds it: the queries' 8-byte sort keys, read once; every tile
// re-reads its block's 8 KB of keys (from L2 when the block's tiles run
// together) and scans its 4 KB count tile, the price of the split.
//
// The schedule (t_group, t_off) is built on the device by the wrapper; the
// grid is an upper bound of the tile count and tiles past it exit at once.
//
// Bound with ctypes; see kmer_mapper_tpu_torch/native.py.

#include "block_count.cuh"

namespace {

using namespace kmt_count;

template <int V>
__global__ void __launch_bounds__(kThreads)
r2_window_dissect_kernel(const uint32_t* __restrict__ key_lo,
                         const uint32_t* __restrict__ key_hi,
                         unsigned int* __restrict__ counts,
                         const unsigned long long* __restrict__ sorted_keys,
                         const int32_t* __restrict__ off,
                         const int32_t* __restrict__ block_probe,
                         const int32_t* __restrict__ t_group,
                         const int64_t* __restrict__ t_off, int shift, int bpb,
                         int max_probe, int n_blocks, int cap) {
  __shared__ BlockTile tile;
  const int64_t g = t_group[blockIdx.x];
  if (g >= n_blocks) return;  // past the last tile of the schedule
  const int64_t start = off[g];
  const int64_t end = off[g + 1];
  if (V == kEmpty) {
    // zero-trip loop: the tile's window bounds stay live (offsets never
    // decrease, so this adds nothing, but the compiler cannot know that)
    if (start > end && threadIdx.x == 0) atomicAdd(&counts[0], 0u);
    return;
  }
  const int64_t first = t_off[blockIdx.x];
  const int64_t lo = first > start ? first : start;
  const int64_t hi = first + cap < end ? first + cap : end;
  if (lo >= hi) return;  // uniform over the CTA

  const int n_slots = bpb * kBucketKeys;
  const int64_t slot0 = g * static_cast<int64_t>(n_slots);
  stage_block<false>(tile, key_lo, key_hi, slot0, n_slots);
  __syncthreads();

  const int rounds = probe_rounds(block_probe, g, 1, max_probe);
  const int64_t bucket0 = g * static_cast<int64_t>(bpb);
  for (int64_t i = lo + threadIdx.x; i < hi; i += blockDim.x) {
    uint32_t m_lo, m_hi;
    query_at<V>(tile, sorted_keys, i, n_slots, m_lo, m_hi);
    count_query<V>(tile, m_lo, m_hi, shift, bucket0, bpb, rounds);
  }
  __syncthreads();
  flush_block(tile, counts, slot0, n_slots);
}

template <int V>
void launch(dim3 grid, cudaStream_t stream, const void* key_lo,
            const void* key_hi, void* counts, const void* sorted_keys,
            const void* off, const void* block_probe, const void* t_group,
            const void* t_off, int shift, int bpb, int max_probe, int n_blocks,
            int cap) {
  r2_window_dissect_kernel<V><<<grid, kThreads, 0, stream>>>(
      static_cast<const uint32_t*>(key_lo), static_cast<const uint32_t*>(key_hi),
      static_cast<unsigned int*>(counts),
      static_cast<const unsigned long long*>(sorted_keys),
      static_cast<const int32_t*>(off), static_cast<const int32_t*>(block_probe),
      static_cast<const int32_t*>(t_group), static_cast<const int64_t*>(t_off),
      shift, bpb, max_probe, n_blocks, cap);
}

}  // namespace

// counts += the variant's contribution of the sorted queries, one CTA per
// schedule entry; returns cudaGetLastError() after the launch (0 on
// success). Pointers as in r2_kernel_dissect_launch, plus t_group
// int32[n_tiles] (the chain block of each tile, n_blocks past the end) and
// t_off int64[n_tiles] (the tile's first sorted position). variant is one
// of kFull, kNoMm1Rolled, kNoDma, kEmpty. Does not synchronise.
extern "C" int r2_window_dissect_launch(const void* key_lo, const void* key_hi,
                                        void* counts, const void* sorted_keys,
                                        const void* off, const void* block_probe,
                                        const void* t_group, const void* t_off,
                                        int n_tiles, int n_blocks, int shift,
                                        int bpb, int max_probe, int cap,
                                        int variant, int device, void* stream) {
  if (n_tiles < 0 || cap < 1 ||
      !(variant == kFull || variant == kNoMm1Rolled || variant == kNoDma ||
        variant == kEmpty)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaError_t set = check_and_select(bpb, n_blocks, max_probe, variant, device);
  if (set != cudaSuccess) return static_cast<int>(set);
  if (n_tiles == 0 || n_blocks == 0) return static_cast<int>(cudaGetLastError());
  const dim3 grid(n_tiles);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define KMT_LAUNCH(V)                                                          \
  launch<V>(grid, s, key_lo, key_hi, counts, sorted_keys, off, block_probe,   \
            t_group, t_off, shift, bpb, max_probe, n_blocks, cap)
  switch (variant) {
    case kFull: KMT_LAUNCH(kFull); break;
    case kNoMm1Rolled: KMT_LAUNCH(kNoMm1Rolled); break;
    case kNoDma: KMT_LAUNCH(kNoDma); break;
    default: KMT_LAUNCH(kEmpty); break;
  }
#undef KMT_LAUNCH
  return static_cast<int>(cudaGetLastError());
}
