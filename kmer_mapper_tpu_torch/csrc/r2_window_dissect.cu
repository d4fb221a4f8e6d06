// Dissection of the stream count over a schedule of window ranges (sm_90a).
//
// Replaces scripts/r2_window_dissect.py:_kernel_v, the Pallas kernel that
// walks a flat schedule of 1024-query tiles (each tile: one chain block's
// group and an aligned offset into its window) with a 4-slot DMA ring, and
// the jnp schedule before it (:143-153). Here the schedule is a list of
// window ranges: chain block g's window [off[g], off[g+1]) of length L is
// cut into ceil(L / span) contiguous ranges of at most `span` queries, one
// CTA each. A window of up to `span` queries thus stages its block once,
// and a long (poly-A) window still spreads over ceil(L / span) CTAs, where
// stream_count.cu gives it one. Two kernels build the list on the device,
// one CTA per 1024 windows: window_totals_kernel counts each CTA's ranges,
// window_ranges_kernel adds the totals before its CTA and writes its
// windows' rows; rows past the last range hold group n_blocks.
//
// A CTA counts its range with count_range.cuh's body, the body of
// r2_kernel_dissect.cu too: the block's keys staged with 16-byte cp.async
// copies while its first queries load, count_tile.cuh's tile built from
// them, the range counted into the tile and the tile added into the global
// counts. The variants full, nodma and empty compute what the same variants
// of r2_kernel_dissect.cu compute (this kernel's empty exits before the
// staging); this script's nomm1 adds round p's counts at bucket local + p,
// as its Pallas variant rolls them.
//
// What bounds it: the queries' 8-byte sort keys, read once; the keys of
// each block once per range (from L2 when a window's ranges run together).
//
// Bound with ctypes; see kmer_mapper_tpu_torch/native.py.

#include "count_range.cuh"

namespace {

using namespace kmt_range;

constexpr int kScheduleThreads = 1024;
// ranges of one window that the thread owning the window writes alone; the
// rest of a longer window its warp writes together
constexpr int kInline = 4;
constexpr int kMinSpan = 32;

// ceil((end - start) / span), 0 for an empty window; 32-bit division (a
// window holds fewer than 2^31 queries)
__device__ __forceinline__ int ranges_of(int32_t start, int32_t end, int span) {
  if (end <= start) return 0;
  const uint32_t n = static_cast<uint32_t>(end - start), d = static_cast<uint32_t>(span);
  const uint32_t whole = n / d;
  return static_cast<int>(whole + (n - whole * d != 0));
}

// The CTA-wide sum of one int a thread (every thread of the CTA calls it).
__device__ __forceinline__ int cta_sum(int v, int* warp_total) {
  v = __reduce_add_sync(~0u, v);
  __syncthreads();  // warp_total free
  if ((threadIdx.x & 31) == 0) warp_total[threadIdx.x >> 5] = v;
  __syncthreads();
  int total = 0;
#pragma unroll
  for (int w = 0; w < kScheduleThreads / 32; ++w) total += warp_total[w];
  return total;
}

// The range count of the window thread i of CTA c owns: window c * 1024 + i.
__device__ __forceinline__ int own_ranges(const int32_t* __restrict__ off, int n_blocks,
                                          int span, int& start) {
  const int b = blockIdx.x * kScheduleThreads + threadIdx.x;
  start = 0;
  if (b >= n_blocks) return 0;
  start = off[b];
  return ranges_of(start, off[b + 1], span);
}

// totals[c] = the ranges of CTA c's 1024 windows.
__global__ void __launch_bounds__(kScheduleThreads)
window_totals_kernel(const int32_t* __restrict__ off, int* __restrict__ totals, int n_blocks,
                     int span) {
  __shared__ int warp_total[kScheduleThreads / 32];
  int start;
  const int total = cta_sum(own_ranges(off, n_blocks, span, start), warp_total);
  if (threadIdx.x == 0) totals[blockIdx.x] = total;
}

// The ranges of CTA c's windows, after the ranges of the CTAs before it
// (the sum of their totals), in block order; then the rows from the last
// range to n_ranges get (n_blocks, off[n_blocks]), spread over the CTAs.
__global__ void __launch_bounds__(kScheduleThreads)
window_ranges_kernel(const int32_t* __restrict__ off, const int* __restrict__ totals,
                     int2* __restrict__ ranges, int n_blocks, int n_ctas, int span,
                     int n_ranges) {
  __shared__ int warp_total[kScheduleThreads / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int before = 0, all = 0;
  for (int c = threadIdx.x; c < n_ctas; c += kScheduleThreads) {
    const int t = totals[c];
    all += t;
    before += c < static_cast<int>(blockIdx.x) ? t : 0;
  }
  before = cta_sum(before, warp_total);
  all = cta_sum(all, warp_total);
  int start;
  const int n = own_ranges(off, n_blocks, span, start);
  int incl = n;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int v = __shfl_up_sync(~0u, incl, d);
    if (lane >= d) incl += v;
  }
  __syncthreads();  // warp_total free
  if (lane == 31) warp_total[warp] = incl;
  __syncthreads();
  int base = before + incl - n;
  for (int w = 0; w < warp; ++w) base += warp_total[w];
  const int b = blockIdx.x * kScheduleThreads + threadIdx.x;
  for (int j = 0; j < min(n, kInline); ++j) ranges[base + j] = make_int2(b, start + j * span);
  // the rest of a long window: its warp writes it, 32 rows at a time
  for (unsigned big = __ballot_sync(~0u, n > kInline); big; big &= big - 1) {
    const int src = __ffs(big) - 1;
    const int sb = __shfl_sync(~0u, b, src), ss = __shfl_sync(~0u, start, src);
    const int sn = __shfl_sync(~0u, n, src), sbase = __shfl_sync(~0u, base, src);
    for (int j = kInline + lane; j < sn; j += 32) ranges[sbase + j] = make_int2(sb, ss + j * span);
  }
  const int end = off[n_blocks];
  for (int e = all + blockIdx.x * kScheduleThreads + threadIdx.x; e < n_ranges;
       e += n_ctas * kScheduleThreads) {
    ranges[e] = make_int2(n_blocks, end);
  }
}

// at most 32 registers: 8 CTAs an SM, as stream_count_kernel, to hide the
// latency of the key stream
template <int V>
__global__ void __launch_bounds__(kCountThreads, 8)
r2_window_dissect_kernel(const uint32_t* __restrict__ key_lo,
                         const uint32_t* __restrict__ key_hi,
                         unsigned int* __restrict__ counts,
                         const unsigned long long* __restrict__ sorted_keys,
                         const int32_t* __restrict__ off,
                         const int32_t* __restrict__ block_probe,
                         const int2* __restrict__ ranges, int shift, int bpb,
                         int max_probe, int n_blocks, int span) {
  __shared__ RangeSmem sm;
  const int2 range = ranges[blockIdx.x];
  const int64_t g = range.x;
  if (g >= n_blocks) return;  // past the last range of the schedule
  const int64_t first = range.y;
  const int64_t end = off[g + 1];
  if (V == kEmpty) {
    // zero-trip loop: the range's bounds stay live (a range never starts
    // past its window's end, but the compiler cannot know that)
    if (first > end && threadIdx.x == 0) atomicAdd(&counts[0], 0u);
    return;
  }
  count_range<V>(sm, key_lo, key_hi, counts, sorted_keys, block_probe, g, first,
                 first + span < end ? first + span : end, shift, bpb, max_probe);
}

template <int V>
void launch(int grid, cudaStream_t stream, const void* key_lo, const void* key_hi,
            void* counts, const void* sorted_keys, const void* off,
            const void* block_probe, const void* ranges, int shift, int bpb,
            int max_probe, int n_blocks, int span) {
  r2_window_dissect_kernel<V><<<grid, kCountThreads, 0, stream>>>(
      static_cast<const uint32_t*>(key_lo), static_cast<const uint32_t*>(key_hi),
      static_cast<unsigned int*>(counts),
      static_cast<const unsigned long long*>(sorted_keys),
      static_cast<const int32_t*>(off), static_cast<const int32_t*>(block_probe),
      static_cast<const int2*>(ranges), shift, bpb, max_probe, n_blocks, span);
}

}  // namespace

// ranges int32 (n_ranges, 2) := the schedule of window ranges of off
// int32[n_blocks + 1] at `span` queries a range (span >= 32), then
// (n_blocks, off[n_blocks]) to the end; n_ranges must be at least the
// number of ranges (ceil(n_queries / span) + n_blocks always is); totals
// int32[max(1, ceil(n_blocks / 1024))] is scratch. Two kernels of one CTA
// per 1024 windows; returns cudaGetLastError() after the launches (0 on
// success) and does not synchronise.
extern "C" int r2_window_ranges_launch(const void* off, void* totals, void* ranges,
                                       int n_blocks, int span, int n_ranges, int device,
                                       void* stream) {
  if (n_blocks < 0 || span < kMinSpan || n_ranges < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n_ctas = max(1, (n_blocks + kScheduleThreads - 1) / kScheduleThreads);
  window_totals_kernel<<<n_ctas, kScheduleThreads, 0, s>>>(
      static_cast<const int32_t*>(off), static_cast<int*>(totals), n_blocks, span);
  window_ranges_kernel<<<n_ctas, kScheduleThreads, 0, s>>>(
      static_cast<const int32_t*>(off), static_cast<const int*>(totals),
      static_cast<int2*>(ranges), n_blocks, n_ctas, span, n_ranges);
  return static_cast<int>(cudaGetLastError());
}

// counts += the variant's contribution of the grouped queries, one CTA per
// schedule entry; returns cudaGetLastError() after the launch (0 on
// success). Pointers as in r2_kernel_dissect_launch (key_lo and key_hi
// 16-byte aligned), plus ranges int32 (n_ranges, 2) from
// r2_window_ranges_launch with the same span. variant is one of kFull,
// kNoMm1Rolled, kNoDma, kEmpty. Does not synchronise.
extern "C" int r2_window_dissect_launch(const void* key_lo, const void* key_hi,
                                        void* counts, const void* sorted_keys,
                                        const void* off, const void* block_probe,
                                        const void* ranges, int n_ranges, int n_blocks,
                                        int shift, int bpb, int max_probe, int span,
                                        int variant, int device, void* stream) {
  if (n_ranges < 0 || span < kMinSpan || !aligned16(key_lo) || !aligned16(key_hi) ||
      !(variant == kFull || variant == kNoMm1Rolled || variant == kNoDma ||
        variant == kEmpty)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaError_t set = check_and_select(bpb, n_blocks, max_probe, variant, device);
  if (set != cudaSuccess) return static_cast<int>(set);
  if (n_ranges == 0 || n_blocks == 0) return static_cast<int>(cudaGetLastError());
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define KMT_LAUNCH(V)                                                                 \
  launch<V>(n_ranges, s, key_lo, key_hi, counts, sorted_keys, off, block_probe, ranges, \
            shift, bpb, max_probe, n_blocks, span)
  switch (variant) {
    case kFull: KMT_LAUNCH(kFull); break;
    case kNoMm1Rolled: KMT_LAUNCH(kNoMm1Rolled); break;
    case kNoDma: KMT_LAUNCH(kNoDma); break;
    default: KMT_LAUNCH(kEmpty); break;
  }
#undef KMT_LAUNCH
  return static_cast<int>(cudaGetLastError());
}
