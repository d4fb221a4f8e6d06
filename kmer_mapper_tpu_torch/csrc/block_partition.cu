// Block partition for NVIDIA Hopper (sm_90a): the int64 sort keys of a
// chunk's queries grouped by 128-bucket chain block, and each block's window,
// for the stream count (stream_count.cu) of both chunk steps.
//
// Replaces the sort and the offsets of
// kmer_mapper_tpu/ops/stream_probe.py:stream_probe_count_mixed: the
// two-operand lax.sort of the mixed (m_lo, m_hi) words (:1170) and
// block_offsets (:407), XLA code on the TPU that the port had run as
// torch.sort (values and int64 indices) plus two torch.searchsorted. The
// count never needed sorted order: it runs one CTA per chain block's window
// and checks each query's bucket against its own block, so only grouping by
// block matters, and integer adds commute. It computes, for keys k[0..n):
//  * bin(k) = the chain block (k ^ 2**63) >> (64 - log2 n_blocks), the top
//    bits of m_lo (0 for a table of one block, where a shift by 64 would be
//    undefined), or n_blocks for the all-ones invalid key, which lands in no
//    window;
//  * block_histogram: hist[bin] += 1 for every key, hist int32[n_blocks + 1];
//  * the wrapper's exclusive scan (torch.cumsum) gives off int32[n_blocks + 2]:
//    block b's window is [off[b], off[b+1]), the invalid keys follow off[n_blocks];
//  * block_scatter: every key is written into its bin's window, at a slot
//    reserved from cursor = off[:n_blocks + 1]. The output is a permutation
//    of the input. The order inside a window is left unspecified (it depends
//    on the order in which warps reserve their slots).
//
// What bounds it: its bytes are 24 a key (the histogram reads each 8-byte
// key, the scatter reads it again and writes it; the histogram, offsets and
// cursors are n_blocks words, 32 KB on the bench index), but on the H100 its
// atomics bound it: one per group of equal bins in a warp, which on uniform
// keys is almost one a key. In device memory they cost the histogram about
// twice its time in shared memory, and the scatter's, which must return the
// slot, take most of the partition's time (PERF.md). Design, simple first:
//  * each lane loads kItems keys (coalesced, the loads issued together)
//    before it bins them; warps stride over the keys;
//  * the lanes of a warp that share a bin merge with __match_any_sync, and
//    the lowest of them does one atomic for the group: on the poly-A window,
//    where every key of a chunk lands in one block, that is one atomic per
//    32 keys, not 32;
//  * the histogram counts into a copy in shared memory where its bins fit
//    (kSharedBins, 48 KB: the bench index's 8,193), which each CTA adds into
//    the global one at its end; a table of 2**25 buckets has 262,145 bins
//    and counts straight into device memory;
//  * the scatter's leaders reserve popc(group) slots from the bin's cursor
//    (an atomic that returns), issued for all kItems keys before any is
//    written; each lane writes at the reserved base + its rank in the group.
//    The writes land in at most n_blocks + 1 open windows; their 32-byte
//    sectors (256 KB on the bench index, 8 MB at 2**25 buckets) stay in the
//    50 MB L2 until they fill, so device memory sees whole sectors.
//
// Bound with ctypes; see kmer_mapper_tpu_torch/native.py.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kItems = 4;  // keys a lane loads before it bins them
constexpr int kWarpTile = 32 * kItems;
constexpr int kSharedBins = 12288;  // 48 KB of int32: the histogram's shared copy
constexpr long long kInvalidKey = 0x7FFFFFFFFFFFFFFFll;  // the all-ones pair's key
constexpr unsigned long long kSignBit = 0x8000000000000000ull;
constexpr unsigned int kFullMask = 0xFFFFFFFFu;

// The bin of a key: its chain block, or n_blocks for the invalid key.
__device__ __forceinline__ int key_bin(long long key, int log2_blocks) {
  if (key == kInvalidKey) return 1 << log2_blocks;
  // a 64-bit shift by 64 is undefined: one block holds every key
  if (log2_blocks == 0) return 0;
  return static_cast<int>((static_cast<unsigned long long>(key) ^ kSignBit) >>
                          (64 - log2_blocks));
}

// The warp's tile at `base`: lane l holds keys base + 32j + l, j < kItems,
// and their bins (-1 past the end, a group that does nothing).
__device__ __forceinline__ void load_tile(const long long* __restrict__ keys, long long n,
                                          long long base, int lane, int log2_blocks,
                                          long long (&key)[kItems], int (&bin)[kItems]) {
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    const long long i = base + 32 * j + lane;
    key[j] = i < n ? keys[i] : 0;
  }
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    bin[j] = base + 32 * j + lane < n ? key_bin(key[j], log2_blocks) : -1;
  }
}

template <bool kShared>
__global__ void __launch_bounds__(kThreads)
block_histogram_kernel(const long long* __restrict__ keys, long long n,
                       int* __restrict__ hist, int log2_blocks) {
  extern __shared__ int local[];
  const int n_bins = (1 << log2_blocks) + 1;
  int* bins = kShared ? local : hist;
  if (kShared) {
    for (int b = threadIdx.x; b < n_bins; b += kThreads) local[b] = 0;
    __syncthreads();
  }
  const int lane = threadIdx.x & 31;
  const long long stride = static_cast<long long>(gridDim.x) * kWarps * kWarpTile;
  // `base` is the same for every lane of a warp: all of them reach the match
  for (long long base = (static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5)) *
                        kWarpTile;
       base < n; base += stride) {
    long long key[kItems];
    int bin[kItems];
    load_tile(keys, n, base, lane, log2_blocks, key, bin);
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      const unsigned int peers = __match_any_sync(kFullMask, bin[j]);
      if (bin[j] >= 0 && lane == __ffs(peers) - 1) atomicAdd(&bins[bin[j]], __popc(peers));
    }
  }
  if (kShared) {
    __syncthreads();
    for (int b = threadIdx.x; b < n_bins; b += kThreads) {
      if (local[b]) atomicAdd(&hist[b], local[b]);
    }
  }
}

__global__ void __launch_bounds__(kThreads)
block_scatter_kernel(const long long* __restrict__ keys, long long n,
                     int* __restrict__ cursor, long long* __restrict__ out,
                     int log2_blocks) {
  const int lane = threadIdx.x & 31;
  const unsigned int below = (1u << lane) - 1u;
  const long long stride = static_cast<long long>(gridDim.x) * kWarps * kWarpTile;
  for (long long base = (static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5)) *
                        kWarpTile;
       base < n; base += stride) {
    long long key[kItems];
    int bin[kItems];
    load_tile(keys, n, base, lane, log2_blocks, key, bin);
    unsigned int peers[kItems];
    int at[kItems];
    // every reservation is in flight before the first result is needed
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      peers[j] = __match_any_sync(kFullMask, bin[j]);
      at[j] = 0;
      if (bin[j] >= 0 && lane == __ffs(peers[j]) - 1) {
        at[j] = atomicAdd(&cursor[bin[j]], __popc(peers[j]));
      }
    }
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      const int base_j = __shfl_sync(kFullMask, at[j], __ffs(peers[j]) - 1);
      if (bin[j] >= 0) out[base_j + __popc(peers[j] & below)] = key[j];
    }
  }
}

// CTAs that fill the card once, and no more than the work's CTA tiles
// (kWarps warp tiles each); the kernels stride over the rest.
template <typename Kernel>
cudaError_t grid_for(Kernel kernel, int device, size_t smem, long long n, unsigned int& grid) {
  int sms = 0, per_sm = 0;
  cudaError_t err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
  }
  if (err != cudaSuccess) return err;
  const long long tiles = (n + kWarps * kWarpTile - 1) / (kWarps * kWarpTile);
  grid = static_cast<unsigned int>(tiles < 1LL * sms * per_sm ? tiles : 1LL * sms * per_sm);
  return grid ? cudaSuccess : cudaErrorInvalidConfiguration;
}

bool valid_args(long long n, int log2_blocks) {
  return n >= 0 && n < (1LL << 31) && log2_blocks >= 0 && log2_blocks <= 30;
}

}  // namespace

// hist[bin(k)] += 1 for the n keys; returns the first CUDA error (0 on
// success). Device pointers: keys int64[n], hist int32[2**log2_blocks + 1],
// zeroed by the caller. shared != 0 counts in a shared-memory copy, which
// needs 2**log2_blocks + 1 <= 12288 bins. Launches on `stream` of CUDA
// device `device` and does not synchronise.
extern "C" int block_histogram_launch(const void* keys, long long n, void* hist,
                                      int log2_blocks, int shared, int device,
                                      void* stream) {
  const int n_bins = valid_args(n, log2_blocks) ? (1 << log2_blocks) + 1 : 0;
  if (!n_bins || (shared && n_bins > kSharedBins)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // this library links its own CUDA runtime, whose current device is not
  // PyTorch's
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess || n == 0) return static_cast<int>(err);
  const auto* k = static_cast<const long long*>(keys);
  auto* h = static_cast<int*>(hist);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  unsigned int grid = 0;
  if (shared) {
    const size_t smem = sizeof(int) * n_bins;
    err = grid_for(block_histogram_kernel<true>, device, smem, n, grid);
    if (err != cudaSuccess) return static_cast<int>(err);
    block_histogram_kernel<true><<<grid, kThreads, smem, s>>>(k, n, h, log2_blocks);
  } else {
    err = grid_for(block_histogram_kernel<false>, device, 0, n, grid);
    if (err != cudaSuccess) return static_cast<int>(err);
    block_histogram_kernel<false><<<grid, kThreads, 0, s>>>(k, n, h, log2_blocks);
  }
  return static_cast<int>(cudaGetLastError());
}

// Writes each of the n keys into its bin's window of out, at a slot taken
// from cursor[bin] (cursor int32[2**log2_blocks + 1], each bin's first slot,
// advanced in place); returns the first CUDA error (0 on success). Device
// pointers: keys and out int64[n]. Launches on `stream` of CUDA device
// `device` and does not synchronise.
extern "C" int block_scatter_launch(const void* keys, long long n, void* cursor, void* out,
                                    int log2_blocks, int device, void* stream) {
  if (!valid_args(n, log2_blocks)) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess || n == 0) return static_cast<int>(err);
  unsigned int grid = 0;
  err = grid_for(block_scatter_kernel, device, 0, n, grid);
  if (err != cudaSuccess) return static_cast<int>(err);
  block_scatter_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const long long*>(keys), n, static_cast<int*>(cursor),
      static_cast<long long*>(out), log2_blocks);
  return static_cast<int>(cudaGetLastError());
}
