// The block partition's first design, the cursor route, kept for measurement
// on the card: kmer_mapper_tpu_torch/scripts/partition_dissect.py times it
// beside the main path's radix route (block_partition.cu) on the same keys.
// It computes block_partition.cu's function (off and a grouping of the keys
// by bin; the order inside a window is unspecified) in two kernels:
//  * block_histogram_kernel: hist[bin] += 1 with warp-aggregated atomics
//    (the lanes of a warp that share a bin merge with __match_any_sync), in
//    a shared copy where the bins fit (kSharedBins, 48 KB) and else in
//    device memory; the wrapper's torch.cumsum of hist gives off;
//  * block_scatter_kernel: the leaders of each warp's groups reserve their
//    slots from a cursor array in device memory (returning atomics in L2),
//    issued for all kItems keys before any is written; each lane writes at
//    the reserved base + its rank in the group.
// Its scatter's returning atomics and random 8-byte stores are what the
// radix route replaced (PERF.md).
//
// Bound with ctypes; see kmer_mapper_tpu_torch/native.py.

#include <cstdint>
#include <cuda_runtime.h>

#include "block_partition.cuh"

namespace {

using namespace kmt_partition;

constexpr int kSharedBins = 12288;  // 48 KB of int32: the histogram's shared copy

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
