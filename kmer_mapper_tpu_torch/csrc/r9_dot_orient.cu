// The tile body under its two MXU dot orientations (sm_90a).
//
// Replaces scripts/r9_dot_orient.py:make_kernel(variant).kernel, the Pallas
// kernel that runs the tile body ITERS times in one program on one bf16
// key tile of byte planes and one (2, lanes) query array: tile i looks at
// buckets (37 l + i) & 127, and the result is the count tile. Its variants
// differ in the orientation of the two dots, which here is the layout of
// the key tile and of the count tile in shared memory (r9_tile.cuh):
//
//   variant   key tile (tb)     count tile
//   old       (128, 64)         (128, 8)       both bucket-major
//   new       (64, 128)         (8, 128)
//   d1old     (128, 64)         (8, 128)
//   d2old     (64, 128)         (128, 8)
//
// The iterations are an order-free sum of integers, so they are spread over
// CTAs of iters_per_cta iterations each: a CTA stages the 16 KB tile, counts
// into its own 4 KB count tile with shared atomics and adds each nonzero
// entry into the output with one global atomic. Each thread keeps a lane's
// query in registers across the CTA's iterations.
//
// What bounds it: the 64 shared bf16 reads per live lane and iteration (8
// planes of 8 key lanes). In the bucket-major tile a warp's 32 lanes read
// 32 rows of 128 bytes at one column, one bank: 32-way conflicts.
//
// Bound with ctypes; see kmer_mapper_tpu_torch/native.py.

#include "r9_tile.cuh"

using namespace kmt_r9;

namespace {

constexpr int kDotThreads = 512;

template <bool kTbBucketMajor, bool kCountBucketMajor>
__global__ void __launch_bounds__(kDotThreads)
r9_dot_orient_kernel(const uint16_t* __restrict__ tb, const uint32_t* __restrict__ q,
                     unsigned int* __restrict__ out, int iters, int iters_per_cta, int lanes) {
  __shared__ uint16_t s_tb[kW8 * kGpb];
  __shared__ unsigned int s_cnt[kK * kGpb];
  for (int i = threadIdx.x; i < kW8 * kGpb; i += blockDim.x) s_tb[i] = tb[i];
  for (int i = threadIdx.x; i < kK * kGpb; i += blockDim.x) s_cnt[i] = 0;
  __syncthreads();
  const int i0 = blockIdx.x * iters_per_cta;
  const int i1 = min(iters, i0 + iters_per_cta);
  const PlaneTile<kTbBucketMajor> tile{s_tb};
  const CountTile<kCountBucketMajor> counts{s_cnt};
  for (int l = threadIdx.x; l < lanes; l += blockDim.x) {
    const LaneQuery lq = lane_query(q, lanes, l);
    for (int i = i0; i < i1; ++i) tile_lane(tile, counts, l, lq, i, 0);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < kK * kGpb; i += blockDim.x) {
    const unsigned int c = s_cnt[i];
    if (c) atomicAdd(&out[i], c);
  }
}

template <bool kTb, bool kCount>
cudaError_t launch(int grid, cudaStream_t stream, const void* tb, const void* q, void* out,
                   int iters, int iters_per_cta, int lanes) {
  r9_dot_orient_kernel<kTb, kCount><<<grid, kDotThreads, 0, stream>>>(
      static_cast<const uint16_t*>(tb), static_cast<const uint32_t*>(q),
      static_cast<unsigned int*>(out), iters, iters_per_cta, lanes);
  return cudaGetLastError();
}

}  // namespace

// out (the count tile, uint32, zeroed by the caller) += the counts of
// `iters` tiles; tb is the bf16 key tile, q uint32 (2, lanes), all on CUDA
// device `device`. layout bit 0: tb is (128, 64) bucket-major; bit 1: out
// is (128, 8) bucket-major. Launches ceil(iters / iters_per_cta) CTAs on
// `stream`, returns the launch's error code (0 on success) and does not
// synchronise.
extern "C" int r9_dot_orient_launch(const void* tb, const void* q, void* out, int iters,
                                    int iters_per_cta, int lanes, int layout, int device,
                                    void* stream) {
  if (iters < 1 || iters_per_cta < 1 || lanes < 1 || layout < 0 || layout > 3) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  const int grid = (iters - 1) / iters_per_cta + 1;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t rc;
  switch (layout) {
    case 0: rc = launch<false, false>(grid, s, tb, q, out, iters, iters_per_cta, lanes); break;
    case 1: rc = launch<true, false>(grid, s, tb, q, out, iters, iters_per_cta, lanes); break;
    case 2: rc = launch<false, true>(grid, s, tb, q, out, iters, iters_per_cta, lanes); break;
    default: rc = launch<true, true>(grid, s, tb, q, out, iters, iters_per_cta, lanes); break;
  }
  return static_cast<int>(rc);
}
