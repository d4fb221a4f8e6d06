// The tile body under its two MXU dot orientations (sm_90a).
//
// Replaces scripts/r9_dot_orient.py:make_kernel(variant).kernel, the Pallas
// kernel that runs the tile body ITERS times in one program on one bf16
// key tile of byte planes and one (2, lanes) query array: tile i looks at
// buckets (37 l + i) & 127, and the result is the count tile. Its variants
// differ in the orientation of the two dots, which here is the layout of
// the key tile and of the count tile in shared memory:
//
//   variant   key tile (tb)     count tile
//   old       (128, 64)         (128, 8)       both bucket-major
//   new       (64, 128)         (8, 128)
//   d1old     (128, 64)         (8, 128)
//   d2old     (64, 128)         (128, 8)
//
// The iterations are an order-free sum of integers, so they are spread over
// CTAs of iters_per_cta iterations each; a CTA counts into its own 4 KB count
// tile with shared atomics and adds each nonzero entry into the output with
// one global atomic. Each thread keeps a lane's query in registers across
// the CTA's iterations.
//
// The packed tile. A CTA first turns the bf16 tile into what the body
// compares: for each (key lane k, bucket b) the three float32 packs of its
// planes, in PlaneTile::packs' order and rounding, stored as canonical bits
// (x + 0.0f, so -0.0 becomes +0.0 and bits are equal exactly when the
// floats are), and for each bucket a fingerprint word of its 8 key lanes'
// packs (r9_tile.cuh); PackTile says where, in the key tile's orientation
// (bucket-major rows of 128 bytes, as the (128, 64) bf16 tile's, so a
// warp's fingerprint reads meet the one-bank conflict that old and d1old
// exist to show). A live lane then reads its bucket's fingerprint word and
// compares packs, one 16-byte read each, only in the key lanes whose
// fingerprint is its query's.
// A query's packs are integers below 2^24, never NaN, so a compare of
// canonical bits is the float compare of the twin on any tile; the Pallas
// kernel's one-hot dot spreads a NaN or an infinity over every lane, so the
// contract, and the twin's agreement with Pallas, covers finite tiles only.
//
// What bounds it: one shared read and a SWAR test a live lane-tile, then
// for each candidate (the hits and ~1/15 of the other key lanes) a 16-byte
// read, a branch-free compare and, on a hit, a shared atomic. A warp runs
// its candidate loop as often as its busiest lane has candidates;
// scripts/r9_dot_orient.py:candidate_loop counts both on any input.
//
// Bound with ctypes; see kmer_mapper_tpu_torch/native.py.

#include "r9_tile.cuh"

using namespace kmt_r9;

namespace {

constexpr int kDotThreads = 512;
// the packed tile, in words: 16 bytes a (key lane, bucket), and in the
// key-lane-major order a row of fingerprint words after them
constexpr int kTileWords = kK * kGpb * 4 + kGpb;
static_assert((kK * kGpb) % kDotThreads == 0, "the tile build runs whole warps");

// Where the packed tile keeps things: the 16 bytes of (key lane k, bucket
// b), its packs gp0, gp1, gp2 as canonical bits and a fourth word, at
// uint4 k*128 + b (key-lane-major), or b*8 + k (bucket-major: a bucket's
// row of 128 bytes, as in the (128, 64) bf16 tile); the fingerprint word
// of bucket b after the packs (key-lane-major), or in the fourth word of
// its key lane 0 (bucket-major: word b*32 + 3, one bank for every bucket).
template <bool kBucketMajorTile>
struct PackTile {
  __device__ __forceinline__ static int packs(int k, int b) {
    return kBucketMajorTile ? b * kK + k : k * kGpb + b;
  }

  __device__ __forceinline__ static int fingerprints(int b) {
    return kBucketMajorTile ? b * kK * 4 + 3 : kK * kGpb * 4 + b;
  }

  // Builds the tile from the bf16 tile tb (in the same orientation): thread
  // i takes (bucket i / 8, key lane i % 8), so a bucket's 8 key lanes are 8
  // neighbouring lanes of a warp, which OR their nibbles together.
  __device__ __forceinline__ static void build(const uint16_t* __restrict__ tb, uint32_t* tile) {
    const PlaneTile<kBucketMajorTile> planes{tb};
    uint4* entries = reinterpret_cast<uint4*>(tile);
    for (int i = threadIdx.x; i < kK * kGpb; i += blockDim.x) {
      const int b = i / kK, k = i % kK;
      float gp[kPacks];
      planes.packs(k, b, gp);
      uint4 e;
      e.x = __float_as_uint(__fadd_rn(gp[0], 0.0f));
      e.y = __float_as_uint(__fadd_rn(gp[1], 0.0f));
      e.z = __float_as_uint(__fadd_rn(gp[2], 0.0f));
      uint32_t word = fingerprint(e.x, e.y, e.z) << (4 * k);
#pragma unroll
      for (int d = 1; d < kK; d <<= 1) word |= __shfl_xor_sync(0xFFFFFFFFu, word, d);
      e.w = kBucketMajorTile && k == 0 ? word : 0u;
      entries[packs(k, b)] = e;
      if (!kBucketMajorTile && k == 0) tile[fingerprints(b)] = word;
    }
  }
};

template <bool kTbBucketMajor, bool kCountBucketMajor>
__global__ void __launch_bounds__(kDotThreads, 4)
r9_dot_orient_kernel(const uint16_t* __restrict__ tb, const uint32_t* __restrict__ q,
                     unsigned int* __restrict__ out, int iters, int iters_per_cta, int lanes) {
  using Tile = PackTile<kTbBucketMajor>;
  __shared__ __align__(16) uint32_t s_tile[kTileWords];
  __shared__ unsigned int s_cnt[kK * kGpb];
  Tile::build(tb, s_tile);
  for (int i = threadIdx.x; i < kK * kGpb; i += blockDim.x) s_cnt[i] = 0;
  __syncthreads();
  const uint4* entries = reinterpret_cast<const uint4*>(s_tile);
  const int i0 = blockIdx.x * iters_per_cta;
  const int i1 = min(iters, i0 + iters_per_cta);
  const CountTile<kCountBucketMajor> counts{s_cnt};
  for (int l = threadIdx.x; l < lanes; l += blockDim.x) {
    const LaneQuery lq = lane_query(q, lanes, l);
    const uint32_t p0 = __float_as_uint(lq.p0), p1 = __float_as_uint(lq.p1),
                   p2 = __float_as_uint(lq.p2);
    const uint32_t mine = fingerprint(p0, p1, p2) * kNibbles;
    for (int i = i0; i < i1; ++i) {
      if (!lane_live(l, i)) continue;
      const int b = lane_bucket(l, i, 0);
      for (uint32_t m = zero_nibbles(s_tile[Tile::fingerprints(b)] ^ mine); m; m &= m - 1) {
        const int k = candidate_lane(m);
        const uint4 e = entries[Tile::packs(k, b)];
        if ((e.x == p0) & (e.y == p1) & (e.z == p2)) counts.add(k, b);
      }
    }
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
