// The tile body of the r9 layout microbenchmarks, one copy for the three
// kernels that run it (sm_90a): r9_dot_orient.cu, r9_step_parts.cu and
// r9_block_pipeline.cu replace scripts/r9_dot_orient.py:make_kernel,
// scripts/r9_step_parts.py:make_kernel and
// scripts/r9_block_pipeline.py:make_kernel. Their plain twins are in
// kmer_mapper_tpu_torch/scripts/r9_*.py.
//
// The body takes a tile index t and a step id c. For each query lane
// l < lanes, the lane looks at bucket bp = (37 l + t + c) & 127 and is live
// when l >= (t & 63). A live lane hits key lane k when key k of bucket bp
// equals the lane's (lo, hi) query, and each hit adds one to counts[k][bp].
// The Pallas kernels gather the keys with a one-hot bf16 matmul over byte
// planes; here a lane reads its bucket's keys from shared memory, so the
// matmul and its 128x7168 one-hot have no counterpart. What stays is the
// layout of each tile in shared memory, which is what the variants measure:
//
//   PlaneTile   bf16 byte planes (r9_dot_orient): plane p of key lane k at
//               bucket b is row p*8+k, column b of a (64, 128) tile, or
//               row b, column p*8+k of a (128, 64) tile ("bucket-major").
//               A lane compares the float32 packing of the 8 planes with
//               its query's, as the Pallas kernel does: exact for byte
//               values, the same float32 rounding for any finite tile.
//   WordTile    packed words (r9_step_parts, r9_block_pipeline): the key
//               tile is built from (lo, hi) words, so its 8 planes are the
//               words' bytes and a compare of the two words is the same
//               test. Word w (0 lo, 1 hi) of key lane k at bucket b sits at
//               (w*8 + k)*128 + b of its group (the 3-D plane layout), or
//               at b*16 + w*8 + k (the 2-D layout, bucket-major).
//   CountTile   counts[k][b] at k*128 + b, or at b*8 + k (bucket-major).
//
// What bounds it: neither bytes nor operations at these sizes, but the
// shared-memory reads of the gather. In a bucket-major tile the lanes of a
// warp, which look at 32 distinct buckets, read one column: a bf16 row of
// 128 bytes (or a word row of 64 bytes) puts that column in one bank (or
// two), so each read is replayed 32 (or 16) times. The bucket-minor tiles
// spread the column over the banks. The conflicts are kept: they are what
// the layout variants compare.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace kmt_r9 {

constexpr int kGpb = 128;                      // buckets of a key tile
constexpr int kK = 8;                          // key lanes of a bucket
constexpr int kPlanes = 8;                     // byte planes of a (lo, hi) key
constexpr int kW8 = kPlanes * kK;              // rows of a plane tile
constexpr int kCoarse = 16;                    // key groups of a grid step
constexpr int kGroupSlots = kK * kGpb;         // count (and key word) slots of a group
constexpr int kGroupWords = 2 * kGroupSlots;   // lo and hi words of a group
constexpr int kStepSlots = kCoarse * kGroupSlots;  // slots of a step's block
constexpr int kStepThreads = 1024;
// shared memory of a step kernel: 16 groups of key words and of counts
constexpr size_t kStepShared = static_cast<size_t>(kCoarse) * (kGroupWords + kGroupSlots) *
                               sizeof(uint32_t);

// the variant flags of the step kernels (kmer_mapper_tpu_torch/scripts/
// r9_step_parts.py FLAGS and r9_block_pipeline.py FLAGS)
enum StepFlags : int {
  kBucketMajor = 1,  // the 2-D layout: keys (groups*128, 8), counts the same
  kTbStatic = 2,     // every tile reads key group 0
  kRmwStatic = 4,    // every tile adds into count group 0
  kPrepOnce = 8,     // a CTA stages the keys on its first step only
  kOwnBlocks = 16,   // step c reads and writes its own block of 16 groups
};

// A query lane: its two words and the float32 packing of their bytes.
struct LaneQuery {
  uint32_t lo, hi;
  float p0, p1, p2;
};

__device__ __forceinline__ LaneQuery lane_query(const uint32_t* __restrict__ q, int lanes,
                                                int l) {
  LaneQuery r;
  r.lo = __ldg(q + l);
  r.hi = __ldg(q + lanes + l);
  // each below 2^24: exact in float32
  r.p0 = static_cast<float>(r.lo & 0xFFFFFFu);
  r.p1 = static_cast<float>((r.lo >> 24) | ((r.hi & 0xFFFFu) << 8));
  r.p2 = static_cast<float>(r.hi >> 16);
  return r;
}

// (37 l + t + c) & 127 in wrapping 32-bit arithmetic, as the int32 iota
__device__ __forceinline__ int lane_bucket(int l, int t, int c) {
  return static_cast<int>((static_cast<uint32_t>(l) * 37u + static_cast<uint32_t>(t) +
                           static_cast<uint32_t>(c)) & (kGpb - 1));
}

__device__ __forceinline__ bool lane_live(int l, int t) { return l >= (t & 63); }

template <bool kBucketMajorTile>
struct PlaneTile {
  const uint16_t* t;  // bf16 bits

  __device__ __forceinline__ float plane(int p, int k, int b) const {
    const int i = kBucketMajorTile ? b * kW8 + p * kK + k : (p * kK + k) * kGpb + b;
    return __uint_as_float(static_cast<uint32_t>(t[i]) << 16);
  }

  // gp0 = g0 + 256 g1 + 65536 g2, gp1 = g3 + 256 g4 + 65536 g5,
  // gp2 = g6 + 256 g7 in float32, in the Pallas kernel's order and unfused
  __device__ __forceinline__ bool match(int k, int b, const LaneQuery& q) const {
    float g[kPlanes];
#pragma unroll
    for (int p = 0; p < kPlanes; ++p) g[p] = plane(p, k, b);
    const float gp0 = __fadd_rn(__fadd_rn(g[0], __fmul_rn(256.0f, g[1])), __fmul_rn(65536.0f, g[2]));
    const float gp1 = __fadd_rn(__fadd_rn(g[3], __fmul_rn(256.0f, g[4])), __fmul_rn(65536.0f, g[5]));
    const float gp2 = __fadd_rn(g[6], __fmul_rn(256.0f, g[7]));
    return gp0 == q.p0 && gp1 == q.p1 && gp2 == q.p2;
  }
};

template <bool kBucketMajorTile>
struct WordTile {
  const uint32_t* w;  // the group's first word

  __device__ __forceinline__ static int index(int word, int k, int b) {
    return kBucketMajorTile ? b * 2 * kK + word * kK + k : (word * kK + k) * kGpb + b;
  }

  __device__ __forceinline__ bool match(int k, int b, const LaneQuery& q) const {
    return w[index(0, k, b)] == q.lo && w[index(1, k, b)] == q.hi;
  }
};

template <bool kBucketMajorTile>
struct CountTile {
  unsigned int* c;  // the group's first count

  __device__ __forceinline__ void add(int k, int b) const {
    atomicAdd(c + (kBucketMajorTile ? b * kK + k : k * kGpb + b), 1u);
  }
};

// The tile body for one lane of tile t at step c.
template <class Tile, class Counts>
__device__ __forceinline__ void tile_lane(const Tile& tile, const Counts& counts, int l,
                                          const LaneQuery& q, int t, int c) {
  if (!lane_live(l, t)) return;
  const int b = lane_bucket(l, t, c);
#pragma unroll
  for (int k = 0; k < kK; ++k) {
    if (tile.match(k, b, q)) counts.add(k, b);
  }
}

// Checks the step kernels' launch arguments and selects the tensors' device.
inline cudaError_t check_steps(int n_steps, int n_tiles, int lanes, int n_ctas, int device) {
  if (n_steps < 1 || n_tiles < 0 || lanes < 1 || n_ctas < 1 || n_ctas > n_steps) {
    return cudaErrorInvalidValue;
  }
  return cudaSetDevice(device);
}

}  // namespace kmt_r9

// Internal linkage: each source that launches a kernel has its own copy (a
// top-level unnamed namespace, as in block_count.cuh).
namespace {

using namespace kmt_r9;

// The grid steps of r9_step_parts (F without kOwnBlocks) and
// r9_block_pipeline (F with kOwnBlocks) on persistent CTAs: CTA j runs
// steps j, j + gridDim.x, ... One step stages its block's counts and (each
// step, or with kPrepOnce the CTA's first only) its 16 key groups into
// shared memory in the layout's order, runs n_tiles tiles, tile t on key
// group g = (7 t + c) % 16 and count group g (0 for kTbStatic, kRmwStatic),
// and writes its counts out. Without kOwnBlocks every step starts again
// from counts_in (the Pallas kernel copies counts_in into counts_out at
// every step under a constant block index), so only the last step's counts
// reach counts_out; the others go into a data-dependent fold in `sink`,
// which keeps their work.
template <int F>
__global__ void __launch_bounds__(kStepThreads)
r9_steps_kernel(const uint32_t* __restrict__ key_lo, const uint32_t* __restrict__ key_hi,
                const uint32_t* __restrict__ counts_in, const uint32_t* __restrict__ q,
                uint32_t* __restrict__ counts_out, uint32_t* __restrict__ sink,
                int n_steps, int n_tiles, int lanes) {
  constexpr bool kBm = F & kBucketMajor;
  extern __shared__ uint32_t smem[];
  uint32_t* s_keys = smem;                         // [kCoarse][kGroupWords]
  unsigned int* s_cnt = smem + kCoarse * kGroupWords;  // [kCoarse][kGroupSlots]
  bool staged = false;
  for (int c = blockIdx.x; c < n_steps; c += gridDim.x) {
    const int64_t block0 = (F & kOwnBlocks) ? static_cast<int64_t>(c) * kStepSlots : 0;
    const bool prep = !((F & kPrepOnce) && staged);
    for (int i = threadIdx.x; i < kStepSlots; i += blockDim.x) {
      s_cnt[i] = counts_in[block0 + i];
      if (prep) {
        // slot i is (row, k) = (g*128 + b, k) in the 2-D layout, (g, k, b)
        // in the 3-D one; its lo and hi words go to the tile's order
        const int lo = kBm ? (i / kK) * 2 * kK + i % kK
                           : (i / kGroupSlots) * kGroupWords + i % kGroupSlots;
        const int hi = lo + (kBm ? kK : kGroupSlots);
        s_keys[lo] = key_lo[block0 + i];
        s_keys[hi] = key_hi[block0 + i];
      }
    }
    staged = true;
    __syncthreads();
    for (int l = threadIdx.x; l < lanes; l += blockDim.x) {
      const LaneQuery lq = lane_query(q, lanes, l);
      for (int t = 0; t < n_tiles; ++t) {
        const int g = (t * 7 + c) % kCoarse;
        const WordTile<kBm> tile{s_keys + ((F & kTbStatic) ? 0 : g) * kGroupWords};
        const CountTile<kBm> counts{s_cnt + ((F & kRmwStatic) ? 0 : g) * kGroupSlots};
        tile_lane(tile, counts, l, lq, t, c);
      }
    }
    __syncthreads();
    if ((F & kOwnBlocks) || c == n_steps - 1) {
      for (int i = threadIdx.x; i < kStepSlots; i += blockDim.x) {
        counts_out[block0 + i] = s_cnt[i];
      }
    } else {
      uint32_t fold = 0;
      for (int i = threadIdx.x; i < kStepSlots; i += blockDim.x) fold = fold * 31u + s_cnt[i];
      sink[blockIdx.x * blockDim.x + threadIdx.x] = fold;
    }
    __syncthreads();  // the next step restages the tiles
  }
}

template <int F>
cudaError_t launch_steps(int n_ctas, cudaStream_t stream, const void* key_lo,
                         const void* key_hi, const void* counts_in, const void* q,
                         void* counts_out, void* sink, int n_steps, int n_tiles, int lanes) {
  const cudaError_t attr = cudaFuncSetAttribute(
      r9_steps_kernel<F>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kStepShared));
  if (attr != cudaSuccess) return attr;
  r9_steps_kernel<F><<<n_ctas, kStepThreads, kStepShared, stream>>>(
      static_cast<const uint32_t*>(key_lo), static_cast<const uint32_t*>(key_hi),
      static_cast<const uint32_t*>(counts_in), static_cast<const uint32_t*>(q),
      static_cast<uint32_t*>(counts_out), static_cast<uint32_t*>(sink), n_steps, n_tiles,
      lanes);
  return cudaGetLastError();
}

}  // namespace
