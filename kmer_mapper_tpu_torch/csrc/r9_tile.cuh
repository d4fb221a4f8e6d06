// The tile body of the r9 layout microbenchmarks (sm_90a), and what the
// three kernels that run it share: r9_dot_orient.cu, r9_step_parts.cu and
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
// layout of each tile in shared memory, which is what the variants measure.
//
// The tiles the three kernels read:
//
//   PlaneTile   bf16 byte planes: plane p of key lane k at bucket b is row
//               p*8+k, column b of a (64, 128) tile, or row b, column p*8+k
//               of a (128, 64) tile ("bucket-major"). packs gives the
//               float32 packing of a key lane's 8 planes, as the Pallas
//               kernel forms it: exact for byte values, the same float32
//               rounding for any finite tile. r9_dot_orient.cu builds its
//               packed tile from it once a CTA.
//   WordTile    packed words: the key tile is built from (lo, hi) words, so
//               its 8 planes are the words' bytes and a compare of the two
//               words is the same test. Word w (0 lo, 1 hi) of key lane k at
//               bucket b sits at (w*8 + k)*128 + b of its group (the 3-D
//               plane layout), or at b*16 + w*8 + k (the 2-D layout,
//               bucket-major).
//   CountTile   counts[k][b] at k*128 + b, or at b*8 + k (bucket-major).
//
// The three kernels count on a fingerprinted tile: one word a bucket holds
// a 4-bit fingerprint of each key lane (fingerprint, below), so a live lane
// reads that one word, finds with a SWAR test the key lanes whose
// fingerprint is its own, and reads key words only for those (the
// candidates), compared without a branch (WordTile::equal).
//
// What bounds that body: neither bytes nor operations at these sizes, but
// the shared-memory reads of the gather and a warp's candidate loop, which
// runs as often as its busiest lane has candidates. In a bucket-major tile
// the lanes of a warp, which look at 32 distinct buckets, read one column:
// a word row of 64 bytes puts that column in two banks, so each read is
// replayed 16 times. The bucket-minor tiles spread the column over the
// banks. The conflicts are kept: they are what the layout variants compare.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#include "async_copy.cuh"

namespace kmt_r9 {

using kmt_copy::aligned16;
using kmt_copy::cp_async16;

constexpr int kGpb = 128;                      // buckets of a key tile
constexpr int kK = 8;                          // key lanes of a bucket
constexpr int kPlanes = 8;                     // byte planes of a (lo, hi) key
constexpr int kW8 = kPlanes * kK;              // rows of a plane tile
constexpr int kPacks = 3;                      // float32 packs of a key's 8 planes
constexpr int kCoarse = 16;                    // key groups of a grid step
constexpr int kGroupSlots = kK * kGpb;         // count (and key word) slots of a group
constexpr int kGroupWords = 2 * kGroupSlots;   // lo and hi words of a group
constexpr int kStepSlots = kCoarse * kGroupSlots;  // slots of a step's block
constexpr int kStepThreads = 1024;
// shared memory of a step kernel: 16 groups of key words and of counts
constexpr size_t kStepShared = static_cast<size_t>(kCoarse) * (kGroupWords + kGroupSlots) *
                               sizeof(uint32_t);

// the variant flags of the step kernels (kmer_mapper_tpu_torch/scripts/
// r9_step_parts.py FLAGS and r9_block_pipeline.py FLAGS; r9_step_parts.cu
// takes the first four, r9_block_pipeline.cu kBucketMajor with kOwnBlocks)
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

constexpr uint32_t kNibbles = 0x11111111u;

// A key's 4-bit fingerprint, 1..15, from its words (a, b, c): the high bits
// of a multiplicative hash. No key lane has fingerprint 0: in the r9 tile
// body every (lo, hi), the all-ones pair included, is an ordinary key (the
// count tile of count_tile.cuh keeps 0 for its empty slots; r9 has none).
// Keys that compare equal must give equal words: the plane tile's packs are
// canonical float32 bits (-0.0 stored as +0.0).
__device__ __forceinline__ uint32_t fingerprint(uint32_t a, uint32_t b, uint32_t c = 0u) {
  return __umulhi(a * 0x9E3779B1u ^ b * 0x85EBCA77u ^ c * 0xC2B2AE3Du, 15u) + 1u;
}

// Bit 4k + 3 set where nibble k of x is 0 (no carry crosses a nibble): with
// x = bucket word ^ (the query's fingerprint * kNibbles), the key lanes
// whose fingerprint equals the query's, and no others.
__device__ __forceinline__ uint32_t zero_nibbles(uint32_t x) {
  return ~(((x & 0x77777777u) + 0x77777777u) | x) & 0x88888888u;
}

// The key lane of the lowest candidate bit of a zero_nibbles mask.
__device__ __forceinline__ int candidate_lane(uint32_t m) { return (__ffs(m) - 1) >> 2; }

template <bool kBucketMajorTile>
struct PlaneTile {
  const uint16_t* t;  // bf16 bits

  __device__ __forceinline__ float plane(int p, int k, int b) const {
    const int i = kBucketMajorTile ? b * kW8 + p * kK + k : (p * kK + k) * kGpb + b;
    return __uint_as_float(static_cast<uint32_t>(t[i]) << 16);
  }

  // The float32 packing of key lane k's planes at bucket b: gp0 = g0 +
  // 256 g1 + 65536 g2, gp1 = g3 + 256 g4 + 65536 g5, gp2 = g6 + 256 g7, in
  // the Pallas kernel's order and unfused. t may point to shared or device
  // memory.
  __device__ __forceinline__ void packs(int k, int b, float (&gp)[kPacks]) const {
    float g[kPlanes];
#pragma unroll
    for (int p = 0; p < kPlanes; ++p) g[p] = plane(p, k, b);
    gp[0] = __fadd_rn(__fadd_rn(g[0], __fmul_rn(256.0f, g[1])), __fmul_rn(65536.0f, g[2]));
    gp[1] = __fadd_rn(__fadd_rn(g[3], __fmul_rn(256.0f, g[4])), __fmul_rn(65536.0f, g[5]));
    gp[2] = __fadd_rn(g[6], __fmul_rn(256.0f, g[7]));
  }
};

template <bool kBucketMajorTile>
struct WordTile {
  const uint32_t* w;  // the group's first word

  __device__ __forceinline__ static int index(int word, int k, int b) {
    return kBucketMajorTile ? b * 2 * kK + word * kK + k : (word * kK + k) * kGpb + b;
  }

  // key lane k of bucket b equals the query, both words read and no
  // branch: a warp's candidate loop, whose lanes are mostly idle, then runs
  // no nested divergent branch
  __device__ __forceinline__ bool equal(int k, int b, const LaneQuery& q) const {
    return (w[index(0, k, b)] == q.lo) & (w[index(1, k, b)] == q.hi);
  }

  // The fingerprint word of bucket b: key lane k's fingerprint at bit 4k.
  // A bucket-major row (16 words, 16-byte aligned) is read in four 16-byte
  // reads: a warp's rows lie 64 bytes apart, so 4-way conflicts, not 16.
  __device__ __forceinline__ uint32_t fingerprints(int b) const {
    uint32_t words[2 * kK];  // lo of key lanes 0..7, then hi
    if constexpr (kBucketMajorTile) {
      const uint4* row = reinterpret_cast<const uint4*>(w + index(0, 0, b));
#pragma unroll
      for (int j = 0; j < kK / 2; ++j) {
        const uint4 v = row[j];
        words[4 * j] = v.x;
        words[4 * j + 1] = v.y;
        words[4 * j + 2] = v.z;
        words[4 * j + 3] = v.w;
      }
    } else {
#pragma unroll
      for (int k = 0; k < kK; ++k) {
        words[k] = w[index(0, k, b)];
        words[kK + k] = w[index(1, k, b)];
      }
    }
    uint32_t word = 0;
#pragma unroll
    for (int k = 0; k < kK; ++k) word |= fingerprint(words[k], words[kK + k]) << (4 * k);
    return word;
  }
};

template <bool kBucketMajorTile>
struct CountTile {
  unsigned int* c;  // the group's first count

  __device__ __forceinline__ void add(int k, int b) const {
    atomicAdd(c + (kBucketMajorTile ? b * kK + k : k * kGpb + b), 1u);
  }
};

// Checks the step kernels' launch arguments and selects the tensors' device.
inline cudaError_t check_steps(int n_steps, int n_tiles, int lanes, int n_ctas, int device) {
  if (n_steps < 1 || n_tiles < 0 || lanes < 1 || n_ctas < 1 || n_ctas > n_steps) {
    return cudaErrorInvalidValue;
  }
  return cudaSetDevice(device);
}

}  // namespace kmt_r9
