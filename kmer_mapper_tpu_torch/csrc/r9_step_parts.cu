// The parts of a grid step's overhead (sm_90a).
//
// Replaces scripts/r9_step_parts.py:make_kernel(variant).kernel, the Pallas
// kernel of GRID steps of TILES tiles each over one block of 16 key groups
// and their counts, with per-step key preparation and a counts
// read-modify-write per tile. Its keys and counts have a constant block
// index and counts_out is set to counts_in at every step, so the result is
// counts_in plus the LAST step's tiles; the earlier steps' work is done and
// dropped. Here r9_parts_kernel runs the steps on persistent CTAs, each
// step on its own staged copy of the block, and the earlier steps' counts
// go into a fold in a sink buffer.
//
//   variant    flags
//   newfull    the 3-D plane layout: keys and counts (16, 8, 128)
//   tbstatic   tiles read key group 0
//   rmwstatic  tiles add into count group 0
//   noprep     a CTA stages the keys and their fingerprints on its first
//              step only (the Pallas variant writes its key tile at grid
//              step 0 only)
//   oldfull    the 2-D layout: keys and counts (2048, 8), bucket-major
//
// The TPU stages the keys as bf16 byte planes, which for 16 groups would
// take 256 KB of shared memory, more than a CTA's 227 KB. The port stages
// them as packed (lo, hi) words, 128 KB (the keys are words, so a compare
// of the two words is the compare of the 8 planes), the 64 KB of counts
// and a fingerprint word per (group, bucket), 8 KB (r9_tile.cuh): 200 KB
// of dynamic shared memory, one CTA per SM.
//
// A step stages its counts, and its keys where the variant prepares them,
// with 16-byte cp.async copies, then builds the fingerprint words from the
// staged keys. In a tile a live lane reads its bucket's fingerprint word,
// finds the key lanes whose fingerprint is its query's with a SWAR test and
// reads their lo and hi words only, compared without a branch; the group
// and the bucket of a lane's next tile are one add and one mask away. The
// bucket-major layout keeps its conflicts on the key words and the counts;
// its fingerprints are one word a (group, bucket) as the plane layout's.
//
// What bounds it: the shared reads and the candidate loop of each warp,
// which runs as often as its busiest lane has candidates (the hits and
// ~1/15 of the other key lanes; scripts/r9_step_parts.py:candidate_loop
// counts both on any input); then the 512 steps over 132 SMs, 4 rounds.
//
// r9_block_pipeline.cu runs the same body over blocks of its own, one
// group at a time through a ring of stages.
//
// Bound with ctypes; see kmer_mapper_tpu_torch/native.py.

#include "r9_tile.cuh"

using namespace kmt_r9;

namespace {

constexpr int kFpWords = kCoarse * kGpb;  // a fingerprint word per (group, bucket)
constexpr size_t kPartsShared = kStepShared + kFpWords * sizeof(uint32_t);
static_assert(kPartsShared <= 232448, "a CTA may use 227 KB of shared memory");

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\n" ::);
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// The steps of r9_step_parts, F without kOwnBlocks: CTA j runs steps j,
// j + gridDim.x, ... Tile t of step c runs on key group g = (7 t + c) % 16
// and count group g (0 for kTbStatic, kRmwStatic); only the last step's
// counts reach counts_out.
template <int F>
__global__ void __launch_bounds__(kStepThreads, 1)
r9_parts_kernel(const uint32_t* __restrict__ key_lo, const uint32_t* __restrict__ key_hi,
                const uint32_t* __restrict__ counts_in, const uint32_t* __restrict__ q,
                uint32_t* __restrict__ counts_out, uint32_t* __restrict__ sink, int n_steps,
                int n_tiles, int lanes) {
  static_assert(!(F & kOwnBlocks), "r9_block_pipeline.cu runs the steps on blocks of their own");
  constexpr bool kBm = F & kBucketMajor;
  extern __shared__ __align__(16) uint32_t parts_smem[];
  uint32_t* s_keys = parts_smem;                          // [kCoarse][kGroupWords]
  unsigned int* s_cnt = parts_smem + kCoarse * kGroupWords;  // [kCoarse][kGroupSlots]
  uint32_t* s_fp = s_cnt + kCoarse * kGroupSlots;         // [kCoarse][kGpb]
  bool staged = false;
  for (int c = blockIdx.x; c < n_steps; c += gridDim.x) {
    const bool prep = !((F & kPrepOnce) && staged);
    // 4 slots a copy: slot i is (row, k) = (g*128 + b, k) in the 2-D layout,
    // (g, k, b) in the 3-D one; its lo and hi words go to the tile's order
    for (int i = 4 * threadIdx.x; i < kStepSlots; i += 4 * blockDim.x) {
      cp_async16(s_cnt + i, counts_in + i);
      if (prep) {
        const int lo = kBm ? (i / kK) * 2 * kK + i % kK
                           : (i / kGroupSlots) * kGroupWords + i % kGroupSlots;
        cp_async16(s_keys + lo, key_lo + i);
        cp_async16(s_keys + lo + (kBm ? kK : kGroupSlots), key_hi + i);
      }
    }
    cp_async_wait_all();
    __syncthreads();
    if (prep) {
      for (int r = threadIdx.x; r < kFpWords; r += blockDim.x) {
        const WordTile<kBm> tile{s_keys + (r / kGpb) * kGroupWords};
        s_fp[r] = tile.fingerprints(r % kGpb);
      }
      __syncthreads();
    }
    staged = true;
    for (int l = threadIdx.x; l < lanes; l += blockDim.x) {
      const LaneQuery lq = lane_query(q, lanes, l);
      const uint32_t mine = fingerprint(lq.lo, lq.hi) * kNibbles;
      int g = c % kCoarse, b = lane_bucket(l, 0, c);  // tile t's: (7 t + c) % 16, bp
      for (int t = 0; t < n_tiles; ++t) {
        if (lane_live(l, t)) {
          const int g_tb = (F & kTbStatic) ? 0 : g;
          const WordTile<kBm> tile{s_keys + g_tb * kGroupWords};
          const CountTile<kBm> counts{s_cnt + ((F & kRmwStatic) ? 0 : g) * kGroupSlots};
          for (uint32_t m = zero_nibbles(s_fp[g_tb * kGpb + b] ^ mine); m; m &= m - 1) {
            const int k = candidate_lane(m);
            if (tile.equal(k, b, lq)) counts.add(k, b);
          }
        }
        g = (g + 7) & (kCoarse - 1);
        b = (b + 1) & (kGpb - 1);
      }
    }
    __syncthreads();
    if (c == n_steps - 1) {
      const uint4* src = reinterpret_cast<const uint4*>(s_cnt);
      uint4* dst = reinterpret_cast<uint4*>(counts_out);
      for (int i = threadIdx.x; i < kStepSlots / 4; i += blockDim.x) dst[i] = src[i];
    } else {
      uint32_t fold = 0;
      for (int i = threadIdx.x; i < kStepSlots; i += blockDim.x) fold = fold * 31u + s_cnt[i];
      sink[blockIdx.x * blockDim.x + threadIdx.x] = fold;
    }
    __syncthreads();  // the next step restages the tiles
  }
}

template <int F>
cudaError_t launch_parts(int n_ctas, cudaStream_t stream, const void* key_lo,
                         const void* key_hi, const void* counts_in, const void* q,
                         void* counts_out, void* sink, int n_steps, int n_tiles, int lanes) {
  const cudaError_t attr = cudaFuncSetAttribute(
      r9_parts_kernel<F>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kPartsShared));
  if (attr != cudaSuccess) return attr;
  r9_parts_kernel<F><<<n_ctas, kStepThreads, kPartsShared, stream>>>(
      static_cast<const uint32_t*>(key_lo), static_cast<const uint32_t*>(key_hi),
      static_cast<const uint32_t*>(counts_in), static_cast<const uint32_t*>(q),
      static_cast<uint32_t*>(counts_out), static_cast<uint32_t*>(sink), n_steps, n_tiles,
      lanes);
  return cudaGetLastError();
}

}  // namespace

// counts_out = counts_in + the last step's counts. key_lo, key_hi,
// counts_in and counts_out are uint32 blocks of 16 x 8 x 128 slots in the
// variant's layout, each starting on 16 bytes, q uint32 (2, lanes), sink
// uint32[n_ctas * 1024], all on CUDA device `device`. variant 0..4 as
// above. Returns the launch's error code (0 on success) and does not
// synchronise.
extern "C" int r9_step_parts_launch(const void* key_lo, const void* key_hi,
                                    const void* counts_in, const void* q, void* counts_out,
                                    void* sink, int n_steps, int n_tiles, int lanes,
                                    int n_ctas, int variant, int device, void* stream) {
  if (!(aligned16(key_lo) && aligned16(key_hi) && aligned16(counts_in) &&
        aligned16(counts_out))) {
    return static_cast<int>(cudaErrorMisalignedAddress);
  }
  const cudaError_t set = check_steps(n_steps, n_tiles, lanes, n_ctas, device);
  if (set != cudaSuccess) return static_cast<int>(set);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto args = [&](auto launch) {
    return launch(n_ctas, s, key_lo, key_hi, counts_in, q, counts_out, sink, n_steps,
                  n_tiles, lanes);
  };
  cudaError_t rc;
  switch (variant) {
    case 0: rc = args(launch_parts<0>); break;
    case 1: rc = args(launch_parts<kTbStatic>); break;
    case 2: rc = args(launch_parts<kRmwStatic>); break;
    case 3: rc = args(launch_parts<kPrepOnce>); break;
    case 4: rc = args(launch_parts<kBucketMajor>); break;
    default: rc = cudaErrorInvalidValue; break;
  }
  return static_cast<int>(rc);
}
