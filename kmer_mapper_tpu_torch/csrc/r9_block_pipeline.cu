// The grid step with its block movement (sm_90a).
//
// Replaces scripts/r9_block_pipeline.py:make_kernel(variant).kernel, the
// Pallas kernel that adds to r9_step_parts' step the movement of a block per
// grid step: step c reads groups 16c .. 16c+15 of the key and count arrays
// (8192 groups, 33.5 MB each) and writes its count block back, so the
// result is counts_in plus every step's tiles on its own block.
//
//   variant   layout
//   new       keys and counts (8192, 8, 128): the 3-D plane layout
//   old       keys and counts (1048576, 8): the 2-D layout, bucket-major
//
// Tile t of step c reads key group and count group g = (7 t + c) % 16 and
// nothing else, so a step is 16 independent units (c, j): group
// (7 j + c) % 16 with the tiles t = j, j + 16, ... (t = 16 and 17 revisit
// the groups of t = 0 and 1). The adds commute, so the kernel runs unit by
// unit, in any order, and gets the twin's bits. Persistent CTAs, one an SM,
// each take a contiguous run of the grid's 16 x n_steps units; a unit no
// tile reads still carries counts_in to counts_out.
//
// The movement runs beside the tiles: a unit's key group (8 KB) and count
// group (4 KB) land with 16-byte cp.async copies in a ring of stages, one
// phase of kPhaseUnits units ahead of the phase the CTA counts. Between
// two phases, with two CTA barriers, the CTA writes back the count groups
// of the phase it finished, builds the fingerprint words of the next (one
// word a bucket, r9_tile.cuh) and refills the stages it freed. Each thread
// keeps its lanes' queries and fingerprints in registers (lane
// lane0 + threadIdx.x + 1024 s for s < kLaneSlots), so a tile needs only
// its group's stage. More than kMaxLanes lanes run in passes of kMaxLanes:
// each pass streams the CTA's units again, the later ones from counts_out,
// which only this CTA writes for its units. The body is r9_step_parts.cu's: a live lane reads its
// bucket's fingerprint word and compares the key words of the candidate
// key lanes only. The bucket-major layout keeps its conflicts on the key
// words and the counts; its fingerprints are one word a (group, bucket).
//
// What bounds it: the tile body, as in r9_step_parts (the shared reads and
// each warp's candidate loop), with 134 MB of keys and counts moved beside
// it. 2 x kPhaseUnits stages of 12.5 KB each (175 KB). A warp
// queue that takes the warp's candidates 32 at a time, each one's owner
// lane found with shuffles, ran slower than this loop on an H100: the
// shuffles and the queries' loads cost more than the divergent trips they
// save.
//
// Bound with ctypes; see kmer_mapper_tpu_torch/native.py.

#include "r9_tile.cuh"

using namespace kmt_r9;

namespace {

constexpr int kLaneSlots = 8;  // lanes a thread keeps in registers
constexpr int kMaxLanes = kLaneSlots * kStepThreads;
constexpr int kFpOffset = kGroupWords + kGroupSlots;  // a stage: keys, counts, fingerprints
constexpr int kStageWords = kFpOffset + kGpb;
constexpr int kChunks = kGroupSlots / 4;  // 16-byte chunks of a group's slots
// units a phase: 1..8 fit; 7 was the fastest of them on an H100
constexpr int kPhaseUnits = 7;
constexpr int kRingBytes = 2 * kPhaseUnits * kStageWords * sizeof(uint32_t);
static_assert(kRingBytes <= 232448, "a CTA may use 227 KB of shared memory");

// The first slot of unit u's group: step c = u / 16's block, position j.
__device__ __forceinline__ int64_t unit_slot0(int64_t u) {
  const int64_t c = u / kCoarse;
  const int j = static_cast<int>(u % kCoarse);
  return (c * kCoarse + (7 * j + static_cast<int>(c % kCoarse)) % kCoarse) * kGroupSlots;
}

template <bool kBm>
struct Pipeline {
  uint32_t* smem;
  const uint32_t* __restrict__ key_lo;
  const uint32_t* __restrict__ key_hi;
  const uint32_t* counts_in;  // counts_out after the first pass
  uint32_t* counts_out;
  int64_t u0;  // the CTA's first unit
  int n;       // its units

  __device__ __forceinline__ uint32_t* stage(int i) const {
    return smem + (i % (2 * kPhaseUnits)) * kStageWords;
  }

  __device__ __forceinline__ int first(int p) const { return min(n, p * kPhaseUnits); }
  __device__ __forceinline__ int last(int p) const { return min(n, (p + 1) * kPhaseUnits); }

  // Phase p's key and count groups into their stages, one commit group
  // (empty past the last phase). Slot i of the group is (k, b) = (i / 128,
  // i % 128) in the 3-D layout, (b, k) = (i / 8, i % 8) in the 2-D one; its
  // lo and hi words go to the tile's order.
  __device__ __forceinline__ void fetch(int p) const {
    const int i0 = first(p);
    for (int x = threadIdx.x; x < (last(p) - i0) * kChunks; x += kStepThreads) {
      const int i = i0 + x / kChunks, slot = 4 * (x % kChunks);
      uint32_t* st = stage(i);
      const int64_t src = unit_slot0(u0 + i) + slot;
      const int lo = kBm ? (slot / kK) * 2 * kK + slot % kK : slot;
      cp_async16(st + lo, key_lo + src);
      cp_async16(st + lo + (kBm ? kK : kGroupSlots), key_hi + src);
      cp_async16(st + kGroupWords + slot, counts_in + src);
    }
    asm volatile("cp.async.commit_group;\n" ::);
  }

  __device__ __forceinline__ void fingerprints(int p) const {
    const int i0 = first(p);
    for (int x = threadIdx.x; x < (last(p) - i0) * kGpb; x += kStepThreads) {
      uint32_t* st = stage(i0 + x / kGpb);
      st[kFpOffset + x % kGpb] = WordTile<kBm>{st}.fingerprints(x % kGpb);
    }
  }

  __device__ __forceinline__ void write_back(int p) const {
    const int i0 = first(p);
    for (int x = threadIdx.x; x < (last(p) - i0) * kChunks; x += kStepThreads) {
      const int i = i0 + x / kChunks, slot = 4 * (x % kChunks);
      *reinterpret_cast<uint4*>(counts_out + unit_slot0(u0 + i) + slot) =
          *reinterpret_cast<const uint4*>(stage(i) + kGroupWords + slot);
    }
  }
};

template <bool kBm>
__global__ void __launch_bounds__(kStepThreads, 1)
r9_pipeline_kernel(const uint32_t* __restrict__ key_lo, const uint32_t* __restrict__ key_hi,
                   const uint32_t* counts_in, const uint32_t* __restrict__ q,
                   uint32_t* counts_out, int n_steps, int n_tiles, int lanes) {
  extern __shared__ __align__(16) uint32_t pipe_smem[];
  const int64_t n_units = static_cast<int64_t>(n_steps) * kCoarse;
  const int64_t u0 = n_units * blockIdx.x / gridDim.x;
  const int n = static_cast<int>(n_units * (blockIdx.x + 1) / gridDim.x - u0);
  const int n_phases = (n + kPhaseUnits - 1) / kPhaseUnits;

  for (int lane0 = 0; lane0 < lanes; lane0 += kMaxLanes) {
    // a pass after the first reads the counts the last one wrote back; the
    // barrier after its last write-back orders them
    const Pipeline<kBm> pipe{pipe_smem, key_lo, key_hi, lane0 ? counts_out : counts_in,
                             counts_out, u0, n};
    pipe.fetch(0);
    pipe.fetch(1);
    LaneQuery lq[kLaneSlots];
    uint32_t mine[kLaneSlots];
#pragma unroll
    for (int s = 0; s < kLaneSlots; ++s) {
      const int l = lane0 + threadIdx.x + s * kStepThreads;
      lq[s] = lane_query(q, lanes, l < lanes ? l : 0);
      mine[s] = fingerprint(lq[s].lo, lq[s].hi) * kNibbles;
    }
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    __syncthreads();
    pipe.fingerprints(0);
    __syncthreads();
    for (int p = 0; p < n_phases; ++p) {
      for (int i = pipe.first(p); i < pipe.last(p); ++i) {
        const int64_t u = u0 + i;
        const int c = static_cast<int>(u / kCoarse);
        uint32_t* st = pipe.stage(i);
        const WordTile<kBm> tile{st};
        const CountTile<kBm> counts{st + kGroupWords};
        const uint32_t* fp = st + kFpOffset;
        for (int t = static_cast<int>(u % kCoarse); t < n_tiles; t += kCoarse) {
#pragma unroll
          for (int s = 0; s < kLaneSlots; ++s) {
            const int l = lane0 + threadIdx.x + s * kStepThreads;
            if (l < lanes && lane_live(l, t)) {
              const int b = lane_bucket(l, t, c);
              for (uint32_t m = zero_nibbles(fp[b] ^ mine[s]); m; m &= m - 1) {
                const int k = candidate_lane(m);
                if (tile.equal(k, b, lq[s])) counts.add(k, b);
              }
            }
          }
        }
      }
      asm volatile("cp.async.wait_group 0;\n" ::: "memory");  // phase p + 1 landed
      __syncthreads();  // phase p counted
      pipe.write_back(p);
      pipe.fingerprints(p + 1);
      __syncthreads();  // phase p's stages free, its counts written back
      pipe.fetch(p + 2);
    }
  }
}

template <bool kBm>
cudaError_t launch(int n_ctas, cudaStream_t stream, const void* key_lo, const void* key_hi,
                   const void* counts_in, const void* q, void* counts_out, int n_steps,
                   int n_tiles, int lanes) {
  const cudaError_t attr = cudaFuncSetAttribute(
      r9_pipeline_kernel<kBm>, cudaFuncAttributeMaxDynamicSharedMemorySize, kRingBytes);
  if (attr != cudaSuccess) return attr;
  r9_pipeline_kernel<kBm><<<n_ctas, kStepThreads, kRingBytes, stream>>>(
      static_cast<const uint32_t*>(key_lo), static_cast<const uint32_t*>(key_hi),
      static_cast<const uint32_t*>(counts_in), static_cast<const uint32_t*>(q),
      static_cast<uint32_t*>(counts_out), n_steps, n_tiles, lanes);
  return cudaGetLastError();
}

}  // namespace

// counts_out = counts_in + every step's counts on its block. key_lo,
// key_hi, counts_in and counts_out are uint32 arrays of n_steps x 16 x 8 x
// 128 slots in the variant's layout, each starting on 16 bytes, q uint32
// (2, lanes), all on CUDA device `device`; n_ctas persistent CTAs (at most
// n_steps). variant 0 new, 1 old. Returns the launch's error code (0 on
// success) and does not synchronise.
extern "C" int r9_block_pipeline_launch(const void* key_lo, const void* key_hi,
                                        const void* counts_in, const void* q,
                                        void* counts_out, int n_steps, int n_tiles, int lanes,
                                        int n_ctas, int variant, int device, void* stream) {
  if (!(aligned16(key_lo) && aligned16(key_hi) && aligned16(counts_in) &&
        aligned16(counts_out))) {
    return static_cast<int>(cudaErrorMisalignedAddress);
  }
  const cudaError_t set = check_steps(n_steps, n_tiles, lanes, n_ctas, device);
  if (set != cudaSuccess) return static_cast<int>(set);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t rc;
  const auto args = [&](auto fn) {
    return fn(n_ctas, s, key_lo, key_hi, counts_in, q, counts_out, n_steps, n_tiles, lanes);
  };
  switch (variant) {
    case 0: rc = args(launch<false>); break;
    case 1: rc = args(launch<true>); break;
    default: rc = cudaErrorInvalidValue; break;
  }
  return static_cast<int>(rc);
}
