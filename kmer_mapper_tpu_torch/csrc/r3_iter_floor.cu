// The floor of one tile iteration, piece by piece, over the whole card
// (sm_90a).
//
// Replaces scripts/r3_iter_floor.py:make_variant(v).kernel, the Pallas
// kernel that runs N_ITER iterations of the stream count's tile loop with
// parts added one at a time, to find what one iteration costs. Iteration t
// reads the scalars a = off[t % 8192] and b = off[8192 + t % 8192] and the
// (4, cap) query tile at column (t % 64) * cap:
//
//   loop   carry += t                        (the loop alone)
//   smem   carry += a + b
//   vmem   smem + acc[lane] += float(q0) of tile t % 4 (tile w in slot w, a
//          stand-in for the TPU's never-written scratch)
//   dma    smem + the (4, cap) tiles copied into shared memory;
//          acc[lane] += float(q0) of tile t % 64, in t order
//   mm     full's tile compute on the vmem stand-in, no copies
//   full   dma's copies + the tile compute: a lane is live if its position
//          lies in [a, a + cap) and local_b = q0 - b % 997 lies in [0, 128);
//          a live lane hits key lane k when all 8 bytes of (q1, q2) equal
//          bf16(tb[local_b, p * 8 + k]); hits count in acc[local_b, k]
//   grid   n_grid CTAs with a one-iteration loop, each adding its carry (0)
//          into row 0 of the zeroed output: the launch floor
//
// Output f32 (128, 8): row 0 = float(int32 carry); rows 1..127 = acc rows
// 0..126 (the count tile for mm and full, lane 0..7 sums for vmem and dma).
//
// How the card shares the loop. The carry (a uint32 sum that wraps) and the
// hit counts (integers) do not depend on the order of the iterations, so
// CTAs add their parts into a uint32 scratch (shared memory first, then one
// global atomic per nonzero entry); the last CTA to finish, found with a
// ticket, converts the scratch to f32 once. Tile t sits at column t % 64,
// so the 16,384 iterations read 64 distinct tiles: for loop, smem, mm and
// full, CTA (j, s, p) takes part p of kParts of the iterations t = j
// (mod 64) and lanes [s * L, (s + 1) * L) of tile j, stages its rows once
// (full: one 16-byte cp.async a thread) and loops over those iterations, a
// and b % 997 read from shared memory, 8 at a time before their steps (at
// cap 1,024: 512 CTAs of 8 warps, ~31 warps an SM; 2 parts were the
// fastest of 1, 2, 4, 8 on the H100). A lane's hits depend on t only through a
// and local_b: it keeps the hit mask of its last local_b and a run count,
// and adds the run into the shared count tile when local_b changes or the
// loop ends.
// vmem and dma cannot share out the loop: row 1 is the f32 sum of float(q0)
// for lanes 0..7 taken in t order, and any split of t rounds differently.
// Each lane stays one serial chain of n_iter dependent adds over its 64 (4)
// values held in registers, one warp a CTA; its floor is n_iter FADD
// latencies, ~33 us for 16,384 at 1.98 GHz. dma copies its lanes of the 64
// tiles (all 4 rows) with 16-byte cp.async first.
//
// The TPU's byte-plane matmul has no counterpart: the staged key tile holds
// each key lane's 8 planes as two packed words (when all 8 are bytes), so a
// lane compares 2 words per key lane. The asm barrier on the carry keeps
// the loop variants from being folded.
//
// Bound with ctypes; see kmer_mapper_tpu_torch/native.py.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "async_copy.cuh"

namespace {

using kmt_copy::aligned16;
using kmt_copy::cp_async16;

constexpr int kSlots = 4;      // vmem's and mm's stand-in tiles
constexpr int kRows = 4;       // rows of a query tile: bucket, lo, hi, hi
constexpr int kBpb = 128;      // rows of the key and count tiles
constexpr int kK = 8;          // key lanes
constexpr int kPlanes = 8;     // byte planes of a (lo, hi) pair
constexpr int kOffHalf = 8192; // a = off[t % 8192], b = off[8192 + t % 8192]
constexpr int kMod = 997;
constexpr int kTiles = 64;     // tile t sits at column (t % 64) * cap
constexpr int kMaxCap = 1024;
constexpr int kLanes = 256;    // most lanes of a tiled CTA
constexpr int kWarp = 32;      // lanes of a chain CTA
constexpr int kParts = 2;      // CTAs that share one tile's iterations
// a row of the staged keys: 8 packed words, then a mask of the lanes whose
// 8 planes are all bytes
constexpr int kKeyStride = kK + 1;
constexpr uint32_t kNone = 0xFFFFFFFFu;  // no local_b yet
// the scratch, uint32 zeroed by the caller: the count tile (or lane 0..7
// sums' bits), the carry, the ticket
constexpr int kCarry = kBpb * kK;
constexpr int kTicket = kCarry + 1;

enum Variant : int { kLoop = 0, kSmem = 1, kVmem = 2, kDma = 3, kMm = 4, kFull = 5, kGrid = 6 };

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\n" ::);
  asm volatile("cp.async.wait_all;\n" ::);
}

// Adds this thread's carry part into the scratch, then the last CTA of the
// grid writes out: row 0 = float(int32 carry), rows 1..127 the count tile
// (mm, full) or lane 0..7's sum bits (vmem, dma) in row 1, else zeros.
template <int V>
__device__ void finish(uint32_t carry, uint32_t* __restrict__ scratch, float* __restrict__ out) {
  __shared__ bool last;
  const uint32_t sum = __reduce_add_sync(~0u, carry);
  if ((threadIdx.x & 31) == 0 && sum) atomicAdd(&scratch[kCarry], sum);
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    last = atomicAdd(&scratch[kTicket], 1u) == gridDim.x * gridDim.y * gridDim.z - 1;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  const float total = static_cast<float>(static_cast<int32_t>(__ldcg(&scratch[kCarry])));
  for (int i = threadIdx.x; i < kBpb * kK; i += blockDim.x) {
    float v = 0.0f;
    if (i < kK) {
      v = total;
    } else if (V == kMm || V == kFull) {
      v = static_cast<float>(__ldcg(&scratch[i - kK]));
    } else if ((V == kVmem || V == kDma) && i < 2 * kK) {
      v = __uint_as_float(__ldcg(&scratch[i - kK]));
    }
    out[i] = v;
  }
}

// The hit mask of a query lane (q1, q2) in key row r.
__device__ __forceinline__ uint32_t hit_mask(const uint32_t* s_klo, const uint32_t* s_khi,
                                             uint32_t r, uint32_t q1, uint32_t q2) {
  const uint32_t* row_lo = s_klo + r * kKeyStride;
  const uint32_t* row_hi = s_khi + r * kKeyStride;
  const uint32_t bytes = row_lo[kK];
  uint32_t mask = 0;
#pragma unroll
  for (int k = 0; k < kK; ++k) {
    if (((bytes >> k) & 1u) && row_lo[k] == q1 && row_hi[k] == q2) mask |= 1u << k;
  }
  return mask;
}

__device__ __forceinline__ void add_run(unsigned int* s_cnt, uint32_t r, uint32_t mask,
                                        uint32_t n) {
  for (; mask; mask &= mask - 1) atomicAdd(&s_cnt[r * kK + __ffs(mask) - 1], n);
}

// loop, smem, mm, full: CTA (j, s, p) of a (64, cap / L, kParts) grid, L
// threads: tile j's lanes [s * L, (s + 1) * L), part p of its iterations.
template <int V>
__global__ void __launch_bounds__(kLanes)
r3_tiled_kernel(const int32_t* __restrict__ off, const float* __restrict__ tb,
                const uint32_t* __restrict__ q, float* __restrict__ out,
                uint32_t* __restrict__ scratch, int n_iter, int cap) {
  constexpr bool kCompute = V == kMm || V == kFull;
  constexpr int kUnroll = 8;
  __shared__ __align__(16) uint32_t s_tile[kRows * kLanes];
  __shared__ uint32_t s_klo[kBpb * kKeyStride];
  __shared__ uint32_t s_khi[kBpb * kKeyStride];
  __shared__ unsigned int s_cnt[kBpb * kK];
  __shared__ __align__(16) int2 s_ab[kLanes];  // (a, b % 997) of a chunk of iterations
  const int j = blockIdx.x;
  const int n_lanes = blockDim.x;
  const int x = threadIdx.x;
  const int lane = blockIdx.y * n_lanes + x;
  // tile j's iterations t = j + 64 i, i < n_j; this CTA's part [i0, i1)
  const int n_j = n_iter > j ? (n_iter - 1 - j) / kTiles + 1 : 0;
  const int i0 = static_cast<int>(static_cast<int64_t>(n_j) * blockIdx.z / gridDim.z);
  const int i1 = static_cast<int>(static_cast<int64_t>(n_j) * (blockIdx.z + 1) / gridDim.z);
  const int n_t = i1 - i0;
  // the carry is counted by the CTAs of lane group 0; mm and full need all
  const bool active = n_t > 0 && (kCompute || blockIdx.y == 0);
  uint32_t carry = 0;

  uint32_t q0 = 0, q1 = 0, q2 = 0;
  if (kCompute && active) {
    const int64_t q_stride = static_cast<int64_t>(kTiles) * cap;
    if (V == kFull) {  // this CTA's lanes of tile j, all 4 rows, 16 bytes a thread
      const int per_row = n_lanes / 4;
      const int r = x / per_row, c = (x % per_row) * 4;
      cp_async16(s_tile + r * n_lanes + c, q + r * q_stride + j * cap + blockIdx.y * n_lanes + c);
    }
    // A key lane hits when each of its 8 planes, rounded to bf16, equals a
    // byte of the query. Where all 8 are bytes that is a compare of packed
    // words; a lane with another value can never hit (-0.0 counts as 0).
    for (int r = x; r < kBpb; r += n_lanes) s_klo[r * kKeyStride + kK] = 0;
    __syncthreads();
    for (int i = x; i < kBpb * kK; i += n_lanes) {
      const int r = i / kK, k = i % kK;
      uint32_t words[2] = {0, 0};
      bool bytes = true;
      for (int p = 0; p < kPlanes; ++p) {
        const float v = __bfloat162float(__float2bfloat16_rn(tb[r * kPlanes * kK + p * kK + k]));
        bytes = bytes && v >= 0.0f && v <= 255.0f && v == floorf(v);
        words[p / 4] |= (bytes ? static_cast<uint32_t>(v) : 0u) << (8 * (p % 4));
      }
      s_klo[r * kKeyStride + k] = words[0];
      s_khi[r * kKeyStride + k] = words[1];
      s_cnt[i] = 0;
      if (bytes) atomicOr(&s_klo[r * kKeyStride + kK], 1u << k);
    }
    if (V == kFull) {
      cp_async_wait_all();
      __syncthreads();
      q0 = s_tile[x], q1 = s_tile[n_lanes + x], q2 = s_tile[2 * n_lanes + x];
    } else {  // the stand-in: tile j % 4 in place of tile j
      const int col = (j % kSlots) * cap + lane;
      q0 = q[col], q1 = q[q_stride + col], q2 = q[2 * q_stride + col];
    }
  }

  const uint32_t pos = static_cast<uint32_t>(j * cap + lane);
  uint32_t run_b = kNone, mask = 0, run = 0;
  // one iteration of this lane: in [a, a + cap) and in [0, 128), as
  // differences that cannot wrap past their range (pos < 2^16, q0 an
  // int32, b % 997 in [0, 997))
  const auto step = [&](int2 ab) {
    const uint32_t local_b = q0 - static_cast<uint32_t>(ab.y);
    const bool live = pos - static_cast<uint32_t>(ab.x) < static_cast<uint32_t>(cap) &&
                      local_b < kBpb;
    if (live && local_b != run_b) {
      if (run_b != kNone) add_run(s_cnt, run_b, mask, run);
      run_b = local_b;
      mask = hit_mask(s_klo, s_khi, local_b, q1, q2);
      run = 0;
    }
    run += live;
  };
  for (int base = 0; active && base < n_t; base += n_lanes) {
    const int m = min(n_lanes, n_t - base);
    if (x < m) {
      const int t = j + kTiles * (i0 + base + x);
      if (V == kLoop) {
        carry += static_cast<uint32_t>(t);
        asm volatile("" : "+r"(carry));  // no closed form: one add per iteration
      } else {
        const int a = __ldg(off + (t % kOffHalf));
        const int b = __ldg(off + kOffHalf + (t % kOffHalf));
        if (blockIdx.y == 0) carry += static_cast<uint32_t>(a) + static_cast<uint32_t>(b);
        if (kCompute) {
          int bmod = b % kMod;  // floor modulo, as jnp's %
          if (bmod < 0) bmod += kMod;
          s_ab[x] = make_int2(a, bmod);
        }
      }
    }
    if (kCompute) {
      __syncthreads();
      int i = 0;
      for (; i + kUnroll <= m; i += kUnroll) {  // the loads first, then the steps
        int2 ab[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) ab[u] = s_ab[i + u];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) step(ab[u]);
      }
      for (; i < m; ++i) step(s_ab[i]);
      __syncthreads();
    }
  }
  if (kCompute && active) {
    if (run_b != kNone) add_run(s_cnt, run_b, mask, run);
    __syncthreads();
    for (int i = x; i < (kBpb - 1) * kK; i += n_lanes) {
      const unsigned int c = s_cnt[i];
      if (c) atomicAdd(&scratch[i], c);
    }
  }
  finish<V>(carry, scratch, out);
}

// vmem, dma: one warp a CTA, lanes [32 c, 32 c + 32); each lane one serial
// chain of n_iter adds. The carry's iterations spread over all lanes.
template <int V>
__global__ void __launch_bounds__(kWarp)
r3_chain_kernel(const int32_t* __restrict__ off, const uint32_t* __restrict__ q,
                float* __restrict__ out, float* __restrict__ sink,
                uint32_t* __restrict__ scratch, int n_iter, int cap) {
  constexpr int kPeriod = V == kDma ? kTiles : kSlots;
  __shared__ __align__(16) uint32_t s_tiles[V == kDma ? kTiles * kRows * kWarp : 1];
  const int lane = blockIdx.x * kWarp + threadIdx.x;
  uint32_t carry = 0;
  for (int t = lane; t < n_iter; t += cap) {
    carry += static_cast<uint32_t>(__ldg(off + (t % kOffHalf)));
    carry += static_cast<uint32_t>(__ldg(off + kOffHalf + (t % kOffHalf)));
  }
  const int64_t q_stride = static_cast<int64_t>(kTiles) * cap;
  float v[kPeriod];
  if (V == kDma) {
    // this warp's 32 lanes of each tile the loop reads, all 4 rows: 8
    // chunks of 16 bytes a row
    const int n_tiles = min(n_iter, kTiles);
    for (int c = threadIdx.x; c < n_tiles * kRows * 8; c += kWarp) {
      const int w = c / (kRows * 8), r = (c / 8) % kRows, k = (c % 8) * 4;
      cp_async16(s_tiles + (w * kRows + r) * kWarp + k,
                 q + r * q_stride + w * cap + blockIdx.x * kWarp + k);
    }
    cp_async_wait_all();
    __syncthreads();
#pragma unroll
    for (int w = 0; w < kPeriod; ++w) {
      v[w] = static_cast<float>(static_cast<int32_t>(s_tiles[w * kRows * kWarp + threadIdx.x]));
    }
  } else {  // the stand-in: slot w holds tile w
#pragma unroll
    for (int w = 0; w < kPeriod; ++w) {
      v[w] = static_cast<float>(static_cast<int32_t>(q[w * cap + lane]));
    }
  }
  // iteration t adds v[t % kPeriod]: whole periods, then the rest
  float acc = 0.0f;
  for (int n = n_iter / kPeriod; n > 0; --n) {
#pragma unroll
    for (int w = 0; w < kPeriod; ++w) acc = __fadd_rn(acc, v[w]);
  }
  const int rest = n_iter % kPeriod;
#pragma unroll
  for (int w = 0; w < kPeriod; ++w) {
    if (w < rest) acc = __fadd_rn(acc, v[w]);
  }
  sink[lane] = acc;  // every lane's sum stays live
  if (lane < kK) scratch[lane] = __float_as_uint(acc);
  finish<V>(carry, scratch, out);
}

// grid: n_grid CTAs of cap threads, each a one-iteration loop whose carry
// lanes 0..7 add into row 0 of the zeroed output.
__global__ void __launch_bounds__(kMaxCap)
r3_grid_kernel(float* __restrict__ out) {
  uint32_t carry = 0;
  for (int t = 0; t < 1; ++t) {
    carry += static_cast<uint32_t>(t);
    asm volatile("" : "+r"(carry));
  }
  if (threadIdx.x < kK) {
    atomicAdd(&out[threadIdx.x], static_cast<float>(static_cast<int32_t>(carry)));
  }
}

// Lanes of a tiled CTA: the most of cap's multiples of 32 up to kLanes that
// divide it.
int tiled_lanes(int cap) {
  for (int lanes = kLanes; lanes > kWarp; lanes -= kWarp) {
    if (cap % lanes == 0) return lanes;
  }
  return kWarp;
}

template <int V>
cudaError_t launch_tiled(cudaStream_t s, const void* off, const void* tb, const void* q,
                         void* out, void* scratch, int n_iter, int cap) {
  const int lanes = tiled_lanes(cap);
  r3_tiled_kernel<V><<<dim3(kTiles, cap / lanes, kParts), lanes, 0, s>>>(
      static_cast<const int32_t*>(off), static_cast<const float*>(tb),
      static_cast<const uint32_t*>(q), static_cast<float*>(out),
      static_cast<uint32_t*>(scratch), n_iter, cap);
  return cudaGetLastError();
}

template <int V>
cudaError_t launch_chain(cudaStream_t s, const void* off, const void* q, void* out,
                         void* sink, void* scratch, int n_iter, int cap) {
  r3_chain_kernel<V><<<cap / kWarp, kWarp, 0, s>>>(
      static_cast<const int32_t*>(off), static_cast<const uint32_t*>(q),
      static_cast<float*>(out), static_cast<float*>(sink), static_cast<uint32_t*>(scratch),
      n_iter, cap);
  return cudaGetLastError();
}

}  // namespace

// out f32 (128, 8) := the variant's result (grid: added into an out the
// caller zeroed; the others write every entry); sink f32[cap] receives the
// per-lane sums of vmem and dma; scratch uint32[1026] zeroed by the caller
// (grid takes none). off int32[16384], tb f32 (128, 64), q uint32
// (4, 64 * cap) 16-byte aligned, all on CUDA device `device`. The grid
// variant launches n_grid CTAs of one iteration each. Returns the launch's
// error code (0 on success) and does not synchronise.
extern "C" int r3_iter_floor_launch(const void* off, const void* tb, const void* q,
                                    void* out, void* sink, void* scratch, int n_iter,
                                    int n_grid, int cap, int variant, int device,
                                    void* stream) {
  if (cap < kWarp || cap > kMaxCap || cap % kWarp || n_iter < 0 || n_grid < 1 ||
      variant < kLoop || variant > kGrid || !aligned16(q)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t rc;
  switch (variant) {
    case kLoop: rc = launch_tiled<kLoop>(s, off, tb, q, out, scratch, n_iter, cap); break;
    case kSmem: rc = launch_tiled<kSmem>(s, off, tb, q, out, scratch, n_iter, cap); break;
    case kVmem: rc = launch_chain<kVmem>(s, off, q, out, sink, scratch, n_iter, cap); break;
    case kDma: rc = launch_chain<kDma>(s, off, q, out, sink, scratch, n_iter, cap); break;
    case kMm: rc = launch_tiled<kMm>(s, off, tb, q, out, scratch, n_iter, cap); break;
    case kFull: rc = launch_tiled<kFull>(s, off, tb, q, out, scratch, n_iter, cap); break;
    default:
      r3_grid_kernel<<<n_grid, cap, 0, s>>>(static_cast<float*>(out));
      rc = cudaGetLastError();
      break;
  }
  return static_cast<int>(rc);
}
