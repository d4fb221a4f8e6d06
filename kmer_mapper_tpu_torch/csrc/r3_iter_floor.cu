// The floor of one tile iteration, piece by piece (sm_90a).
//
// Replaces scripts/r3_iter_floor.py:make_variant(v).kernel, the Pallas
// kernel that runs N_ITER iterations of the stream count's tile loop with
// parts added one at a time, to find what one iteration costs. Here one
// CTA of `cap` threads (one per query lane) runs the loop:
//
//   loop   carry += t                        (the loop alone)
//   smem   carry += a + b, a = off[t % 8192], b = off[8192 + t % 8192]
//   vmem   smem + acc[lane] += float(ring[t % 4][0][lane]) from shared
//          memory that was filled once (tile w in slot w, a stand-in for
//          the TPU's never-written scratch)
//   dma    smem + a 4-deep cp.async ring of (4, cap) query tiles, tile t at
//          column (t % 64) * cap; acc[lane] += float(q[0]) in t order
//   mm     full's tile compute on the vmem stand-in, no copies
//   full   dma + the tile compute: a lane is live if its position lies in
//          [a, a + cap) and local_b = q0 - b % 997 lies in [0, 128); a live
//          lane hits key lane k when all 8 bytes of (q1, q2) equal
//          bf16(tb[local_b, p * 8 + k]); hits count in acc[local_b, k]
//   grid   1024 CTAs with a one-iteration loop (the output stays zero)
//
// Output f32 (128, 8): row 0 += float(int32 carry); rows 1..127 += acc rows
// 0..126 (the count tile for mm and full, lane 0..7 sums for vmem and dma).
// The carry wraps as uint32 (signed overflow is undefined in C++); each
// thread adds its lane in t order, so the f32 sums round as the TPU's do.
//
// What bounds it: not bytes (q is 1 MB, read again and again from L2) and
// not operations, but the loop's dependent chain per iteration on one SM:
// the uniform loads of a and b, the cp.async wait, and the shared reads and
// atomics of the tile compute. The TPU's byte-plane matmul has no
// counterpart: the staged tile holds each key lane's 8 planes as two packed
// words (when all 8 are bytes), so a live lane compares 2 words per key lane.
// The asm barrier on the carry keeps the loop variants from being folded.
//
// Bound with ctypes; see kmer_mapper_tpu_torch/native.py.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kSlots = 4;      // query tiles in flight
constexpr int kRows = 4;       // rows of a query tile: bucket, lo, hi, hi
constexpr int kBpb = 128;      // rows of the key and count tiles
constexpr int kK = 8;          // key lanes
constexpr int kPlanes = 8;     // byte planes of a (lo, hi) pair
constexpr int kOffHalf = 8192; // a = off[t % 8192], b = off[8192 + t % 8192]
constexpr int kTiles = 64;     // tile t sits at column (t % 64) * cap
constexpr int kMaxCap = 1024;
// a row of the staged keys: 8 packed words, then a mask of the lanes whose
// 8 planes are all bytes. Nine words, not eight: lanes of a warp read random
// rows at one column, which a stride of 8 would send to 4 banks.
constexpr int kKeyStride = kK + 1;

enum Variant : int { kLoop = 0, kSmem = 1, kVmem = 2, kDma = 3, kMm = 4, kFull = 5, kGrid = 6 };

__device__ __forceinline__ void cp_async4(uint32_t* dst, const uint32_t* src) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src));
}

// This thread's lane of tile t (all 4 rows) into ring slot `slot`. Each
// thread copies and later reads only its own lane, so the ring needs no
// barrier: cp.async.wait_group orders a thread's copies before its reads.
__device__ __forceinline__ void issue_tile(uint32_t* ring, const uint32_t* q,
                                           int t, int slot, int cap, int lane) {
  const int64_t q_stride = static_cast<int64_t>(kTiles) * cap;
  const int col = (t % kTiles) * cap + lane;
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    cp_async4(ring + (slot * kRows + r) * cap + lane, q + r * q_stride + col);
  }
}

template <int V>
__global__ void __launch_bounds__(kMaxCap)
r3_iter_floor_kernel(const int32_t* __restrict__ off,
                     const float* __restrict__ tb,
                     const uint32_t* __restrict__ q, float* __restrict__ out,
                     float* __restrict__ sink, int n_iter, int cap) {
  constexpr bool kRing = V == kVmem || V == kDma || V == kMm || V == kFull;
  constexpr bool kCopies = V == kDma || V == kFull;
  constexpr bool kCompute = V == kMm || V == kFull;
  extern __shared__ uint32_t smem[];
  uint32_t* ring = smem;  // [kSlots][kRows][cap]
  uint32_t* s_klo = ring + kSlots * kRows * cap;  // [kBpb][kKeyStride]
  uint32_t* s_khi = s_klo + kBpb * kKeyStride;    // [kBpb][kKeyStride]
  unsigned int* s_cnt = s_khi + kBpb * kKeyStride;  // [kBpb][kK]
  const int lane = threadIdx.x;

  if (kCompute) {
    // A key lane hits when each of its 8 planes, rounded to bf16, equals a
    // byte of the query. Where all 8 are bytes that is a compare of packed
    // words; a lane with another value can never hit (-0.0 counts as 0).
    for (int r = lane; r < kBpb; r += blockDim.x) s_klo[r * kKeyStride + kK] = 0;
    __syncthreads();
    for (int i = lane; i < kBpb * kK; i += blockDim.x) {
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
    __syncthreads();
  }
  if (V == kVmem || V == kMm) {  // the stand-in: slot w holds tile w
    const int64_t q_stride = static_cast<int64_t>(kTiles) * cap;
    for (int w = 0; w < kSlots; ++w) {
      for (int r = 0; r < kRows; ++r) {
        ring[(w * kRows + r) * cap + lane] = q[r * q_stride + w * cap + lane];
      }
    }
  }
  if (kCopies) {
    for (int w = 0; w < kSlots - 1; ++w) {
      if (w < n_iter) issue_tile(ring, q, w, w, cap, lane);
      asm volatile("cp.async.commit_group;\n" ::);
    }
  }

  uint32_t carry = 0;
  float acc0 = 0.0f;
  for (int t = 0; t < n_iter; ++t) {
    if (V == kLoop || V == kGrid) {
      carry += static_cast<uint32_t>(t);
      asm volatile("" : "+r"(carry));  // no closed form: one add per iteration
      continue;
    }
    const int a = __ldg(off + (t % kOffHalf));
    const int b = __ldg(off + kOffHalf + (t % kOffHalf));
    carry += static_cast<uint32_t>(a);
    if (kRing) {
      const int slot = t % kSlots;
      if (kCopies) {
        // one commit per iteration, empty past the end, so that waiting
        // for all but the newest kSlots - 1 groups always covers tile t
        if (t + kSlots - 1 < n_iter) {
          issue_tile(ring, q, t + kSlots - 1, (t + kSlots - 1) % kSlots, cap, lane);
        }
        asm volatile("cp.async.commit_group;\n" ::);
        asm volatile("cp.async.wait_group %0;\n" ::"n"(kSlots - 1));
      }
      const uint32_t* tile = ring + slot * kRows * cap;
      const uint32_t q0 = tile[lane];
      if (V == kVmem || V == kDma) {
        acc0 += static_cast<float>(static_cast<int32_t>(q0));
      } else {
        const int64_t pos = static_cast<int64_t>(t % kTiles) * cap + lane;
        int bmod = b % 997;  // floor modulo, as jnp's %
        if (bmod < 0) bmod += 997;
        const int64_t local_b = static_cast<int64_t>(static_cast<int32_t>(q0)) - bmod;
        if (pos >= a && pos < static_cast<int64_t>(a) + cap && local_b >= 0 &&
            local_b < kBpb) {
          const uint32_t q1 = tile[cap + lane];
          const uint32_t q2 = tile[2 * cap + lane];
          const uint32_t* row_lo = s_klo + local_b * kKeyStride;
          const uint32_t* row_hi = s_khi + local_b * kKeyStride;
          const uint32_t bytes = row_lo[kK];
#pragma unroll
          for (int k = 0; k < kK; ++k) {
            if (((bytes >> k) & 1u) && row_lo[k] == q1 && row_hi[k] == q2) {
              atomicAdd(&s_cnt[local_b * kK + k], 1u);
            }
          }
        }
      }
    }
    carry += static_cast<uint32_t>(b);
  }
  if (kCopies) asm volatile("cp.async.wait_all;\n" ::);

  const float total = static_cast<float>(static_cast<int32_t>(carry));
  if (lane < kK) atomicAdd(&out[lane], total);
  if (V == kVmem || V == kDma) {
    if (lane < kK) atomicAdd(&out[kK + lane], acc0);
    sink[lane] = acc0;  // every lane's sum stays live
  }
  if (kCompute) {
    __syncthreads();
    for (int i = lane; i < (kBpb - 1) * kK; i += blockDim.x) {
      atomicAdd(&out[kK + i], static_cast<float>(s_cnt[i]));
    }
  }
}

template <int V>
cudaError_t launch(int grid, cudaStream_t stream, const void* off,
                   const void* tb, const void* q, void* out, void* sink,
                   int n_iter, int cap) {
  const size_t shared = (static_cast<size_t>(kSlots) * kRows * cap +
                         2 * kBpb * kKeyStride + kBpb * kK) * sizeof(uint32_t);
  const cudaError_t attr = cudaFuncSetAttribute(
      r3_iter_floor_kernel<V>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(shared));
  if (attr != cudaSuccess) return attr;
  r3_iter_floor_kernel<V><<<grid, cap, shared, stream>>>(
      static_cast<const int32_t*>(off), static_cast<const float*>(tb),
      static_cast<const uint32_t*>(q), static_cast<float*>(out),
      static_cast<float*>(sink), n_iter, cap);
  return cudaGetLastError();
}

}  // namespace

// out (f32 (128, 8), zeroed by the caller) += the variant's result; sink
// f32[cap] receives the per-lane sums of vmem and dma. off int32[16384], tb
// f32 (128, 64), q uint32 (4, 64 * cap), all on CUDA device `device`. The
// grid variant launches n_grid CTAs of one iteration each, the others one
// CTA of n_iter iterations. Returns the launch's error code (0 on success)
// and does not synchronise.
extern "C" int r3_iter_floor_launch(const void* off, const void* tb,
                                    const void* q, void* out, void* sink,
                                    int n_iter, int n_grid, int cap,
                                    int variant, int device, void* stream) {
  if (cap < 32 || cap > kMaxCap || cap % 32 || n_iter < 0 || n_grid < 1 ||
      variant < kLoop || variant > kGrid) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t rc;
  switch (variant) {
    case kLoop: rc = launch<kLoop>(1, s, off, tb, q, out, sink, n_iter, cap); break;
    case kSmem: rc = launch<kSmem>(1, s, off, tb, q, out, sink, n_iter, cap); break;
    case kVmem: rc = launch<kVmem>(1, s, off, tb, q, out, sink, n_iter, cap); break;
    case kDma: rc = launch<kDma>(1, s, off, tb, q, out, sink, n_iter, cap); break;
    case kMm: rc = launch<kMm>(1, s, off, tb, q, out, sink, n_iter, cap); break;
    case kFull: rc = launch<kFull>(1, s, off, tb, q, out, sink, n_iter, cap); break;
    default: rc = launch<kGrid>(n_grid, s, off, tb, q, out, sink, 1, cap); break;
  }
  return static_cast<int>(rc);
}
