// The hashing stage of both chunk steps for NVIDIA Hopper (sm_90a): packed
// 2-bit words in, the int64 sort key of every valid k-mer window out.
//
// Replaces two XLA fusions of the JAX package, which the port had run as
// plain torch eager (about 1,700 launches over int64 temporaries a chunk):
//  * plane_hash_keys: kmer_mapper_tpu/ops/hashing.py:82 plane_hash_mixed
//    with ops/u32hash.py:57 feistel_mix, and the sort key of
//    ops/stream_probe.py's sort: the fixed-read-length (strided) step;
//  * ragged_hash_keys: ops/hashing.py:41 rolling_kmer_hash_packed, :261
//    window_mask, :218 revcomp_lo_hi and the mix of models/mapper.py:107-147
//    chunk_step: every other buffer.
// Each computes what its fusion computes, not its layout: the k-mer words of
// a window, optionally their reverse complement, the three-round Feistel
// mix and the key (m_lo - 2**31) * 2**32 + m_hi (u32mix.cuh). Windows that
// the JAX code marks invalid (rows past n_reads, windows that cross a read)
// are neither hashed nor written, so the keys need no invalid tail. The
// output order is each plain twin's (kmer_mapper_tpu_torch/ops/hashing.py),
// so kernel and twin compare without a sort.
//
// What bounds them: device-memory bytes, the 8-byte key written per window
// (about 20x the packed words read); about 40 INT32 operations a key are of
// the same order. Design, simple first: no shared memory, words read
// through the read-only cache, each warp store 32 consecutive keys.
//  * plane: thread (read r, word j) loads the read's words j, j+1, j+2 once
//    (words past the row read as zero, as JAX's col(j)) and writes the 16
//    windows s = 16j + p of that word, at key (combo(p, j), r) of the
//    twin's (combo, read) order: a warp's 32 reads store 256 contiguous
//    bytes per window. It needs no shared memory, so any read length fits.
//  * ragged: one warp per 32 reads; lane i loads read i's start and output
//    offset, then the warp walks each read's windows 32 at a time. Adjacent
//    lanes read adjacent bases (one to three words a warp load) and store
//    adjacent keys. A read owns windows start + t, t < len - k + 1, written
//    at offs[read] + t; the packers' lengths tile the buffer (pinned by
//    tests/test_torch_hash_keys.py), where this equals window_mask's rule.
//
// The ragged step's offsets are computed here too, on the card, so that no
// host sync and no eager torch op stands between a chunk's read lengths and
// its keys (JAX's chunk_step keeps them on the device too: the cumsum and
// n_valid of models/mapper.py:140-142). Their work is 12 bytes a read (a
// length read, a start and an offset written): a chunk's half million reads
// are 2 us of bytes, so what bounds ragged_offsets_launch is fixed cost,
// launches and round trips to memory. It is one cooperative launch of
// ragged_offsets_kernel on a persistent grid of at most the CTAs that fit
// on the card at once (ragged_offsets_grid), each taking a run of
// contiguous tiles of kScanTile reads; a chunk's reads fill less than one
// wave (534,721 reads of 100-151 bp: 131 tiles, where an H100 holds 264
// CTAs), so a CTA takes one tile. A thread loads its 16 consecutive lengths
// with four 16-byte loads and keeps its CTA's first tile in registers; the
// CTA scans that tile (warp shuffles, one row of warp totals in shared
// memory) and writes its totals (bases, valid windows, negative lengths) to
// its own slot of the scratch. After one grid.sync() each CTA adds the
// slots of the CTAs before it and writes each read's start and output
// offset, staged in shared memory so that a warp stores 32 consecutive
// 16-byte groups of each. Only a CTA with more than one tile (more reads
// than a wave's tiles) reads its later tiles' lengths again, after the
// barrier. Every slot is written before the barrier and read after it, so
// the scratch needs no zeroing and carries nothing from one call to the
// next. The last CTA, which has added every slot before its own, writes
// offs[n_rows] and the chunk's count, int32 (keys, valid windows), which
// the hash kernel (the reverse complements go after the forward keys, at
// the valid windows), the block partition and the mapper's totals read
// from device memory; the key buffer is sized by the buffer's capacity,
// since windows never outnumber bases. Where the lengths do not tile the
// buffer (a negative length, or a sum other than n_bases) the count is
// (-1, -1): the hash kernel writes nothing, the partition takes no key, and
// the mapper raises at its next read-back.
//
// Bound with ctypes; see kmer_mapper_tpu_torch/native.py.

#include <atomic>
#include <cstdint>
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "u32mix.cuh"

namespace {

using namespace kmt_mix;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxPlaneWords = 65535;  // gridDim.y

__global__ void __launch_bounds__(kThreads)
plane_hash_keys_kernel(const uint32_t* __restrict__ words,
                       long long* __restrict__ keys, int n_reads, int npr,
                       int n_win, int k, uint32_t seed, int with_revcomp) {
  const int r = blockIdx.x * kThreads + threadIdx.x;
  if (r >= n_reads) return;
  const int j = blockIdx.y;
  const uint32_t* row = words + static_cast<int64_t>(r) * npr;
  const uint32_t w0 = __ldg(row + j);
  const uint32_t w1 = j + 1 < npr ? __ldg(row + j + 1) : 0u;
  const uint32_t w2 = j + 2 < npr ? __ldg(row + j + 2) : 0u;
  const int64_t n = n_reads;
  long long* rc_keys = keys + static_cast<int64_t>(n_win) * n;
  int combo0 = 0;  // windows of the phases before p, over all words
  for (int p = 0; p < 16; ++p) {
    // phase p holds windows 16j' + p for j' < n_j (hashing.plane_hash_mixed)
    const int n_j = p < n_win ? (n_win - 1 - p) / 16 + 1 : 0;
    if (j < n_j) {
      uint32_t lo, hi;
      window_words(w0, w1, w2, p, k, lo, hi);
      const int64_t at = static_cast<int64_t>(combo0 + j) * n + r;
      keys[at] = mixed_key(lo, hi, seed);
      if (with_revcomp) {
        uint32_t rlo, rhi;
        revcomp(lo, hi, k, rlo, rhi);
        rc_keys[at] = mixed_key(rlo, rhi, seed);
      }
    }
    combo0 += n_j;
  }
}

constexpr int kScanThreads = 256;
constexpr int kScanWarps = kScanThreads / 32;
constexpr int kScanVecs = 4;  // 16-byte loads (and stores) of a thread a tile
constexpr int kScanItems = 4 * kScanVecs;  // consecutive reads a thread scans, 16
constexpr int kScanTile = kScanThreads * kScanItems;  // reads a tile, 4,096
constexpr int kSums = 3;  // bases, valid windows and negative lengths
constexpr int kMaxDevices = 64;  // devices whose grid size is cached

// Running sums of reads: bases, valid windows, negative lengths. A CTA's
// slot of the scratch holds its reads' sums as kSums int64.
struct Sums {
  long long v[kSums];
  __device__ __forceinline__ void add(int len, int k) {
    v[0] += len;
    v[1] += max(0, len - k + 1);
    v[2] += len < 0;
  }
  __device__ __forceinline__ void add(const Sums& o) {
#pragma unroll
    for (int c = 0; c < kSums; ++c) v[c] += o.v[c];
  }
};

// The block's exclusive scan of each thread's sums (threads in order),
// returned, and the block's totals; every thread of the block calls it.
__device__ __forceinline__ Sums block_scan(const Sums& mine, Sums& total) {
  __shared__ Sums warp_total[kScanWarps];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  Sums incl = mine;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
#pragma unroll
    for (int c = 0; c < kSums; ++c) {
      const long long u = __shfl_up_sync(0xFFFFFFFFu, incl.v[c], o);
      if (lane >= o) incl.v[c] += u;
    }
  }
  __syncthreads();  // the readers of a previous call are done with warp_total
  if (lane == 31) warp_total[warp] = incl;
  __syncthreads();
  Sums before = {{0, 0, 0}};
  total = before;
#pragma unroll
  for (int w = 0; w < kScanWarps; ++w) {
    const Sums t = warp_total[w];
    if (w < warp) before.add(t);
    total.add(t);
  }
#pragma unroll
  for (int c = 0; c < kSums; ++c) before.v[c] += incl.v[c] - mine.v[c];
  return before;
}

// Thread x's lengths in tile t: reads t * kScanTile + 16x ... + 15, 0 past
// n_rows; four 16-byte loads where the lengths are aligned and in range.
__device__ __forceinline__ void load_tile(const int32_t* __restrict__ lengths, int n_rows, int t,
                                          bool vec, int (&len)[kScanItems]) {
  const int64_t first = static_cast<int64_t>(t) * kScanTile + threadIdx.x * kScanItems;
  if (vec && first + kScanItems <= n_rows) {
    const int4* at = reinterpret_cast<const int4*>(lengths + first);
#pragma unroll
    for (int j = 0; j < kScanVecs; ++j) {
      const int4 q = __ldg(at + j);
      len[4 * j] = q.x;
      len[4 * j + 1] = q.y;
      len[4 * j + 2] = q.z;
      len[4 * j + 3] = q.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < kScanItems; ++i) {
      len[i] = first + i < n_rows ? __ldg(lengths + first + i) : 0;
    }
  }
}

__device__ __forceinline__ Sums tile_sums(const int (&len)[kScanItems], int k) {
  Sums s = {{0, 0, 0}};
#pragma unroll
  for (int i = 0; i < kScanItems; ++i) s.add(len[i], k);
  return s;
}

// The shared-memory slot of a tile's 16-byte group q: its low two bits
// xor'ed with bits 3-4, so that neither a thread's four consecutive groups
// (q = 4x + j) nor a warp's consecutive ones (q = 256j + x) meet in a bank.
__device__ __forceinline__ int swizzle(int q) { return q ^ ((q >> 3) & 3); }

// Tile t's starts and output offsets from thread x's lengths and `at`, the
// sums of every read before its first: staged in shared memory, so that a
// warp stores 32 consecutive 16-byte groups of each.
__device__ __forceinline__ void store_tile(const int (&len)[kScanItems], const Sums& at, int t,
                                           int n_rows, int k, bool vec,
                                           int32_t* __restrict__ starts,
                                           int32_t* __restrict__ offs) {
  __shared__ int4 staged[2][kScanTile / 4];
  long long base = at.v[0], out = at.v[1];
  __syncthreads();  // the stores of a previous tile are done with staged
#pragma unroll
  for (int j = 0; j < kScanVecs; ++j) {
    int s[4], o[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      // int32 like the twin's: exact wherever the lengths tile the buffer
      s[e] = static_cast<int32_t>(base);
      o[e] = static_cast<int32_t>(out);
      base += len[4 * j + e];
      out += max(0, len[4 * j + e] - k + 1);
    }
    const int q = swizzle(threadIdx.x * kScanVecs + j);
    staged[0][q] = make_int4(s[0], s[1], s[2], s[3]);
    staged[1][q] = make_int4(o[0], o[1], o[2], o[3]);
  }
  __syncthreads();
  const int64_t first = static_cast<int64_t>(t) * kScanTile;
#pragma unroll
  for (int j = 0; j < kScanVecs; ++j) {
    const int q = j * kScanThreads + threadIdx.x;
    const int64_t i = first + 4 * q;
    const int4 s = staged[0][swizzle(q)];
    const int4 o = staged[1][swizzle(q)];
    if (vec && i + 4 <= n_rows) {
      *reinterpret_cast<int4*>(starts + i) = s;
      *reinterpret_cast<int4*>(offs + i) = o;
    } else {
      const int sv[4] = {s.x, s.y, s.z, s.w};
      const int ov[4] = {o.x, o.y, o.z, o.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (i + e < n_rows) {
          starts[i + e] = sv[e];
          offs[i + e] = ov[e];
        }
      }
    }
  }
}

// The ragged step's offsets in one pass over the lengths (see the note at
// the top): CTA b takes tiles [b * tiles_per_cta, ...) of `tiles`, writes
// their sums to slots[b * kSums ...], waits for every CTA at the grid
// barrier, then writes its reads' starts and offsets; the last CTA writes
// offs[n_rows] and the count. Needs a cooperative launch.
__global__ void __launch_bounds__(kScanThreads)
ragged_offsets_kernel(const int32_t* __restrict__ lengths, int n_rows, int k, int tiles,
                      int tiles_per_cta, int vec, long long* slots,
                      int32_t* __restrict__ starts, int32_t* __restrict__ offs,
                      int32_t* __restrict__ count, long long n_bases, int with_revcomp) {
  const int cta = static_cast<int>(blockIdx.x);
  const int first = cta * tiles_per_cta;
  const int end = min(first + tiles_per_cta, tiles);
  int len[kScanItems];  // the first tile's, kept across the barrier
  load_tile(lengths, n_rows, first, vec, len);
  Sums own;  // the first tile's, then every tile's of this CTA
  const Sums before = block_scan(tile_sums(len, k), own);
  const Sums first_tile = own;
  for (int t = first + 1; t < end; ++t) {  // more reads than one wave of tiles
    int more[kScanItems];
    load_tile(lengths, n_rows, t, vec, more);
    Sums tile;
    block_scan(tile_sums(more, k), tile);
    own.add(tile);
  }
  if (threadIdx.x == 0) {
#pragma unroll
    for (int c = 0; c < kSums; ++c) slots[cta * kSums + c] = own.v[c];
  }
  cooperative_groups::this_grid().sync();
  // the slots of the CTAs before this one, added (read past L1: written by
  // other SMs during this launch)
  Sums prior = {{0, 0, 0}};
  for (int b = threadIdx.x; b < cta; b += kScanThreads) {
#pragma unroll
    for (int c = 0; c < kSums; ++c) prior.v[c] += __ldcg(slots + b * kSums + c);
  }
  Sums carry;  // every read's sums before this CTA's first, then before tile t
  block_scan(prior, carry);
  Sums at = carry;
  at.add(before);
  store_tile(len, at, first, n_rows, k, vec != 0, starts, offs);
  carry.add(first_tile);
  for (int t = first + 1; t < end; ++t) {
    int more[kScanItems];
    load_tile(lengths, n_rows, t, vec, more);
    Sums tile;
    at = block_scan(tile_sums(more, k), tile);
    at.add(carry);
    store_tile(more, at, t, n_rows, k, vec != 0, starts, offs);
    carry.add(tile);
  }
  if (cta == static_cast<int>(gridDim.x) - 1 && threadIdx.x == 0) {
    const long long windows = carry.v[1];  // every read's sums now
    const bool tiled = carry.v[2] == 0 && carry.v[0] == n_bases;
    offs[n_rows] = static_cast<int32_t>(windows);
    count[0] = tiled ? static_cast<int32_t>(windows * (with_revcomp ? 2 : 1)) : -1;
    count[1] = tiled ? static_cast<int32_t>(windows) : -1;
  }
}

__global__ void __launch_bounds__(kThreads)
ragged_hash_keys_kernel(const uint32_t* __restrict__ words, int64_t n_words,
                        const int32_t* __restrict__ starts,
                        const int32_t* __restrict__ offs, int n_rows,
                        const int32_t* __restrict__ count,
                        long long* __restrict__ keys, int k,
                        uint32_t seed, int with_revcomp) {
  const int lane = threadIdx.x & 31;
  const int64_t first =
      (static_cast<int64_t>(blockIdx.x) * kWarps + threadIdx.x / 32) * 32;
  // the valid windows, -1 where the lengths do not tile the buffer: then
  // nothing is written
  const int64_t n_valid = __ldg(count + 1);
  if (first >= n_rows || n_valid <= 0) return;  // the whole warp
  const int64_t i = first + lane;
  int start = 0, off = 0, n_win = 0;
  if (i < n_rows) {
    start = starts[i];
    off = offs[i];
    n_win = offs[i + 1] - off;
  }
  for (int q = 0; q < 32; ++q) {
    const int s0 = __shfl_sync(0xFFFFFFFFu, start, q);
    const int o0 = __shfl_sync(0xFFFFFFFFu, off, q);
    const int nq = __shfl_sync(0xFFFFFFFFu, n_win, q);
    for (int t = lane; t < nq; t += 32) {
      const int64_t pos = static_cast<int64_t>(s0) + t;
      const int64_t j = pos >> 4;  // never read past the buffer's last word
      const uint32_t w0 = j < n_words ? __ldg(words + j) : 0u;
      const uint32_t w1 = j + 1 < n_words ? __ldg(words + j + 1) : 0u;
      const uint32_t w2 = j + 2 < n_words ? __ldg(words + j + 2) : 0u;
      uint32_t lo, hi;
      window_words(w0, w1, w2, static_cast<int>(pos & 15), k, lo, hi);
      const int64_t at = static_cast<int64_t>(o0) + t;
      keys[at] = mixed_key(lo, hi, seed);
      if (with_revcomp) {
        uint32_t rlo, rhi;
        revcomp(lo, hi, k, rlo, rhi);
        keys[n_valid + at] = mixed_key(rlo, rhi, seed);
      }
    }
  }
}

// The most CTAs of ragged_offsets_kernel that are resident on `device` at
// once (a cooperative launch may have no more), cached per device; the
// device must be current.
cudaError_t offsets_ctas(int device, int* ctas) {
  static std::atomic<int> cached[kMaxDevices];
  const bool cache = device >= 0 && device < kMaxDevices;
  if (cache && (*ctas = cached[device].load(std::memory_order_relaxed)) > 0) return cudaSuccess;
  int per_sm = 0, sms = 0, cooperative = 0;
  cudaError_t e = cudaDeviceGetAttribute(&cooperative, cudaDevAttrCooperativeLaunch, device);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (e == cudaSuccess) {
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, ragged_offsets_kernel,
                                                      kScanThreads, 0);
  }
  if (e != cudaSuccess) return e;
  if (!cooperative || per_sm < 1) return cudaErrorCooperativeLaunchTooLarge;
  *ctas = per_sm * sms;
  if (cache) cached[device].store(*ctas, std::memory_order_relaxed);
  return cudaSuccess;
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace

// Keys of every window of reads 0 .. n_reads-1 of a strided buffer; returns
// cudaGetLastError() after the launch (0 on success). Device pointers:
// words uint32[>= n_reads * npr], row r at [r*npr, (r+1)*npr); keys
// int64[n_win * n_reads * (revcomp ? 2 : 1)], n_win = read_len - k + 1,
// key (combo, r) at combo * n_reads + r, reverse complements after the
// forward keys. Launches on `stream` of CUDA device `device`, does not
// synchronise; n_reads == 0 launches nothing.
extern "C" int plane_hash_keys_launch(const void* words, void* keys, int n_reads,
                                      int npr, int read_len, int k,
                                      unsigned int seed, int revcomp, int device,
                                      void* stream) {
  if (n_reads < 0 || npr < 1 || npr > kMaxPlaneWords || k < 1 || k > 31 ||
      read_len < k || read_len > 16 * npr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  if (n_reads == 0) return static_cast<int>(cudaGetLastError());
  const int n_win = read_len - k + 1;
  const dim3 grid((n_reads + kThreads - 1) / kThreads, (n_win - 1) / 16 + 1);
  plane_hash_keys_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(words), static_cast<long long*>(keys), n_reads, npr,
      n_win, k, seed, revcomp);
  return static_cast<int>(cudaGetLastError());
}

// The CTAs of ragged_offsets_launch's persistent grid on CUDA device
// `device`, into *ctas; returns the first CUDA error (0 on success). A call
// of more than *ctas * 4,096 reads gives some CTAs more than one tile.
extern "C" int ragged_offsets_grid(int device, int* ctas) {
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  return static_cast<int>(offsets_ctas(device, ctas));
}

// The ragged step's offsets of n_rows reads, on the card, in one cooperative
// launch; returns the first CUDA error (0 on success). Device pointers:
// lengths int32[n_rows]; starts int32[n_rows] (each read's first base) and
// offs int32[n_rows + 1] (the exclusive sum of max(0, len - k + 1)); count
// int32[2]: (keys, valid windows), the keys twice the windows with revcomp,
// both -1 where a length is negative or the lengths do not add up to
// n_bases; slots int64 scratch of 3 * max(1, ceil(n_rows / 4096)), whose
// contents do not matter (every slot used is written before it is read).
// Launches on `stream` of CUDA device `device` and does not synchronise;
// n_rows == 0 still writes offs[0] and the count.
extern "C" int ragged_offsets_launch(const void* lengths, int n_rows, void* starts, void* offs,
                                     void* count, void* slots, long long n_bases, int k,
                                     int revcomp, int device, void* stream) {
  if (n_rows < 0 || n_bases < 0 || k < 1 || k > 31) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  int ctas = 0;
  const cudaError_t grid_err = offsets_ctas(device, &ctas);
  if (grid_err != cudaSuccess) return static_cast<int>(grid_err);
  int tiles = n_rows > 0 ? (n_rows - 1) / kScanTile + 1 : 1;
  int tiles_per_cta = (tiles - 1) / ctas + 1;
  int vec = aligned16(lengths) && aligned16(starts) && aligned16(offs);
  const auto* len = static_cast<const int32_t*>(lengths);
  auto* slot = static_cast<long long*>(slots);
  auto* start = static_cast<int32_t*>(starts);
  auto* off = static_cast<int32_t*>(offs);
  auto* cnt = static_cast<int32_t*>(count);
  void* args[] = {&len, &n_rows, &k, &tiles, &tiles_per_cta, &vec, &slot, &start, &off, &cnt,
                  &n_bases, &revcomp};
  const cudaError_t launched = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(ragged_offsets_kernel),
      dim3((tiles - 1) / tiles_per_cta + 1), dim3(kScanThreads), args, 0,
      static_cast<cudaStream_t>(stream));
  return static_cast<int>(launched != cudaSuccess ? launched : cudaGetLastError());
}

// Keys of the valid windows of a continuously packed buffer; returns
// cudaGetLastError() after the launch (0 on success). Device pointers:
// words uint32[n_words]; starts, offs and count as ragged_offsets_launch
// wrote them; keys int64 of at least count[0] (the buffer's capacity in
// bases, twice that with revcomp, holds any count): read i's window t at
// offs[i] + t, reverse complements count[1] further on, nothing where
// count[1] is -1. Launches on `stream` of CUDA device `device`, does not
// synchronise; n_rows == 0 launches nothing.
extern "C" int ragged_hash_keys_launch(const void* words, long long n_words,
                                       const void* starts, const void* offs,
                                       int n_rows, const void* count, void* keys,
                                       int k, unsigned int seed, int revcomp,
                                       int device, void* stream) {
  if (n_words < 1 || n_rows < 0 || k < 1 || k > 31) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  if (n_rows == 0) return static_cast<int>(cudaGetLastError());
  const int64_t grid = (static_cast<int64_t>(n_rows) + kThreads - 1) / kThreads;
  ragged_hash_keys_kernel<<<static_cast<unsigned int>(grid), kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(words), n_words, static_cast<const int32_t*>(starts),
      static_cast<const int32_t*>(offs), n_rows, static_cast<const int32_t*>(count),
      static_cast<long long*>(keys), k, seed, revcomp);
  return static_cast<int>(cudaGetLastError());
}
