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
// n_valid of models/mapper.py:140-142). ragged_offsets_launch is a
// reduce-then-scan in two small kernels over tiles of kScanTile reads:
// ragged_tile_sums_kernel writes each tile's bases, valid windows and
// negative lengths; ragged_offsets_kernel adds the tiles before its own and
// scans its tile, writing each read's start and output offset. Its last CTA
// writes the chunk's count, int32 (keys, valid windows), which the hash
// kernel (the reverse complements go after the forward keys, at the valid
// windows), the block partition and the mapper's totals read from device
// memory; the key buffer is sized by the buffer's capacity, since windows
// never outnumber bases. Where the lengths do not tile the buffer (a
// negative length, or a sum other than n_bases) the count is (-1, -1): the
// hash kernel writes nothing, the partition takes no key, and the mapper
// raises at its next read-back.
//
// Bound with ctypes; see kmer_mapper_tpu_torch/native.py.

#include <cstdint>
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
constexpr int kScanItems = 8;  // consecutive reads a thread scans
constexpr int kScanTile = kScanThreads * kScanItems;  // reads a scan CTA, 2,048
constexpr int kSums = 3;  // a tile's bases, valid windows and negative lengths

// A lane's running sums of reads: bases, valid windows, negative lengths.
struct Sums {
  long long v[kSums];
  __device__ __forceinline__ void add(int len, int k) {
    v[0] += len;
    v[1] += max(0, len - k + 1);
    v[2] += len < 0;
  }
};

// The block's exclusive scan of each thread's sums (threads in order), in
// place, and the block's totals; every thread of the block calls it.
__device__ __forceinline__ void block_scan(Sums& mine, Sums& total) {
  __shared__ long long warp_sums[kScanWarps + 1][kSums];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  Sums incl = mine;
#pragma unroll
  for (int c = 0; c < kSums; ++c) {
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const long long u = __shfl_up_sync(0xFFFFFFFFu, incl.v[c], o);
      if (lane >= o) incl.v[c] += u;
    }
  }
  __syncthreads();  // the readers of a previous call are done with warp_sums
  if (lane == 31) {
#pragma unroll
    for (int c = 0; c < kSums; ++c) warp_sums[warp][c] = incl.v[c];
  }
  __syncthreads();
  if (threadIdx.x == 0) {  // the warps' sums scanned: row w the sums before warp w
    long long run[kSums] = {0, 0, 0};
    for (int w = 0; w <= kScanWarps; ++w) {
#pragma unroll
      for (int c = 0; c < kSums; ++c) {
        const long long x = w < kScanWarps ? warp_sums[w][c] : 0;
        warp_sums[w][c] = run[c];
        run[c] += x;
      }
    }
  }
  __syncthreads();
#pragma unroll
  for (int c = 0; c < kSums; ++c) {
    mine.v[c] = warp_sums[warp][c] + incl.v[c] - mine.v[c];
    total.v[c] = warp_sums[kScanWarps][c];
  }
}

// Tile t's sums over the reads [t * kScanTile, (t + 1) * kScanTile), into
// sums[t * kSums ...].
__global__ void __launch_bounds__(kScanThreads)
ragged_tile_sums_kernel(const int32_t* __restrict__ lengths, int n_rows, int k,
                        long long* __restrict__ sums) {
  const int64_t first = static_cast<int64_t>(blockIdx.x) * kScanTile;
  Sums mine = {{0, 0, 0}}, total;
#pragma unroll
  for (int j = 0; j < kScanItems; ++j) {
    const int64_t i = first + j * kScanThreads + threadIdx.x;
    if (i < n_rows) mine.add(__ldg(lengths + i), k);
  }
  block_scan(mine, total);
  if (threadIdx.x == 0) {
#pragma unroll
    for (int c = 0; c < kSums; ++c) sums[blockIdx.x * kSums + c] = total.v[c];
  }
}

// Tile t's starts and output offsets: the sums of the tiles before it, then
// its reads scanned in order (thread x owns the tile's reads
// x * kScanItems ... + kScanItems - 1). The last CTA writes offs[n_rows]
// and the count.
__global__ void __launch_bounds__(kScanThreads)
ragged_offsets_kernel(const int32_t* __restrict__ lengths, int n_rows, int k,
                      const long long* __restrict__ sums, int32_t* __restrict__ starts,
                      int32_t* __restrict__ offs, int32_t* __restrict__ count,
                      long long n_bases, int with_revcomp) {
  // the tile's lengths are loaded first, so that their latency overlaps
  // the sums of the tiles before it
  const int64_t first =
      static_cast<int64_t>(blockIdx.x) * kScanTile + threadIdx.x * kScanItems;
  int len[kScanItems];
#pragma unroll
  for (int j = 0; j < kScanItems; ++j) {
    len[j] = first + j < n_rows ? __ldg(lengths + first + j) : 0;
  }
  Sums before = {{0, 0, 0}}, prefix;
  for (int t = threadIdx.x; t < static_cast<int>(blockIdx.x); t += kScanThreads) {
#pragma unroll
    for (int c = 0; c < kSums; ++c) before.v[c] += sums[t * kSums + c];
  }
  block_scan(before, prefix);
  Sums mine = {{0, 0, 0}}, tile;
#pragma unroll
  for (int j = 0; j < kScanItems; ++j) mine.add(len[j], k);
  block_scan(mine, tile);
  long long base = prefix.v[0] + mine.v[0];
  long long out = prefix.v[1] + mine.v[1];
#pragma unroll
  for (int j = 0; j < kScanItems; ++j) {
    if (first + j < n_rows) {
      // int32 like the twin's: exact wherever the lengths tile the buffer
      starts[first + j] = static_cast<int32_t>(base);
      offs[first + j] = static_cast<int32_t>(out);
    }
    base += len[j];
    out += max(0, len[j] - k + 1);
  }
  if (blockIdx.x == gridDim.x - 1 && threadIdx.x == 0) {
    const long long bases = prefix.v[0] + tile.v[0];
    const long long windows = prefix.v[1] + tile.v[1];
    const bool tiled = prefix.v[2] + tile.v[2] == 0 && bases == n_bases;
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

// The ragged step's offsets of n_rows reads, on the card; returns the
// first CUDA error (0 on success). Device pointers: lengths int32[n_rows];
// starts int32[n_rows] (each read's first base) and offs int32[n_rows + 1]
// (the exclusive sum of max(0, len - k + 1)); count int32[2]: (keys, valid
// windows), the keys twice the windows with revcomp, both -1 where a length
// is negative or the lengths do not add up to n_bases; sums int64 scratch of
// 3 * max(1, ceil(n_rows / 2048)). Launches on `stream` of CUDA device
// `device` (the tile sums only where the reads fill more than one tile) and
// does not synchronise; n_rows == 0 still writes offs[0] and the count.
extern "C" int ragged_offsets_launch(const void* lengths, int n_rows, void* starts, void* offs,
                                     void* count, void* sums, long long n_bases, int k,
                                     int revcomp, int device, void* stream) {
  if (n_rows < 0 || n_bases < 0 || k < 1 || k > 31) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  const int tiles = n_rows > 0 ? (n_rows + kScanTile - 1) / kScanTile : 1;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* len = static_cast<const int32_t*>(lengths);
  auto* tile_sums = static_cast<long long*>(sums);
  if (tiles > 1) {
    ragged_tile_sums_kernel<<<tiles, kScanThreads, 0, s>>>(len, n_rows, k, tile_sums);
  }
  ragged_offsets_kernel<<<tiles, kScanThreads, 0, s>>>(
      len, n_rows, k, tile_sums, static_cast<int32_t*>(starts), static_cast<int32_t*>(offs),
      static_cast<int32_t*>(count), n_bases, revcomp);
  return static_cast<int>(cudaGetLastError());
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
