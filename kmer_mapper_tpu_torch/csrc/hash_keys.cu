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

__global__ void __launch_bounds__(kThreads)
ragged_hash_keys_kernel(const uint32_t* __restrict__ words, int64_t n_words,
                        const int32_t* __restrict__ starts,
                        const int32_t* __restrict__ offs, int n_rows,
                        long long* __restrict__ keys, int64_t n_valid, int k,
                        uint32_t seed, int with_revcomp) {
  const int lane = threadIdx.x & 31;
  const int64_t first =
      (static_cast<int64_t>(blockIdx.x) * kWarps + threadIdx.x / 32) * 32;
  if (first >= n_rows) return;  // the whole warp
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

// Keys of the valid windows of a continuously packed buffer; returns
// cudaGetLastError() after the launch (0 on success). Device pointers:
// words uint32[n_words]; starts int32[n_rows] (each read's first base);
// offs int32[n_rows + 1] (exclusive sum of max(0, len - k + 1), offs[n_rows]
// == n_valid); keys int64[n_valid * (revcomp ? 2 : 1)], read i's window t at
// offs[i] + t, reverse complements n_valid further on. Launches on `stream`
// of CUDA device `device`, does not synchronise; n_valid == 0 launches
// nothing.
extern "C" int ragged_hash_keys_launch(const void* words, long long n_words,
                                       const void* starts, const void* offs,
                                       int n_rows, void* keys, long long n_valid,
                                       int k, unsigned int seed, int revcomp,
                                       int device, void* stream) {
  if (n_words < 1 || n_rows < 0 || n_valid < 0 || k < 1 || k > 31) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  if (n_rows == 0 || n_valid == 0) return static_cast<int>(cudaGetLastError());
  const int64_t grid = (static_cast<int64_t>(n_rows) + kThreads - 1) / kThreads;
  ragged_hash_keys_kernel<<<static_cast<unsigned int>(grid), kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(words), n_words, static_cast<const int32_t*>(starts),
      static_cast<const int32_t*>(offs), n_rows, static_cast<long long*>(keys), n_valid,
      k, seed, revcomp);
  return static_cast<int>(cudaGetLastError());
}
