// Block partition for NVIDIA Hopper (sm_90a): the int64 sort keys of a
// chunk's queries grouped by 128-bucket chain block, and each block's window,
// for the stream count (stream_count.cu) of both chunk steps.
//
// Replaces the sort and the offsets of
// kmer_mapper_tpu/ops/stream_probe.py:stream_probe_count_mixed: the
// two-operand lax.sort of the mixed (m_lo, m_hi) words (:1170) and
// block_offsets (:407), XLA code on the TPU. The count never needed sorted
// order: it runs one CTA per chain block's window and checks each query's
// bucket against its own block, so only grouping by block matters, and
// integer adds commute. For keys k[0..n):
//  * bin(k) is the key's chain block, or n_blocks for the all-ones invalid
//    key, which lands in no window (block_partition.cuh);
//  * off int32[n_blocks + 1]: block b's window is [off[b], off[b+1]), the
//    invalid keys follow off[n_blocks];
//  * every key is written into its bin's window: the output is a
//    permutation of the input, here sorted by bin and stable.
//
// What bounds it on the H100 is not its bytes (16 a key for one read and one
// write, 0.257 ms for a 64 Mi-base chunk's 53.8M keys) but how its writes
// land. Scattered 8-byte stores, one 32-byte sector request each, run at
// ~50 G a second even into an L2-resident region (PERF.md): ~1 ms a chunk,
// whatever the atomics. So the partition is a least-significant-digit radix
// sort of the bins, whose writes leave in runs, in passes of at most
// kRadixMaxBits bits (two of 7 bits for the 8,193 bins of a 2**20-bucket
// table); it takes every table size. Each pass:
//  * partition_histogram_kernel: CTA s takes the contiguous slab of keys
//    [s*slab_len, (s+1)*slab_len), counts the pass's digit of each key in
//    shared memory and writes its counts as row s of a (slab, digit) int32
//    matrix. No global atomic.
//  * partition_scan_kernel: the matrix's exclusive scan down each digit's
//    column, in place, and each digit's total; the wrapper's torch.cumsum
//    of the totals gives each digit's first slot.
//  * radix_scatter_kernel: CTA s walks its slab in tiles of 4,096 keys,
//    ranks each tile stably in shared memory (ballots over the digit's
//    bits find the lanes of a warp that share a digit; running counts per
//    warp; the warps' counts scanned in (digit, warp) order), stores the
//    tile grouped by digit and writes it out in that order from one
//    cursor a digit in shared memory: each digit's keys of a tile leave as
//    one run (~32 keys at 128 digits). Stable, so the passes compose into
//    a sort by bin, equal to the plain twin's stable order.
// radix_offsets_launch then finds each bin's first position in the sorted
// keys (a binary search a bin, or one read of the keys where the bins are
// many). A pass reads and writes each key once, plus one read for its
// histogram. The slabs are one wave of the scatter kernel: the card's SMs
// times its resident CTAs (radix_slabs).
//
// Every launch takes the number of keys from device memory: the ragged
// step's keys come with a count that stays on the card (the hash stage
// writes it; hash_keys.cu) in a buffer sized by capacity, and the plane
// step, whose count the host knows, writes its count there too. The
// kernels partition keys [0, *count) (clamped to [0, n], n the buffer's
// length) and read nothing past them. Each histogram and scatter CTA
// derives its slab from that count and the grid (pass_keys), as
// slab_layout cuts n keys on the host: a slab layout fixed by capacity
// would leave CTAs idle wherever the count falls short of it. The offsets
// search [0, *count) only.
//
// The first design, a histogram and a scatter with returning atomics on a
// cursor array, is kept for measurement in partition_dissect.cu.
//
// Bound with ctypes; see kmer_mapper_tpu_torch/native.py.

#include <cstdint>
#include <cuda_runtime.h>

#include "block_partition.cuh"

namespace {

using namespace kmt_partition;

constexpr int kScanWarps = 8;  // warps of a scan CTA, which scans 32 digits

// The keys a launch partitions: the device count *count clamped to [0, n]
// (a count of -1 marks a chunk that gave no keys).
__device__ __forceinline__ long long launch_keys(long long n, const int* count) {
  return min(max(static_cast<long long>(*count), 0LL), n);
}

// The keys a pass partitions, and its slab length: the count cut into
// gridDim.x slabs as the host's slab_layout cuts it (ceil(max(n, 1) /
// slabs), rounded up to whole warp tiles); the CTAs past the count's last
// slab get none.
__device__ __forceinline__ long long pass_keys(long long n, const int* count,
                                               long long& slab_len) {
  n = launch_keys(n, count);
  const long long per = (max(n, 1LL) + gridDim.x - 1) / gridDim.x;
  slab_len = (per + kWarpTile - 1) / kWarpTile * kWarpTile;
  return n;
}

// Row s of the (slab, digit) matrix: the digits (bin >> shift) & mask of
// slab s's keys, counted in shared memory; every entry of the row is
// written, zeros too.
__global__ void __launch_bounds__(kThreads)
partition_histogram_kernel(const long long* __restrict__ keys, long long n,
                           const int* __restrict__ count, int* __restrict__ rows,
                           int log2_blocks, int shift, int mask, int width) {
  extern __shared__ int bins[];
  for (int b = threadIdx.x; b < width; b += kThreads) bins[b] = 0;
  __syncthreads();
  const int lane = threadIdx.x & 31;
  long long slab_len;
  n = pass_keys(n, count, slab_len);
  const long long first = blockIdx.x * slab_len;
  const long long end = min(n, first + slab_len);
  for (long long base = first + (threadIdx.x >> 5) * kWarpTile; base < end;
       base += kWarps * kWarpTile) {
    long long key[kItems];
    int bin[kItems];
    load_tile(keys, end, base, lane, log2_blocks, key, bin);
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      if (bin[j] >= 0) atomicAdd(&bins[(bin[j] >> shift) & mask], 1);
    }
  }
  __syncthreads();
  int* row = rows + static_cast<long long>(blockIdx.x) * width;
  for (int b = threadIdx.x; b < width; b += kThreads) row[b] = bins[b];
}

// The exclusive scan of each digit's column of the (slab, digit) matrix, in
// place, and each digit's total. CTA c scans digits 32c .. 32c + 31, one a
// lane; warp w takes a run of the slabs: it sums its run, the warps' sums
// are scanned in shared memory, and each warp walks its run again writing
// the running sum. Neighbouring lanes read neighbouring words of a row.
__global__ void __launch_bounds__(kScanWarps * 32)
partition_scan_kernel(int* __restrict__ rows, int* __restrict__ totals, int n_slabs,
                      int width) {
  __shared__ int part[kScanWarps][32];
  const int lane = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;
  const int d = blockIdx.x * 32 + lane;
  const int per_warp = (n_slabs + kScanWarps - 1) / kScanWarps;
  const int s0 = min(n_slabs, w * per_warp);
  const int s1 = min(n_slabs, s0 + per_warp);
  int* col = rows + d;
  int sum = 0;
  if (d < width) {
    for (int s = s0; s < s1; ++s) sum += col[static_cast<long long>(s) * width];
  }
  part[w][lane] = sum;
  __syncthreads();
  int run = 0;
  for (int v = 0; v < w; ++v) run += part[v][lane];
  if (d >= width) return;
  if (w == kScanWarps - 1) totals[d] = run + sum;
  for (int s = s0; s < s1; ++s) {
    const int c = col[static_cast<long long>(s) * width];
    col[static_cast<long long>(s) * width] = run;
    run += c;
  }
}

constexpr int kRadixThreads = 512;
constexpr int kRadixWarps = kRadixThreads / 32;
constexpr int kRadixItems = 8;  // keys a thread ranks in a tile
constexpr int kRadixTile = kRadixThreads * kRadixItems;  // 4096 keys, 32 KB
constexpr int kRadixMaxBits = 8;
constexpr int kRadixDigits = 1 << kRadixMaxBits;
// radix_offsets_launch searches for each bin's bound where the keys are at
// least this many times the bins, and else reads every key once
constexpr long long kSearchKeysABin = 64;

struct RadixSmem {
  long long tile[kRadixTile];            // the tile's keys, stably grouped by digit
  int warp_count[kRadixWarps][kRadixDigits];  // a warp's keys of each digit, then its base
  int cursor[kRadixDigits];              // the slab's next slot of each digit
  int start[kRadixDigits];               // a digit's first position in the tile
  int count[kRadixDigits];               // a digit's keys in the tile
};

// One LSD pass: slab s's keys, each written at its digit's cursor
// doff[d] + rows[s, d] (the scanned (slab, digit) matrix) plus its stable
// rank among the slab's keys of that digit. The slab goes in tiles of
// kRadixTile keys; a tile is ranked in shared memory (for each item of a
// warp, the lanes that share a digit found with one ballot a digit bit;
// each warp's running count of each digit; the warps' counts scanned in
// (digit, warp) order), stored grouped by digit, and written out in that
// order, so each digit's keys of a tile leave as one coalesced run.
// Stability: a tile's order is (warp, item, lane) = the slab's order, and
// the slab's tiles go in order, so equal digits keep the input order, and
// LSD passes compose into a sort by bin.
__global__ void __launch_bounds__(kRadixThreads)
radix_scatter_kernel(const long long* __restrict__ keys, long long n,
                     const int* __restrict__ count, const int* __restrict__ rows,
                     const int* __restrict__ doff, long long* __restrict__ out, int log2_blocks, int shift, int bits,
                     int width) {
  extern __shared__ __align__(16) unsigned char radix_smem[];
  RadixSmem& sm = *reinterpret_cast<RadixSmem*>(radix_smem);
  const int mask = (1 << bits) - 1;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const unsigned int below = (1u << lane) - 1u;
  const int* row = rows + static_cast<long long>(blockIdx.x) * width;
  for (int d = threadIdx.x; d < width; d += kRadixThreads) sm.cursor[d] = doff[d] + row[d];
  long long slab_len;
  n = pass_keys(n, count, slab_len);
  const long long first = blockIdx.x * slab_len;
  const long long end = min(n, first + slab_len);
  for (long long tile0 = first; tile0 < end; tile0 += kRadixTile) {
    for (int i = threadIdx.x; i < kRadixWarps * width; i += kRadixThreads) {
      sm.warp_count[i / width][i % width] = 0;
    }
    __syncthreads();
    // warp w ranks the tile's keys [w * 32 * kRadixItems, (w + 1) * ...)
    const long long base = tile0 + warp * 32 * kRadixItems;
    long long key[kRadixItems];
    int digit[kRadixItems], rank[kRadixItems];
#pragma unroll
    for (int j = 0; j < kRadixItems; ++j) {
      const long long i = base + 32 * j + lane;
      key[j] = i < end ? keys[i] : 0;
    }
#pragma unroll
    for (int j = 0; j < kRadixItems; ++j) {
      const bool valid = base + 32 * j + lane < end;
      digit[j] = valid ? (key_bin(key[j], log2_blocks) >> shift) & mask : 0;
      unsigned int peers = __ballot_sync(kFullMask, valid);
      for (int b = 0; b < bits; ++b) {
        const unsigned int ones = __ballot_sync(kFullMask, (digit[j] >> b) & 1);
        peers &= (digit[j] >> b) & 1 ? ones : ~ones;
      }
      const int seen = valid ? sm.warp_count[warp][digit[j]] : 0;
      rank[j] = seen + __popc(peers & below);
      __syncwarp();
      if (valid && (peers & below) == 0) sm.warp_count[warp][digit[j]] = seen + __popc(peers);
      __syncwarp();
    }
    __syncthreads();
    // each digit's warps in order: warp_count becomes the warp's base
    for (int d = threadIdx.x; d < width; d += kRadixThreads) {
      int run = 0;
      for (int w = 0; w < kRadixWarps; ++w) {
        const int c = sm.warp_count[w][d];
        sm.warp_count[w][d] = run;
        run += c;
      }
      sm.count[d] = run;
    }
    __syncthreads();
    if (warp == 0) {  // the digits' starts in the tile: a warp scan of 8-digit sums
      const int per_lane = kRadixDigits / 32;
      int sums[per_lane];
      int total = 0;
#pragma unroll
      for (int k = 0; k < per_lane; ++k) {
        const int d = lane * per_lane + k;
        sums[k] = d < width ? sm.count[d] : 0;
        total += sums[k];
      }
      int incl = total;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int v = __shfl_up_sync(kFullMask, incl, o);
        if (lane >= o) incl += v;
      }
      int run = incl - total;
#pragma unroll
      for (int k = 0; k < per_lane; ++k) {
        const int d = lane * per_lane + k;
        if (d < width) sm.start[d] = run;
        run += sums[k];
      }
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < kRadixItems; ++j) {
      if (base + 32 * j + lane < end) {
        sm.tile[sm.start[digit[j]] + sm.warp_count[warp][digit[j]] + rank[j]] = key[j];
      }
    }
    __syncthreads();
    const int tile_n = static_cast<int>(min(static_cast<long long>(kRadixTile), end - tile0));
    for (int p = threadIdx.x; p < tile_n; p += kRadixThreads) {
      const long long k = sm.tile[p];
      const int d = (key_bin(k, log2_blocks) >> shift) & mask;
      out[sm.cursor[d] + (p - sm.start[d])] = k;
    }
    __syncthreads();
    for (int d = threadIdx.x; d < width; d += kRadixThreads) sm.cursor[d] += sm.count[d];
  }
}

// off[b] for b <= n_blocks: the first position of the sorted keys whose bin
// is b or more (n where none is), two ways. radix_search_offsets_kernel: a
// thread a bin, a binary search of the keys (~26 reads a bin, the first
// steps shared by all). radix_offsets_kernel: thread i writes the bins in
// (bin of key i - 1, bin of key i], so every entry is written once, for
// one read of the keys; it takes tables with many bins for their keys.
__global__ void radix_search_offsets_kernel(const long long* __restrict__ sorted, long long n,
                                            const int* __restrict__ count,
                                            int* __restrict__ off, int log2_blocks) {
  const long long b = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
  if (b > (1LL << log2_blocks)) return;
  long long lo = 0, hi = launch_keys(n, count);
  while (lo < hi) {
    const long long mid = (lo + hi) >> 1;
    if (key_bin(sorted[mid], log2_blocks) < b) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  off[b] = static_cast<int>(lo);
}

__global__ void radix_offsets_kernel(const long long* __restrict__ sorted, long long n,
                                     const int* __restrict__ count, int* __restrict__ off,
                                     int log2_blocks) {
  const int n_blocks = 1 << log2_blocks;
  n = launch_keys(n, count);
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x; i <= n;
       i += static_cast<long long>(gridDim.x) * blockDim.x) {
    const int prev = i > 0 ? key_bin(sorted[i - 1], log2_blocks) : -1;
    const int cur = i < n ? key_bin(sorted[i], log2_blocks) : n_blocks;
    for (int b = prev + 1; b <= cur; ++b) off[b] = static_cast<int>(i);
  }
}

}  // namespace

// The partition's slab count: one wave of radix_scatter_kernel, the card's
// SMs times the CTAs of it that an SM holds. Returns the count, or minus a
// CUDA error code.
extern "C" int radix_slabs(int device) {
  int sms = 0, resident = 0;
  cudaError_t err = cudaSetDevice(device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(radix_scatter_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(sizeof(RadixSmem)));
  }
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&resident, radix_scatter_kernel,
                                                        kRadixThreads, sizeof(RadixSmem));
  }
  if (err != cudaSuccess) return -static_cast<int>(err);
  if (resident < 1) return -static_cast<int>(cudaErrorInvalidConfiguration);
  return sms * resident;
}

namespace {

// A device count and slabs to cut it into, and a pass's digit (bin >>
// shift) & (2**bits - 1) one of the bins' bits.
bool valid_pass_args(long long n, const void* count, int n_slabs, int log2_blocks, int shift,
                     int bits) {
  return valid_args(n, log2_blocks) && count != nullptr && n_slabs > 0 && bits >= 1 &&
         bits <= kRadixMaxBits && shift >= 0 && shift <= log2_blocks;
}

// A pass's digits: min(2**bits, (n_blocks >> shift) + 1).
int digit_width(int log2_blocks, int shift, int bits) {
  return min(1 << bits, ((1 << log2_blocks) >> shift) + 1);
}

}  // namespace

// Writes row s < n_slabs of rows int32[n_slabs, width]: the counts of the
// radix digit (bin >> shift) & (2**bits - 1) of keys [s*slab_len, min(c,
// (s+1)*slab_len)), where c is the int32 device count *count clamped to
// [0, n] (n the keys' length) and slab_len cuts c into the n_slabs slabs
// on the card (pass_keys; rows past the last slab with keys are zeros),
// width = min(2**bits, (n_blocks >> shift) + 1), bits in 1..8. Returns the
// first CUDA error (0 on success). Device pointers. Launches on `stream`
// of CUDA device `device` and does not synchronise.
extern "C" int partition_histogram_launch(const void* keys, long long n, const void* count,
                                          void* rows, int n_slabs, int log2_blocks, int shift,
                                          int bits, int device, void* stream) {
  if (!valid_pass_args(n, count, n_slabs, log2_blocks, shift, bits)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess || n == 0) return static_cast<int>(err);
  const int width = digit_width(log2_blocks, shift, bits);
  partition_histogram_kernel<<<n_slabs, kThreads, sizeof(int) * width,
                               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const long long*>(keys), n, static_cast<const int*>(count),
      static_cast<int*>(rows), log2_blocks, shift, (1 << bits) - 1, width);
  return static_cast<int>(cudaGetLastError());
}

// Scans rows int32[n_slabs, width] down each column in place (exclusive)
// and writes each column's total to totals int32[width], width at most
// 2**8. Returns the first CUDA error (0 on success). Device pointers.
// Launches on `stream` of CUDA device `device` and does not synchronise.
extern "C" int partition_scan_launch(void* rows, void* totals, int n_slabs, int width,
                                     int device, void* stream) {
  if (n_slabs < 1 || width < 1 || width > kRadixDigits) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  partition_scan_kernel<<<(width + 31) / 32, kScanWarps * 32, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<int*>(rows), static_cast<int*>(totals), n_slabs, width);
  return static_cast<int>(cudaGetLastError());
}

// One LSD pass: each of the device count's keys of slab s (cut as
// partition_histogram_launch cut them) is written into out int64[n] at
// doff[d] + rows[s, d] + its stable rank among the slab's keys of digit d
// = (bin >> shift) & (2**bits - 1); out past the count is left as it
// was. rows is the scanned (slab, digit) matrix, doff its digits' first
// slots. bits in 1..8. Returns the first CUDA error (0 on success). Device
// pointers. Launches on `stream` of CUDA device `device` and does not
// synchronise.
extern "C" int radix_scatter_launch(const void* keys, long long n, const void* count,
                                    const void* rows, const void* doff, void* out,
                                    int n_slabs, int log2_blocks, int shift, int bits,
                                    int device, void* stream) {
  if (!valid_pass_args(n, count, n_slabs, log2_blocks, shift, bits)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess || n == 0) return static_cast<int>(err);
  err = cudaFuncSetAttribute(radix_scatter_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(sizeof(RadixSmem)));
  if (err != cudaSuccess) return static_cast<int>(err);
  radix_scatter_kernel<<<n_slabs, kRadixThreads, sizeof(RadixSmem),
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const long long*>(keys), n, static_cast<const int*>(count),
      static_cast<const int*>(rows), static_cast<const int*>(doff),
      static_cast<long long*>(out), log2_blocks, shift, bits,
      digit_width(log2_blocks, shift, bits));
  return static_cast<int>(cudaGetLastError());
}

// off int32[2**log2_blocks + 1]: off[b] the first position of the device
// count's first keys (clamped to [0, n]), sorted by bin, whose bin is b or
// more; by binary searches where n is at least kSearchKeysABin times the
// bins, else by one read of the keys. Returns the first CUDA error (0 on
// success). Device pointers. Launches on `stream` of CUDA device `device`
// and does not synchronise.
extern "C" int radix_offsets_launch(const void* sorted, long long n, const void* count,
                                    void* off, int log2_blocks, int device, void* stream) {
  if (!valid_args(n, log2_blocks) || count == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long n_off = (1LL << log2_blocks) + 1;
  const auto* k = static_cast<const long long*>(sorted);
  const auto* c = static_cast<const int*>(count);
  auto* o = static_cast<int*>(off);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_off * kSearchKeysABin <= n) {
    radix_search_offsets_kernel<<<static_cast<unsigned int>((n_off + 255) / 256), 256, 0, s>>>(
        k, n, c, o, log2_blocks);
  } else {
    const long long blocks = (n + 1 + kThreads - 1) / kThreads;
    radix_offsets_kernel<<<static_cast<unsigned int>(blocks < 4096 ? blocks : 4096), kThreads,
                           0, s>>>(k, n, c, o, log2_blocks);
  }
  return static_cast<int>(cudaGetLastError());
}
