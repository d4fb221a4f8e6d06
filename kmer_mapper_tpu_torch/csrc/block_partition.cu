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
//  * radix_scatter_kernel: CTA s walks its slab in tiles of 8,192 keys,
//    ranks each tile stably in shared memory and writes it out grouped by
//    digit, so that each digit's keys of a tile leave as one run (~64 keys
//    at 128 digits). Like a copy it reads and writes each key once: 0.514
//    ms a pass for the human-scale buffer's 107.6M keys at 3.35 TB/s, and
//    a device-to-device copy of them takes 0.572 ms. What bounds it is
//    the work a tile takes between its read and its write. The first
//    design read 4,096-key tiles with plain loads, then ranked each (a
//    ballot a digit bit of every key), grouped it and wrote it behind six
//    barriers, so a CTA's reads stopped for most of each tile: 1.06 ms a
//    128-digit pass. Here the tiles come through a ring of two stages in
//    shared memory, each filled by one bulk copy (TMA, one thread a tile,
//    completing on an mbarrier) a tile ahead, so the next tile's reads are
//    in flight while this one is ranked and written; a key is ranked by an
//    atomicOr into its digit's word of its warp's row, which then names
//    the lanes that share the digit, and one atomicAdd a group (the
//    ballots were half the ranking's time); four barriers a tile. The ring
//    fills an SM's shared memory, one CTA of 1,024 threads: its tiles,
//    twice the first design's, write runs twice as long, which the
//    128-digit passes needed most (0.85 ms at 4,096 keys, 0.73 at 8,192;
//    0.65 at 33 digits; PERF.md). What is left is shared memory and the
//    runs' writes: a key is stored and loaded at random slots to group it.
//    Stable, so the passes compose into a sort by bin, equal to the plain
//    twin's stable order.
// radix_offsets_launch then finds each bin's first position in the sorted
// keys (a binary search a bin, or one read of the keys where the bins are
// many). A pass reads and writes each key once, plus one read for its
// histogram. The slabs are one wave of the histogram kernel: the card's SMs
// times its resident CTAs (radix_slabs); the scatter takes them in waves.
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

#include "async_copy.cuh"
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

constexpr int kRadixThreads = 1024;
constexpr int kRadixWarps = kRadixThreads / 32;
constexpr int kRadixItems = 8;  // keys a thread ranks in a tile
constexpr int kRadixTile = kRadixThreads * kRadixItems;  // 8192 keys, 64 KB
constexpr int kRadixStages = 2;  // tiles of the ring
constexpr int kRadixCtas = 1;    // resident CTAs an SM (the ring takes most of its shared memory)
// a stage's slots: the tile, one slot of skew (RadixLoad) and one that
// keeps the stages on 16 bytes
constexpr int kRadixSlots = kRadixTile + 2;
constexpr int kRadixMaxBits = 8;
constexpr int kRadixDigits = 1 << kRadixMaxBits;
// the scan of a tile's counts: kDigitThreads neighbouring threads a digit,
// each summing kDigitWarps warps' counts of it
constexpr int kDigitThreads = kRadixThreads / kRadixDigits;
constexpr int kDigitWarps = kRadixWarps / kDigitThreads;
// the row stride of the warps' counts: the digit's threads' rows fall in
// distinct banks
constexpr int kCountStride = kRadixDigits + 1;
// radix_offsets_launch searches for each bin's bound where the keys are at
// least this many times the bins, and else reads every key once
constexpr long long kSearchKeysABin = 64;

struct RadixSmem {
  long long stage[kRadixStages][kRadixSlots];  // the ring: tile t in stage t % kRadixStages
  int count[kRadixWarps][kCountStride];  // a warp's keys of each digit, then its first slot
  unsigned int lanes[kRadixWarps][kRadixDigits];  // a warp's lanes of each digit in an item
  int base[kRadixDigits];                // grouped key p of digit d goes to out[base[d] + p]
  int warp_sum[kRadixWarps];             // the scan's sum of each warp's threads
  uint64_t full[kRadixStages];           // mbarrier: the stage's tile has landed
  unsigned char digit[kRadixTile];       // each grouped key's digit
};

// A pass's digit of a key, (key_bin(key) >> shift) & mask, from the key's
// top word alone: the bin is its top log2_blocks bits (at most 30).
struct RadixDigit {
  unsigned int down;  // 32 - log2_blocks + shift; 32 or more leaves no bit
  int mask;
  int invalid;  // the invalid key's digit, that of bin n_blocks

  __device__ __forceinline__ RadixDigit(int log2_blocks, int shift, int bits)
      : down(32 - log2_blocks + shift), mask((1 << bits) - 1),
        invalid(((1 << log2_blocks) >> shift) & ((1 << bits) - 1)) {}

  __device__ __forceinline__ int operator()(long long key) const {
    if (key == kInvalidKey) return invalid;
    const unsigned int top =
        static_cast<unsigned int>(static_cast<unsigned long long>(key) >> 32) ^ 0x80000000u;
    return down < 32 ? static_cast<int>(top >> down) & mask : 0;
  }
};

// Where a tile's keys come from. The bulk copy wants 16-byte addresses and
// a whole number of 16-byte pairs, and keys may lie on 8 bytes only (a
// view keys[1:]): key i of the tile lands in slot i + skew of its stage,
// where skew is 1 if the keys' base lies 8 bytes off 16 (every tile starts
// a whole number of warp tiles into the keys, so on the same parity), and
// keys [lo, hi), whole pairs, come by the copy; the one before lo and the
// one at hi, where the tile has them, are read from device memory by the
// thread that ranks them.
struct RadixLoad {
  long long tile0;  // the tile's first key
  int n;            // its keys: kRadixTile, or fewer in a slab's last tile
  int lo, hi;

  __device__ __forceinline__ RadixLoad(long long first, long long end, int t, int skew) {
    tile0 = first + static_cast<long long>(t) * kRadixTile;
    n = static_cast<int>(min(static_cast<long long>(kRadixTile), end - tile0));
    lo = min(skew, n);
    hi = lo + ((n - lo) & ~1);
  }
};

// One thread starts tile t's bulk copy into its stage (an arrival alone
// where the tile has no whole pair).
__device__ __forceinline__ void radix_issue(RadixSmem& sm, const long long* __restrict__ keys,
                                            long long first, long long end, int t, int skew) {
  const RadixLoad ld(first, end, t, skew);
  uint64_t* bar = &sm.full[t % kRadixStages];
  if (ld.hi == ld.lo) {
    kmt_copy::mbar_arrive(bar);
    return;
  }
  const unsigned int bytes = static_cast<unsigned int>(ld.hi - ld.lo) * sizeof(long long);
  kmt_copy::mbar_arrive_expect_tx(bar, bytes);
  kmt_copy::bulk_copy(&sm.stage[t % kRadixStages][ld.lo + skew], keys + ld.tile0 + ld.lo, bytes,
                      bar);
}

// One LSD pass: slab s's keys, each written at its digit's cursor
// doff[d] + rows[s, d] (the scanned (slab, digit) matrix) plus its stable
// rank among the slab's keys of that digit. The slab goes in tiles of
// kRadixTile keys through a ring of kRadixStages stages in shared memory:
// thread 0 starts each tile's bulk copy as soon as its stage is free, so
// the next tile lands while the CTA ranks and writes out this one. A tile:
//  1. each warp ranks its 256 keys from the stage, an item (32 keys) at a
//     time: each lane ORs its bit into its digit's word of the warp's row
//     of `lanes`, which then holds the lanes that share its digit; the
//     last of them adds their number to the digit's running count in the
//     warp's row of `count`, hands the count before it to the others and
//     clears the word. Each key's digit is computed once and kept with its
//     rank;
//  2. one scan of the warps' counts in (digit, warp) order, kDigitThreads
//     threads a digit, gives each warp's first slot of each digit in
//     the grouped tile, and each digit's out position (`base`: its cursor
//     less its first slot), and moves the cursors on;
//  3. each thread stores its keys grouped by digit into the stage it
//     ranked from (every key of the tile is in registers by then), each
//     with its digit;
//  4. the grouped tile is written out in order: each digit's keys of a
//     tile leave as one coalesced run.
// Four block-wide barriers a tile, after 1, the scan's first half, 2 and
// 3; the first also frees the previous tile's stage for the copy of the
// tile kRadixStages - 1 ahead.
// Stability: a tile's order is (warp, item, lane) = the slab's order, and
// the slab's tiles go in order, so equal digits keep the input order, and
// LSD passes compose into a sort by bin.
__global__ void __launch_bounds__(kRadixThreads, kRadixCtas)
radix_scatter_kernel(const long long* __restrict__ keys, long long n,
                     const int* __restrict__ count, const int* __restrict__ rows,
                     const int* __restrict__ doff, long long* __restrict__ out, int log2_blocks,
                     int shift, int bits, int width) {
  extern __shared__ __align__(16) unsigned char radix_smem[];
  RadixSmem& sm = *reinterpret_cast<RadixSmem*>(radix_smem);
  const RadixDigit digit_of(log2_blocks, shift, bits);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const unsigned int below = (1u << lane) - 1u;
  long long slab_len;
  n = pass_keys(n, count, slab_len);
  const long long first = blockIdx.x * slab_len;
  const long long end = min(n, first + slab_len);
  const int tiles = first < end ? static_cast<int>((end - first + kRadixTile - 1) / kRadixTile) : 0;
  const int skew = static_cast<int>(reinterpret_cast<uintptr_t>(keys) >> 3) & 1;
  // the scan's thread: digit scan_d, warps scan_w .. scan_w + kDigitWarps
  const int scan_d = threadIdx.x / kDigitThreads;
  const int scan_w = threadIdx.x % kDigitThreads * kDigitWarps;
  const bool scans = scan_d < width;
  // the digit's first thread keeps the slab's next slot of that digit
  int cursor = 0;
  if (scans && scan_w == 0) {
    cursor = doff[scan_d] + rows[static_cast<long long>(blockIdx.x) * width + scan_d];
  }
  for (int i = threadIdx.x; i < kRadixWarps * kRadixDigits; i += kRadixThreads) {
    (&sm.lanes[0][0])[i] = 0u;  // each item's last lanes clear their words again
  }
  if (threadIdx.x == 0) {
    for (int s = 0; s < kRadixStages; ++s) kmt_copy::mbar_init(&sm.full[s], 1);
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int t = 0; t < kRadixStages && t < tiles; ++t) radix_issue(sm, keys, first, end, t, skew);
  }
  for (int t = 0; t < tiles; ++t) {
    const RadixLoad ld(first, end, t, skew);
    long long* stage = sm.stage[t % kRadixStages];
    for (int d = lane; d < width; d += 32) sm.count[warp][d] = 0;
    kmt_copy::mbar_wait(&sm.full[t % kRadixStages], (t / kRadixStages) & 1);
    // 1. warp w ranks the tile's keys [w * 32 * kRadixItems, (w + 1) * ...)
    const int i0 = warp * 32 * kRadixItems + lane;
    long long key[kRadixItems];
    int dr[kRadixItems];  // digit << 16 | rank in the warp
#pragma unroll
    for (int j = 0; j < kRadixItems; ++j) {
      const int i = i0 + 32 * j;
      key[j] = i >= ld.n ? 0 : i >= ld.lo && i < ld.hi ? stage[i + skew] : keys[ld.tile0 + i];
    }
    __syncwarp();  // the warp's zeroed row before any lane reads it
#pragma unroll
    for (int j = 0; j < kRadixItems; ++j) {
      const bool valid = i0 + 32 * j < ld.n;
      const int digit = valid ? digit_of(key[j]) : 0;
      unsigned int* word = &sm.lanes[warp][digit];
      if (valid) atomicOr(word, 1u << lane);
      __syncwarp();
      const unsigned int peers = valid ? *word : 0u;
      const int last = 31 - __clz(peers);
      int seen = 0;
      if (valid && lane == last) seen = atomicAdd(&sm.count[warp][digit], __popc(peers));
      seen = __shfl_sync(kFullMask, seen, last & 31);
      if (valid && lane == last) *word = 0u;
      dr[j] = digit << 16 | (seen + __popc(peers & below));
      __syncwarp();
    }
    __syncthreads();
    // the stage of tile t - 1 is free: start the copy of tile t - 1 + kRadixStages
    if (threadIdx.x == 0 && t > 0 && t - 1 + kRadixStages < tiles) {
      radix_issue(sm, keys, first, end, t - 1 + kRadixStages, skew);
    }
    // 2. the counts in (digit, warp) order, scanned across the CTA
    int c[kDigitWarps];
    int sum = 0;
#pragma unroll
    for (int v = 0; v < kDigitWarps; ++v) {
      c[v] = scans ? sm.count[scan_w + v][scan_d] : 0;
      sum += c[v];
    }
    int incl = sum;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int v = __shfl_up_sync(kFullMask, incl, o);
      if (lane >= o) incl += v;
    }
    int total = sum;  // the digit's keys in the tile
#pragma unroll
    for (int o = 1; o < kDigitThreads; o <<= 1) total += __shfl_xor_sync(kFullMask, total, o);
    if (lane == 31) sm.warp_sum[warp] = incl;
    __syncthreads();
    int before = lane < warp ? sm.warp_sum[lane] : 0;  // the warps before this one
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) before += __shfl_xor_sync(kFullMask, before, o);
    int run = before + incl - sum;
    if (scans) {
      if (scan_w == 0) {
        sm.base[scan_d] = cursor - run;
        cursor += total;
      }
#pragma unroll
      for (int v = 0; v < kDigitWarps; ++v) {
        sm.count[scan_w + v][scan_d] = run;
        run += c[v];
      }
    }
    __syncthreads();
    // 3. the tile grouped by digit, in place, each key with its digit
#pragma unroll
    for (int j = 0; j < kRadixItems; ++j) {
      if (i0 + 32 * j < ld.n) {
        const int digit = dr[j] >> 16;
        const int p = sm.count[warp][digit] + (dr[j] & 0xFFFF);
        stage[p] = key[j];
        sm.digit[p] = static_cast<unsigned char>(digit);
      }
    }
    __syncthreads();
    // 4. written out in order
#pragma unroll
    for (int j = 0; j < kRadixItems; ++j) {
      const int p = threadIdx.x + j * kRadixThreads;
      if (p < ld.n) out[sm.base[sm.digit[p]] + p] = stage[p];
    }
    // before the stage's next bulk copy, which the next tile's first
    // barrier lets thread 0 start
    kmt_copy::fence_proxy_async();
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

// The partition's slab count: one wave of partition_histogram_kernel, the
// card's SMs times the CTAs of it that an SM holds (at its widest digit).
// The histogram only streams its slabs' keys and needs that many CTAs'
// loads in flight; radix_scatter_kernel, one CTA an SM for its ring, takes
// the same slabs in waves. Returns the count, or minus a CUDA error code
// (an error too where the scatter kernel fits no SM).
extern "C" int radix_slabs(int device) {
  int sms = 0, resident = 0, scatter = 0;
  cudaError_t err = cudaSetDevice(device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&resident, partition_histogram_kernel,
                                                        kThreads, sizeof(int) * kRadixDigits);
  }
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(radix_scatter_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(sizeof(RadixSmem)));
  }
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&scatter, radix_scatter_kernel,
                                                        kRadixThreads, sizeof(RadixSmem));
  }
  if (err != cudaSuccess) return -static_cast<int>(err);
  if (resident < 1 || scatter < 1) return -static_cast<int>(cudaErrorInvalidConfiguration);
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
