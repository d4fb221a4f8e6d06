// Gather probe for NVIDIA Hopper (sm_90a): every pre-hashed library call
// (KmerMapper.map_hashes and in_index, and through them compat's
// map_kmers_to_graph_index, in_graph_index and GpuCounter.count).
//
// Replaces kmer_mapper_tpu/ops/probe.py:probe_hits with accumulate_scatter
// (:31, :117) in mode kCount and probe_slots (:78) in mode kSlots. Those are
// XLA code on the TPU, not a Pallas kernel: per probe round they gather a
// bucket row for every query and compare it with an (n, 8) lane mask, which
// torch eager would write to device memory once per round. This kernel
// computes what they compute: for each query i, the caller's uint64 k-mer
// hash (an int64 bit pattern) is split into its (lo, hi) words and mixed
// with the three-round Feistel of u32hash.feistel_mix; a query whose mixed
// pair is all-ones (the empty-slot sentinel) never matches; bucket b0 =
// m_lo >> shift (0 for a one-bucket table); for rounds p < min(max_probe,
// block_probe[b0 / bpb]) (chain.cuh; max_probe alone without block_probe)
// the query compares its pair with the 8 keys of bucket (b0 & ~mask) |
// ((b0 + p) & mask), mask = bpb - 1, bpb = min(128, n_buckets). An index
// shard (parallel/sharded.py) passes its rows [row_offset, row_offset +
// n_local) of a table of n_buckets: buckets, chains and block bounds are the
// whole table's, a round in another shard's rows compares nothing, and the
// slots are the shard's (row - row_offset)*8 + lane, as in probe_hits with
// row_offset and n_buckets_global (:60-70). The first
// hit adds one to counts[b*8 + lane] (kCount, valid queries only; the int32
// add wraps as the reference's uint32) or is written as the slot, -1 for a
// miss (kSlots). Keys are unique in the table, so stopping at the first hit
// gives probe_hits' result, and the block bound is exact: a key stored
// further than its block's bound from home does not exist.
//
// What bounds it: per query 8 bytes in and 4 out (kSlots), and per round a
// random 32-byte row of lo words, plus the hi word where a lo word matched:
// device-memory bytes at random rows, which the hits' hi words and count
// adds and the query stream push out of the 50 MB L2. The design, each
// point measured on the card against its other side
// (scripts/gather_probe_dissect.py, PERF.md):
//  * raw words in: one 8-byte evict-first load per query (__ldcs), split in
//    registers; slots stored evict-first (__stcs), so the query and slot
//    streams do not evict the table;
//  * per-block chain bounds: a miss walks its own block's bound, mostly 1,
//    not the table's max_probe;
//  * the lo rows are loaded with an evict-last L2 policy, so they stay in
//    L2 where they fit (on a table ten times the L2 it neither wins nor
//    loses), and the hi words and count adds, one a hit, with an
//    evict-first policy, so they do not push the lo rows out;
//  * one query a thread, at full occupancy; round 0's row is requested
//    before the block bound is read;
//  * counts: no valid array unless the caller passes one; the hits of one
//    slot within a warp are added by one add of their number
//    (__match_any_sync), so a hot k-mer does not serialise 32 atomics on one
//    address.
// No shared memory: the queries are unsorted, so nothing is reused within a
// CTA.
//
// Bound with ctypes; see kmer_mapper_tpu_torch/native.py.

#include <cstdint>
#include <cuda_runtime.h>

#include "gather_probe.cuh"

namespace {

using namespace kmt_gather;

template <int M>
__global__ void __launch_bounds__(kThreads)
gather_probe_kernel(Table t, const long long* __restrict__ queries,
                    const bool* __restrict__ valid,
                    unsigned int* __restrict__ counts,
                    int32_t* __restrict__ out, int64_t n) {
  const Policies policy = {l2_policy(kEvictLast), l2_policy(kEvictFirst)};
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;

  bool live = i < n;
  const long long q = live ? __ldcs(queries + i) : 0;
  if (M == kCount && live && valid != nullptr && !valid[i]) live = false;
  uint32_t L, R;
  live = mixed_words(q, t.seed, L, R) && live;
  const uint32_t b0 = live ? home_bucket(t, L) : 0u;

  int64_t slot = -1;
  if (live) {
    // round 0, the home bucket: its row is requested before the bound
    const int64_t r0 = local_row(t, b0);
    uint4 w0 = {0u, 0u, 0u, 0u}, w1 = w0;
    if (r0 >= 0) {
      w0 = load_lo(t.lo + 2 * r0, policy.rows);
      w1 = load_lo(t.lo + 2 * r0 + 1, policy.rows);
    }
    const int rounds = query_rounds(t, b0);
    const uint32_t lanes = r0 >= 0 ? lo_lanes(w0, w1, L) : 0u;
    if (lanes) slot = check_hi(t, r0, lanes, R, policy.hits);
    // the chain beyond the home bucket, where the block has one
    if (slot < 0 && rounds > 1) slot = walk(t, L, R, b0, 1, rounds, policy);
  }

  if (M == kSlots) {
    if (i < n) __stcs(out + i, static_cast<int32_t>(slot));
  } else {
    // every lane of the warp takes part, hit or not; the lowest lane of
    // each group of equal slots adds the group's size
    const unsigned int peers =
        __match_any_sync(0xFFFFFFFFu, static_cast<unsigned long long>(slot));
    if (slot >= 0 && static_cast<int>(threadIdx.x & 31) == __ffs(peers) - 1) {
      add_count(counts + slot, static_cast<unsigned int>(__popc(peers)), policy.hits);
    }
  }
}

}  // namespace

// Probes n raw queries; returns cudaGetLastError() after the launch (0 on
// success). Device pointers: key_lo and key_hi uint32[n_local*8], the rows
// [row_offset, row_offset + n_local) of a table of n_buckets, in slot
// order (key_lo 16-byte aligned); block_probe int32[n_blocks], n_blocks =
// n_buckets / min(128, n_buckets), or null with n_blocks 0 (every query
// walks max_probe rounds); queries int64[n], the hashes' uint64 bits; mode
// kCount reads valid bool[n] unless it is null (every query valid) and adds
// into counts uint32[n_local*8]; mode kSlots writes out int32[n] (the
// wrapper refuses tables of 2**31 slots or more). Launches on `stream` of
// CUDA device `device` and does not synchronise.
extern "C" int gather_probe_launch(const void* key_lo, const void* key_hi,
                                   const void* block_probe, const void* queries,
                                   const void* valid, void* counts, void* out,
                                   long long n, int n_buckets, int n_blocks,
                                   int max_probe, unsigned int seed, int mode,
                                   int row_offset, int n_local, int device, void* stream) {
  if (!valid_launch(n, n_buckets, n_blocks, max_probe, mode, key_lo, block_probe) ||
      !valid_shard(n_buckets, row_offset, n_local)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // this library links its own CUDA runtime, whose current device is not
  // PyTorch's
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  if (n == 0) return static_cast<int>(cudaGetLastError());
  const Table t =
      make_table(key_lo, key_hi, block_probe, n_buckets, max_probe, seed, row_offset, n_local);
  const auto* q = static_cast<const long long*>(queries);
  const unsigned int grid = static_cast<unsigned int>((n + kThreads - 1) / kThreads);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (mode == kCount) {
    gather_probe_kernel<kCount><<<grid, kThreads, 0, s>>>(
        t, q, static_cast<const bool*>(valid), static_cast<unsigned int*>(counts), nullptr, n);
  } else {
    gather_probe_kernel<kSlots><<<grid, kThreads, 0, s>>>(t, q, nullptr, nullptr,
                                                          static_cast<int32_t*>(out), n);
  }
  return static_cast<int>(cudaGetLastError());
}
