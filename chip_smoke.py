#!/usr/bin/env python3
"""Smoke test of kmer_mapper_tpu_torch on one NVIDIA GPU.

Run from the repository root:  python3 chip_smoke.py

Phases (a failing phase raises, the script exits non-zero and prints no
result line):
  1. environment: torch, CUDA, the card's name and power limit, nvcc;
  2. build the CUDA kernels from kmer_mapper_tpu_torch/csrc with nvcc;
  3. the stream-count kernel against its plain-torch twin and the host
     oracle on every hazard case of its contract, on sorted and on
     shuffled, partitioned windows; the two hash-key kernels (plane and
     ragged, with the ragged step's offsets kernel and its count) against
     theirs on every case of ops/hash_keys_cases.py (exact equality, the
     keys in the same order); and the block partition
     against its twin on every case of ops/block_partition_cases.py (the
     main path's kernels: the twin's keys in the twin's order; the cursor
     route of scripts/partition_dissect.py with its histogram in shared
     and in device memory: offsets exact, every key in its own block's
     window, the windows equal as multisets), each of the main path's
     partition kernels against its plain piece, each table case then
     counted == the oracle;
  4. the main path as a user runs it: ``kmer_mapper_tpu_torch.cli map`` on
     a FASTQ of 10^5 151-bp reads against the bench index (~2.6M unique
     31-mers in 2^20 buckets); node counts must equal the numpy oracle's
     modulo-index probe, and the plane hash-key kernel, the partition
     kernels and the count kernel must have run (no twin);
  5. steady state on 8 distinct device-resident 64 Mi-base chunks of 151-bp
     reads: k-mers per second through KmerMapper.map_chunk and through the
     same stages with the plain twins, per-stage milliseconds (hash keys,
     partition, count), equal counts, one chunk's node counts == the
     oracle's; on that chunk's keys each partition kernel against its
     plain piece, timed with it (histogram rows, scan, scatter of each
     pass; the offsets), the kernels pass by pass at one CTA an SM, the
     partition whole beside the cursor route (the first partition
     kernels) whole and in its kernels, the twin and torch.sort + count_offsets; the same keys
     partitioned for tables of 2^22, 2^25 and 2^29 buckets, on the main
     path and on the cursor route; the count kernel, the per-block
     dissection kernel (r2_kernel_dissect's full, the count's design with
     nothing removed) and the split-window one (r2_window_dissect's full)
     on the grouped and on the sorted keys;
     then the ragged step the same way on the same bases cut into reads of
     100-151 bp (8 chunks, each one continuous buffer; stages offsets, hash
     keys, partition with the device count, count); its 8 buffers mapped
     once more under torch.cuda.set_sync_debug_mode("error"), so any host
     sync in the step raises; the offsets' kernel, the hash kernel and the
     function whole against the twins; the device-count partition of the
     capacity key buffer == the twin on the count's keys;
  6. dissect: the three dissection scripts of kmer_mapper_tpu_torch.scripts
     run as a user runs them, at their full sizes (their kernels must have
     launched); then every variant of each kernel against its twin, bit for
     bit, also on the stream-count hazard cases the TPU grid takes (empty
     slots, buckets of one key), r2_kernel_dissect's full against
     stream_count, and the
     split-window r2_window_dissect's full against both and the oracle on
     its chunk and on a poly-A window (every variant there too), its
     schedule kernels against their twin, timed on both beside the
     per-block kernels; r3_iter_floor's vmem and dma beside their
     serial-chain floor; on a ragged
     chunk, count_offsets (which end at the invalid tail, as the
     partition's windows do) leave the last chain block's window without
     invalid queries;
  7. tiles: the three r9 tile-body scripts of kmer_mapper_tpu_torch.scripts
     (r9_dot_orient, r9_step_parts, r9_block_pipeline) run as a user runs
     them, at their full sizes (their kernels must have launched); then
     every variant against its twin, bit for bit, with hits, and on each
     hazard input (carried, -0.0 and non-byte planes; all-ones keys and
     lanes, buckets of one key), and the candidates and loop trips of
     their fingerprinted tiles on the main's inputs, counted in torch;
  8. library: the pre-hashed calls on the bench index, as KAGE calls them:
     compat.map_kmers_to_graph_index on 2^24 hashes, in_graph_index on
     2^24, map_hashes on 2^16 and GpuCounter with reverse complements on
     2^22, each equal to the numpy oracle, with the launch counts zeroed
     before and read after (the gather kernel must run, stream_count and
     the twins not); a second call on 2^26 hashes that must reuse the
     cached mapper, timed and split into upload, kernel and node counts;
     one piece's upload, pageable and page-locked; the gather kernel
     against its twins on every hazard case; the device ms of the stream
     and gather routes at 2^12 ... 2^26 hashes; both modes' ms, rounds a
     query, bounds and row-traffic times at 2^24 on the bench index, a
     skewed, a hit-only and a miss-only batch, and a table of 2^23 buckets
     (ten times the L2). (The design points of the gather kernel are
     timed on demand by kmer_mapper_tpu_torch.scripts.gather_probe_dissect.)
  9. file feed: the reads of phase 5's 8 chunks written as one FASTQ (~1.1
     GB), the first chunk's as FASTQ, .fq.gz (zlib level 1) and BGZF, each
     mapped through ``kmer_mapper_tpu_torch.cli map``: (a) the numpy framer
     on the one-chunk file, (b) the native loader with -t 1 and (c) with
     -t 8 and --profile-dir on the 8-chunk file, (f) as (c) without the
     profiler, (d) the .fq.gz and (e) the BGZF file, and (g) the first
     ragged chunk's reads as FASTQ; every node-count vector must equal a
     fresh map_chunk pass over the same chunks, stream_count, the partition
     kernels and the hash-key kernel of the run's step must have launched
     and no twin, and the
     native loader must have framed (b)-(g). Prints each run's wall
     seconds, bases and k-mers per second, the seconds the mapping loop
     waited on the host feed and the gzip decoder; from (c)'s trace, the
     device's busy share of the mapping window.
 10. sharded: the node-count finalize kernel against its twin, numpy and
     the host finalize on the hazard cases of ops/finalize_cases.py, each
     in its own entry order, shuffled and sorted by slot; the finalize of
     phase 8's 2^26-hash call (entries in slot order, as the mappers upload
     them) timed beside the twin, the host, an int64 index_add_ of the
     gathered weights and the gather, where and index_add_ in torch (the
     finalize's other designs are timed on demand by
     kmer_mapper_tpu_torch.scripts.finalize_dissect); phase 5's chunks
     through ShardedKmerMapper on (data, index) grids (1,1), (2,1), (1,2), (2,2) of the card, node counts
     == KmerMapper's, M k-mers/s a grid; sharded map_hashes on phase 8's
     2^23-bucket table over 4 index shards and on a 512-bucket table over 8
     sub-block shards == KmerMapper's; map_file_sharded over 4 cells (2
     index shards) on phase 9's FASTQ == map_file's counts; with two cards
     or more, the grids and the file path over distinct cards and the
     two-card tests of tests/test_torch_kernels.py. Each run's launch counts
     are zeroed before it and read after (stream_count, gather_probe and
     node_counts must run, no twin).
The line before the last is a JSON object describing each kernel, with its
bound: the larger of its bytes over 3.35 TB/s (the H100 SXM's memory rate)
and its 32-bit integer operations over the card's INT32 rate (SMs x 64
INT32 lanes per SM x the largest SM clock, as nvidia-smi reports it); the
last line is {"ok": true, "device": {...}}. Needs no network and one GPU.
"""
from __future__ import annotations

import functools
import json
import logging
import os
import shutil
import subprocess
import sys
import tempfile
import time

K = 31
READ_LEN = 151
N_CHUNKS = 8  # distinct device-resident chunks in each timed window
N_WINDOWS = 3
E2E_READS = 100_000
POLY_A = 2_000_000  # poly-A k-mers in one chain block's window
INDEX_UNIFORM = 2_000_000  # bench.py's recipe: half uniform random keys,
INDEX_FROM_READS = 2_000_000  # half drawn from the first 5000 reads' k-mers
HBM_BYTES_PER_S = 3.35e12  # H100 SXM
INT32_LANES_PER_SM = 64  # Hopper SM: 4 partitions x 16 INT32 units
DISSECT_POLY_A = 200_000  # poly-A queries in one window, phase 6
#: cycles of one dependent FP32 add on Hopper: the step of r3_iter_floor's
#: serial chains (vmem, dma)
FADD_CYCLES = 4
LIB_HASHES = 1 << 24  # hashes of the library calls held to the oracle, phase 8
LIB_TIMED = 1 << 26  # hashes of the timed map_kmers_to_graph_index call
LIB_GATHER = 1 << 16  # a small map_hashes batch
LIB_COUNTER = 1 << 22  # hashes counted by GpuCounter (and their revcomps)
CROSSOVER = [1 << e for e in range(12, 27, 2)]  # batch sizes timed on both routes
LARGE_TABLE_KEYS = 1 << 24  # random keys of the table ten times the L2, phase 8
LARGE_TABLE_BUCKETS = 1 << 23  # 537 MB of key words
RAGGED_MIN, RAGGED_MAX = 100, 151  # read lengths of the ragged steady state
#: INT32 operations a key of the block partition, counted from
#: csrc/block_partition.cu: per pass (histogram, scatter) the key's compare
#: with the invalid key and its block (about 4), the bounds check, the match
#: and the leader test (about 4); the scatter's rank, shuffle and address
#: (about 4)
PARTITION_OPS = 20
#: INT32 operations a forward key of the hash-key kernels, counted from
#: csrc/hash_keys.cu: the window (2 funnel shifts, 2 masks), the Feistel mix
#: (3 rounds of fmix32's 3 shifts, 3 xors and 2 multiplies plus 2 xors), the
#: key's xor and the store's address and loop (about 4)
HASH_OPS = 40


def log(msg: str) -> None:
    print(msg, flush=True)


def _cmd_output(cmd: list[str]) -> str:
    return subprocess.run(cmd, capture_output=True, text=True, check=True).stdout.strip()


def phase_environment(torch) -> tuple[str, str]:
    name = torch.cuda.get_device_name(0)
    smi = _cmd_output(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"]
    ).splitlines()[0]
    from kmer_mapper_tpu_torch import native

    nvcc = _cmd_output([native._nvcc(), "--version"]).splitlines()[-1]
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, device {name}, "
        f"count {torch.cuda.device_count()}")
    log(f"nvcc: {nvcc}")
    log(smi)  # the card's name and power limit, as nvidia-smi reports them
    return name, smi


def phase_build() -> float:
    from kmer_mapper_tpu_torch import native

    t = time.perf_counter()
    path = native.build()
    native.library()
    seconds = time.perf_counter() - t
    report = native.build_log().splitlines()
    # "nvcc <source>: <seconds> s" heads each compile's report
    compiles = [float(line.split()[-2]) for line in report
                if line.startswith("nvcc ") and ".cu:" in line]
    log(f"build: {path.name} in {seconds:.2f} s; the {len(compiles)} compiles, "
        f"started together, took {sum(compiles):.2f} s one after another")
    for line in report:
        if "ptxas info" in line or line.startswith("nvcc "):
            log(f"  {line.strip()}")
    return seconds


def _u32(t):
    import numpy as np

    return t.cpu().numpy().view(np.uint32).astype(np.int64)


@functools.cache
def max_sm_mhz() -> float:
    return float(_cmd_output(["nvidia-smi", "--query-gpu=clocks.max.sm",
                              "--format=csv,noheader,nounits"]).splitlines()[0])


@functools.cache
def int32_ops_per_s() -> float:
    """The card's INT32 instruction rate: SMs x INT32 lanes x largest SM clock."""
    import torch

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return sms * INT32_LANES_PER_SM * max_sm_mhz() * 1e6


def bound(n_bytes: float, n_ops: float) -> tuple[float, str]:
    """(ms, "bytes" or "operations"): the least time the card could take for
    ``n_bytes`` moved and ``n_ops`` 32-bit integer operations."""
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, n_ops / int32_ops_per_s()
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def count_bound(args, max_probe: int, n_changed: int) -> tuple[float, str]:
    """The stream count's bound on these inputs: each 8-byte sort key, both
    key words of every slot, the offsets and probe bounds read once, and the
    counts of the slots this run changes read and written once; operations:
    two 32-bit compares per key lane per round of each query in a window."""
    key_lo, _, _, keys, off, block_probe, _, _ = args
    lengths = (off[1:] - off[:-1]).long()
    rounds = block_probe.long().clamp(min=1, max=max_probe)
    n_bytes = (8 * keys.numel() + 8 * key_lo.numel() + 4 * off.numel()
               + 4 * block_probe.numel() + 8 * n_changed)
    return bound(n_bytes, 16 * int((lengths * rounds).sum()))


def phase_hazards(torch, device) -> int:
    """The count kernel vs the twin vs the oracle on every hazard case, on
    the case's sorted windows and on its queries shuffled and grouped by
    the partition kernels; returns the max absolute difference between
    kernel and twin (must be 0)."""
    import numpy as np

    from kmer_mapper_tpu_torch.ops import block_partition, stream_count_cases, stream_probe

    max_err = 0
    gen = torch.Generator(device=device).manual_seed(9)
    for case in stream_count_cases.cases(poly_a=POLY_A):
        expected = case.expected().astype(np.int64)
        twin = _u32(stream_probe.stream_count_reference(*case.inputs(device)))
        if not np.array_equal(twin, expected):
            raise AssertionError(f"hazard {case.name}: twin and oracle disagree")
        unordered = list(case.inputs(device))
        keys, n_buckets, bpb = unordered[3], case.table.n_buckets, unordered[7]
        shuffled = keys[torch.randperm(keys.numel(), generator=gen, device=device)]
        unordered[3:5] = block_partition.block_partition(shuffled, n_buckets, bpb)
        for args in (case.inputs(device), unordered):
            got = _u32(stream_probe.stream_count(*args))
            err = int(np.abs(got - twin).max(initial=0))
            max_err = max(max_err, err)
            if err or not np.array_equal(got, expected):
                raise AssertionError(f"hazard {case.name}: kernel, twin and oracle disagree")
        log(f"hazard {case.name}: {case.table.n_buckets} buckets, "
            f"{len(case.queries)} queries, kernel == twin == oracle on sorted and on "
            "shuffled, partitioned windows")
    free, total = torch.cuda.mem_get_info()
    if total < 60 << 30:
        raise AssertionError("the slot-past-2**31 case needs a card with >= 60 GiB")
    args, (slots, reps) = stream_count_cases.huge_table_inputs(device)
    counts = args[2]
    results = []
    for fn in (stream_probe.stream_count, stream_probe.stream_count_reference):
        counts.zero_()
        fn(*args)
        results.append(stream_count_cases.nonzero_counts(counts))
    for hit, vals in results:
        if not (np.array_equal(hit, slots) and np.array_equal(vals, reps)):
            raise AssertionError("hazard slots_past_2_31: wrong counts")
    max_err = max(max_err, max(int(np.abs(r[1] - results[-1][1]).max()) for r in results))
    log(f"hazard slots_past_2_31: {args[0].shape[0]} buckets "
        f"({counts.numel()} slots, hits up to slot {slots.max()}), "
        "kernel == twin == expected")
    del args, counts
    torch.cuda.empty_cache()
    return max_err


def key_err(a, b) -> int:
    """Largest |a - b| over two integer tensors of one shape, exactly."""
    if a.shape != b.shape:
        raise AssertionError(f"key tensors of shapes {tuple(a.shape)} and {tuple(b.shape)}")
    bad = (a != b).nonzero().squeeze(1)[:4096]
    return max((abs(x - y) for x, y in zip(a[bad].tolist(), b[bad].tolist())), default=0)


def phase_hash_hazards(torch, np, device) -> dict:
    """Each hash-key kernel against its twin (the same keys in the same
    order) and the host oracle (sorted) on every case of
    ops/hash_keys_cases.py; returns the largest absolute difference between
    kernel and twin keys per kernel (must be 0)."""
    from kmer_mapper_tpu_torch.ops import hash_keys_cases, hashing

    max_err = {"plane_hash_keys": 0, "ragged_hash_keys": 0, "ragged_offsets": 0}
    n_cases = dict.fromkeys(("plane_hash_keys", "ragged_hash_keys"), 0)
    n_keys = dict.fromkeys(n_cases, 0)
    t = time.perf_counter()
    for case in hash_keys_cases.cases():
        name = "ragged_hash_keys" if case.ragged else "plane_hash_keys"
        got = getattr(hashing, name)(*case.inputs(device))
        twin = getattr(hashing, f"{name}_reference")(*case.inputs(device))
        if case.ragged:  # the keys are the first count[0] of a capacity buffer
            _, lengths, n_bases, k, _, revcomp = case.inputs(device)
            offsets = hashing.ragged_offsets(lengths, n_bases, k, revcomp)
            plain = hashing.ragged_offsets_reference(lengths, n_bases, k, revcomp)
            max_err["ragged_offsets"] = max(
                max_err["ragged_offsets"],
                *(int((a.long() - b.long()).abs().amax()) for a, b in zip(offsets, plain)
                  if a.numel()))
            got, count = got
            if count.tolist() != plain[2].tolist() or max_err["ragged_offsets"]:
                raise AssertionError(f"hash hazard {case.name}: ragged_offsets != its twin")
            got = got[: int(count[0])]
        err = key_err(got, twin)
        max_err[name] = max(max_err[name], err)
        if err or not np.array_equal(np.sort(got.cpu().numpy()), case.expected_keys()):
            raise AssertionError(f"hash hazard {case.name}: kernel, twin and oracle disagree")
        n_cases[name] += 1
        n_keys[name] += got.numel()
    log(f"hash hazards: {n_cases} cases ({n_keys} keys), kernel == twin (same order) == "
        f"oracle (sorted) in {time.perf_counter() - t:.1f} s")
    return max_err


#: the partitions that phase 3 holds to the twin: the main path's (the
#: wrapper's) and the variants of partition_dissect's cursor route
PARTITION_OPTIONS = {
    "wrapper": None,
    "cursor": "cursor",
    "cursor, histogram in device memory": "device_histogram",
}


def run_partition(keys, n_buckets: int, option: str = "wrapper"):
    """(grouped keys, off) of one option of PARTITION_OPTIONS."""
    from kmer_mapper_tpu_torch.ops import block_partition as bp
    from kmer_mapper_tpu_torch.scripts import partition_dissect

    bpb = min(128, n_buckets)
    variant = PARTITION_OPTIONS[option]
    if variant is None:
        return bp.block_partition(keys, n_buckets, bpb)
    return partition_dissect.cursor_partition(keys, n_buckets, bpb, variant)


def partition_check(torch, keys, n_buckets: int, option: str = "wrapper"):
    """The partition kernels (``option`` of PARTITION_OPTIONS) against their
    twin on the same device: returns (grouped keys, off, max_abs_err).
    Raises unless the offsets are equal, every key lies in its own block's
    window and the two hold the same keys, which with the first two makes
    every window equal as a multiset; the main path's must equal the twin
    in order too (its passes are stable)."""
    from kmer_mapper_tpu_torch.ops import block_partition as bp
    from kmer_mapper_tpu_torch.scripts import partition_dissect

    grouped, off = run_partition(keys, n_buckets, option)
    twin, twin_off = bp.block_partition_reference(keys, n_buckets, min(128, n_buckets))
    err = max(key_err(off.long(), twin_off.long()),
              key_err(torch.sort(grouped).values, torch.sort(twin).values))
    partition_dissect.check(keys, grouped, off, n_buckets, f"partition ({option})")
    if PARTITION_OPTIONS[option] is None and not torch.equal(grouped, twin):
        raise AssertionError(f"partition ({option}): the radix route's order is not the twin's")
    return grouped, off, err


#: INT32 operations a key of each partition kernel, counted from
#: csrc/block_partition.cu: the histogram's load, bin (the invalid test, a
#: xor and a shift), digit, bounds test and shared add (about 10); the
#: scatter's bin and digit twice, a ballot, a test and an and for each of
#: the digit's bits (7 here), the rank's popcount and adds, the tile's
#: shared stores and loads and the output address (about 50)
HISTOGRAM_OPS = 10
SCATTER_OPS = 50


def radix_kernels(torch, keys, n_buckets: int, timed: bool = False) -> dict:
    """Each kernel of the main path's partition on ``keys`` at its own slab
    count, pass by pass, against its plain piece on the same inputs:
    partition_histogram vs slab_histograms, partition_scan vs slab_bases,
    radix_scatter vs slab_scatter_reference, radix_offsets vs
    radix_offsets_reference. Returns for each kernel its max_abs_err and
    the bytes and INT32 operations of this data's work (summed over the
    passes); with ``timed``, its device ms, its plain piece's and, for the
    scan, torch.cumsum's over the same matrix (median of 5, summed over the
    passes)."""
    from kmer_mapper_tpu_torch.ops import block_partition as bp

    n_blocks = n_buckets // min(128, n_buckets)
    n = keys.numel()
    n_slabs = bp.radix_slabs(keys.device)
    _, slab_len = bp.slab_layout(n, n_slabs)
    count = torch.full((1,), n, dtype=torch.int32, device=keys.device)
    out = {name: {"max_abs_err": 0, "bytes": 0, "ops": 0, "ms": 0.0, "plain_ms": 0.0,
                  "library_ms": None}
           for name in ("partition_histogram", "partition_scan", "radix_scatter",
                        "radix_offsets")}
    out["partition_scan"]["library_ms"] = 0.0

    def record(name, got, want, kernel, plain, n_bytes, n_ops, library=None):
        entry = out[name]
        entry["max_abs_err"] = max(entry["max_abs_err"], key_err(got.long(), want.long()))
        entry["bytes"] += n_bytes
        entry["ops"] += n_ops
        if timed:
            entry["ms"] += median_ms(kernel)
            entry["plain_ms"] += median_ms(plain, reps=3)
            if library is not None:
                entry["library_ms"] += median_ms(library)

    cur = keys
    for shift, bits in bp.radix_passes(n_blocks):
        width = bp.digit_width(n_blocks, shift, bits)
        matrix = 4 * n_slabs * width
        rows = bp.partition_histogram(cur, n_blocks, shift, bits, count, n_slabs)
        record("partition_histogram", rows,
               bp.slab_histograms(cur, n_blocks, slab_len, shift, bits, n_slabs),
               lambda: bp.partition_histogram(cur, n_blocks, shift, bits, count, n_slabs),
               lambda: bp.slab_histograms(cur, n_blocks, slab_len, shift, bits, n_slabs),
               8 * n + matrix, HISTOGRAM_OPS * n)
        bases, doff = bp.slab_bases(rows)
        counts = rows.clone()
        totals = bp.partition_scan(rows)
        # the scan works in place: a timed call scans a fresh copy, whose
        # copy is timed alone and taken off
        copy_ms = median_ms(lambda: counts.clone()) if timed else 0.0
        record("partition_scan", torch.cat([rows.view(-1), totals]),
               torch.cat([bases.view(-1), doff.diff()]),
               lambda: bp.partition_scan(counts.clone()),
               lambda: bp.slab_bases(counts), 2 * matrix + 4 * width, 2 * n_slabs * width,
               lambda: torch.cumsum(counts, 0))
        out["partition_scan"]["ms"] -= copy_ms
        nxt = bp.radix_scatter(cur, rows, doff, n_blocks, shift, bits, count)
        record("radix_scatter", nxt,
               bp.slab_scatter_reference(cur, bases, doff, n_blocks, slab_len, shift, bits),
               lambda: bp.radix_scatter(cur, rows, doff, n_blocks, shift, bits, count),
               lambda: bp.slab_scatter_reference(cur, bases, doff, n_blocks, slab_len, shift,
                                                 bits),
               16 * n + matrix + 4 * (width + 1), SCATTER_OPS * n)
        cur = nxt
    n_off = n_blocks + 1
    # a binary search a bin reads ~log2(n) keys where the keys are at least
    # 64 times the bins (kSearchKeysABin), else every key once
    search = n_off * 64 <= n
    reads = n_off * max(1, n.bit_length()) if search else n
    record("radix_offsets", bp.radix_offsets(cur, n_blocks, count),
           bp.radix_offsets_reference(cur, n_blocks),
           lambda: bp.radix_offsets(cur, n_blocks, count),
           lambda: bp.radix_offsets_reference(cur, n_blocks), 8 * reads + 4 * n_off,
           8 * reads)
    for entry in out.values():
        if entry["max_abs_err"]:
            raise AssertionError(f"radix kernels: a kernel and its plain piece disagree: {out}")
        entry["bound_ms"], entry["bound_by"] = bound(entry["bytes"], entry["ops"])
    return out


def phase_partition_hazards(torch, np, device) -> int:
    """The partition kernels against their twin on every case of
    ops/block_partition_cases.py (the poly-A window at POLY_A keys), on the
    main path's partition and on the cursor route's variants; each of the
    main path's kernels against its plain piece; every table case then
    counted by the main path's partition and stream_count == the oracle.
    Returns the largest absolute difference (must be 0)."""
    from kmer_mapper_tpu_torch.ops import block_partition_cases, stream_probe

    t = time.perf_counter()
    max_err, n_keys = 0, 0
    cases = block_partition_cases.cases(poly_a=POLY_A)
    for case in cases:
        keys = case.inputs(device)[0]
        for option in PARTITION_OPTIONS:
            max_err = max(max_err, partition_check(torch, keys, case.n_buckets, option)[2])
        if keys.numel():
            radix_kernels(torch, keys, case.n_buckets)
        n_keys += keys.numel()
    for case in block_partition_cases.table_cases(poly_a=POLY_A):
        key_lo, key_hi, counts, _, _, block_probe, _, _ = case.inputs(device)
        keys = block_partition_cases.query_keys(case)
        stream_probe.stream_probe_count_keys(
            key_lo, key_hi, counts, torch.from_numpy(keys[case.valid]).to(device), block_probe)
        if not np.array_equal(_u32(counts), case.expected().astype(np.int64)):
            raise AssertionError(f"partition hazard {case.name}: counts differ from the oracle")
    log(f"partition hazards: {len(cases)} cases ({n_keys} keys; up to "
        f"{max(c.n_buckets // c.bpb for c in cases)} chain blocks), kernel == twin on "
        f"{list(PARTITION_OPTIONS)}, each radix kernel == its plain piece; every table case "
        f"counted == oracle, in {time.perf_counter() - t:.1f} s")
    return max_err


def partition_bound(n_keys: int, n_blocks: int) -> tuple[float, str]:
    """The partition's bound: its keys read once, the grouped keys and the
    offsets written once, PARTITION_OPS INT32 operations a key."""
    return bound(16 * n_keys + 4 * (n_blocks + 1), PARTITION_OPS * n_keys)


def hash_bound(n_read_bytes: int, n_keys: int) -> tuple[float, str]:
    """A hash-key kernel's bound without reverse complements: its inputs
    read once, its 8-byte keys written once, HASH_OPS INT32 operations a
    key."""
    return bound(n_read_bytes + 8 * n_keys, HASH_OPS * n_keys)


#: the partition's kernels, and the kernels that both chunk steps launch on
#: every chunk beside their hash-key kernel: the partition's and the count
PARTITION_KERNELS = ("partition_histogram", "partition_scan", "radix_scatter",
                     "radix_offsets")
MAIN_PATH_KERNELS = (*PARTITION_KERNELS, "stream_count")


def chunk_launches(n_buckets: int) -> dict:
    """Each of MAIN_PATH_KERNELS' launches a chunk on a table of
    ``n_buckets``: the radix route's histogram, scan and scatter once a
    pass."""
    from kmer_mapper_tpu_torch.ops import block_partition as bp

    passes = len(bp.radix_passes(n_buckets // min(128, n_buckets)))
    return {"partition_histogram": passes, "partition_scan": passes, "radix_scatter": passes,
            "radix_offsets": 1, "stream_count": 1}


def zero_launch_counts(*modules) -> None:
    for m in modules:
        for name in m.launch_counts:
            m.launch_counts[name] = 0


def all_launches(*modules) -> dict:
    return {name: n for m in modules for name, n in m.launch_counts.items()}


def make_chunks(np, rng, n_chunks: int, n_reads: int):
    """Random 151-bp reads, as framed SequenceChunks."""
    from kmer_mapper_tpu_torch.io.readers import SequenceChunk

    lut = np.frombuffer(b"ACGT", dtype=np.uint8)
    out = []
    for _ in range(n_chunks):
        bases = lut[rng.integers(0, 4, n_reads * READ_LEN, dtype=np.uint8)]
        starts = np.arange(n_reads, dtype=np.int64) * READ_LEN
        out.append(SequenceChunk(bases=bases, read_starts=starts))
    return out


def fixed_read_kmers(np, bases):
    """Oracle k-mer hashes of concatenated fixed-length reads: the oracle's
    hash of the whole stream, keeping windows that stay inside one read."""
    from kmer_mapper_tpu_torch import oracle

    h = oracle.kmer_hashes(oracle.encode_bytes(bases), K)
    t = np.arange(len(h))
    return h[t % READ_LEN <= READ_LEN - K]


def phase_end_to_end(torch, np, chunk0, rng, workdir) -> dict:
    from kmer_mapper_tpu_torch import cli, oracle
    from kmer_mapper_tpu_torch.index import kmer_index
    from kmer_mapper_tpu_torch.io import readers
    from kmer_mapper_tpu_torch.ops import block_partition, finalize, hashing, stream_probe
    from kmer_mapper_tpu_torch.pipeline import CUDA_BUF

    t = time.perf_counter()
    sample = fixed_read_kmers(np, chunk0.bases[: READ_LEN * 5000])
    entry_kmers = np.unique(np.concatenate([
        rng.integers(0, 1 << 62, INDEX_UNIFORM, dtype=np.uint64),
        rng.choice(sample, INDEX_FROM_READS),
    ]))
    nodes = rng.integers(0, 3_000_000, len(entry_kmers)).astype(np.int32)
    arrays = oracle.build_kmer_index(entry_kmers, nodes, int(len(entry_kmers) * 1.7) | 1)
    index_path = os.path.join(workdir, "index.npz")
    kmer_index.save_reference_npz(index_path, arrays)
    reads = chunk0.bases[: E2E_READS * READ_LEN].reshape(E2E_READS, READ_LEN)
    fq = os.path.join(workdir, "reads.fq")
    qual = b"I" * READ_LEN
    with open(fq, "wb") as f:
        f.writelines(b"@r%d\n%s\n+\n%s\n" % (i, r.tobytes(), qual) for i, r in enumerate(reads))
    log(f"e2e: index of {len(entry_kmers)} unique k-mers, {E2E_READS} reads "
        f"written in {time.perf_counter() - t:.1f} s")

    out = os.path.join(workdir, "counts.npy")
    modules = (stream_probe, hashing, block_partition, finalize)
    zero_launch_counts(*modules)
    t = time.perf_counter()
    cli.main(["map", "-i", index_path, "-f", fq, "-k", str(K), "-o", out])
    seconds = time.perf_counter() - t
    launches = all_launches(*modules)
    got = np.load(out)

    n_chunks = -(-E2E_READS // readers.strided_rows(CUDA_BUF, READ_LEN))
    twins = [name for name, n in launches.items() if "reference" in name and n]
    if (min(launches[name] for name in MAIN_PATH_KERNELS) < n_chunks
            or launches["plane_hash_keys"] < n_chunks or launches["ragged_hash_keys"] or twins
            or launches["node_counts"] != 1):
        raise AssertionError(f"main path did not run the kernels alone: {launches}")
    expect = oracle.map_kmers_to_index(arrays, fixed_read_kmers(np, reads.reshape(-1)))
    if not np.array_equal(got, expect):
        raise AssertionError("e2e: CLI node counts differ from the numpy oracle")
    log(f"e2e: cli map on {torch.cuda.get_device_name(0)} in {seconds:.2f} s "
        f"(index build included); {int(got.sum())} node hits == oracle; "
        f"launches {launches}")
    index = kmer_index.KmerIndex.from_arrays(arrays)
    per_chunk = chunk_launches(index.table.n_buckets)
    if (len({launches[name] // per_chunk[name] for name in MAIN_PATH_KERNELS}) != 1
            or any(launches[name] % per_chunk[name] for name in MAIN_PATH_KERNELS)):
        raise AssertionError(f"e2e: the partition's kernels ran unequally: {launches}")
    return {"launches": launches, "hash_launches": launches["plane_hash_keys"],
            "arrays": arrays, "index": index}


def timed_rates(torch, fn, kmers_per_window: int) -> list[float]:
    """k-mers per second of N_WINDOWS calls of ``fn`` after a warm-up call,
    host clock around work that ends in a synchronize."""
    fn()
    torch.cuda.synchronize()
    rates = []
    for _ in range(N_WINDOWS):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        rates.append(kmers_per_window / (time.perf_counter() - t0))
    return rates


def stage_split(torch, dev_chunks, stages) -> dict:
    """Mean device ms a chunk of each stage, CUDA events around each; a
    stage takes and returns the state of the chunk's step."""
    stage_ms = dict.fromkeys((name for name, _ in stages), 0.0)
    for chunk in dev_chunks:
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(len(stages) + 1)]
        ev[0].record()
        state = chunk
        for i, (_, fn) in enumerate(stages):
            state = fn(state)
            ev[i + 1].record()
        torch.cuda.synchronize()
        for i, name in enumerate(stage_ms):
            stage_ms[name] += ev[i].elapsed_time(ev[i + 1]) / len(dev_chunks)
    return stage_ms


def oracle_check(np, index, arrays, config, device, packed_chunk, kmers, what):
    """One chunk (words, lengths, n_bases) through a fresh mapper: node
    counts == the oracle's on its k-mers."""
    from kmer_mapper_tpu_torch import oracle
    from kmer_mapper_tpu_torch.models.mapper import KmerMapper

    t = time.perf_counter()
    mapper = KmerMapper(index, config, device)
    words, lengths, n_bases = packed_chunk
    mapper.map_chunk(words, lengths, n_bases, strided=bool(config.read_len))
    got = mapper.node_counts()
    expect = oracle.map_kmers_to_index(arrays, kmers)
    if not np.array_equal(got, expect):
        raise AssertionError(f"{what}: one chunk's node counts differ from the oracle's")
    log(f"{what}: chunk 0 ({len(kmers)} k-mers, {int(got.sum())} node hits) == oracle "
        f"in {time.perf_counter() - t:.1f} s")


def partition_report(torch, keys, n_buckets: int, err: int, what: str) -> dict:
    """The partition's device ms on these keys (median of 5): each of the
    main path's kernels against its plain piece, timed with it
    (radix_kernels); the kernels at one CTA an SM, pass by pass
    (partition_dissect.radix_pass_ms); partition_dissect.report: the main
    path's partition whole, the cursor route (the first partition
    kernels) whole and in its kernels, the twin and torch.sort + count_offsets; beside the
    bounds. Returns the kernels line's entries: the whole stage and each
    kernel."""
    from kmer_mapper_tpu_torch.ops import block_partition as bp
    from kmer_mapper_tpu_torch.scripts import partition_dissect

    bpb = min(128, n_buckets)
    n_blocks = n_buckets // bpb
    n = keys.numel()
    kernels = radix_kernels(torch, keys, n_buckets, timed=True)
    sms = torch.cuda.get_device_properties(keys.device).multi_processor_count
    one_a_sm = partition_dissect.radix_pass_ms(keys, n_buckets, sms, keys.device)
    t = partition_dissect.report(keys, n_buckets, keys.device, f" ({what})")
    bound_ms, bound_by = partition_bound(n, n_blocks)
    # the radix route's own floor: each pass reads the keys for its
    # histogram, then reads and writes them
    passes = bp.radix_passes(n_blocks)
    floor_ms = bound(24 * n * len(passes) + 4 * (n_blocks + 1), 0)[0]
    log(f"{what}: block partition of {n} keys into {n_blocks} chain blocks (radix passes "
        f"{passes}, {bp.radix_slabs(keys.device)} slabs): "
        + ", ".join(f"{name} {k['ms']:.4f} ms (plain {k['plain_ms']:.3f}, bound "
                    f"{k['bound_ms']:.4f} by {k['bound_by']})" for name, k in kernels.items())
        + f"; at one CTA an SM ({sms} slabs): "
        + ", ".join(f"{name} {ms:.4f}" for name, ms in one_a_sm.items())
        + f"; whole stage bound {bound_ms:.4f} ms by {bound_by}, the passes' floor "
        f"{floor_ms:.4f} ms")
    stage = {"ms": t["radix"], "plain_ms": t["twin"],
             "library_ms": t["torch.sort + count_offsets"], "bound_ms": bound_ms,
             "bound_by": bound_by, "max_abs_err": err}
    return {"stage": stage, "kernels": kernels, "times": t, "one_a_sm": one_a_sm}


def large_table_report(torch, keys, what: str) -> dict:
    """One chunk's keys partitioned for tables of 2^22, 2^25 (a human-scale
    index) and 2^29 buckets: the main path's partition and the cursor
    route's with its histogram in device memory, each checked against the
    twin, then timed (median of 5); the main path's launches at 2^25."""
    from kmer_mapper_tpu_torch.ops import block_partition as bp

    t, err = {}, 0
    for log2 in (22, 25, 29):
        n_buckets = 1 << log2
        for option in ("wrapper", "cursor, histogram in device memory"):
            err = max(err, partition_check(torch, keys, n_buckets, option)[2])
            t[f"2^{log2} {option}"] = median_ms(lambda: run_partition(keys, n_buckets, option))
        t[f"2^{log2} bound"] = partition_bound(keys.numel(), n_buckets // 128)[0]
    zero_launch_counts(bp)
    bp.block_partition(keys, 1 << 25, 128)
    launches = dict(bp.launch_counts)
    expect = {name: n for name, n in chunk_launches(1 << 25).items() if name != "stream_count"}
    if any(launches[name] != n for name, n in expect.items()) or launches[
            "block_partition_reference"]:
        raise AssertionError(f"{what}: the 2^25 table's partition launched {launches}")
    log(f"{what}: large tables, {keys.numel()} keys, kernel == twin: "
        + ", ".join(f"{name} {ms:.4f} ms" for name, ms in t.items())
        + f"; launches at 2^25: {launches}")
    return {"times": t, "max_abs_err": err}


def count_report(torch, mapper, grouped, off, keys, n_buckets: int, max_probe: int,
                 what: str) -> dict:
    """The count kernel, the per-block dissection kernel (r2_kernel_dissect's
    ``full``: the same design, its variants take it apart) and the
    split-window one (r2_window_dissect's ``full``, its schedule included)
    on one chunk's grouped keys and on the
    same keys sorted (with count_offsets), each from zero counts == the
    twin's counts, then timed (median of 5), beside the twin and the bound;
    the kernels line's entry."""
    from kmer_mapper_tpu_torch.ops import stream_probe
    from kmer_mapper_tpu_torch.ops.u32hash import bucket_shift
    from kmer_mapper_tpu_torch.scripts import r2_kernel_dissect, r2_window_dissect

    shift, bpb = bucket_shift(n_buckets), min(128, n_buckets)
    table = (mapper.key_lo, mapper.key_hi)
    ordered = torch.sort(keys).values
    inputs = {"grouped": (grouped, off),
              "sorted": (ordered, stream_probe.count_offsets(ordered, n_buckets, bpb))}
    kernels = {"stream_count": stream_probe.stream_count,
               "per-block dissection (r2_kernel_dissect full)": lambda *a: r2_kernel_dissect.
               stream_count_v(*a, max_probe, "full"),
               "split windows (r2_window_dissect full)": lambda *a: r2_window_dissect.
               stream_count_v(*a, max_probe, "full")}

    def run(fn, counts, window):
        return fn(*table, counts, *window, mapper.block_probe, shift, bpb)

    twin = run(stream_probe.stream_count_reference, torch.zeros_like(mapper.counts),
               inputs["grouped"])
    t, err = {}, 0
    for name, fn in kernels.items():
        for order, window in inputs.items():
            got = run(fn, torch.zeros_like(mapper.counts), window)
            err = max(err, int((got.long() - twin.long()).abs().max()))
            scratch = torch.zeros_like(mapper.counts)
            t[f"{name} {order}"] = median_ms(lambda: run(fn, scratch, window))
    if err:
        raise AssertionError(f"{what}: a count kernel and the twin disagree")
    scratch = torch.zeros_like(mapper.counts)
    t["twin"] = median_ms(
        lambda: run(stream_probe.stream_count_reference, scratch, inputs["grouped"]))
    bound_ms, bound_by = count_bound((*table, twin, grouped, off, mapper.block_probe, shift,
                                      bpb), max_probe, int(twin.ne(0).sum()))
    log(f"{what}: stream_count on {keys.numel()} queries, == twin: "
        + ", ".join(f"{name} {ms:.4f} ms" for name, ms in t.items())
        + f" (median of 5); bound {bound_ms:.4f} ms by {bound_by}")
    return {"ms": t["stream_count grouped"], "plain_ms": t["twin"], "max_abs_err": err,
            "bound_ms": bound_ms, "bound_by": bound_by, "times": t}


def phase_steady_state(torch, np, chunks, index, arrays, device) -> dict:
    from kmer_mapper_tpu_torch.io import readers
    from kmer_mapper_tpu_torch.models.mapper import KmerMapper, MapperConfig
    from kmer_mapper_tpu_torch.ops import block_partition, hashing, stream_probe
    from kmer_mapper_tpu_torch.ops.u32hash import bucket_shift
    from kmer_mapper_tpu_torch.pipeline import CUDA_BUF

    config = MapperConfig(
        k=K, buf=CUDA_BUF, max_reads=max(1024, CUDA_BUF // 32), read_len=READ_LEN
    )
    t = time.perf_counter()
    dev_chunks = []
    for chunk in chunks:
        (packed, _, n_bases, n_reads, _, strided), = readers.pack_for_device(
            iter([chunk]), config.buf, config.max_reads, K, read_len=READ_LEN
        )
        if not strided or n_reads != readers.strided_rows(CUDA_BUF, READ_LEN):
            raise AssertionError("steady: a chunk did not pack in the strided layout")
        dev_chunks.append((torch.from_numpy(packed.view(np.int32)).to(device), n_bases, n_reads))
    log(f"steady: {len(chunks)} chunks of {n_bases} bases packed and moved in "
        f"{time.perf_counter() - t:.1f} s")
    kmers_per_chunk = n_reads * (READ_LEN - K + 1)
    seed = index.table.seed

    mapper = KmerMapper(index, config, device)
    n_buckets = index.table.n_buckets
    shift, bpb = bucket_shift(n_buckets), min(128, n_buckets)

    def run_mapper():
        for words, nb, _ in dev_chunks:
            mapper.map_chunk(words, None, nb, strided=True)

    twin_counts = torch.zeros_like(mapper.counts)

    def run_twin():
        """The same stages with the plain twins: hash, partition, count."""
        for words, _, nr in dev_chunks:
            keys, off = block_partition.block_partition_reference(
                hashing.plane_hash_keys_reference(words, K, READ_LEN, nr, seed), n_buckets, bpb)
            stream_probe.stream_count_reference(
                mapper.key_lo, mapper.key_hi, twin_counts, keys, off,
                mapper.block_probe, shift, bpb,
            )

    modules = (hashing, stream_probe, block_partition)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_launch_counts(*modules)
    kernel_rates = timed_rates(torch, run_mapper, kmers_per_chunk * len(dev_chunks))
    peak = torch.cuda.max_memory_allocated()
    launches = all_launches(*modules)
    twin_rates = timed_rates(torch, run_twin, kmers_per_chunk * len(dev_chunks))
    # both ran 1 + N_WINDOWS windows over the same chunks from zero counts
    if not torch.equal(mapper.counts, twin_counts):
        raise AssertionError("steady: kernel path and twin path counts differ")
    n_steps = (1 + N_WINDOWS) * len(dev_chunks)
    if (launches["plane_hash_keys"] != n_steps
            or any(launches[name] != n_steps * chunk_launches(n_buckets)[name]
                   for name in MAIN_PATH_KERNELS)
            or launches["ragged_hash_keys"]
            or any(n for name, n in launches.items() if "reference" in name)):
        raise AssertionError(f"steady: map_chunk did not run the kernels alone: {launches}")
    if not int(mapper.counts.ne(0).sum()):
        raise AssertionError("steady: no table hits at all")
    log(f"steady: kernel path {[f'{r / 1e6:.1f}' for r in kernel_rates]} Mk/s, "
        f"twin path {[f'{r / 1e6:.1f}' for r in twin_rates]} Mk/s "
        f"({len(dev_chunks)} chunks x {kmers_per_chunk} k-mers per window); counts equal; "
        f"peak device memory {peak / 2**30:.2f} GiB in the kernel path's windows; "
        f"launches {launches}")
    words0, nb0, nr0 = dev_chunks[0]
    oracle_check(np, index, arrays, config, device, (words0, None, nb0),
                 fixed_read_kmers(np, chunks[0].bases), "steady")

    # per-stage device time over one window, CUDA events around each stage
    scratch = torch.zeros_like(mapper.counts)

    def count(state, fn):
        keys, off = state
        fn(mapper.key_lo, mapper.key_hi, scratch, keys, off, mapper.block_probe, shift, bpb)
        return state

    stage_ms = stage_split(torch, dev_chunks, [
        ("hash_keys", lambda c: hashing.plane_hash_keys(c[0], K, READ_LEN, c[2], seed)),
        ("partition", lambda keys: block_partition.block_partition(keys, n_buckets, bpb)),
        ("kernel", lambda st: count(st, stream_probe.stream_count)),
        ("twin_count", lambda st: count(st, stream_probe.stream_count_reference)),
    ])
    log("steady: per-chunk stage ms " + ", ".join(f"{n} {v:.3f}" for n, v in stage_ms.items()))

    # the partition kernels alone on one chunk's keys, against their twin
    # and their plain pieces, timed beside the cursor route, the twin and
    # torch.sort + count_offsets; then the same keys for larger tables
    keys0 = hashing.plane_hash_keys(words0, K, READ_LEN, nr0, seed)
    keys, off, part_err = partition_check(torch, keys0, n_buckets)
    partition = partition_report(torch, keys0, n_buckets, part_err, "steady")
    large = large_table_report(torch, keys0, "steady")

    # the count kernel and the first one vs the twin alone on that chunk's
    # grouped keys and on the same keys sorted
    count = count_report(torch, mapper, keys, off, keys0, n_buckets, index.table.max_probe,
                         "steady")

    # the plane hash-key kernel alone on one chunk, against its twin
    hash_args = (words0, K, READ_LEN, nr0, seed)
    got = hashing.plane_hash_keys(*hash_args)
    hash_err = key_err(got, hashing.plane_hash_keys_reference(*hash_args))
    if hash_err:
        raise AssertionError("steady: plane_hash_keys and its twin disagree on one chunk")
    hash_ms = median_ms(lambda: hashing.plane_hash_keys(*hash_args))
    hash_plain_ms = median_ms(lambda: hashing.plane_hash_keys_reference(*hash_args), reps=3)
    npr = hashing.read_stride(READ_LEN) // 16
    hash_bound_ms, hash_bound_by = hash_bound(4 * nr0 * npr, got.numel())
    log(f"steady: plane_hash_keys on {nr0} reads ({got.numel()} keys): kernel {hash_ms:.4f} "
        f"ms, twin {hash_plain_ms:.3f} ms; bound {hash_bound_ms:.4f} ms by {hash_bound_by}")
    del got, keys, keys0
    return {
        "kernel_rates": kernel_rates, "twin_rates": twin_rates, "stage_ms": stage_ms,
        "peak_gib": peak / 2**30, "partition": partition, "large": large, "count": count,
        "dev_chunks": dev_chunks,
        "hash": {"ms": hash_ms, "plain_ms": hash_plain_ms, "max_abs_err": hash_err,
                 "bound_ms": hash_bound_ms, "bound_by": hash_bound_by},
    }


def ragged_chunks(np, rng, chunks):
    """Phase 5's bases cut into reads of RAGGED_MIN..RAGGED_MAX bp: the
    whole reads that fit in each chunk's bases."""
    from kmer_mapper_tpu_torch.io.readers import SequenceChunk

    out = []
    for chunk in chunks:
        lengths = rng.integers(RAGGED_MIN, RAGGED_MAX + 1, chunk.n_bases // RAGGED_MIN + 1)
        lengths = lengths[: np.searchsorted(np.cumsum(lengths), chunk.n_bases, side="right")]
        starts = np.cumsum(lengths) - lengths
        out.append(SequenceChunk(bases=chunk.bases[: int(lengths.sum())], read_starts=starts))
    return out


def ragged_read_kmers(np, chunk):
    """Oracle k-mer hashes of a chunk's ragged reads: the oracle's hash of
    the whole stream at the windows that end inside their read."""
    from kmer_mapper_tpu_torch import oracle

    h = oracle.kmer_hashes(oracle.encode_bytes(chunk.bases), K)
    n_win = np.maximum(chunk.read_lengths - K + 1, 0)
    first = np.cumsum(n_win) - n_win
    t = np.arange(int(n_win.sum())) - np.repeat(first, n_win)
    return h[np.repeat(chunk.read_starts, n_win) + t]


def phase_ragged_steady_state(torch, np, chunks, index, arrays, device) -> dict:
    """The ragged step at full size: ``chunks`` (reads of 100-151 bp) packed
    continuously into 64 Mi-base buffers, words and the lengths of their
    reads on the device, through KmerMapper.map_chunk and through the same
    stages with the plain twins, equal counts; one chunk's node counts
    against the oracle; the stage split and the ragged hash-key kernel
    against its twin."""
    from kmer_mapper_tpu_torch.io import readers
    from kmer_mapper_tpu_torch.models.mapper import KmerMapper, MapperConfig
    from kmer_mapper_tpu_torch.ops import block_partition, hashing, stream_probe
    from kmer_mapper_tpu_torch.ops.u32hash import bucket_shift
    from kmer_mapper_tpu_torch.pipeline import CUDA_BUF

    config = MapperConfig(k=K, buf=CUDA_BUF, max_reads=max(1024, CUDA_BUF // 32))
    t = time.perf_counter()
    dev_chunks = []
    n_kmers = 0
    for chunk in chunks:
        (packed, lengths, n_bases, n_reads, _), = readers.pack_for_device(
            iter([chunk]), config.buf, config.max_reads, K)
        dev_chunks.append((torch.from_numpy(packed.view(np.int32)).to(device),
                           torch.from_numpy(lengths[:n_reads].astype(np.int32)).to(device),
                           n_bases))
        n_kmers += int(np.maximum(lengths.astype(np.int64) - K + 1, 0).sum())
    log(f"ragged: {len(chunks)} chunks of {RAGGED_MIN}-{RAGGED_MAX} bp reads (chunk 0: "
        f"{chunks[0].n_reads} reads, {chunks[0].n_bases} bases) packed and moved in "
        f"{time.perf_counter() - t:.1f} s")
    seed = index.table.seed
    mapper = KmerMapper(index, config, device)
    n_buckets = index.table.n_buckets
    shift, bpb = bucket_shift(n_buckets), min(128, n_buckets)

    def run_mapper_on(m):
        for words, lengths, nb in dev_chunks:
            m.map_chunk(words, lengths, nb)

    def run_mapper():
        run_mapper_on(mapper)

    twin_counts = torch.zeros_like(mapper.counts)

    def run_twin():
        """The same stages with the plain twins: hash, partition, count."""
        for words, lengths, nb in dev_chunks:
            keys, off = block_partition.block_partition_reference(
                hashing.ragged_hash_keys_reference(words, lengths, nb, K, seed), n_buckets, bpb)
            stream_probe.stream_count_reference(
                mapper.key_lo, mapper.key_hi, twin_counts, keys, off, mapper.block_probe, shift,
                bpb)

    modules = (hashing, stream_probe, block_partition)
    zero_launch_counts(*modules)
    torch.cuda.reset_peak_memory_stats()
    kernel_rates = timed_rates(torch, run_mapper, n_kmers)
    peak = torch.cuda.max_memory_allocated()
    launches = all_launches(*modules)
    twin_rates = timed_rates(torch, run_twin, n_kmers)
    if not torch.equal(mapper.counts, twin_counts):
        raise AssertionError("ragged: kernel path and twin path counts differ")
    n_steps = (1 + N_WINDOWS) * len(dev_chunks)
    if (launches["ragged_hash_keys"] != n_steps or launches["ragged_offsets"] != n_steps
            or any(launches[name] != n_steps * chunk_launches(n_buckets)[name]
                   for name in MAIN_PATH_KERNELS)
            or launches["plane_hash_keys"]
            or any(n for name, n in launches.items() if "reference" in name)):
        raise AssertionError(f"ragged: map_chunk did not run the kernels alone: {launches}")
    ms_chunk = [n_kmers / r / len(dev_chunks) * 1e3 for r in kernel_rates]
    log(f"ragged: kernel path {[f'{r / 1e6:.1f}' for r in kernel_rates]} Mk/s "
        f"({[f'{m:.3f}' for m in ms_chunk]} ms a chunk), twin path "
        f"{[f'{r / 1e6:.1f}' for r in twin_rates]} Mk/s ({len(dev_chunks)} chunks, "
        f"{n_kmers} k-mers a window); counts equal; peak device memory "
        f"{peak / 2**30:.2f} GiB in the kernel path's windows (the 8 buffers' words and "
        f"lengths included); launches {launches}")
    # the ragged step makes no host sync: a fresh mapper (made before, since
    # its table upload syncs) maps the 8 buffers with torch's sync check set
    # to raise on any synchronising call
    sync_free = KmerMapper(index, config, device)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        run_mapper_on(sync_free)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    if (not torch.equal(sync_free.counts * (1 + N_WINDOWS), mapper.counts)
            or sync_free.n_kmers_mapped != n_kmers):
        raise AssertionError("ragged: the map_chunk run under the sync check counted "
                             "otherwise")
    log(f"ragged: map_chunk over {len(dev_chunks)} buffers under "
        "torch.cuda.set_sync_debug_mode('error'): no host sync; its counts and "
        f"n_kmers_mapped ({n_kmers}) == the timed windows'")
    del sync_free
    words0, lengths0, nb0 = dev_chunks[0]
    oracle_check(np, index, arrays, config, device, dev_chunks[0],
                 ragged_read_kmers(np, chunks[0]), "ragged")

    scratch = torch.zeros_like(mapper.counts)
    keys_buffer = torch.empty(hashing.ragged_capacity(words0.numel()), dtype=torch.int64,
                              device=device)

    def offsets(chunk):
        words, lengths, nb = chunk
        return (words, *hashing.ragged_offsets(lengths, nb, K))

    def hash_keys(state):
        words, starts, offs, count = state
        return hashing._ragged_launch(words, starts, offs, count, K, seed, False,
                                      keys_buffer), count

    def count(state):
        keys, off = state
        stream_probe.stream_count(mapper.key_lo, mapper.key_hi, scratch, keys, off,
                                  mapper.block_probe, shift, bpb)
        return state

    stage_ms = stage_split(torch, dev_chunks, [
        ("offsets", offsets),
        ("hash_keys", hash_keys),
        ("partition", lambda st: block_partition.block_partition(st[0], n_buckets, bpb,
                                                                 count=st[1])),
        ("kernel", count),
    ])
    log("ragged: per-chunk stage ms " + ", ".join(f"{n} {v:.3f}" for n, v in stage_ms.items()))

    # the ragged stage on one chunk: the offsets' kernel and the hash kernel
    # alone (offsets made once) and the function whole, against the twins
    twin_args = (words0, lengths0, nb0, K, seed)
    got, count0 = hashing.ragged_hash_keys(*twin_args, out=keys_buffer)
    n_keys = int(count0[0])
    state0 = offsets(dev_chunks[0])
    offsets_err = max(int((a.long() - b.long()).abs().max()) for a, b in zip(
        state0[1:], hashing.ragged_offsets_reference(lengths0, nb0, K)))
    hash_err = key_err(got[:n_keys], hashing.ragged_hash_keys_reference(*twin_args))
    if hash_err or offsets_err or count0.tolist() != [n_keys, n_keys] or n_keys != int(
            np.maximum(chunks[0].read_lengths.astype(np.int64) - K + 1, 0).sum()):
        raise AssertionError("ragged: ragged_offsets or ragged_hash_keys and its twin disagree "
                             "on one chunk")
    offsets_ms = median_ms(lambda: hashing.ragged_offsets(lengths0, nb0, K))
    offsets_plain_ms = median_ms(lambda: hashing.ragged_offsets_reference(lengths0, nb0, K))
    hash_ms = median_ms(lambda: hash_keys(state0))
    wrapper_ms = median_ms(lambda: hashing.ragged_hash_keys(*twin_args, out=keys_buffer))
    plain_ms = median_ms(lambda: hashing.ragged_hash_keys_reference(*twin_args), reps=3)
    # the function's inputs: the words and one int32 length a read
    bound_ms, bound_by = hash_bound(4 * (words0.numel() + lengths0.numel()), n_keys)
    # the offsets: one int32 length read, a start and an offset written a read
    offsets_bound_ms, offsets_by = bound(12 * lengths0.numel() + 12, 0)
    log(f"ragged: ragged_hash_keys on {chunks[0].n_reads} reads ({n_keys} keys): the function "
        f"(offsets and hash kernel, no sync) {wrapper_ms:.4f} ms, the hash kernel alone "
        f"{hash_ms:.4f} ms, twin {plain_ms:.3f} ms; bound {bound_ms:.4f} ms by {bound_by}; "
        f"ragged_offsets {offsets_ms:.4f} ms (twin {offsets_plain_ms:.4f} ms, bound "
        f"{offsets_bound_ms:.5f} ms by {offsets_by})")
    # the partition with the device count (the main path's) against the twin
    # on the count's keys, then the kernels and the count on the exact keys
    keys = got[:n_keys].clone()
    counted = block_partition.block_partition(got, n_buckets, bpb, count=count0)
    twin = block_partition.block_partition_reference(keys, n_buckets, bpb)
    counted_ms = median_ms(lambda: block_partition.block_partition(got, n_buckets, bpb,
                                                                   count=count0))
    if not (torch.equal(counted[0][:n_keys], twin[0]) and torch.equal(counted[1], twin[1])):
        raise AssertionError("ragged: the device-count partition != the twin on keys[:n]")
    log(f"ragged: block partition with the device count on a {got.numel()}-key buffer == "
        f"twin on its {n_keys} keys, in order: {counted_ms:.4f} ms")
    del counted, twin, got
    grouped, off, part_err = partition_check(torch, keys, n_buckets)
    partition = partition_report(torch, keys, n_buckets, part_err, "ragged")
    partition["stage"]["device_count_ms"] = counted_ms
    count = count_report(torch, mapper, grouped, off, keys, n_buckets, index.table.max_probe,
                         "ragged")
    del keys, grouped, keys_buffer
    return {"kernel_rates": kernel_rates, "ms_chunk": ms_chunk, "dev_chunks": dev_chunks,
            "partition": partition, "count": count, "stage_ms": stage_ms,
            "hash": {"ms": hash_ms, "function_ms": wrapper_ms, "plain_ms": plain_ms,
                     "max_abs_err": hash_err, "bound_ms": bound_ms, "bound_by": bound_by},
            "offsets": {"ms": offsets_ms, "plain_ms": offsets_plain_ms,
                        "max_abs_err": offsets_err, "bound_ms": offsets_bound_ms,
                        "bound_by": offsets_by}}


def median_ms(fn, reps: int = 5) -> float:
    from kmer_mapper_tpu_torch.scripts import median_ms as script_median_ms
    import torch

    return script_median_ms(fn, torch.device("cuda"), reps)


def phase_dissect(torch, np, device) -> list[dict]:
    """The dissection path: each script's main at its full size, with every
    launch count zeroed before it and read after it; then every variant of
    each kernel against its twin (launches not counted)."""
    from kmer_mapper_tpu_torch.ops import stream_count_cases, stream_probe
    from kmer_mapper_tpu_torch.index import layout
    from kmer_mapper_tpu_torch.scripts import r2_kernel_dissect as A
    from kmer_mapper_tpu_torch.scripts import r2_window_dissect as B
    from kmer_mapper_tpu_torch.scripts import r3_iter_floor as C

    modules = {"r2_kernel_dissect": A, "r2_window_dissect": B, "r3_iter_floor": C}
    for m in (*modules.values(), stream_probe):
        for name in m.launch_counts:
            m.launch_counts[name] = 0
    t = time.perf_counter()
    log("dissect: python -m kmer_mapper_tpu_torch.scripts.r2_kernel_dissect")
    ra = A.main([])
    log("dissect: python -m kmer_mapper_tpu_torch.scripts.r2_window_dissect")
    rb = B.main([])
    log("dissect: python -m kmer_mapper_tpu_torch.scripts.r3_iter_floor")
    rc = C.main([])
    launches = {name: m.launch_counts[name] for name, m in modules.items()}
    launches["r2_window_ranges"] = B.launch_counts["r2_window_ranges"]
    twins = {name: m.launch_counts[f"{name}_reference"] for name, m in modules.items()}
    twins["r2_window_ranges"] = B.launch_counts["r2_window_ranges_reference"]
    if not all(launches.values()) or any(twins.values()):
        raise AssertionError(f"dissect: a kernel did not run: launches {launches}, twins {twins}")
    log(f"dissect: the three scripts ran in {time.perf_counter() - t:.1f} s; "
        f"launches {launches}")

    def u32(x):
        return x.cpu().numpy().view(np.uint32)

    max_err = {}

    def check(name, variant, got, twin):
        """kernel == twin; keeps the largest absolute difference per kernel."""
        err = float((got.cpu().double() - twin.cpu().double()).abs().max()) if got.numel() else 0.0
        max_err[name] = max(max_err.get(name, 0.0), err)
        if err or not torch.equal(got, twin):
            raise AssertionError(f"dissect: {name} {variant}: kernel != twin")

    def count_variants(module, args, max_probe, kernel_ms=None):
        """Each variant: kernel == twin from the same counts. Returns
        {variant: (kernel ms, twin ms)}, taking the kernel's from
        ``kernel_ms`` or timing 5 calls, the twin's from 3 calls, and the
        full variant's counts."""
        times, full = {}, None
        name = module.__name__.rsplit(".", 1)[1]
        for variant in module.VARIANTS:
            call_args = (*args[:2], args[2].clone(), *args[3:], max_probe, variant)
            got = module.stream_count_v(*call_args).clone()
            twin_args = (*args[:2], args[2].clone(), *args[3:], max_probe, variant)
            # the counts are uint32 bit patterns in int32
            check(name, variant, torch.from_numpy(_u32(got)),
                  torch.from_numpy(_u32(module.stream_count_v_reference(*twin_args))))
            times[variant] = (
                kernel_ms[variant] if kernel_ms else median_ms(
                    lambda: module.stream_count_v(*call_args)),
                median_ms(lambda: module.stream_count_v_reference(*twin_args), reps=3))
            full = got if variant == "full" else full
        return times, full

    def table(name, times):
        for variant, (kernel_ms, twin_ms) in times.items():
            log(f"dissect {name}: {variant:10s} kernel {kernel_ms:9.4f} ms  "
                f"twin {twin_ms:9.3f} ms")

    out = []
    # A: the script's own inputs; full must equal stream_count
    args, max_probe = ra["args"], ra["max_probe"]
    times, full_a = count_variants(A, args, max_probe, ra["ms"])
    main_args = (*args[:2], args[2].clone(), *args[3:])
    if not torch.equal(full_a, stream_probe.stream_count(*main_args)):
        raise AssertionError("dissect: r2_kernel_dissect full != stream_count")
    # the main path's launch of the same kernel, on the same inputs
    main_ms = median_ms(lambda: stream_probe.stream_count(*main_args))
    table("A", times)
    bound_ms, bound_by = count_bound(args, max_probe, int(full_a.ne(args[2]).sum()))
    log(f"dissect A: {len(A.VARIANTS)} variants == twins; full == stream_count; "
        f"stream_count {main_ms:.4f} ms on the same inputs; "
        f"bound {bound_ms:.4f} ms by {bound_by}")
    # every variant of both r2 kernels on the hazard cases the TPU grid takes
    hazards = A.hazard_cases()
    for case in hazards:
        h_args = case.inputs(device)

        def run(fn, *variant):  # from a copy of the case's counts
            return fn(*h_args[:2], h_args[2].clone(), *h_args[3:], *variant)

        main_full = run(stream_probe.stream_count)
        for module in (A, B):
            name = module.__name__.rsplit(".", 1)[1]
            for variant in module.VARIANTS:
                check(name, f"{variant} {case.name}",
                      torch.from_numpy(_u32(run(module.stream_count_v, case.table.max_probe,
                                                variant))),
                      torch.from_numpy(_u32(run(module.stream_count_v_reference,
                                                case.table.max_probe, variant))))
            full = run(module.stream_count_v, case.table.max_probe, "full")
            if not torch.equal(full, main_full) or (
                    case.name != "one_key_buckets" and not np.array_equal(u32(full),
                                                                          case.expected())):
                raise AssertionError(f"dissect: {name} full != stream_count or the oracle on "
                                     f"{case.name}")
    log(f"dissect A, B: every variant == twin on the hazard cases "
        f"{', '.join(c.name for c in hazards)}; full == stream_count (== oracle but on "
        "one_key_buckets, whose oracle finds one slot a query)")
    out.append(dict(name="r2_kernel_dissect", source="kmer_mapper_tpu_torch/csrc/r2_kernel_dissect.cu",
                    replaces="scripts/r2_kernel_dissect.py:52", ms=ra["ms"]["full"],
                    plain_ms=times["full"][1], bound_ms=bound_ms, bound_by=bound_by))

    # B: one chunk of the in-context run (each variant alone), then a
    # poly-A window
    ctx = rb["context"]
    keys, off, _ = ctx.sorted_chunk(0)
    args = ctx.count_args(torch.zeros_like(ctx.key_lo).view(-1), keys, off)
    max_probe = ctx.index.table.max_probe
    times, full_b = count_variants(B, args, max_probe)
    per_block_args = (*args[:2], args[2].clone(), *args[3:])
    for name, other in (("stream_count", stream_probe.stream_count(*per_block_args)),
                        ("r2_kernel_dissect", A.stream_count_v(
                            *args[:2], args[2].clone(), *args[3:], max_probe, "full"))):
        if not torch.equal(full_b, other):
            raise AssertionError(f"dissect: r2_window_dissect full != {name}")
    slots = layout.query_table(ctx.index.table, fixed_read_kmers(np, ctx.reads[0].bases))
    oracle_counts = np.bincount(slots[slots >= 0], minlength=ctx.index.table.n_slots)
    if not np.array_equal(u32(full_b), oracle_counts.astype(np.uint32)):
        raise AssertionError("dissect: r2_window_dissect full != the oracle on the chunk")
    per_block_ms = median_ms(lambda: stream_probe.stream_count(*per_block_args))
    # count_offsets end at the invalid tail: the last chain block's window
    # must hold no invalid query, and the count is the same
    main_off = stream_probe.count_offsets(keys, ctx.n_buckets, args[7])
    last = keys[int(main_off[-2]):int(main_off[-1])]
    if bool((last == stream_probe.INVALID_KEY).any()):
        raise AssertionError("dissect: the last window of count_offsets holds invalid queries")
    main_args = ctx.count_args(torch.zeros_like(args[2]), keys, main_off)
    if not torch.equal(full_b, stream_probe.stream_count(*main_args)):
        raise AssertionError("dissect: stream_count on count_offsets != r2_window_dissect full")
    main_ms = median_ms(lambda: stream_probe.stream_count(*main_args))
    main_split_ms = median_ms(lambda: B.stream_count_v(*main_args, max_probe, "full"))
    table("B", times)
    lengths = off[1:] - off[:-1]
    n_invalid = int((keys == stream_probe.INVALID_KEY).sum())
    bound_ms_b, bound_by_b = count_bound(args, max_probe, int(full_b.ne(0).sum()))
    log(f"dissect B: {len(B.VARIANTS)} variants == twins on one {ctx.buf}-base chunk "
        f"({keys.numel()} queries, {n_invalid} of them invalid; longest window "
        f"{int(lengths.max())} queries in block {int(lengths.argmax())} of {lengths.numel()}); "
        f"full == r2_kernel_dissect == stream_count == oracle; per-block stream_count alone "
        f"{per_block_ms:.4f} ms on block_offsets; bound {bound_ms_b:.4f} ms by {bound_by_b}")
    log(f"dissect B: tail repair: per-block stream_count {per_block_ms:.4f} ms on "
        f"block_offsets (last window {int(lengths[-1])} queries) -> {main_ms:.4f} ms on "
        f"count_offsets (last window {last.numel()} queries, none invalid); counts equal; "
        f"split-window full {times['full'][0]:.4f} -> {main_split_ms:.4f} ms")
    # the schedule kernel == its twin on this chunk, timed
    def ranges_entry(off, n_queries):
        got = B.window_ranges(off, n_queries)
        check("r2_window_ranges", "schedule", got, B.window_ranges_reference(off, n_queries))
        return got

    ranges = ranges_entry(off, keys.numel())
    ranges_ms = median_ms(lambda: B.window_ranges(off, keys.numel()))
    ranges_plain_ms = median_ms(lambda: B.window_ranges_reference(off, keys.numel()), reps=3)
    n_live = int((ranges[:, 0] < lengths.numel()).sum())
    # each window's bounds read, each row written; per block ~8 operations
    # (its range count and scan), per row ~3
    ranges_bound = bound(4 * off.numel() + ranges.numel() * 4,
                         8 * lengths.numel() + 3 * ranges.shape[0])
    log(f"dissect B: window ranges at span {B.SPAN}: {n_live} ranges for {lengths.numel()} "
        f"windows ({ranges.shape[0]} rows), kernel == twin, {ranges_ms:.4f} ms, twin "
        f"{ranges_plain_ms:.3f} ms; bound {ranges_bound[0]:.6f} ms by {ranges_bound[1]}")

    def split_times(count_args, max_probe):
        """full (at the script's span), the per-block stream_count and
        r2_kernel_dissect's full on the same inputs (from the same counts)."""
        scratch = count_args[2].clone()
        t = {f"span {B.SPAN}": median_ms(lambda: B.stream_count_v(
            *count_args[:2], scratch, *count_args[3:], max_probe, "full"))}
        t["stream_count"] = median_ms(lambda: stream_probe.stream_count(
            *count_args[:2], scratch, *count_args[3:]))
        t["r2_kernel_dissect full"] = median_ms(lambda: A.stream_count_v(
            *count_args[:2], scratch, *count_args[3:], max_probe, "full"))
        return t

    def split_report(what, t):
        log(f"dissect B: {what}: " + ", ".join(f"{k} {ms:.4f} ms" for k, ms in t.items())
            + f"; span {B.SPAN} is {t['stream_count'] / t[f'span {B.SPAN}']:.2f}x the "
            "per-block stream_count")

    split_report(f"split vs per-block on the {ctx.buf}-base chunk (block_offsets)",
                 split_times(args, max_probe))
    rng = np.random.default_rng(1)
    keys_pa = np.concatenate([[np.uint64(0)], np.unique(
        rng.integers(0, 1 << 62, 8000, dtype=np.uint64))])
    table_pa = layout.build_table(keys_pa)
    queries = np.concatenate([np.zeros(DISSECT_POLY_A, np.uint64), rng.choice(keys_pa, 50_000)])
    case = stream_count_cases.Case("poly_a_tiles", table_pa, queries,
                                   np.ones(len(queries), bool), np.zeros(table_pa.n_slots, np.uint32))
    pa_args = case.inputs(device)
    results = [fn(*pa_args[:2], pa_args[2].clone(), *pa_args[3:], table_pa.max_probe, "full")
               for fn in (B.stream_count_v, A.stream_count_v, B.stream_count_v_reference)]
    results.append(stream_probe.stream_count(*pa_args[:2], pa_args[2].clone(), *pa_args[3:]))
    window = int((pa_args[4][1:] - pa_args[4][:-1]).max())
    if not all(torch.equal(results[0], r) for r in results[1:]) or not np.array_equal(
            u32(results[0]), case.expected()):
        raise AssertionError("dissect: split-window count differs on the poly-A window")
    ranges_entry(pa_args[4], pa_args[3].numel())
    for variant in B.VARIANTS:  # every variant on the poly-A window too
        check("r2_window_dissect", f"{variant} poly-A",
              torch.from_numpy(_u32(B.stream_count_v(*pa_args[:2], pa_args[2].clone(),
                                                     *pa_args[3:], table_pa.max_probe, variant))),
              torch.from_numpy(_u32(B.stream_count_v_reference(
                  *pa_args[:2], pa_args[2].clone(), *pa_args[3:], table_pa.max_probe, variant))))
    log(f"dissect B: poly-A window of {window} queries over {-(-window // B.SPAN)} ranges: "
        "every variant == twin; split-window == per-block == stream_count == twin == oracle")
    split_report(f"split vs per-block on the poly-A window ({window} of {queries.size} queries)",
                 split_times(pa_args, table_pa.max_probe))
    out.append(dict(name="r2_window_dissect", source="kmer_mapper_tpu_torch/csrc/r2_window_dissect.cu",
                    replaces="scripts/r2_window_dissect.py:45", ms=times["full"][0],
                    plain_ms=times["full"][1], bound_ms=bound_ms_b, bound_by=bound_by_b))
    out.append(dict(name="r2_window_ranges", source="kmer_mapper_tpu_torch/csrc/r2_window_dissect.cu",
                    replaces="scripts/r2_window_dissect.py:143 (jnp schedule)", ms=ranges_ms,
                    plain_ms=ranges_plain_ms, bound_ms=ranges_bound[0],
                    bound_by=ranges_bound[1]))

    # C: the script's inputs, every variant
    off, tb, q = rc["inputs"]
    times = {}
    for variant in C.VARIANTS:
        twin_args = (off, tb, q, variant, C.N_ITER, C.N_GRID, C.CAP)
        check("r3_iter_floor", variant, C.iter_floor(off, tb, q, variant),
              C.iter_floor_reference(*twin_args))
        times[variant] = (rc["ms"][variant],
                          median_ms(lambda: C.iter_floor_reference(*twin_args), reps=3))
    table("C", times)
    # vmem and dma sum floats in t order: each lane is one chain of N_ITER
    # dependent adds, which no split of the loop may shorten
    chain_ms = C.N_ITER * FADD_CYCLES / (max_sm_mhz() * 1e3)
    log("dissect C: vmem, dma: " + ", ".join(f"{v} {times[v][0]:.4f} ms" for v in ("vmem", "dma"))
        + f" against their serial-chain floor {chain_ms:.4f} ms ({C.N_ITER} dependent "
        f"float adds of {FADD_CYCLES} cycles at {max_sm_mhz():.0f} MHz), not the rates' bound")
    # bound of full: the inputs read and the output written once; per lane
    # and iteration 4 integer operations (position window, local_b, its
    # range), per live lane 8 key lanes of 2 word compares; the one float
    # add per live lane issues on the FP32 pipe beside them
    t_idx = torch.arange(C.N_ITER, device=device)
    a = off[t_idx % C.OFF_HALF].long()[:, None]
    b = off[C.OFF_HALF + t_idx % C.OFF_HALF].long()[:, None]
    col = (t_idx % C.N_TILES)[:, None] * C.CAP + torch.arange(C.CAP, device=device)
    local = q[0].long()[col] - torch.remainder(b, C.MOD)
    n_live = int(((col >= a) & (col < a + C.CAP) & (local >= 0) & (local < C.BPB)).sum())
    n_bytes = 4 * (off.numel() + tb.numel() + q.numel() + C.BPB * C.K)
    bound_ms_c, bound_by_c = bound(n_bytes, C.N_ITER * (4 * C.CAP + 2) + n_live * 16)
    log(f"dissect C: {len(C.VARIANTS)} variants == twins; {n_live} live lanes in full; "
        f"bound {bound_ms_c:.6f} ms by {bound_by_c}")
    out.append(dict(name="r3_iter_floor", source="kmer_mapper_tpu_torch/csrc/r3_iter_floor.cu",
                    replaces="scripts/r3_iter_floor.py:65", ms=rc["ms"]["full"],
                    plain_ms=times["full"][1], bound_ms=bound_ms_c, bound_by=bound_by_c))
    for entry in out:
        entry.update(route="cuda", launches=launches[entry["name"]],
                     max_abs_err=max_err[entry["name"]], library_ms=None)
    return out


def phase_tiles(torch, np, device) -> list[dict]:
    """The tile-body path: each r9 script's main at its full size, with
    every launch count zeroed before it and read after it; then every
    variant against its twin on the main's inputs (launches not counted)
    and on each hazard input, and what the candidate loop of each variant
    does on the main's inputs (candidates and hits a live lane-tile, trips
    a warp-tile)."""
    from kmer_mapper_tpu_torch.scripts import r9_block_pipeline as P
    from kmer_mapper_tpu_torch.scripts import r9_dot_orient as D
    from kmer_mapper_tpu_torch.scripts import r9_step_parts as S

    modules = {"r9_dot_orient": D, "r9_step_parts": S, "r9_block_pipeline": P}
    for m in modules.values():
        for name in m.launch_counts:
            m.launch_counts[name] = 0
    t = time.perf_counter()
    results = {}
    for name, m in modules.items():
        log(f"tiles: python -m kmer_mapper_tpu_torch.scripts.{name}")
        results[name] = m.main([])
    launches = {name: m.launch_counts[name] for name, m in modules.items()}
    twins = {name: m.launch_counts[f"{name}_reference"] for name, m in modules.items()}
    if not all(launches.values()) or any(twins.values()):
        raise AssertionError(f"tiles: a kernel did not run: launches {launches}, twins {twins}")
    log(f"tiles: the three scripts ran in {time.perf_counter() - t:.1f} s; launches {launches}")

    # (kernel, twin at the script's sizes, the variant in the kernels line)
    calls = {
        "r9_dot_orient": (D.dot_orient,
                          lambda x, v: D.dot_orient_reference(*x, v, D.ITERS), "new"),
        "r9_step_parts": (S.step_parts,
                          lambda x, v: S.step_parts_reference(*x, v, S.GRID, S.TILES), "newfull"),
        "r9_block_pipeline": (P.block_pipeline, lambda x, v: P.block_pipeline_reference(
            *x, v, P.GRID, P.TILES), "new"),
    }
    # the fingerprinted kernels' hazard inputs (CPU tensors) and loop counts
    fingerprinted = {
        "r9_dot_orient": (D.HAZARDS, lambda v, kind: D.hazard_inputs(kind, v),
                          lambda x, v: D.candidate_loop(*x, v)),
        "r9_step_parts": (S.HAZARDS, lambda v, kind: S.step_hazard_inputs(
            "cpu", kind, S.FLAGS[v], S.COARSE, S.LANES), lambda x, v: S.candidate_loop(*x, v)),
        "r9_block_pipeline": (S.HAZARDS, lambda v, kind: S.step_hazard_inputs(
            "cpu", kind, P.FLAGS[v], P.GRID * S.COARSE, P.LANES),
            lambda x, v: P.candidate_loop(*x, v)),
    }
    out = []
    for name, m in modules.items():
        kernel, twin, main_variant = calls[name]
        res, max_err, twin_ms = results[name], 0, {}

        def check(fn, inputs, variant, what):
            got, ref = _u32(fn(*inputs, variant)), _u32(twin(inputs, variant))
            if not np.array_equal(got, ref):
                raise AssertionError(f"tiles: {name} {variant} {what}: kernel != twin")
            # hits: the count tile's sum, or the count slots that changed
            hits = int(got.sum()) if m is D else int((got != _u32(inputs[2])).sum())
            if not hits:
                raise AssertionError(f"tiles: {name} {variant} {what}: no hits")
            return int(np.abs(got - ref).max()), hits

        for variant, inputs in res["inputs"].items():
            err, hits = check(kernel, inputs, variant, "main's inputs")
            max_err = max(max_err, err)
            twin_ms[variant] = median_ms(lambda: twin(inputs, variant), reps=3)
            extra = ""
            if name in fingerprinted:
                hazards, make, loop = fingerprinted[name]
                for kind in hazards:
                    x = tuple(t.to(device) for t in make(variant, kind))
                    max_err = max(max_err, check(kernel, x, variant, kind)[0])
                n = loop(inputs, variant)
                extra = (f"; == twin on {', '.join(hazards)}; a live lane-tile "
                         f"{n['candidates'] / n['lane_tiles']:.4f} candidates, "
                         f"{n['hits'] / n['lane_tiles']:.4f} hits; a live warp-tile "
                         f"{n['trips'] / n['warp_tiles']:.4f} loop trips ({n['lane_tiles']} "
                         f"lane-tiles, {n['warp_tiles']} warp-tiles)")
            log(f"tiles {name}: {variant:9s} kernel {res['ms'][variant]:9.4f} ms  twin "
                f"{twin_ms[variant]:9.3f} ms  == twin, {hits} "
                f"{'hits' if m is D else 'count slots changed'}{extra}")
        # bound: the inputs read and the outputs written once; 4 integer
        # operations per lane and tile (bucket, live), 16 word compares per
        # live lane (2 words of 8 key lanes)
        x = res["inputs"][main_variant]
        if m is D:
            n_tiles, per_tile = D.ITERS, np.arange(D.ITERS)
            n_bytes = 2 * x[0].numel() + 4 * x[1].numel() + 4 * D.K * D.GPB
        else:
            n_tiles, per_tile = m.GRID * m.TILES, np.tile(np.arange(m.TILES), m.GRID)
            n_bytes = 4 * (3 * x[0].numel() + x[3].numel()) + 4 * x[2].numel()
        lanes = x[1].shape[1] if m is D else x[3].shape[1]
        n_live = int(np.maximum(0, lanes - (per_tile & 63)).sum())
        bound_ms, bound_by = bound(n_bytes, 4 * n_tiles * lanes + 16 * n_live)
        log(f"tiles {name}: {len(res['ms'])} variants == twins; {n_tiles} tiles, {n_live} live "
            f"lanes; bound {bound_ms:.6f} ms by {bound_by}")
        line = {"r9_dot_orient": 55, "r9_step_parts": 63, "r9_block_pipeline": 56}[name]
        out.append(dict(name=name, route="cuda", source=f"kmer_mapper_tpu_torch/csrc/{name}.cu",
                        replaces=f"scripts/{name}.py:{line}", launches=launches[name],
                        max_abs_err=max_err, ms=res["ms"][main_variant],
                        plain_ms=twin_ms[main_variant], bound_ms=bound_ms, bound_by=bound_by,
                        library_ms=None))
    return out


def gather_bound(key_lo, table, block_probe, queries, slots) -> dict:
    """The gather probe's work on these raw int64 queries (``slots``: the
    slot of each, or -1): mean rounds a query under the block bounds and
    under the table's max_probe alone (hits: up to the hit; misses: the
    walk's bound; the sentinel: none), and each mode's bound and row-traffic
    time. Bytes of the slots mode's bound: each query's 8 bytes read once,
    the 32 bytes of lo words of each bucket the run touches read once, the
    32 bytes of hi words only of the buckets where some query's lo word
    matched (a round without a lo match reads no hi word), 4 bytes of slot
    written per query; of the counts mode's: the queries, the same rows,
    and the count of each slot hit read and written once (8 bytes), no slot
    output. Operations: 30 for the Feistel mix of each query (3 rounds of
    fmix32 and two xors) and 9 per round taken (8 lane compares and the
    bucket). The row-traffic time is the same bytes with every round's
    32-byte lo row and every lo-matched round's 32-byte hi sector read
    again, and in counts mode every hit's count read and written, as a
    gather that caches nothing would."""
    import torch

    from kmer_mapper_tpu_torch.ops import probe
    from kmer_mapper_tpu_torch.ops.u32hash import to_int32_bits

    n, n_buckets = queries.numel(), table.n_buckets
    bpb = min(128, n_buckets)
    b0, m_lo, _, walk = probe.query_rounds(queries, table.max_probe, table.seed, n_buckets,
                                           block_probe)
    _, _, _, unbounded = probe.query_rounds(queries, table.max_probe, table.seed, n_buckets)
    slots = slots.long()
    hit = slots >= 0
    to_hit = ((slots // 8 - b0) & (bpb - 1)) + 1
    rounds = torch.where(hit, to_hit, walk)
    old_rounds = torch.where(hit, to_hit, unbounded)
    w_lo = to_int32_bits(m_lo)
    touched = torch.zeros(n_buckets, dtype=torch.bool, device=queries.device)
    hi_touched = torch.zeros_like(touched)
    n_lo_matched = 0  # rounds whose row holds the query's lo word
    for p in range(table.max_probe):
        sel = rounds > p
        b = probe.chain_next(b0[sel], p, n_buckets)
        touched[b] = True
        matched = (key_lo[b] == w_lo[sel][:, None]).any(dim=1)
        hi_touched[b[matched]] = True
        n_lo_matched += int(matched.sum())
    n_rounds, n_touched, n_hi = int(rounds.sum()), int(touched.sum()), int(hi_touched.sum())
    n_hits, n_slots_hit = int(hit.sum()), int(torch.unique(slots[hit]).numel())
    n_ops = 30 * n + 9 * n_rounds
    rows = 32 * n_touched + 32 * n_hi
    slots_ms, slots_by = bound(12 * n + rows, n_ops)
    count_ms, count_by = bound(8 * n + rows + 8 * n_slots_hit, n_ops)
    row_traffic = 32 * n_rounds + 32 * n_lo_matched
    return {
        "rounds": n_rounds / max(n, 1), "old_rounds": int(old_rounds.sum()) / max(n, 1),
        "hits": n_hits, "touched": n_touched, "hi_touched": n_hi, "slots_hit": n_slots_hit,
        "slots_bound_ms": slots_ms, "slots_bound_by": slots_by,
        "count_bound_ms": count_ms, "count_bound_by": count_by,
        "slots_row_ms": (12 * n + row_traffic) / HBM_BYTES_PER_S * 1e3,
        "count_row_ms": (8 * n + row_traffic + 8 * n_hits) / HBM_BYTES_PER_S * 1e3,
    }


def library_hashes(np, rng, arrays, n: int, shuffle: bool = True):
    """n uint64 hashes: half drawn from the index's kmers, half uniform."""
    q = np.concatenate([rng.choice(arrays.kmers, n // 2),
                        rng.integers(0, 1 << 62, n - n // 2, dtype=np.uint64)])
    if shuffle:
        rng.shuffle(q)
    return q


def probe_report(torch, what: str, key_lo, key_hi, table, block_probe, queries) -> dict:
    """Both modes of the gather kernel on one batch: == the twins, warm and
    cold device ms, the twins' ms, rounds, bounds and row-traffic times."""
    from kmer_mapper_tpu_torch.ops import probe
    from kmer_mapper_tpu_torch.scripts import cold_ms

    args = (key_lo, key_hi, queries, table.max_probe, table.seed)
    kw = dict(block_probe=block_probe)
    cold = functools.partial(cold_ms, device=key_lo.device)
    slots = probe.probe_slots(*args, **kw)
    twin = probe.probe_slots_reference(*args, block_probe=block_probe)
    counts = torch.zeros(table.n_slots, dtype=torch.int32, device=key_lo.device)
    count_args = (key_lo, key_hi, counts, queries, table.max_probe, table.seed)
    probe.probe_count(*count_args, **kw)
    twin_counts = probe.probe_count_reference(
        key_lo, key_hi, torch.zeros_like(counts), queries, table.max_probe, table.seed,
        block_probe=block_probe)
    err = max(key_err(slots, twin), key_err(counts, twin_counts))
    if err:
        raise AssertionError(f"library: gather kernel != twin on {what}")
    r = gather_bound(key_lo, table, block_probe, queries, slots)
    r.update(
        err=err,
        slots_ms=median_ms(lambda: probe.probe_slots(*args, **kw)),
        slots_cold_ms=cold(lambda: probe.probe_slots(*args, **kw)),
        count_ms=median_ms(lambda: probe.probe_count(*count_args, **kw)),
        count_cold_ms=cold(lambda: probe.probe_count(*count_args, **kw)),
        slots_plain_ms=median_ms(lambda: probe.probe_slots_reference(
            *args, block_probe=block_probe), reps=3),
        count_plain_ms=median_ms(lambda: probe.probe_count_reference(
            *count_args, block_probe=block_probe), reps=3),
    )
    log(f"library: gather_probe on {what}, {queries.numel()} queries ({r['hits']} hits), "
        f"== twins: slots {r['slots_ms']:.4f} ms warm, {r['slots_cold_ms']:.4f} cold (twin "
        f"{r['slots_plain_ms']:.3f}); counts {r['count_ms']:.4f} warm, "
        f"{r['count_cold_ms']:.4f} cold (twin {r['count_plain_ms']:.3f}); "
        f"{r['rounds']:.4f} rounds a query ({r['old_rounds']:.4f} under max_probe "
        f"{table.max_probe} alone); {r['touched']} buckets touched ({r['hi_touched']} with a "
        f"lo match), {r['slots_hit']} slots hit; bound slots {r['slots_bound_ms']:.4f} ms by "
        f"{r['slots_bound_by']}, counts {r['count_bound_ms']:.4f} ms by "
        f"{r['count_bound_by']}; row traffic slots {r['slots_row_ms']:.4f} ms, counts "
        f"{r['count_row_ms']:.4f} ms")
    return r


def phase_library(torch, np, arrays, rng, device) -> dict:
    """The pre-hashed library path at the sizes a KAGE caller passes, on the
    bench index: compat calls, map_hashes and GpuCounter, each against the
    numpy oracle with every launch count zeroed before and read after
    (gather_probe must run, stream_count and the twins not); the 2^26 call
    split into upload, kernel and node counts; the upload of one piece
    from pageable and from page-locked memory; the gather kernel against
    its twins on every hazard case; the stream route against the gather
    route at 2^12 ... 2^26 hashes; the kernel's time, rounds and bounds in
    both modes at 2^24 on the bench index, a table of 2^23 buckets (10x the
    L2), a skewed, a hit-only and a miss-only batch."""
    import statistics

    from kmer_mapper_tpu_torch import compat, gpu_counter, oracle
    from kmer_mapper_tpu_torch.ops import probe, probe_cases, stream_probe
    from kmer_mapper_tpu_torch.scripts.gather_probe_dissect import probe_batch, random_table
    from kmer_mapper_tpu_torch.ops.u32hash import MASK32

    def launches():
        return {**stream_probe.launch_counts, **probe.launch_counts}

    path_launches = 0  # gather_probe launches of the calls below, as a user makes them

    def require(before, what: str):
        nonlocal path_launches
        now = launches()
        twins = {k: now[k] - before[k] for k in now if "reference" in k and now[k] != before[k]}
        if (now["gather_probe"] <= before["gather_probe"] or twins
                or now["stream_count"] != before["stream_count"]):
            raise AssertionError(f"library: {what} did not run gather_probe alone: "
                                 f"before {before}, after {now}")
        path_launches += now["gather_probe"] - before["gather_probe"]

    t_phase = time.perf_counter()
    for m in (probe, stream_probe):
        for name in m.launch_counts:
            m.launch_counts[name] = 0
    q = library_hashes(np, rng, arrays, LIB_HASHES)
    before = launches()
    t = time.perf_counter()
    got = compat.map_kmers_to_graph_index(arrays, kmers=q)
    first_s = time.perf_counter() - t
    require(before, "map_kmers_to_graph_index")
    t = time.perf_counter()
    if not np.array_equal(got, oracle.map_kmers_to_index(arrays, q)):
        raise AssertionError("library: map_kmers_to_graph_index != oracle.map_kmers_to_index")
    oracle_s = time.perf_counter() - t
    index = compat._as_index(arrays)
    mapper = compat._shared_mapper(index)
    table = index.table
    table_ptr = mapper.key_lo.data_ptr()
    log(f"library: map_kmers_to_graph_index on {len(q)} hashes (table build and upload "
        f"included) in {first_s:.2f} s; {int(got.sum())} node hits == oracle "
        f"({oracle_s:.1f} s)")

    # a second call with the same index object: the cached mapper and its
    # device table, timed on LIB_TIMED hashes, then its stages alone
    big = library_hashes(np, rng, arrays, LIB_TIMED, shuffle=False)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    before = launches()
    t = time.perf_counter()
    got_big = compat.map_kmers_to_graph_index(arrays, kmers=big)
    big_s = time.perf_counter() - t
    peak = torch.cuda.max_memory_allocated() - base
    require(before, "the timed map_kmers_to_graph_index")
    if compat._shared_mapper(index) is not mapper or mapper.key_lo.data_ptr() != table_ptr:
        raise AssertionError("library: the second call did not reuse the cached mapper")
    if int(got_big.sum()) < LIB_TIMED // 2:
        raise AssertionError("library: the timed call counted too few hits")
    t = time.perf_counter()
    pieces = list(mapper._hash_pieces(big))
    torch.cuda.synchronize()
    upload_s = time.perf_counter() - t
    mapper.reset_counts()
    t = time.perf_counter()
    for piece in pieces:
        probe.probe_count(mapper.key_lo, mapper.key_hi, mapper.counts, piece, table.max_probe,
                          table.seed, block_probe=mapper.block_probe)
    torch.cuda.synchronize()
    kernel_s = time.perf_counter() - t
    t = time.perf_counter()
    if not np.array_equal(mapper.node_counts(), got_big):
        raise AssertionError("library: the split stages of the timed call count otherwise")
    finalize_s = time.perf_counter() - t
    split = dict(call_s=big_s, upload_s=upload_s, kernel_s=kernel_s, finalize_s=finalize_s,
                 counts=mapper.counts.clone(), node_counts=got_big)
    log(f"library: second call on {LIB_TIMED} hashes, same mapper and table: "
        f"{big_s:.3f} s host clock, {LIB_TIMED / big_s / 1e6:.1f} M hashes/s; its stages "
        f"alone (host clock): upload {upload_s:.4f} s, kernel {kernel_s:.4f} s, node counts "
        f"{finalize_s:.4f} s, the rest {big_s - upload_s - kernel_s - finalize_s:.4f} s; "
        f"peak device memory above the table {peak / 2**30:.2f} GiB ({peak / LIB_TIMED:.1f} "
        f"B a hash, HASH_PIECE {mapper.HASH_PIECE})")
    # one piece's upload from pageable memory (what _hash_pieces does) and
    # through a page-locked buffer (a host copy, then the DMA)
    host = torch.from_numpy(big.view(np.int64))
    t = time.perf_counter()
    pinned = torch.empty(host.shape, dtype=torch.int64, pin_memory=True)
    alloc_s = time.perf_counter() - t
    timing = {"pageable": [], "page-locked": []}
    for _ in range(3):
        for how in timing:
            torch.cuda.synchronize()
            t = time.perf_counter()
            if how == "pageable":
                on_card = host.to(device)
            else:
                pinned.copy_(host)
                on_card = pinned.to(device, non_blocking=True)
            torch.cuda.synchronize()
            timing[how].append(time.perf_counter() - t)
            del on_card
    log(f"library: upload of one {host.numel() * 8 / 2**20:.0f} MiB piece, median of 3: "
        f"pageable {statistics.median(timing['pageable']):.4f} s, through a page-locked "
        f"buffer {statistics.median(timing['page-locked']):.4f} s (copy in and DMA; the "
        f"buffer's allocation {alloc_s:.4f} s once)")
    del big, got_big, pieces, pinned, host

    before = launches()
    member = compat.in_graph_index(arrays, q)
    require(before, "in_graph_index")
    if not np.array_equal(member, oracle.in_index(arrays, q)):
        raise AssertionError("library: in_graph_index != oracle.in_index")
    log(f"library: in_graph_index on {len(q)} hashes == oracle ({int(member.sum())} in)")

    small = q[:LIB_GATHER]
    before = launches()
    mapper.reset_counts()
    mapper.map_hashes(small)
    require(before, "map_hashes")
    if not np.array_equal(mapper.node_counts(), oracle.map_kmers_to_index(arrays, small)):
        raise AssertionError("library: map_hashes != oracle")
    log(f"library: map_hashes on {LIB_GATHER} hashes == oracle")

    counted = q[:LIB_COUNTER]
    before = launches()
    counter = gpu_counter.GpuCounter.from_kmers_and_nodes(arrays.kmers, arrays.nodes, K)
    counter.count(counted, count_revcomps=True)
    got_nodes = counter.get_node_counts()
    require(before, "GpuCounter.count")
    unique = np.unique(arrays.kmers)
    expect = oracle.node_counts_from_kmer_counts(
        arrays.kmers, arrays.nodes, unique, oracle.count_unique_kmers(
            unique, np.concatenate([counted, oracle.revcomp_hash(counted, K)])))
    if not np.array_equal(got_nodes, expect):
        raise AssertionError("library: GpuCounter != numpy node_counts_from_kmer_counts")
    log(f"library: GpuCounter.count({LIB_COUNTER} hashes, count_revcomps=True) == numpy "
        f"path ({int(got_nodes.sum())} node hits); gather_probe launched {path_launches} "
        f"times by these calls, stream_count and the twins never: {launches()}")

    # the kernel against its twins and the loop on every hazard case, in both
    # modes (launches not counted)
    max_err = 0
    cases = probe_cases.cases()
    for case in cases:
        s_args, s_kw = case.slot_args(device)
        twin_slots = probe.probe_slots_reference(*s_args, **s_kw).cpu().numpy()
        slots = probe.probe_slots(*s_args, **s_kw).cpu().numpy()
        c_args, c_kw = case.count_args(device)
        twin_counts = _u32(probe.probe_count_reference(*c_args, **c_kw))
        c_args, c_kw = case.count_args(device)
        counts = _u32(probe.probe_count(*c_args, **c_kw))
        max_err = max(max_err, int(np.abs(slots.astype(np.int64) - twin_slots).max(initial=0)),
                      int(np.abs(counts - twin_counts).max(initial=0)))
        if (max_err or not np.array_equal(slots, case.expected_slots())
                or not np.array_equal(counts, case.expected_counts())):
            raise AssertionError(f"library: gather hazard {case.name}: kernel, twin and loop "
                                 "differ")
    log(f"library: gather_probe == twins == numpy loop on {len(cases)} hazard cases, both "
        "modes")

    # the stream route (mix, block partition, stream_count) against the gather route on
    # device-resident raw words, up to a whole piece
    raw = probe_batch(rng, arrays.kmers, LIB_TIMED, 0.5, device=device)
    lo, hi = raw & MASK32, (raw >> 32) & MASK32
    valid = torch.ones(raw.numel(), dtype=torch.bool, device=device)
    scratch = torch.zeros_like(mapper.counts)

    def stream_route(n, counts):
        return lambda: stream_probe.stream_probe_count(
            mapper.key_lo, mapper.key_hi, counts, lo[:n], hi[:n], valid[:n], table.seed,
            mapper.block_probe)

    def gather_route(n, counts):
        return lambda: probe.probe_count(mapper.key_lo, mapper.key_hi, counts, raw[:n],
                                         table.max_probe, table.seed,
                                         block_probe=mapper.block_probe)

    log("library: crossover, device ms of one map_hashes piece on each route "
        "(median of 5)")
    for n in CROSSOVER:
        a, b = torch.zeros_like(scratch), torch.zeros_like(scratch)
        stream_route(n, a)()
        gather_route(n, b)()
        if not torch.equal(a, b):
            raise AssertionError(f"library: stream and gather routes differ at n={n}")
        row = (median_ms(stream_route(n, scratch)), median_ms(gather_route(n, scratch)))
        log(f"  n = 2^{n.bit_length() - 1:2d}: stream {row[0]:8.4f} ms  gather {row[1]:8.4f} ms")
    del lo, hi, valid, raw, scratch
    torch.cuda.empty_cache()

    # the kernel line: in_graph_index's shape, LIB_HASHES queries in slots
    # mode on the bench index, and the same batch in counts mode
    queries = torch.from_numpy(q.view(np.int64)).to(device)
    lib = probe_report(torch, "the bench index (2^24, half hits)", mapper.key_lo,
                       mapper.key_hi, table, mapper.block_probe, queries)
    max_err = max(max_err, lib["err"])
    for what, hit_share, hot_share in (("a skewed batch (25% one key, the rest half hits)",
                                        0.5, 0.25),
                                       ("a hit-only batch", 1.0, 0.0),
                                       ("a miss-only batch", 0.0, 0.0)):
        batch = probe_batch(rng, arrays.kmers, LIB_HASHES, hit_share, hot_share, device)
        r = probe_report(torch, what, mapper.key_lo, mapper.key_hi, table,
                         mapper.block_probe, batch)
        max_err = max(max_err, r["err"])
    del queries, batch
    torch.cuda.empty_cache()

    # a table ten times the L2: 2^24 random keys in 2^23 buckets (537 MB)
    t = time.perf_counter()
    keys, large, key_lo, key_hi, block_probe = random_table(rng, LARGE_TABLE_KEYS,
                                                            LARGE_TABLE_BUCKETS, device)
    log(f"library: large table of {len(keys)} keys in {large.n_buckets} buckets "
        f"({large.nbytes / 1e6:.0f} MB, max_probe {large.max_probe}) built and uploaded in "
        f"{time.perf_counter() - t:.1f} s")
    batch = probe_batch(rng, keys, LIB_HASHES, 0.5, device=device)
    r = probe_report(torch, "the large table (2^24, half hits)", key_lo, key_hi, large,
                     block_probe, batch)
    max_err = max(max_err, r["err"])
    del key_lo, key_hi, block_probe, batch
    torch.cuda.empty_cache()
    log(f"library: phase took {time.perf_counter() - t_phase:.1f} s")
    split.update(large=(keys, large), index=index)
    return split, {
        "name": "gather_probe", "route": "cuda",
        "source": "kmer_mapper_tpu_torch/csrc/gather_probe.cu",
        "replaces": "kmer_mapper_tpu/ops/probe.py:31 (XLA)",
        "launches": path_launches, "max_abs_err": max_err,
        "ms": lib["slots_ms"], "plain_ms": lib["slots_plain_ms"],
        "bound_ms": lib["slots_bound_ms"], "bound_by": lib["slots_bound_by"],
        "library_ms": None,  # no single PyTorch call probes a bucket chain
    }


def fastq_bytes(np, chunk, first_id: int) -> bytes:
    """The chunk's fixed-length reads as FASTQ records of one width:
    '@' and a 9-digit id, the read, '+', a quality line of 'I'."""
    n = chunk.n_reads
    head = 11  # '@', 9 digits, newline
    rec = np.empty((n, head + 2 * READ_LEN + 4), dtype=np.uint8)
    rec[:, 0] = ord("@")
    ids = np.arange(first_id, first_id + n, dtype=np.int64)
    for d in range(9):
        rec[:, 9 - d] = ord("0") + (ids // 10**d) % 10
    rec[:, 10] = ord("\n")
    rec[:, head : head + READ_LEN] = chunk.bases.reshape(n, READ_LEN)
    rec[:, head + READ_LEN : head + READ_LEN + 3] = np.frombuffer(b"\n+\n", dtype=np.uint8)
    rec[:, head + READ_LEN + 3 : -1] = ord("I")
    rec[:, -1] = ord("\n")
    return rec.tobytes()


def write_bgzf(path, payload: bytes, block_out: int = 60_000, level: int = 6) -> None:
    """A BGZF file (bgzip's container): independent gzip members of at most
    ``block_out`` input bytes, each with the BC/BSIZE extra field, then the
    empty BGZF end-of-file member."""
    import struct
    import zlib

    with open(path, "wb") as f:
        for off in range(0, len(payload), block_out):
            chunk = payload[off : off + block_out]
            co = zlib.compressobj(level, zlib.DEFLATED, -15)
            data = co.compress(chunk) + co.flush()
            bsize = len(data) + 18 + 8 - 1  # header (12 + 6 extra) + data + crc/isize
            header = (b"\x1f\x8b\x08\x04\x00\x00\x00\x00\x00\xff" + struct.pack("<H", 6)
                      + b"BC" + struct.pack("<HH", 2, bsize))
            f.write(header + data + struct.pack("<II", zlib.crc32(chunk),
                                                len(chunk) & 0xFFFFFFFF))
        f.write(bytes.fromhex("1f8b08040000000000ff0600424302001b0003000000000000000000"))


def trace_busy_share(profile_dir: str) -> tuple[float, float, int]:
    """(busy share, window ms, stream_count launches) of the torch.profiler
    trace in ``profile_dir``. The window runs from the first ``map_chunk``
    region on the host to the end of the last device activity; busy is the
    union of the kernels, copies and sets on the device inside it."""
    import glob

    files = glob.glob(os.path.join(profile_dir, "*.pt.trace.json"))
    if len(files) != 1:
        raise AssertionError(f"file feed: expected one trace in {profile_dir}, found {files}")
    with open(files[0]) as f:
        events = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]
    device = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in events
                    if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset"))
    steps = [float(e["ts"]) for e in events
             if e.get("cat") == "user_annotation" and e.get("name") == "map_chunk"]
    if not device or not steps:
        raise AssertionError("file feed: the trace holds no device activity or no map_chunk")
    start, end = min(steps), max(stop for _, stop in device)
    busy, cursor = 0.0, start
    for a, b in device:
        a, b = max(a, cursor), min(b, end)
        if b > a:
            busy += b - a
            cursor = b
    launches = sum(1 for e in events
                   if e.get("cat") == "kernel" and "stream_count_kernel" in e.get("name", ""))
    return busy / (end - start), (end - start) / 1e3, launches


class RunFigures(logging.Handler):
    """Keeps the figures of the latest ``map_file``, read off its timing
    record (``record.figures``)."""

    def __init__(self):
        super().__init__(logging.INFO)
        self.figures = None

    def emit(self, record):
        if hasattr(record, "figures"):
            self.figures = record.figures


def ragged_fastq_bytes(np, chunk) -> bytes:
    """A chunk's reads of any length as FASTQ: '@r' and an id, the read,
    '+', a quality line of 'I'."""
    ends = chunk.read_starts + chunk.read_lengths
    return b"".join(b"@r%d\n%s\n+\n%s\n" % (i, chunk.bases[s:e].tobytes(), b"I" * (e - s))
                    for i, (s, e) in enumerate(zip(chunk.read_starts, ends)))


def phase_file_feed(torch, np, chunks, dev_chunks, ragged, index, device, workdir) -> dict:
    """The file path as a user runs it: the CLI on FASTQ, .fq.gz and BGZF
    files of phase 5's reads and on a FASTQ of the first ragged chunk's
    reads (``ragged``: its SequenceChunk and device chunk), each held to a
    fresh map_chunk pass over the same chunks, with the launch and frame
    counts zeroed before each run and read after it. The files, the index
    and each run's counts stay in ``workdir`` for phase 10."""
    import gzip

    from kmer_mapper_tpu_torch import cli, pipeline
    from kmer_mapper_tpu_torch.io import gzio, native
    from kmer_mapper_tpu_torch.models.mapper import KmerMapper, MapperConfig
    from kmer_mapper_tpu_torch.ops import block_partition, hashing, stream_probe
    from kmer_mapper_tpu_torch.pipeline import CUDA_BUF

    t_phase = time.perf_counter()
    index_path = os.path.join(workdir, "index.tpuidx.npz")
    index.to_file(index_path)
    paths = {name: os.path.join(workdir, name) for name in
             ("reads8.fq", "reads1.fq", "reads1.fq.gz", "reads1.bgzf.fq.gz",
              "ragged1.fq")}
    first_id = 0
    with open(paths["reads8.fq"], "wb") as f:
        for i, chunk in enumerate(chunks):
            payload = fastq_bytes(np, chunk, first_id)
            first_id += chunk.n_reads
            f.write(payload)
            if i == 0:
                first = payload
    with open(paths["reads1.fq"], "wb") as f:
        f.write(first)
    with open(paths["reads1.fq.gz"], "wb") as f:
        f.write(gzip.compress(first, compresslevel=1))
    write_bgzf(paths["reads1.bgzf.fq.gz"], first, level=1)
    del first
    ragged_chunk, ragged_dev = ragged
    with open(paths["ragged1.fq"], "wb") as f:
        f.write(ragged_fastq_bytes(np, ragged_chunk))
    sizes = {name: os.path.getsize(p) for name, p in paths.items()}
    log(f"file feed: {os.cpu_count()} host cores; wrote {sizes} bytes in "
        f"{time.perf_counter() - t_phase:.1f} s; "
        f"gzip decoders: .fq.gz {gzio.decoder_name(paths['reads1.fq.gz'])}, "
        f"BGZF {gzio.decoder_name(paths['reads1.bgzf.fq.gz'])}")

    config = MapperConfig(k=K, buf=CUDA_BUF, max_reads=max(1024, CUDA_BUF // 32),
                          read_len=READ_LEN)

    def reference(n_chunks):
        mapper = KmerMapper(index, config, device)
        for words, nb, _ in dev_chunks[:n_chunks]:
            mapper.map_chunk(words, None, nb, strided=True)
        return mapper.node_counts()

    ragged_mapper = KmerMapper(index, MapperConfig(k=K, buf=CUDA_BUF,
                                                   max_reads=config.max_reads), device)
    ragged_mapper.map_chunk(*ragged_dev)
    expect = {"one": reference(1), "all": reference(len(dev_chunks)),
              "ragged": ragged_mapper.node_counts()}
    profile_dir = os.path.join(workdir, "trace")
    # tag, what, file, expected counts, flags, numpy framer, the step's kernel
    runs = [
        ("a", "numpy framer, -t 1", "reads1.fq", "one", ["-t", "1"], True, "plane"),
        ("b", "native, -t 1", "reads8.fq", "all", ["-t", "1"], False, "plane"),
        ("c", "native, -t 8, --profile-dir", "reads8.fq", "all",
         ["-t", "8", "--profile-dir", profile_dir], False, "plane"),
        ("f", "native, -t 8, no profiler", "reads8.fq", "all", ["-t", "8"], False,
         "plane"),
        ("d", ".fq.gz, -t 8", "reads1.fq.gz", "one", ["-t", "8"], False, "plane"),
        ("e", "BGZF, -t 8", "reads1.bgzf.fq.gz", "one", ["-t", "8"], False, "plane"),
        ("g", "ragged FASTQ, -t 8", "ragged1.fq", "ragged", ["-t", "8"], False, "ragged"),
    ]
    out = {}
    catch = RunFigures()
    pipeline_log = logging.getLogger(pipeline.__name__)
    pipeline_log.addHandler(catch)
    pipeline_log.setLevel(logging.INFO)
    for tag, what, name, expect_key, flags, no_native, step in runs:
        catch.figures = None
        counts_path = os.path.join(workdir, f"counts_{tag}.npy")
        zero_launch_counts(stream_probe, hashing, block_partition)
        native.frame_counts["buffers"] = 0
        if no_native:
            os.environ["KMT_NO_NATIVE"] = "1"
        try:
            t = time.perf_counter()
            cli.main(["map", "-i", index_path, "-f", paths[name], "-k", str(K),
                      "-o", counts_path, "--device", str(device), *flags])
            wall = time.perf_counter() - t
        finally:
            os.environ.pop("KMT_NO_NATIVE", None)
        run = dict(catch.figures)
        launches = all_launches(stream_probe, hashing, block_partition)
        framed = native.frame_counts["buffers"]
        if not np.array_equal(np.load(counts_path), expect[expect_key]):
            raise AssertionError(f"file feed ({tag}) {what}: node counts differ from "
                                 "the map_chunk reference")
        other = "ragged" if step == "plane" else "plane"
        offsets = launches["ragged_offsets"]
        if (min(launches[name] for name in MAIN_PATH_KERNELS) < run["chunks"]
                or launches[f"{step}_hash_keys"] < run["chunks"]
                or launches[f"{other}_hash_keys"]
                or (offsets < run["chunks"] if step == "ragged" else offsets)
                or any(n for key, n in launches.items() if "reference" in key)):
            raise AssertionError(f"file feed ({tag}): the kernels did not run alone: "
                                 f"{launches} for {run['chunks']} chunks")
        if (framed > 0) == no_native:
            raise AssertionError(f"file feed ({tag}): the native loader framed {framed} "
                                 "buffers")
        decoder = gzio.decoder_name(paths[name]) if name.endswith(".gz") else "none"
        run.update(wall_s=wall, framed=framed, launches=launches["stream_count"],
                   hash_launches=launches[f"{step}_hash_keys"], offsets_launches=offsets,
                   decoder=decoder)
        out[tag] = run
        log(f"file feed ({tag}) {what}: {sizes[name]} bytes, {run['chunks']} chunks, "
            f"wall {wall:.3f} s ({run['bases'] / wall / 1e6:.1f} M bases/s, "
            f"{run['kmers'] / wall / 1e6:.1f} M k-mers/s); mapping loop "
            f"{run['map_s']:.3f} s ({run['bases'] / run['map_s'] / 1e6:.1f} M bases/s, "
            f"{run['kmers'] / run['map_s'] / 1e6:.1f} M k-mers/s), waited "
            f"{run['queue_wait_s']:.3f} s on the host feed; decoder {decoder}; native "
            f"buffers {framed}; stream_count {launches['stream_count']}, {step}_hash_keys "
            f"{launches[f'{step}_hash_keys']}; counts == reference")
    pipeline_log.removeHandler(catch)
    share, window_ms, traced = trace_busy_share(profile_dir)
    if traced < out["c"]["chunks"]:
        raise AssertionError(f"file feed (c): the trace holds {traced} stream_count "
                             f"launches for {out['c']['chunks']} chunks")
    out["c"].update(busy_share=share, window_ms=window_ms)
    log(f"file feed (c) trace: device busy {100 * share:.1f}% of a {window_ms:.1f} ms "
        f"mapping window; {traced} stream_count launches traced")
    log(f"file feed: phase took {time.perf_counter() - t_phase:.1f} s")
    return out

#: bytes of one index entry the finalize must read: its int32 slot and node
#: and its uint16 frequency (the index's own type)
ENTRY_BYTES = 10
SECTOR_BYTES = 32  # the gathers read the slot counts in 32-byte sectors
SHARDED_GRIDS = ((1, 1), (2, 1), (1, 2), (2, 2))
SUB_BLOCK_BUCKETS = 512  # the sub-block map_hashes table: 8 shards of 64 buckets
#: the finalize cases whose node sums pass 2**32 over many nodes, where the
#: host finalize's float64 sums meet numpy's vectorised uint32 cast
HOST_UNDEFINED = ("one_slot", "two_hot_nodes")


def finalize_bound(n_entries: int, n_sectors: int, n_nodes: int) -> tuple[float, str]:
    """The finalize's bound: each entry read once, each distinct sector of
    the slot counts that holds a weighted entry's count read once, 4 bytes
    a node zeroed and 4 read back."""
    return bound(ENTRY_BYTES * n_entries + SECTOR_BYTES * n_sectors + 8 * n_nodes, 0)


def shard_count_check(torch, mapper, words, n_bases: int) -> int:
    """Index shard 1's stream count on one strided chunk, as the sharded
    step runs it (the whole table's block partition, the shard's slice of
    the offsets and of the block bounds, its ``bucket_base``): the kernel
    == ``stream_count_reference`` on the same inputs, each from zero
    counts. Returns the shard's count of hit slots."""
    from kmer_mapper_tpu_torch.models.mapper import plane_chunk_keys
    from kmer_mapper_tpu_torch.ops import block_partition, stream_probe
    from kmer_mapper_tpu_torch.ops.u32hash import bucket_shift

    cell, config = mapper.cells[0][1], mapper.config
    n, bpb, base = mapper.n_buckets, mapper.bpb, mapper.nb_local
    keys, _ = plane_chunk_keys(words.to(cell.device), n_bases // config.read_len,
                               config=config, seed=mapper.index.table.seed)
    grouped, off = block_partition.block_partition(keys, n, bpb)
    first, n_blocks = base // bpb, mapper.nb_local // bpb
    window = (grouped, off[first : first + n_blocks + 1],
              cell.block_probe[first : first + n_blocks], bucket_shift(n), bpb, base)
    got = stream_probe.stream_count(cell.key_lo, cell.key_hi, torch.zeros_like(cell.counts),
                                    *window, n)
    twin = stream_probe.stream_count_reference(cell.key_lo, cell.key_hi,
                                               torch.zeros_like(cell.counts), *window)
    hit = int(twin.ne(0).sum())
    if not torch.equal(got, twin) or not hit:
        raise AssertionError(f"sharded: shard 1's stream_count (bucket_base {base}) != "
                             f"stream_count_reference, or no hits ({hit} slots)")
    return hit


def sharded_grid(torch, index, config, grid, devices):
    """A ShardedKmerMapper on the (data, index) grid ``grid`` over ``devices``
    (repeated where the grid has more cells)."""
    from kmer_mapper_tpu_torch.parallel import ShardedKmerMapper, make_mesh

    d, x = grid
    cells = [devices[i % len(devices)] for i in range(d * x)]
    return ShardedKmerMapper(index, config, make_mesh(index_parallel=x, devices=cells))


def map_sharded_chunks(mapper, dev_chunks) -> None:
    """Phase 5's device-resident strided chunks, D at a time."""
    for i in range(0, len(dev_chunks), mapper.n_data):
        mapper.map_chunks([(words, None, nb, 0, True)
                           for words, nb, _ in dev_chunks[i : i + mapper.n_data]])


def phase_sharded(torch, np, dev_chunks, ragged_chunks, index, library, feed_dir,
                  device) -> dict:
    """Multi-device mapping and the node-count finalize on the card: (a) the
    finalize kernel against its twin and the host on the hazard cases;
    (b) the finalize of phase 8's 2^26-hash call, timed beside its twin,
    the host and an int64 index_add_; (c) phase 5's chunks through
    ShardedKmerMapper on grids (1,1), (2,1), (1,2), (2,2) of one card ==
    KmerMapper; (d) sharded map_hashes on phase 8's 2^23-bucket table over
    4 index shards and on a 512-bucket table over 8 == KmerMapper, then
    the ragged step's device-resident buffers (``ragged_chunks``) on a
    (1,2) grid of the bench index and on the 512-bucket table's 8 sub-block
    shards under torch's sync check == KmerMapper; (e)
    map_file_sharded on phase 9's FASTQ over 4 cells == map_file's counts;
    (f) with two cards or more, (c) and (e) over distinct cards, the
    ragged buffers on grids (2,1) and (2,2) whose data rows lie on distinct
    cards, and the two-card tests of tests/test_torch_kernels.py. Each run's launch counts
    are zeroed before it and read after it."""
    from kmer_mapper_tpu_torch import pipeline
    from kmer_mapper_tpu_torch.index import kmer_index, layout
    from kmer_mapper_tpu_torch.models.mapper import KmerMapper, MapperConfig
    from kmer_mapper_tpu_torch.ops import (
        block_partition, finalize, finalize_cases, hashing, probe, stream_probe,
    )
    from kmer_mapper_tpu_torch.ops.u32hash import MASK32
    from kmer_mapper_tpu_torch.pipeline import CUDA_BUF

    t_phase = time.perf_counter()
    modules = (stream_probe, hashing, block_partition, probe, finalize)
    path_launches = dict.fromkeys(("stream_count", "gather_probe", "node_counts"), 0)

    def require(what: str, kernels) -> dict:
        """This run's launches: each of ``kernels`` at least once, no twin."""
        launches = all_launches(*modules)
        twins = {k: n for k, n in launches.items() if "reference" in k and n}
        if twins or any(launches[k] < 1 for k in kernels):
            raise AssertionError(f"sharded ({what}): {kernels} did not run alone: {launches}")
        for k in path_launches:
            path_launches[k] += launches[k]
        return launches

    # (a) the finalize kernel == twin == host on the hazard cases, the
    # entries in the case's order, shuffled and sorted by slot
    max_err = 0
    for name, base in finalize_cases.cases().items():
        for order in ("case", "shuffled", "slot"):
            case = base if order == "case" else base.ordered(order, seed=1)
            args = case.inputs(device)
            got = _u32(finalize.finalize(*args))
            twin = _u32(finalize.finalize_reference(*args))
            host = kmer_index.KmerIndex(
                table=None, entry_slot=case.slot, entry_node=case.node,
                entry_frequency=case.frequency, max_node_id=case.n_nodes - 1,
                n_unique=len(case.counts)).node_counts(case.counts, case.max_frequency)
            max_err = max(max_err, int(np.abs(got - twin).max(initial=0)))
            # the host sums in float64 and casts to uint32: past 2**32
            # numpy's vectorised cast gives 0, not the low word (the wrap
            # case's 3 nodes take the scalar cast, which keeps it), so the
            # host is not held to the wrapping sums of the cases with many
            # nodes
            host_defined = name not in HOST_UNDEFINED
            if (max_err or not np.array_equal(got, base.expected())
                    or host_defined and not np.array_equal(got, host.astype(np.int64))):
                raise AssertionError(f"sharded (a): finalize case {name} ({order} order): "
                                     "kernel, twin, numpy and host differ")
    log(f"sharded (a): node_counts kernel == twin == numpy on {len(finalize_cases.cases())} "
        "hazard cases (frequency bound, 10^5 entries on one node, 0xFFFFFFFF + 1 and a sum "
        "past 2^32, 10^3 nodes an entry, no entries, one slot on 10^4 nodes whose sums wrap, "
        "two hot nodes with 80% of the entries), "
        "each in its own entry order, shuffled and sorted by slot; == the host "
        f"KmerIndex.node_counts on all but {HOST_UNDEFINED} (float64 sums past 2^32 that "
        "numpy's vectorised cast turns to 0)")

    # (b) the finalize of the 2^26-hash library call, beside the host's
    counts, lib_index = library["counts"], library["index"]
    entries = lib_index.device_entries(counts.device)
    n_nodes = lib_index.max_node_id + 1
    got = finalize.finalize(counts, *entries, 1000, n_nodes)
    if not np.array_equal(_u32(got), library["node_counts"].astype(np.int64)):
        raise AssertionError("sharded (b): the finalize kernel != the 2^26 call's node counts")
    twin = finalize.finalize_reference(counts, *entries, 1000, n_nodes)
    err = int(np.abs(_u32(got) - _u32(twin)).max(initial=0))
    if err:
        raise AssertionError(f"sharded (b): the finalize kernel != its twin on the 2^26 "
                             f"call's counts (max |difference| {err})")
    ms = median_ms(lambda: finalize.finalize(counts, *entries, 1000, n_nodes))
    plain_ms = median_ms(lambda: finalize.finalize_reference(counts, *entries, 1000, n_nodes),
                         reps=3)
    slot, node, freq = entries
    weights = torch.where(freq <= 1000, counts[slot.long()].long() & MASK32, 0)
    node64, slot64 = node.long(), slot.long()
    library_ms = median_ms(lambda: torch.zeros(n_nodes, dtype=torch.int64,
                                               device=device).index_add_(0, node64, weights))
    # the whole function in torch: the gather, the frequency filter and the
    # index_add_, on the same entries
    composed_ms = median_ms(lambda: torch.zeros(n_nodes, dtype=torch.int64, device=device)
                            .index_add_(0, node64, torch.where(
                                freq <= 1000, counts[slot64].long() & MASK32, 0)))
    weighted = weights.ne(0)
    n_nonzero = int(weighted.sum())
    n_sectors = int(torch.unique(slot[weighted] // (SECTOR_BYTES // 4)).numel())
    bound_ms, bound_by = finalize_bound(slot.numel(), n_sectors, n_nodes)
    t = time.perf_counter()  # the CPU path's finalize on this call's counts
    host = lib_index.node_counts(counts.cpu().numpy().view(np.uint32))
    host_s = time.perf_counter() - t
    if not np.array_equal(host, library["node_counts"]):
        raise AssertionError("sharded (b): the host finalize != the kernel's")
    log(f"sharded (b): the 2^26-hash library call: {library['call_s']:.4f} s host clock, "
        f"upload {library['upload_s']:.4f} s, kernel {library['kernel_s']:.4f} s, node counts "
        f"{library['finalize_s']:.4f} s (the finalize kernel and a read-back of {n_nodes} "
        f"words; the host finalize, read-back of every slot and bincount, took "
        f"{host_s:.4f} s on these counts, 0.1034 s in PERF.md's run); node_counts kernel "
        f"{ms:.4f} ms on {slot.numel()} entries ({n_nonzero} with a weight, gathering "
        f"{n_sectors} distinct sectors of {counts.numel()} slot counts; entries sorted by "
        f"slot), twin "
        f"{plain_ms:.3f} ms, int64 index_add_ of the gathered weights {library_ms:.4f} ms, "
        f"the gather, where and index_add_ in torch {composed_ms:.4f} ms, "
        f"bound {bound_ms:.4f} ms by {bound_by} ({100 * bound_ms / ms:.0f}% of it)")
    del weights, weighted, node64, slot64, twin
    finalize_entry = {
        "name": "node_counts", "route": "cuda",
        "source": "kmer_mapper_tpu_torch/csrc/node_counts.cu",
        "replaces": "kmer_mapper_tpu/parallel/sharded.py:403 (make_finalize's finalize, XLA)",
        "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": library_ms, "composed_ms": composed_ms,
    }

    # (c) the main path sharded at full width, on grids of this card
    config = MapperConfig(k=K, buf=CUDA_BUF, max_reads=max(1024, CUDA_BUF // 32),
                          read_len=READ_LEN)
    single = KmerMapper(index, config, device)
    for words, nb, _ in dev_chunks:
        single.map_chunk(words, None, nb, strided=True)
    expect = single.node_counts()
    del single
    kmers_per_window = len(dev_chunks) * dev_chunks[0][2] * (READ_LEN - K + 1)
    rates = {}

    def run_grids(devices, grids, tag):
        for grid in grids:
            mapper = sharded_grid(torch, index, config, grid, devices)
            zero_launch_counts(*modules)
            map_sharded_chunks(mapper, dev_chunks)
            got = mapper.node_counts()
            launches = require(f"{tag} grid {grid}", ("stream_count", "node_counts"))
            if launches["stream_count"] != len(dev_chunks) * grid[1]:
                raise AssertionError(f"sharded ({tag}): grid {grid} launched stream_count "
                                     f"{launches['stream_count']} times")
            if not np.array_equal(got, expect):
                raise AssertionError(f"sharded ({tag}): grid {grid} != KmerMapper")
            if grid == (1, 2):
                hit = shard_count_check(torch, mapper, *dev_chunks[0][:2])
                log(f"sharded ({tag}): grid {grid}: shard 1's stream_count (bucket_base "
                    f"{mapper.nb_local}) on chunk 0 == stream_count_reference ({hit} slots hit)")
            window = timed_rates(torch, lambda: map_sharded_chunks(mapper, dev_chunks),
                                 kmers_per_window)
            rates[tag, grid] = window
            log(f"sharded ({tag}): grid {grid} on {sorted({str(c.device) for r in mapper.cells for c in r})}: "
                f"node counts == KmerMapper's ({int(got.sum())} node hits); "
                f"{[f'{r / 1e6:.1f}' for r in window]} Mk/s over {len(dev_chunks)} chunks "
                f"({grid[0] * grid[1]} cells: each chunk hashed and partitioned {grid[1]} "
                f"times, once a cell of its row); launches {launches}")
            del mapper
            torch.cuda.empty_cache()

    run_grids([device], SHARDED_GRIDS, "c")

    # (d) sharded map_hashes == KmerMapper.map_hashes
    rng = np.random.default_rng(13)
    keys, large = library["large"]
    large_index = kmer_index.KmerIndex(
        table=large, entry_slot=large.build_slots.astype(np.int32),
        entry_node=rng.integers(0, 1 << 20, len(keys)).astype(np.int32),
        entry_frequency=np.ones(len(keys), np.uint16), max_node_id=(1 << 20) - 1,
        n_unique=len(keys))
    small_keys = np.unique(rng.integers(0, 1 << 62, 3000, dtype=np.uint64))
    small_table = layout.build_table(small_keys, n_buckets=SUB_BLOCK_BUCKETS)
    small = kmer_index.KmerIndex(
        table=small_table, entry_slot=small_table.build_slots.astype(np.int32),
        entry_node=np.arange(len(small_keys), dtype=np.int32),
        entry_frequency=np.ones(len(small_keys), np.uint16),
        max_node_id=len(small_keys) - 1, n_unique=len(small_keys))
    for what, idx, pool, n, grid in (
            ("2^23-bucket table, 4 index shards", large_index, keys, LIB_HASHES, (1, 4)),
            ("512-bucket table, 8 sub-block index shards", small, small_keys, 1 << 20, (1, 8))):
        q = np.concatenate([rng.choice(pool, n // 2),
                            rng.integers(0, 1 << 62, n - n // 2, dtype=np.uint64)])
        ref = KmerMapper(idx, config, device)
        ref.map_hashes(q)
        want = ref.node_counts()
        del ref
        mapper = sharded_grid(torch, idx, config, grid, [device])
        zero_launch_counts(*modules)
        t = time.perf_counter()
        mapper.map_hashes(q)
        got = mapper.node_counts()
        seconds = time.perf_counter() - t
        launches = require(f"d, {what}", ("gather_probe", "node_counts"))
        if not np.array_equal(got, want) or mapper.n_kmers_mapped != n:
            raise AssertionError(f"sharded (d): map_hashes on the {what} != KmerMapper")
        log(f"sharded (d): map_hashes of {n} hashes on the {what} (grid {grid}, "
            f"{mapper.nb_local} buckets a shard) == KmerMapper's ({int(got.sum())} node hits) in {seconds:.3f} s; "
            f"launches {launches}")
        del mapper
    # the ragged step on sharded grids: its device count feeds the
    # partition (stream route) and masks the key buffer's tail (gather
    # route, sub-block shards), with no host sync
    ragged_config = MapperConfig(k=K, buf=CUDA_BUF, max_reads=config.max_reads)
    ragged_want: dict = {}  # KmerMapper's node counts and windows a table, for (f)
    for what, idx, grid, chunks in (
            ("bench index", index, (1, 2), ragged_chunks),
            ("512-bucket table, 8 sub-block index shards", small, (1, 8), ragged_chunks[:2])):
        ref = KmerMapper(idx, ragged_config, device)
        for chunk in chunks:
            ref.map_chunk(*chunk)
        want, want_kmers = ref.node_counts(), ref.n_kmers_mapped
        ragged_want.setdefault(what, (want, want_kmers))
        del ref
        mapper = sharded_grid(torch, idx, ragged_config, grid, [device])
        zero_launch_counts(*modules)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            for words, lengths, nb in chunks:
                mapper.map_chunks([(words, lengths, nb, 0, False)])
        finally:
            torch.cuda.set_sync_debug_mode(0)
        got = mapper.node_counts()
        launches = require(f"d, ragged, {what}", ("ragged_offsets", "ragged_hash_keys",
                                                  "node_counts"))
        if not np.array_equal(got, want) or mapper.n_kmers_mapped != want_kmers:
            raise AssertionError(f"sharded (d): ragged chunks on the {what} != KmerMapper")
        log(f"sharded (d): {len(chunks)} ragged buffers on the {what} (grid {grid}) under "
            f"torch.cuda.set_sync_debug_mode('error'): no host sync; node counts and "
            f"n_kmers_mapped ({want_kmers}) == KmerMapper's; launches {launches}")
        del mapper
    del large_index, library["large"]
    torch.cuda.empty_cache()

    # (e) the sharded file path == map_file's counts
    index_path = os.path.join(feed_dir, "index.tpuidx.npz")
    reads = os.path.join(feed_dir, "reads8.fq")
    want = np.load(os.path.join(feed_dir, "counts_b.npy"))

    def run_file(devices, tag):
        zero_launch_counts(*modules)
        t = time.perf_counter()
        got = pipeline.map_file_sharded(index_path, reads, k=K, devices=devices,
                                        index_parallel=2)
        wall = time.perf_counter() - t
        launches = require(f"{tag}, map_file_sharded", ("stream_count", "node_counts",
                                                         "plane_hash_keys"))
        if not np.array_equal(got, want):
            raise AssertionError(f"sharded ({tag}): map_file_sharded != map_file")
        log(f"sharded ({tag}): map_file_sharded(devices={[str(d) for d in devices]}, "
            f"index_parallel=2) on the {os.path.getsize(reads)}-byte FASTQ == map_file's "
            f".npy, wall {wall:.3f} s; launches {launches}")

    run_file([device] * 4, "e")

    # (f) distinct cards
    n_cards = torch.cuda.device_count()
    if n_cards >= 2:
        cards = [torch.device("cuda", i) for i in range(n_cards)]
        run_grids(cards, SHARDED_GRIDS[1:], "f")
        run_file([cards[i % n_cards] for i in range(4)], "f")
        # the ragged buffers fanned out over data rows on distinct cards:
        # each row's device count stays on its card until the read-back
        want, want_kmers = ragged_want["bench index"]
        for grid in ((2, 1), (2, 2)):
            mapper = sharded_grid(torch, index, ragged_config, grid,
                                  [cards[i // grid[1] % n_cards] for i in range(4)])
            zero_launch_counts(*modules)
            for i in range(0, len(ragged_chunks), 2):
                mapper.map_chunks([(words, lengths, nb, 0, False)
                                   for words, lengths, nb in ragged_chunks[i : i + 2]])
            row_devices = {cells[0].device for cells in mapper.cells}
            if len(row_devices) != 2:
                raise AssertionError(f"sharded (f): grid {grid}'s data rows share a card")
            got = mapper.node_counts()
            launches = require(f"f, ragged, grid {grid}", ("ragged_offsets", "ragged_hash_keys",
                                                            "node_counts"))
            if not np.array_equal(got, want) or mapper.n_kmers_mapped != want_kmers:
                raise AssertionError(f"sharded (f): ragged chunks on grid {grid} over "
                                     f"{sorted(map(str, row_devices))} != KmerMapper")
            log(f"sharded (f): {len(ragged_chunks)} ragged buffers on grid {grid}, data rows "
                f"on {sorted(map(str, row_devices))}: node counts and n_kmers_mapped "
                f"({want_kmers}) == KmerMapper's; launches {launches}")
            del mapper
        tests = ("test_pinned_ring_event_waits_on_the_mappers_device or "
                 "test_map_file_on_a_device_that_is_not_current or "
                 "test_sharded_ragged_chunks_over_two_cards")
        proc = subprocess.run([sys.executable, "-m", "pytest", "--noconftest", "-p",
                               "no:cacheprovider", "-q", "-rA", "tests/test_torch_kernels.py",
                               "-k", tests], capture_output=True, text=True)
        log("sharded (f): the two-card tests of tests/test_torch_kernels.py:\n"
            + proc.stdout[-3000:])
        if proc.returncode or " passed" not in proc.stdout or "skipped" in proc.stdout:
            raise AssertionError("sharded (f): the two-card tests did not pass")
    else:
        log(f"sharded (f): {n_cards} card(s): the grids over distinct cards and the two-card "
            "tests did not run")
    log(f"sharded: phase took {time.perf_counter() - t_phase:.1f} s")
    finalize_entry.update(launches=path_launches["node_counts"], max_abs_err=max_err)
    return {"launches": path_launches, "node_counts": finalize_entry, "rates": rates}



def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this check needs a GPU",
              file=sys.stderr)
        return 1
    device = torch.device("cuda")
    card, smi = phase_environment(torch)
    phase_build()
    log("tolerance: every comparison is exact integer equality (max_abs_err 0)")
    max_err = phase_hazards(torch, device)
    hash_err = phase_hash_hazards(torch, np, device)
    partition_err = phase_partition_hazards(torch, np, device)
    rng = np.random.default_rng(0)
    from kmer_mapper_tpu_torch.io.readers import strided_rows
    from kmer_mapper_tpu_torch.pipeline import CUDA_BUF

    chunks = make_chunks(np, rng, N_CHUNKS, strided_rows(CUDA_BUF, READ_LEN))
    workdir = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        e2e = phase_end_to_end(torch, np, chunks[0], rng, workdir)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    steady = phase_steady_state(torch, np, chunks, e2e["index"], e2e["arrays"], device)
    log(f"summary on {smi}: kernel path median "
        f"{sorted(steady['kernel_rates'])[N_WINDOWS // 2] / 1e6:.1f} Mk/s, twin path median "
        f"{sorted(steady['twin_rates'])[N_WINDOWS // 2] / 1e6:.1f} Mk/s, peak device memory "
        f"{steady['peak_gib']:.2f} GiB")
    ragged_reads = ragged_chunks(np, rng, chunks)
    ragged = phase_ragged_steady_state(torch, np, ragged_reads, e2e["index"], e2e["arrays"],
                                       device)
    dissect = phase_dissect(torch, np, device)
    tiles = phase_tiles(torch, np, device)
    library_run, library = phase_library(torch, np, e2e["arrays"], rng, device)
    feed_dir = tempfile.mkdtemp(prefix="chip_smoke_feed_")
    try:
        feed = phase_file_feed(torch, np, chunks, steady["dev_chunks"],
                               (ragged_reads[0], ragged["dev_chunks"][0]), e2e["index"],
                               device, feed_dir)
        sharded = phase_sharded(torch, np, steady["dev_chunks"], ragged["dev_chunks"],
                                e2e["index"], library_run, feed_dir, device)
    finally:
        shutil.rmtree(feed_dir, ignore_errors=True)
    # the sharded paths' launches beside the single-device main path's
    library["launches"] += sharded["launches"]["gather_probe"]
    hash_keys = [
        dict(name="plane_hash_keys", replaces="kmer_mapper_tpu/ops/hashing.py:82 (XLA)",
             launches=e2e["hash_launches"], **steady["hash"]),
        dict(name="ragged_hash_keys", replaces="kmer_mapper_tpu/ops/hashing.py:41 (XLA)",
             launches=feed["g"]["hash_launches"], **ragged["hash"]),
        dict(name="ragged_offsets",
             replaces="kmer_mapper_tpu/models/mapper.py:140-142 (chunk_step's cumsum and "
                      "n_valid, XLA)",
             launches=feed["g"]["offsets_launches"], **ragged["offsets"]),
    ]
    for entry in hash_keys:
        entry.update(route="cuda", source="kmer_mapper_tpu_torch/csrc/hash_keys.cu",
                     max_abs_err=max(entry["max_abs_err"], hash_err[entry["name"]]),
                     library_ms=None)  # no single PyTorch call hashes, mixes and keys,
    # nor writes both scans and the count
    source = "kmer_mapper_tpu_torch/csrc/block_partition.cu"
    launches = e2e["launches"]
    sharded["node_counts"]["launches"] += launches["node_counts"]
    partition = [{
        # the whole stage: its launches are its kernels' in the main path's run
        "name": "block_partition", "route": "cuda", "source": source,
        "replaces": "kmer_mapper_tpu/ops/stream_probe.py:1170 (lax.sort) and :407 "
                    "(block_offsets), XLA",
        "launches": sum(launches[name] for name in PARTITION_KERNELS),
        **steady["partition"]["stage"],
        "max_abs_err": max(partition_err, steady["partition"]["stage"]["max_abs_err"],
                           steady["large"]["max_abs_err"],
                           ragged["partition"]["stage"]["max_abs_err"]),
    }]
    for kernel in PARTITION_KERNELS:
        entry = steady["partition"]["kernels"][kernel]
        partition.append({
            "name": kernel, "route": "cuda", "source": source,
            "replaces": "kmer_mapper_tpu/ops/stream_probe.py:407 (block_offsets), XLA"
                        if kernel == "radix_offsets" else
                        "kmer_mapper_tpu/ops/stream_probe.py:1170 (lax.sort), XLA",
            "launches": launches[kernel],
            **{key: entry[key] for key in ("ms", "plain_ms", "bound_ms", "bound_by",
                                           "library_ms")},
            "max_abs_err": max(entry["max_abs_err"],
                               ragged["partition"]["kernels"][kernel]["max_abs_err"]),
        })
    kernels = [{
        "name": "stream_count",
        "route": "cuda",
        "source": "kmer_mapper_tpu_torch/csrc/stream_count.cu",
        "replaces": "kmer_mapper_tpu/ops/stream_probe.py:551",
        "launches": launches["stream_count"] + sharded["launches"]["stream_count"],
        "max_abs_err": max(max_err, steady["count"]["max_abs_err"],
                           ragged["count"]["max_abs_err"]),
        **{key: steady["count"][key] for key in ("ms", "plain_ms", "bound_ms", "bound_by")},
        "library_ms": None,  # no single PyTorch call counts slot hits
    }, *partition, *hash_keys, *dissect, *tiles, library, sharded["node_counts"]]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": card, "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
