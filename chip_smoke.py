#!/usr/bin/env python3
"""Smoke test of kmer_mapper_tpu_torch on one NVIDIA GPU.

Run from the repository root:  python3 chip_smoke.py

Phases (a failing phase raises, the script exits non-zero and prints no
result line):
  1. environment: torch, CUDA, the card's name and power limit, nvcc;
  2. build the CUDA kernels from kmer_mapper_tpu_torch/csrc with nvcc;
  3. the stream-count kernel against its plain-torch twin and the host
     oracle on every hazard case of its contract (exact equality);
  4. the main path as a user runs it: ``kmer_mapper_tpu_torch.cli map`` on
     a FASTQ of 10^5 151-bp reads against the bench index (~2.6M unique
     31-mers in 2^20 buckets); node counts must equal the numpy oracle's
     modulo-index probe, and the kernel must have run;
  5. steady state on 8 distinct device-resident 64 Mi-base chunks of 151-bp
     reads: k-mers per second through KmerMapper.map_chunk and through the
     same stages with the plain twin, per-stage milliseconds, equal counts;
  6. dissect: the three dissection scripts of kmer_mapper_tpu_torch.scripts
     run as a user runs them, at their full sizes (their kernels must have
     launched); then every variant of each kernel against its twin, bit for
     bit, r2_kernel_dissect's full against stream_count, and the
     tile-scheduled r2_window_dissect against both on a poly-A window; on
     a ragged chunk, the main path's offsets (which end at the invalid tail)
     leave the last chain block's window without invalid queries;
  7. tiles: the three r9 tile-body scripts of kmer_mapper_tpu_torch.scripts
     (r9_dot_orient, r9_step_parts, r9_block_pipeline) run as a user runs
     them, at their full sizes (their kernels must have launched); then
     every variant against its twin, bit for bit, with hits;
  8. library: the pre-hashed calls on the bench index, as KAGE calls them:
     compat.map_kmers_to_graph_index on 2^24 hashes (stream route),
     in_graph_index on 2^24 (gather kernel), map_hashes on 2^16 (gather
     route) and GpuCounter with reverse complements on 2^22, each equal to
     the numpy oracle, with the launch counts zeroed before and read after
     (no twin may run); a second call on 2^26 hashes that must reuse the
     cached mapper, timed; the gather kernel against its twins on every
     hazard case; the device ms of both routes at 2^12 ... 2^24 hashes;
  9. file feed: the reads of phase 5's 8 chunks written as one FASTQ (~1.1
     GB), the first chunk's as FASTQ, .fq.gz (zlib level 1) and BGZF, each
     mapped through ``kmer_mapper_tpu_torch.cli map``: (a) the numpy framer
     on the one-chunk file, (b) the native loader with -t 1 and (c) with
     -t 8 and --profile-dir on the 8-chunk file, (f) as (c) without the
     profiler, (d) the .fq.gz and (e) the BGZF file; every node-count
     vector must equal a fresh map_chunk pass
     over the same chunks, stream_count must have launched and its twin not,
     and the native loader must have framed (b)-(f). Prints each run's wall
     seconds, bases and k-mers per second, the seconds the mapping loop
     waited on the host feed and the gzip decoder; from (c)'s trace, the
     device's busy share of the mapping window.
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
LIB_HASHES = 1 << 24  # hashes of the library calls held to the oracle, phase 8
LIB_TIMED = 1 << 26  # hashes of the timed map_kmers_to_graph_index call
LIB_GATHER = 1 << 16  # a map_hashes batch on the gather route
LIB_COUNTER = 1 << 22  # hashes counted by GpuCounter (and their revcomps)
CROSSOVER = [1 << e for e in range(12, 25, 2)]  # batch sizes timed on both routes


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
def int32_ops_per_s() -> float:
    """The card's INT32 instruction rate: SMs x INT32 lanes x largest SM clock."""
    import torch

    mhz = float(_cmd_output(["nvidia-smi", "--query-gpu=clocks.max.sm",
                             "--format=csv,noheader,nounits"]).splitlines()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return sms * INT32_LANES_PER_SM * mhz * 1e6


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
    """Kernel vs twin vs oracle on every hazard case; returns the max
    absolute difference between kernel and twin (must be 0)."""
    import numpy as np

    from kmer_mapper_tpu_torch.ops import stream_count_cases, stream_probe

    max_err = 0
    for case in stream_count_cases.cases(poly_a=POLY_A):
        got = _u32(stream_probe.stream_count(*case.inputs(device)))
        twin = _u32(stream_probe.stream_count_reference(*case.inputs(device)))
        err = int(np.abs(got - twin).max(initial=0))
        max_err = max(max_err, err)
        if err or not np.array_equal(got, case.expected().astype(np.int64)):
            raise AssertionError(f"hazard {case.name}: kernel, twin and oracle disagree")
        log(f"hazard {case.name}: {case.table.n_buckets} buckets, "
            f"{len(case.queries)} queries, kernel == twin == oracle")
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
    max_err = max(max_err, int(np.abs(results[0][1] - results[1][1]).max()))
    log(f"hazard slots_past_2_31: {args[0].shape[0]} buckets "
        f"({counts.numel()} slots, hits up to slot {slots.max()}), "
        "kernel == twin == expected")
    del args, counts
    torch.cuda.empty_cache()
    return max_err


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
    from kmer_mapper_tpu_torch.ops import stream_probe
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
    for name in stream_probe.launch_counts:
        stream_probe.launch_counts[name] = 0
    t = time.perf_counter()
    cli.main(["map", "-i", index_path, "-f", fq, "-k", str(K), "-o", out])
    seconds = time.perf_counter() - t
    launches = dict(stream_probe.launch_counts)
    got = np.load(out)

    n_chunks = -(-E2E_READS // readers.strided_rows(CUDA_BUF, READ_LEN))
    if launches["stream_count"] < n_chunks or launches["stream_count_reference"]:
        raise AssertionError(f"main path did not run the kernel: {launches}")
    expect = oracle.map_kmers_to_index(arrays, fixed_read_kmers(np, reads.reshape(-1)))
    if not np.array_equal(got, expect):
        raise AssertionError("e2e: CLI node counts differ from the numpy oracle")
    log(f"e2e: cli map on {torch.cuda.get_device_name(0)} in {seconds:.2f} s "
        f"(index build included); {int(got.sum())} node hits == oracle; "
        f"launches {launches}")
    return {"launches": launches["stream_count"], "arrays": arrays,
            "index": kmer_index.KmerIndex.from_arrays(arrays)}


def phase_steady_state(torch, np, chunks, index, device) -> dict:
    from kmer_mapper_tpu_torch.io import readers
    from kmer_mapper_tpu_torch.models.mapper import KmerMapper, MapperConfig
    from kmer_mapper_tpu_torch.ops import hashing, stream_probe
    from kmer_mapper_tpu_torch.ops.u32hash import bucket_shift, from_int32_bits
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

    mapper = KmerMapper(index, config, device)
    n_buckets = index.table.n_buckets
    shift, bpb = bucket_shift(n_buckets), min(128, n_buckets)

    def run_mapper():
        for words, nb, _ in dev_chunks:
            mapper.map_chunk(words, None, nb, strided=True)

    def sorted_queries(words, n_reads):
        """The plain stages before the count: hash + mix, sort, offsets."""
        m_lo, m_hi = hashing.plane_hash_mixed(
            from_int32_bits(words), K, READ_LEN, n_reads, index.table.seed
        )
        keys = stream_probe.sort_mixed(m_lo, m_hi)
        return keys, stream_probe.count_offsets(keys, n_buckets, bpb)

    twin_counts = torch.zeros_like(mapper.counts)

    def run_twin():
        for words, _, nr in dev_chunks:
            keys, off = sorted_queries(words, nr)
            stream_probe.stream_count_reference(
                mapper.key_lo, mapper.key_hi, twin_counts, keys, off,
                mapper.block_probe, shift, bpb,
            )

    def rate(fn):
        fn()  # warm-up window
        torch.cuda.synchronize()
        rates = []
        for _ in range(N_WINDOWS):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            rates.append(kmers_per_chunk * len(dev_chunks) / (time.perf_counter() - t0))
        return rates

    kernel_rates = rate(run_mapper)
    twin_rates = rate(run_twin)
    # both ran 1 + N_WINDOWS windows over the same chunks from zero counts
    if not torch.equal(mapper.counts, twin_counts):
        raise AssertionError("steady: kernel path and twin path counts differ")
    if not int(mapper.counts.ne(0).sum()):
        raise AssertionError("steady: no table hits at all")
    log(f"steady: kernel path {[f'{r / 1e6:.1f}' for r in kernel_rates]} Mk/s, "
        f"twin path {[f'{r / 1e6:.1f}' for r in twin_rates]} Mk/s "
        f"({len(dev_chunks)} chunks x {kmers_per_chunk} k-mers per window); counts equal")

    # per-stage device time over one window, CUDA events around each stage
    names = ("hash_mix", "sort", "offsets", "kernel", "twin_count")
    stage_ms = {n: 0.0 for n in names}
    scratch = torch.zeros_like(mapper.counts)
    for words, _, nr in dev_chunks:
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(len(names) + 1)]
        ev[0].record()
        m_lo, m_hi = hashing.plane_hash_mixed(
            from_int32_bits(words), K, READ_LEN, nr, index.table.seed
        )
        ev[1].record()
        keys = stream_probe.sort_mixed(m_lo, m_hi)
        ev[2].record()
        off = stream_probe.count_offsets(keys, n_buckets, bpb)
        ev[3].record()
        count_args = (mapper.key_lo, mapper.key_hi, scratch, keys, off,
                      mapper.block_probe, shift, bpb)
        stream_probe.stream_count(*count_args)
        ev[4].record()
        stream_probe.stream_count_reference(*count_args)
        ev[5].record()
        torch.cuda.synchronize()
        for i, n in enumerate(names):
            stage_ms[n] += ev[i].elapsed_time(ev[i + 1]) / len(dev_chunks)
    log("steady: per-chunk stage ms " + ", ".join(f"{n} {v:.3f}" for n, v in stage_ms.items()))

    # kernel vs twin alone on one chunk's sorted keys: the result from
    # fresh counts, then the median device time of 5 calls (median_ms)
    keys, off = sorted_queries(dev_chunks[0][0], dev_chunks[0][2])
    outs, ms = [], []
    for fn in (stream_probe.stream_count, stream_probe.stream_count_reference):
        c = torch.zeros_like(mapper.counts)
        args = (mapper.key_lo, mapper.key_hi, c, keys, off, mapper.block_probe, shift, bpb)
        outs.append(fn(*args).clone())
        ms.append(median_ms(lambda: fn(*args)))
    max_err = int((outs[0].to(torch.int64) - outs[1].to(torch.int64)).abs().max())
    if max_err:
        raise AssertionError("steady: kernel and twin disagree on one chunk")
    bound_ms, bound_by = count_bound(
        (mapper.key_lo, mapper.key_hi, outs[0], keys, off, mapper.block_probe, shift, bpb),
        index.table.max_probe, int(outs[0].ne(0).sum()))
    log(f"steady: stream_count on {keys.numel()} queries: kernel {ms[0]:.3f} ms, "
        f"twin {ms[1]:.3f} ms (median of 5); bound {bound_ms:.4f} ms by {bound_by}")
    return {
        "kernel_rates": kernel_rates, "twin_rates": twin_rates, "stage_ms": stage_ms,
        "ms": ms[0], "plain_ms": ms[1], "max_abs_err": max_err,
        "bound_ms": bound_ms, "bound_by": bound_by, "dev_chunks": dev_chunks,
    }


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
    twins = {name: m.launch_counts[f"{name}_reference"] for name, m in modules.items()}
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
    per_block_ms = median_ms(lambda: stream_probe.stream_count(*per_block_args))
    # the main path's offsets end at the invalid tail: the last chain
    # block's window must hold no invalid query, and the count is the same
    main_off = stream_probe.count_offsets(keys, ctx.n_buckets, args[7])
    last = keys[int(main_off[-2]):int(main_off[-1])]
    if bool((last == stream_probe.INVALID_KEY).any()):
        raise AssertionError("dissect: the last window of count_offsets holds invalid queries")
    main_args = ctx.count_args(torch.zeros_like(args[2]), keys, main_off)
    if not torch.equal(full_b, stream_probe.stream_count(*main_args)):
        raise AssertionError("dissect: stream_count on count_offsets != r2_window_dissect full")
    main_ms = median_ms(lambda: stream_probe.stream_count(*main_args))
    table("B", times)
    lengths = off[1:] - off[:-1]
    n_invalid = int((keys == stream_probe.INVALID_KEY).sum())
    bound_ms_b, bound_by_b = count_bound(args, max_probe, int(full_b.ne(0).sum()))
    log(f"dissect B: {len(B.VARIANTS)} variants == twins on one {ctx.buf}-base chunk "
        f"({keys.numel()} queries, {n_invalid} of them invalid; longest window "
        f"{int(lengths.max())} queries in block {int(lengths.argmax())} of {lengths.numel()}); "
        f"full == r2_kernel_dissect == stream_count; per-block stream_count alone "
        f"{per_block_ms:.4f} ms on block_offsets; bound {bound_ms_b:.4f} ms by {bound_by_b}")
    log(f"dissect B: tail repair: per-block stream_count {per_block_ms:.4f} ms on "
        f"block_offsets (last window {int(lengths[-1])} queries) -> {main_ms:.4f} ms on "
        f"count_offsets (last window {last.numel()} queries, none invalid); counts equal")
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
        raise AssertionError("dissect: tile-scheduled count differs on the poly-A window")
    log(f"dissect B: poly-A window of {window} queries over {-(-window // B.CAP)} tiles: "
        "tile-scheduled == per-block == stream_count == twin == oracle")
    out.append(dict(name="r2_window_dissect", source="kmer_mapper_tpu_torch/csrc/r2_window_dissect.cu",
                    replaces="scripts/r2_window_dissect.py:45", ms=times["full"][0],
                    plain_ms=times["full"][1], bound_ms=bound_ms_b, bound_by=bound_by_b))

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
    variant against its twin on the main's inputs (launches not counted)."""
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
    out = []
    for name, m in modules.items():
        kernel, twin, main_variant = calls[name]
        res, max_err, twin_ms = results[name], 0, {}
        for variant, inputs in res["inputs"].items():
            got, ref = _u32(kernel(*inputs, variant)), _u32(twin(inputs, variant))
            max_err = max(max_err, int(np.abs(got - ref).max()))
            if not np.array_equal(got, ref):
                raise AssertionError(f"tiles: {name} {variant}: kernel != twin")
            # hits: the count tile's sum, or the count slots that changed
            hits = int(got.sum()) if m is D else int((got != _u32(inputs[2])).sum())
            if not hits:
                raise AssertionError(f"tiles: {name} {variant}: no hits")
            twin_ms[variant] = median_ms(lambda: twin(inputs, variant), reps=3)
            log(f"tiles {name}: {variant:9s} kernel {res['ms'][variant]:9.4f} ms  twin "
                f"{twin_ms[variant]:9.3f} ms  == twin, {hits} "
                f"{'hits' if m is D else 'count slots changed'}")
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


def gather_bound(index, q_lo, q_hi, slots) -> tuple[float, float, str, float]:
    """(mean rounds, bound ms, "bytes" or "operations", row-traffic ms) of
    the gather probe's slots mode on these queries. Rounds per query: up to
    the hit, the table's max_probe for a miss, none for the sentinel. Bytes:
    the 8 bytes of each query's words read once, each bucket the run touches
    read once (32 bytes of lo and 32 of hi words) and 4 bytes of slot
    written per query; operations: 30 for the Feistel mix of each query (3
    rounds of fmix32 and two xors) and 9 per round taken (8 lane compares
    and the bucket). The row-traffic time is the same bytes with every
    round's 64-byte row read again, as a gather that caches nothing would."""
    import torch

    from kmer_mapper_tpu_torch.ops import probe
    from kmer_mapper_tpu_torch.ops.u32hash import (
        MASK32, bucket_from_mlo_torch, feistel_mix_torch, from_int32_bits,
    )

    table = index.table
    n, n_buckets, bpb = q_lo.numel(), table.n_buckets, min(128, table.n_buckets)
    m_lo, m_hi = feistel_mix_torch(from_int32_bits(q_lo), from_int32_bits(q_hi), table.seed)
    b0 = bucket_from_mlo_torch(m_lo, n_buckets)
    slots = slots.long()
    rounds = torch.where(slots >= 0, ((slots // 8 - b0) & (bpb - 1)) + 1, table.max_probe)
    rounds = torch.where((m_lo == MASK32) & (m_hi == MASK32), 0, rounds)
    touched = torch.zeros(n_buckets, dtype=torch.bool, device=q_lo.device)
    for p in range(table.max_probe):
        sel = rounds > p
        touched[probe.chain_next(b0[sel], p, n_buckets)] = True
    n_rounds = int(rounds.sum())
    ms, by = bound(12 * n + 64 * int(touched.sum()), 30 * n + 9 * n_rounds)
    row_ms = (12 * n + 64 * n_rounds) / HBM_BYTES_PER_S * 1e3
    return n_rounds / max(n, 1), ms, by, row_ms


def library_hashes(np, rng, arrays, n: int, shuffle: bool = True):
    """n uint64 hashes: half drawn from the index's kmers, half uniform."""
    q = np.concatenate([rng.choice(arrays.kmers, n // 2),
                        rng.integers(0, 1 << 62, n - n // 2, dtype=np.uint64)])
    if shuffle:
        rng.shuffle(q)
    return q


def phase_library(torch, np, arrays, rng, device) -> dict:
    """The pre-hashed library path at the sizes a KAGE caller passes, on the
    bench index: compat calls, map_hashes on the gather route and
    GpuCounter, each against the numpy oracle with every launch count
    zeroed before and read after (no twin may run); the gather kernel
    against its twins on every hazard case; the crossover of the two routes
    of map_hashes; the gather kernel's time and bound."""
    from kmer_mapper_tpu_torch import compat, gpu_counter, oracle
    from kmer_mapper_tpu_torch.ops import probe, probe_cases, stream_probe
    from kmer_mapper_tpu_torch.ops.u32hash import from_int32_bits

    def launches():
        return {**stream_probe.launch_counts, **probe.launch_counts}

    def require(before, rose: str, what: str):
        now = launches()
        twins = {k: now[k] - before[k] for k in now if "reference" in k and now[k] != before[k]}
        if now[rose] <= before[rose] or twins:
            raise AssertionError(f"library: {what} did not run {rose} alone: "
                                 f"before {before}, after {now}")

    t_phase = time.perf_counter()
    for m in (probe, stream_probe):
        for name in m.launch_counts:
            m.launch_counts[name] = 0
    q = library_hashes(np, rng, arrays, LIB_HASHES)
    before = launches()
    t = time.perf_counter()
    got = compat.map_kmers_to_graph_index(arrays, kmers=q)
    first_s = time.perf_counter() - t
    require(before, "stream_count", "map_kmers_to_graph_index")
    t = time.perf_counter()
    if not np.array_equal(got, oracle.map_kmers_to_index(arrays, q)):
        raise AssertionError("library: map_kmers_to_graph_index != oracle.map_kmers_to_index")
    oracle_s = time.perf_counter() - t
    index = compat._as_index(arrays)
    mapper = compat._shared_mapper(index)
    table_ptr = mapper.key_lo.data_ptr()
    log(f"library: map_kmers_to_graph_index on {len(q)} hashes (table build and upload "
        f"included) in {first_s:.2f} s; {int(got.sum())} node hits == oracle "
        f"({oracle_s:.1f} s)")

    # a second call with the same index object: the cached mapper and its
    # device table, timed on LIB_TIMED hashes
    big = library_hashes(np, rng, arrays, LIB_TIMED, shuffle=False)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    before = launches()
    t = time.perf_counter()
    got_big = compat.map_kmers_to_graph_index(arrays, kmers=big)
    big_s = time.perf_counter() - t
    peak = torch.cuda.max_memory_allocated() - base
    require(before, "stream_count", "the timed map_kmers_to_graph_index")
    if compat._shared_mapper(index) is not mapper or mapper.key_lo.data_ptr() != table_ptr:
        raise AssertionError("library: the second call did not reuse the cached mapper")
    if int(got_big.sum()) < LIB_TIMED // 2:
        raise AssertionError("library: the timed call counted too few hits")
    # its host stages alone: words split and uploaded, node counts
    t = time.perf_counter()
    words = list(mapper._hash_pieces(big))
    torch.cuda.synchronize()
    upload_s = time.perf_counter() - t
    t = time.perf_counter()
    mapper.node_counts()
    finalize_s = time.perf_counter() - t
    log(f"library: second call on {LIB_TIMED} hashes, same mapper and table: "
        f"{big_s:.3f} s host clock, {LIB_TIMED / big_s / 1e6:.1f} M hashes/s (split and "
        f"upload alone {upload_s:.3f} s, node counts alone {finalize_s:.3f} s); peak device "
        f"memory above the table {peak / 2**30:.2f} GiB ({peak / LIB_TIMED:.1f} B a hash, "
        f"HASH_PIECE {mapper.HASH_PIECE})")
    del big, got_big, words

    before = launches()
    member = compat.in_graph_index(arrays, q)
    require(before, "gather_probe", "in_graph_index")
    if not np.array_equal(member, oracle.in_index(arrays, q)):
        raise AssertionError("library: in_graph_index != oracle.in_index")
    log(f"library: in_graph_index on {len(q)} hashes == oracle ({int(member.sum())} in)")

    small = q[:LIB_GATHER]
    before = launches()
    mapper.reset_counts()
    mapper.map_hashes(small)
    require(before, "gather_probe", "map_hashes on the gather route")
    if launches()["stream_count"] != before["stream_count"]:
        raise AssertionError("library: a gather-route batch launched stream_count")
    if not np.array_equal(mapper.node_counts(), oracle.map_kmers_to_index(arrays, small)):
        raise AssertionError("library: map_hashes (gather route) != oracle")
    log(f"library: map_hashes on {LIB_GATHER} hashes (gather route) == oracle")

    counted = q[:LIB_COUNTER]
    before = launches()
    counter = gpu_counter.GpuCounter.from_kmers_and_nodes(arrays.kmers, arrays.nodes, K)
    counter.count(counted, count_revcomps=True)
    got_nodes = counter.get_node_counts()
    require(before, "stream_count", "GpuCounter.count")
    unique = np.unique(arrays.kmers)
    expect = oracle.node_counts_from_kmer_counts(
        arrays.kmers, arrays.nodes, unique, oracle.count_unique_kmers(
            unique, np.concatenate([counted, oracle.revcomp_hash(counted, K)])))
    if not np.array_equal(got_nodes, expect):
        raise AssertionError("library: GpuCounter != numpy node_counts_from_kmer_counts")
    path_launches = launches()
    log(f"library: GpuCounter.count({LIB_COUNTER} hashes, count_revcomps=True) == numpy "
        f"path ({int(got_nodes.sum())} node hits); launches on the library path "
        f"{path_launches}")

    # the kernel against its twins on every hazard case (launches not counted)
    max_err = 0
    for case in probe_cases.cases():
        slots = probe.probe_slots(*case.slot_args(device))
        counts = probe.probe_count(*case.count_args(device))
        twin_slots = probe.probe_slots_reference(*case.slot_args(device))
        twin_counts = probe.probe_count_reference(*case.count_args(device))
        max_err = max(max_err, int(np.abs(slots.cpu().numpy().astype(np.int64)
                                          - twin_slots.cpu().numpy()).max(initial=0)),
                      int(np.abs(_u32(counts) - _u32(twin_counts)).max(initial=0)))
        if (max_err or not np.array_equal(slots.cpu().numpy(), case.expected_slots())
                or not np.array_equal(_u32(counts), case.expected_counts())):
            raise AssertionError(f"library: gather hazard {case.name}: kernel, twin and loop differ")
    log(f"library: gather_probe == twin == numpy loop on {len(probe_cases.cases())} hazard "
        "cases, both modes")

    # the crossover of the two routes, on device-resident query words
    table = index.table
    lo32 = torch.from_numpy(np.ascontiguousarray(q.astype(np.uint32)).view(np.int32)).to(device)
    hi32 = torch.from_numpy(np.ascontiguousarray((q >> np.uint64(32)).astype(np.uint32))
                            .view(np.int32)).to(device)
    valid = torch.ones(len(q), dtype=torch.bool, device=device)
    scratch = torch.zeros_like(mapper.counts)

    def stream_route(n, counts):
        return lambda: stream_probe.stream_probe_count(
            mapper.key_lo, mapper.key_hi, counts, from_int32_bits(lo32[:n]),
            from_int32_bits(hi32[:n]), valid[:n], table.seed, mapper.block_probe)

    def gather_route(n, counts):
        return lambda: probe.probe_count(mapper.key_lo, mapper.key_hi, counts, lo32[:n],
                                         hi32[:n], valid[:n], table.max_probe, table.seed)

    crossover = []
    log("library: crossover, device ms of one map_hashes piece on each route "
        "(median of 5)")
    for n in CROSSOVER:
        a, b = torch.zeros_like(scratch), torch.zeros_like(scratch)
        stream_route(n, a)()
        gather_route(n, b)()
        if not torch.equal(a, b):
            raise AssertionError(f"library: stream and gather routes differ at n={n}")
        row = (n, median_ms(stream_route(n, scratch)), median_ms(gather_route(n, scratch)))
        crossover.append(row)
        log(f"  n = 2^{n.bit_length() - 1:2d}: stream {row[1]:8.4f} ms  gather {row[2]:8.4f} ms")

    # the kernel line: in_graph_index's shape, LIB_HASHES queries in slots mode
    slots_args = (mapper.key_lo, mapper.key_hi, lo32, hi32, table.max_probe, table.seed)
    slots = probe.probe_slots(*slots_args)
    twin = probe.probe_slots_reference(*slots_args)
    max_err = max(max_err, int((slots.long() - twin.long()).abs().max()))
    if max_err:
        raise AssertionError("library: gather kernel != twin at the library's shape")
    ms = median_ms(lambda: probe.probe_slots(*slots_args))
    plain_ms = median_ms(lambda: probe.probe_slots_reference(*slots_args), reps=3)
    mean_rounds, bound_ms, bound_by, row_ms = gather_bound(index, lo32, hi32, slots)
    count_args = (mapper.key_lo, mapper.key_hi, scratch, lo32, hi32, valid, table.max_probe,
                  table.seed)
    count_ms = median_ms(lambda: probe.probe_count(*count_args))
    count_plain_ms = median_ms(lambda: probe.probe_count_reference(*count_args), reps=3)
    log(f"library: gather_probe on {len(q)} queries, slots: kernel {ms:.4f} ms, twin "
        f"{plain_ms:.3f} ms; counts: kernel {count_ms:.4f} ms, twin {count_plain_ms:.3f} ms; "
        f"{mean_rounds:.3f} rounds a query; bound {bound_ms:.4f} ms by {bound_by} (every "
        f"touched bucket read once), {row_ms:.4f} ms with every round's row read")
    log(f"library: phase took {time.perf_counter() - t_phase:.1f} s")
    return {
        "name": "gather_probe", "route": "cuda",
        "source": "kmer_mapper_tpu_torch/csrc/gather_probe.cu",
        "replaces": "kmer_mapper_tpu/ops/probe.py:31 (XLA)",
        "launches": path_launches["gather_probe"], "max_abs_err": max_err,
        "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
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
                   if e.get("cat") == "kernel" and "block_count_kernel" in e.get("name", ""))
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


def phase_file_feed(torch, np, chunks, dev_chunks, index, device) -> dict:
    """The file path as a user runs it: the CLI on FASTQ, .fq.gz and BGZF
    files of phase 5's reads, each held to a fresh map_chunk pass over the
    same chunks, with the launch and frame counts zeroed before each run and
    read after it."""
    import gzip

    from kmer_mapper_tpu_torch import cli, pipeline
    from kmer_mapper_tpu_torch.io import gzio, native
    from kmer_mapper_tpu_torch.models.mapper import KmerMapper, MapperConfig
    from kmer_mapper_tpu_torch.ops import stream_probe
    from kmer_mapper_tpu_torch.pipeline import CUDA_BUF

    t_phase = time.perf_counter()
    workdir = tempfile.mkdtemp(prefix="chip_smoke_feed_")
    try:
        index_path = os.path.join(workdir, "index.tpuidx.npz")
        index.to_file(index_path)
        paths = {name: os.path.join(workdir, name) for name in
                 ("reads8.fq", "reads1.fq", "reads1.fq.gz", "reads1.bgzf.fq.gz")}
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

        expect = {1: reference(1), len(dev_chunks): reference(len(dev_chunks))}
        profile_dir = os.path.join(workdir, "trace")
        runs = [
            ("a", "numpy framer, -t 1", "reads1.fq", 1, ["-t", "1"], True),
            ("b", "native, -t 1", "reads8.fq", len(dev_chunks), ["-t", "1"], False),
            ("c", "native, -t 8, --profile-dir", "reads8.fq", len(dev_chunks),
             ["-t", "8", "--profile-dir", profile_dir], False),
            ("f", "native, -t 8, no profiler", "reads8.fq", len(dev_chunks), ["-t", "8"],
             False),
            ("d", ".fq.gz, -t 8", "reads1.fq.gz", 1, ["-t", "8"], False),
            ("e", "BGZF, -t 8", "reads1.bgzf.fq.gz", 1, ["-t", "8"], False),
        ]
        out = {}
        catch = RunFigures()
        pipeline_log = logging.getLogger(pipeline.__name__)
        pipeline_log.addHandler(catch)
        pipeline_log.setLevel(logging.INFO)
        for tag, what, name, n_chunks, flags, no_native in runs:
            catch.figures = None
            counts_path = os.path.join(workdir, f"counts_{tag}.npy")
            for key in stream_probe.launch_counts:
                stream_probe.launch_counts[key] = 0
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
            launches = dict(stream_probe.launch_counts)
            framed = native.frame_counts["buffers"]
            if not np.array_equal(np.load(counts_path), expect[n_chunks]):
                raise AssertionError(f"file feed ({tag}) {what}: node counts differ from "
                                     "the map_chunk reference")
            if launches["stream_count"] < run["chunks"] or launches["stream_count_reference"]:
                raise AssertionError(f"file feed ({tag}): stream_count did not run alone: "
                                     f"{launches} for {run['chunks']} chunks")
            if (framed > 0) == no_native:
                raise AssertionError(f"file feed ({tag}): the native loader framed {framed} "
                                     "buffers")
            decoder = gzio.decoder_name(paths[name]) if name.endswith(".gz") else "none"
            run.update(wall_s=wall, framed=framed, launches=launches["stream_count"],
                       decoder=decoder)
            out[tag] = run
            log(f"file feed ({tag}) {what}: {sizes[name]} bytes, {run['chunks']} chunks, "
                f"wall {wall:.3f} s ({run['bases'] / wall / 1e6:.1f} M bases/s, "
                f"{run['kmers'] / wall / 1e6:.1f} M k-mers/s); mapping loop "
                f"{run['map_s']:.3f} s ({run['bases'] / run['map_s'] / 1e6:.1f} M bases/s, "
                f"{run['kmers'] / run['map_s'] / 1e6:.1f} M k-mers/s), waited "
                f"{run['queue_wait_s']:.3f} s on the host feed; decoder {decoder}; native "
                f"buffers {framed}; stream_count {launches['stream_count']}; counts == reference")
        pipeline_log.removeHandler(catch)
        share, window_ms, traced = trace_busy_share(profile_dir)
        if traced < out["c"]["chunks"]:
            raise AssertionError(f"file feed (c): the trace holds {traced} stream_count "
                                 f"launches for {out['c']['chunks']} chunks")
        out["c"].update(busy_share=share, window_ms=window_ms)
        log(f"file feed (c) trace: device busy {100 * share:.1f}% of a {window_ms:.1f} ms "
            f"mapping window; {traced} stream_count launches traced")
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    log(f"file feed: phase took {time.perf_counter() - t_phase:.1f} s")
    return out


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this check needs a GPU",
              file=sys.stderr)
        return 1
    device = torch.device("cuda")
    name, smi = phase_environment(torch)
    phase_build()
    log("tolerance: every comparison is exact integer equality (max_abs_err 0)")
    max_err = phase_hazards(torch, device)
    rng = np.random.default_rng(0)
    from kmer_mapper_tpu_torch.io.readers import strided_rows
    from kmer_mapper_tpu_torch.pipeline import CUDA_BUF

    chunks = make_chunks(np, rng, N_CHUNKS, strided_rows(CUDA_BUF, READ_LEN))
    workdir = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        e2e = phase_end_to_end(torch, np, chunks[0], rng, workdir)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    steady = phase_steady_state(torch, np, chunks, e2e["index"], device)
    log(f"summary on {smi}: kernel path median "
        f"{sorted(steady['kernel_rates'])[N_WINDOWS // 2] / 1e6:.1f} Mk/s, twin path median "
        f"{sorted(steady['twin_rates'])[N_WINDOWS // 2] / 1e6:.1f} Mk/s")
    dissect = phase_dissect(torch, np, device)
    tiles = phase_tiles(torch, np, device)
    library = phase_library(torch, np, e2e["arrays"], rng, device)
    phase_file_feed(torch, np, chunks, steady["dev_chunks"], e2e["index"], device)
    kernels = [{
        "name": "stream_count",
        "route": "cuda",
        "source": "kmer_mapper_tpu_torch/csrc/stream_count.cu",
        "replaces": "kmer_mapper_tpu/ops/stream_probe.py:551",
        "launches": e2e["launches"],
        "max_abs_err": max(max_err, steady["max_abs_err"]),
        "ms": steady["ms"],
        "plain_ms": steady["plain_ms"],
        "bound_ms": steady["bound_ms"],
        "bound_by": steady["bound_by"],
        "library_ms": None,  # no single PyTorch call counts slot hits
    }, *dissect, *tiles, library]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
