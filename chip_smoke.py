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
     same stages with the plain twin, per-stage milliseconds, equal counts.
The line before the last is a JSON object describing each kernel; the last
line is {"ok": true, "device": {...}}. Needs no network and one GPU.
"""
from __future__ import annotations

import json
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
    log(f"build: {path.name} in {seconds:.2f} s")
    for line in native.build_log().splitlines():
        if "ptxas info" in line:
            log(f"  {line.strip()}")
    return seconds


def _u32(t):
    import numpy as np

    return t.cpu().numpy().view(np.uint32).astype(np.int64)


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
    return {"launches": launches["stream_count"], "index": kmer_index.KmerIndex.from_arrays(arrays)}


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
        return keys, stream_probe.block_offsets(keys, n_buckets, bpb)

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
        off = stream_probe.block_offsets(keys, n_buckets, bpb)
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

    # kernel vs twin alone on one chunk's sorted keys, fresh counts each
    keys, off = sorted_queries(dev_chunks[0][0], dev_chunks[0][2])
    outs, ms = [], []
    for fn in (stream_probe.stream_count, stream_probe.stream_count_reference):
        reps = []
        for _ in range(5):
            c = torch.zeros_like(mapper.counts)
            e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            e0.record()
            fn(mapper.key_lo, mapper.key_hi, c, keys, off, mapper.block_probe, shift, bpb)
            e1.record()
            torch.cuda.synchronize()
            reps.append(e0.elapsed_time(e1))
        outs.append(c)
        ms.append(sorted(reps)[len(reps) // 2])
    max_err = int((outs[0].to(torch.int64) - outs[1].to(torch.int64)).abs().max())
    if max_err:
        raise AssertionError("steady: kernel and twin disagree on one chunk")
    log(f"steady: stream_count on {keys.numel()} queries: kernel {ms[0]:.3f} ms, "
        f"twin {ms[1]:.3f} ms (median of 5)")
    return {
        "kernel_rates": kernel_rates, "twin_rates": twin_rates, "stage_ms": stage_ms,
        "ms": ms[0], "plain_ms": ms[1], "max_abs_err": max_err,
    }


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
    kernels = [{
        "name": "stream_count",
        "route": "cuda",
        "source": "kmer_mapper_tpu_torch/csrc/stream_count.cu",
        "replaces": "kmer_mapper_tpu/ops/stream_probe.py:551",
        "launches": e2e["launches"],
        "max_abs_err": max(max_err, steady["max_abs_err"]),
        "ms": steady["ms"],
        "plain_ms": steady["plain_ms"],
    }]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
