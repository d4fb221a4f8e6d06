"""Scale run of the file pipeline: 10M reads of 151 bp (1.21 G k-mers) at
k=31 against a 16M-key index, end to end through ``pipeline.map_file`` on
one device (the counterpart of ``scripts/scale_run.py``).

    python -m kmer_mapper_tpu_torch.scripts.scale_run [--reads N] [--device cpu]

Writes the reads as a FASTA from ``default_rng(0)`` byte for byte as the
JAX script does (into a temporary directory, removed at the end), builds
the index from ``default_rng(1)``, maps the file twice (the first run's
wall includes the kernels' first build and load; the second is the steady
wall) and checks the file's first framed chunk exactly against the host
table's probe (``index.layout.query_table``) and ``KmerIndex.node_counts``.
Prints one ``RESULT`` line on stdout.
"""
from __future__ import annotations

import argparse
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

from .. import oracle, pipeline
from ..index import layout
from ..index.kmer_index import KmerIndex
from ..io import native, readers
from . import device_arg, device_name, pick_device
from .bench_matrix import sorted_unique

N_READS = 10_000_000
READ_LEN = 151
K = 31
CHUNK_READS = 100_000  # reads drawn and written at a time


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def write_reads(path: Path, n_reads: int, rng) -> None:
    """``n_reads`` random reads as a FASTA, drawn ``CHUNK_READS`` at a time
    (the last draw cut to what is left)."""
    with open(path, "wb") as f:
        for c in range(-(-n_reads // CHUNK_READS)):
            n = min(CHUNK_READS, n_reads - c * CHUNK_READS)
            seqs = rng.choice(np.frombuffer(b"ACGT", np.uint8), (n, READ_LEN))
            parts = [
                b">r%d\n" % (c * CHUNK_READS + i) + seqs[i].tobytes() + b"\n"
                for i in range(n)
            ]
            f.write(b"".join(parts))


def make_index(reads_path: Path) -> KmerIndex:
    """16M keys from ``default_rng(1)``: 8M uniform and 8M sampled from the
    k-mers of the file's first 2 Mi bases (across read ends, as the JAX
    script samples them)."""
    rng = np.random.default_rng(1)
    with open(reads_path, "rb") as f:
        head = f.read(4 << 20)
    sample_bases = np.frombuffer(
        b"".join(l for l in head.split(b"\n") if l and not l.startswith(b">")), np.uint8
    )
    read_kmers = oracle.kmer_hashes(oracle.encode_bytes(sample_bases[: 2 << 20]), K)
    entry = sorted_unique(
        np.concatenate(
            [
                rng.integers(0, 1 << 62, 8_000_000, dtype=np.uint64),
                rng.choice(read_kmers, 8_000_000),
            ]
        )
    )
    nodes = rng.integers(0, 10_000_000, len(entry)).astype(np.int32)
    return KmerIndex.from_entries(entry, nodes)


def check_prefix(index: KmerIndex, reads_path: Path, workdir: Path, device) -> tuple[int, int]:
    """Map the file's first framed chunk (at least 1 MiB) as a file of its
    own; its node counts must equal the host probe's. Returns (k-mers,
    node hits)."""
    chunk = next(readers.read_chunks(str(reads_path), min_chunk_size=1 << 20))
    prefix = workdir / "head.fa"
    with open(prefix, "w") as g:
        ends = np.append(chunk.read_starts[1:], chunk.n_bases)
        for i, (s, e) in enumerate(zip(chunk.read_starts, ends)):
            g.write(f">r{i}\n{bytes(chunk.bases[s:e]).decode()}\n")
    got = pipeline.map_file(index, str(prefix), device=device, k=K, chunk_size=1 << 20)
    pref_kmers = oracle.kmer_hashes_ragged(
        oracle.encode_bytes(chunk.bases), chunk.read_lengths, K
    )
    slots = layout.query_table(index.table, pref_kmers)
    slot_counts = np.bincount(slots[slots >= 0], minlength=index.table.n_slots)
    expect = index.node_counts(slot_counts)
    if not np.array_equal(got, expect):
        raise AssertionError("scale_run: the first chunk's node counts differ from the "
                             "host probe's")
    return len(pref_kmers), int(got.sum(dtype=np.int64))


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--reads", type=int, default=N_READS,
                        help=f"reads in the file (default {N_READS:,})")
    device_arg(parser)
    a = parser.parse_args(argv)
    device = pick_device(a.device)
    print(f"scale_run on {device_name(device)}", flush=True)
    with tempfile.TemporaryDirectory(prefix="kmt_scale_") as tmp:
        workdir = Path(tmp)
        reads_path = workdir / "reads.fa"
        t = time.perf_counter()
        write_reads(reads_path, a.reads, np.random.default_rng(0))
        log(f"wrote {reads_path.stat().st_size / 1e9:.2f} GB in "
            f"{time.perf_counter() - t:.1f} s")
        t = time.perf_counter()
        index = make_index(reads_path)
        log(f"index: {index.n_unique / 1e6:.1f}M unique, table "
            f"{index.table.nbytes / 1e9:.2f} GB, built in {time.perf_counter() - t:.1f} s; "
            f"native loader: {native.available()}")

        n_kmers = a.reads * (READ_LEN - K + 1)
        t = time.perf_counter()
        counts = pipeline.map_file(index, str(reads_path), device=device, k=K,
                                   chunk_size=4 << 20)
        first = time.perf_counter() - t
        log(f"FIRST: {first:.3f} s wall (kernel build and load included) for "
            f"{n_kmers / 1e9:.3f} G k-mers = {n_kmers / first / 1e6:.1f} Mk/s; "
            f"node-count sum {int(counts.sum(dtype=np.int64))}")
        t = time.perf_counter()
        counts2 = pipeline.map_file(index, str(reads_path), device=device, k=K,
                                    chunk_size=4 << 20)
        steady = time.perf_counter() - t
        if not np.array_equal(counts, counts2):
            raise AssertionError("scale_run: the two runs' node counts differ")
        log(f"STEADY: {steady:.3f} s wall for {n_kmers / 1e9:.3f} G k-mers = "
            f"{n_kmers / steady / 1e6:.1f} Mk/s end to end")
        n_prefix, prefix_hits = check_prefix(index, reads_path, workdir, device)
        log(f"prefix verification OK ({n_prefix} k-mers, {prefix_hits} node hits)")
    result = dict(reads=a.reads, kmers=n_kmers, first_s=first, steady_s=steady,
                  steady_mk_s=n_kmers / steady / 1e6, sum=int(counts.sum(dtype=np.int64)),
                  prefix_kmers=n_prefix)
    print("RESULT " + " ".join(f"{key}={value}" for key, value in result.items()),
          flush=True)
    return result


if __name__ == "__main__":
    main()
