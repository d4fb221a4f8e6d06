"""The configuration matrix of ``scripts/bench_matrix.py`` on the port: five
configurations through ``pipeline.map_file`` / ``map_file_sharded``, each
run twice (warm-up, then steady), each held to its node-count sum in
``BENCH_MATRIX.md`` and to the numpy oracle's node-count vector.

    python -m kmer_mapper_tpu_torch.scripts.bench_matrix [--device cpu]

  1. a toy .fa (2,000 reads) against a toy index, one chunk
  2. a gzipped FASTQ (100,000 reads) streamed against a 4M-key index
  3. k = 16, 21 and 31 with reverse complements, reads with N bases
  4. 300,000 reads against a 16M-key index
  5. config 4 over a (data, index) grid: with n >= 2 cards n devices in
     rows of min(2, n) index shards; with one card a (1, 2) grid of that
     card, which is not a multi-card rate; on the CPU a (1, 2) grid of it

Reads and indexes come from ``default_rng(0)`` in the JAX script's order
(``scripts/bench_matrix.py:66-130``), so the sums are the JAX package's.
Prints one line a configuration (warm-up wall, steady wall, M k-mers/s of
the steady run, node-count sum) and raises on any mismatch.
"""
from __future__ import annotations

import argparse
import dataclasses
import gzip
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from .. import oracle, pipeline
from ..index.kmer_index import KmerIndex
from . import device_arg, device_name, pick_device

READ_LEN = 151
#: node-count sums of BENCH_MATRIX.md, by configuration
EXPECTED_SUMS = {"1": 15205, "2": 15275, "3 k=16": 18879, "3 k=21": 16527, "3 k=31": 15214,
                 "4": 15281, "5": 15281}


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def make_reads(rng, n_reads, read_len=READ_LEN, with_n=False):
    alphabet = list("ACGTN") if with_n else list("ACGT")
    p = [0.24, 0.24, 0.24, 0.24, 0.04] if with_n else None
    return ["".join(rng.choice(alphabet, read_len, p=p)) for _ in range(n_reads)]


def write_reads(path, reads, gz=False, fastq=False):
    if fastq:
        data = "".join(f"@r{i}\n{s}\n+\n{'I' * len(s)}\n" for i, s in enumerate(reads))
    else:
        data = "".join(f">r{i}\n{s}\n" for i, s in enumerate(reads))
    if gz:
        with gzip.open(path, "wt") as f:
            f.write(data)
    else:
        Path(path).write_text(data)
    return str(path)


def sorted_unique(x: np.ndarray) -> np.ndarray:
    """``np.unique(x)`` by a sort: numpy 2.3's ``np.unique`` finds integers'
    unique values in a hash table, which made ``scale_drill``'s draw of
    150M keys take 478 s on an H100 server's host CPU, against 15 s by
    this sort."""
    x = np.sort(x)
    return x[np.concatenate([[True], x[1:] != x[:-1]])] if len(x) else x


def index_entries(rng, reads, k, n_extra, n_nodes, sample=30_000):
    """(unique entry k-mers, their nodes): k-mers sampled from the first 200
    reads (N read as A) and ``n_extra`` random k-mers."""
    codes = oracle.encode_bytes(
        np.frombuffer("".join(reads[:200]).replace("N", "A").encode(), np.uint8)
    )
    read_kmers = oracle.kmer_hashes(codes, k)
    entry = sorted_unique(
        np.concatenate(
            [
                rng.choice(read_kmers, min(sample, len(read_kmers))),
                rng.integers(0, 1 << 62, n_extra, dtype=np.uint64) & np.uint64(4**k - 1),
            ]
        )
    )
    nodes = rng.integers(0, n_nodes, len(entry)).astype(np.int32)
    return entry, nodes


def index_from_reads(rng, reads, k, n_extra, n_nodes, sample=30_000):
    return KmerIndex.from_entries(*index_entries(rng, reads, k, n_extra, n_nodes, sample))


def fixed_read_kmers(bases: np.ndarray, read_len: int, k: int) -> np.ndarray:
    """The oracle's k-mer hashes (``hash = sum codes[i + m] << 2m``, N read
    as A) of concatenated reads of ``read_len`` bases, read by read, window
    by window: ``oracle.kmer_hashes_ragged`` on equal lengths, computed in
    two buffers of the output's size (a host fills fresh pages slowly)."""
    codes = oracle.encode_bytes(bases).reshape(-1, read_len)
    n_windows = read_len - k + 1
    out = np.zeros((len(codes), n_windows), np.uint64)
    term = np.empty_like(out)
    for m in range(k):
        term[...] = codes[:, m : m + n_windows]
        term <<= np.uint64(2 * m)
        out |= term
    return out.reshape(-1)


@dataclasses.dataclass
class Config:
    """One configuration: its index (with the entries it was built from, for
    the oracle), its reads' file and bases, and how it is mapped."""

    name: str
    index: KmerIndex
    entries: tuple  # (unique k-mers, nodes)
    path: str
    bases: np.ndarray  # the reads' bases, concatenated
    k: int = 31
    revcomp: bool = False
    sharded: bool = False

    @property
    def n_kmers(self) -> int:
        """Windows mapped: the JAX script's count (forward and reverse)."""
        n = len(self.bases) // READ_LEN * (READ_LEN - self.k + 1)
        return 2 * n if self.revcomp else n

    def oracle_counts(self) -> np.ndarray:
        """The numpy oracle's node counts: the reference-layout index of the
        entries probed with the reads' k-mers (and their reverse
        complements)."""
        entry, nodes = self.entries
        arrays = oracle.build_kmer_index(entry, nodes, int(len(entry) * 1.7) | 1)
        kmers = fixed_read_kmers(self.bases, READ_LEN, self.k)
        if self.revcomp:
            kmers = np.concatenate([kmers, oracle.revcomp_hash(kmers, self.k)])
        return oracle.map_kmers_to_index(arrays, kmers)


def _bases(reads) -> np.ndarray:
    return np.frombuffer("".join(reads).encode(), np.uint8)


def make_configs(workdir) -> list[Config]:
    """Configurations 1-4 (config 3 once per k), their reads written under
    ``workdir``, drawn in the JAX script's order."""
    workdir = Path(workdir)
    rng = np.random.default_rng(0)
    t = time.perf_counter()
    reads1 = make_reads(rng, 2000)
    e1 = index_entries(rng, reads1, 31, 2000, 500)
    configs = [Config("1", KmerIndex.from_entries(*e1), e1,
                      write_reads(workdir / "toy.fa", reads1), _bases(reads1))]
    reads2 = make_reads(rng, 100_000)
    e2 = index_entries(rng, reads2, 31, 4_000_000, 3_000_000)
    configs.append(Config("2", KmerIndex.from_entries(*e2), e2,
                          write_reads(workdir / "big.fq.gz", reads2, gz=True, fastq=True),
                          _bases(reads2)))
    reads3 = make_reads(rng, 50_000, with_n=True)
    p3 = write_reads(workdir / "n.fa", reads3)
    b3 = _bases(reads3)
    for k in (16, 21, 31):
        e3 = index_entries(rng, [r.replace("N", "A") for r in reads3], k, 500_000, 100_000)
        configs.append(Config(f"3 k={k}", KmerIndex.from_entries(*e3), e3, p3, b3, k=k,
                              revcomp=True))
    reads4 = make_reads(rng, 300_000)
    e4 = index_entries(rng, reads4, 31, 16_000_000, 3_000_000, sample=100_000)
    configs.append(Config("4", KmerIndex.from_entries(*e4), e4,
                          write_reads(workdir / "vol.fa", reads4), _bases(reads4)))
    log(f"bench_matrix: reads and indexes made in {time.perf_counter() - t:.1f} s; "
        f"config 2's index {configs[1].index.n_unique} keys "
        f"({configs[1].index.table.nbytes / 1e6:.0f} MB), config 4's "
        f"{configs[-1].index.n_unique} ({configs[-1].index.table.nbytes / 1e6:.0f} MB)")
    return configs


def sharded_config(config4: Config) -> Config:
    return dataclasses.replace(config4, name="5", sharded=True)


def grid_args(device: torch.device) -> tuple[dict, str]:
    """``map_file_sharded``'s grid arguments for config 5 on ``device``'s
    kind, and the grid's label: every card (rows of min(2, n) index shards)
    where there are two or more, else a (1, 2) grid of the one device."""
    n = torch.cuda.device_count() if device.type == "cuda" else 0
    if n >= 2:
        return dict(n_devices=n, index_parallel=min(2, n)), f"{n} cards"
    what = "one card, not a multi-card rate" if device.type == "cuda" else "the CPU"
    return dict(devices=[device, device], index_parallel=2), f"(1, 2) grid of {what}"


def run_config(config: Config, device: torch.device) -> np.ndarray:
    """One run of the configuration through the file pipeline."""
    if config.sharded:
        grid, _ = grid_args(device)
        return pipeline.map_file_sharded(config.index, config.path, k=config.k,
                                         map_reverse_complements=config.revcomp, **grid)
    return pipeline.map_file(config.index, config.path, device=device, k=config.k,
                             map_reverse_complements=config.revcomp)


def check(name: str, got: np.ndarray, expect_sum: int, expect: np.ndarray) -> None:
    """Raise unless the node counts sum to ``expect_sum`` and equal
    ``expect`` (the oracle's) entry for entry."""
    total = int(got.sum(dtype=np.int64))
    if total != expect_sum:
        raise AssertionError(f"config {name}: node-count sum {total}, expected {expect_sum}")
    if got.shape != expect.shape or not np.array_equal(got, expect):
        raise AssertionError(f"config {name}: node counts differ from the numpy oracle's")


def time_config(config: Config, device: torch.device, expect: np.ndarray) -> dict:
    """Warm-up and steady runs of one configuration, both checked against
    its sum and ``expect``, the oracle's node counts."""
    t = time.perf_counter()
    warm = run_config(config, device)
    warm_s = time.perf_counter() - t
    t = time.perf_counter()
    out = run_config(config, device)
    steady_s = time.perf_counter() - t
    check(config.name, warm, EXPECTED_SUMS[config.name], expect)
    check(config.name, out, EXPECTED_SUMS[config.name], expect)
    return dict(name=config.name, warm_s=warm_s, steady_s=steady_s,
                mk_s=config.n_kmers / steady_s / 1e6, sum=int(out.sum(dtype=np.int64)))


def describe(config: Config, device: torch.device) -> str:
    what = {"1": "toy .fa, one chunk", "2": "gzipped FASTQ, 4M-key index",
            "4": "16M-key index, 300,000 reads"}.get(config.name, "revcomp + N bases")
    if config.sharded:
        what = "config 4 sharded over " + grid_args(device)[1]
    return f"{config.name} ({what})"


def main(argv=None) -> list[dict]:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    device_arg(parser)
    device = pick_device(parser.parse_args(argv).device)
    print(f"bench_matrix on {device_name(device)}", flush=True)
    rows = []
    with tempfile.TemporaryDirectory(prefix="kmt_matrix_") as workdir:
        configs = make_configs(workdir)
        expect = [config.oracle_counts() for config in configs]
        for config, counts in zip([*configs, sharded_config(configs[-1])], expect + expect[-1:]):
            row = time_config(config, device, counts)
            rows.append(row)
            print(f"config {describe(config, device)}: warm-up {row['warm_s']:.3f} s, "
                  f"steady {row['steady_s']:.3f} s = {row['mk_s']:.1f} Mk/s, "
                  f"node-count sum {row['sum']} (== BENCH_MATRIX.md and the oracle)",
                  flush=True)
    return rows


if __name__ == "__main__":
    main()
