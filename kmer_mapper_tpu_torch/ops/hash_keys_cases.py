"""Hazard inputs for the hash-key kernels (``csrc/hash_keys.cu``), each with
the sorted keys that the host oracle expects.

The buffers come from the port's own packer (``io/readers.py:
pack_for_device``) on reads made from a numpy seed. Plane cases: k at 1, at
the word boundary (15, 16, 17) and 21, 31; read lengths k, 31, 32, 33 and
151; the reverse complement off and on; ``n_reads`` of 0, 1, all rows but
one and all rows of a full buffer (the rows past ``n_reads`` hold reads that
must be ignored); seed 0 and a seed at which every round constant plus the
seed wraps past 2**32. Ragged cases: reads shorter than k, zero-length
reads, invalid bases (N and others encode as A), a last read that fills the
buffer, poly-A and poly-T buffers, a read split into overlapping pieces, and
the read layouts of the JAX package's window-mask tests
(``tests/test_device_ops.py`` ``test_window_mask_ragged`` and
``test_window_mask_padding_contract``). The expected keys come from
:func:`expected_keys`: the oracle's k-mer hashes of the codes unpacked from
each buffer, mixed and keyed on the host, independent of both the kernels
and their twins. Used by ``tests/test_torch_hash_keys.py``,
``tests/test_torch_hash_kernels.py`` and ``chip_smoke.py``.
"""
from __future__ import annotations

import dataclasses
import itertools

import numpy as np
import torch

from .. import oracle
from ..io import readers
from .hashing import read_stride
from .u32hash import feistel_mix, split_u64

PLANE_KS = (1, 15, 16, 17, 21, 31)
PLANE_READ_LENS = (31, 32, 33, 151)  # and read_len == k
#: seed 0, and one where (round constant + seed) wraps for all three rounds
SEEDS = (0, 0x80000000 + 12345)


@dataclasses.dataclass
class HashCase:
    name: str
    packed: np.ndarray  # uint32 words as the packer wrote them
    k: int
    seed: int
    revcomp: bool
    # plane: reads per row and the rows hashed; ragged: the read lengths
    read_len: int = 0
    n_reads: int = 0
    lengths: np.ndarray | None = None  # uint16[max_reads], ragged only
    n_bases: int = 0

    @property
    def ragged(self) -> bool:
        return self.lengths is not None

    def inputs(self, device) -> tuple:
        """The arguments of ``hashing.plane_hash_keys`` or
        ``hashing.ragged_hash_keys`` on ``device``."""
        words = torch.from_numpy(self.packed.view(np.int32).copy()).to(device)
        if self.ragged:
            lengths = torch.from_numpy(self.lengths.astype(np.int32)).to(device)
            return words, lengths, self.n_bases, self.k, self.seed, self.revcomp
        return words, self.k, self.read_len, self.n_reads, self.seed, self.revcomp

    def reads(self) -> list[np.ndarray]:
        """The 2-bit codes of each read the call hashes, unpacked from the
        buffer."""
        if self.ragged:
            codes = unpack(self.packed, self.n_bases)
            ends = np.cumsum(self.lengths.astype(np.int64))
            return [codes[e - n : e] for e, n in zip(ends, self.lengths) if n]
        npr = read_stride(self.read_len) // 16
        return [unpack(self.packed[r * npr : (r + 1) * npr], self.read_len)
                for r in range(self.n_reads)]

    def expected_keys(self) -> np.ndarray:
        return expected_keys(self.reads(), self.k, self.seed, self.revcomp)

    def n_keys(self) -> int:
        """How many keys the call writes: one per valid window (x2)."""
        n = sum(max(0, len(r) - self.k + 1) for r in self.reads())
        return n * (2 if self.revcomp else 1)


def unpack(packed: np.ndarray, n: int) -> np.ndarray:
    """The first n 2-bit codes of a packed word stream."""
    idx = np.arange(n, dtype=np.int64)
    return ((packed[idx // 16] >> (2 * (idx % 16)).astype(np.uint32)) & 3).astype(np.uint8)


def expected_keys(reads, k: int, seed: int, revcomp: bool) -> np.ndarray:
    """Sorted int64 sort keys of every window of each read: the oracle's
    hashes (and reverse complements), the host Feistel mix, the key whose
    high word is ``m_lo ^ 2**31`` and low word ``m_hi``."""
    kmers = np.concatenate([np.zeros(0, np.uint64)]
                           + [oracle.kmer_hashes(r, k) for r in reads])
    if revcomp:
        kmers = np.concatenate([kmers, oracle.revcomp_hash(kmers, k)])
    m_lo, m_hi = feistel_mix(*split_u64(kmers), seed=seed)
    keys = (((m_lo ^ np.uint32(0x80000000)).astype(np.uint64) << np.uint64(32))
            | m_hi.astype(np.uint64))
    return np.sort(keys.view(np.int64))


def _bases(rng, n: int, alphabet: str = "ACGT") -> np.ndarray:
    return np.frombuffer(alphabet.encode(), np.uint8)[rng.integers(0, len(alphabet), n)]


def _chunk(parts) -> readers.SequenceChunk:
    lengths = np.array([len(p) for p in parts], dtype=np.int64)
    bases = np.concatenate([np.zeros(0, np.uint8), *parts]).astype(np.uint8)
    return readers.SequenceChunk(bases, np.cumsum(lengths) - lengths)


def plane_buffer(k: int, read_len: int) -> tuple[np.ndarray, int]:
    """(packed words, rows): a full strided buffer of at least 3 reads of
    ``read_len`` (ACGTN), as ``pack_for_device(read_len=...)`` packs it."""
    buf = -(-3 * read_len // 16) * 16
    rows = readers.strided_rows(buf, read_len)
    rng = np.random.default_rng(1000 * k + read_len)
    reads = [_bases(rng, read_len, "ACGTN") for _ in range(rows)]
    (packed, _, _, n_reads, _, strided), = readers.pack_for_device(
        iter([_chunk(reads)]), buf, rows, k, read_len=read_len)
    assert strided and n_reads == rows
    return packed, rows


def plane_configs():
    """(k, read_len) pairs of the plane cases."""
    return [(k, L) for k in PLANE_KS for L in sorted({k, *PLANE_READ_LENS}) if L >= k]


def plane_cases(seeds=SEEDS) -> list[HashCase]:
    out = []
    for k, L in plane_configs():
        packed, rows = plane_buffer(k, L)
        for revcomp, seed, n_reads in itertools.product(
                (False, True), seeds, sorted({0, 1, rows - 1, rows})):
            out.append(HashCase(f"plane_k{k}_L{L}_rc{int(revcomp)}_s{seed}_n{n_reads}",
                                packed, k, seed, revcomp, read_len=L, n_reads=n_reads))
    return out


def ragged_sources() -> dict:
    """name -> (chunks of reads, buf, max_reads, ks)."""
    rng = np.random.default_rng(20)
    mixed = [_bases(rng, n, "ACGTNX") for n in rng.integers(0, 90, 70)]
    for i in (3, 17, 40):
        mixed[i] = mixed[i][:0]  # zero-length reads
    short = [_bases(rng, n) for n in rng.integers(0, 15, 40)]
    fills = [_bases(rng, n) for n in (100, 150, 120, 142, 200, 312)]  # 512 each way
    poly_a = [np.full(n, ord("A"), np.uint8) for n in rng.integers(30, 200, 12)]
    poly_t = [np.full(n, ord("T"), np.uint8) for n in rng.integers(30, 200, 12)]
    long_read = [_bases(rng, 3000)]
    return {
        "mixed": ([mixed], 1024, 32, (1, 15, 16, 17, 31)),
        "short_and_empty": ([short + [short[0][:0]]], 512, 64, (1, 15, 31)),
        "last_read_fills_buf": ([fills], 512, 16, (16, 31)),
        "poly_a": ([poly_a], 1024, 16, (15, 31)),
        "poly_t": ([poly_t], 1024, 16, (17, 31)),
        "long_read_split": ([long_read], 512, 16, (21, 31)),
        # tests/test_device_ops.py: window_mask's ragged and padding cases
        "device_ops_window_mask": ([[_bases(rng, n) for n in (6, 3, 10, 4)]], 32, 8, (4,)),
        "device_ops_padding_contract": ([[_bases(rng, 40)]], 64, 16, (5,)),
    }


def ragged_buffers(name: str, k: int) -> list[tuple]:
    """The continuous buffers ``pack_for_device`` makes of a ragged source:
    (packed, lengths, n_bases, n_reads, n_invalid) tuples."""
    groups, buf, max_reads, _ = ragged_sources()[name]
    return list(readers.pack_for_device(
        (_chunk(parts) for parts in groups), buf, max_reads, k))


def ragged_configs() -> list[tuple[str, int]]:
    """(source name, k) pairs of the ragged cases."""
    return [(name, k) for name, (*_, ks) in ragged_sources().items() for k in ks]


def ragged_cases(seeds=SEEDS) -> list[HashCase]:
    out = []
    for name, k in ragged_configs():
        for i, (packed, lengths, n_bases, _, _) in enumerate(ragged_buffers(name, k)):
            for revcomp, seed in itertools.product((False, True), seeds):
                out.append(HashCase(f"ragged_{name}_k{k}_b{i}_rc{int(revcomp)}_s{seed}",
                                    packed, k, seed, revcomp, lengths=lengths,
                                    n_bases=n_bases))
    return out


def cases() -> list[HashCase]:
    return plane_cases() + ragged_cases()


#: read counts of the offsets' cases: none, one, around one and two tiles of
#: the scan (``hashing.RAGGED_SCAN_TILE`` reads, 4,096), and 2^21
OFFSETS_ROWS = (0, 1, 2047, 2048, 2049, 4095, 4096, 4097, 8193, 1 << 21)
#: the offsets' edge cases, on 2 tiles and a part: a negative length in the
#: last tile (the sum kept), lengths that add up to n_bases + 1 and - 1, and
#: every length below k
OFFSETS_EDGES = ("negative_in_last_tile", "n_bases_plus_one", "n_bases_minus_one",
                 "all_below_k")


@dataclasses.dataclass
class OffsetsCase:
    """Read lengths for ``hashing.ragged_offsets`` with the buffer's bases."""
    name: str
    lengths: np.ndarray  # int64
    n_bases: int
    k: int
    revcomp: bool

    def inputs(self, device) -> tuple:
        """The arguments of ``hashing.ragged_offsets`` on ``device``."""
        lengths = torch.from_numpy(self.lengths.astype(np.int32)).to(device)
        return lengths, self.n_bases, self.k, self.revcomp

    def expected(self) -> tuple[np.ndarray, np.ndarray, list[int]]:
        """(starts, offs, count) by numpy, int32 as the offsets' contract
        has them: (-1, -1) where the lengths do not tile the bases."""
        windows = np.maximum(self.lengths - self.k + 1, 0)
        offs = np.concatenate([[0], np.cumsum(windows)])
        tiled = self.lengths.sum() == self.n_bases and not (self.lengths < 0).any()
        n = int(offs[-1])
        count = [n * (2 if self.revcomp else 1), n] if tiled else [-1, -1]
        starts = np.cumsum(self.lengths) - self.lengths
        return starts.astype(np.int32), offs.astype(np.int32), count


def offsets_case(name: str, wave: int | None = None) -> OffsetsCase:
    """One case of :func:`offsets_case_names`: ``rows_<n>`` (lengths of
    0..200 bp, a few zero, tiling their bases), an edge of
    :data:`OFFSETS_EDGES`, or ``wave_plus_one``: one read more than a wave
    of the offsets' persistent grid, ``wave`` reads (so one CTA takes two
    tiles)."""
    k = 31
    if name == "wave_plus_one":
        if wave is None:
            raise ValueError("wave_plus_one needs the grid's reads a wave")
        n = wave + 1
    elif name.startswith("rows_"):
        n = int(name[len("rows_"):])
    else:
        n = 2 * 4096 + 1000
    rng = np.random.default_rng(n + 17 * len(name))
    high = k if name == "all_below_k" else 201
    lengths = rng.integers(0, high, n).astype(np.int64)
    lengths[rng.random(n) < 0.05] = 0
    n_bases = int(lengths.sum())
    if name == "negative_in_last_tile":
        lengths[-3] -= lengths[-3] + 7  # -7, the sum kept by the next read
        lengths[-2] += n_bases - lengths.sum()
    n_bases += {"n_bases_plus_one": 1, "n_bases_minus_one": -1}.get(name, 0)
    return OffsetsCase(name, lengths, n_bases, k, revcomp=n % 2 == 1)


def offsets_case_names() -> list[str]:
    return [f"rows_{n}" for n in OFFSETS_ROWS] + list(OFFSETS_EDGES) + ["wave_plus_one"]
