"""The mapper: a device-resident table and count state fed one packed chunk
at a time. The torch counterpart of ``kmer_mapper_tpu/models/mapper.py``.

    stride-padded packed reads -> plane hash + Feistel mix -> sort
        -> chain-block offsets -> stream-count kernel -> slot counts

Chunks whose reads are not all ``read_len`` long take the ragged step
(rolling hash + read-boundary window mask), which gives identical counts.
Pre-hashed uint64 k-mers (the library calls) take :meth:`KmerMapper.map_hashes`
and :meth:`KmerMapper.in_index`:

    large batches: Feistel mix -> sort -> chain-block offsets -> stream-count kernel
    small batches and membership: gather-probe kernel (``ops/probe.py``)

Counts stay on the device in slot order as int32 whose bits are the
reference's wrapping uint32; they leave it only in :meth:`slot_counts`.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..index.kmer_index import KmerIndex
from ..index.layout import CHAIN_BLOCK
from ..ops import encode, hashing, probe, stream_probe
from ..ops.u32hash import from_int32_bits, split_u64


@dataclasses.dataclass(frozen=True)
class MapperConfig:
    """Shape configuration of the mapping step."""

    k: int = 31
    buf: int = 1 << 21  # chunk capacity in bases; multiple of 16
    max_reads: int = 1 << 15  # max reads per chunk
    revcomp: bool = False  # also count reverse complements
    read_len: int = 0  # every read of a strided chunk has this length (0: none)

    def __post_init__(self):
        if not 1 <= self.k <= 31:
            raise ValueError(f"k must be in [1, 31] (62-bit hashes); got {self.k}")
        if self.buf % encode.BASES_PER_WORD:
            raise ValueError(f"buf must be a multiple of {encode.BASES_PER_WORD}")
        if self.read_len and not self.k <= self.read_len <= self.buf:
            raise ValueError(f"read_len {self.read_len} outside [k, buf]")


def chunk_step(key_lo, key_hi, counts, packed, lengths, n_bases: int, *,
               config: MapperConfig, seed: int, block_probe) -> torch.Tensor:
    """Ragged step over a continuously packed chunk: folds the chunk's hits
    into ``counts`` in place and returns its valid-window count (a device
    scalar). ``packed`` is int64-held words[buf // 16 + 2], ``lengths``
    int64[max_reads] with zero padding."""
    k = config.k
    lo, hi = hashing.rolling_kmer_hash_packed(packed, k)
    starts = torch.cumsum(lengths, 0) - lengths
    valid = hashing.window_mask(starts, n_bases, k, config.buf)
    n_valid = valid.sum()
    if config.revcomp:
        rlo, rhi = hashing.revcomp_lo_hi(lo, hi, k)
        lo, hi = torch.cat([lo, rlo]), torch.cat([hi, rhi])
        valid = torch.cat([valid, valid])
    stream_probe.stream_probe_count(
        key_lo, key_hi, counts, lo, hi, valid, seed, block_probe
    )
    return n_valid


def plane_chunk_step(key_lo, key_hi, counts, packed, n_reads: int, *,
                     config: MapperConfig, seed: int, block_probe) -> int:
    """Fixed-read-length step over stride-padded packing
    (``pack_for_device(read_len=L)``): folds the hits into ``counts`` in
    place and returns the valid-window count."""
    m_lo, m_hi = hashing.plane_hash_mixed(
        packed, config.k, config.read_len, n_reads, seed, revcomp=config.revcomp
    )
    stream_probe.stream_probe_count_mixed(
        key_lo, key_hi, counts, m_lo, m_hi, block_probe
    )
    return n_reads * (config.read_len - config.k + 1)


def state_from_jax(counts_plane: np.ndarray, n_buckets: int,
                   gpb: int = CHAIN_BLOCK) -> np.ndarray:
    """A ``kmer_mapper_tpu`` stream mapper's device counts (plane order,
    blocked by ``gpb`` buckets) -> this package's slot-order uint32 counts."""
    return stream_probe.plane_to_slot(
        np.asarray(counts_plane, dtype=np.uint32), n_buckets, gpb
    )


class KmerMapper:
    """Device-resident mapper: the index table and the counts live on
    ``device``; feed packed chunks with :meth:`map_chunk` or uint64 hashes
    with :meth:`map_hashes`, then read :meth:`node_counts`. Nothing is moved
    off the device it was given."""

    #: a batch of at least this many hashes takes the stream route (sort +
    #: stream-count kernel), a smaller one the gather probe; by size alone,
    #: the same on every device
    STREAM_HASH_MIN = 1 << 17
    #: hashes per piece of a batch: bounds the stream route's int64
    #: temporaries on the device (5.6 GiB at 2**26 on an H100; PERF.md)
    HASH_PIECE = 1 << 26

    def __init__(self, index: KmerIndex, config: MapperConfig, device):
        self.index = index
        self.config = config
        table = index.table
        self.counts = torch.zeros(table.n_slots, dtype=torch.int32, device=device)
        self.device = self.counts.device  # with its index: "cuda" -> cuda:0
        self.key_lo = self._to_device(table.key_lo)
        self.key_hi = self._to_device(table.key_hi)
        self.block_probe = torch.from_numpy(table.block_max_probe()).to(self.device)
        self._stats: list = []  # per-chunk valid windows: ints or device scalars
        self._total_kmers = 0
        self.n_invalid_bases = 0

    def _to_device(self, words: np.ndarray) -> torch.Tensor:
        """uint32 host words -> int32 bit patterns on the device."""
        return torch.from_numpy(np.ascontiguousarray(words, np.uint32).view(np.int32)).to(
            self.device
        )

    def _words(self, packed) -> torch.Tensor:
        """Packed words (uint32 numpy, or int32 bit patterns in a tensor on
        the mapper's device or in page-locked host memory) -> int64-held
        words on the mapper's device. A page-locked tensor is copied
        asynchronously: the caller keeps it unchanged until the stream has
        passed this chunk (``pipeline.PinnedRing``)."""
        if isinstance(packed, np.ndarray):
            if packed.dtype != np.uint32:
                raise TypeError(f"packed words must be uint32, got {packed.dtype}")
            packed = self._to_device(packed)
        elif packed.dtype == torch.int32 and packed.device.type == "cpu" and packed.is_pinned():
            packed = packed.to(self.device, non_blocking=True)
        elif packed.dtype != torch.int32 or packed.device != self.device:
            raise TypeError(
                f"packed tensor must be int32 on {self.device} or in page-locked "
                f"host memory, got {packed.dtype} on {packed.device}"
            )
        return from_int32_bits(packed)

    def map_chunk(self, packed, lengths, n_bases: int, n_invalid: int = 0,
                  strided: bool = False) -> None:
        """Fold one packed chunk into the count state.

        ``strided=True`` marks a buffer from ``pack_for_device(...,
        read_len=L)`` in the stride-padded layout (every read exactly
        ``config.read_len`` long): it takes the plane step. Continuous
        buffers take the ragged step."""
        self.n_invalid_bases += n_invalid
        words = self._words(packed)
        table = self.index.table
        step_args = (self.key_lo, self.key_hi, self.counts, words)
        step_kw = dict(config=self.config, seed=table.seed, block_probe=self.block_probe)
        if strided:
            if not self.config.read_len:
                raise ValueError("strided chunks need config.read_len")
            n_reads = n_bases // self.config.read_len
            self._stats.append(plane_chunk_step(*step_args, n_reads, **step_kw))
            return
        lengths = torch.from_numpy(np.asarray(lengths, dtype=np.int64)).to(self.device)
        self._stats.append(chunk_step(*step_args, lengths, n_bases, **step_kw))

    def _hash_pieces(self, kmers):
        """uint64 hashes -> (lo, hi) int32 word tensors on the device, one
        piece of at most HASH_PIECE hashes at a time."""
        kmers = np.asarray(kmers, dtype=np.uint64)
        for start in range(0, len(kmers), self.HASH_PIECE):
            lo, hi = split_u64(kmers[start : start + self.HASH_PIECE])
            yield self._to_device(lo), self._to_device(hi)

    def map_hashes(self, kmers: np.ndarray) -> None:
        """Count pre-computed uint64 kmer hashes (the library calls
        ``map_kmers_to_graph_index`` and ``counter.count``). A piece of at
        least STREAM_HASH_MIN hashes takes the stream route, a smaller one
        the gather probe; both give the same counts."""
        table = self.index.table
        for q_lo, q_hi in self._hash_pieces(kmers):
            n = q_lo.shape[0]
            valid = torch.ones(n, dtype=torch.bool, device=self.device)
            if n >= self.STREAM_HASH_MIN:
                stream_probe.stream_probe_count(
                    self.key_lo, self.key_hi, self.counts, from_int32_bits(q_lo),
                    from_int32_bits(q_hi), valid, table.seed, self.block_probe,
                )
            else:
                probe.probe_count(
                    self.key_lo, self.key_hi, self.counts, q_lo, q_hi, valid,
                    table.max_probe, table.seed,
                )
            self._stats.append(n)

    def in_index(self, kmers: np.ndarray) -> np.ndarray:
        """Membership per uint64 kmer hash, uint8[n], with no frequency
        filter (the reference's ``in_graph_index``), by the gather probe."""
        table = self.index.table
        out = [np.zeros(0, dtype=np.uint8)]
        for q_lo, q_hi in self._hash_pieces(kmers):
            slots = probe.probe_slots(
                self.key_lo, self.key_hi, q_lo, q_hi, table.max_probe, table.seed
            )
            out.append(slots.ge(0).to(torch.uint8).cpu().numpy())
        return np.concatenate(out)

    @property
    def n_kmers_mapped(self) -> int:
        if self._stats:
            on_device = [s for s in self._stats if isinstance(s, torch.Tensor)]
            self._total_kmers += sum(s for s in self._stats if isinstance(s, int))
            if on_device:  # one transfer for all device scalars
                self._total_kmers += int(torch.stack(on_device).sum())
            self._stats = []
        return self._total_kmers

    def reset_counts(self) -> None:
        """Zero the accumulated state, keeping the device-resident table."""
        self.counts.zero_()
        self._stats = []
        self._total_kmers = 0
        self.n_invalid_bases = 0

    def save_state(self, path) -> None:
        """Checkpoint the counts (slot order, as ``kmer_mapper_tpu`` writes
        them) and totals."""
        np.savez(
            path,
            counts=self.slot_counts(),
            n_kmers=np.int64(self.n_kmers_mapped),
            n_invalid=np.int64(self.n_invalid_bases),
        )

    def load_state(self, path) -> None:
        with np.load(path, allow_pickle=False) as data:
            counts = np.asarray(data["counts"], dtype=np.uint32).reshape(-1)
            if counts.shape[0] != self.index.table.n_slots:
                raise ValueError(
                    f"checkpoint holds {counts.shape[0]} slot counts, the "
                    f"table has {self.index.table.n_slots}"
                )
            self.counts = self._to_device(counts)
            self._stats = []
            self._total_kmers = int(data["n_kmers"])
            self.n_invalid_bases = int(data["n_invalid"])

    def slot_counts(self) -> np.ndarray:
        """uint32[n_slots] counts in slot order, on the host."""
        return self.counts.cpu().numpy().view(np.uint32)

    def node_counts(self, max_frequency: int = 1000) -> np.ndarray:
        """Final per-node hit counts, uint32[max_node_id + 1]."""
        return self.index.node_counts(self.slot_counts(), max_frequency=max_frequency)

    def kmer_counts(self) -> tuple[np.ndarray, np.ndarray]:
        """Counter view: (unique kmers, their counts)."""
        return self.index.kmer_counts(self.slot_counts())
