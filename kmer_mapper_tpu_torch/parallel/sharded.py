"""Multi-device mapping over a (data, index) grid of devices.

The torch counterpart of ``kmer_mapper_tpu/parallel/sharded.py``. Layout
(``mesh.py``): chunks of reads fan out over the grid's data rows, and the
table is split into equal, contiguous bucket ranges over its index columns.
Cell (d, x) holds table rows ``[x * nb_local, (x + 1) * nb_local)`` and its
own int32 slot-order count shard, both on its device. It hashes every chunk
of its data row and counts only the keys whose bucket it holds, so the hot
loop needs no communication. The data rows' counts add, and the entries
become node counts, once, in :meth:`ShardedKmerMapper.node_counts`.

A cell's chunk step is the single-device one (its hashing is
``models/mapper.py``'s ``chunk_keys`` / ``plane_chunk_keys``), with the
shard's range:

* shards of whole chain blocks (``nb_local % 128 == 0``, every table of
  128 buckets or more a shard): the block partition over the
  whole table's blocks, and the stream count over the shard's own windows
  (``stream_probe.stream_probe_count_keys`` with ``bucket_base``);
* narrower shards: the same keys, unmixed to the raw hashes, through the
  gather probe with the shard's rows (``probe.probe_count`` with
  ``row_offset``; other shards' rounds compare nothing), JAX's gather route.

A ragged chunk's key count stays on its device, as on one device: the
partition reads it from device memory, the gather route masks the key
buffer's tail with it, and the totals are read back only when they are
read (``models/mapper.WindowTotals``).

Pre-hashed batches (:meth:`ShardedKmerMapper.map_hashes`) take the gather
probe, as the single-device port does. The TPU workarounds of the JAX
mapper's ``__init__`` (group widening, ``min_feasible_group``,
``auto_stream_cap``, multi-stream and paged schedules) have no counterpart.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..index.kmer_index import KmerIndex
from ..index.layout import BUCKET_KEYS, CHAIN_BLOCK
from ..io import readers
from ..models.mapper import (
    KmerMapper, MapperConfig, WindowTotals, chunk_is_fixed, chunk_keys, key_buffer,
    plane_chunk_keys,
)
from ..ops import finalize as finalize_op
from ..ops import hashing, probe, stream_probe
from ..ops.u32hash import MASK32, feistel_unmix_torch
from .mesh import DATA_AXIS, INDEX_AXIS, Mesh
from .multihost import process_index_and_count

#: the node-count finalize (``kmer_mapper_tpu.parallel.make_finalize``): the
#: kernel of ``csrc/node_counts.cu`` on CUDA tensors, its twin on the CPU
finalize = finalize_op.finalize


@dataclasses.dataclass
class _Cell:
    """Grid cell (d, x): its device, its table shard (shared with the cells
    of other rows on the same device), the whole table's chain-block bounds
    on that device, and its own count shard."""

    device: torch.device
    key_lo: torch.Tensor
    key_hi: torch.Tensor
    block_probe: torch.Tensor
    counts: torch.Tensor


def _raw_queries(keys: torch.Tensor, seed: int) -> torch.Tensor:
    """Sort keys of mixed windows -> the raw hashes' uint64 bits as int64."""
    lo, hi = feistel_unmix_torch(*stream_probe.split_key(keys), seed)
    return torch.where(hi >= 1 << 31, hi - (1 << 32), hi) * (1 << 32) + lo


def _counted(keys: torch.Tensor, count: torch.Tensor | None) -> torch.Tensor | None:
    """The gather probe's ``valid`` mask of a key buffer: its first
    ``count[0]`` entries (the ragged step's device count; the tail of a
    capacity buffer is not a query), made on the device with no sync. None
    (every key a query) without a count."""
    if count is None:
        return None
    return torch.arange(keys.shape[0], device=keys.device) < count[0]


class ShardedKmerMapper(WindowTotals):
    """Multi-device mapper: the table sharded over the mesh's index axis,
    chunks fanned out over its data axis. Feed batches of D packed chunks
    (:meth:`map_batch`, :meth:`map_chunks`) or uint64 hashes
    (:meth:`map_hashes`), then read :meth:`node_counts`."""

    def __init__(self, index: KmerIndex, config: MapperConfig, mesh: Mesh):
        self.index = index
        self.config = config
        self.mesh = mesh
        self.n_data = mesh.shape[DATA_AXIS]
        self.n_index = mesh.shape[INDEX_AXIS]
        table = index.table
        if table.n_buckets % self.n_index:
            raise ValueError(f"{table.n_buckets} buckets do not split into "
                             f"{self.n_index} index shards")
        self.n_buckets = table.n_buckets
        self.nb_local = table.n_buckets // self.n_index
        self.bpb = min(CHAIN_BLOCK, table.n_buckets)
        # the stream count takes whole chain blocks
        self.route = "stream" if self.nb_local % self.bpb == 0 else "gather"
        shards: dict = {}
        block_probe: dict = {}
        self.cells = []
        for row in mesh.devices:
            cells = []
            for x, dev in enumerate(row):
                if (dev, x) not in shards:
                    rows = slice(x * self.nb_local, (x + 1) * self.nb_local)
                    shards[dev, x] = tuple(
                        torch.from_numpy(np.ascontiguousarray(w[rows], np.uint32).view(np.int32))
                        .to(dev) for w in (table.key_lo, table.key_hi))
                if dev not in block_probe:
                    block_probe[dev] = torch.from_numpy(table.block_max_probe()).to(dev)
                counts = torch.zeros(self.nb_local * BUCKET_KEYS, dtype=torch.int32, device=dev)
                cells.append(_Cell(dev, *shards[dev, x], block_probe[dev], counts))
            self.cells.append(cells)
        #: index shard x's entry arrays on row 0's device, from the first
        #: node_counts on
        self._entries: dict = {}
        self._keys: dict = {}  # the ragged step's key buffer a device (key_buffer)
        self._reset_totals()
        self.n_invalid_bases = 0

    def _count_keys(self, x: int, cell: _Cell, keys: torch.Tensor,
                    count: torch.Tensor | None = None) -> None:
        """Fold one data row's sort keys (the first ``count[0]`` of them,
        where the ragged step's device count is given) into cell x's
        counts."""
        base = x * self.nb_local
        if self.route == "stream":
            first = base // self.bpb
            stream_probe.stream_probe_count_keys(
                cell.key_lo, cell.key_hi, cell.counts, keys,
                cell.block_probe[first : first + self.nb_local // self.bpb],
                bucket_base=base, n_buckets_global=self.n_buckets, count=count,
            )
            return
        table = self.index.table
        probe.probe_count(cell.key_lo, cell.key_hi, cell.counts, _raw_queries(keys, table.seed),
                          table.max_probe, table.seed, block_probe=cell.block_probe,
                          valid=_counted(keys, count), row_offset=base,
                          n_buckets_global=self.n_buckets)

    def map_chunks(self, chunks) -> None:
        """Fold up to D chunks, one a data row, into the count shards (None:
        the row has none). Each chunk is
        ``(packed, lengths, n_bases, n_invalid, strided)`` as
        ``KmerMapper.map_chunk`` takes it: uint32 words in numpy, or int32
        words in a tensor (on any device, or page-locked and unchanged until
        the devices have taken it); ``strided`` buffers take the plane step,
        the others the ragged one, which reads ``lengths``."""
        if len(chunks) > self.n_data:
            raise ValueError(f"{len(chunks)} chunks for {self.n_data} data rows")
        config, seed = self.config, self.index.table.seed
        for d, chunk in enumerate(chunks):
            if chunk is None:
                continue
            packed, lengths, n_bases, n_invalid, strided = chunk
            self.n_invalid_bases += n_invalid
            if strided and not config.read_len:
                raise ValueError("strided chunks need config.read_len")
            if not strided:
                hashing.check_lengths(lengths, n_bases)  # host lengths, before the upload
            on_device: dict = {}
            for x, cell in enumerate(self.cells[d]):
                if cell.device not in on_device:
                    on_device[cell.device] = (
                        _int32_on(packed, cell.device),
                        None if strided else _int32_on(lengths, cell.device),
                    )
                words, lens = on_device[cell.device]
                count = None
                if strided:
                    keys, n_valid = plane_chunk_keys(words, n_bases // config.read_len,
                                                     config=config, seed=seed)
                else:
                    keys, count = chunk_keys(words, lens, n_bases, config=config, seed=seed,
                                             out=key_buffer(self._keys, words, config))
                    n_valid = count[1]  # a device scalar: no sync
                if x == 0:  # each data row's windows count once
                    self._stats.append(n_valid)
                self._count_keys(x, cell, keys, count)

    def map_batch(self, packed_batch: np.ndarray, lengths_batch: np.ndarray,
                  n_bases: np.ndarray, n_invalid: int = 0) -> None:
        """packed uint32[D, packed_words] (continuous packing), lengths
        uint16[D, max_reads], n_bases int32[D] (``batch_packed_chunks``).
        A batch of whole ``config.read_len`` reads is restrided on the host
        and takes the plane step; any other takes the ragged step. Empty
        rows are skipped."""
        config = self.config
        n_bases = [int(n) for n in np.asarray(n_bases)]
        fixed = bool(config.read_len) and all(
            chunk_is_fixed(ln, nb, config.read_len)
            for ln, nb in zip(np.asarray(lengths_batch), n_bases)
        )
        chunks = []
        for packed, lengths, nb in zip(np.asarray(packed_batch), np.asarray(lengths_batch),
                                       n_bases):
            if fixed:
                rows = readers.strided_rows(config.buf, config.read_len)
                packed = readers.restride_packed(packed, nb // config.read_len,
                                                 config.read_len, rows)
            nz = np.flatnonzero(lengths)
            lengths = lengths[: nz[-1] + 1 if len(nz) else 0]
            chunks.append((packed, lengths, nb, 0, fixed) if nb else None)
        self.n_invalid_bases += n_invalid
        self.map_chunks(chunks)

    def map_hashes(self, kmers: np.ndarray) -> None:
        """Count pre-computed uint64 k-mer hashes on the sharded index (the
        KAGE library call): the batch splits over the data rows, and each
        index shard counts the keys it holds, through the gather probe, in
        pieces of at most ``KmerMapper.HASH_PIECE``."""
        kmers = np.ascontiguousarray(kmers, dtype=np.uint64).view(np.int64)
        table = self.index.table
        for d, part in enumerate(np.array_split(kmers, self.n_data)):
            for start in range(0, len(part), KmerMapper.HASH_PIECE):
                piece = part[start : start + KmerMapper.HASH_PIECE]
                on_device: dict = {}
                for x, cell in enumerate(self.cells[d]):
                    if cell.device not in on_device:
                        on_device[cell.device] = torch.from_numpy(piece).to(cell.device)
                    probe.probe_count(cell.key_lo, cell.key_hi, cell.counts,
                                      on_device[cell.device], table.max_probe, table.seed,
                                      block_probe=cell.block_probe,
                                      row_offset=x * self.nb_local,
                                      n_buckets_global=self.n_buckets)
        self._stats.append(len(kmers))

    def slot_counts(self) -> np.ndarray:
        """uint32[D, n_slots]: each data row's counts in slot order, on the
        host."""
        self._fold_stats()
        return np.stack([np.concatenate([c.counts.cpu().numpy().view(np.uint32) for c in row])
                         for row in self.cells])

    def save_state(self, path) -> None:
        """Checkpoint the count shards (each data row's counts in slot order,
        as ``kmer_mapper_tpu``'s sharded mapper writes them) and totals."""
        np.savez(path, counts=self.slot_counts(), n_kmers=np.int64(self.n_kmers_mapped),
                 n_invalid=np.int64(self.n_invalid_bases))

    def load_state(self, path) -> None:
        with np.load(path, allow_pickle=False) as data:
            counts = np.asarray(data["counts"], dtype=np.uint32)
            if counts.shape != (self.n_data, self.index.table.n_slots):
                raise ValueError(f"checkpoint counts shape {counts.shape} does not match "
                                 f"mesh ({self.n_data}, {self.index.table.n_slots})")
            per = self.nb_local * BUCKET_KEYS
            for row, saved in zip(self.cells, counts):
                for x, cell in enumerate(row):
                    cell.counts = torch.from_numpy(
                        np.ascontiguousarray(saved[x * per : (x + 1) * per]).view(np.int32)
                    ).to(cell.device)
            self._reset_totals(int(data["n_kmers"]))
            self.n_invalid_bases = int(data["n_invalid"])

    def node_counts(self, max_frequency: int = 1000) -> np.ndarray:
        """Final per-node hit counts, uint32[max_node_id + 1]. Per index
        shard: the data rows' count shards added into a copy of row 0's (a
        device-to-device copy each, a wrapping int32 add), the finalize over
        the shard's entries on its device; the shards' vectors added on the
        mesh's first device, read back once. Each shard's entry arrays are
        uploaded on the first call and kept with the mapper. Inside a
        ``torch.distributed`` process group the vector is summed over the
        processes too (in int64, then masked to 32 bits: the uint32 wrap)."""
        self._fold_stats()
        n_nodes = self.index.max_node_id + 1
        out = None
        for x, cell in enumerate(self.cells[0]):
            total = cell.counts.clone()
            for row in self.cells[1:]:
                total.add_(row[x].counts.to(cell.device))
            if x not in self._entries:
                self._entries[x] = self.index.device_entries(cell.device, (x, self.n_index))
            part = finalize(total, *self._entries[x], max_frequency, n_nodes)
            out = part if out is None else out.add_(part.to(out.device))
        if process_index_and_count()[1] > 1:
            import torch.distributed as dist

            out = out.long() & MASK32
            dist.all_reduce(out)
            out &= MASK32
            return out.cpu().numpy().astype(np.uint32)
        return out.cpu().numpy().view(np.uint32)


def _int32_on(x, device: torch.device) -> torch.Tensor:
    """uint32 or integer numpy words, or an int32 tensor anywhere -> int32 on
    ``device`` (a page-locked tensor is copied asynchronously)."""
    if isinstance(x, np.ndarray):
        if x.dtype == np.uint32:
            x = x.view(np.int32)
        return torch.from_numpy(np.ascontiguousarray(x, np.int32)).to(device)
    if x.dtype != torch.int32:
        raise TypeError(f"chunk tensors must be int32, got {x.dtype}")
    return x.to(device, non_blocking=x.device.type == "cpu" and x.is_pinned())


def batch_packed_chunks(packed_iter, n_data: int, packed_words: int, max_reads: int):
    """Group single-chunk packed buffers (``pack_for_device``'s 5-tuples)
    into [D, ...] batches for :meth:`ShardedKmerMapper.map_batch`, padding
    the tail with empty rows. Yields (packed[D, W], lengths[D, R],
    n_bases[D], n_invalid_total)."""
    batch = []
    for item in packed_iter:
        batch.append(item)
        if len(batch) == n_data:
            yield _stack_batch(batch, packed_words, max_reads, n_data)
            batch = []
    if batch:
        yield _stack_batch(batch, packed_words, max_reads, n_data)


def _stack_batch(batch, packed_words, max_reads, n_data):
    packed_b = np.zeros((n_data, packed_words), dtype=np.uint32)
    lengths_b = np.zeros((n_data, max_reads), dtype=np.uint16)
    n_bases = np.zeros(n_data, dtype=np.int32)
    n_invalid = 0
    for i, (p, ln, nb, _, inv) in enumerate(batch):
        packed_b[i], lengths_b[i], n_bases[i] = p, ln, nb
        n_invalid += inv
    return packed_b, lengths_b, n_bases, n_invalid
