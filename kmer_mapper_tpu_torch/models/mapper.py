"""The mapper: a device-resident table and count state fed one packed chunk
at a time. The torch counterpart of ``kmer_mapper_tpu/models/mapper.py``.

    stride-padded packed reads -> hash-key kernel (plane hash + Feistel mix
        + sort key of each valid window) -> block partition (histogram,
        scan, scatter: the keys grouped by chain block, each block's
        window) -> stream-count kernel -> slot counts

Chunks whose reads are not all ``read_len`` long take the ragged step (the
ragged offsets and hash-key kernels: the windows that lie in one read),
which gives identical counts. Its count of keys stays on the card, as JAX's
``chunk_step`` returns ``n_valid`` as a device scalar: the keys go into a
buffer sized by the chunk's capacity, the partition reads the count from
device memory, and the mapper sums the counts when its totals are read, so
the step makes no host sync.
Pre-hashed uint64 k-mers (the library calls) take :meth:`KmerMapper.map_hashes`
and :meth:`KmerMapper.in_index`: the hashes' bits go to the device as int64,
a piece at a time, and the gather-probe kernel (``ops/probe.py``) mixes,
probes and counts each piece, or returns its slots.

Counts stay on the device in slot order as int32 whose bits are the
reference's wrapping uint32; they leave it only in :meth:`slot_counts`. On
CUDA, :meth:`KmerMapper.node_counts` turns them into node counts on the card
(the finalize kernel, ``ops/finalize.py``) and reads back one word a node.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..index.kmer_index import KmerIndex
from ..index.layout import CHAIN_BLOCK
from ..io import readers
from ..ops import encode, finalize, hashing, probe, stream_probe
from ..utils import profiling


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

    @property
    def packed_words(self) -> int:
        """Words of a continuously packed buffer: buf bases and a window's
        tail."""
        return self.buf // encode.BASES_PER_WORD + 2

    @property
    def max_words(self) -> int:
        """Words of the largest packed buffer the config's chunks can have:
        the continuous layout's, or with ``read_len`` the stride-padded
        layout's where that is longer."""
        words = self.packed_words
        if self.read_len:
            rows = readers.strided_rows(self.buf, self.read_len)
            words = max(words, rows * (hashing.read_stride(self.read_len)
                                       // encode.BASES_PER_WORD))
        return words


def chunk_is_fixed(lengths, n_bases, read_len: int) -> bool:
    """True iff the chunk is exactly n whole reads of ``read_len``."""
    nb = int(n_bases)
    if nb % read_len:
        return False
    n = nb // read_len
    lengths = np.asarray(lengths)
    return bool(np.all(lengths[:n] == read_len)) and not np.any(lengths[n:])


def default_config(**kwargs) -> MapperConfig:
    """A :class:`MapperConfig` (``kmer_mapper_tpu.models.mapper.default_config``;
    the port has one route a step, so there is no backend to pick for)."""
    return MapperConfig(**kwargs)


def chunk_keys(packed, lengths, n_bases: int, *, config: MapperConfig, seed: int, out=None):
    """The ragged step's hashing over a continuously packed chunk: (the int64
    sort keys of its valid windows, int32 ``count`` = (keys, valid windows)
    on the chunk's device; ``hashing.ragged_hash_keys``). ``packed`` is
    int32 words[buf // 16 + 2], ``lengths`` the int32 lengths of the chunk's
    reads (zero padding after them is allowed, and scanned), both on one
    device; ``out`` the key buffer (:func:`key_buffer`)."""
    return hashing.ragged_hash_keys(
        packed, lengths, n_bases, config.k, seed, revcomp=config.revcomp, out=out
    )


def key_buffer(buffers: dict, words: torch.Tensor, config: MapperConfig):
    """The ragged step's key buffer on ``words``' device, kept in ``buffers``
    (a mapper's, by device) and reused by every chunk: capacity-sized
    (``hashing.ragged_capacity``), since the host does not learn a chunk's
    count. None on the CPU, whose twin returns exactly the keys."""
    if words.device.type == "cpu":
        return None
    need = hashing.ragged_capacity(words.shape[0], config.revcomp)
    keys = buffers.get(words.device)
    if keys is None or keys.shape[0] < need:
        keys = buffers[words.device] = torch.empty(need, dtype=torch.int64,
                                                   device=words.device)
    return keys


def plane_chunk_keys(packed, n_reads: int, *, config: MapperConfig, seed: int):
    """The plane step's hashing over stride-padded packing
    (``pack_for_device(read_len=L)``, int32 words): (the sort keys of the
    first ``n_reads`` rows' valid windows, their count)."""
    keys = hashing.plane_hash_keys(
        packed, config.k, config.read_len, n_reads, seed, revcomp=config.revcomp
    )
    return keys, n_reads * (config.read_len - config.k + 1)


class WindowTotals:
    """The valid windows a mapper has counted: ints, and the ragged step's
    device scalars, which are summed (one transfer a device) only when the
    total, the counts or the node counts are read, so the step itself
    never syncs. A scalar of -1 marks a ragged chunk whose device lengths did not
    tile its buffer: it was not counted, and every read raises from then
    on until the totals are reset."""

    def _reset_totals(self, total: int = 0) -> None:
        self._stats: list = []  # per-chunk valid windows: ints or device scalars
        self._total_kmers = total
        self._fault = False

    def _fold_stats(self) -> None:
        # the scalars of a sharded mapper's data rows lie on their own
        # devices: each device's are stacked and read back apart
        by_device: dict = {}
        for s in self._stats:
            if isinstance(s, torch.Tensor):
                by_device.setdefault(s.device, []).append(s)
            else:
                self._total_kmers += s
        self._stats = []
        for on_device in by_device.values():
            values = torch.stack(on_device).long().cpu()
            self._total_kmers += int(values.clamp(min=0).sum())
            self._fault = self._fault or bool((values < 0).any())
        if self._fault:
            raise ValueError("ragged_hash_keys: a chunk's read lengths did not tile its "
                             "buffer (a length was negative or they did not add up to "
                             "n_bases); it was not counted")

    @property
    def n_kmers_mapped(self) -> int:
        self._fold_stats()
        return self._total_kmers


def state_from_jax(counts_plane: np.ndarray, n_buckets: int,
                   gpb: int = CHAIN_BLOCK) -> np.ndarray:
    """A ``kmer_mapper_tpu`` stream mapper's device counts (plane order,
    blocked by ``gpb`` buckets) -> this package's slot-order uint32 counts."""
    return stream_probe.plane_to_slot(
        np.asarray(counts_plane, dtype=np.uint32), n_buckets, gpb
    )


class StagingSlots:
    """Two device slots that a CUDA mapper copies page-locked chunks into,
    on a copy stream of its own, so that a chunk's upload runs while the
    mapper's stream still runs the previous chunk's kernels.

    A chunk takes the slots in turn (:meth:`take`). Each slot holds
    ``n_words`` int32 words and, from the first ragged chunk on,
    ``n_lengths`` int32 read lengths; they are allocated on first use, from
    the mapper's stream's memory pool, and kept. CUDA events order the two
    streams:

      * "ready": recorded on the mapper's stream when a slot is allocated;
        the copy stream waits on it before its first write there, since
        kernels queued before may still use the block;
      * "slot j is free": recorded on the mapper's stream (:meth:`passed`)
        after the last kernel that reads the slot (the step's hash-key
        kernel); the copy stream waits on it before it writes slot j again;
      * "copied": recorded on the copy stream after each copy; the mapper's
        stream waits on it before the step reads the slot, and
        :attr:`copied` keeps the chunk's last one, where the copies that
        read the host memory end (``pipeline.PinnedRing`` waits on it
        before it rewrites a host buffer)."""

    def __init__(self, device: torch.device, n_words: int, n_lengths: int):
        self.device = device
        self.capacity = {"packed": n_words, "lengths": n_lengths}
        self.stream = torch.cuda.Stream(device)
        self._slots: dict = {"packed": [None, None], "lengths": [None, None]}
        self._free = [torch.cuda.Event(), torch.cuda.Event()]
        self._next = 0
        self.slot: int | None = None  # the slot of the chunk being staged
        self.copied = None  # the event after the chunk's last copy

    def take(self) -> None:
        """Start a chunk: it takes the next slot, which the copy stream
        writes only once the chunk that last read it has passed its hash."""
        self.slot, self._next = self._next, self._next ^ 1
        self.stream.wait_event(self._free[self.slot])
        self.copied = None

    def copy(self, x: torch.Tensor, what: str) -> torch.Tensor:
        """``x`` (page-locked int32 ``packed`` words or ``lengths``) copied
        into the chunk's slot on the copy stream; the mapper's stream waits
        for the copy. Returns the slot's first ``len(x)`` entries."""
        if self.slot is None:
            self.take()
        n, cap = x.shape[0], self.capacity[what]
        if n > cap:
            raise ValueError(f"{n} page-locked {what} entries, past the staging slot's "
                             f"{cap} (the config's largest chunk)")
        slots = self._slots[what]
        if slots[self.slot] is None:
            slots[self.slot] = torch.empty(cap, dtype=torch.int32, device=self.device)
            # the block comes from the mapper's stream's pool, where kernels
            # queued before may still use it (memory freed under them): the
            # copy stream waits for them before its first write
            ready = torch.cuda.Event()
            ready.record(torch.cuda.current_stream(self.device))
            self.stream.wait_event(ready)
        out = slots[self.slot][:n]
        with torch.cuda.stream(self.stream):
            out.copy_(x, non_blocking=True)
        self.copied = torch.cuda.Event()
        self.copied.record(self.stream)
        torch.cuda.current_stream(self.device).wait_event(self.copied)
        return out

    def passed(self) -> None:
        """The chunk's kernels that read its slot are enqueued on the
        mapper's stream: the slot is free once the stream gets here."""
        if self.slot is not None:
            self._free[self.slot].record(torch.cuda.current_stream(self.device))
            self.slot = None


class KmerMapper(WindowTotals):
    """Device-resident mapper: the index table and the counts live on
    ``device``; feed packed chunks with :meth:`map_chunk` or uint64 hashes
    with :meth:`map_hashes`, then read :meth:`node_counts`. Nothing is moved
    off the device it was given."""

    #: hashes per piece of a batch: a piece holds its int64 hashes on the
    #: device (512 MiB at 2**26) and, in :meth:`in_index`, their int32
    #: slots and uint8 flags (another 320 MiB)
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
        self._entries = None  # the finalize's entry arrays, from the first node_counts on
        self._keys: dict = {}  # the ragged step's key buffer (key_buffer)
        # page-locked chunks are copied on CUDA through two device slots
        self._staging = (StagingSlots(self.device, config.max_words, config.max_reads)
                         if self.device.type == "cuda" else None)
        self._reset_totals()
        self.n_invalid_bases = 0

    @property
    def upload_done(self):
        """The CUDA event after the last :meth:`map_chunk`'s copies of
        page-locked host memory, on the mapper's copy stream: the caller may
        rewrite that memory once it has completed. None where the chunk
        copied none (on the CPU always)."""
        return None if self._staging is None else self._staging.copied

    def _to_device(self, words: np.ndarray) -> torch.Tensor:
        """uint32 host words -> int32 bit patterns on the device."""
        return torch.from_numpy(np.ascontiguousarray(words, np.uint32).view(np.int32)).to(
            self.device
        )

    def _staged(self, x: torch.Tensor, what: str) -> torch.Tensor:
        """An int32 tensor on the mapper's device, or on CUDA in page-locked
        host memory: then copied asynchronously into the chunk's staging
        slot on the mapper's copy stream (:class:`StagingSlots`, at most the
        config's largest chunk), and the caller keeps it unchanged until
        :attr:`upload_done` has completed (``pipeline.PinnedRing``)."""
        if (self._staging is not None and x.dtype == torch.int32
                and x.device.type == "cpu" and x.is_pinned()):
            return self._staging.copy(x, what)
        if x.dtype != torch.int32 or x.device != self.device:
            raise TypeError(
                f"{what} tensor must be int32 on {self.device} or in page-locked "
                f"host memory, got {x.dtype} on {x.device}"
            )
        return x

    def _words(self, packed) -> torch.Tensor:
        """Packed words (uint32 numpy, or int32 bit patterns in a tensor, see
        :meth:`_staged`) -> int32 bit patterns on the mapper's device."""
        if isinstance(packed, np.ndarray):
            if packed.dtype != np.uint32:
                raise TypeError(f"packed words must be uint32, got {packed.dtype}")
            return self._to_device(packed)
        return self._staged(packed, "packed")

    def _lengths(self, lengths, n_bases: int) -> torch.Tensor:
        """Read lengths (a numpy integer array, or an int32 tensor, see
        :meth:`_staged`) -> int32 on the mapper's device. Lengths in host
        memory are checked here, before the upload
        (``hashing.check_lengths``); those already on the device are checked
        by the offsets' kernel, and a failure raises at the next read-back
        (:class:`WindowTotals`)."""
        hashing.check_lengths(lengths, n_bases)
        if isinstance(lengths, np.ndarray):
            return torch.from_numpy(np.ascontiguousarray(lengths, np.int32)).to(self.device)
        return self._staged(lengths, "lengths")

    def map_chunk(self, packed, lengths, n_bases: int, n_invalid: int = 0,
                  strided: bool = False) -> None:
        """Fold one packed chunk into the count state.

        ``strided=True`` marks a buffer from ``pack_for_device(...,
        read_len=L)`` in the stride-padded layout (every read exactly
        ``config.read_len`` long): it takes the plane step. Continuous
        buffers take the ragged step, which reads ``lengths``: pass those of
        the chunk's ``n_reads`` reads (``lengths[:n_reads]``); zero padding
        after them gives the same counts but costs a scan of the padding."""
        self.n_invalid_bases += n_invalid
        if self._staging is not None:
            self._staging.copied = None
        with profiling.span(profiling.UPLOAD):
            words = self._words(packed)
        config, seed = self.config, self.index.table.seed
        if strided:
            if not config.read_len:
                raise ValueError("strided chunks need config.read_len")
            keys, n_valid = plane_chunk_keys(words, n_bases // config.read_len,
                                             config=config, seed=seed)
            count = None
        else:
            with profiling.span(profiling.UPLOAD):
                lengths = self._lengths(lengths, n_bases)
            keys, count = chunk_keys(words, lengths, n_bases, config=config, seed=seed,
                                     out=key_buffer(self._keys, words, config))
            n_valid = count[1]  # a device scalar: no sync
        if self._staging is not None:
            self._staging.passed()  # only the hash-key kernel read the slot
        stream_probe.stream_probe_count_keys(self.key_lo, self.key_hi, self.counts, keys,
                                             self.block_probe, count=count)
        self._stats.append(n_valid)

    def _hash_pieces(self, kmers):
        """uint64 hashes -> int64 tensors of the same bits on the device, one
        piece of at most HASH_PIECE hashes at a time; the words are split on
        the device, by the kernel."""
        kmers = np.ascontiguousarray(kmers, dtype=np.uint64).view(np.int64)
        for start in range(0, len(kmers), self.HASH_PIECE):
            yield torch.from_numpy(kmers[start : start + self.HASH_PIECE]).to(self.device)

    def map_hashes(self, kmers: np.ndarray) -> None:
        """Count pre-computed uint64 kmer hashes (the library calls
        ``map_kmers_to_graph_index`` and ``counter.count``): every piece
        through the gather probe, as the JAX package does off the TPU."""
        table = self.index.table
        for queries in self._hash_pieces(kmers):
            probe.probe_count(self.key_lo, self.key_hi, self.counts, queries,
                              table.max_probe, table.seed, block_probe=self.block_probe)
            self._stats.append(queries.shape[0])

    def in_index(self, kmers: np.ndarray) -> np.ndarray:
        """Membership per uint64 kmer hash, uint8[n], with no frequency
        filter (the reference's ``in_graph_index``), by the gather probe."""
        table = self.index.table
        out = [np.zeros(0, dtype=np.uint8)]
        for queries in self._hash_pieces(kmers):
            slots = probe.probe_slots(self.key_lo, self.key_hi, queries, table.max_probe,
                                      table.seed, block_probe=self.block_probe)
            out.append(slots.ge(0).to(torch.uint8).cpu().numpy())
        return np.concatenate(out)

    def reset_counts(self) -> None:
        """Zero the accumulated state, keeping the device-resident table."""
        self.counts.zero_()
        self._reset_totals()
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
            self._reset_totals(int(data["n_kmers"]))
            self.n_invalid_bases = int(data["n_invalid"])

    def slot_counts(self) -> np.ndarray:
        """uint32[n_slots] counts in slot order, on the host."""
        self._fold_stats()
        return self.counts.cpu().numpy().view(np.uint32)

    def node_counts(self, max_frequency: int = 1000) -> np.ndarray:
        """Final per-node hit counts, uint32[max_node_id + 1]: on CUDA the
        finalize kernel on the device counts, then one word a node read
        back (the entry arrays are uploaded on the first call and kept with
        the mapper); on the CPU the host ``KmerIndex.node_counts``."""
        if self.device.type == "cpu":
            return self.index.node_counts(self.slot_counts(), max_frequency=max_frequency)
        self._fold_stats()
        if self._entries is None:
            self._entries = self.index.device_entries(self.device)
        out = finalize.finalize(self.counts, *self._entries, max_frequency,
                                self.index.max_node_id + 1)
        return out.cpu().numpy().view(np.uint32)

    def kmer_counts(self) -> tuple[np.ndarray, np.ndarray]:
        """Counter view: (unique kmers, their counts)."""
        return self.index.kmer_counts(self.slot_counts())
