"""End-to-end mapping: file -> framed, packed chunks -> device step -> node counts.

The torch counterpart of ``kmer_mapper_tpu/pipeline.py``. Host threads read,
decode, frame and pack fixed-shape buffers (the native C++ loader, else the
numpy framer; ``reader_workers`` byte regions in parallel) while the device
maps the previous ones; the "reduce" is the device-resident count state. On
CUDA the producer stages each buffer in page-locked host memory, so the
upload in ``KmerMapper.map_chunk`` is asynchronous and the consumer thread
only enqueues work.
"""
from __future__ import annotations

import contextlib
import itertools
import logging
import queue
import threading
import time
from typing import Iterable, Iterator

import numpy as np
import torch

from .index.kmer_index import KmerIndex, load_index
from .io import readers
from .models.mapper import KmerMapper, MapperConfig, chunk_is_fixed
from .ops import stream_probe
from .ops.hashing import read_stride
from .utils import profiling
from .utils.timing import log_memory_usage_now, span

logger = logging.getLogger(__name__)

#: device buffer on CUDA, in bases (a 64 Mi-base buffer of 151 bp reads
#: holds ~53.8M k=31 windows)
CUDA_BUF = 64 << 20
#: device buffer on CUDA where a device's share of the table has
#: ``stream_probe.HUMAN_SCALE_BUCKETS`` buckets or more (:func:`device_buf`)
HUMAN_SCALE_BUF = 128 << 20
#: smallest buffer on the CPU, where the buffer otherwise follows chunk_size
CPU_BUF_FLOOR = 1 << 16


def _producer(chunk_iter: Iterator, out_queue: queue.Queue, stop: threading.Event):
    try:
        for item in chunk_iter:
            if not readers.put_unless_stopped(out_queue, item, stop):
                return
        readers.put_unless_stopped(out_queue, None, stop)
    except BaseException as exc:  # re-raised on the consumer side
        readers.put_unless_stopped(out_queue, exc, stop)


def prefetch(iterator: Iterator, depth: int = 4) -> Iterator:
    """Run an iterator in a background thread with bounded lookahead."""
    q: queue.Queue = queue.Queue(maxsize=depth)
    stop = threading.Event()
    thread = threading.Thread(target=_producer, args=(iterator, q, stop), daemon=True)
    thread.start()
    try:
        while True:
            item = q.get()
            if item is None:
                return
            if isinstance(item, BaseException):
                raise item
            yield item
    finally:
        stop.set()


class PinnedRing:
    """Page-locked host buffers that packed chunks are staged in on their way
    to the card: the packed words, and for a buffer that takes the ragged
    step the lengths of its reads as int32 (room for ``n_lengths``, pinned
    when the slot first takes a ragged buffer). A buffer goes back to the
    ring with a CUDA event recorded on ``device``'s current stream once the
    chunk's work (its uploads first) was enqueued there; the producer waits
    on that event before it writes the buffer again. The event goes on the
    mapper's device whatever the thread's current device is: one recorded
    elsewhere would complete before the upload it guards. The event is all
    that guards a slot: neither step reads anything back, so the host may
    queue several chunks ahead, and a slot's words and lengths stay
    unchanged until the stream has passed the chunk's uploads. The mapper
    reads the staged lengths on the host (their premise check) before it
    enqueues their upload."""

    def __init__(self, n_buffers: int, n_words: int, device: torch.device, *,
                 n_lengths: int):
        self.device = device
        self.n_lengths = n_lengths
        self._free: queue.Queue = queue.Queue()
        for _ in range(n_buffers):
            slot = [torch.empty(n_words, dtype=torch.int32, pin_memory=True), None]
            self._free.put((slot, None))

    def staged(self, packed_iter: Iterable) -> Iterator[tuple]:
        """(slot, chunk) pairs: each chunk (``_strided_chunks``' 6-tuples)
        with its packed words, and unless it is strided the lengths of its
        ``n_reads`` reads, copied into a free page-locked slot (those
        elements are then views of it). Runs in the producer thread."""
        for packed, lengths, n_bases, n_reads, n_invalid, strided in packed_iter:
            slot, event = self._free.get()
            if slot is None:  # closed
                return
            if event is not None:
                event.synchronize()
            words = slot[0][: len(packed)]
            words.numpy()[:] = packed.view(np.int32)
            if not strided:  # the ragged step reads the lengths
                if slot[1] is None:
                    slot[1] = torch.empty(self.n_lengths, dtype=torch.int32, pin_memory=True)
                staged_lengths = slot[1][:n_reads]
                staged_lengths.numpy()[:] = lengths[:n_reads]
                lengths = staged_lengths
            yield slot, (words, lengths, n_bases, n_reads, n_invalid, strided)

    def release(self, slot) -> None:
        """Return ``slot`` after its chunk's work was enqueued on the device's
        current stream. Runs in the consumer thread."""
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(self.device))
        self._free.put((slot, event))

    def close(self) -> None:
        """Wake a producer waiting for a buffer; it stops."""
        self._free.put((None, None))


def map_file(
    index: KmerIndex | str,
    reads_path: str,
    *,
    device,
    k: int = 31,
    chunk_size: int = 2_500_000,
    max_frequency: int = 1000,
    map_reverse_complements: bool = False,
    queue_depth: int = 4,
    strict_bases: bool = False,
    profile_dir: str | None = None,
    reader_workers: int = 1,
) -> np.ndarray:
    """Map all k-mers of a FASTA/FASTQ(.gz) file against the index on
    ``device``; returns the per-node hit counts (uint32[max_node_id+1]).

    With ``strict_bases`` any non-ACGTN base raises (the reference's
    bionumpy DNAEncoding does); by default such bases encode as A with a
    warning. ``profile_dir`` writes a ``torch.profiler`` trace of the
    mapping loop there: one ``map_chunk`` region per chunk, the stage spans
    inside it, and a ``kmt.feed_wait`` region for each wait on the host
    feed (``utils/profiling.py`` lists the spans).
    ``reader_workers`` frames an uncompressed file in that many byte regions
    in parallel (the reference's ``-t``; ``io/parallel_reader.py``).

    The run's figures (the buffer, chunks, bases, k-mers; the seconds of the
    index load, the device's start (a process's first CUDA call makes its
    context), the chain blocks' bounds on the host, the table upload, the
    mapping loop and its wait on the host feed) ride on the INFO record of
    the loop's timing line as ``record.figures``, and with the node counts'
    and the whole call's seconds added (``node_counts_s``, ``total_s``) on
    the last line's."""
    t_start = time.perf_counter()
    device = torch.device(device)
    index = load_index(index)
    load_s = time.perf_counter() - t_start
    mapper, packed, setup = make_mapper_and_chunks(
        index, reads_path, k=k, chunk_size=chunk_size,
        map_reverse_complements=map_reverse_complements, device=device,
        reader_workers=reader_workers,
    )
    logger.info("Index of %d k-mers in %d buckets loaded in %.3f s, its chain-block bounds "
                "in %.3f s; %s ready in %.3f s, the table on it in %.3f s; buffers of %d "
                "bases", index.n_unique, index.table.n_buckets, load_s, setup["bounds_s"],
                mapper.device, setup["init_s"], setup["upload_s"], mapper.config.buf)
    ring = None
    if device.type == "cuda":
        ring = PinnedRing(queue_depth + 2, _max_words(mapper.config), mapper.device,
                          n_lengths=mapper.config.max_reads)
        feed = ring.staged(packed)
    else:
        feed = ((None, chunk) for chunk in packed)
    n_chunks = n_bases_total = 0
    waited = 0.0
    chunks = prefetch(feed, depth=queue_depth)
    try:
        with profiling.trace(profile_dir) if profile_dir else contextlib.nullcontext():
            t_map = time.perf_counter()  # after the profiler started
            while True:
                t0 = time.perf_counter()
                with profiling.span(profiling.FEED_WAIT):
                    item = next(chunks, None)
                waited += time.perf_counter() - t0
                if item is None:
                    break
                slot, (packed_codes, lengths, n_bases, _, n_invalid, strided) = item
                if strict_bases and n_invalid:
                    raise ValueError(
                        f"{n_invalid} invalid (non-ACGTN) bases in input "
                        "(--strict-bases; the reference's DNAEncoding would raise too)"
                    )
                with profiling.span(profiling.MAP_CHUNK):
                    mapper.map_chunk(packed_codes, lengths, n_bases, n_invalid, strided=strided)
                if slot is not None:
                    ring.release(slot)
                n_chunks += 1
                n_bases_total += n_bases
                if n_chunks % 200 == 0:
                    logger.info("chunk %d", n_chunks)
            n_kmers = mapper.n_kmers_mapped  # waits for the last chunk's step
            if device.type == "cuda":
                torch.cuda.synchronize(mapper.device)
            map_s = time.perf_counter() - t_map  # before the trace is written
    finally:
        chunks.close()
        if ring is not None:
            ring.close()
    figures = dict(buf=mapper.config.buf, chunks=n_chunks, bases=n_bases_total,
                   kmers=n_kmers, load_s=load_s, **setup, map_s=map_s, queue_wait_s=waited)
    logger.info(
        "Time spent only on hashing and counting hashes: %.4f (waited %.4f on the "
        "host feed)", map_s, waited, extra={"figures": figures},
    )
    if mapper.n_invalid_bases:
        logger.warning(
            "%d invalid (non-ACGTN) bases were encoded as A", mapper.n_invalid_bases
        )
    t = time.perf_counter()
    with span("node count finalization", logging.INFO):
        node_counts = mapper.node_counts(max_frequency=max_frequency)
    figures = dict(figures, node_counts_s=time.perf_counter() - t)
    log_memory_usage_now("after mapping")
    n_hits = _index_hits(mapper.counts)
    figures["total_s"] = time.perf_counter() - t_start
    logger.info(
        "Mapped %d kmers (%d index hits) from %d chunks on %s in %.3f sec total",
        n_kmers, n_hits, n_chunks, mapper.device, figures["total_s"],
        extra={"figures": figures},
    )
    return node_counts


def _index_hits(counts: torch.Tensor) -> int:
    """The sum of uint32 slot counts held as int32 bits, taken on their
    device: the int32 sum plus 2**32 for each count at or past 2**31."""
    return int(counts.sum(dtype=torch.int64)) + (int(counts.lt(0).sum()) << 32)


def _max_words(config: MapperConfig) -> int:
    """Words of the largest packed buffer the config's chunks can have."""
    words = config.buf // 16 + 2
    if config.read_len:
        rows = readers.strided_rows(config.buf, config.read_len)
        words = max(words, rows * (read_stride(config.read_len) // 16))
    return words


def make_mapper_and_chunks(
    index: KmerIndex,
    reads_path: str,
    k: int,
    chunk_size: int,
    map_reverse_complements: bool,
    device,
    reader_workers: int = 1,
) -> tuple[KmerMapper, Iterable, dict]:
    """The device mapper, the packed host chunk iterator
    (:func:`config_and_chunks`) and the set-up's seconds: the device's start
    (``init_s``; a process's first CUDA call makes its context), the chain
    blocks' bounds on the host (``bounds_s``) and the table upload
    (``upload_s``)."""
    device = torch.device(device)
    config, chunks = config_and_chunks(reads_path, k, chunk_size, map_reverse_complements,
                                       device, reader_workers,
                                       n_buckets=index.table.n_buckets)
    t = time.perf_counter()
    if device.type == "cuda":
        torch.zeros(1, device=device)
        torch.cuda.synchronize(device)
    init_s = time.perf_counter() - t
    t = time.perf_counter()
    index.table.block_max_probe()  # kept by the table for the mapper
    bounds_s = time.perf_counter() - t
    t = time.perf_counter()
    mapper = KmerMapper(index, config, device)
    if device.type == "cuda":
        torch.cuda.synchronize(mapper.device)
    return mapper, chunks, dict(init_s=init_s, bounds_s=bounds_s,
                                upload_s=time.perf_counter() - t)


def device_buf(n_buckets: int, n_shards: int = 1) -> int:
    """The buffer on CUDA, in bases, for a table of ``n_buckets`` split over
    ``n_shards`` index shards: ``HUMAN_SCALE_BUF`` where a shard holds
    ``stream_probe.HUMAN_SCALE_BUCKETS`` buckets or more (a shard is at
    least one chain block), else ``CUDA_BUF``. Each chunk's count reads the
    shard's whole table once, so on a human-scale table a larger buffer
    spreads that read over more keys (JAX's ``_buf_floor`` gate)."""
    if max(128, n_buckets // max(1, n_shards)) >= stream_probe.HUMAN_SCALE_BUCKETS:
        return HUMAN_SCALE_BUF
    return CUDA_BUF


def buffer_bases(device: torch.device, chunk_size: int, n_buckets: int,
                 n_shards: int = 1) -> int:
    """The buffer, in bases, of a file mapped on ``device``: :func:`device_buf`
    on CUDA whatever ``chunk_size`` says; on the CPU ``chunk_size``, kept
    within [CPU_BUF_FLOOR, CUDA_BUF] and rounded up to 8 Ki."""
    if device.type == "cuda":
        return device_buf(n_buckets, n_shards)
    return _round_up(min(max(chunk_size, CPU_BUF_FLOOR), CUDA_BUF), 1 << 13)


def config_and_chunks(reads_path: str, k: int, chunk_size: int, map_reverse_complements: bool,
                      device: torch.device, reader_workers: int = 1, *, n_buckets: int,
                      n_shards: int = 1) -> tuple[MapperConfig, Iterable]:
    """The mapper's config and the file's packed host chunks (6-tuples,
    :func:`_strided_chunks`) for a table of ``n_buckets`` over ``n_shards``
    index shards, in buffers of :func:`buffer_bases`. If the file's first
    records are uniform-length reads (the Illumina case), buffers arrive in
    the strided layout of the plane step; any buffer that is not uniform
    takes the ragged step with identical results."""
    buf = buffer_bases(device, chunk_size, n_buckets, n_shards)

    def make_config(read_len):
        return MapperConfig(
            k=k, buf=buf, max_reads=max(1024, buf // 32),
            revcomp=map_reverse_complements, read_len=read_len,
        )

    rl_hint = _peek_read_len(reads_path, k)
    chunks = iter(packed_chunk_iterator(
        reads_path, make_config(rl_hint), chunk_size, reader_workers
    ))
    first = next(chunks, None)
    config = make_config(rl_hint or _detect_read_len(first, k))
    if first is None:
        return config, iter(())
    return config, _strided_chunks(itertools.chain([first], chunks), config)


def _strided_chunks(packed_iter, config: MapperConfig):
    """Normalize packed chunks to 6-tuples (+ ``strided``), restriding
    continuous buffers of uniform ``read_len`` reads into the strided
    layout on the way."""
    rows = readers.strided_rows(config.buf, config.read_len) if config.read_len else 0
    for tup in packed_iter:
        if len(tup) == 6:  # the packer was given read_len and already decided
            yield tup
            continue
        packed, lengths, n_bases, n_reads, n_invalid = tup
        strided = bool(config.read_len) and chunk_is_fixed(
            lengths, n_bases, config.read_len
        )
        if strided:
            packed = readers.restride_packed(
                packed, n_bases // config.read_len, config.read_len, rows
            )
        yield packed, lengths, n_bases, n_reads, n_invalid, strided


def packed_chunk_iterator(
    reads_path: str, config: MapperConfig, chunk_size: int, reader_workers: int = 1
):
    """Framed and packed device buffers of a reads file: the native C++
    loader where it is available (``io/native.py``), else the numpy framer;
    both give the same buffers.

    ``reader_workers > 1`` frames an uncompressed file as up to that many
    byte regions in parallel (``io/parallel_reader.py``), each of at least
    two bytes per base of the device buffer, about one buffer of FASTQ:
    every region ends in a partly filled buffer, which costs the device a
    whole step, so a file of about one buffer stays one region. Chunk
    boundaries then
    differ from a sequential read's, but every buffer maps on its own and
    counts add, so node counts are the same. Gzipped input stays sequential
    (a gzip stream cannot seek; BGZF decodes on several cores anyway)."""
    from .io import native

    fmt = readers.detect_format(reads_path)

    def stream_iter(stream):
        if native.available():
            yield from native.pack_stream_native(
                stream, fmt, config.buf, config.max_reads, config.k,
                block_bytes=chunk_size, read_len=config.read_len,
            )
            return
        try:
            chunks = readers.read_chunks(stream, fmt=fmt, min_chunk_size=chunk_size)
            yield from readers.pack_for_device(
                chunks, config.buf, config.max_reads, config.k, read_len=config.read_len
            )
        finally:
            stream.close()

    if reader_workers > 1 and not str(reads_path).endswith(".gz"):
        from .io import parallel_reader

        return parallel_reader.parallel_packed_iterator(
            reads_path, fmt,
            lambda region: stream_iter(parallel_reader.RangeReader(reads_path, *region)),
            reader_workers,
            min_region=2 * config.buf,
        )
    return stream_iter(readers.open_bytes(reads_path))


def map_file_sharded(
    index: KmerIndex | str,
    reads_path: str,
    *,
    k: int = 31,
    chunk_size: int = 2_500_000,
    max_frequency: int = 1000,
    map_reverse_complements: bool = False,
    index_parallel: int = 1,
    n_devices: int | None = None,
    devices=None,
    queue_depth: int = 4,
    strict_bases: bool = False,
    profile_dir: str | None = None,
    reader_workers: int = 1,
) -> np.ndarray:
    """Map a reads file over a (data, index) grid of devices
    (``parallel.make_mesh(n_devices, index_parallel, devices)``; by default
    every CUDA device): chunks fan out over the data rows, the table is
    sharded over the index columns, and the counts are combined on the
    devices at the node-count finalize (in a ``torch.distributed`` process
    group, across the processes too). Returns uint32[max_node_id + 1].
    ``strict_bases``, ``profile_dir`` and ``reader_workers`` as in
    :func:`map_file`; the buffer is :func:`device_buf` of an index shard.
    The buffers are uploaded from pageable host memory, one chunk a data
    row at a time. The timing line's record carries the buffer, chunks,
    k-mers and loop seconds as ``record.figures``."""
    from .parallel import ShardedKmerMapper, make_mesh

    t_start = time.perf_counter()
    index = load_index(index)
    mesh = make_mesh(n_devices=n_devices, index_parallel=index_parallel, devices=devices)
    devices = {dev for row in mesh.devices for dev in row}
    config, chunks = config_and_chunks(
        reads_path, k, chunk_size, map_reverse_complements, mesh.devices[0][0], reader_workers,
        n_buckets=index.table.n_buckets, n_shards=index_parallel,
    )
    mapper = ShardedKmerMapper(index, config, mesh)
    n_chunks = 0
    batches = prefetch(_groups(chunks, mapper.n_data), depth=queue_depth)
    try:
        with profiling.trace(profile_dir) if profile_dir else contextlib.nullcontext():
            t_map = time.perf_counter()
            for batch in batches:
                rows = []
                for packed, lengths, n_bases, n_reads, n_invalid, strided in batch:
                    if strict_bases and n_invalid:
                        raise ValueError(
                            f"{n_invalid} invalid (non-ACGTN) bases in input "
                            "(--strict-bases; the reference's DNAEncoding would raise too)"
                        )
                    rows.append((packed, None if strided else lengths[:n_reads], n_bases,
                                 n_invalid, strided))
                mapper.map_chunks(rows)
                n_chunks += len(rows)
            n_kmers = mapper.n_kmers_mapped
            for dev in devices:
                if dev.type == "cuda":
                    torch.cuda.synchronize(dev)
            map_s = time.perf_counter() - t_map
    finally:
        batches.close()
    logger.info("Mapped %d kmers in %d chunks of %d-base buffers over the grid %s in %.3f "
                "sec (loop %.4f s)", n_kmers, n_chunks, config.buf, mesh.shape,
                time.perf_counter() - t_start, map_s,
                extra={"figures": dict(buf=config.buf, chunks=n_chunks, kmers=n_kmers,
                                       map_s=map_s)})
    if mapper.n_invalid_bases:
        logger.warning(
            "%d invalid (non-ACGTN) bases were encoded as A", mapper.n_invalid_bases
        )
    with span("node count finalization", logging.INFO):
        return mapper.node_counts(max_frequency=max_frequency)


def _groups(items: Iterable, n: int) -> Iterator[list]:
    """Lists of ``n`` consecutive items, the last one shorter."""
    items = iter(items)
    while group := list(itertools.islice(items, n)):
        yield group


def map_sequences(
    index: KmerIndex | str,
    sequences: list[str],
    k: int = 31,
    max_frequency: int = 1000,
    *,
    device,
    revcomp: bool = False,
) -> np.ndarray:
    """Map in-memory sequences on ``device``; returns the per-node hit counts
    (``kmer_mapper_tpu.pipeline.map_sequences``)."""
    index = load_index(index)
    flat = "".join(sequences)
    chunk = readers.SequenceChunk(
        bases=np.frombuffer(flat.encode(), dtype=np.uint8),
        read_starts=np.cumsum([0] + [len(s) for s in sequences[:-1]]).astype(np.int64),
    )
    buf = _round_up(max(len(flat), 1 << 10), 1 << 10)
    config = MapperConfig(k=k, buf=buf, max_reads=max(16, len(sequences)), revcomp=revcomp)
    mapper = KmerMapper(index, config, device)
    for packed, lengths, n_bases, n_reads, n_invalid in readers.pack_for_device(
        iter([chunk]), config.buf, config.max_reads, config.k
    ):
        mapper.map_chunk(packed, lengths[:n_reads], n_bases, n_invalid)
    return mapper.node_counts(max_frequency=max_frequency)


def _detect_read_len(first_chunk, k: int) -> int:
    """Uniform read length of a packed chunk (0 if ragged, empty or < k)."""
    if first_chunk is None:
        return 0
    _, lengths, n_bases, n_reads, _ = first_chunk[:5]
    L = int(lengths[0]) if n_reads else 0
    if L >= k and n_bases == n_reads * L and np.all(lengths[:n_reads] == L):
        return L
    return 0


def _peek_read_len(reads_path: str, k: int, peek_bytes: int = 512 << 10) -> int:
    """Uniform read length of the file's first records (0 if ragged, empty,
    unreadable or shorter than k), so the packer emits the strided layout
    from the first buffer on."""
    try:
        stream = readers.open_bytes(reads_path)
        try:
            block = stream.read(peek_bytes)
        finally:
            stream.close()
        fmt = readers.detect_format(reads_path, peek=block[:1])
        chunk, _ = readers.framer_for(fmt).frame(
            np.frombuffer(block, dtype=np.uint8), eof=len(block) < peek_bytes
        )
    except (OSError, ValueError):
        return 0
    if chunk.n_reads == 0:
        return 0
    lengths = chunk.read_lengths
    L = int(lengths[0])
    return L if L >= k and np.all(lengths == L) else 0


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m
