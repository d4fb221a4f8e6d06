"""End-to-end mapping: file -> framed, packed chunks -> device step -> node counts.

The torch counterpart of ``kmer_mapper_tpu/pipeline.py:map_file``. A host
thread reads, frames and packs fixed-shape buffers while the device maps the
previous one; the "reduce" is the device-resident count state.
"""
from __future__ import annotations

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
from .models.mapper import KmerMapper, MapperConfig

logger = logging.getLogger(__name__)

#: device buffer on CUDA, in bases (a 64 Mi-base buffer of 151 bp reads
#: holds ~53.8M k=31 windows)
CUDA_BUF = 64 << 20
#: smallest buffer on the CPU, where the buffer otherwise follows chunk_size
CPU_BUF_FLOOR = 1 << 16


def _producer(chunk_iter: Iterator, out_queue: queue.Queue, stop: threading.Event):
    try:
        for item in chunk_iter:
            while not stop.is_set():
                try:
                    out_queue.put(item, timeout=0.2)
                    break
                except queue.Full:
                    continue
            if stop.is_set():
                return
        out_queue.put(None)
    except BaseException as exc:  # re-raised on the consumer side
        out_queue.put(exc)


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
) -> np.ndarray:
    """Map all k-mers of a FASTA/FASTQ(.gz) file against the index on
    ``device``; returns the per-node hit counts (uint32[max_node_id+1])."""
    t_start = time.perf_counter()
    index = load_index(index)
    mapper, packed = make_mapper_and_chunks(
        index, reads_path, k=k, chunk_size=chunk_size,
        map_reverse_complements=map_reverse_complements, device=device,
    )
    t_map = time.perf_counter()
    n_chunks = 0
    for packed_codes, lengths, n_bases, _, n_invalid, strided in prefetch(
        packed, depth=queue_depth
    ):
        mapper.map_chunk(packed_codes, lengths, n_bases, n_invalid, strided=strided)
        n_chunks += 1
        if n_chunks % 200 == 0:
            logger.info("chunk %d", n_chunks)
    n_kmers = mapper.n_kmers_mapped  # waits for the last chunk's step
    logger.info(
        "Time spent only on hashing and counting hashes: %.4f",
        time.perf_counter() - t_map,
    )
    if mapper.n_invalid_bases:
        logger.warning(
            "%d invalid (non-ACGTN) bases were encoded as A", mapper.n_invalid_bases
        )
    slot_counts = mapper.slot_counts()
    node_counts = index.node_counts(slot_counts, max_frequency=max_frequency)
    n_hits = int(slot_counts.sum(dtype=np.uint64))
    logger.info(
        "Mapped %d kmers (%d index hits) from %d chunks on %s in %.3f sec total",
        n_kmers, n_hits, n_chunks, mapper.device, time.perf_counter() - t_start,
    )
    return node_counts


def make_mapper_and_chunks(
    index: KmerIndex,
    reads_path: str,
    k: int,
    chunk_size: int,
    map_reverse_complements: bool,
    device,
) -> tuple[KmerMapper, Iterable]:
    """The device mapper plus the packed host chunk iterator.

    The buffer is ``CUDA_BUF`` bases on CUDA whatever ``chunk_size`` says;
    on the CPU it follows ``chunk_size``. If the file's first records are
    uniform-length reads (the Illumina case), buffers arrive in the strided
    layout of the plane step; any buffer that is not uniform takes the
    ragged step with identical results."""
    device = torch.device(device)
    if device.type == "cuda":
        buf = CUDA_BUF
    else:
        buf = _round_up(min(max(chunk_size, CPU_BUF_FLOOR), CUDA_BUF), 1 << 13)

    def make_config(read_len):
        return MapperConfig(
            k=k, buf=buf, max_reads=max(1024, buf // 32),
            revcomp=map_reverse_complements, read_len=read_len,
        )

    rl_hint = _peek_read_len(reads_path, k)
    chunks = iter(packed_chunk_iterator(reads_path, make_config(rl_hint), chunk_size))
    first = next(chunks, None)
    mapper = KmerMapper(
        index, make_config(rl_hint or _detect_read_len(first, k)), device
    )
    if first is None:
        return mapper, iter(())
    return mapper, _strided_chunks(itertools.chain([first], chunks), mapper.config)


def _strided_chunks(packed_iter, config: MapperConfig):
    """Normalize packed chunks to 6-tuples (+ ``strided``), restriding
    continuous buffers of uniform ``read_len`` reads into the strided
    layout on the way."""
    rows = readers.strided_rows(config.buf, config.read_len) if config.read_len else 0
    for tup in packed_iter:
        if len(tup) == 6:  # pack_for_device(read_len=...) already decided
            yield tup
            continue
        packed, lengths, n_bases, n_reads, n_invalid = tup
        strided = bool(config.read_len) and _chunk_is_fixed(
            lengths, n_bases, config.read_len
        )
        if strided:
            packed = readers.restride_packed(
                packed, n_bases // config.read_len, config.read_len, rows
            )
        yield packed, lengths, n_bases, n_reads, n_invalid, strided


def _chunk_is_fixed(lengths, n_bases, read_len: int) -> bool:
    """True iff the chunk is exactly n whole reads of ``read_len``."""
    nb = int(n_bases)
    if nb % read_len:
        return False
    n = nb // read_len
    lengths = np.asarray(lengths)
    return bool(np.all(lengths[:n] == read_len)) and not np.any(lengths[n:])


def packed_chunk_iterator(reads_path: str, config: MapperConfig, chunk_size: int):
    """Framed and packed device buffers of a reads file (numpy framer)."""
    fmt = readers.detect_format(reads_path)
    stream = readers.open_bytes(reads_path)
    try:
        chunks = readers.read_chunks(stream, fmt=fmt, min_chunk_size=chunk_size)
        yield from readers.pack_for_device(
            chunks, config.buf, config.max_reads, config.k, read_len=config.read_len
        )
    finally:
        stream.close()


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
