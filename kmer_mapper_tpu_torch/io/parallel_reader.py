"""Byte-region-parallel framing: the ``-t`` workers of the file path.

The torch counterpart of ``kmer_mapper_tpu/io/parallel_reader.py``. The
reference parallelises its pipeline with a process pool fed through shared
memory (``kmer_mapper/command_line_interface.py:124-130``, ``-t``). Here the
device does the counting, and ``-t`` sets how many host threads frame and
pack:

* An uncompressed FASTA/FASTQ file is split into ``n_workers`` byte regions,
  each starting exactly at a record boundary (:func:`split_regions`).
* Each worker runs the ordinary frame+pack iterator (the native C++ loader or
  the numpy framer, whichever ``pipeline.packed_chunk_iterator`` uses) over
  its own region and puts finished buffers into one bounded queue. The
  native frame+pack call releases the interpreter lock, so the threads
  scale across cores.
* Buffers come out in completion order. Chunk boundaries differ from a
  sequential read's (each region packs greedily from its own start), but
  every buffer maps on its own and counts add, so node counts equal a
  sequential run's (tests hold them equal).

Gzipped input stays sequential (a gzip stream cannot seek; BGZF already
decodes on several cores in ``io/gzio.py``). Each worker holds its own
framing window (about three buffers' worth of bytes for the native loader),
so host memory grows with ``n_workers``; the CLI caps them at the core count.

Record starts: FASTA records start at ``\\n>``. In FASTQ a quality line may
begin with ``@``, so a candidate ``\\n@`` counts only where the 4-line record
pattern holds from it (header ``@``, separator ``+``, quality as long as the
sequence), the usual splitter rule (bwa, seqkit). A wrong split cannot
corrupt counts silently: the worker's framer raises on the malformed record.
"""
from __future__ import annotations

import io
import logging
import os
import queue
import threading
from typing import Iterator

from .readers import put_unless_stopped

logger = logging.getLogger(__name__)

_PROBE = 1 << 16
#: give up splitting at a target offset after scanning this many bytes
#: without a provable record start (the region merges into the previous one)
_PROBE_BOUND = 1 << 26


def _strip_cr(line: bytes) -> bytes:
    return line[:-1] if line.endswith(b"\r") else line


def _fastq_record_at(lines: list[bytes], i: int) -> bool:
    """Do lines[i:i+4] look like a complete FASTQ record (header '@',
    separator '+', quality as long as the sequence)?"""
    if i + 3 >= len(lines):
        return False
    head, seq, plus, qual = lines[i : i + 4]
    return (
        head.startswith(b"@")
        and plus.startswith(b"+")
        and not seq.startswith(b"+")
        and len(_strip_cr(qual)) == len(_strip_cr(seq))
    )


def _find_record_start(chunk: bytes, fmt: str, at_file_start: bool) -> int | None:
    """Offset of the first record start in ``chunk``, or None where it holds
    no provable record start (the caller reads further). ``at_file_start``
    lets offset 0 count without a newline before it."""
    if fmt == "fasta":
        if at_file_start and chunk.startswith(b">"):
            return 0
        pos = chunk.find(b"\n>")
        return None if pos < 0 else pos + 1
    # FASTQ: the last split element is never a candidate, since without its
    # newline the pattern cannot be proven
    lines = chunk.split(b"\n")
    offset = 0
    for i, line in enumerate(lines[:-1]):
        if (
            line.startswith(b"@")
            and (i > 0 or at_file_start)
            and _fastq_record_at(lines, i)
        ):
            return offset
        offset += len(line) + 1
    return None


def split_regions(
    path: str, fmt: str, n_regions: int, min_region: int | None = None
) -> list[tuple[int, int]]:
    """Up to ``n_regions`` byte ranges of ``path``, each starting exactly at
    a record boundary; disjoint and together the whole file, so the regions'
    records are the file's. A file with less than ``min_region`` bytes per
    worker takes fewer regions."""
    size = os.path.getsize(path)
    if min_region is None:
        min_region = _PROBE  # read at call time so tests can shrink it
    n_regions = max(1, min(n_regions, max(1, size // min_region)))
    if n_regions == 1:
        return [(0, size)]
    starts = [0]
    with open(path, "rb") as f:
        for i in range(1, n_regions):
            target = size * i // n_regions
            if target <= starts[-1]:
                continue
            f.seek(target)
            probe = b""
            found = None
            while found is None:
                block = f.read(_PROBE)
                if not block:
                    break  # no record start before EOF: the tail joins the prior region
                probe += block
                found = _find_record_start(probe, fmt, at_file_start=False)
                # No record start within the bound (the target landed inside
                # a chromosome-sized FASTA record): skip this boundary, the
                # region merges into the previous worker's, later targets
                # still split
                if found is None and len(probe) > _PROBE_BOUND:
                    logger.debug(
                        "no record boundary within %d bytes after offset %d; "
                        "merging region", _PROBE_BOUND, target,
                    )
                    break
            if found is not None and target + found > starts[-1]:
                starts.append(target + found)
    starts.append(size)
    return [(starts[i], starts[i + 1]) for i in range(len(starts) - 1)]


class RangeReader(io.RawIOBase):
    """Sequential reads over one byte range of a file, on its own file
    descriptor, so workers never share a seek position."""

    def __init__(self, path: str, start: int, end: int):
        self._f = open(path, "rb")
        self._f.seek(start)
        self._left = end - start

    def read(self, n: int = -1) -> bytes:
        if self._left <= 0:
            return b""
        n = self._left if n is None or n < 0 else min(n, self._left)
        block = self._f.read(n)
        self._left -= len(block)
        return block

    def readinto(self, b) -> int:
        """Read into ``b`` without an intermediate bytes object (the native
        loader's window)."""
        if self._left <= 0:
            return 0
        view = memoryview(b).cast("B")
        n = self._f.readinto(view[: min(len(view), self._left)])
        self._left -= n
        return n

    def readable(self) -> bool:
        return True

    def close(self):
        try:
            self._f.close()
        finally:
            super().close()


def parallel_packed_iterator(
    reads_path: str,
    fmt: str,
    make_region_iter,
    n_workers: int,
    queue_depth: int = 2,
    min_region: int | None = None,
) -> Iterator[tuple]:
    """Run ``make_region_iter((start, end))``, an iterator of packed buffers,
    over each region in its own thread; yield the buffers in completion
    order. ``queue_depth`` bounds the finished buffers in flight per worker.
    A worker's error is raised to the caller."""
    regions = split_regions(reads_path, fmt, n_workers, min_region)
    if len(regions) == 1:
        yield from make_region_iter(regions[0])
        return
    out: queue.Queue = queue.Queue(maxsize=max(2, queue_depth * len(regions)))
    stop = threading.Event()
    done = object()

    def worker(region):
        try:
            for item in make_region_iter(region):
                if not put_unless_stopped(out, item, stop):
                    return
            put_unless_stopped(out, done, stop)
        except BaseException as exc:  # raised again on the consumer's side
            put_unless_stopped(out, exc, stop)

    threads = [threading.Thread(target=worker, args=(r,), daemon=True) for r in regions]
    for t in threads:
        t.start()
    live = len(threads)
    try:
        while live:
            item = out.get()
            if item is done:
                live -= 1
                continue
            if isinstance(item, BaseException):
                raise item
            yield item
    finally:
        stop.set()
