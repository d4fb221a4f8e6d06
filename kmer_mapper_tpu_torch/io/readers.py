"""Host-side chunked FASTA/FASTQ readers and the device-buffer packer.

A copy of the numpy paths of ``kmer_mapper_tpu/io/readers.py``: raw bytes
are read in blocks, records are framed with vectorized newline scans, and a
partial trailing record is carried into the next block. Gzip input is
decoded by the standard library's ``gzip`` module. Pinned bit-identical to
the original by ``tests/test_torch_pipeline.py``.
"""
from __future__ import annotations

import dataclasses
import gzip
import io
from typing import Iterator

import numpy as np

from ..ops.encode import host_encode_pack
from ..ops.hashing import read_stride

_NEWLINE = ord("\n")
_CR = ord("\r")
_FASTA_HEADER = ord(">")
_FASTQ_HEADER = ord("@")
_FASTQ_PLUS = ord("+")

FASTA_SUFFIXES = (".fa", ".fasta", ".fna")
FASTQ_SUFFIXES = (".fq", ".fastq")


@dataclasses.dataclass
class SequenceChunk:
    """A batch of framed reads: concatenated bases + per-read start offsets."""

    bases: np.ndarray  # uint8[n_bases]
    read_starts: np.ndarray  # int64[n_reads] offsets into bases

    @property
    def n_bases(self) -> int:
        return len(self.bases)

    @property
    def n_reads(self) -> int:
        return len(self.read_starts)

    @property
    def read_lengths(self) -> np.ndarray:
        if self.n_reads == 0:
            return np.zeros(0, dtype=np.int64)
        return np.diff(np.append(self.read_starts, self.n_bases))


def detect_format(path: str, peek: bytes | None = None) -> str:
    """'fasta' | 'fastq' from the suffix, else from the first byte."""
    name = path.lower()
    if name.endswith(".gz"):
        name = name[: -len(".gz")]
    for suffix in FASTA_SUFFIXES:
        if name.endswith(suffix):
            return "fasta"
    for suffix in FASTQ_SUFFIXES:
        if name.endswith(suffix):
            return "fastq"
    if peek:
        if peek[:1] == b">":
            return "fasta"
        if peek[:1] == b"@":
            return "fastq"
    raise ValueError(f"cannot determine sequence format of {path}")


def open_bytes(path: str) -> io.BufferedIOBase:
    """Binary stream of the (decompressed) file bytes."""
    if str(path).endswith(".gz"):
        return gzip.open(path, "rb")
    return open(path, "rb")


def _gather_ragged(buf: np.ndarray, starts: np.ndarray, lengths: np.ndarray) -> np.ndarray:
    """Concatenate buf[starts[i] : starts[i]+lengths[i]] without a Python loop."""
    total = int(lengths.sum())
    if total == 0:
        return np.zeros(0, dtype=np.uint8)
    out_starts = np.cumsum(lengths) - lengths
    idx = np.arange(total, dtype=np.int64) - np.repeat(out_starts, lengths) + np.repeat(
        starts, lengths
    )
    return buf[idx]


def _line_table(buf: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """(line_starts, line_ends) of complete (newline-terminated) lines;
    ends exclude the newline and any preceding carriage return."""
    nl = np.flatnonzero(buf == _NEWLINE)
    starts = np.empty(len(nl), dtype=np.int64)
    starts[0:1] = 0
    starts[1:] = nl[:-1] + 1
    ends = nl.copy()
    has_cr = (ends > 0) & (buf[np.maximum(ends - 1, 0)] == _CR)
    ends[has_cr] -= 1
    return starts, ends


def _empty_chunk() -> SequenceChunk:
    return SequenceChunk(np.zeros(0, np.uint8), np.zeros(0, np.int64))


class _FastaFramer:
    """Frames complete FASTA records (multi-line sequences supported). A
    record is complete when the next header (or EOF) is seen."""

    def frame(self, buf: np.ndarray, eof: bool) -> tuple[SequenceChunk, int]:
        if len(buf) == 0:
            return _empty_chunk(), 0
        true_len = len(buf)
        if eof and buf[-1] != _NEWLINE:
            buf = np.append(buf, np.uint8(_NEWLINE))  # final line may lack one
        starts, ends = _line_table(buf)
        if len(starts) == 0:
            return _empty_chunk(), 0
        is_header = buf[starts] == _FASTA_HEADER
        header_pos = np.flatnonzero(is_header)
        if len(header_pos) == 0:
            raise ValueError("FASTA block contains no record header ('>')")
        if header_pos[0] != 0 or starts[0] != 0:
            raise ValueError("FASTA input does not start with a record header")
        if eof:
            consume_line = len(starts)
            consumed_bytes = true_len
        else:
            consume_line = int(header_pos[-1])  # lines strictly before last header
            consumed_bytes = int(starts[consume_line])
            header_pos = header_pos[:-1]
        starts, ends, is_header = starts[:consume_line], ends[:consume_line], is_header[:consume_line]
        if len(starts) == 0:
            return _empty_chunk(), consumed_bytes
        # sequence lines belong to the most recent header
        seq_mask = ~is_header
        record_of_line = np.cumsum(is_header) - 1
        lengths = ends - starts
        seq_starts, seq_lens = starts[seq_mask], lengths[seq_mask]
        bases = _gather_ragged(buf, seq_starts, seq_lens)
        n_records = len(header_pos)
        per_record = np.bincount(record_of_line[seq_mask], weights=seq_lens, minlength=n_records)
        per_record = per_record.astype(np.int64)
        read_starts = np.cumsum(per_record) - per_record
        return SequenceChunk(bases, read_starts), consumed_bytes


class _FastqFramer:
    """Frames complete 4-line FASTQ records (header/sequence/plus/quality)."""

    def frame(self, buf: np.ndarray, eof: bool) -> tuple[SequenceChunk, int]:
        if len(buf) == 0:
            return _empty_chunk(), 0
        true_len = len(buf)
        if eof and buf[-1] != _NEWLINE:
            buf = np.append(buf, np.uint8(_NEWLINE))  # final line may lack one
        starts, ends = _line_table(buf)
        n_records = len(starts) // 4
        if eof and len(starts) % 4 != 0:
            raise ValueError("truncated FASTQ record at end of file")
        if n_records == 0:
            return _empty_chunk(), 0
        consume_line = n_records * 4
        if eof:
            consumed_bytes = true_len
        elif consume_line < len(starts):
            consumed_bytes = int(starts[consume_line])
        else:
            # all complete lines consumed; a partial trailing line (if any)
            # starts right after the last consumed newline and is carried
            nl = np.flatnonzero(buf == _NEWLINE)
            consumed_bytes = int(nl[consume_line - 1]) + 1
        head = starts[0 : consume_line : 4]
        plus = starts[2 : consume_line : 4]
        if not (buf[head] == _FASTQ_HEADER).all():
            raise ValueError("malformed FASTQ: record header does not start with '@'")
        if not (buf[plus] == _FASTQ_PLUS).all():
            raise ValueError("malformed FASTQ: separator line does not start with '+'")
        seq_starts = starts[1:consume_line:4]
        seq_lens = ends[1:consume_line:4] - seq_starts
        bases = _gather_ragged(buf, seq_starts, seq_lens)
        read_starts = np.cumsum(seq_lens) - seq_lens
        return SequenceChunk(bases, read_starts.astype(np.int64)), consumed_bytes


def framer_for(fmt: str):
    return _FastaFramer() if fmt == "fasta" else _FastqFramer()


def read_chunks(
    path_or_stream,
    fmt: str | None = None,
    min_chunk_size: int = 2_500_000,
) -> Iterator[SequenceChunk]:
    """Framed chunks of ~min_chunk_size bytes, with carry-over of partial
    records between blocks."""
    own = False
    if isinstance(path_or_stream, (str, bytes)) or hasattr(path_or_stream, "__fspath__"):
        stream = open_bytes(str(path_or_stream))
        fmt = fmt or detect_format(str(path_or_stream))
        own = True
    else:
        stream = path_or_stream
        assert fmt is not None, "fmt required for stream input"
    framer = framer_for(fmt)
    leftover = b""
    try:
        while True:
            block = stream.read(min_chunk_size)
            eof = not block
            data = leftover + block
            buf = np.frombuffer(data, dtype=np.uint8)
            chunk, consumed = framer.frame(buf, eof)
            leftover = data[consumed:]
            if chunk.n_reads:
                yield chunk
            if eof:
                if leftover.strip():
                    raise ValueError("trailing unframed data at end of file")
                return
    finally:
        if own:
            stream.close()


def split_long_reads(chunk: SequenceChunk, max_len: int, k: int) -> SequenceChunk:
    """Split reads longer than ``max_len`` into segments overlapping by k-1
    bases, so the set of k-mer windows is preserved exactly."""
    lengths = chunk.read_lengths
    if chunk.n_reads == 0 or int(lengths.max()) <= max_len:
        return chunk
    step = max_len - (k - 1)
    assert step > 0
    new_bases: list[np.ndarray] = []
    new_lengths: list[int] = []
    for s, ln in zip(chunk.read_starts, lengths):
        if ln <= max_len:
            new_bases.append(chunk.bases[s : s + ln])
            new_lengths.append(int(ln))
        else:
            for off in range(0, int(ln), step):
                seg = chunk.bases[s + off : s + min(off + max_len, int(ln))]
                new_bases.append(seg)
                new_lengths.append(len(seg))
                if off + max_len >= ln:
                    break
    starts = np.cumsum([0] + new_lengths[:-1]).astype(np.int64)
    return SequenceChunk(bases=np.concatenate(new_bases), read_starts=starts)


def strided_rows(max_bases: int, read_len: int) -> int:
    """Row capacity of the strided fixed-read-length layout: a buffer of
    ``max_bases`` holds at most this many reads of ``read_len``."""
    return max_bases // read_len


def restride_packed(
    packed: np.ndarray, n_reads: int, read_len: int, rows: int
) -> np.ndarray:
    """Continuous 2-bit packing -> the stride-padded layout of
    ``pack_for_device(read_len=...)``, bit-exactly: read r's bases start at
    bit ``2*read_len*r`` of the continuous stream and move to a word-aligned
    stride of ``read_stride(read_len)`` bases, padded with 'A' (code 0)."""
    stride = read_stride(read_len)
    npr = stride // 16
    R = int(n_reads)
    assert R <= rows
    out = np.zeros(rows * npr, dtype=np.uint32)
    if R == 0:
        return out
    base_bit = 2 * read_len * np.arange(R, dtype=np.int64)
    w0 = (base_bit >> 5)[:, None] + np.arange(npr, dtype=np.int64)[None, :]
    assert int(w0[-1, -1]) + 1 < packed.shape[0], "packed buffer too short"
    s = (base_bit & 31).astype(np.uint32)[:, None]
    a = packed[w0]
    b = packed[w0 + 1]
    words = (a >> s) | np.where(s == 0, np.uint32(0), b << (np.uint32(32) - s))
    # zero the pad bases of each read's last word so the result equals
    # packing 'A'-padded rows directly
    tail_bits = 2 * read_len - 32 * ((2 * read_len - 1) // 32)
    last = (2 * read_len - 1) // 32  # word (within the read) of the last base
    if last < npr:
        words[:, last] &= np.uint32(
            (1 << tail_bits) - 1 if tail_bits < 32 else 0xFFFFFFFF
        )
        words[:, last + 1 :] = 0
    out[: R * npr] = words.reshape(-1)
    return out


def pack_for_device(
    chunks: Iterator[SequenceChunk],
    max_bases: int,
    max_reads: int,
    k: int,
    read_len: int = 0,
) -> Iterator[tuple]:
    """Repack framed chunks into fixed-shape packed device buffers.

    Yields (packed_codes uint32[max_bases/16 + 2], read_lengths
    uint16[max_reads], n_bases, n_reads, n_invalid). Reads longer than
    min(65535, max_bases) are split with k-1 overlap.

    ``read_len > 0`` appends a sixth element ``strided: bool``. A buffer
    whose reads are all exactly ``read_len`` long is emitted in the strided
    layout: each read padded with 'A' to ``hashing.read_stride(read_len)``
    bases so that it starts word-aligned, ``strided_rows(max_bases,
    read_len)`` rows in all. Other buffers keep the continuous layout
    (``strided=False``) and take the ragged step."""
    max_read_len = min(65535, max_bases)
    out_words = max_bases // 16 + 2
    stride = read_stride(read_len) if read_len else 0
    pend_bases: list[np.ndarray] = []
    pend_lengths: list[np.ndarray] = []
    pend_nb = 0
    pend_nr = 0

    def emit():
        nonlocal pend_bases, pend_lengths, pend_nb, pend_nr
        flat = np.concatenate(pend_bases) if pend_bases else np.zeros(0, np.uint8)
        lengths = np.zeros(max_reads, dtype=np.uint16)
        if pend_lengths:
            lengths[:pend_nr] = np.concatenate(pend_lengths)
        strided = bool(
            read_len and pend_nr and np.all(lengths[:pend_nr] == read_len)
        )
        if strided:
            rows = np.full((pend_nr, stride), ord("A"), dtype=np.uint8)
            rows[:, :read_len] = flat.reshape(pend_nr, read_len)
            flat = rows.reshape(-1)
            n_words = strided_rows(max_bases, read_len) * (stride // 16)
        else:
            n_words = out_words
        packed, n_invalid = host_encode_pack(flat, n_words)
        out = (packed, lengths, pend_nb, pend_nr, n_invalid)
        pend_bases, pend_lengths, pend_nb, pend_nr = [], [], 0, 0
        return out + ((strided,) if read_len else ())

    for chunk in chunks:
        chunk = split_long_reads(chunk, max_read_len, k)
        offset = 0  # record index consumed within this chunk
        starts_all = chunk.read_starts
        lengths_all = chunk.read_lengths
        while offset < chunk.n_reads:
            space_b = max_bases - pend_nb
            space_r = max_reads - pend_nr
            if space_r == 0 or lengths_all[offset] > space_b:
                yield emit()
                continue
            # how many whole records fit
            cum = np.cumsum(lengths_all[offset:])
            n_fit = int(np.searchsorted(cum, space_b, side="right"))
            n_fit = min(n_fit, space_r)
            if n_fit == 0:
                yield emit()
                continue
            lo = int(starts_all[offset])
            hi = (
                int(starts_all[offset + n_fit])
                if offset + n_fit < chunk.n_reads
                else chunk.n_bases
            )
            pend_bases.append(chunk.bases[lo:hi])
            pend_lengths.append(lengths_all[offset : offset + n_fit].astype(np.uint16))
            pend_nb += hi - lo
            pend_nr += n_fit
            offset += n_fit
    if pend_nr:
        yield emit()
