"""The benchmark's data, made from seeds with plain torch operations on the
device the run uses: a genome, the entries of a KAGE-like k-mer index over
it, reads sampled from it, and those reads packed as the mapper takes them.

* The genome is a counter-based hash of the position: base ``p`` is two
  bits of ``mix32(mix32(p >> 4) ^ salt)``, so any window of it is made
  where it is needed and none is stored.
* The index holds the k-mers that start at ``n_kmers`` positions spread
  evenly over the genome, each jittered inside its own stretch, so the
  k-mers are as many as the configuration says and a read's k-mer hits at
  the share ``n_kmers / genome_length``. Node ``i * n_nodes // n_kmers``
  (neighbouring k-mers on one node, as a variant's k-mers are); a share of
  the entries carries a frequency above the mapper's ``max_frequency``
  (repeat k-mers that KAGE's filter drops).
* A read is a window of the genome at a start drawn from the run's seed.
  Every buffer holds the same multiset of read lengths (each length of the
  traffic's range equally often), in an order drawn from the seed, so every
  seed gives buffers of one size.
* Traffic mapped with ``-r`` (its ``revcomp``) is a sample sequenced from
  both strands: half the reads of a buffer, which ones drawn from the seed,
  come from the reverse strand, the reverse complement of their genome
  window (code ``3 - c``, the order reversed). Other traffic is read from
  the forward strand alone.
* The k-mer hash puts base ``m`` of a window in bits ``[2m, 2m + 2)``, the
  packed words base ``i`` in bits ``[2i, 2i + 2)`` of word ``i // 16``.

Nothing here imports the program under test.
"""
from __future__ import annotations

import dataclasses

import torch

M32 = 0xFFFFFFFF
BASES_PER_WORD = 16


def mul32(x, c: int):
    """``(x * c) mod 2**32`` for 32-bit values held in int64 (a tensor or an
    int), with no product past 2**63."""
    lo = (x & 0xFFFF) * c
    hi = (((x >> 16) * c) & 0xFFFF) << 16
    return (lo + hi) & M32


def mix32(x):
    """lowbias32 (C. Wellons' integer hash): a bijection of 32-bit values
    held in int64, a tensor or an int."""
    x = x ^ (x >> 16)
    x = mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def salt(seed: int, stream: int) -> int:
    """A 32-bit salt of ``seed`` for one use (``stream``)."""
    return mix32(mix32((seed ^ (seed >> 32)) & M32) ^ mix32(stream))


class Genome:
    """The genome of a configuration: ``length`` bases made from ``seed``."""

    def __init__(self, length: int, seed: int):
        if not 0 < length < 1 << 36:
            raise ValueError(f"genome length {length} outside (0, 2**36)")
        self.length = int(length)
        self._salt = salt(seed, 1)

    def codes(self, pos: torch.Tensor) -> torch.Tensor:
        """The 2-bit codes (int64, 0..3) of the bases at int64 positions."""
        word = mix32(mix32(pos >> 4) ^ self._salt)
        return (word >> ((pos & 15) << 1)) & 3


def window_hashes(codes: torch.Tensor, k: int) -> torch.Tensor:
    """The k-mer hashes of every window of the rows of ``codes`` (int64,
    (rows, length) or (length,)): base ``m`` of a window in bits
    ``[2m, 2m + 2)``. Shape (rows, length - k + 1), or (length - k + 1,)."""
    n = codes.shape[-1] - k + 1
    out = torch.zeros(codes.shape[:-1] + (max(n, 0),), dtype=torch.int64,
                      device=codes.device)
    for m in range(k):
        out |= codes[..., m:m + n] << (2 * m)
    return out


@dataclasses.dataclass
class Entries:
    """The index's entries: k-mer hash, node and frequency of each."""

    kmers: torch.Tensor  # int64 (62-bit hashes)
    nodes: torch.Tensor  # int64
    frequencies: torch.Tensor  # int64
    n_nodes: int


def index_entries(config: dict, device) -> Entries:
    """The entries of the configuration's index (see the module's text)."""
    n, k = int(config["n_kmers"]), int(config["k"])
    genome = Genome(config["genome_length"], config["seed"])
    span = genome.length - k + 1
    if not 0 < n <= span:
        raise ValueError(f"{n} k-mers in a genome of {span} windows")
    i = torch.arange(n, dtype=torch.int64, device=device)
    lo = i * span // n
    hi = (i + 1) * span // n
    pos = lo + ((mix32(i ^ salt(config["seed"], 2)) * (hi - lo)) >> 32)
    kmers = torch.zeros_like(pos)
    for m in range(k):  # a base at a time: the k-mers of a human index are 1 GB
        kmers |= genome.codes(pos + m) << (2 * m)
    del pos
    n_nodes = int(config["n_nodes"])
    nodes = i * n_nodes // n
    r = mix32(i ^ salt(config["seed"], 3))
    repeat = (r % 10000) < int(config["repeat_share_per_10000"])
    frequencies = torch.where(repeat, config["max_frequency"] + 1 + (r >> 16) % 9000,
                              torch.ones_like(r))
    return Entries(kmers, nodes, frequencies, n_nodes)


@dataclasses.dataclass
class Buffer:
    """One buffer of the pool: the reads' starts, lengths and strands, and
    the words (and for the continuous layout the int32 lengths) that the
    mapper takes."""

    starts: torch.Tensor  # int64, on the host
    lengths: torch.Tensor  # int64, on the host
    words: torch.Tensor  # int32, page-locked where the run is on the card
    read_lengths: torch.Tensor | None  # int32 (continuous layout), else None
    n_bases: int
    strided: bool
    n_windows: int  # valid k-mer windows
    reverse: torch.Tensor | None = None  # bool a read, on the host: from the reverse strand


def read_stride(read_len: int) -> int:
    """Bases a read takes in the stride-padded layout: a whole number of
    words, so that each read starts on a word."""
    return -(-read_len // BASES_PER_WORD) * BASES_PER_WORD


def length_multiset(lo: int, hi: int, buf: int) -> list[int]:
    """The read lengths of one buffer of ``buf`` bases: ``lo, lo + 1, ...,
    hi, lo, ...`` for as many reads as fit."""
    cycle = list(range(lo, hi + 1))
    full, rest = divmod(buf, sum(cycle))
    out = cycle * full
    for length in cycle:
        if length > rest:
            break
        out.append(length)
        rest -= length
    return out


def pack_words(codes: torch.Tensor, n_words: int) -> torch.Tensor:
    """2-bit codes (int64, flat) -> int32 words[n_words], base i in bits
    [2i, 2i + 2) of word i // 16, zero past the codes."""
    padded = torch.zeros(n_words * BASES_PER_WORD, dtype=torch.int64, device=codes.device)
    padded[:codes.shape[0]] = codes
    shifts = 2 * torch.arange(BASES_PER_WORD, dtype=torch.int64, device=codes.device)
    words = (padded.view(n_words, BASES_PER_WORD) << shifts).sum(1)
    return torch.where(words >= 1 << 31, words - (1 << 32), words).to(torch.int32)


def read_codes(genome: Genome, starts: torch.Tensor, lengths: torch.Tensor,
               strided: bool, reverse: torch.Tensor | None = None) -> torch.Tensor:
    """The codes of the reads: (reads, length) for one read length, else
    flat, the reads back to back. A read where ``reverse`` (bool a read) is
    set is the reverse complement of its genome window: its base ``j`` is
    ``3 - c`` of the window's base ``length - 1 - j``."""
    if strided:
        length = int(lengths[0])
        pos = starts[:, None] + torch.arange(length, device=starts.device)
        if reverse is None:
            return genome.codes(pos)
        flip, start, end = reverse[:, None], starts[:, None], starts[:, None] + length - 1
    else:
        first = torch.cumsum(lengths, 0) - lengths
        n_bases = int(lengths.sum())
        pos = torch.repeat_interleave(starts - first, lengths) + torch.arange(
            n_bases, device=starts.device)
        if reverse is None:
            return genome.codes(pos)
        flip = torch.repeat_interleave(reverse, lengths)
        start = torch.repeat_interleave(starts, lengths)
        end = start + torch.repeat_interleave(lengths, lengths) - 1
    codes = genome.codes(torch.where(flip, start + end - pos, pos))
    return torch.where(flip, 3 - codes, codes)


def draw_strands(traffic: dict, n_reads: int, generator: torch.Generator) -> torch.Tensor | None:
    """Which of ``n_reads`` reads come from the reverse strand: None where
    the traffic is not mapped with ``-r`` (no draw), else ``n_reads // 2``
    of them, which ones drawn with ``generator``."""
    if not traffic["revcomp"]:
        return None
    order = torch.randperm(n_reads, generator=generator, device=generator.device)
    return order < n_reads // 2


def make_buffer(genome: Genome, traffic: dict, k: int, buf: int, strided: bool,
                generator: torch.Generator, pinned: bool) -> Buffer:
    """One buffer of ``buf`` bases of the traffic's reads, drawn with
    ``generator`` on its device: the stride-padded layout of
    ``read_stride(read_len)`` bases a row (``buf // read_len`` rows) where
    ``strided``, else the continuous layout of ``buf // 16 + 2`` words. The
    draws: the order of the lengths (continuous layout), the starts, then,
    for traffic mapped with ``-r`` alone, the strands
    (:func:`draw_strands`), so that a forward buffer makes no draw more."""
    device = generator.device
    lo, hi = int(traffic["read_length_min"]), int(traffic["read_length_max"])
    if strided:
        if lo != hi:
            raise ValueError("the stride-padded layout needs one read length")
        lengths = torch.full((buf // lo,), lo, dtype=torch.int64, device=device)
    else:
        lengths = torch.tensor(length_multiset(lo, hi, buf), dtype=torch.int64, device=device)
        lengths = lengths[torch.randperm(lengths.shape[0], generator=generator, device=device)]
    room = (genome.length - lengths + 1).double()
    starts = (torch.rand(lengths.shape[0], dtype=torch.float64, generator=generator,
                         device=device) * room).long()
    reverse = draw_strands(traffic, lengths.shape[0], generator)
    codes = read_codes(genome, starts, lengths, strided, reverse)
    if strided:
        stride = read_stride(lo)
        rows = torch.zeros(codes.shape[0], stride, dtype=torch.int64, device=device)
        rows[:, :lo] = codes
        words = pack_words(rows.view(-1), codes.shape[0] * stride // BASES_PER_WORD)
    else:
        words = pack_words(codes, buf // BASES_PER_WORD + 2)
    del codes
    read_lengths = None if strided else lengths.to(torch.int32)
    if pinned:
        words = _pinned(words)
        read_lengths = None if read_lengths is None else _pinned(read_lengths)
    else:
        words = words.cpu()
        read_lengths = None if read_lengths is None else read_lengths.cpu()
    return Buffer(starts=starts.cpu(), lengths=lengths.cpu(), words=words,
                  read_lengths=read_lengths, n_bases=int(lengths.sum()), strided=strided,
                  n_windows=int((lengths - (k - 1)).clamp(min=0).sum()),
                  reverse=None if reverse is None else reverse.cpu())


def _pinned(x: torch.Tensor) -> torch.Tensor:
    out = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
    out.copy_(x)
    return out
