"""Pure-numpy semantic core: the bit-exact specification the port is held to.

A copy of the parts of ``kmer_mapper_tpu/oracle.py`` that the mapping path,
the library calls and their checks use, pinned identical by
``tests/test_torch_layout.py`` and ``tests/test_torch_compat.py``.
Semantics follow the reference implementation (ivargr/kmer_mapper):

* 2-bit encoding A=0 C=1 G=2 T=3; ``N`` is read as ``A``.
* The k-mer hash puts base ``m`` of a window in bits ``[2m, 2m+1]`` (first
  base least significant).
* The bucketed-index probe counts one hit per index entry whose stored kmer
  equals the query and whose frequency is ``<= max_frequency``.
* The reverse complement of a code is ``3 - code``, in reversed base order.
* k-mers never cross read boundaries; reads shorter than k give none.
"""
from __future__ import annotations

import dataclasses

import numpy as np

INVALID_CODE = np.uint8(255)
ALPHABET = "ACGT"


def _make_code_table() -> np.ndarray:
    table = np.full(256, INVALID_CODE, dtype=np.uint8)
    for code, base in enumerate(ALPHABET):
        table[ord(base)] = code
        table[ord(base.lower())] = code
    table[ord("N")] = 0
    table[ord("n")] = 0
    return table


CODE_TABLE = _make_code_table()


def encode_bytes(ascii_bytes: np.ndarray, strict: bool = True) -> np.ndarray:
    """ASCII bases -> 2-bit codes (uint8). N/n become A (code 0); with
    ``strict`` any other invalid base raises."""
    ascii_bytes = np.asarray(ascii_bytes, dtype=np.uint8)
    codes = CODE_TABLE[ascii_bytes]
    if strict and (codes == INVALID_CODE).any():
        bad = ascii_bytes[codes == INVALID_CODE][:10]
        raise ValueError(f"invalid bases in input (bytes {bad.tolist()})")
    return codes


def encode_string(seq: str) -> np.ndarray:
    return encode_bytes(np.frombuffer(seq.encode(), dtype=np.uint8))


def decode_to_string(codes: np.ndarray) -> str:
    return "".join(ALPHABET[c] for c in np.asarray(codes))


def kmer_hashes(codes: np.ndarray, k: int) -> np.ndarray:
    """All k-mer hashes of one contiguous code sequence:
    ``hash[i] = sum_m codes[i+m] << 2m``."""
    codes = np.asarray(codes, dtype=np.uint64)
    n = len(codes)
    if n < k:
        return np.zeros(0, dtype=np.uint64)
    out = np.zeros(n - k + 1, dtype=np.uint64)
    for m in range(k):
        out |= codes[m : m + n - k + 1] << np.uint64(2 * m)
    return out


def kmer_hashes_convolve(codes: np.ndarray, k: int) -> np.ndarray:
    """The same hash by another route, a convolution of the reversed
    complement (the reference's test oracle, ``tests/test_hashing.py:11-27``).
    Used only in tests."""
    codes = np.asarray(codes, dtype=np.uint64)
    if len(codes) < k:
        return np.zeros(0, dtype=np.uint64)
    comp = (np.uint64(3) - codes)[::-1]  # reverse complement in ACGT code
    conv = np.convolve(comp, np.uint64(4) ** np.arange(k, dtype=np.uint64), mode="valid")
    rc_of_windows = conv[::-1]
    # complement each 2-bit field back to get the forward hash
    mask = np.uint64(4**k - 1)
    return (~rc_of_windows & mask) ^ np.uint64(0)


def kmer_hashes_ragged(flat_codes: np.ndarray, lengths: np.ndarray, k: int) -> np.ndarray:
    """K-mer hashes of concatenated ragged reads, in read order; windows
    never cross read boundaries."""
    flat_codes = np.asarray(flat_codes, dtype=np.uint8)
    lengths = np.asarray(lengths, dtype=np.int64)
    out = []
    start = 0
    for ln in lengths:
        out.append(kmer_hashes(flat_codes[start : start + ln], k))
        start += ln
    if not out:
        return np.zeros(0, dtype=np.uint64)
    return np.concatenate(out)


def revcomp_hash(hashes: np.ndarray, k: int) -> np.ndarray:
    """Reverse-complement hash: complement each 2-bit base (3-c) and reverse
    the base order within the k-window."""
    h = np.asarray(hashes, dtype=np.uint64)
    mask = np.uint64(4**k - 1) if k < 32 else np.uint64(0xFFFFFFFFFFFFFFFF)
    comp = ~h & mask
    rev = _reverse_2bit_fields_u64(comp)
    return rev >> np.uint64(64 - 2 * k)


def _reverse_2bit_fields_u64(x: np.ndarray) -> np.ndarray:
    """Reverse all 32 two-bit fields of each uint64."""
    x = x.astype(np.uint64)
    m2 = np.uint64(0x3333333333333333)
    m4 = np.uint64(0x0F0F0F0F0F0F0F0F)
    x = ((x >> np.uint64(2)) & m2) | ((x & m2) << np.uint64(2))
    x = ((x >> np.uint64(4)) & m4) | ((x & m4) << np.uint64(4))
    return x.byteswap()


@dataclasses.dataclass
class KmerIndexArrays:
    """The reference's ``graph_kmer_index.KmerIndex`` array layout: entries
    sorted by ``kmer % modulo``; ``hashes_to_index[h]`` is the bucket start,
    ``n_kmers[h]`` its length. A kmer may repeat with different nodes."""

    hashes_to_index: np.ndarray  # int32[modulo]
    n_kmers: np.ndarray  # int32[modulo]
    kmers: np.ndarray  # uint64[N]
    nodes: np.ndarray  # int32[N]
    frequencies: np.ndarray  # uint16[N]
    modulo: int

    def max_node_id(self) -> int:
        return int(self.nodes.max()) if len(self.nodes) else 0


def build_kmer_index(
    kmers: np.ndarray,
    nodes: np.ndarray,
    modulo: int,
    frequencies: np.ndarray | None = None,
) -> KmerIndexArrays:
    """Reference-layout bucketed index from flat (kmer, node) pairs. Without
    ``frequencies`` an entry's frequency is the number of entries sharing
    its kmer."""
    kmers = np.asarray(kmers, dtype=np.uint64)
    nodes = np.asarray(nodes, dtype=np.int32)
    h = kmers % np.uint64(modulo)
    order = np.argsort(h, kind="stable")
    kmers_s, nodes_s, h_s = kmers[order], nodes[order], h[order]
    if frequencies is None:
        _, inverse, counts = np.unique(kmers_s, return_inverse=True, return_counts=True)
        freq_s = np.minimum(counts[inverse], 65535).astype(np.uint16)
    else:
        freq_s = np.asarray(frequencies, dtype=np.uint16)[order]
    n_in_bucket = np.bincount(h_s.astype(np.int64), minlength=modulo).astype(np.int32)
    starts = np.zeros(modulo, dtype=np.int32)
    np.cumsum(n_in_bucket[:-1], out=starts[1:])
    return KmerIndexArrays(
        hashes_to_index=starts,
        n_kmers=n_in_bucket,
        kmers=kmers_s,
        nodes=nodes_s,
        frequencies=freq_s,
        modulo=int(modulo),
    )


def map_kmers_to_index(
    index: KmerIndexArrays,
    kmers: np.ndarray,
    max_node_id: int | None = None,
    max_frequency: int = 1000,
) -> np.ndarray:
    """Reference CPU probe: per query, scan its bucket; every entry with an
    equal kmer and frequency <= max_frequency adds one to its node.
    Returns uint32[max_node_id+1]."""
    if max_node_id is None:
        max_node_id = index.max_node_id()
    kmers = np.asarray(kmers, dtype=np.uint64)
    node_counts = np.zeros(max_node_id + 1, dtype=np.uint32)
    if len(kmers) == 0:
        return node_counts
    h = (kmers % np.uint64(index.modulo)).astype(np.int64)
    starts = index.hashes_to_index[h].astype(np.int64)
    lens = index.n_kmers[h].astype(np.int64)
    max_len = int(lens.max()) if len(lens) else 0
    for j in range(max_len):
        live = j < lens
        pos = starts[live] + j
        q = kmers[live]
        hit = (index.kmers[pos] == q) & (index.frequencies[pos] <= max_frequency)
        np.add.at(node_counts, index.nodes[pos[hit]], 1)
    return node_counts


def in_index(index: KmerIndexArrays, kmers: np.ndarray) -> np.ndarray:
    """Membership per query (``kmer_mapper/mapper.pyx:81-130``): True iff any
    bucket entry stores an equal kmer. No frequency filter. Returns uint8[len]."""
    kmers = np.asarray(kmers, dtype=np.uint64)
    out = np.zeros(len(kmers), dtype=np.uint8)
    if len(kmers) == 0:
        return out
    h = (kmers % np.uint64(index.modulo)).astype(np.int64)
    starts = index.hashes_to_index[h].astype(np.int64)
    lens = index.n_kmers[h].astype(np.int64)
    max_len = int(lens.max()) if len(lens) else 0
    for j in range(max_len):
        live = j < lens
        pos = starts[live] + j
        out[live] |= (index.kmers[pos] == kmers[live]).astype(np.uint8)
    return out


def count_unique_kmers(
    unique_kmers: np.ndarray, query_kmers: np.ndarray, counts: np.ndarray | None = None
) -> np.ndarray:
    """Counter semantics (npstructures.Counter / cucounter): count occurrences of
    each key of ``unique_kmers`` among ``query_kmers``, accumulating into
    ``counts``. Reference: ``kmer_mapper/gpu_counter.py`` and the
    CounterKmerIndex path (``command_line_interface.py:46-48``)."""
    unique_kmers = np.asarray(unique_kmers, dtype=np.uint64)
    if counts is None:
        counts = np.zeros(len(unique_kmers), dtype=np.uint32)
    if len(unique_kmers) == 0 or len(np.asarray(query_kmers)) == 0:
        return counts
    order = np.argsort(unique_kmers, kind="stable")
    sorted_keys = unique_kmers[order]
    pos = np.searchsorted(sorted_keys, query_kmers)
    pos = np.minimum(pos, len(sorted_keys) - 1)
    hit = sorted_keys[pos] == np.asarray(query_kmers, dtype=np.uint64)
    np.add.at(counts, order[pos[hit]], 1)
    return counts


def node_counts_from_kmer_counts(
    entry_kmers: np.ndarray,
    entry_nodes: np.ndarray,
    unique_kmers: np.ndarray,
    kmer_counts: np.ndarray,
    min_nodes: int = 0,
    entry_frequencies: np.ndarray | None = None,
    max_frequency: int | None = None,
) -> np.ndarray:
    """Distribute per-unique-kmer counts to all index entries carrying that kmer,
    then bincount by node (``kmer_mapper/gpu_counter.py:26-37``). With
    ``entry_frequencies``/``max_frequency`` also applies the CPU path's per-entry
    frequency filter, making the factorized result equal the CPU probe's."""
    order = np.argsort(unique_kmers, kind="stable")
    sorted_keys = unique_kmers[order]
    pos = np.searchsorted(sorted_keys, entry_kmers)
    pos = np.minimum(pos, len(sorted_keys) - 1)
    hit = sorted_keys[pos] == np.asarray(entry_kmers, dtype=np.uint64)
    weights = np.where(hit, kmer_counts[order[pos]], 0).astype(np.float64)
    if entry_frequencies is not None and max_frequency is not None:
        weights = np.where(entry_frequencies <= max_frequency, weights, 0.0)
    out = np.bincount(
        np.asarray(entry_nodes, dtype=np.int64), weights=weights, minlength=min_nodes + 1
    )
    return out.astype(np.uint32)
