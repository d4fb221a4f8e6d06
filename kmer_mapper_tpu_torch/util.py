"""Drop-in module path of ``kmer_mapper.util``.

The torch counterpart of ``kmer_mapper_tpu/util.py``: index resolution from
parsed arguments, k-mer hashes of a chunk of sequences, the file opener and
small helpers (``kmer_mapper/util.py``).
"""
from __future__ import annotations

import logging
import sys

import numpy as np

from . import oracle
from .index.kmer_index import KmerIndex, load_index
from .io.readers import open_bytes
from .tools import read_fasta, remap_array
from .utils.timing import log_memory_usage_now


def _get_kmer_index_from_args(args) -> KmerIndex:
    """Resolve the -i / -b / in-memory index arguments (``util.py:38-68``):
    an in-memory index on ``args.kmer_index``, else ``args.index_bundle``,
    else the ``-i`` path (every form ``load_index`` reads)."""
    kmer_index = getattr(args, "kmer_index", None)
    bundle = getattr(args, "index_bundle", None)
    if kmer_index is None and bundle is None:
        logging.error("Either a kmer index or an index bundle must be specified")
        sys.exit(1)
    return load_index(bundle if kmer_index is None else kmer_index)


def get_kmer_hashes_from_chunk_sequence(chunk_sequence, kmer_size: int) -> np.ndarray:
    """Flat uint64 k-mer hashes of ragged sequences, no window crossing a
    read boundary (``util.py:71-75``). Takes a list of str/bytes, or a
    (bases uint8 array, lengths array) pair in place of the reference's
    bionumpy ragged array."""
    if isinstance(chunk_sequence, tuple):
        bases, lengths = chunk_sequence
        codes = oracle.encode_bytes(np.asarray(bases, dtype=np.uint8))
        lengths = np.asarray(lengths)
    else:
        seqs = [s.encode() if isinstance(s, str) else bytes(s) for s in chunk_sequence]
        codes = oracle.encode_bytes(np.frombuffer(b"".join(seqs), dtype=np.uint8))
        lengths = np.array([len(s) for s in seqs])
    return oracle.kmer_hashes_ragged(codes, lengths, kmer_size)


def open_file(path: str):
    """A binary stream of the decompressed bytes of a FASTA/FASTQ(.gz) file
    (``util.py:78-101``; framing happens in the pipeline)."""
    return open_bytes(path)


__all__ = [
    "_get_kmer_index_from_args",
    "get_kmer_hashes_from_chunk_sequence",
    "open_file",
    "log_memory_usage_now",
    "read_fasta",
    "remap_array",
]
