"""Small data utilities (reference parity: ``shuffle_fasta.py``, the
``read_fasta``/``remap_array`` helpers of ``kmer_mapper/util.py:17-29``).
The port's copy of ``kmer_mapper_tpu/tools.py``, held equal to it by
``tests/test_torch_cli_surface.py``."""
from __future__ import annotations

import random

import numpy as np

from .io import readers


def read_fasta(file_name: str):
    """Yield raw sequence lines of a FASTA file (``util.py:17-23`` parity)."""
    with open(file_name, "rb") as f:
        for line in f:
            if line[:1] != b">":
                yield line


def remap_array(array: np.ndarray, from_values, to_values) -> np.ndarray:
    """Map values of ``array`` through a (from -> to) table
    (``util.py:27-29`` parity)."""
    index = np.digitize(array.ravel(), from_values, right=True)
    return np.asarray(to_values)[index].reshape(np.asarray(array).shape)


def shuffle_fasta(in_path: str, out_path: str, seed: int | None = None) -> int:
    """Write a record-shuffled copy of a FASTA file; returns record count."""
    records: list[tuple[int, str]] = []
    i = 0
    for chunk in readers.read_chunks(in_path, fmt="fasta"):
        ends = np.append(chunk.read_starts[1:], chunk.n_bases)
        for s, e in zip(chunk.read_starts, ends):
            records.append((i, bytes(chunk.bases[s:e]).decode()))
            i += 1
    rng = random.Random(seed)
    rng.shuffle(records)
    with open(out_path, "w") as f:
        for idx, seq in records:
            f.write(f">{idx}\n{seq}\n")
    return len(records)
