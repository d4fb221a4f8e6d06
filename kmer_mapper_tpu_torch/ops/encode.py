"""Host 2-bit packing of ASCII bases, 16 bases per uint32 word.

A copy of ``kmer_mapper_tpu/ops/encode.py:host_encode_pack``. N/n encode
to A (code 0), as the reference substitutes N with A; other invalid bytes
are encoded as A and counted.
"""
from __future__ import annotations

import numpy as np

from .. import oracle

BASES_PER_WORD = 16

_HOST_SHIFTS = (2 * np.arange(BASES_PER_WORD, dtype=np.uint32)).astype(np.uint32)


def host_encode_pack(bases: np.ndarray, out_words: int) -> tuple[np.ndarray, int]:
    """ASCII bases -> (packed uint32[out_words], n_invalid). Base i sits in
    bits [2i, 2i+2) of word i // 16."""
    codes = oracle.CODE_TABLE[np.asarray(bases, dtype=np.uint8)]
    invalid = codes == oracle.INVALID_CODE
    n_invalid = int(invalid.sum())
    if n_invalid:
        codes = np.where(invalid, 0, codes)
    n = len(codes)
    assert n <= out_words * BASES_PER_WORD
    padded = np.zeros(out_words * BASES_PER_WORD, dtype=np.uint32)
    padded[:n] = codes
    packed = np.bitwise_or.reduce(
        padded.reshape(-1, BASES_PER_WORD) << _HOST_SHIFTS, axis=1
    ).astype(np.uint32)
    return packed, n_invalid
