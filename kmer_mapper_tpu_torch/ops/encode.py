"""2-bit encoding of ASCII bases: host packing, 16 bases per uint32 word,
and the device unpack and encode.

A copy of ``kmer_mapper_tpu/ops/encode.py`` (its jnp functions as torch).
N/n encode to A (code 0), as the reference substitutes N with A; other
invalid bytes are encoded as A and counted.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import oracle

BASES_PER_WORD = 16

_HOST_SHIFTS = (2 * np.arange(BASES_PER_WORD, dtype=np.uint32)).astype(np.uint32)
# tables of the device encode
_DEV_CODE = np.where(oracle.CODE_TABLE == oracle.INVALID_CODE, 0, oracle.CODE_TABLE).astype(
    np.uint8)
_DEV_INVALID = (oracle.CODE_TABLE == oracle.INVALID_CODE).astype(np.uint8)


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


def unpack_codes(packed: torch.Tensor) -> torch.Tensor:
    """int64-held uint32 words[w] -> int64 2-bit codes[w * 16] (device side)."""
    shifts = 2 * torch.arange(BASES_PER_WORD, dtype=torch.int64, device=packed.device)
    return ((packed[:, None] >> shifts[None, :]) & 3).reshape(-1)


def encode_bases(ascii_u8: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Device encode of uint8 ASCII bases: (codes 0..3, uint8 invalid flags)."""
    codes = torch.from_numpy(_DEV_CODE).to(ascii_u8.device)[ascii_u8.long()]
    invalid = torch.from_numpy(_DEV_INVALID).to(ascii_u8.device)[ascii_u8.long()]
    return codes.long(), invalid
