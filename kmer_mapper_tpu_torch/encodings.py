"""Legacy 2-bit codec — import-surface parity with the reference's
``kmer_mapper/encodings.py`` (112 LoC, NOT used by the reference's live CLI
path either; kept because it is importable as ``kmer_mapper.encodings`` and
documents the legacy bit convention). The port's copy of
``kmer_mapper_tpu/encodings.py``, held equal to it by
``tests/test_torch_cli_surface.py``.

Semantics pinned by the reference (`encodings.py:25-112`):

* Legacy base codes A=0, C=1, T=2, G=3 (``letters``/``bitcodes``,
  `encodings.py:26-28`) — NOT the live path's bionumpy convention
  (A=0 C=1 G=2 T=3, see ``oracle.py``); the two never mix.
* Packing is 4 bases per byte, first base in the least-significant 2 bits;
  input length must be a multiple of 4 (`encodings.py:53`); case-insensitive
  (`& 31`, `encodings.py:54`).
* ``complement`` XORs the packed bytes with 0b10101010 (A<->T, C<->G in the
  legacy code, `encodings.py:45-48`).
* ``to_bytes`` emits lowercase ASCII (`encodings.py:70-75`).
* ``twobit_swap`` reverses the 2-bit groups of each integer — the packed-kmer
  reversal used for reverse complements (`encodings.py:104-112`).

The implementation here is an independent numpy formulation (direct
byte->code lookup + shift/OR reduction, no 2-byte lookup tables); tests pin
it against the reference's declared bit tables.
"""
from __future__ import annotations

import numpy as np

_CODE_OF_BYTE = np.zeros(256, dtype=np.uint8)
for _ch, _code in zip(b"ACTG", range(4)):
    _CODE_OF_BYTE[_ch] = _code
    _CODE_OF_BYTE[_ch + 32] = _code  # lowercase
_LOWER_OF_CODE = np.frombuffer(b"actg", dtype=np.uint8)
_SHIFTS = np.uint8(2) * np.arange(4, dtype=np.uint8)


class BaseEncoding:
    """Plain ASCII bytes (`encodings.py:4-23`)."""

    @classmethod
    def from_string(cls, sequence: str) -> np.ndarray:
        return np.frombuffer(sequence.encode(), dtype=np.uint8).copy()

    @classmethod
    def from_bytes(cls, sequence: np.ndarray) -> np.ndarray:
        return sequence

    @classmethod
    def to_bytes(cls, sequence: np.ndarray) -> np.ndarray:
        return sequence

    @classmethod
    def to_string(cls, byte_sequence: np.ndarray) -> str:
        return bytes(np.asarray(byte_sequence, dtype=np.uint8)).decode()


class ACTGTwoBitEncoding:
    """Legacy packed 2-bit codec, 4 bases/byte LSB-first (`encodings.py:25-75`)."""

    letters = ["A", "C", "T", "G"]
    bitcodes = ["00", "01", "10", "11"]

    @classmethod
    def from_bytes(cls, sequence: np.ndarray) -> np.ndarray:
        sequence = np.asarray(sequence, dtype=np.uint8)
        assert sequence.size % 4 == 0, sequence.size
        codes = _CODE_OF_BYTE[sequence & 31 | 64]  # case-fold like `& 31`
        return np.bitwise_or.reduce(
            codes.reshape(-1, 4) << _SHIFTS, axis=-1
        ).astype(np.uint8)

    @classmethod
    def from_string(cls, string: str) -> np.ndarray:
        return cls.from_bytes(np.frombuffer(string.encode(), dtype=np.uint8))

    @classmethod
    def to_bytes(cls, sequence: np.ndarray) -> np.ndarray:
        sequence = np.asarray(sequence, dtype=np.uint8)
        codes = (sequence[:, None] >> _SHIFTS) & np.uint8(3)
        return _LOWER_OF_CODE[codes.reshape(-1)]

    @classmethod
    def to_string(cls, bits: np.ndarray) -> str:
        return bytes(cls.to_bytes(bits)).decode()

    @classmethod
    def complement(cls, char: np.ndarray) -> np.ndarray:
        """XOR 0b10101010 on the packed bytes: A<->T, C<->G in the legacy
        code (`encodings.py:45-48`); works on any integer dtype view."""
        dtype = char.dtype
        return (char.view(np.uint8) ^ np.uint8(0b10101010)).view(dtype)


class SimpleEncoding(ACTGTwoBitEncoding):
    """Reference's alternate formulation of the same packing
    (`encodings.py:78-102`) — here literally the same implementation, since
    both produce identical bytes (the reference's tests relied on that)."""


def twobit_swap(number: np.ndarray) -> np.ndarray:
    """Reverse the 2-bit groups of each integer (`encodings.py:104-112`):
    the packed-kmer reversal step of a reverse complement. Independent
    formulation: swap 2-bit pairs within bytes by shift/mask, then reverse
    byte order with ``byteswap``."""
    number = np.asarray(number)
    b = number.view(np.uint8)
    b = ((b & 0x03) << 6) | ((b & 0x0C) << 2) | ((b & 0x30) >> 2) | ((b & 0xC0) >> 6)
    return b.view(number.dtype).byteswap()
