"""32-bit hash mixing for the host table build (numpy) and the device path (torch).

The table stores keys bijectively mixed by a 3-round Feistel network whose
round function is the murmur3 finalizer (fmix32); the bucket id is the high
bits of the mixed low word. The numpy half is a copy of
``kmer_mapper_tpu/ops/u32hash.py`` (pinned bit-identical by
``tests/test_torch_u32hash.py``). The torch half carries each 32-bit word in
an int64 tensor with a value in ``[0, 2**32)``, because torch's uint32 lacks
shifts and comparisons.
"""
from __future__ import annotations

import numpy as np
import torch

_C1 = 0x85EBCA6B
_C2 = 0xC2B2AE35
_GOLDEN = 0x9E3779B9
#: Feistel round constants (arbitrary odd words; one per round)
_FEISTEL_ROUNDS = (0x9E3779B9, 0x85EBCA6B, 0xC2B2AE35)
MASK32 = 0xFFFFFFFF


def fmix32(x: np.ndarray) -> np.ndarray:
    """murmur3 finalizer on a uint32 array."""
    u = np.uint32
    if isinstance(x, np.ndarray) and x.size > 1024:
        # allocation-lean path (same arithmetic bit for bit): the plain
        # expression chain allocates 5 full temporaries, which dominates the
        # index build's mix stage at tens of millions of keys
        y = x >> u(16)
        np.bitwise_xor(x, y, out=y)
        np.multiply(y, u(_C1), out=y)
        t = y >> u(13)
        np.bitwise_xor(y, t, out=t)
        np.multiply(t, u(_C2), out=t)
        np.right_shift(t, u(16), out=y)
        np.bitwise_xor(t, y, out=y)
        return y
    x = x ^ (x >> u(16))
    x = x * u(_C1)
    x = x ^ (x >> u(13))
    x = x * u(_C2)
    x = x ^ (x >> u(16))
    return x


def feistel_mix(lo, hi, seed: int = 0):
    """Bijective 64-bit mix of uint32 (lo, hi) -> (m_lo, m_hi)."""
    L, R = lo, hi
    for c in _FEISTEL_ROUNDS:
        k = np.uint32((c + seed) & MASK32)
        L, R = R, L ^ fmix32(R ^ k)
    return L, R


def feistel_unmix(m_lo, m_hi, seed: int = 0):
    """Inverse of :func:`feistel_mix` (host side: the counter view)."""
    L, R = m_lo, m_hi
    for c in reversed(_FEISTEL_ROUNDS):
        k = np.uint32((c + seed) & MASK32)
        L, R = R ^ fmix32(L ^ k), L
    return L, R


def mix64(lo, hi, seed: int = 0):
    """Avalanche-mix a 64-bit value given as uint32 (lo, hi) -> uint32."""
    h = fmix32(hi ^ np.uint32((_GOLDEN + seed) & MASK32))
    return fmix32(lo ^ h)


def bucket_shift(n_buckets: int) -> int:
    """``m_lo >> bucket_shift(n)`` is the bucket id (32 for one bucket)."""
    assert n_buckets & (n_buckets - 1) == 0, "n_buckets must be a power of two"
    return 32 - (n_buckets - 1).bit_length() if n_buckets > 1 else 32


def bucket_from_mlo(m_lo, n_buckets: int):
    """Bucket id from a mixed uint32 low word (a single-bucket table would
    shift by 32, which C leaves undefined: every id is 0 instead)."""
    shift = bucket_shift(n_buckets)
    if shift >= 32:
        return np.uint32(0) * m_lo
    return m_lo >> np.uint32(shift)


def bucket_of(lo, hi, n_buckets: int, seed: int = 0):
    """Bucket id in [0, n_buckets) of uint32 (lo, hi); n_buckets must be a
    power of two."""
    return bucket_from_mlo(feistel_mix(lo, hi, seed)[0], n_buckets)


def split_u64(kmers: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """uint64 kmers -> (lo, hi) uint32 word pair."""
    k = np.asarray(kmers, dtype=np.uint64)
    lo = (k & np.uint64(MASK32)).astype(np.uint32)
    hi = (k >> np.uint64(32)).astype(np.uint32)
    return lo, hi


def join_u64(lo: np.ndarray, hi: np.ndarray) -> np.ndarray:
    """(lo, hi) uint32 word pair -> uint64."""
    return np.asarray(lo, dtype=np.uint64) | (np.asarray(hi, dtype=np.uint64) << np.uint64(32))


# --- torch half: 32-bit words held in int64 -----------------------------------


def _mul32_torch(x: torch.Tensor, c: int) -> torch.Tensor:
    """Low word of ``x * c`` for x in [0, 2**32): the full product can pass
    2**63, so multiply by the constant's 16-bit halves, which stays below
    2**49 and never overflows int64."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & MASK32


def fmix32_torch(x: torch.Tensor) -> torch.Tensor:
    """murmur3 finalizer on int64-held 32-bit words (bit-identical to
    :func:`fmix32`)."""
    x = x ^ (x >> 16)
    x = _mul32_torch(x, _C1)
    x = x ^ (x >> 13)
    x = _mul32_torch(x, _C2)
    return x ^ (x >> 16)


def feistel_mix_torch(lo: torch.Tensor, hi: torch.Tensor, seed: int = 0):
    """:func:`feistel_mix` on int64-held words."""
    L, R = lo, hi
    for c in _FEISTEL_ROUNDS:
        L, R = R, L ^ fmix32_torch(R ^ ((c + seed) & MASK32))
    return L, R


def feistel_unmix_torch(m_lo: torch.Tensor, m_hi: torch.Tensor, seed: int = 0):
    """:func:`feistel_unmix` on int64-held words."""
    L, R = m_lo, m_hi
    for c in reversed(_FEISTEL_ROUNDS):
        L, R = R ^ fmix32_torch(L ^ ((c + seed) & MASK32)), L
    return L, R


def mix64_torch(lo: torch.Tensor, hi: torch.Tensor, seed: int = 0) -> torch.Tensor:
    """:func:`mix64` on int64-held words."""
    return fmix32_torch(lo ^ fmix32_torch(hi ^ ((_GOLDEN + seed) & MASK32)))


def bucket_of_torch(lo: torch.Tensor, hi: torch.Tensor, n_buckets: int,
                    seed: int = 0) -> torch.Tensor:
    """:func:`bucket_of` on int64-held words."""
    return bucket_from_mlo_torch(feistel_mix_torch(lo, hi, seed)[0], n_buckets)


def bucket_from_mlo_torch(m_lo: torch.Tensor, n_buckets: int) -> torch.Tensor:
    """:func:`bucket_from_mlo` on int64-held words."""
    shift = bucket_shift(n_buckets)
    if shift >= 32:
        return torch.zeros_like(m_lo)
    return m_lo >> shift


def to_int32_bits(x: torch.Tensor) -> torch.Tensor:
    """int64-held 32-bit words -> int32 tensor with the same bit pattern."""
    return torch.where(x >= 1 << 31, x - (1 << 32), x).to(torch.int32)


def from_int32_bits(x: torch.Tensor) -> torch.Tensor:
    """int32 bit patterns -> int64-held 32-bit words in [0, 2**32)."""
    return x.to(torch.int64) & MASK32
