"""Rolling k-mer hashing, revcomp and ragged window masking in torch.

The torch counterpart of ``kmer_mapper_tpu/ops/hashing.py``. Each k-mer
hash (up to 62 bits for k <= 31) is a (lo, hi) pair of 32-bit words held in
int64 tensors with values in ``[0, 2**32)``. The hash convention is the
reference's, first base least significant:

    lo |= code[t+m] << 2m          for m < 16
    hi |= code[t+m] << (2m - 32)   for m >= 16

Packed input is one continuous 2-bit stream: base i occupies bits
[2i, 2i+2) of word i // 16.
"""
from __future__ import annotations

import torch

from .stream_probe import INVALID_WORD
from .u32hash import MASK32, feistel_mix_torch


def _masks(k: int) -> tuple[int, int]:
    lo_mask = MASK32 if k >= 16 else (1 << (2 * k)) - 1
    hi_mask = (1 << max(0, 2 * k - 32)) - 1
    return lo_mask, hi_mask


def _window_words(w0, w1, w2, p: int, k: int):
    """(lo, hi) of the window starting at base p of word w0 (p < 16)."""
    lo_mask, hi_mask = _masks(k)
    s = 2 * p
    if s:
        lo = ((w0 >> s) | (w1 << (32 - s))) & lo_mask
        hi = ((w1 >> s) | (w2 << (32 - s))) & hi_mask
    else:
        lo = w0 & lo_mask
        hi = w1 & hi_mask
    return lo, hi


def rolling_kmer_hash_packed(packed: torch.Tensor, k: int):
    """(lo, hi) int64[(w-2)*16] from packed int64 words[w] (w >= 3): entry t
    is the hash of window [t, t+k), computed as 16 alignment phases over the
    word array. The caller masks windows that cross reads."""
    assert 1 <= k <= 31
    w0, w1, w2 = packed[:-2], packed[1:-1], packed[2:]
    los, his = [], []
    for p in range(16):
        lo, hi = _window_words(w0, w1, w2, p, k)
        los.append(lo)
        his.append(hi)
    return torch.stack(los, dim=1).reshape(-1), torch.stack(his, dim=1).reshape(-1)


def read_stride(read_len: int) -> int:
    """Packed stride (bases) for fixed-length reads: the next multiple of 16,
    so each read starts word-aligned and owns ``read_stride // 16`` words."""
    return -(-read_len // 16) * 16


def plane_hash_mixed(
    packed: torch.Tensor,
    k: int,
    read_len: int,
    n_reads: int,
    seed: int,
    revcomp: bool = False,
):
    """Mixed, masked (m_lo, m_hi) of every window of stride-padded reads.

    ``packed`` holds rows of ``read_stride(read_len) // 16`` int64 words, one
    read per row (``pack_for_device(read_len=...)``). Window s = 16*j + p of
    a read lies in the read's own words j..j+2, so all windows with the same
    phase p are one shift/OR over contiguous columns of the (words, rows)
    transpose. Rows >= ``n_reads`` give the all-ones invalid pair. With
    ``revcomp`` the reverse-complement hash of every window is appended.
    The order of the output is a fixed permutation of window order; the
    sort that follows erases it. Returns int64[n_combos * rows] twice."""
    assert 1 <= k <= 31 and read_len >= k
    npr = read_stride(read_len) // 16
    R = packed.shape[0] // npr
    planes = packed[: R * npr].reshape(R, npr).T
    planes = torch.cat([planes, planes.new_zeros(2, R)])  # words past the row
    los, his = [], []
    for p in range(16):
        n_j = (read_len - k - p) // 16 + 1 if p <= read_len - k else 0
        if n_j:
            lo, hi = _window_words(
                planes[0:n_j], planes[1 : n_j + 1], planes[2 : n_j + 2], p, k
            )
            los.append(lo)
            his.append(hi)
    lo = torch.cat(los)
    hi = torch.cat(his)
    if revcomp:
        rlo, rhi = revcomp_lo_hi(lo, hi, k)
        lo = torch.cat([lo, rlo])
        hi = torch.cat([hi, rhi])
    assert lo.shape[0] == (read_len - k + 1) * (2 if revcomp else 1)
    m_lo, m_hi = feistel_mix_torch(lo, hi, seed)
    m_lo[:, n_reads:] = INVALID_WORD
    m_hi[:, n_reads:] = INVALID_WORD
    return m_lo.reshape(-1), m_hi.reshape(-1)


def _reverse_2bit_fields_u32(x: torch.Tensor) -> torch.Tensor:
    """Reverse the 16 two-bit fields of each 32-bit word."""
    x = ((x >> 2) & 0x33333333) | ((x & 0x33333333) << 2)
    x = ((x >> 4) & 0x0F0F0F0F) | ((x & 0x0F0F0F0F) << 4)
    x = ((x >> 8) & 0x00FF00FF) | ((x & 0x00FF00FF) << 8)
    return ((x >> 16) | (x << 16)) & MASK32


def revcomp_lo_hi(lo: torch.Tensor, hi: torch.Tensor, k: int):
    """Reverse-complement hash from the forward (lo, hi) words: complement
    every 2-bit base, reverse the base order, shift down to bit 0."""
    assert 1 <= k <= 31
    rev_hi = _reverse_2bit_fields_u32(lo ^ MASK32)  # forward lo becomes high
    rev_lo = _reverse_2bit_fields_u32(hi ^ MASK32)
    s = 64 - 2 * k  # shift the 64-bit value right by s
    if s < 32:
        out_lo = ((rev_lo >> s) | (rev_hi << (32 - s))) & MASK32
        out_hi = rev_hi >> s
    else:
        out_lo = rev_hi >> (s - 32)
        out_hi = torch.zeros_like(rev_hi)
    lo_mask, hi_mask = _masks(k)
    return out_lo & lo_mask, out_hi & hi_mask


def window_mask(
    read_starts: torch.Tensor, n_bases: int, k: int, buf: int
) -> torch.Tensor:
    """bool[buf]: window t covers [t, t+k) of one read entirely.

    ``read_starts`` are start offsets into the chunk; padding entries may be
    any value >= ``n_bases`` (entries >= buf + k are dropped, and entries in
    [n_bases, buf + k) can only invalidate windows that ``t + k <= n_bases``
    already rejects)."""
    starts_flag = torch.zeros(buf + k, dtype=torch.int32, device=read_starts.device)
    starts_flag[read_starts[read_starts < buf + k]] = 1
    cum = torch.cumsum(starts_flag, 0)
    # no read start strictly inside (t, t+k): cum[t+k-1] == cum[t]
    same_read = cum[k - 1 : k - 1 + buf] == cum[:buf]
    t = torch.arange(buf, device=read_starts.device)
    return same_read & (t + k <= n_bases)
