"""Rolling k-mer hashing, revcomp and ragged window masking in torch.

The torch counterpart of ``kmer_mapper_tpu/ops/hashing.py``. Each k-mer
hash (up to 62 bits for k <= 31) is a (lo, hi) pair of 32-bit words held in
int64 tensors with values in ``[0, 2**32)``. The hash convention is the
reference's, first base least significant:

    lo |= code[t+m] << 2m          for m < 16
    hi |= code[t+m] << (2m - 32)   for m >= 16

Packed input is one continuous 2-bit stream: base i occupies bits
[2i, 2i+2) of word i // 16.

Both chunk steps hash through one wrapper each, which turns packed words
(int32 bit patterns) into the int64 sort keys (``stream_probe.sort_key``)
of exactly the valid windows:

* :func:`plane_hash_keys`, the strided fixed-read-length buffer, whose
  key count the host knows;
* :func:`ragged_hash_keys`, the continuous buffer of reads of any length:
  its offsets and its count are computed on the card
  (:func:`ragged_offsets`) and stay there, as JAX's ``chunk_step`` keeps
  ``n_valid`` on the device, so the step makes no host sync.

On a CUDA tensor each launches its hand-written kernels in
``csrc/hash_keys.cu`` (a failed build or launch raises); on a CPU tensor it
runs its plain twin (:func:`plane_hash_keys_reference`,
:func:`ragged_offsets_reference`, :func:`ragged_hash_keys_reference`), the
plain code below restricted to the valid rows and windows. Any other
device raises. Kernel and twin write the keys in the same order.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from .. import native
from ..utils import profiling
from .stream_probe import INVALID_WORD, sort_key
from .u32hash import MASK32, feistel_mix_torch, from_int32_bits

#: launches of the CUDA kernels and calls of their plain twins since import;
#: a run that must show which one ran resets them first
launch_counts = {
    "plane_hash_keys": 0, "plane_hash_keys_reference": 0,
    "ragged_offsets": 0, "ragged_offsets_reference": 0,
    "ragged_hash_keys": 0, "ragged_hash_keys_reference": 0,
}


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


def rolling_kmer_hash(codes: torch.Tensor, k: int):
    """(lo, hi) int64[n] from base codes int64[n + k] (the chunk padded by
    at least k): entry t is the hash of window [t, t+k), as k shifted-slice
    ORs. The caller masks windows that cross reads."""
    assert 1 <= k <= 31
    n = codes.shape[0] - k
    lo = codes.new_zeros(n)
    hi = codes.new_zeros(n)
    for m in range(k):
        c = codes[m : m + n]
        if 2 * m < 32:
            lo = lo | (c << 2 * m)
        else:
            hi = hi | (c << (2 * m - 32))
    return lo, hi


def rolling_revcomp_hash(codes: torch.Tensor, k: int):
    """Reverse-complement hash of each window of :func:`rolling_kmer_hash`:
    base t+k-1-m complemented (3 - c) at bits 2m."""
    assert 1 <= k <= 31
    n = codes.shape[0] - k
    lo = codes.new_zeros(n)
    hi = codes.new_zeros(n)
    for m in range(k):
        c = 3 - codes[k - 1 - m : k - 1 - m + n]
        if 2 * m < 32:
            lo = lo | (c << 2 * m)
        else:
            hi = hi | (c << (2 * m - 32))
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
    The order of the output is a fixed permutation of window order, on
    which the count does not depend. Returns int64[n_combos * rows] twice."""
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


def _check_words(name: str, packed: torch.Tensor, min_words: int = 1) -> None:
    if packed.dtype != torch.int32 or packed.dim() != 1 or packed.shape[0] < min_words:
        raise ValueError(f"{name}: packed is {packed.dtype}{tuple(packed.shape)}, expected "
                         f"int32 words (at least {min_words})")
    if not packed.is_contiguous():
        raise ValueError(f"{name}: packed is not contiguous")
    if packed.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: no kernel for device {packed.device}")


def _raise_on(name: str, rc: int) -> None:
    if rc:
        raise RuntimeError(f"{name} kernel launch failed: {native.error_string(rc)}")


def plane_hash_keys(packed: torch.Tensor, k: int, read_len: int, n_reads: int, seed: int,
                    revcomp: bool = False) -> torch.Tensor:
    """int64 sort keys of every window of reads 0 .. n_reads-1 of a strided
    buffer (``pack_for_device(read_len=...)``: int32 words, one read per row
    of ``read_stride(read_len) // 16`` words). Rows past ``n_reads`` are
    neither hashed nor written: ``n_reads * (read_len - k + 1)`` keys (twice
    that with ``revcomp``), in :func:`plane_hash_mixed`'s (window combo,
    read) order, reverse complements after the forward keys. Unsorted."""
    with profiling.span(profiling.HASH):
        _check_words("plane_hash_keys", packed)
        if not 1 <= k <= 31 or read_len < k:
            raise ValueError(f"plane_hash_keys: k={k}, read_len={read_len} (need 1 <= k <= 31, "
                             "k <= read_len)")
        npr = read_stride(read_len) // 16
        if not 0 <= n_reads <= packed.shape[0] // npr:
            raise ValueError(f"plane_hash_keys: {n_reads} reads in a buffer of "
                             f"{packed.shape[0] // npr} rows")
        if packed.device.type == "cpu":
            return plane_hash_keys_reference(packed, k, read_len, n_reads, seed, revcomp)
        return _plane_launch(packed, k, read_len, n_reads, seed, revcomp)


def _plane_launch(packed, k: int, read_len: int, n_reads: int, seed: int,
                  revcomp: bool) -> torch.Tensor:
    """The keys from one launch of ``plane_hash_keys_kernel`` on the
    tensor's device and current stream (none for no keys); raises if the
    build or the launch fails."""
    npr = read_stride(read_len) // 16
    n_keys = n_reads * (read_len - k + 1) * (2 if revcomp else 1)
    keys = torch.empty(n_keys, dtype=torch.int64, device=packed.device)
    if not n_keys:
        return keys
    fn = native.library().plane_hash_keys_launch
    with torch.cuda.device(packed.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(packed.data_ptr(), keys.data_ptr(), n_reads, npr, read_len, k, seed & MASK32,
                int(revcomp), packed.device.index, stream)
    _raise_on("plane_hash_keys", rc)
    launch_counts["plane_hash_keys"] += 1
    return keys


def plane_hash_keys_reference(packed: torch.Tensor, k: int, read_len: int, n_reads: int,
                              seed: int, revcomp: bool = False) -> torch.Tensor:
    """Plain-torch twin of :func:`plane_hash_keys`: :func:`plane_hash_mixed`
    on the buffer's first ``n_reads`` rows, then the sort key."""
    launch_counts["plane_hash_keys_reference"] += 1
    if n_reads == 0:
        return torch.empty(0, dtype=torch.int64, device=packed.device)
    rows = packed[: n_reads * (read_stride(read_len) // 16)]
    m_lo, m_hi = plane_hash_mixed(from_int32_bits(rows), k, read_len, n_reads, seed, revcomp)
    return sort_key(m_lo, m_hi)


def _check_ragged(packed, lengths, n_bases: int, k: int) -> None:
    _check_words("ragged_hash_keys", packed, min_words=3)
    if lengths.dtype != torch.int32 or lengths.dim() != 1 or not lengths.is_contiguous():
        raise ValueError(f"ragged_hash_keys: lengths is {lengths.dtype}{tuple(lengths.shape)}, "
                         "expected contiguous int32 read lengths")
    if lengths.device != packed.device:
        raise ValueError(f"ragged_hash_keys: lengths on {lengths.device}, words on "
                         f"{packed.device}")
    if not 1 <= k <= 31:
        raise ValueError(f"ragged_hash_keys: k={k} outside [1, 31]")
    if not 0 <= n_bases <= (packed.shape[0] - 2) * 16:
        raise ValueError(f"ragged_hash_keys: {n_bases} bases in a buffer of "
                         f"{(packed.shape[0] - 2) * 16}")


def _premise(total: int, n_negative: int, n_bases: int) -> None:
    """The reads tile the buffer's bases, where a read's own windows are
    exactly :func:`window_mask`'s."""
    if n_negative:
        raise ValueError(f"ragged_hash_keys: {n_negative} read lengths are negative")
    if total != n_bases:
        raise ValueError(f"ragged_hash_keys: the read lengths add up to {total}, "
                         f"the buffer holds {n_bases} bases")


def check_lengths(lengths, n_bases: int) -> None:
    """Raises ValueError unless read lengths in host memory (a numpy array,
    or a CPU tensor, page-locked or not) tile a buffer of ``n_bases``: none
    negative, their sum ``n_bases``. Reads host memory only, so a mapper
    checks a chunk's lengths here before their upload, with no device sync;
    lengths already on the card are left to the offsets' kernel."""
    if isinstance(lengths, torch.Tensor):
        if lengths.device.type != "cpu":
            return
        lengths = lengths.numpy()
    lengths = np.asarray(lengths).astype(np.int64, copy=False)
    _premise(int(lengths.sum()), int(np.count_nonzero(lengths < 0)), n_bases)


def ragged_capacity(n_words: int, revcomp: bool = False) -> int:
    """The keys a continuously packed buffer of ``n_words`` words can give:
    one a base of its capacity (windows never outnumber bases), twice that
    with ``revcomp``. The size of :func:`ragged_hash_keys`' key buffer."""
    return (n_words - 2) * 16 * (2 if revcomp else 1)


def ragged_hash_keys(packed: torch.Tensor, lengths: torch.Tensor, n_bases: int, k: int,
                     seed: int, revcomp: bool = False, *, out: torch.Tensor | None = None):
    """(keys, count): the int64 sort keys of the valid windows of a
    continuously packed buffer (``pack_for_device`` without ``read_len``:
    int32 words[buf // 16 + 2], the reads back to back from base 0;
    ``lengths`` the int32 lengths of its reads, adding up to ``n_bases``;
    zero padding after them is allowed but the offsets and the kernel cover
    it too), and ``count``, int32[2] on the words' device: (keys, valid
    windows). A window is valid when it lies in one read
    (:func:`window_mask`). The keys of the valid windows in buffer order,
    then their reverse complements with ``revcomp``; unsorted.

    On CUDA nothing is read back: :func:`ragged_offsets` computes the
    offsets and the count on the card, and the kernel writes the keys into
    the first ``count[0]`` entries of ``out`` (a buffer of at least
    :func:`ragged_capacity` int64 keys on the words' device, or a new one;
    past the count its entries are left as they were). Where the lengths do
    not tile the buffer the count is (-1, -1) and nothing is written: the
    caller raises on it when it next reads a count back. On the CPU the twin
    raises at once and returns exactly the keys (``out`` unused)."""
    with profiling.span(profiling.HASH):
        _check_ragged(packed, lengths, n_bases, k)
        if packed.device.type == "cpu":
            check_lengths(lengths, n_bases)
            keys = ragged_hash_keys_reference(packed, lengths, n_bases, k, seed, revcomp)
            n = keys.shape[0]
            return keys, torch.tensor([n, n // (2 if revcomp else 1)], dtype=torch.int32)
        starts, offs, count = ragged_offsets(lengths, n_bases, k, revcomp)
        return _ragged_launch(packed, starts, offs, count, k, seed, revcomp, out), count


#: reads a tile of the offsets' scan (``kScanTile`` of ``csrc/hash_keys.cu``)
RAGGED_SCAN_TILE = 4096


def ragged_offsets(lengths: torch.Tensor, n_bases: int, k: int,
                   revcomp: bool = False) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """int32 (starts[n], offs[n + 1], count[2]) on the lengths' device: each
    read's first base, the exclusive prefix sum of its window counts
    ``max(0, len - k + 1)`` (``offs[n]`` the valid windows), and the count
    (keys, valid windows), the keys twice the windows with ``revcomp``, both
    -1 where a length is negative or the lengths do not add up to
    ``n_bases``. On CUDA one cooperative launch of ``ragged_offsets_kernel``
    (one pass over the lengths, no host sync); on the CPU its twin
    :func:`ragged_offsets_reference`."""
    if lengths.device.type == "cpu":
        return ragged_offsets_reference(lengths, n_bases, k, revcomp)
    return _offsets_launch(lengths, n_bases, k, revcomp)


def _offsets_launch(lengths, n_bases: int, k: int, revcomp: bool):
    """:func:`ragged_offsets`' outputs from one launch of
    ``ragged_offsets_launch`` on the lengths' device and current stream;
    raises if the build or the launch fails. Its scratch, a slot of three
    int64 a CTA, is left as the allocator gives it: the kernel writes every
    slot it reads."""
    n = lengths.shape[0]
    starts, offs, count = (lengths.new_empty(size) for size in (n, n + 1, 2))
    slots = lengths.new_empty(offsets_slots(n), dtype=torch.int64)
    with torch.cuda.device(lengths.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = native.library().ragged_offsets_launch(
            lengths.data_ptr(), n, starts.data_ptr(), offs.data_ptr(), count.data_ptr(),
            slots.data_ptr(), n_bases, k, int(revcomp), lengths.device.index, stream)
    _raise_on("ragged_offsets", rc)
    launch_counts["ragged_offsets"] += 1
    return starts, offs, count


def ragged_offsets_wave(device) -> int:
    """Reads of one wave of :func:`ragged_offsets`' persistent grid on a
    CUDA device: its CTAs (as many as are resident at once) times
    :data:`RAGGED_SCAN_TILE`. A call of more reads gives some CTAs more
    than one tile."""
    device = torch.device(device)
    index = torch.cuda.current_device() if device.index is None else device.index
    ctas = ctypes.c_int(0)
    with torch.cuda.device(index):
        rc = native.library().ragged_offsets_grid(index, ctypes.byref(ctas))
    _raise_on("ragged_offsets_grid", rc)
    return ctas.value * RAGGED_SCAN_TILE


def offsets_slots(n_rows: int) -> int:
    """int64 entries of :func:`ragged_offsets`' scratch for ``n_rows``
    reads: a slot of three (bases, valid windows, negative lengths) a tile
    of :data:`RAGGED_SCAN_TILE` reads, so one for every CTA the grid can
    have (a CTA takes at least one tile)."""
    return 3 * max(1, -(-n_rows // RAGGED_SCAN_TILE))


def ragged_offsets_reference(lengths: torch.Tensor, n_bases: int, k: int,
                             revcomp: bool = False):
    """Plain-torch twin of :func:`ragged_offsets` (same contract, same
    bits): ``cumsum`` of the lengths and of the clamped window counts, and
    the count."""
    launch_counts["ragged_offsets_reference"] += 1
    lengths = lengths.long()
    windows = torch.clamp(lengths - (k - 1), min=0)
    offs = torch.cat([windows.new_zeros(1), torch.cumsum(windows, 0)])
    tiled = (lengths.sum() == n_bases) & ~(lengths < 0).any()
    count = torch.stack([offs[-1] * (2 if revcomp else 1), offs[-1]])
    count = torch.where(tiled, count, -1)
    starts = torch.cumsum(lengths, 0) - lengths
    return (starts.to(torch.int32), offs.to(torch.int32), count.to(torch.int32))


def _ragged_launch(packed, starts, offs, count, k: int, seed: int, revcomp: bool,
                   out: torch.Tensor | None = None) -> torch.Tensor:
    """The key buffer (``out``, or a new one of :func:`ragged_capacity`
    keys) after one launch of ``ragged_hash_keys_kernel`` on the tensors'
    device and current stream (none for no reads); raises if the build or
    the launch fails."""
    capacity = ragged_capacity(packed.shape[0], revcomp)
    if out is None:
        out = torch.empty(capacity, dtype=torch.int64, device=packed.device)
    elif (out.dtype != torch.int64 or out.dim() != 1 or not out.is_contiguous()
          or out.device != packed.device or out.shape[0] < capacity):
        raise ValueError(f"ragged_hash_keys: out is {out.dtype}{tuple(out.shape)} on "
                         f"{out.device}, expected contiguous int64[>= {capacity}] on "
                         f"{packed.device}")
    if not starts.numel():
        return out
    fn = native.library().ragged_hash_keys_launch
    with torch.cuda.device(packed.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(packed.data_ptr(), packed.shape[0], starts.data_ptr(), offs.data_ptr(),
                starts.shape[0], count.data_ptr(), out.data_ptr(), k, seed & MASK32,
                int(revcomp), packed.device.index, stream)
    _raise_on("ragged_hash_keys", rc)
    launch_counts["ragged_hash_keys"] += 1
    return out


def ragged_hash_keys_reference(packed: torch.Tensor, lengths: torch.Tensor, n_bases: int,
                               k: int, seed: int, revcomp: bool = False) -> torch.Tensor:
    """Plain-torch twin of :func:`ragged_hash_keys`: the rolling hash of
    every base, :func:`window_mask`, the reverse complements and the mix of
    the valid windows, then the sort key."""
    launch_counts["ragged_hash_keys_reference"] += 1
    lo, hi = rolling_kmer_hash_packed(from_int32_bits(packed), k)
    lengths = lengths.to(torch.int64)
    starts = torch.cumsum(lengths, 0) - lengths
    valid = window_mask(starts, n_bases, k, lo.shape[0])
    lo, hi = lo[valid], hi[valid]
    if revcomp:
        rlo, rhi = revcomp_lo_hi(lo, hi, k)
        lo, hi = torch.cat([lo, rlo]), torch.cat([hi, rhi])
    return sort_key(*feistel_mix_torch(lo, hi, seed))
