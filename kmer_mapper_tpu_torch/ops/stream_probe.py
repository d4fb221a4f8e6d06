"""Block partition + stream count: the counting path of the port.

1. Each query's mixed (m_lo, m_hi) pair becomes ONE int64 sort key,
   ``m_lo * 2**32 + m_hi - 2**63``: the signed order of the key is the
   unsigned order of the pair, and the all-ones invalid pair becomes the
   largest key. The bucket id is the high bits of m_lo, so a key's
   128-bucket chain block is the top bits of the key. The chunk steps get
   their keys straight from the hash kernels of ``ops/hashing.py``, which
   write valid queries only.
2. ``block_partition.block_partition`` groups the keys by chain block and
   gives each block's window; the invalid keys fall after the last window.
   (``sort_mixed``, ``block_offsets`` and ``count_offsets``, the sort and
   bisections of the JAX package, stay as references and for the
   dissection scripts.)
3. ``stream_count`` adds, for every valid query, one to the table slot that
   stores its key. On a CUDA tensor it launches the hand-written kernel
   ``csrc/stream_count.cu`` (one CTA per chain block); on a CPU tensor it
   runs its plain twin ``stream_count_reference``. It needs each block's
   keys in one window, in any order.

Table words arrive as int32 bit patterns (``key_lo``/``key_hi`` of shape
(n_buckets, 8), slot order) and counts as int32 (n_buckets * 8,) in slot
order, whose bits equal the reference's wrapping uint32 counts.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import native
from ..index.layout import BUCKET_KEYS, CHAIN_BLOCK
from ..utils import profiling
from .block_partition import INVALID_KEY, block_partition
from .u32hash import (
    MASK32, bucket_shift, feistel_mix_torch, to_int32_bits,
)

#: invalid queries get BOTH mixed words set to this; the pair equals the
#: table's EMPTY sentinel, which the build keeps away from real keys, and the
#: count step skips it
INVALID_WORD = 0xFFFFFFFF

#: launches of the CUDA kernel and calls of its plain twin since import;
#: a run that must show which one counted resets them first
launch_counts = {"stream_count": 0, "stream_count_reference": 0}
#: the fingerprint of an empty slot; a key's is 1..15 (:func:`fingerprint`)
EMPTY_FINGERPRINT = 0
#: a device's share of the table from which the file pipeline takes
#: 128 Mi-base buffers (``pipeline.device_buf``): a human pangenome's index
#: (~127M keys); every chunk reads the whole table once in the count, and a
#: larger buffer spreads that read over more keys
HUMAN_SCALE_BUCKETS = 1 << 25


def sort_key(m_lo: torch.Tensor, m_hi: torch.Tensor) -> torch.Tensor:
    """int64 key whose signed order is the unsigned (m_lo, m_hi) order.
    ``m_lo << 32`` would overflow int64 for m_lo >= 2**31, so the key is
    built as ``(m_lo - 2**31) * 2**32 + m_hi``, which stays in range."""
    return (m_lo - (1 << 31)) * (1 << 32) + m_hi


def split_key(keys: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Inverse of :func:`sort_key`: int64-held (m_lo, m_hi)."""
    return (keys >> 32) + (1 << 31), keys & MASK32


def sort_mixed(m_lo: torch.Tensor, m_hi: torch.Tensor) -> torch.Tensor:
    """Sorted int64 keys of pre-mixed, pre-masked query words."""
    return torch.sort(sort_key(m_lo, m_hi)).values


def mixed_keys(q_lo, q_hi, valid, seed: int) -> torch.Tensor:
    """Raw query words -> int64 sort keys in query order: mixed, invalid ->
    :data:`INVALID_KEY`."""
    m_lo, m_hi = feistel_mix_torch(q_lo, q_hi, seed)
    m_lo = torch.where(valid, m_lo, INVALID_WORD)
    m_hi = torch.where(valid, m_hi, INVALID_WORD)
    return sort_key(m_lo, m_hi)


def sort_queries(q_lo, q_hi, valid, seed: int) -> torch.Tensor:
    """Raw query words -> sorted int64 keys: mixed, invalid -> all-ones."""
    return torch.sort(mixed_keys(q_lo, q_hi, valid, seed)).values


def block_offsets(sorted_keys: torch.Tensor, n_buckets: int, block: int) -> torch.Tensor:
    """int32[n_blocks + 1] window bounds of each chain block in the sorted keys.

    Block b owns keys whose m_lo lies in [(b*block) << shift,
    ((b+1)*block) << shift). A threshold at or past 2**32 (the top of the
    table) means "end of array"; that last window also holds the invalid
    tail, which the count step skips."""
    n_blocks = max(1, n_buckets // min(block, n_buckets))
    block = n_buckets // n_blocks
    shift = min(bucket_shift(n_buckets), 31)  # 32 only for a 1-bucket table,
    # whose only non-top bound is 0
    dev = sorted_keys.device
    bounds_b = torch.arange(n_blocks + 1, dtype=torch.int64, device=dev) * block
    is_top = bounds_b >= n_buckets
    thr_lo = torch.where(is_top, 0, bounds_b) << shift
    thr = sort_key(thr_lo, torch.zeros_like(thr_lo))
    off = torch.searchsorted(sorted_keys, thr)
    off = torch.where(is_top, sorted_keys.shape[0], off)
    return off.to(torch.int32)


def count_offsets(sorted_keys: torch.Tensor, n_buckets: int, block: int) -> torch.Tensor:
    """:func:`block_offsets` with every window ended at the first invalid
    key. The invalid queries sort last, into the last block's window, where
    the count's one CTA for that block would read each only to skip it. One
    ``searchsorted`` on the keys' device, with no host sync."""
    off = block_offsets(sorted_keys, n_buckets, block)
    invalid = torch.full((1,), INVALID_KEY, dtype=torch.int64, device=sorted_keys.device)
    return torch.minimum(off, torch.searchsorted(sorted_keys, invalid).to(torch.int32))


def check_count_args(key_lo, key_hi, counts, keys, off, block_probe, shift, bpb,
                     name: str = "stream_count", *, bucket_base: int = 0,
                     n_buckets_global: int | None = None):
    """Raises ValueError unless the arguments fit the count kernels'
    contract (dtypes, shapes, contiguity, one device, a power-of-two table
    and its shift and chain-block size). The key words may be an index
    shard's: the buckets ``[bucket_base, bucket_base + n_local)`` of a table
    of ``n_buckets_global`` (default: the key words are the whole table),
    in whole chain blocks."""
    n_local = key_lo.shape[0] if key_lo.dim() == 2 else -1
    n_buckets = n_local if n_buckets_global is None else n_buckets_global
    n_blocks = n_local // max(1, bpb)
    expect = (
        (key_lo, torch.int32, (n_local, BUCKET_KEYS)),
        (key_hi, torch.int32, (n_local, BUCKET_KEYS)),
        (counts, torch.int32, (n_local * BUCKET_KEYS,)),
        (keys, torch.int64, (keys.shape[0],)),
        (off, torch.int32, (n_blocks + 1,)),
        (block_probe, torch.int32, (n_blocks,)),
    )
    dev = key_lo.device
    for arg, (t, dtype, shape) in zip(
        ("key_lo", "key_hi", "counts", "keys", "off", "block_probe"), expect
    ):
        if t.dtype != dtype or tuple(t.shape) != shape or t.dim() != len(shape):
            raise ValueError(
                f"{name}: {arg} is {t.dtype}{tuple(t.shape)}, "
                f"expected {dtype}{shape}"
            )
        if not t.is_contiguous():
            raise ValueError(f"{name}: {arg} is not contiguous")
        if t.device != dev:
            raise ValueError(f"{name}: {arg} is on {t.device}, keys on {dev}")
    if n_buckets < 1 or n_buckets & (n_buckets - 1):
        raise ValueError(f"{name}: n_buckets={n_buckets} is not a power of two")
    if shift != bucket_shift(n_buckets) or bpb != min(CHAIN_BLOCK, n_buckets):
        raise ValueError(f"{name}: shift={shift}, bpb={bpb} do not fit {n_buckets} buckets")
    if (n_local < 1 or n_local % bpb or bucket_base < 0 or bucket_base % bpb
            or bucket_base + n_local > n_buckets):
        raise ValueError(f"{name}: buckets [{bucket_base}, {bucket_base + n_local}) are not "
                         f"whole chain blocks of a table of {n_buckets}")
    if keys.shape[0] >= 1 << 31:
        raise ValueError(f"{name}: more than 2**31 - 1 queries in one call")


def stream_count(key_lo, key_hi, counts, keys, off, block_probe,
                 shift: int, bpb: int, bucket_base: int = 0,
                 n_buckets_global: int | None = None) -> torch.Tensor:
    """counts[slot] += the number of valid queries whose (m_lo, m_hi)
    equals the key stored in that slot; updates ``counts`` in place and
    returns it. ``keys`` holds chain block b's queries in ``[off[b],
    off[b+1])``, in any order inside a window
    (:func:`block_partition.block_partition`; sorted keys with
    :func:`count_offsets` are grouped too). A query of chain block b looks
    in bucket ``b*bpb + ((local_b + p) & (bpb-1))`` for rounds ``p <
    block_probe[b]``, across all 8 lanes.

    An index shard passes its first bucket ``bucket_base`` and the whole
    table's ``n_buckets_global`` (``shift`` and ``bpb`` are the whole
    table's); its blocks, ``off`` and ``block_probe`` are local, and a
    query's block is its global block less ``bucket_base / bpb``.

    CUDA tensors launch ``csrc/stream_count.cu`` (a failed build or launch
    raises); CPU tensors run :func:`stream_count_reference`."""
    with profiling.span(profiling.COUNT):
        check_count_args(key_lo, key_hi, counts, keys, off, block_probe, shift, bpb,
                         bucket_base=bucket_base, n_buckets_global=n_buckets_global)
        if counts.device.type == "cpu":
            return stream_count_reference(
                key_lo, key_hi, counts, keys, off, block_probe, shift, bpb, bucket_base
            )
        if counts.device.type != "cuda":
            raise ValueError(f"stream_count: no kernel for device {counts.device}")
        fn = native.library().stream_count_launch
        n_blocks = block_probe.shape[0]
        with torch.cuda.device(counts.device):
            stream = torch.cuda.current_stream().cuda_stream
            rc = fn(
                key_lo.data_ptr(), key_hi.data_ptr(), counts.data_ptr(),
                keys.data_ptr(), off.data_ptr(), block_probe.data_ptr(),
                n_blocks, shift, bpb, bucket_base, counts.device.index, stream,
            )
        if rc:
            raise RuntimeError(f"stream_count kernel launch failed: {native.error_string(rc)}")
        launch_counts["stream_count"] += 1
        return counts


def fingerprint(m_hi: torch.Tensor) -> torch.Tensor:
    """int64 4-bit fingerprint of int64-held m_hi words, 1..15:
    ``1 + (15 * m_hi >> 32)``, the kernel's ``__umulhi(m_hi, 15) + 1``."""
    return ((m_hi & MASK32) * 15 >> 32) + 1


def bucket_fingerprints(key_lo: torch.Tensor, key_hi: torch.Tensor) -> torch.Tensor:
    """int64[n_buckets] fingerprint words of a table's int32 key words: lane
    l's 4 bits at bit ``4 l``, :data:`EMPTY_FINGERPRINT` for an empty
    slot (the all-ones pair), :func:`fingerprint` of its m_hi for a key."""
    lo, hi = key_lo.to(torch.int64) & MASK32, key_hi.to(torch.int64) & MASK32
    empty = (lo == INVALID_WORD) & (hi == INVALID_WORD)
    nibble = torch.where(empty, EMPTY_FINGERPRINT, fingerprint(hi))
    return (nibble << (4 * torch.arange(BUCKET_KEYS, device=lo.device))).sum(1)


def fingerprint_lanes(words: torch.Tensor, m_hi: torch.Tensor) -> torch.Tensor:
    """bool (n, 8): the lanes of each query's bucket whose fingerprint equals
    the query's, found as the kernel finds them: the word xor the query's
    fingerprint in every nibble, then the nibbles that are zero
    (``~(((x & 0x77777777) + 0x77777777) | x) & 0x88888888``, no carry
    crossing a nibble). ``words`` holds each query's bucket's word."""
    x = (words ^ (fingerprint(m_hi) * 0x11111111)) & MASK32
    zero = ~(((x & 0x77777777) + 0x77777777) | x) & 0x88888888
    return (zero[:, None] >> (4 * torch.arange(BUCKET_KEYS, device=words.device) + 3)) & 1 == 1


def stream_count_reference(key_lo, key_hi, counts, keys, off, block_probe,
                           shift: int, bpb: int, bucket_base: int = 0) -> torch.Tensor:
    """Plain-torch twin of the kernel (same contract, same result): for each
    valid query, walk its rounds with a row gather and an 8-lane compare,
    then add the hits into ``counts`` with wrapping 32-bit arithmetic."""
    launch_counts["stream_count_reference"] += 1
    dev = keys.device
    n_blocks = block_probe.shape[0]
    off64 = off.to(torch.int64)
    lengths = off64[1:] - off64[:-1]
    in_windows = keys[int(off64[0]) : int(off64[-1])]
    block = torch.repeat_interleave(torch.arange(n_blocks, device=dev), lengths)
    m_lo, m_hi = split_key(in_windows)
    # the global bucket (shift of the whole table) against the shard's blocks
    bucket = m_lo >> shift if shift < 32 else torch.zeros_like(m_lo)
    local = bucket - bucket_base - block * bpb
    live = ~((m_lo == INVALID_WORD) & (m_hi == INVALID_WORD))
    live &= (local >= 0) & (local < bpb)
    # a chain never leaves its block: more than bpb rounds would revisit
    rounds = block_probe.to(torch.int64).clamp(max=bpb)[block]
    q_lo, q_hi = to_int32_bits(m_lo), to_int32_bits(m_hi)
    hit_slots = []
    for p in range(min(int(block_probe.max()), bpb)):
        sel = torch.nonzero(live & (p < rounds)).squeeze(1)
        if sel.numel() == 0:
            continue
        b = block[sel] * bpb + ((local[sel] + p) & (bpb - 1))
        match = (key_lo[b] == q_lo[sel, None]) & (key_hi[b] == q_hi[sel, None])
        row, lane = torch.nonzero(match, as_tuple=True)
        hit_slots.append(b[row] * BUCKET_KEYS + lane)
    if hit_slots:
        slots, n_hits = torch.unique(torch.cat(hit_slots), return_counts=True)
        total = (counts[slots].to(torch.int64) & MASK32) + n_hits
        counts[slots] = to_int32_bits(total & MASK32)
    return counts


def slot_to_plane(counts: np.ndarray, n_buckets: int, gpb: int = CHAIN_BLOCK) -> np.ndarray:
    """Slot-order counts -> the plane order of ``kmer_mapper_tpu``'s
    stream mappers ((g*8 + lane) * gpb + bucket_in_group)."""
    gpb = min(gpb, n_buckets)
    return np.ascontiguousarray(
        np.asarray(counts)
        .reshape(n_buckets // gpb, gpb, BUCKET_KEYS)
        .transpose(0, 2, 1)
    ).reshape(-1)


def plane_to_slot(counts: np.ndarray, n_buckets: int, gpb: int = CHAIN_BLOCK) -> np.ndarray:
    """Plane-order counts of ``kmer_mapper_tpu`` -> slot order."""
    gpb = min(gpb, n_buckets)
    return np.ascontiguousarray(
        np.asarray(counts)
        .reshape(n_buckets // gpb, BUCKET_KEYS, gpb)
        .transpose(0, 2, 1)
    ).reshape(-1)


def stream_probe_count_keys(key_lo, key_hi, counts, keys, block_probe, *,
                            bucket_base: int = 0, n_buckets_global: int | None = None,
                            count: torch.Tensor | None = None):
    """Stream path for the sort keys of valid queries, in any order (the
    hash kernels' output, ``hashing.plane_hash_keys`` / ``ragged_hash_keys``):
    block partition -> stream count. Updates ``counts`` in place. On the
    card the partition uses ``keys``' memory, whose contents are then
    undefined. ``count`` (the ragged step's device count, see
    ``block_partition``) names how many of the keys are queries; the rest
    are not read.

    An index shard (buckets ``[bucket_base, bucket_base + n_local)`` of
    ``n_buckets_global``, whole chain blocks; ``block_probe`` its slice)
    partitions the keys over the whole table's blocks and counts its own
    blocks' windows, ``off[bucket_base / bpb : ... + n_local / bpb + 1]``;
    keys homed elsewhere lie outside them."""
    n_local = key_lo.shape[0]
    n_buckets = n_local if n_buckets_global is None else n_buckets_global
    bpb = min(CHAIN_BLOCK, n_buckets)
    grouped, off = block_partition(keys, n_buckets, bpb, consume=True, count=count)
    first = bucket_base // bpb
    return stream_count(
        key_lo, key_hi, counts, grouped, off[first : first + n_local // bpb + 1], block_probe,
        bucket_shift(n_buckets), bpb, bucket_base, n_buckets,
    )


def stream_probe_count(key_lo, key_hi, counts, q_lo, q_hi, valid, seed: int,
                       block_probe):
    """Stream path for raw query words and their validity mask: the mixed
    keys (invalid queries land in no window) -> block partition -> stream
    count."""
    return stream_probe_count_keys(
        key_lo, key_hi, counts, mixed_keys(q_lo, q_hi, valid, seed), block_probe
    )
