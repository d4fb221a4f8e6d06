"""Gather probe: every pre-hashed library call, counts and membership. The
torch counterpart of ``kmer_mapper_tpu/ops/probe.py``.

Each query is the caller's uint64 k-mer hash, held as an int64 tensor of
the same bits. The probe splits it into its ``(lo, hi)`` words, mixes them
(``u32hash.feistel_mix``), finds the home bucket from the high bits of the
mixed low word and walks the bucket's chain, comparing the mixed pair with
the bucket's 8 keys: ``max_probe`` rounds, or with ``block_probe`` (the
table's ``block_max_probe``) only as many as the query's chain block needs,
which finds the same keys. A query that mixes to the all-ones empty
sentinel never matches.

* :func:`probe_count` adds one to the table slot of every valid query that
  hits (``probe_hits`` + ``accumulate_scatter``);
* :func:`probe_slots` returns the slot of each query, or -1 (``probe_slots``).

An index shard (``parallel/sharded.py``) passes its rows, the buckets
``[row_offset, row_offset + n_local)`` of a table of ``n_buckets_global``:
home buckets, chains and block bounds are the whole table's, a round whose
bucket lies in another shard compares nothing, and slots are the shard's
own, as ``probe_hits`` does with ``row_offset`` (JAX ``ops/probe.py:31``).

On CUDA tensors both launch the hand-written kernel ``csrc/gather_probe.cu``
(a failed build or launch raises); on CPU tensors they run their plain
twins :func:`probe_count_reference` and :func:`probe_slots_reference`, which
gather a bucket row per round and compare it with an (n, 8) lane mask, as
``probe_hits`` does. Any other device raises.

Table words are int32 bit patterns of shape (n_buckets, 8) in slot order;
counts are int32 (n_buckets * 8,) whose bits equal the reference's wrapping
uint32 counts.
"""
from __future__ import annotations

import torch

from .. import native
from ..index.layout import BUCKET_KEYS, CHAIN_BLOCK, MAX_PROBE_HARD
from .u32hash import MASK32, bucket_from_mlo_torch, feistel_mix_torch, to_int32_bits

#: launches of the CUDA kernel (both modes) and calls of each plain twin
#: since import; a run that must show which one ran resets them first
launch_counts = {"gather_probe": 0, "probe_count_reference": 0, "probe_slots_reference": 0}

_COUNT, _SLOTS = 0, 1  # the kernel's modes (csrc/gather_probe.cu)
_MAX_BUCKETS = 1 << 29  # the kernel's bound: slots stay below 2**32


def chain_next(b: torch.Tensor, step: int, n_buckets: int) -> torch.Tensor:
    """Bucket ``step`` places down the chain of ``b``: chains wrap inside
    aligned CHAIN_BLOCK-bucket blocks (``layout.chain_next``)."""
    block = min(CHAIN_BLOCK, n_buckets)
    return (b & ~(block - 1)) | ((b + step) & (block - 1))


def check_args(name, key_lo, key_hi, queries, max_probe, block_probe, row_offset: int = 0,
               n_buckets_global: int | None = None, **more):
    """Raises ValueError unless the arguments fit the kernel's contract
    (``more``: ``valid`` and ``counts`` where the call takes them)."""
    n_local = key_lo.shape[0] if key_lo.dim() == 2 else -1
    n_buckets = n_local if n_buckets_global is None else n_buckets_global
    n = queries.shape[0] if queries.dim() == 1 else -1
    expect = {
        "key_lo": (key_lo, torch.int32, (n_local, BUCKET_KEYS)),
        "key_hi": (key_hi, torch.int32, (n_local, BUCKET_KEYS)),
        "queries": (queries, torch.int64, (n,)),
    }
    if block_probe is not None:
        n_blocks = n_buckets // min(CHAIN_BLOCK, max(n_buckets, 1))
        expect["block_probe"] = (block_probe, torch.int32, (n_blocks,))
    if more.get("valid") is not None:
        expect["valid"] = (more["valid"], torch.bool, (n,))
    if "counts" in more:
        expect["counts"] = (more["counts"], torch.int32, (n_local * BUCKET_KEYS,))
    for arg, (t, dtype, shape) in expect.items():
        if t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(f"{name}: {arg} is {t.dtype}{tuple(t.shape)}, expected {dtype}{shape}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {arg} is not contiguous")
        if t.device != key_lo.device:
            raise ValueError(f"{name}: {arg} is on {t.device}, keys on {key_lo.device}")
    if n_buckets < 1 or n_buckets & (n_buckets - 1) or n_buckets > _MAX_BUCKETS:
        raise ValueError(f"{name}: n_buckets={n_buckets} is not a power of two <= 2**29")
    if n_local < 1 or row_offset < 0 or row_offset + n_local > n_buckets:
        raise ValueError(f"{name}: rows [{row_offset}, {row_offset + n_local}) are not in a "
                         f"table of {n_buckets} buckets")
    if not 1 <= max_probe <= MAX_PROBE_HARD:
        raise ValueError(f"{name}: max_probe={max_probe} outside [1, {MAX_PROBE_HARD}]")
    if key_lo.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: no kernel for device {key_lo.device}")


def probe_count(key_lo, key_hi, counts, queries, max_probe: int, seed: int, *,
                block_probe=None, valid=None, row_offset: int = 0,
                n_buckets_global: int | None = None) -> torch.Tensor:
    """counts[slot] += 1 for every query (every valid one, where ``valid``
    is given) whose key the table (or the shard's rows) holds; updates
    ``counts`` in place and returns it."""
    shard = dict(row_offset=row_offset, n_buckets_global=n_buckets_global)
    check_args("probe_count", key_lo, key_hi, queries, max_probe, block_probe, valid=valid,
               counts=counts, **shard)
    if counts.device.type == "cpu":
        return probe_count_reference(key_lo, key_hi, counts, queries, max_probe, seed,
                                     block_probe=block_probe, valid=valid, **shard)
    _launch(_COUNT, key_lo, key_hi, block_probe, queries, valid, counts, None, max_probe,
            seed, **shard)
    return counts


def probe_slots(key_lo, key_hi, queries, max_probe: int, seed: int, *,
                block_probe=None, row_offset: int = 0,
                n_buckets_global: int | None = None) -> torch.Tensor:
    """int32[n]: the table slot (bucket * 8 + lane; the shard's own) holding
    each query's key, or -1."""
    if key_lo.shape[0] * BUCKET_KEYS > 1 << 31:
        raise ValueError("probe_slots: a table of more than 2**31 slots has slots past int32")
    shard = dict(row_offset=row_offset, n_buckets_global=n_buckets_global)
    check_args("probe_slots", key_lo, key_hi, queries, max_probe, block_probe, **shard)
    if key_lo.device.type == "cpu":
        return probe_slots_reference(key_lo, key_hi, queries, max_probe, seed,
                                     block_probe=block_probe, **shard)
    out = torch.empty(queries.shape[0], dtype=torch.int32, device=key_lo.device)
    _launch(_SLOTS, key_lo, key_hi, block_probe, queries, None, None, out, max_probe, seed,
            **shard)
    return out


def launch_with(fn, mode, key_lo, key_hi, block_probe, queries, valid, counts, out,
                max_probe, seed, *more, n_buckets: int | None = None) -> int:
    """Calls ``fn``, a C entry point with ``gather_probe_launch``'s
    arguments (``more`` before the device; ``n_buckets`` the whole table's,
    by default the key words'), on the tensors' device and current stream;
    returns its code."""
    device = key_lo.device
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream().cuda_stream
        return fn(
            key_lo.data_ptr(), key_hi.data_ptr(),
            None if block_probe is None else block_probe.data_ptr(), queries.data_ptr(),
            None if valid is None else valid.data_ptr(),
            None if counts is None else counts.data_ptr(),
            None if out is None else out.data_ptr(),
            queries.shape[0], key_lo.shape[0] if n_buckets is None else n_buckets,
            0 if block_probe is None else block_probe.shape[0], max_probe, seed & MASK32,
            mode, *more, device.index, stream,
        )


def _launch(mode, key_lo, key_hi, block_probe, queries, valid, counts, out, max_probe, seed,
            row_offset: int = 0, n_buckets_global: int | None = None):
    """One launch of ``csrc/gather_probe.cu`` on the tensors' device and
    current stream; raises if the build or the launch fails."""
    rc = launch_with(native.library().gather_probe_launch, mode, key_lo, key_hi, block_probe,
                     queries, valid, counts, out, max_probe, seed, row_offset,
                     key_lo.shape[0], n_buckets=n_buckets_global)
    if rc:
        raise RuntimeError(f"gather_probe kernel launch failed: {native.error_string(rc)}")
    launch_counts["gather_probe"] += 1


def query_rounds(queries, max_probe: int, seed: int, n_buckets: int, block_probe=None):
    """(home bucket, mixed lo, mixed hi, rounds) of each int64 raw query:
    the walk's bound, ``max_probe`` or its chain block's bound, and 0 for
    the sentinel. Words split as ``q & MASK32`` and ``(q >> 32) & MASK32``:
    torch's int64 ``>>`` copies the sign bit down."""
    m_lo, m_hi = feistel_mix_torch(queries & MASK32, (queries >> 32) & MASK32, seed)
    b0 = bucket_from_mlo_torch(m_lo, n_buckets)
    if block_probe is None:
        rounds = torch.full_like(b0, max_probe)
    else:
        rounds = block_probe.long()[b0 // min(CHAIN_BLOCK, n_buckets)].clamp(max=max_probe)
    rounds = torch.where((m_lo == MASK32) & (m_hi == MASK32), 0, rounds)
    return b0, m_lo, m_hi, rounds


def _twin_slots(key_lo, key_hi, queries, max_probe: int, seed: int,
                block_probe, row_offset: int = 0,
                n_buckets_global: int | None = None) -> torch.Tensor:
    """int64 slot per query or -1: ``probe_hits`` in plain torch, a row
    gather and an 8-lane compare per round, each query's rounds bounded as
    the kernel bounds them, rounds in other shards' rows masked."""
    n_local = key_lo.shape[0]
    n_buckets = n_local if n_buckets_global is None else n_buckets_global
    b0, m_lo, m_hi, rounds = query_rounds(queries, max_probe, seed, n_buckets, block_probe)
    w_lo, w_hi = to_int32_bits(m_lo)[:, None], to_int32_bits(m_hi)[:, None]
    bucket = torch.zeros_like(b0)
    mask = torch.zeros((queries.shape[0], BUCKET_KEYS), dtype=torch.bool,
                       device=queries.device)
    for p in range(max_probe):
        b = chain_next(b0, p, n_buckets) - row_offset
        here = (b >= 0) & (b < n_local) & (rounds > p)
        b = torch.where(here, b, 0)
        m = (key_lo[b] == w_lo) & (key_hi[b] == w_hi) & here[:, None]
        # keys are unique in the table: at most one (bucket, lane) matches
        bucket = torch.where(m.any(dim=1), b, bucket)
        mask |= m
    lane = mask.to(torch.uint8).argmax(dim=1)
    return torch.where(mask.any(dim=1), bucket * BUCKET_KEYS + lane, -1)


def probe_count_reference(key_lo, key_hi, counts, queries, max_probe: int, seed: int, *,
                          block_probe=None, valid=None, row_offset: int = 0,
                          n_buckets_global: int | None = None) -> torch.Tensor:
    """Plain-torch twin of :func:`probe_count` (same contract, same result),
    adding with wrapping 32-bit arithmetic."""
    launch_counts["probe_count_reference"] += 1
    slots = _twin_slots(key_lo, key_hi, queries, max_probe, seed, block_probe, row_offset,
                        n_buckets_global)
    slots = slots[slots >= 0] if valid is None else slots[valid & (slots >= 0)]
    if slots.numel():
        slots, n_hits = torch.unique(slots, return_counts=True)
        total = (counts[slots].to(torch.int64) & MASK32) + n_hits
        counts[slots] = to_int32_bits(total & MASK32)
    return counts


def probe_slots_reference(key_lo, key_hi, queries, max_probe: int, seed: int, *,
                          block_probe=None, row_offset: int = 0,
                          n_buckets_global: int | None = None) -> torch.Tensor:
    """Plain-torch twin of :func:`probe_slots`."""
    launch_counts["probe_slots_reference"] += 1
    return _twin_slots(key_lo, key_hi, queries, max_probe, seed, block_probe, row_offset,
                       n_buckets_global).to(torch.int32)
