"""Hazard inputs for the gather probe, each with the slots and counts that a
plain numpy loop expects.

Every case stresses one corner of ``probe.probe_count``'s and
``probe.probe_slots``' contract: a query that mixes to the all-ones empty
sentinel, tables of 1, 8 and 64 buckets, chains that wrap inside their
chain block, chain blocks with different bounds (one long chain beside
blocks with none, misses homed in each), a round bound of 1, of the
table's own, below a block's bound and 64 (which revisits buckets), with
and without the per-block bounds, a seeded table, key words with the high
bit set and raw words whose int64 view is negative, invalid queries, a
null and an all-true ``valid``, one hot key 10^4 times, counts that wrap
past 2**32 and no queries at all. The expected results come from
:func:`expected_slots`, a loop over queries that walks ``max_probe`` rounds
whatever the block bounds, independent of the kernel and its twin. Used by
``tests/test_torch_gather_kernels.py``, ``tests/test_torch_probe.py`` and
``chip_smoke.py``.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..index import layout
from .u32hash import MASK32, bucket_from_mlo, feistel_mix, feistel_unmix, split_u64


@dataclasses.dataclass
class ProbeCase:
    name: str
    table: layout.TableArrays
    queries: np.ndarray  # uint64 raw kmers
    valid: np.ndarray | None  # bool per query (probe_count only); None: all
    counts0: np.ndarray  # uint32[n_slots] starting counts, slot order
    max_probe: int
    bounds: bool = True  # pass the table's per-block chain bounds

    def expected_slots(self) -> np.ndarray:
        return expected_slots(self.table, self.queries, self.max_probe)

    def expected_counts(self) -> np.ndarray:
        """counts0 + one per valid hit, wrapping like uint32."""
        slots = self.expected_slots()
        if self.valid is not None:
            slots = slots[self.valid]
        hits = np.bincount(slots[slots >= 0], minlength=self.table.n_slots)
        return ((self.counts0.astype(np.uint64) + hits.astype(np.uint64))
                & np.uint64(MASK32)).astype(np.uint32)

    def count_args(self, device) -> tuple[tuple, dict]:
        """``probe_count``'s positional and keyword arguments on ``device``
        (a fresh copy of counts0)."""
        key_lo, key_hi, queries, kw = self._inputs(device)
        if self.valid is not None:
            kw["valid"] = torch.from_numpy(self.valid).to(device)
        return (key_lo, key_hi, _int32(self.counts0.copy(), device), queries, self.max_probe,
                self.table.seed), kw

    def slot_args(self, device) -> tuple[tuple, dict]:
        """``probe_slots``' positional and keyword arguments on ``device``."""
        key_lo, key_hi, queries, kw = self._inputs(device)
        return (key_lo, key_hi, queries, self.max_probe, self.table.seed), kw

    def _inputs(self, device):
        kw = {}
        if self.bounds:
            kw["block_probe"] = torch.from_numpy(self.table.block_max_probe()).to(device)
        return (_int32(self.table.key_lo, device), _int32(self.table.key_hi, device),
                raw_queries(self.queries, device), kw)


def _int32(words: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(words, np.uint32).view(np.int32)).to(device)


def raw_queries(kmers: np.ndarray, device) -> torch.Tensor:
    """uint64 kmers -> the int64 tensor of the same bits that the probe takes."""
    return torch.from_numpy(np.array(kmers, np.uint64).view(np.int64)).to(device)


def expected_slots(table: layout.TableArrays, queries: np.ndarray, max_probe: int) -> np.ndarray:
    """int64 slot per query or -1, one query at a time: mix, skip the
    sentinel, walk rounds p < max_probe of the chain, first matching lane."""
    lo, hi = feistel_mix(*split_u64(queries), seed=table.seed)
    block = min(layout.CHAIN_BLOCK, table.n_buckets)
    out = np.full(len(queries), -1, dtype=np.int64)
    for i in range(len(queries)):
        if lo[i] == layout.EMPTY and hi[i] == layout.EMPTY:
            continue
        b0 = int(bucket_from_mlo(lo[i], table.n_buckets))
        for p in range(max_probe):
            b = (b0 & ~(block - 1)) | ((b0 + p) & (block - 1))
            lanes = np.flatnonzero((table.key_lo[b] == lo[i]) & (table.key_hi[b] == hi[i]))
            if len(lanes):
                out[i] = b * layout.BUCKET_KEYS + lanes[0]
                break
    return out


def sentinel_query(seed: int) -> np.uint64:
    """The raw kmer that mixes to the all-ones empty sentinel."""
    lo, hi = feistel_unmix(np.array([MASK32], np.uint32), np.array([MASK32], np.uint32), seed)
    return (np.uint64(hi[0]) << np.uint64(32)) | np.uint64(lo[0])


def _keys(rng, n):
    return np.unique(rng.integers(0, 1 << 62, n, dtype=np.uint64))


def _queries(rng, keys, seed, n_hits, n_misses):
    """Hits drawn from ``keys``, uniform misses and two sentinel queries."""
    return np.concatenate([
        rng.choice(keys, n_hits), rng.integers(0, 1 << 62, n_misses, dtype=np.uint64),
        np.full(2, sentinel_query(seed), np.uint64),
    ])


def homed_at(rng, bucket: int, n_buckets: int, seed: int, n: int) -> np.ndarray:
    """n distinct raw kmers whose home bucket is ``bucket``."""
    found = []
    while sum(len(f) for f in found) < n:
        cand = rng.integers(0, 1 << 62, 1 << 16, dtype=np.uint64)
        m_lo, _ = feistel_mix(*split_u64(cand), seed=seed)
        found.append(cand[bucket_from_mlo(m_lo, n_buckets) == bucket])
    return np.unique(np.concatenate(found))[:n]


def cases() -> list[ProbeCase]:
    rng = np.random.default_rng(17)
    out = []

    def add(name, table, queries, valid=None, counts0=None, rounds=None, unbounded=()):
        """The case at each round bound, with the table's block bounds, and
        at each round bound in ``unbounded`` without them."""
        queries = np.asarray(queries, dtype=np.uint64)
        counts0 = np.zeros(table.n_slots, np.uint32) if counts0 is None else counts0
        for max_probe in sorted(set(rounds or (1, table.max_probe))):
            out.append(ProbeCase(f"{name}_p{max_probe}", table, queries, valid, counts0,
                                 max_probe))
        for max_probe in unbounded:
            out.append(ProbeCase(f"{name}_nobounds_p{max_probe}", table, queries, valid,
                                 counts0, max_probe, bounds=False))

    keys = _keys(rng, 3000)
    table = layout.build_table(keys)
    add("sentinel", table, _queries(rng, keys, table.seed, 2000, 1000))
    for n_buckets, n_keys in ((1, 6), (8, 60), (64, 480)):
        keys = _keys(rng, n_keys)
        table = layout.build_table(keys, n_buckets=n_buckets, max_probe_limit=64)
        rounds = (1, table.max_probe, layout.MAX_PROBE_HARD)  # 64 revisits buckets
        add(f"buckets{n_buckets}", table, _queries(rng, keys, table.seed, 600, 300),
            rounds=rounds, unbounded=(table.max_probe,) if n_buckets == 8 else ())
    # chains that wrap inside 128-bucket chain blocks
    keys = _keys(rng, 7600)
    table = layout.build_table(keys, n_buckets=1 << 10, max_probe_limit=64)
    add("wrapping_chains", table, _queries(rng, keys, table.seed, 3000, 500),
        unbounded=(table.max_probe,))
    # a seeded table: every round constant plus the seed
    keys = _keys(rng, 2000)
    table = layout.build_table(keys, seed=29)
    add("seeded", table, _queries(rng, keys, table.seed, 2000, 500))
    # both words with the high bit set, and the all-ones kmer
    keys = np.unique(np.concatenate([
        _keys(rng, 1500) | np.uint64(0x8000000080000000),
        np.array([0xFFFFFFFFFFFFFFFF, 0x80000000FFFFFFFF, 0xFFFFFFFF80000000], np.uint64),
    ]))
    table = layout.build_table(keys)
    add("high_bits", table, _queries(rng, keys, table.seed, 2000, 500))
    # invalid queries count nothing; counts wrap past 2**32
    keys = _keys(rng, 1000)
    table = layout.build_table(keys)
    queries = np.repeat(keys[:300], 9)
    add("invalid", table, queries, valid=rng.random(len(queries)) < 0.6)
    add("counts_wrap", table, queries,
        counts0=np.full(table.n_slots, (1 << 32) - 5, np.uint32))
    add("no_queries", table, np.zeros(0, np.uint64))
    # an all-true valid array counts as no array
    add("valid_array", table, queries, valid=np.ones(len(queries), bool))
    # one hot key 10^4 times among hits and misses: its warp-aggregated adds
    # wrap past 2**32
    queries = np.concatenate([np.full(10_000, keys[7], np.uint64), rng.choice(keys, 2000),
                              rng.integers(0, 1 << 62, 1000, dtype=np.uint64)])
    add("skewed", table, rng.permutation(queries),
        counts0=np.full(table.n_slots, (1 << 32) - 5000, np.uint32))
    # chain blocks with different bounds: 40 keys homed in bucket 126 of
    # block 3 chain past the block's end and wrap, the other blocks hold no
    # chain; misses homed in every block and in the long chain's bucket;
    # round bounds below the long chain's
    hot = 3 * layout.CHAIN_BLOCK + 126
    chained = homed_at(rng, hot, 1 << 10, 0, 140)
    keys = np.unique(np.concatenate([_keys(rng, 1200), chained[:40]]))
    table = layout.build_table(keys, n_buckets=1 << 10, max_probe_limit=64)
    queries = np.concatenate([_queries(rng, keys, table.seed, 1500, 2000), chained,
                              np.repeat(chained[:40], 3)])
    add("block_bounds", table, queries, rounds=(1, 2, 3, table.max_probe, 64),
        unbounded=(table.max_probe,))
    # raw words whose int64 view is negative: hits and misses with bit 63 set
    top = np.uint64(1 << 63)
    keys = _keys(rng, 1500) | top
    table = layout.build_table(keys)
    add("negative_words", table, np.concatenate([
        rng.choice(keys, 2000), rng.integers(0, 1 << 62, 500, dtype=np.uint64) | top]))
    return out
