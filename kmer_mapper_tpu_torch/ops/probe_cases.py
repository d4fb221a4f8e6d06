"""Hazard inputs for the gather probe, each with the slots and counts that a
plain numpy loop expects.

Every case stresses one corner of ``probe.probe_count``'s and
``probe.probe_slots``' contract: a query that mixes to the all-ones empty
sentinel, tables of 1, 8 and 64 buckets, chains that wrap inside their
chain block, a round bound of 1 and of the table's own (and 64, which
revisits buckets), a seeded table, key words with the high bit set, invalid
queries, counts that wrap past 2**32 and no queries at all. The expected
results come from :func:`expected_slots`, a loop over queries that is
independent of the kernel and its twin. Used by
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
    valid: np.ndarray  # bool per query (probe_count only)
    counts0: np.ndarray  # uint32[n_slots] starting counts, slot order
    max_probe: int

    def expected_slots(self) -> np.ndarray:
        return expected_slots(self.table, self.queries, self.max_probe)

    def expected_counts(self) -> np.ndarray:
        """counts0 + one per valid hit, wrapping like uint32."""
        slots = self.expected_slots()[self.valid]
        hits = np.bincount(slots[slots >= 0], minlength=self.table.n_slots)
        return ((self.counts0.astype(np.uint64) + hits.astype(np.uint64))
                & np.uint64(MASK32)).astype(np.uint32)

    def count_args(self, device) -> tuple:
        """``probe_count``'s arguments on ``device`` (a fresh copy of counts0)."""
        key_lo, key_hi, q_lo, q_hi = self._words(device)
        return (key_lo, key_hi, _int32(self.counts0.copy(), device), q_lo, q_hi,
                torch.from_numpy(self.valid).to(device), self.max_probe, self.table.seed)

    def slot_args(self, device) -> tuple:
        """``probe_slots``' arguments on ``device``."""
        return (*self._words(device), self.max_probe, self.table.seed)

    def _words(self, device):
        lo, hi = split_u64(self.queries)
        return (_int32(self.table.key_lo, device), _int32(self.table.key_hi, device),
                _int32(lo, device), _int32(hi, device))


def _int32(words: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(words, np.uint32).view(np.int32)).to(device)


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


def cases() -> list[ProbeCase]:
    rng = np.random.default_rng(17)
    out = []

    def add(name, table, queries, valid=None, counts0=None, rounds=None):
        queries = np.asarray(queries, dtype=np.uint64)
        valid = np.ones(len(queries), bool) if valid is None else valid
        counts0 = np.zeros(table.n_slots, np.uint32) if counts0 is None else counts0
        for max_probe in sorted(set(rounds or (1, table.max_probe))):
            out.append(ProbeCase(f"{name}_p{max_probe}", table, queries, valid, counts0,
                                 max_probe))

    keys = _keys(rng, 3000)
    table = layout.build_table(keys)
    add("sentinel", table, _queries(rng, keys, table.seed, 2000, 1000))
    for n_buckets, n_keys in ((1, 6), (8, 60), (64, 480)):
        keys = _keys(rng, n_keys)
        table = layout.build_table(keys, n_buckets=n_buckets, max_probe_limit=64)
        rounds = (1, table.max_probe, layout.MAX_PROBE_HARD)  # 64 revisits buckets
        add(f"buckets{n_buckets}", table, _queries(rng, keys, table.seed, 600, 300),
            rounds=rounds)
    # chains that wrap inside 128-bucket chain blocks
    keys = _keys(rng, 7600)
    table = layout.build_table(keys, n_buckets=1 << 10, max_probe_limit=64)
    add("wrapping_chains", table, _queries(rng, keys, table.seed, 3000, 500))
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
    return out
