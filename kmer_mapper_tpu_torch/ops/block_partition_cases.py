"""Hazard inputs for the block partition (``ops/block_partition.py``,
``csrc/block_partition.cu``).

Two kinds:

* :func:`table_cases`, whose keys come with a table and expected counts:
  every case of ``ops/stream_count_cases.py`` (a poly-A window, tables of
  1, 4 and 64 buckets, 1024 buckets with chains, deep chains, invalid
  queries, no queries at all) and :func:`edge_table_case`, keys homed in the
  first and last bucket of chain blocks and in bucket ``n_buckets - 1``;
* :func:`cases`, key sets alone (``PartitionCase``): the keys of every
  table case, plus words at the extremes of m_lo and m_hi beside invalid
  keys, the reverse-complement keys of two hash-key cases in window order,
  tables of 2**25, 2**26 and 2**29 buckets, whose histograms (262,145,
  524,289 and 4,194,305 bins) do not fit in shared memory, and counts that
  end inside the radix scatter's 8,192-key tiles, on an odd key or with
  one or two keys in a slab's last tile.

Everything is made from numpy seeds, independent of the kernel and its
twin. Used by ``tests/test_torch_block_partition.py``,
``tests/test_torch_partition_kernels.py`` and ``chip_smoke.py``.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..index import layout
from . import hash_keys_cases, stream_count_cases
from .block_partition import INVALID_KEY
from .u32hash import bucket_shift, feistel_mix, split_u64


@dataclasses.dataclass
class PartitionCase:
    name: str
    keys: np.ndarray  # int64 sort keys, in the order the partition takes them
    n_buckets: int

    @property
    def bpb(self) -> int:
        return min(layout.CHAIN_BLOCK, self.n_buckets)

    def inputs(self, device) -> tuple:
        """``block_partition``'s arguments on ``device``."""
        return torch.from_numpy(self.keys.copy()).to(device), self.n_buckets, self.bpb


def mixed_keys(m_lo: np.ndarray, m_hi: np.ndarray) -> np.ndarray:
    """int64 sort keys of uint32-valued mixed words: high word ``m_lo ^
    2**31``, low word ``m_hi``."""
    m_lo = np.asarray(m_lo, np.uint64) ^ np.uint64(1 << 31)
    return ((m_lo << np.uint64(32)) | np.asarray(m_hi, np.uint64)).view(np.int64)


def query_keys(case: stream_count_cases.Case) -> np.ndarray:
    """The keys of a table case's queries in query order, as the raw-word
    path makes them: mixed with the table's seed, invalid ones all-ones."""
    m_lo, m_hi = feistel_mix(*split_u64(case.queries), seed=case.table.seed)
    keys = mixed_keys(m_lo, m_hi)
    keys[~case.valid] = INVALID_KEY
    return keys


def edge_table_case(n_buckets: int = 1 << 10) -> stream_count_cases.Case:
    """A table of random keys plus keys homed in the first and last bucket
    of every chain block and in bucket ``n_buckets - 1``, queried with each
    of those keys 1..3 times and with random misses."""
    rng = np.random.default_rng(77)
    cand = np.unique(rng.integers(0, 1 << 62, 400 * n_buckets, dtype=np.uint64))
    bucket = feistel_mix(*split_u64(cand))[0] >> np.uint32(bucket_shift(n_buckets))
    local = bucket % layout.CHAIN_BLOCK
    edge = cand[(local == 0) | (local == layout.CHAIN_BLOCK - 1) | (bucket == n_buckets - 1)]
    edge = rng.permutation(edge)[: 3 * n_buckets // layout.CHAIN_BLOCK * 4]
    others = rng.choice(np.setdiff1d(cand, edge), 2 * n_buckets, replace=False)
    table = layout.build_table(np.concatenate([edge, others]), n_buckets=n_buckets)
    assert table.n_buckets == n_buckets and table.seed == 0
    queries = np.concatenate([np.repeat(edge, rng.integers(1, 4, len(edge))),
                              rng.choice(others, 500),
                              rng.integers(0, 1 << 62, 500, dtype=np.uint64)])
    queries = rng.permutation(queries)
    return stream_count_cases.Case("block_edges_table", table, queries,
                                   np.ones(len(queries), bool),
                                   np.zeros(table.n_slots, np.uint32))


def table_cases(poly_a: int = 5000) -> list[stream_count_cases.Case]:
    return stream_count_cases.cases(poly_a=poly_a) + [edge_table_case()]


def _extreme_words(rng, n_buckets: int) -> PartitionCase:
    """m_lo of 0, of 2**32 - 1 and at every block bound; m_hi of 0 and
    2**32 - 1 beside them (the largest valid key is one below the invalid
    key); invalid keys among them."""
    n_blocks = n_buckets // min(layout.CHAIN_BLOCK, n_buckets)
    top = 32 - (n_blocks.bit_length() - 1)  # m_lo bits below the block id
    starts = np.arange(n_blocks, dtype=np.uint64) << np.uint64(top) if top < 32 else \
        np.zeros(1, np.uint64)
    m_lo = np.concatenate([starts, starts + np.uint64((1 << top) - 1),
                           [0, 0xFFFFFFFF, 0xFFFFFFFF]]).astype(np.uint64)
    m_hi = np.concatenate([rng.integers(0, 1 << 32, 2 * len(starts), dtype=np.uint64),
                           [0, 0, 0xFFFFFFFE]]).astype(np.uint64)
    keys = np.concatenate([mixed_keys(m_lo, m_hi), np.full(40, INVALID_KEY, np.int64),
                           mixed_keys(*(rng.integers(0, 1 << 32, 2000, dtype=np.uint64)
                                        for _ in range(2)))])
    return PartitionCase(f"extreme_words_{n_buckets}", rng.permutation(keys), n_buckets)


def _revcomp_keys(case: hash_keys_cases.HashCase, n_buckets: int, rng) -> PartitionCase:
    """A hash-key case's forward and reverse-complement keys (the oracle's,
    from the buffer) in a random order, as the main path hands them on."""
    assert case.revcomp
    return PartitionCase(f"revcomp_{case.name}", rng.permutation(case.expected_keys()),
                         n_buckets)


def _wide_table(rng, n_buckets: int, n_keys: int) -> PartitionCase:
    """Random keys in a table of many chain blocks, and some around its
    middle and top buckets."""
    shift = bucket_shift(n_buckets)
    buckets = np.concatenate([n_buckets // 2 - 3 + np.arange(40), n_buckets - 1 - np.arange(40)])
    m_lo = (buckets.astype(np.uint64) << np.uint64(shift)) | rng.integers(
        0, 1 << shift, len(buckets), dtype=np.uint64)
    m_hi = rng.integers(0, 1 << 32, len(buckets), dtype=np.uint64)
    keys = np.concatenate([mixed_keys(m_lo, m_hi),
                           mixed_keys(*(rng.integers(0, 1 << 32, n_keys, dtype=np.uint64)
                                        for _ in range(2)))])
    return PartitionCase(f"wide_table_{n_buckets}", rng.permutation(keys), n_buckets)


def _tile_tail(rng, n_buckets: int, n_keys: int) -> PartitionCase:
    """``n_keys`` random keys, one in 50 invalid, for the scatter's tiles of
    8,192 keys: a count that ends a tile on an odd key, or leaves one or
    two keys in a slab's last tile at slabs of 128 keys, and slabs of
    several tiles plus a remainder at a few slabs."""
    keys = mixed_keys(*(rng.integers(0, 1 << 32, n_keys, dtype=np.uint64) for _ in range(2)))
    keys[rng.random(n_keys) < 0.02] = INVALID_KEY
    return PartitionCase(f"tile_tail_{n_buckets}_{n_keys}", keys, n_buckets)


def cases(poly_a: int = 5000) -> list[PartitionCase]:
    rng = np.random.default_rng(4096)
    out = [PartitionCase(c.name, query_keys(c), c.table.n_buckets) for c in table_cases(poly_a)]
    out += [_extreme_words(rng, n) for n in (1, 4, 64, 128, 1 << 12)]
    hashed = {c.name: c for c in hash_keys_cases.cases()}
    out += [_revcomp_keys(hashed["plane_k31_L151_rc1_s0_n3"], 1 << 10, rng),
            _revcomp_keys(hashed["ragged_poly_a_k31_b0_rc1_s0"], 1 << 6, rng)]
    out += [_wide_table(rng, 1 << 25, 200_000), _wide_table(rng, 1 << 29, 20_000)]
    # the scatter's tiles: the human-scale table (digits of 128, 128 and 33);
    # counts that end inside a tile on an odd key, or one or two keys past
    # a whole number of 128-key slabs; slabs shorter than a tile (at a wave
    # of slabs) and of several tiles plus a remainder (at 1 or 3)
    tiles = np.random.default_rng(4097)
    out += [_wide_table(tiles, 1 << 26, 60_000), _tile_tail(tiles, 1 << 20, 21_717),
            _tile_tail(tiles, 1 << 29, 41_346), _tile_tail(tiles, 1 << 25, 16_385)]
    return out
