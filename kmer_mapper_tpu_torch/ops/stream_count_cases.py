"""Hazard inputs for the stream-count kernel, each with its expected counts.

Every case stresses one corner of ``stream_probe.stream_count``'s contract:
a poly-A window, tables smaller than one chain block, a single bucket
(shift 32), chained and deeply chained tables, counts that wrap past 2**32,
no queries at all, slot indices past 2**31, and keys of one bucket that
share the count kernel's fingerprint. The expected counts come
from the host oracle (``layout.query_table``), independent of both the
kernel and its twin. Used by ``tests/test_torch_stream_probe.py`` and
``chip_smoke.py``.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..index import layout
from . import stream_probe
from .u32hash import bucket_shift, feistel_mix, split_u64, to_int32_bits


@dataclasses.dataclass
class Case:
    name: str
    table: layout.TableArrays
    queries: np.ndarray  # uint64 raw kmers
    valid: np.ndarray  # bool per query
    counts0: np.ndarray  # uint32[n_slots] starting counts, slot order

    def expected(self) -> np.ndarray:
        """counts0 + the oracle's hits, wrapping like uint32."""
        slots = layout.query_table(self.table, self.queries[self.valid])
        hits = np.bincount(slots[slots >= 0], minlength=self.table.n_slots)
        return self.counts0 + hits.astype(np.uint32)

    def inputs(self, device) -> tuple:
        """``stream_count``'s arguments on ``device``: sorted keys of the
        mixed queries, their block offsets, the table and a copy of counts0."""
        t = self.table
        lo, hi = (torch.from_numpy(w.astype(np.int64)).to(device)
                  for w in split_u64(self.queries))
        valid = torch.from_numpy(self.valid).to(device)
        sorted_keys = stream_probe.sort_queries(lo, hi, valid, t.seed)
        bpb = min(layout.CHAIN_BLOCK, t.n_buckets)
        off = stream_probe.block_offsets(sorted_keys, t.n_buckets, bpb)

        def words(a):
            return torch.from_numpy(np.ascontiguousarray(a).view(np.int32)).to(device)

        return (
            words(t.key_lo), words(t.key_hi), words(self.counts0.copy()),
            sorted_keys, off,
            torch.from_numpy(t.block_max_probe()).to(device),
            bucket_shift(t.n_buckets), bpb,
        )


def _keys(rng, n):
    return np.unique(rng.integers(0, 1 << 62, n, dtype=np.uint64))


def _case(name, table, queries, valid=None, counts0=None):
    queries = np.asarray(queries, dtype=np.uint64)
    if valid is None:
        valid = np.ones(len(queries), bool)
    if counts0 is None:
        counts0 = np.zeros(table.n_slots, np.uint32)
    return Case(name, table, queries, valid, counts0)


def cases(poly_a: int = 5000) -> list[Case]:
    """The hazard cases; ``poly_a`` is the number of copies of the poly-A
    k-mer (raw hash 0) that land in one chain block's window."""
    rng = np.random.default_rng(2024)
    out = []

    keys = _keys(rng, 5000)
    table = layout.build_table(keys)
    q = np.concatenate([rng.choice(keys, 2000), rng.integers(0, 1 << 62, 1500, dtype=np.uint64)])
    rng.shuffle(q)
    out.append(_case("hits_misses_masking", table, q, rng.random(len(q)) < 0.85))

    keys = np.concatenate([[np.uint64(0)], _keys(rng, 2000)])
    table = layout.build_table(keys)
    q = np.concatenate([np.zeros(poly_a, np.uint64), rng.choice(keys, 500)])
    out.append(_case("poly_a_window", table, q))

    keys = np.array([5, 9, 1 << 40], dtype=np.uint64)
    table = layout.build_table(keys, n_buckets=4)
    out.append(_case("table_4_buckets", table, [5, 5, 9, 123, 1 << 40, 7]))

    keys = _keys(rng, 150)
    table = layout.build_table(keys, n_buckets=64)
    q = np.concatenate([keys, keys[:40], rng.integers(0, 1 << 62, 90, dtype=np.uint64)])
    out.append(_case("table_64_buckets", table, q))

    keys = _keys(rng, 5)
    table = layout.build_table(keys, n_buckets=1)
    q = np.concatenate([keys, keys[:2], rng.integers(0, 1 << 62, 4, dtype=np.uint64)])
    out.append(_case("single_bucket_shift_32", table, q))

    keys = _keys(rng, 4000)
    table = layout.build_table(keys, n_buckets=1024)
    assert table.n_buckets == 1024 and table.max_probe > 1
    q = np.concatenate([keys, rng.integers(0, 1 << 62, 1000, dtype=np.uint64)])
    out.append(_case("chained_table", table, q, rng.random(len(q)) < 0.9))

    keys = _keys(rng, 3500)
    table = layout.build_table(keys, n_buckets=512, max_probe_limit=layout.MAX_PROBE_HARD)
    assert table.n_buckets == 512 and table.block_max_probe().max() > 8
    q = np.concatenate([keys, rng.integers(0, 1 << 62, 1000, dtype=np.uint64)])
    out.append(_case("deep_chains", table, q, rng.random(len(q)) < 0.95))

    keys = _keys(rng, 3000)
    table = layout.build_table(keys)
    counts0 = (0xFFFFFFFF - rng.integers(0, 3, table.n_slots)).astype(np.uint32)
    counts0[::5] = rng.integers(0, 1 << 32, len(counts0[::5]), dtype=np.int64)
    out.append(_case("counts_wrap_past_2_32", table, rng.choice(keys, 6000), counts0=counts0))

    keys = _keys(rng, 3000)
    table = layout.build_table(keys)
    counts0 = rng.integers(0, 1 << 32, table.n_slots, dtype=np.int64).astype(np.uint32)
    out.append(_case("no_queries", table, np.zeros(0, np.uint64), counts0=counts0))
    out.append(fingerprint_case())
    return out


def _fingerprints(m_hi: np.ndarray) -> np.ndarray:
    """The count kernel's 4-bit fingerprint of uint32 m_hi words, 1..15
    (``stream_probe.fingerprint``)."""
    return ((np.asarray(m_hi, np.uint64) * np.uint64(15)) >> np.uint64(32)) + np.uint64(1)


def fingerprint_case() -> Case:
    """A table of 64 buckets with empty slots, in which rows hold two keys of
    one fingerprint: one of each such pair is queried 1..3 times, the
    other never; and misses whose home bucket holds a key of their
    fingerprint, each of which the fingerprint lets through to a full
    compare that fails."""
    rng = np.random.default_rng(99)
    keys = _keys(rng, 300)
    table = layout.build_table(keys, n_buckets=64)
    lo, hi = feistel_mix(*split_u64(keys), seed=table.seed)
    raw = {(int(a), int(b)): k for a, b, k in zip(lo, hi, keys)}
    empty = (table.key_lo == layout.EMPTY) & (table.key_hi == layout.EMPTY)
    assert empty.any()
    fp = np.where(empty, 0, _fingerprints(table.key_hi))
    queried = []
    for r in range(table.n_buckets):
        lanes = np.flatnonzero(~empty[r])
        seen = {}
        for lane in lanes:
            if fp[r, lane] in seen:  # the first of the pair is queried, this one never
                queried.append(raw[int(table.key_lo[r, seen[fp[r, lane]]]),
                                   int(table.key_hi[r, seen[fp[r, lane]]])])
            seen.setdefault(fp[r, lane], lane)
    assert len(queried) >= 5
    queried = np.unique(np.array(queried, np.uint64))
    cand = rng.integers(0, 1 << 62, 4000, dtype=np.uint64)
    c_lo, c_hi = feistel_mix(*split_u64(cand), seed=table.seed)
    home = c_lo >> np.uint32(bucket_shift(table.n_buckets))
    shares = (fp[home] == _fingerprints(c_hi)[:, None]).any(axis=1)
    misses = cand[shares & ~np.isin(cand, keys)][:300]
    assert len(misses) >= 100
    q = rng.permutation(np.concatenate([np.repeat(queried, rng.integers(1, 4, len(queried))),
                                        misses]))
    return _case("fingerprint_collisions", table, q)


def huge_table_inputs(device, n_buckets: int = 1 << 29):
    """``stream_count`` arguments for a table with slot indices past 2**31
    (2**29 buckets: 2**32 slots, 16 GiB per word array), built on the
    device directly from mixed words, plus the expected hits as
    ``(slots, counts)``. Keys sit in buckets around ``n_buckets // 2``
    (slot 2**31 at the default size) and at the top of the table; each is queried 1..4 times, and a miss with
    the same bucket but another m_hi follows every key."""
    rng = np.random.default_rng(29)
    shift = bucket_shift(n_buckets)
    buckets = np.unique(np.concatenate([
        n_buckets // 2 - 3 + np.arange(40), n_buckets - 1 - 37 * np.arange(40),
    ])).astype(np.int64)
    lanes = np.arange(len(buckets)) % layout.BUCKET_KEYS
    m_lo = (buckets << shift) | rng.integers(0, 1 << shift, len(buckets))
    m_hi = rng.integers(0, 1 << 32, len(buckets), dtype=np.int64)
    m_hi[m_hi == 0xFFFFFFFF] = 0
    reps = rng.integers(1, 5, len(buckets))
    q_lo = np.concatenate([np.repeat(m_lo, reps), m_lo])
    q_hi = np.concatenate([np.repeat(m_hi, reps), (m_hi + 1) & 0xFFFFFFFF])

    key_lo = torch.full((n_buckets, layout.BUCKET_KEYS), -1, dtype=torch.int32, device=device)
    key_hi = torch.full_like(key_lo, -1)
    b_t = torch.from_numpy(buckets).to(device)
    l_t = torch.from_numpy(lanes).to(device)
    key_lo[b_t, l_t] = to_int32_bits(torch.from_numpy(m_lo).to(device))
    key_hi[b_t, l_t] = to_int32_bits(torch.from_numpy(m_hi).to(device))
    counts = torch.zeros(n_buckets * layout.BUCKET_KEYS, dtype=torch.int32, device=device)
    sorted_keys = stream_probe.sort_mixed(
        torch.from_numpy(q_lo).to(device), torch.from_numpy(q_hi).to(device)
    )
    bpb = layout.CHAIN_BLOCK
    off = stream_probe.block_offsets(sorted_keys, n_buckets, bpb)
    block_probe = torch.ones(n_buckets // bpb, dtype=torch.int32, device=device)
    args = (key_lo, key_hi, counts, sorted_keys, off, block_probe, shift, bpb)
    return args, (buckets * layout.BUCKET_KEYS + lanes, reps)


def nonzero_counts(counts: torch.Tensor, row: int = 1024):
    """(slots, values) of every nonzero entry of flat int32 counts, as int64
    numpy arrays in slot order. Works in rows, so tensors past 2**31
    entries need no single nonzero over all of them."""
    n = counts.numel()
    rows = counts[: n - n % row].view(-1, row)
    hot = torch.nonzero(rows.ne(0).any(dim=1)).squeeze(1)
    r, c = torch.nonzero(rows[hot], as_tuple=True)
    slots = [hot[r] * row + c]
    tail = torch.nonzero(counts[n - n % row :]).squeeze(1)
    slots.append(tail + (n - n % row))
    slots = torch.cat(slots)
    values = counts[slots].cpu().numpy().view(np.uint32).astype(np.int64)
    return slots.cpu().numpy(), values
