"""The block partition's plain twin against the JAX package's sort and
block offsets, the stream path through it against JAX's
``stream_probe_count_mixed``, and the chunk steps' use of it, on the hazard
cases of ``ops/block_partition_cases.py``. Tolerance 0: offsets, window
contents and counts are integers and must be equal.

The jax-free tests of the CUDA kernels and their twin are in
test_torch_partition_kernels.py."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from kmer_mapper_tpu.ops import stream_probe as ref_sp
from kmer_mapper_tpu_torch import oracle
from kmer_mapper_tpu_torch.index import kmer_index, layout
from kmer_mapper_tpu_torch.io import readers
from kmer_mapper_tpu_torch.models.mapper import KmerMapper, MapperConfig
from kmer_mapper_tpu_torch.ops import block_partition, block_partition_cases, stream_probe
from kmer_mapper_tpu_torch.ops.block_partition_cases import mixed_keys
from kmer_mapper_tpu_torch.ops.u32hash import bucket_shift, split_u64
from kmer_mapper_tpu_torch.scripts import partition_dissect

CASES = {c.name: c for c in block_partition_cases.cases()}
TABLE_CASES = {c.name: c for c in block_partition_cases.table_cases()}
# the JAX kernel schedules at most 8 rounds at aug=1 (stream_probe.py:175)
JAX_TABLE_CASES = [n for n, c in TABLE_CASES.items() if c.table.max_probe <= 8]
CAP = 128  # the JAX kernel's tile, and its stream path's tail of 2 * CAP invalid queries


def _words(keys: np.ndarray):
    """uint32 (m_lo, m_hi) of int64 sort keys."""
    u = keys.view(np.uint64)
    return ((u >> np.uint64(32)) ^ np.uint64(1 << 31)).astype(np.uint32), \
        (u & np.uint64(0xFFFFFFFF)).astype(np.uint32)


def _jax_padded(keys: np.ndarray):
    """The keys' mixed words with JAX's invalid tail, (-n) % CAP + 2 * CAP
    all-ones pairs, as its stream path pads them."""
    m_lo, m_hi = _words(keys)
    pad = np.full((-len(keys)) % CAP + 2 * CAP, 0xFFFFFFFF, np.uint32)
    return np.concatenate([m_lo, pad]), np.concatenate([m_hi, pad])


def _jax_sorted(keys: np.ndarray, n_buckets: int):
    """JAX's sorted keys (the two-operand ``lax.sort`` by m_lo of
    ``stream_probe_count_mixed``) and their ``block_offsets``."""
    m_lo, m_hi = _jax_padded(keys)
    s_lo, s_hi = lax.sort((jnp.asarray(m_lo), jnp.asarray(m_hi)), dimension=0, num_keys=1,
                          is_stable=False)
    off = ref_sp.block_offsets(s_lo, n_buckets, min(layout.CHAIN_BLOCK, n_buckets))
    return mixed_keys(np.asarray(s_lo), np.asarray(s_hi)), np.asarray(off).astype(np.int64)


def _by_window(keys: np.ndarray, off: np.ndarray) -> np.ndarray:
    """The keys of windows [off[b], off[b+1]), each window sorted, in block
    order."""
    window = np.repeat(np.arange(len(off) - 1), np.diff(off))
    inside = keys[off[0]:off[-1]]
    return inside[np.lexsort((inside, window))]


def _check_against_jax(case, grouped, off):
    """``grouped`` and ``off`` against JAX's sort and offsets: offsets ==
    JAX's ``block_offsets`` over its sorted m_lo, ended at the invalid
    tail; each window == JAX's sorted window (the invalid keys taken out),
    as multisets; the invalid keys after the last window; a permutation."""
    assert off.dtype == torch.int32 and grouped.dtype == torch.int64
    s_keys, s_off = _jax_sorted(case.keys, case.n_buckets)
    is_valid = s_keys != block_partition.INVALID_KEY
    n_valid = int(is_valid.sum())
    np.testing.assert_array_equal(off.numpy(), np.minimum(s_off, n_valid))
    # JAX's windows ended at the invalid tail hold the valid keys of its
    # full windows: the two-operand sort by m_lo alone may leave a valid key
    # of m_lo 2**32 - 1 among the invalid ones
    window = np.repeat(np.arange(len(s_off) - 1), np.diff(s_off))
    valid_keys, valid_window = s_keys[is_valid], window[is_valid]
    expect = valid_keys[np.lexsort((valid_keys, valid_window))]
    got = grouped.numpy()
    np.testing.assert_array_equal(_by_window(got, off.numpy().astype(np.int64)), expect)
    assert (got[n_valid:] == block_partition.INVALID_KEY).all()
    np.testing.assert_array_equal(np.sort(got), np.sort(case.keys))  # a permutation


@pytest.mark.parametrize("name", list(CASES))
def test_twin_matches_jax_sort_and_offsets(name):
    """The twin's partition == JAX's sort and block offsets
    (:func:`_check_against_jax`)."""
    case = CASES[name]
    before = dict(block_partition.launch_counts)
    grouped, off = block_partition.block_partition(*case.inputs("cpu"))
    assert block_partition.launch_counts["block_partition_reference"] == (
        before["block_partition_reference"] + 1)
    _check_against_jax(case, grouped, off)


@pytest.mark.parametrize("n_slabs", [3, 264])
@pytest.mark.parametrize("name", list(CASES))
def test_radix_pieces_match_jax_sort_and_offsets(name, n_slabs):
    """The radix route's plain pieces (per LSD pass the slab rows of its
    digit, their scan and the stable slot rule; then the offsets of the
    sorted keys) == JAX's sort and block offsets, at 3 slabs and at 264
    (one wave of the scatter kernel on an H100)."""
    case = CASES[name]
    keys, n_buckets, bpb = case.inputs("cpu")
    _check_against_jax(case, *block_partition.radix_partition_reference(
        keys, n_buckets, bpb, n_slabs))


@pytest.mark.parametrize("name", list(CASES))
def test_device_count_partition_of_a_capacity_buffer_matches_jax(name):
    """The ragged step's form: the keys at the front of a capacity-sized
    buffer whose tail is garbage (random words and invalid keys), their
    number an int32 count tensor; the partition of the count's keys ==
    JAX's sort and offsets of ``keys[:n]`` (:func:`_check_against_jax`),
    the tail left as it was."""
    case = CASES[name]
    keys, n_buckets, bpb = case.inputs("cpu")
    rng = np.random.default_rng(len(name))
    tail = rng.integers(-(1 << 63), (1 << 63) - 1, 500, dtype=np.int64)
    tail[::4] = block_partition.INVALID_KEY
    buffer = torch.cat([keys, torch.from_numpy(tail)])
    n = keys.shape[0]
    grouped, off = block_partition.block_partition(
        buffer, n_buckets, bpb, count=torch.tensor([n, n], dtype=torch.int32))
    _check_against_jax(case, grouped[:n], off)
    assert torch.equal(grouped[n:], buffer[n:])


def test_cases_cover_the_hazards():
    edges = TABLE_CASES["block_edges_table"]
    n_buckets = edges.table.n_buckets
    keys = block_partition_cases.query_keys(edges)
    bucket = _words(keys)[0] >> np.uint32(bucket_shift(n_buckets))
    local = bucket % layout.CHAIN_BLOCK
    assert (bucket == n_buckets - 1).any() and (local == 0).sum() > 10
    assert (local == layout.CHAIN_BLOCK - 1).sum() > 10 and edges.table.max_probe > 1
    sizes = {c.n_buckets for c in CASES.values()}
    assert {1, 4, 64, 1 << 25, 1 << 29} <= sizes
    assert not CASES["no_queries"].keys.size
    poly = CASES["poly_a_window"]
    assert np.bincount(block_partition.block_ids(
        torch.from_numpy(poly.keys), poly.n_buckets // poly.bpb).numpy()).max() >= 5000
    # tables past the cursor route's shared histogram, and of three radix passes
    assert any(c.n_buckets // c.bpb + 1 > partition_dissect.SHARED_BINS for c in CASES.values())
    assert any(len(block_partition.radix_passes(c.n_buckets // c.bpb)) == 3
               for c in CASES.values())
    assert all(k.startswith("revcomp_") for k in CASES if "rc1" in k)


def _jax_count(case, keys: np.ndarray) -> np.ndarray:
    """JAX ``stream_probe_count_mixed`` (interpret mode) on the keys' mixed
    words, tail-padded, from the case's starting counts; slot order."""
    t = case.table
    p_lo, p_hi = ref_sp.plane_keys(t.key_lo, t.key_hi)
    m_lo, m_hi = _jax_padded(keys)
    out = ref_sp.stream_probe_count_mixed(
        jnp.asarray(p_lo), jnp.asarray(p_hi),
        jnp.asarray(ref_sp.slot_to_plane(case.counts0, t.n_buckets)),
        jnp.asarray(m_lo), jnp.asarray(m_hi), t.max_probe, cap=CAP, interpret=True,
        block_probe=t.block_max_probe(),
    )
    return ref_sp.plane_to_slot(np.asarray(out), t.n_buckets)


@pytest.mark.parametrize("name", JAX_TABLE_CASES)
def test_stream_path_matches_jax_stream_probe_count_mixed(name):
    """``stream_probe_count_keys`` on the valid queries' keys in query order
    (what the hash kernels hand on) and ``stream_probe_count`` on the raw
    words with their validity mask, each through the partition twin, ==
    JAX's ``stream_probe_count_mixed`` == the host oracle."""
    case = TABLE_CASES[name]
    t = case.table
    key_lo, key_hi, counts, _, _, block_probe, _, _ = case.inputs("cpu")
    keys = block_partition_cases.query_keys(case)
    expect = _jax_count(case, keys)
    np.testing.assert_array_equal(expect, case.expected())

    got = stream_probe.stream_probe_count_keys(
        key_lo, key_hi, counts.clone(), torch.from_numpy(keys[case.valid]), block_probe)
    np.testing.assert_array_equal(got.numpy().view(np.uint32), expect)
    q_lo, q_hi = (torch.from_numpy(w.astype(np.int64)) for w in split_u64(case.queries))
    got = stream_probe.stream_probe_count(key_lo, key_hi, counts.clone(), q_lo, q_hi,
                                          torch.from_numpy(case.valid), t.seed, block_probe)
    np.testing.assert_array_equal(got.numpy().view(np.uint32), expect)


@pytest.mark.parametrize("strided", [True, False])
def test_map_chunk_partitions_and_never_sorts(strided, monkeypatch):
    """On the CPU each chunk of either step goes through the partition twin
    once, and neither ``torch.sort`` nor ``torch.searchsorted`` runs; the
    node counts equal the oracle's."""
    rng = np.random.default_rng(11 + strided)
    k, L = 15, 40
    lengths = np.full(90, L) if strided else rng.integers(k - 3, 70, 150)
    codes = rng.integers(0, 4, int(lengths.sum()))
    kmers = oracle.kmer_hashes_ragged(codes, lengths, k)
    entries = np.concatenate([kmers[::7], rng.integers(0, 1 << 30, 50, dtype=np.uint64)])
    arrays = oracle.build_kmer_index(entries, rng.integers(0, 40, len(entries)), 1021)
    config = MapperConfig(k=k, buf=1024, max_reads=128, read_len=L if strided else 0)
    mapper = KmerMapper(kmer_index.KmerIndex.from_arrays(arrays), config, "cpu")
    bases = np.frombuffer(b"ACGT", np.uint8)[codes]
    starts = np.concatenate([[0], np.cumsum(lengths)[:-1]])
    chunks = list(readers.pack_for_device(iter([readers.SequenceChunk(bases, starts)]),
                                          config.buf, config.max_reads, k,
                                          read_len=config.read_len))
    assert len(chunks) > 1 and all(len(c) == 6 for c in chunks) == strided

    def forbidden(*args, **kwargs):
        raise AssertionError("the chunk step sorted or bisected")

    monkeypatch.setattr(torch, "sort", forbidden)
    monkeypatch.setattr(torch.Tensor, "sort", forbidden)
    monkeypatch.setattr(torch, "searchsorted", forbidden)
    before = dict(block_partition.launch_counts)
    for packed, lens, n_bases, *_ in chunks:
        mapper.map_chunk(packed, lens, n_bases, strided=strided)
    monkeypatch.undo()
    assert block_partition.launch_counts == {
        **before, "block_partition_reference": before["block_partition_reference"] + len(chunks)}
    np.testing.assert_array_equal(mapper.node_counts(), oracle.map_kmers_to_index(arrays, kmers))
