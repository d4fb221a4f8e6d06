"""The port's host copies (table layout, oracle, index loading) against the
JAX package's originals, array for array."""
import numpy as np
import pytest

from kmer_mapper_tpu import oracle as ref_oracle
from kmer_mapper_tpu.index import kmer_index as ref_ki
from kmer_mapper_tpu.index import layout as ref_layout
from kmer_mapper_tpu_torch import oracle
from kmer_mapper_tpu_torch.index import kmer_index as ki
from kmer_mapper_tpu_torch.index import layout


def _keys(seed, n):
    rng = np.random.default_rng(seed)
    return np.unique(rng.integers(0, 1 << 62, n, dtype=np.uint64))


def _assert_tables_equal(got, expect):
    for name in ("key_lo", "key_hi", "build_slots"):
        np.testing.assert_array_equal(getattr(got, name), getattr(expect, name))
    assert (got.n_buckets, got.max_probe, got.seed) == (
        expect.n_buckets, expect.max_probe, expect.seed,
    )
    np.testing.assert_array_equal(got.block_max_probe(), expect.block_max_probe())


@pytest.mark.parametrize(
    "n_keys,kw",
    [
        (10, dict(n_buckets=4)),
        (150, dict(n_buckets=64)),
        (3000, dict(n_buckets=1 << 10)),
        (13000, dict()),  # sized by the default load: 1 << 12 buckets
        (3800, dict(max_load=0.95, max_probe_limit=32)),  # dense, chained
    ],
)
def test_build_and_query_table_match(n_keys, kw):
    keys = _keys(n_keys, n_keys)
    got = layout.build_table(keys, **kw)
    expect = ref_layout.build_table(keys, **kw)
    _assert_tables_equal(got, expect)
    if "max_load" in kw:
        assert got.max_probe > 1
    rng = np.random.default_rng(1)
    queries = np.concatenate([keys, rng.integers(0, 1 << 62, 500, dtype=np.uint64)])
    slots = layout.query_table(got, queries)
    np.testing.assert_array_equal(slots, ref_layout.query_table(expect, queries))
    assert (slots[: len(keys)] >= 0).all()


def test_single_bucket_table():
    keys = np.array([5, 9, 1 << 40], dtype=np.uint64)
    got = layout.build_table(keys, n_buckets=1)
    _assert_tables_equal(got, ref_layout.build_table(keys, n_buckets=1))
    assert got.n_buckets == 1
    expect = ref_layout.query_table(ref_layout.build_table(keys, n_buckets=1), keys)
    np.testing.assert_array_equal(layout.query_table(got, keys), expect)
    assert (expect >= 0).all()


def test_index_node_counts_match():
    rng = np.random.default_rng(3)
    entries = _keys(3, 2000)
    entries = np.concatenate([entries, entries[:300]])  # repeated kmers
    nodes = rng.integers(0, 500, len(entries)).astype(np.int32)
    freqs = rng.integers(0, 2000, len(entries)).astype(np.uint16)
    got = ki.KmerIndex.from_entries(entries, nodes, freqs)
    expect = ref_ki.TpuKmerIndex.from_entries(entries, nodes, freqs)
    _assert_tables_equal(got.table, expect.table)
    for name in ("entry_slot", "entry_node", "entry_frequency"):
        np.testing.assert_array_equal(getattr(got, name), getattr(expect, name))
    assert (got.max_node_id, got.n_unique) == (expect.max_node_id, expect.n_unique)
    slot_counts = rng.integers(0, 1 << 20, got.table.n_slots).astype(np.uint32)
    for max_frequency in (1000, 3):
        np.testing.assert_array_equal(
            got.node_counts(slot_counts, max_frequency),
            expect.node_counts(slot_counts, max_frequency),
        )


def test_oracle_copy_matches():
    rng = np.random.default_rng(4)
    seq = np.frombuffer(
        "".join(rng.choice(list("ACGTNacgtn"), 3000)).encode(), np.uint8
    )
    codes = oracle.encode_bytes(seq)
    np.testing.assert_array_equal(codes, ref_oracle.encode_bytes(seq))
    with pytest.raises(ValueError):
        oracle.encode_bytes(np.frombuffer(b"ACGX", np.uint8))
    lengths = np.array([100, 5, 900, 31, 1964])
    for k in (1, 16, 31):
        h = oracle.kmer_hashes_ragged(codes, lengths, k)
        np.testing.assert_array_equal(h, ref_oracle.kmer_hashes_ragged(codes, lengths, k))
        np.testing.assert_array_equal(
            oracle.revcomp_hash(h, k), ref_oracle.revcomp_hash(h, k)
        )
    kmers = ref_oracle.kmer_hashes(codes, 21)
    entries = np.concatenate([kmers[::7], kmers[::11]])
    nodes = rng.integers(0, 50, len(entries)).astype(np.int32)
    got = oracle.build_kmer_index(entries, nodes, 997)
    expect = ref_oracle.build_kmer_index(entries, nodes, 997)
    for f in ("hashes_to_index", "n_kmers", "kmers", "nodes", "frequencies"):
        np.testing.assert_array_equal(getattr(got, f), getattr(expect, f))
    for max_frequency in (1000, 1):
        np.testing.assert_array_equal(
            oracle.map_kmers_to_index(got, kmers, max_frequency=max_frequency),
            ref_oracle.map_kmers_to_index(expect, kmers, max_frequency=max_frequency),
        )


def test_reference_npz_round_trip_between_packages(tmp_path):
    rng = np.random.default_rng(6)
    entries = _keys(6, 800)
    nodes = rng.integers(0, 90, len(entries)).astype(np.int32)
    arrays = ref_oracle.build_kmer_index(entries, nodes, 1009)
    ref_ki.save_reference_npz(tmp_path / "a.npz", arrays)
    ki.save_reference_npz(tmp_path / "b.npz", oracle.build_kmer_index(entries, nodes, 1009))
    for path in ("a.npz", "b.npz"):
        got = ki.load_reference_npz(tmp_path / path)
        expect = ref_ki.load_reference_npz(tmp_path / path)
        for f in ("hashes_to_index", "n_kmers", "kmers", "nodes", "frequencies", "modulo"):
            np.testing.assert_array_equal(getattr(got, f), getattr(expect, f))
    # extensionless path resolves to path + ".npz", as the reference does
    index = ki.load_index(str(tmp_path / "a"))
    ref_index = ref_ki.load_index(str(tmp_path / "a"))
    np.testing.assert_array_equal(index.entry_slot, ref_index.entry_slot)
    _assert_tables_equal(index.table, ref_index.table)
