"""Every index form the port reads (``.tpuidx``, counter ``.npz``, pickled
counter indexes and bundles, reference ``.npz``, zip bundles) against the
JAX package's loaders, on the CPU: mirrors ``tests/test_index.py:109-192``,
``:292`` and ``tests/test_pickled_index.py``, plus ``.tpuidx`` files that
each package writes and the other reads."""
import io
import pickle
import sys
import types
import zipfile

import numpy as np
import pytest

from kmer_mapper_tpu import oracle as ref_oracle
from kmer_mapper_tpu.index import kmer_index as ref_ki
from kmer_mapper_tpu.index import pickled as ref_pickled
from kmer_mapper_tpu_torch import oracle
from kmer_mapper_tpu_torch.index import kmer_index as ki
from kmer_mapper_tpu_torch.index import layout, pickled


def _assert_same_index(got, expect):
    """A port KmerIndex equals a JAX TpuKmerIndex, array for array."""
    for name in ("key_lo", "key_hi"):
        np.testing.assert_array_equal(getattr(got.table, name), getattr(expect.table, name))
    assert (got.table.n_buckets, got.table.max_probe, got.table.seed) == (
        expect.table.n_buckets, expect.table.max_probe, expect.table.seed)
    for name in ("entry_slot", "entry_node", "entry_frequency"):
        np.testing.assert_array_equal(getattr(got, name), getattr(expect, name))
    assert (got.max_node_id, got.n_unique) == (expect.max_node_id, expect.n_unique)


def _slot_counts(index, queries):
    slots = layout.query_table(index.table, queries)
    return np.bincount(slots[slots >= 0], minlength=index.table.n_slots).astype(np.uint32)


def test_build_toy_index_matches_jax():
    got = ki.build_toy_index(n_unique=300, k=31, n_nodes=100, seed=7)
    expect = ref_ki.build_toy_index(n_unique=300, k=31, n_nodes=100, seed=7)
    for f in ("hashes_to_index", "n_kmers", "kmers", "nodes", "frequencies", "modulo"):
        np.testing.assert_array_equal(getattr(got, f), getattr(expect, f))


def test_tpuidx_file_roundtrip(tmp_path):
    index = ki.KmerIndex.from_arrays(ki.build_toy_index(n_unique=300, k=31, n_nodes=100, seed=7))
    path = tmp_path / "index.tpuidx.npz"
    index.to_file(path)
    loaded = ki.load_index(path)
    _assert_same_index(loaded, index)
    # the extensionless name resolves to name + ".npz", as the reference does
    _assert_same_index(ki.load_index(str(tmp_path / "index.tpuidx")), index)


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_tpuidx_files_pass_between_packages(tmp_path, writer):
    arrays = ki.build_toy_index(n_unique=500, k=31, n_nodes=120, seed=11)
    ref_arrays = ref_ki.build_toy_index(n_unique=500, k=31, n_nodes=120, seed=11)
    port, ref = ki.KmerIndex.from_arrays(arrays), ref_ki.TpuKmerIndex.from_arrays(ref_arrays)
    path = tmp_path / f"{writer}.tpuidx.npz"
    (port if writer == "port" else ref).to_file(path)
    got, expect = ki.load_index(path), ref_ki.load_index(path)
    _assert_same_index(got, expect)
    rng = np.random.default_rng(1)
    queries = np.concatenate([rng.choice(arrays.kmers, 2000),
                              rng.integers(0, 1 << 62, 300, dtype=np.uint64)])
    counts = _slot_counts(got, queries)
    np.testing.assert_array_equal(got.node_counts(counts), expect.node_counts(counts))
    np.testing.assert_array_equal(got.node_counts(counts), oracle.map_kmers_to_index(arrays, queries))


def test_load_index_reference_form(tmp_path):
    arrays = ki.build_toy_index(n_unique=300, k=31, n_nodes=100, seed=8)
    path = tmp_path / "index.npz"
    ki.save_reference_npz(path, arrays)
    index = ki.load_index(path)
    assert index.n_unique == len(np.unique(arrays.kmers))
    assert index.max_node_id == arrays.max_node_id()
    _assert_same_index(index, ref_ki.load_index(path))


def test_load_index_counter_form(tmp_path):
    keys = np.unique(np.random.default_rng(9).integers(0, 1 << 62, 100, dtype=np.uint64))
    path = tmp_path / "counter.npz"
    np.savez(path, counter_keys=keys)
    index = ki.load_index(path)
    assert index.n_unique == len(keys)
    _assert_same_index(index, ref_ki.load_index(path))
    got_kmers, got_counts = index.kmer_counts(_slot_counts(index, keys))
    np.testing.assert_array_equal(np.sort(got_kmers), np.sort(keys))
    np.testing.assert_array_equal(got_counts, 1)
    ref_kmers, ref_counts = ref_ki.load_index(path).kmer_counts(_slot_counts(index, keys))
    np.testing.assert_array_equal(got_kmers, ref_kmers)
    np.testing.assert_array_equal(got_counts, ref_counts)


@pytest.mark.parametrize("member", ["reference", "tpuidx"])
def test_load_bundle(tmp_path, member):
    """A zip with a kmer_index member: a reference .npz, or a .tpuidx read
    from memory (BytesIO)."""
    arrays = ki.build_toy_index(n_unique=200, k=31, n_nodes=64, seed=10)
    inner = io.BytesIO()
    if member == "reference":
        ki.save_reference_npz(inner, arrays)
    else:
        ki.KmerIndex.from_arrays(arrays).to_file(inner)
    bundle = tmp_path / "bundle.zip"
    with zipfile.ZipFile(bundle, "w") as zf:
        zf.writestr("kmer_index.npz", inner.getvalue())
    index = ki.load_index(bundle)
    assert index.max_node_id == arrays.max_node_id()
    _assert_same_index(index, ref_ki.load_index(bundle))
    _assert_same_index(ki.load_bundle(bundle), index)


def test_bundle_without_kmer_index_raises(tmp_path):
    bundle = tmp_path / "bundle.zip"
    with zipfile.ZipFile(bundle, "w") as zf:
        zf.writestr("other.txt", "x")
    with pytest.raises(ValueError, match="no kmer_index member"):
        ki.load_bundle(bundle)


def test_index_get_nodes():
    arrays = oracle.build_kmer_index(np.array([5, 9, 5], np.uint64), np.array([10, 11, 12], np.int32), 101)
    index = ki.KmerIndex.from_arrays(arrays)
    np.testing.assert_array_equal(np.sort(index.get(5)), [10, 12])
    np.testing.assert_array_equal(index.get(9), [11])
    assert len(index.get(12345)) == 0
    ref = ref_ki.TpuKmerIndex.from_arrays(ref_oracle.build_kmer_index(
        np.array([5, 9, 5], np.uint64), np.array([10, 11, 12], np.int32), 101))
    np.testing.assert_array_equal(np.sort(index.get(5)), np.sort(ref.get(5)))


def test_empty_index():
    index = ki.KmerIndex.from_counter_keys(np.zeros(0, dtype=np.uint64))
    np.testing.assert_array_equal(layout.query_table(index.table, np.array([1, 2, 3], np.uint64)), -1)
    assert index.node_counts(np.zeros(index.table.n_slots, np.uint32)).shape == (1,)
    kmers, counts = index.kmer_counts(np.zeros(index.table.n_slots, np.uint32))
    assert kmers.shape == counts.shape == (0,)


def test_sentinel_like_and_all_ones_keys_count():
    """lo == 0xFFFFFFFF with hi == 0 is a legal kmer, and so is the all-ones
    kmer; neither is confused with the empty sentinel, and the counter view
    unmixes them back."""
    keys = np.array([0xFFFFFFFF, 0xFFFF, 1, 0xFFFFFFFFFFFFFFFF], dtype=np.uint64)
    index = ki.KmerIndex.from_counter_keys(keys)
    counts = _slot_counts(index, np.concatenate([keys, keys[:2]]))
    got_kmers, got_counts = index.kmer_counts(counts)
    order = np.argsort(got_kmers)
    np.testing.assert_array_equal(got_kmers[order], np.sort(keys))
    np.testing.assert_array_equal(got_counts[order], [1, 2, 2, 1])
    _assert_same_index(index, ref_ki.TpuKmerIndex.from_counter_keys(keys))


def test_tpuidx_rejects_out_of_range_max_probe(tmp_path):
    rng = np.random.default_rng(11)
    keys = np.unique(rng.integers(0, 1 << 62, 500, dtype=np.uint64))
    nodes = rng.integers(0, 50, len(keys)).astype(np.int32)
    ki.KmerIndex.from_entries(keys, nodes).to_file(tmp_path / "i.tpuidx.npz")
    with np.load(tmp_path / "i.tpuidx.npz") as data:
        fields = {k: data[k] for k in data.files}
    for bad in (0, layout.MAX_PROBE_HARD + 1):
        fields["table_max_probe"] = np.int64(bad)
        np.savez(tmp_path / "bad.tpuidx.npz", **fields)
        with pytest.raises(ValueError, match="table_max_probe"):
            ki.KmerIndex.from_file(tmp_path / "bad.tpuidx.npz")
    fields["table_max_probe"] = np.int64(9)  # deep but plausible: loads
    np.savez(tmp_path / "deep.tpuidx.npz", **fields)
    assert ki.KmerIndex.from_file(tmp_path / "deep.tpuidx.npz").table.max_probe == 9
    fields["format"] = np.array(["tpuidx-v3"])
    np.savez(tmp_path / "old.tpuidx.npz", **fields)
    with pytest.raises(ValueError, match="tpuidx-v4"):
        ki.KmerIndex.from_file(tmp_path / "old.tpuidx.npz")


# --- pickled CounterKmerIndex and bundles (tests/test_pickled_index.py) -------


def _fake_module(name: str) -> types.ModuleType:
    parts = name.split(".")
    for i in range(1, len(parts) + 1):
        prefix = ".".join(parts[:i])
        mod = sys.modules.get(prefix)
        if mod is None:
            mod = types.ModuleType(prefix)
            mod.__path__ = []
            sys.modules[prefix] = mod
        if i > 1:
            setattr(sys.modules[".".join(parts[: i - 1])], parts[i - 1], mod)
    return sys.modules[name]


def _fake_class(module: str, name: str) -> type:
    cls = type(name, (object,), {})
    cls.__module__ = module
    setattr(_fake_module(module), name, cls)
    return cls


@pytest.fixture
def fake_tree():
    """The reference dependency class tree (a graph_kmer_index
    CounterKmerIndex holding an npstructures Counter whose _keys is a
    RaggedArray), close enough that pickle stores the same class paths."""
    RaggedArray = _fake_class("npstructures.raggedarray", "RaggedArray")
    Counter = _fake_class("npstructures.hashtable", "Counter")
    CounterKmerIndex = _fake_class("graph_kmer_index.kmer_counter", "CounterKmerIndex")

    def build(keys, kmers=None, nodes=None):
        ragged = RaggedArray()
        ragged._data = np.asarray(keys, dtype=np.uint64)
        ragged._shape = np.array([len(keys)])
        counter = Counter()
        counter._keys = ragged
        counter._values = np.zeros(len(keys), dtype=np.int64)
        counter._mod = np.uint64(17)
        index = CounterKmerIndex()
        index.counter = counter
        if kmers is not None:
            index._kmers = np.asarray(kmers, dtype=np.uint64)
            index._nodes = np.asarray(nodes, dtype=np.int64)
        return index

    return build


def _dump(path, obj):
    with open(path, "wb") as f:
        pickle.dump(obj, f)
    return str(path)


def test_counter_only_pickle(tmp_path, fake_tree):
    rng = np.random.default_rng(3)
    keys = np.unique(rng.integers(0, 1 << 62, 500, dtype=np.uint64))
    path = _dump(tmp_path / "counter_index.pkl", fake_tree(keys))
    assert pickled.is_pickle_file(path)
    index = ki.load_index(path)
    assert index.n_unique == len(keys)
    queries = np.concatenate([keys, rng.integers(0, 1 << 62, 1000, dtype=np.uint64)])
    assert (layout.query_table(index.table, queries)[: len(keys)] >= 0).all()
    got_kmers, _ = index.kmer_counts(np.zeros(index.table.n_slots, np.uint32))
    np.testing.assert_array_equal(np.sort(got_kmers), keys)
    _assert_same_index(index, ref_ki.load_index(path))


def test_counter_with_nodes_pickle(tmp_path, fake_tree):
    rng = np.random.default_rng(4)
    kmers = np.unique(rng.integers(0, 1 << 62, 300, dtype=np.uint64))
    entry_kmers = np.concatenate([kmers, rng.choice(kmers, 60)])
    nodes = rng.integers(0, 50, len(entry_kmers)).astype(np.int64)
    path = _dump(tmp_path / "counter_nodes.pkl", fake_tree(kmers, entry_kmers, nodes))
    index = ki.load_index(path)
    got = index.node_counts(_slot_counts(index, kmers))
    np.testing.assert_array_equal(got, np.bincount(nodes, minlength=int(nodes.max()) + 1))
    _assert_same_index(index, ref_ki.load_index(path))


def test_counter_keys_missing_from_entries_still_countable(tmp_path, fake_tree):
    rng = np.random.default_rng(6)
    entry_kmers = np.unique(rng.integers(0, 1 << 62, 100, dtype=np.uint64))
    nodes = rng.integers(0, 20, len(entry_kmers)).astype(np.int64)
    extra = np.setdiff1d(np.unique(rng.integers(0, 1 << 62, 40, dtype=np.uint64)), entry_kmers)
    path = _dump(tmp_path / "c.pkl", fake_tree(np.union1d(entry_kmers, extra), entry_kmers, nodes))
    index = ki.load_index(path)
    assert index.n_unique == len(entry_kmers) + len(extra)
    slots = layout.query_table(index.table, extra)
    assert (slots >= 0).all()  # extra keys probeable, and they add to no node
    assert index.node_counts(_slot_counts(index, extra)).sum() == 0
    _assert_same_index(index, ref_ki.load_index(path))


def test_pickled_bundle_full_kmer_index(tmp_path):
    """A pickled bundle dict whose kmer_index member carries per-entry
    arrays only (a full KmerIndex); a reverse_kmer_index beside it is not
    taken for it."""
    KmerIndexCls = _fake_class("graph_kmer_index.kmer_index", "KmerIndex")
    rng = np.random.default_rng(12)
    def make(n):
        obj = KmerIndexCls()
        obj._kmers = rng.integers(0, 1 << 62, n, dtype=np.uint64)
        obj._nodes = rng.integers(0, 30, n).astype(np.int64)
        obj._frequencies = np.ones(n, np.uint16)
        return obj
    member, decoy = make(200), make(50)
    path = _dump(tmp_path / "bundle.npz", {"reverse_kmer_index": decoy, "kmer_index": member})
    index = ki.load_index(path)
    assert len(index.entry_node) == 200
    _assert_same_index(index, ref_ki.load_index(path))


def test_unknown_class_refused(tmp_path):
    path = _dump(tmp_path / "evil.pkl", {"f": print})
    with pytest.raises(pickle.UnpicklingError, match="refusing"):
        pickled.load_pickled_index(path)


def test_no_keys_raises(tmp_path, fake_tree):
    idx = fake_tree(np.array([1], dtype=np.uint64))
    idx.counter._keys = None
    path = _dump(tmp_path / "empty.pkl", idx)
    with pytest.raises(ValueError, match="no counter keys"):
        pickled.load_pickled_index(path)


class _EvilNumpyCall:
    """Pickles to a REDUCE of numpy.save, a side-effecting numpy callable
    that the reconstruction allowlist must refuse."""

    def __init__(self, target):
        self.target = target

    def __reduce__(self):
        return (np.save, (self.target, np.arange(3)))


def test_numpy_namespace_restricted(tmp_path):
    target = str(tmp_path / "pwn")
    path = _dump(tmp_path / "evil2.pkl", _EvilNumpyCall(target))
    with pytest.raises(pickle.UnpicklingError, match="refus"):
        pickled.load_pickled_index(path)
    assert not (tmp_path / "pwn.npy").exists()


def test_allowlists_equal_jax():
    assert pickled._STUB_PREFIXES == ref_pickled._STUB_PREFIXES
    assert pickled._NUMPY_ALLOWED == ref_pickled._NUMPY_ALLOWED
