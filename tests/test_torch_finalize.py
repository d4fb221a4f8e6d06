"""The node-count finalize's twin (``ops/finalize.finalize_reference``, what
``finalize`` runs on CPU tensors) against the JAX package's
``parallel.make_finalize`` on a one-device mesh and against the numpy
oracle, on the hazard cases of ``ops/finalize_cases.py``, bit for bit."""
import numpy as np
import pytest
import torch

from kmer_mapper_tpu.parallel import make_finalize, make_mesh
from kmer_mapper_tpu_torch import oracle
from kmer_mapper_tpu_torch.index import kmer_index as ki
from kmer_mapper_tpu_torch.models.mapper import KmerMapper, MapperConfig
from kmer_mapper_tpu_torch.ops import finalize, finalize_cases

CASES = finalize_cases.cases()


def _u32(t):
    return t.numpy().view(np.uint32)


def _jax_finalize(case):
    fn = make_finalize(make_mesh(n_devices=1), case.n_nodes - 1, case.max_frequency)
    return np.asarray(fn(case.counts[None], case.slot, case.node, case.frequency))


@pytest.mark.parametrize("name", list(CASES))
def test_twin_matches_jax_make_finalize(name):
    case = CASES[name]
    got = _u32(finalize.finalize(*case.inputs("cpu")))
    np.testing.assert_array_equal(got, case.expected())
    np.testing.assert_array_equal(got, _jax_finalize(case))


@pytest.mark.parametrize("order", ["shuffled", "slot"])
@pytest.mark.parametrize("name", list(CASES))
def test_twin_matches_jax_make_finalize_in_any_entry_order(name, order):
    """The entries shuffled, and sorted by slot as ``KmerIndex.device_entries``
    uploads them: the twin == numpy == JAX's make_finalize on the same
    (reordered) entries."""
    case = CASES[name].ordered(order, seed=len(name))
    got = _u32(finalize.finalize(*case.inputs("cpu")))
    np.testing.assert_array_equal(got, CASES[name].expected())
    np.testing.assert_array_equal(got, _jax_finalize(case))


def test_the_wrap_case_wraps_modulo_2_32():
    """0xFFFFFFFF + 1 adds to 0, a sum past 2**32 keeps its low word, as the
    uint32 .at[].add of make_finalize does."""
    got = _u32(finalize.finalize(*CASES["wrap"].inputs("cpu")))
    np.testing.assert_array_equal(got, [0, 4, 0xFFFFFFFA])


def test_host_node_counts_on_the_wrap_case():
    """The host ``KmerIndex.node_counts`` sums in float64 and casts to
    uint32: exact below 2**53, and on this platform the cast of a sum past
    2**32 keeps its low word too, so it equals make_finalize's wrap here.
    The device path does not rely on that cast."""
    case = CASES["wrap"]
    index = ki.KmerIndex(table=None, entry_slot=case.slot, entry_node=case.node,
                         entry_frequency=case.frequency, max_node_id=case.n_nodes - 1,
                         n_unique=len(case.counts))
    host = index.node_counts(case.counts, max_frequency=case.max_frequency)
    np.testing.assert_array_equal(host, [0, 4, 0xFFFFFFFA])
    np.testing.assert_array_equal(host, _jax_finalize(case))


@pytest.mark.parametrize("max_frequency", [0, 1, 2, 1000])
def test_twin_matches_oracle_on_a_mapped_index(max_frequency):
    """Slot counts of real queries (KmerMapper on the CPU): the twin over
    the index's entries == the oracle's node counts == the host finalize."""
    rng = np.random.default_rng(max_frequency)
    kmers = rng.integers(0, 1 << 40, 3000, dtype=np.uint64)
    entries = np.concatenate([kmers[:2000], rng.choice(kmers[:2000], 1000)])
    nodes = rng.integers(0, 700, len(entries)).astype(np.int32)
    arrays = oracle.build_kmer_index(entries, nodes, 2003)
    index = ki.KmerIndex.from_arrays(arrays)
    mapper = KmerMapper(index, MapperConfig(k=31), "cpu")
    queries = np.concatenate([rng.choice(kmers, 20_000), kmers[:50].repeat(3)])
    mapper.map_hashes(queries)
    got = _u32(finalize.finalize(mapper.counts, *index.device_entries("cpu"), max_frequency,
                                 index.max_node_id + 1))
    expect = oracle.map_kmers_to_index(arrays, queries, max_frequency=max_frequency)
    np.testing.assert_array_equal(got, expect)
    np.testing.assert_array_equal(got, mapper.node_counts(max_frequency=max_frequency))
    assert (arrays.frequencies > 1).any()
