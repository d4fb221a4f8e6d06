"""The port's gather-probe twins against the JAX package's gather probe
(``kmer_mapper_tpu/ops/probe.py``: ``probe_hits`` + the accumulators, and
``probe_slots``) on the same numpy-seeded hazard cases, and the port's
Feistel halves against the JAX package's. The twins take the raw uint64
words as int64 and bound each query's rounds by its chain block, where the
case passes the block bounds; JAX walks ``max_probe`` rounds of the split
words, and the two must agree exactly."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kmer_mapper_tpu.ops import probe as ref_probe
from kmer_mapper_tpu.ops import u32hash as ref_u32hash
from kmer_mapper_tpu_torch.ops import probe, probe_cases, u32hash

CASES = {c.name: c for c in probe_cases.cases()}


def _jax_inputs(case):
    lo, hi = u32hash.split_u64(case.queries)
    t = case.table
    return (jnp.asarray(t.key_lo), jnp.asarray(t.key_hi), jnp.asarray(lo), jnp.asarray(hi),
            case.max_probe, t.seed)


@pytest.mark.parametrize("name", list(CASES))
def test_slots_match_jax(name):
    case = CASES[name]
    args, kw = case.slot_args("cpu")
    got = probe.probe_slots_reference(*args, **kw).numpy()
    expect = np.asarray(ref_probe.probe_slots(*_jax_inputs(case)))
    np.testing.assert_array_equal(got, expect)
    np.testing.assert_array_equal(got, case.expected_slots())


# JAX's sort accumulator cannot take an empty batch
@pytest.mark.parametrize("name,accumulate", [
    (name, acc) for name, case in CASES.items() for acc in ref_probe.ACCUMULATORS
    if case.queries.size or acc == "scatter"
])
def test_counts_match_jax(name, accumulate):
    case = CASES[name]
    args, kw = case.count_args("cpu")
    got = probe.probe_count_reference(*args, **kw).numpy().view(np.uint32)
    bucket, mask = ref_probe.probe_hits(*_jax_inputs(case))
    valid = np.ones(len(case.queries), bool) if case.valid is None else case.valid
    expect = ref_probe.ACCUMULATORS[accumulate](
        jnp.asarray(case.counts0), bucket, mask, jnp.asarray(valid)
    )
    np.testing.assert_array_equal(got, np.asarray(expect))


def test_chain_next_matches_jax():
    b = np.arange(0, 4096, 3, dtype=np.int32)
    for n_buckets in (1, 8, 64, 128, 4096):
        bb = b[b < n_buckets]
        for step in (0, 1, 9, 127, 300):
            np.testing.assert_array_equal(
                probe.chain_next(torch.from_numpy(bb.astype(np.int64)), step, n_buckets).numpy(),
                np.asarray(ref_probe.chain_next(jnp.asarray(bb), step, n_buckets)),
            )


def test_unmix_and_join_match_jax():
    rng = np.random.default_rng(8)
    lo = rng.integers(0, 1 << 32, 5000, dtype=np.int64).astype(np.uint32)
    hi = rng.integers(0, 1 << 32, 5000, dtype=np.int64).astype(np.uint32)
    lo[:100] |= np.uint32(1 << 31)
    hi[:100] |= np.uint32(1 << 31)
    for seed in (0, 13, 29):
        got = u32hash.feistel_unmix(lo, hi, seed)
        expect = ref_u32hash.feistel_unmix(lo, hi, seed)
        for a, b in zip(got, expect):
            np.testing.assert_array_equal(a, b)
        back = u32hash.feistel_mix(*got, seed)
        np.testing.assert_array_equal(back[0], lo)
        np.testing.assert_array_equal(back[1], hi)
    np.testing.assert_array_equal(u32hash.join_u64(lo, hi), ref_u32hash.join_u64(lo, hi))
    kmers = u32hash.join_u64(lo, hi)
    np.testing.assert_array_equal(u32hash.join_u64(*u32hash.split_u64(kmers)), kmers)
