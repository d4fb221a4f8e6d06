"""The port's sort, block offsets and stream count against the JAX stream
path, on every hazard case of the kernel's contract the JAX kernel accepts.
The jax-free tests of the kernel and its twin are in test_torch_kernels.py."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kmer_mapper_tpu.ops import stream_probe as ref_sp
from kmer_mapper_tpu_torch.index import layout
from kmer_mapper_tpu_torch.ops import stream_count_cases, stream_probe
from kmer_mapper_tpu_torch.ops.u32hash import split_u64

CASES = {c.name: c for c in stream_count_cases.cases()}
# the JAX kernel schedules at most 8 rounds at aug=1 (stream_probe.py:175)
JAX_CASES = [n for n, c in CASES.items() if c.table.max_probe <= 8]


def _u32(t):
    return t.cpu().numpy().view(np.uint32)


def _run_jax(case):
    t = case.table
    p_lo, p_hi = ref_sp.plane_keys(t.key_lo, t.key_hi)
    q_lo, q_hi = split_u64(case.queries)
    out = ref_sp.stream_probe_count(
        jnp.asarray(p_lo), jnp.asarray(p_hi),
        jnp.asarray(ref_sp.slot_to_plane(case.counts0, t.n_buckets)),
        jnp.asarray(q_lo), jnp.asarray(q_hi), jnp.asarray(case.valid),
        t.seed, t.max_probe, cap=128, interpret=True,
        block_probe=t.block_max_probe(),
    )
    return ref_sp.plane_to_slot(np.asarray(out), t.n_buckets)


@pytest.mark.parametrize("name", JAX_CASES)
def test_twin_matches_jax_stream_count(name):
    case = CASES[name]
    got = stream_probe.stream_count_reference(*case.inputs("cpu"))
    np.testing.assert_array_equal(_u32(got), _run_jax(case))


def test_poly_a_case_fills_one_window():
    case = CASES["poly_a_window"]
    args = case.inputs("cpu")
    off = args[4].numpy()
    assert np.diff(off).max() >= 5000  # one chain block holds the run
    slot = layout.query_table(case.table, np.zeros(1, np.uint64))[0]
    assert case.expected()[slot] == 5000


@pytest.mark.parametrize("n_buckets", [1, 4, 64, 128, 1 << 10, 1 << 12])
def test_block_offsets_match_jax(n_buckets):
    rng = np.random.default_rng(n_buckets)
    m_lo = rng.integers(0, 1 << 32, 5000, dtype=np.int64)
    m_hi = rng.integers(0, 1 << 32, 5000, dtype=np.int64)
    m_lo[:700] = m_lo[0]  # a long duplicate run
    m_lo[-300:] = m_hi[-300:] = 0xFFFFFFFF  # invalid tail
    keys = stream_probe.sort_mixed(torch.from_numpy(m_lo), torch.from_numpy(m_hi))
    bpb = min(layout.CHAIN_BLOCK, n_buckets)
    got = stream_probe.block_offsets(keys, n_buckets, bpb)
    assert got.dtype == torch.int32
    sorted_lo = stream_probe.split_key(keys)[0].numpy().astype(np.uint32)
    expect = ref_sp.block_offsets(jnp.asarray(sorted_lo), n_buckets, bpb)
    np.testing.assert_array_equal(got.numpy(), np.asarray(expect))
    assert got[0] == 0 and got[-1] == len(m_lo)


