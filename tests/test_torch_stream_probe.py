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


def test_count_offsets_end_at_the_invalid_tail(monkeypatch):
    """The plain ragged hash turns every window that crosses a read boundary
    into the all-ones pair, which sorts last: the count offsets end at the
    first such key. The ragged step's hash kernel writes the valid windows
    only, so the keys that reach its count hold no such key, and its block
    partition's offsets are ``block_offsets`` of the sorted keys, each
    window holding its block's keys; those offsets still equal JAX's, and
    the node counts equal the oracle's."""
    from kmer_mapper_tpu_torch import oracle
    from kmer_mapper_tpu_torch.index import kmer_index
    from kmer_mapper_tpu_torch.io import readers
    from kmer_mapper_tpu_torch.models.mapper import KmerMapper, MapperConfig
    from kmer_mapper_tpu_torch.ops import hashing
    from kmer_mapper_tpu_torch.ops.u32hash import from_int32_bits

    rng = np.random.default_rng(31)
    k = 15
    lengths = rng.integers(k - 3, 70, 150)
    codes = rng.integers(0, 4, int(lengths.sum()))
    kmers = oracle.kmer_hashes_ragged(codes, lengths, k)
    entries = np.concatenate([kmers[::7], rng.integers(0, 1 << 30, 50, dtype=np.uint64)])
    arrays = oracle.build_kmer_index(entries, rng.integers(0, 40, len(entries)), 1021)
    config = MapperConfig(k=k, buf=4096, max_reads=128)
    mapper = KmerMapper(kmer_index.KmerIndex.from_arrays(arrays), config, "cpu")
    bases = np.frombuffer(b"ACGT", np.uint8)[codes]
    starts = np.concatenate([[0], np.cumsum(lengths)[:-1]])
    chunks = list(readers.pack_for_device(
        iter([readers.SequenceChunk(bases, starts)]), config.buf, config.max_reads, k))
    assert len(chunks) > 1

    seen = []
    count = stream_probe.stream_count

    def spy(key_lo, key_hi, counts, keys, off, *rest):
        seen.append((keys.clone(), off.clone()))
        return count(key_lo, key_hi, counts, keys, off, *rest)

    monkeypatch.setattr(stream_probe, "stream_count", spy)
    for packed, lens, n_bases, _, n_invalid in chunks:
        mapper.map_chunk(packed, lens, n_bases, n_invalid)
    np.testing.assert_array_equal(mapper.node_counts(), oracle.map_kmers_to_index(arrays, kmers))

    n_buckets = mapper.index.table.n_buckets
    bpb = min(layout.CHAIN_BLOCK, n_buckets)
    assert len(seen) == len(chunks)
    for (grouped, off), (packed, lens, n_bases, _, _) in zip(seen, chunks):
        keys = torch.sort(grouped).values
        assert (keys != stream_probe.INVALID_KEY).all()  # valid windows only
        full = stream_probe.block_offsets(keys, n_buckets, bpb)
        assert int(full[-1]) == keys.numel()
        np.testing.assert_array_equal(off.numpy(), full.numpy())
        for b in range(off.numel() - 1):  # each block's keys, in any order
            window = torch.sort(grouped[int(off[b]):int(off[b + 1])]).values
            assert torch.equal(window, keys[int(full[b]):int(full[b + 1])])
        # the same chunk hashed plainly, every base a window: an invalid tail
        lo, hi = hashing.rolling_kmer_hash_packed(
            from_int32_bits(torch.from_numpy(packed.view(np.int32))), k)
        lens64 = torch.from_numpy(lens.astype(np.int64))
        valid = hashing.window_mask(torch.cumsum(lens64, 0) - lens64, n_bases, k, config.buf)
        plain = stream_probe.sort_queries(lo, hi, valid, mapper.index.table.seed)
        plain_off = stream_probe.count_offsets(plain, n_buckets, bpb)
        first_invalid = int(np.searchsorted(plain.numpy(), stream_probe.INVALID_KEY))
        assert first_invalid == keys.numel() < plain.numel()  # the chunk has an invalid tail
        assert torch.equal(plain[:first_invalid], keys)
        assert int(plain_off[-1]) == int(plain_off.max()) == first_invalid
        plain_full = stream_probe.block_offsets(plain, n_buckets, bpb)
        assert int(plain_full[-1]) == plain.numel()
        np.testing.assert_array_equal(plain_off.numpy(),
                                      np.minimum(plain_full.numpy(), first_invalid))
        for sorted_keys, got in ((keys, full), (plain, plain_full)):
            sorted_lo = stream_probe.split_key(sorted_keys)[0].numpy().astype(np.uint32)
            expect = ref_sp.block_offsets(jnp.asarray(sorted_lo), n_buckets, bpb)
            np.testing.assert_array_equal(got.numpy(), np.asarray(expect))
