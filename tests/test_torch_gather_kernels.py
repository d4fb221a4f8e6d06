"""The gather probe's plain twins against a numpy loop on every hazard case
of its contract, the wrappers' refusals, and (on a GPU) the CUDA kernel
against its twins. Jax-free, so it also runs on the GPU machine, which has
no jax:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_gather_kernels.py

Tests of the CUDA kernel itself carry the ``cuda`` marker and skip where
PyTorch sees no GPU."""
import contextlib
import types

import numpy as np
import pytest
import torch

from kmer_mapper_tpu_torch import native
from kmer_mapper_tpu_torch.index import layout
from kmer_mapper_tpu_torch.ops import probe, probe_cases
from kmer_mapper_tpu_torch.ops.u32hash import bucket_from_mlo, feistel_mix, split_u64

CASES = {c.name: c for c in probe_cases.cases()}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


def _u32(t):
    return t.cpu().numpy().view(np.uint32)


def _wrapped_keys(table) -> int:
    """Stored keys whose chain wrapped past the end of their chain block."""
    block = min(layout.CHAIN_BLOCK, table.n_buckets)
    home = bucket_from_mlo(table.key_lo, table.n_buckets).astype(np.int64) % block
    here = np.arange(table.n_buckets)[:, None] % block
    stored = ~((table.key_lo == layout.EMPTY) & (table.key_hi == layout.EMPTY))
    return int((stored & (here < home)).sum())


def _call(fn, call):
    args, kw = call
    return fn(*args, **kw)


@pytest.mark.parametrize("name", list(CASES))
def test_twins_match_numpy_loop(name):
    case = CASES[name]
    before = dict(probe.launch_counts)
    slots = _call(probe.probe_slots, case.slot_args("cpu"))
    assert slots.dtype == torch.int32
    np.testing.assert_array_equal(slots.numpy(), case.expected_slots())
    counts = _call(probe.probe_count, case.count_args("cpu"))
    np.testing.assert_array_equal(_u32(counts), case.expected_counts())
    # on CPU tensors the wrappers run the twins and never count a launch
    assert probe.launch_counts["gather_probe"] == before["gather_probe"]
    for twin in ("probe_count_reference", "probe_slots_reference"):
        assert probe.launch_counts[twin] == before[twin] + 1


def test_cases_cover_the_hazards():
    names = set(CASES)
    assert {CASES[n].table.n_buckets for n in names} >= {1, 8, 64}
    for stem in ("buckets8", "buckets64", "wrapping_chains"):
        case = CASES[f"{stem}_p1"]
        assert _wrapped_keys(case.table) > 0
        # round 1 misses the chained keys that the table's own bound finds
        full = CASES[f"{stem}_p{case.table.max_probe}"]
        assert (full.expected_slots() >= 0).sum() > (case.expected_slots() >= 0).sum()
    assert "buckets8_p64" in names and "buckets1_p64" in names  # revisited buckets
    sentinel = probe_cases.sentinel_query(CASES["sentinel_p2"].table.seed)
    for case in CASES.values():
        if case.queries.size:
            is_sentinel = case.queries == sentinel
            assert not (case.expected_slots()[is_sentinel] >= 0).any()
    assert (CASES["sentinel_p2"].queries == sentinel).sum() == 2
    wrap = CASES["counts_wrap_p2"]
    assert (wrap.expected_counts() < wrap.counts0).any()  # passed 2**32
    assert not CASES["invalid_p2"].valid.all()
    assert CASES["valid_array_p2"].valid.all()
    assert sum(c.valid is None for c in CASES.values()) > len(CASES) // 2  # null valid
    assert CASES["seeded_p2"].table.seed != 0
    assert (CASES["negative_words_p1"].queries.view(np.int64) < 0).all()
    assert (CASES["high_bits_p2"].queries.view(np.int64) < 0).any()
    # one hot key 10^4 times, whose count passes 2**32
    skewed = CASES["skewed_p2"]
    keys, n = np.unique(skewed.queries, return_counts=True)
    hot = skewed.expected_slots()[skewed.queries == keys[n.argmax()]][0]
    assert n.max() >= 10_000 and skewed.expected_counts()[hot] < skewed.counts0[hot]
    assert {c.bounds for c in CASES.values()} == {True, False}


def _homes(case) -> np.ndarray:
    """The chain block each query of the case is homed in."""
    t = case.table
    m_lo, _ = feistel_mix(*split_u64(case.queries), seed=t.seed)
    return bucket_from_mlo(m_lo, t.n_buckets).astype(np.int64) // min(layout.CHAIN_BLOCK,
                                                                      t.n_buckets)


def test_block_bounds_case_differs_by_block():
    """One long chain beside blocks with none; misses homed in every block
    and in the long chain; round bounds below the long chain's bound."""
    case = CASES["block_bounds_p2"]
    bounds = case.table.block_max_probe()
    assert bounds.min() == 1 and bounds.max() >= 4 and (bounds == 1).sum() >= 6
    miss = case.expected_slots() < 0
    homes = _homes(case)
    assert set(homes[miss]) == set(range(len(bounds)))
    long_block = int(bounds.argmax())
    assert (miss & (homes == long_block)).sum() >= 100
    assert 1 < case.max_probe < bounds.max()
    # the bound the walk stops at finds every key the table's own bound finds
    full = CASES[f"block_bounds_p{case.table.max_probe}"]
    np.testing.assert_array_equal(
        full.expected_slots(),
        CASES[f"block_bounds_nobounds_p{case.table.max_probe}"].expected_slots())
    assert (full.expected_slots() >= 0).sum() > (case.expected_slots() >= 0).sum()


@pytest.mark.parametrize("name", ["block_bounds_p6", "wrapping_chains_p55", "sentinel_p2"])
def test_block_bounds_cut_rounds(name):
    """Under the block bounds a query walks at most max_probe rounds, and a
    query homed in a block without chains one round."""
    case = CASES[name]
    t = case.table
    args, kw = case.slot_args("cpu")
    _, _, _, rounds = probe.query_rounds(args[2], case.max_probe, t.seed, t.n_buckets,
                                         kw["block_probe"])
    _, _, _, unbounded = probe.query_rounds(args[2], case.max_probe, t.seed, t.n_buckets)
    homes = _homes(case)
    assert (rounds <= unbounded).all() and rounds.sum() < unbounded.sum()
    plain = t.block_max_probe()[homes] == 1
    assert (rounds.numpy()[plain] <= 1).all()


def test_chain_next_matches_layout():
    b = np.arange(0, 4096, 7)
    for n_buckets in (1, 8, 64, 128, 4096):
        bb = b[b < n_buckets]
        for step in (0, 1, 5, 127, 200):
            np.testing.assert_array_equal(
                probe.chain_next(torch.from_numpy(bb), step, n_buckets).numpy(),
                layout.chain_next(bb, step, n_buckets),
            )


def _args(n_buckets=8, n=5):
    key = torch.zeros((n_buckets, 8), dtype=torch.int32)
    q = torch.zeros(n, dtype=torch.int64)
    counts = torch.zeros(n_buckets * 8, dtype=torch.int32)
    block_probe = torch.ones(max(1, n_buckets // 128), dtype=torch.int32)
    return key, key.clone(), counts, q, torch.ones(n, dtype=torch.bool), block_probe


@pytest.mark.parametrize("bad,match", [
    (dict(queries=torch.zeros(5, dtype=torch.int32)), "queries"),
    (dict(valid=torch.ones(4, dtype=torch.bool)), "valid"),
    (dict(counts=torch.zeros(63, dtype=torch.int32)), "counts"),
    (dict(key_lo=torch.zeros((8, 16), dtype=torch.int32)[:, ::2]), "key_lo"),
    (dict(max_probe=0), "max_probe"),
    (dict(max_probe=layout.MAX_PROBE_HARD + 1), "max_probe"),
    (dict(block_probe=torch.ones(2, dtype=torch.int32)), "block_probe"),
    (dict(block_probe=torch.ones(1, dtype=torch.int64)), "block_probe"),
])
def test_refusals(bad, match):
    key_lo, key_hi, counts, queries, valid, block_probe = _args()
    kw = dict(key_lo=key_lo, key_hi=key_hi, counts=counts, queries=queries, valid=valid,
              max_probe=2, seed=0, block_probe=block_probe)
    kw.update(bad)
    with pytest.raises(ValueError, match=match):
        probe.probe_count(**kw)
    kw.pop("counts"), kw.pop("valid")
    if match not in ("counts", "valid"):
        with pytest.raises(ValueError, match=match):
            probe.probe_slots(**kw)


def test_tables_that_are_not_a_power_of_two_are_refused():
    key_lo, key_hi, counts, queries, valid, _ = _args(n_buckets=6)
    with pytest.raises(ValueError, match="power of two"):
        probe.probe_count(key_lo, key_hi, counts, queries, 2, 0, valid=valid)


def test_other_devices_are_refused():
    """Only CPU tensors take the twin; a device with no kernel raises."""
    args = [t.to("meta") for t in _args()]
    key_lo, key_hi, counts, queries, valid, block_probe = args
    before = dict(probe.launch_counts)
    with pytest.raises(ValueError, match="no kernel for device meta"):
        probe.probe_count(key_lo, key_hi, counts, queries, 2, 0, valid=valid,
                          block_probe=block_probe)
    with pytest.raises(ValueError, match="no kernel for device meta"):
        probe.probe_slots(key_lo, key_hi, queries, 2, 0)
    assert probe.launch_counts == before


def test_slots_past_int32_are_refused():
    """probe_slots writes int32 slots, as the JAX probe does: a table of
    2**29 buckets (2**32 slots) is refused, not wrapped."""
    key = torch.empty((1 << 29, 8), dtype=torch.int32, device="meta")
    q = torch.empty(4, dtype=torch.int64, device="meta")
    with pytest.raises(ValueError, match="2\\*\\*31 slots"):
        probe.probe_slots(key, key, q, 2, 0)


def test_twin_splits_negative_words_with_a_mask():
    """torch's int64 ``>>`` copies the sign bit down: the twin's hi word of
    a raw word with bit 63 set is ``(q >> 32) & MASK32``, as split_u64's."""
    kmers = np.array([1 << 63, (1 << 64) - 1, 0x80000000FFFFFFFF, 0x7FFFFFFF80000000],
                     np.uint64)
    table = layout.build_table(kmers)
    queries = probe_cases.raw_queries(kmers, "cpu")
    assert (queries < 0).sum() == 3
    key_lo, key_hi = (torch.from_numpy(w.view(np.int32)) for w in (table.key_lo, table.key_hi))
    slots = probe.probe_slots(key_lo, key_hi, queries, table.max_probe, table.seed)
    np.testing.assert_array_equal(slots.numpy(), table.build_slots)


def _cuda_stubs(monkeypatch):
    """Lets the launch path run without a GPU up to the library call."""
    monkeypatch.setattr(torch.cuda, "device", lambda device: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda *a: types.SimpleNamespace(cuda_stream=0))


def _stub_library(monkeypatch, rc):
    calls = []
    lib = types.SimpleNamespace(
        gather_probe_launch=lambda *a: calls.append(a) or rc,
        kmt_error_string=lambda rc: b"invalid argument",
    )
    monkeypatch.setattr(native, "library", lambda: lib)
    return calls


def test_failed_launch_raises(monkeypatch):
    """A launch that returns an error raises and counts nothing: there is
    no fallback to the twin."""
    _cuda_stubs(monkeypatch)
    calls = _stub_library(monkeypatch, 1)
    key_lo, key_hi, counts, queries, valid, block_probe = _args()
    before = dict(probe.launch_counts)
    with pytest.raises(RuntimeError, match="gather_probe kernel launch failed: invalid argument"):
        probe._launch(0, key_lo, key_hi, block_probe, queries, valid, counts, None, 2, 7)
    assert probe.launch_counts == before
    (args,) = calls
    # n, n_buckets, n_blocks, max_probe, seed, mode, the rows (row_offset,
    # n_local: the whole table), then the device and stream
    assert args[7:15] == (5, 8, 1, 2, 7, 0, 0, 8) and len(args) == 17


def test_launch_passes_null_valid_and_block_probe(monkeypatch):
    """No valid array and no block bounds reach the kernel as null pointers
    (every query valid; max_probe rounds), with n_blocks 0."""
    _cuda_stubs(monkeypatch)
    calls = _stub_library(monkeypatch, 0)
    key_lo, key_hi, counts, queries, _, _ = _args()
    before = probe.launch_counts["gather_probe"]
    probe._launch(0, key_lo, key_hi, None, queries, None, counts, None, 3, 0)
    assert probe.launch_counts["gather_probe"] == before + 1
    (args,) = calls
    assert args[2] is None and args[4] is None and args[6] is None
    assert args[9] == 0


def test_failed_build_raises(monkeypatch):
    _cuda_stubs(monkeypatch)

    def no_nvcc():
        raise RuntimeError("nvcc not found")

    monkeypatch.setattr(native, "library", no_nvcc)
    key_lo, key_hi, _, queries, _, block_probe = _args()
    before = dict(probe.launch_counts)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        probe._launch(1, key_lo, key_hi, block_probe, queries, None, None,
                      torch.empty(5, dtype=torch.int32), 2, 0)
    assert probe.launch_counts == before


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(CASES))
def test_kernel_matches_twin_and_loop(name, cuda_device):
    case = CASES[name]
    before = probe.launch_counts["gather_probe"]
    slots = _call(probe.probe_slots, case.slot_args(cuda_device))
    counts = _call(probe.probe_count, case.count_args(cuda_device))
    torch.cuda.synchronize()
    assert probe.launch_counts["gather_probe"] == before + 2
    np.testing.assert_array_equal(slots.cpu().numpy(), case.expected_slots())
    np.testing.assert_array_equal(_u32(counts), case.expected_counts())
    twin_slots = _call(probe.probe_slots_reference, case.slot_args(cuda_device))
    twin_counts = _call(probe.probe_count_reference, case.count_args(cuda_device))
    assert torch.equal(slots, twin_slots) and torch.equal(counts, twin_counts)


@pytest.mark.cuda
def test_kernel_matches_twin_on_a_large_batch(cuda_device):
    """2**20 raw queries, high bits set in both words for half of them, on a
    2**16-bucket table: kernel == twin in both modes."""
    rng = np.random.default_rng(3)
    keys = np.unique(rng.integers(0, 1 << 62, 200_000, dtype=np.uint64))
    keys[::2] |= np.uint64(0x8000000080000000)
    keys = np.unique(keys)
    table = layout.build_table(keys)
    queries = np.concatenate([rng.choice(keys, 1 << 19),
                              rng.integers(0, 1 << 63, 1 << 19, dtype=np.uint64)])
    case = probe_cases.ProbeCase("large", table, queries, rng.random(len(queries)) < 0.9,
                                 rng.integers(0, 1 << 32, table.n_slots).astype(np.uint32),
                                 table.max_probe)
    got = _call(probe.probe_slots, case.slot_args(cuda_device))
    assert torch.equal(got, _call(probe.probe_slots_reference, case.slot_args(cuda_device)))
    assert int((got >= 0).sum()) >= 1 << 19
    got = _call(probe.probe_count, case.count_args(cuda_device))
    assert torch.equal(got, _call(probe.probe_count_reference, case.count_args(cuda_device)))
