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
from kmer_mapper_tpu_torch.ops.u32hash import bucket_from_mlo

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


@pytest.mark.parametrize("name", list(CASES))
def test_twins_match_numpy_loop(name):
    case = CASES[name]
    before = dict(probe.launch_counts)
    slots = probe.probe_slots(*case.slot_args("cpu"))
    assert slots.dtype == torch.int32
    np.testing.assert_array_equal(slots.numpy(), case.expected_slots())
    counts = probe.probe_count(*case.count_args("cpu"))
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
    assert CASES["seeded_p2"].table.seed != 0


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
    q = torch.zeros(n, dtype=torch.int32)
    counts = torch.zeros(n_buckets * 8, dtype=torch.int32)
    return key, key.clone(), counts, q, q.clone(), torch.ones(n, dtype=torch.bool)


@pytest.mark.parametrize("bad,match", [
    (dict(q_lo=torch.zeros(5, dtype=torch.int64)), "q_lo"),
    (dict(valid=torch.ones(4, dtype=torch.bool)), "valid"),
    (dict(counts=torch.zeros(63, dtype=torch.int32)), "counts"),
    (dict(key_lo=torch.zeros((8, 16), dtype=torch.int32)[:, ::2]), "key_lo"),
    (dict(max_probe=0), "max_probe"),
    (dict(max_probe=layout.MAX_PROBE_HARD + 1), "max_probe"),
])
def test_refusals(bad, match):
    key_lo, key_hi, counts, q_lo, q_hi, valid = _args()
    kw = dict(key_lo=key_lo, key_hi=key_hi, counts=counts, q_lo=q_lo, q_hi=q_hi,
              valid=valid, max_probe=2, seed=0)
    kw.update(bad)
    with pytest.raises(ValueError, match=match):
        probe.probe_count(**kw)
    kw.pop("counts"), kw.pop("valid")
    if match not in ("counts", "valid"):
        with pytest.raises(ValueError, match=match):
            probe.probe_slots(**kw)


def test_tables_that_are_not_a_power_of_two_are_refused():
    key_lo, key_hi, counts, q_lo, q_hi, valid = _args(n_buckets=6)
    with pytest.raises(ValueError, match="power of two"):
        probe.probe_count(key_lo, key_hi, counts, q_lo, q_hi, valid, 2, 0)


def test_other_devices_are_refused():
    """Only CPU tensors take the twin; a device with no kernel raises."""
    args = [t.to("meta") for t in _args()]
    key_lo, key_hi, counts, q_lo, q_hi, valid = args
    before = dict(probe.launch_counts)
    with pytest.raises(ValueError, match="no kernel for device meta"):
        probe.probe_count(key_lo, key_hi, counts, q_lo, q_hi, valid, 2, 0)
    with pytest.raises(ValueError, match="no kernel for device meta"):
        probe.probe_slots(key_lo, key_hi, q_lo, q_hi, 2, 0)
    assert probe.launch_counts == before


def test_slots_past_int32_are_refused():
    """probe_slots writes int32 slots, as the JAX probe does: a table of
    2**29 buckets (2**32 slots) is refused, not wrapped."""
    key = torch.empty((1 << 29, 8), dtype=torch.int32, device="meta")
    q = torch.empty(4, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="2\\*\\*31 slots"):
        probe.probe_slots(key, key, q, q, 2, 0)


def _cuda_stubs(monkeypatch):
    """Lets the launch path run without a GPU up to the library call."""
    monkeypatch.setattr(torch.cuda, "device", lambda device: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda *a: types.SimpleNamespace(cuda_stream=0))


def test_failed_launch_raises(monkeypatch):
    """A launch that returns an error raises and counts nothing: there is
    no fallback to the twin."""
    _cuda_stubs(monkeypatch)
    calls = []
    lib = types.SimpleNamespace(
        gather_probe_launch=lambda *a: calls.append(a) or 1,
        kmt_error_string=lambda rc: b"invalid argument",
    )
    monkeypatch.setattr(native, "library", lambda: lib)
    key_lo, key_hi, counts, q_lo, q_hi, valid = _args()
    before = dict(probe.launch_counts)
    with pytest.raises(RuntimeError, match="gather_probe kernel launch failed: invalid argument"):
        probe._launch(0, key_lo, key_hi, q_lo, q_hi, valid, counts, None, 2, 7)
    assert probe.launch_counts == before
    (args,) = calls
    assert args[7:12] == (5, 8, 2, 7, 0)  # n, n_buckets, max_probe, seed, mode


def test_failed_build_raises(monkeypatch):
    _cuda_stubs(monkeypatch)

    def no_nvcc():
        raise RuntimeError("nvcc not found")

    monkeypatch.setattr(native, "library", no_nvcc)
    key_lo, key_hi, _, q_lo, q_hi, _ = _args()
    before = dict(probe.launch_counts)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        probe._launch(1, key_lo, key_hi, q_lo, q_hi, None, None,
                      torch.empty(5, dtype=torch.int32), 2, 0)
    assert probe.launch_counts == before


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(CASES))
def test_kernel_matches_twin_and_loop(name, cuda_device):
    case = CASES[name]
    before = probe.launch_counts["gather_probe"]
    slots = probe.probe_slots(*case.slot_args(cuda_device))
    counts = probe.probe_count(*case.count_args(cuda_device))
    torch.cuda.synchronize()
    assert probe.launch_counts["gather_probe"] == before + 2
    np.testing.assert_array_equal(slots.cpu().numpy(), case.expected_slots())
    np.testing.assert_array_equal(_u32(counts), case.expected_counts())
    twin_slots = probe.probe_slots_reference(*case.slot_args(cuda_device))
    twin_counts = probe.probe_count_reference(*case.count_args(cuda_device))
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
    got = probe.probe_slots(*case.slot_args(cuda_device))
    assert torch.equal(got, probe.probe_slots_reference(*case.slot_args(cuda_device)))
    assert int((got >= 0).sum()) >= 1 << 19
    got = probe.probe_count(*case.count_args(cuda_device))
    assert torch.equal(got, probe.probe_count_reference(*case.count_args(cuda_device)))
