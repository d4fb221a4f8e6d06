"""The block partition's plain twin against the port's own sort and count
offsets on every hazard case of ``ops/block_partition_cases.py``, the
wrapper's argument checks, its kernel path's glue on a stand-in library,
and its refusal to fall back. Jax-free, so it also runs on the GPU machine,
which has no jax:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_partition_kernels.py

Tests of the CUDA kernels themselves carry the ``cuda`` marker and skip
where PyTorch sees no GPU. Tolerance 0 throughout."""
import contextlib
import ctypes
import types

import numpy as np
import pytest
import torch

from kmer_mapper_tpu_torch import native
from kmer_mapper_tpu_torch.ops import (
    block_partition, block_partition_cases, stream_count_cases, stream_probe,
)
from kmer_mapper_tpu_torch.ops.u32hash import bucket_from_mlo_torch

CASES = {c.name: c for c in block_partition_cases.cases()}
TABLE_CASES = {c.name: c for c in block_partition_cases.table_cases()}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def check_partition(keys, grouped, off, n_buckets, bpb):
    """``grouped`` and ``off`` are a partition of ``keys`` by chain block:
    offsets == ``count_offsets`` of the sorted keys, every key inside its
    own block's window, each window == the sorted keys' window as a
    multiset, the invalid keys after the last window."""
    keys, grouped, off = keys.cpu(), grouped.cpu(), off.cpu()
    n_blocks = n_buckets // bpb
    ordered = torch.sort(keys).values
    assert off.dtype == torch.int32
    assert torch.equal(off, stream_probe.count_offsets(ordered, n_buckets, bpb))
    end = int(off[-1])
    owner = torch.repeat_interleave(torch.arange(n_blocks), (off[1:] - off[:-1]).long())
    assert torch.equal(block_partition.block_ids(grouped[:end], n_blocks), owner)
    window_sorted = grouped[:end][np.lexsort((grouped[:end].numpy(), owner.numpy()))]
    assert torch.equal(window_sorted, ordered[:end])
    assert (grouped[end:] == block_partition.INVALID_KEY).all()
    assert torch.equal(torch.sort(grouped).values, ordered)


@pytest.mark.parametrize("name", list(CASES))
def test_twin_matches_sort_and_count_offsets(name):
    case = CASES[name]
    before = dict(block_partition.launch_counts)
    grouped, off = block_partition.block_partition(*case.inputs("cpu"))
    check_partition(torch.from_numpy(case.keys), grouped, off, case.n_buckets, case.bpb)
    # the twin keeps the input order inside a window
    owner = block_partition.block_ids(grouped, case.n_buckets // case.bpb)
    keys = torch.from_numpy(case.keys)
    for b in owner.unique()[:4].tolist():
        assert torch.equal(grouped[owner == b],
                           keys[block_partition.block_ids(keys, len(off) - 1) == b])
    # on a CPU tensor the wrapper runs the twin and never counts a launch
    assert block_partition.launch_counts == {
        **before, "block_partition_reference": before["block_partition_reference"] + 1}


def test_block_ids_are_the_count_kernels_blocks():
    """A key's block is its bucket (the count's rule) over the block size,
    on every table size from 1 to 2**29 buckets."""
    rng = np.random.default_rng(3)
    m_lo = np.concatenate([[0, 0xFFFFFFFF], rng.integers(0, 1 << 32, 5000)])
    m_hi = rng.integers(0, 1 << 32, len(m_lo))
    m_hi[1] = 0xFFFFFFFE
    keys = torch.from_numpy(block_partition_cases.mixed_keys(m_lo, m_hi))
    lo = torch.from_numpy(m_lo)
    for log2 in range(30):
        n_buckets = 1 << log2
        bpb = min(128, n_buckets)
        expect = bucket_from_mlo_torch(lo, n_buckets) // bpb
        assert torch.equal(block_partition.block_ids(keys, n_buckets // bpb), expect)
    invalid = torch.tensor([block_partition.INVALID_KEY])
    assert block_partition.block_ids(invalid, 64).tolist() == [64]
    assert block_partition.INVALID_KEY == int(stream_probe.sort_key(
        torch.tensor([stream_probe.INVALID_WORD]), torch.tensor([stream_probe.INVALID_WORD])))


def test_partition_checks_its_arguments():
    keys, n_buckets, bpb = CASES["hits_misses_masking"].inputs("cpu")
    bad = [
        ((keys.to(torch.int32), n_buckets, bpb), "int64 sort keys"),
        ((keys.view(-1, 1), n_buckets, bpb), "int64 sort keys"),
        ((keys[::2], n_buckets, bpb), "int64 sort keys"),
        ((keys, n_buckets - 1, bpb), "power of two"),
        ((keys, n_buckets, bpb // 2), "chain-block size"),
        ((keys, 64, 128), "chain-block size"),
        ((keys.to("meta"), n_buckets, bpb), "no kernel for device meta"),
    ]
    for args, match in bad:
        with pytest.raises(ValueError, match=match):
            block_partition.block_partition(*args)


def _cuda_stubs(monkeypatch):
    """Lets the launch path run without a GPU up to the library call."""
    monkeypatch.setattr(torch.cuda, "device", lambda device: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda *a: types.SimpleNamespace(cuda_stream=0))


def _view(ptr: int, n: int, ctype, dtype):
    return np.frombuffer((ctype * n).from_address(ptr), dtype=dtype) if n else np.zeros(0, dtype)


class StandIn:
    """The two kernels' contract in numpy, on the host memory behind the
    pointers: what the CUDA library does, so that the wrapper's glue (the
    scan, the cursors, the shapes) runs on the CPU."""

    def __init__(self):
        self.calls = []

    def block_histogram_launch(self, keys, n, hist, log2, shared, device, stream):
        self.calls.append(("histogram", n, log2, shared))
        bins = block_partition.block_ids(torch.from_numpy(
            _view(keys, n, ctypes.c_int64, np.int64).copy()), 1 << log2).numpy()
        _view(hist, (1 << log2) + 1, ctypes.c_int32, np.int32)[:] += np.bincount(
            bins, minlength=(1 << log2) + 1).astype(np.int32)
        return 0

    def block_scatter_launch(self, keys, n, cursor, out, log2, device, stream):
        self.calls.append(("scatter", n, log2))
        k = _view(keys, n, ctypes.c_int64, np.int64).copy()
        bins = block_partition.block_ids(torch.from_numpy(k), 1 << log2).numpy()
        cur = _view(cursor, (1 << log2) + 1, ctypes.c_int32, np.int32)
        dst = _view(out, n, ctypes.c_int64, np.int64)
        for i in np.random.default_rng(n).permutation(n):  # any order the warps take
            dst[cur[bins[i]]] = k[i]
            cur[bins[i]] += 1
        return 0


@pytest.mark.parametrize("name", ["hits_misses_masking", "poly_a_window", "no_queries",
                                  "single_bucket_shift_32", "extreme_words_4096"])
def test_kernel_path_glue_on_a_stand_in(name, monkeypatch):
    """The CUDA branch's scan, cursors and shapes, with the kernels' work
    done by a numpy stand-in: a partition by block, and one launch of each
    kernel counted (none for no keys)."""
    _cuda_stubs(monkeypatch)
    lib = StandIn()
    monkeypatch.setattr(native, "library", lambda: lib)
    case = CASES[name]
    keys, n_buckets, bpb = case.inputs("cpu")
    n_blocks = n_buckets // bpb
    before = dict(block_partition.launch_counts)
    grouped, off = block_partition._partition_launch(keys, n_blocks)
    check_partition(keys, grouped, off, n_buckets, bpb)
    assert off.shape == (n_blocks + 1,) and off.is_contiguous()
    n = len(case.keys)
    assert block_partition.launch_counts == {
        **before, "block_histogram": before["block_histogram"] + bool(n),
        "block_scatter": before["block_scatter"] + bool(n)}
    log2 = n_blocks.bit_length() - 1
    assert lib.calls == ([("histogram", n, log2, 1), ("scatter", n, log2)] if n else [])


def test_histogram_counts_in_shared_memory_only_where_it_fits(monkeypatch):
    _cuda_stubs(monkeypatch)
    lib = StandIn()
    monkeypatch.setattr(native, "library", lambda: lib)
    keys = torch.from_numpy(CASES["wide_table_33554432"].keys[:100])
    assert 8192 < block_partition.SHARED_BINS <= 16384
    for n_blocks, shared in ((1, 1), (8192, 1), (16384, 0), (1 << 18, 0)):
        block_partition.block_histogram(keys, n_blocks)
        assert lib.calls[-1] == ("histogram", 100, n_blocks.bit_length() - 1, shared)
    block_partition.block_histogram(keys, 8192, shared=False)
    assert lib.calls[-1][3] == 0


def test_failed_launch_raises(monkeypatch):
    """A launch that returns an error raises and counts nothing: there is
    no fallback to the twin."""
    _cuda_stubs(monkeypatch)
    lib = types.SimpleNamespace(block_histogram_launch=lambda *a: 1,
                                block_scatter_launch=lambda *a: 1,
                                kmt_error_string=lambda rc: b"invalid argument")
    monkeypatch.setattr(native, "library", lambda: lib)
    keys = torch.from_numpy(CASES["chained_table"].keys)
    before = dict(block_partition.launch_counts)
    with pytest.raises(RuntimeError, match="block_histogram kernel launch failed: invalid"):
        block_partition._partition_launch(keys, 8)
    with pytest.raises(RuntimeError, match="block_scatter kernel launch failed: invalid"):
        block_partition.block_scatter(keys, torch.zeros(9, dtype=torch.int32), 8)
    assert block_partition.launch_counts == before


def test_failed_build_raises(monkeypatch):
    _cuda_stubs(monkeypatch)

    def no_nvcc():
        raise RuntimeError("nvcc not found")

    monkeypatch.setattr(native, "library", no_nvcc)
    before = dict(block_partition.launch_counts)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        block_partition._partition_launch(torch.from_numpy(CASES["chained_table"].keys), 8)
    assert block_partition.launch_counts == before


@pytest.mark.cuda
@pytest.mark.parametrize("shared", [None, False])
@pytest.mark.parametrize("name", list(CASES))
def test_kernel_matches_twin(name, shared, cuda_device):
    """Kernel == twin: equal offsets, equal windows as multisets, every key
    inside its own block's window; with the histogram where the wrapper
    puts it and in device memory."""
    case = CASES[name]
    before = dict(block_partition.launch_counts)
    keys = case.inputs(cuda_device)[0]
    if shared is None:
        grouped, off = block_partition.block_partition(*case.inputs(cuda_device))
    else:
        grouped, off = block_partition._partition_launch(keys, case.n_buckets // case.bpb,
                                                         shared)
    torch.cuda.synchronize()
    n = len(case.keys)
    assert block_partition.launch_counts["block_histogram"] == before["block_histogram"] + bool(n)
    assert block_partition.launch_counts["block_scatter"] == before["block_scatter"] + bool(n)
    twin_grouped, twin_off = block_partition.block_partition_reference(*case.inputs("cpu"))
    assert torch.equal(off.cpu(), twin_off)
    check_partition(keys, grouped, off, case.n_buckets, case.bpb)


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(TABLE_CASES))
def test_kernel_counts_equal_twin(name, cuda_device):
    """The stream path through the partition kernels and the count kernel
    == the same path through the twins == the oracle."""
    case = TABLE_CASES[name]
    keys = block_partition_cases.query_keys(case)
    got = []
    for device in (cuda_device, "cpu"):
        key_lo, key_hi, counts, _, _, block_probe, _, _ = case.inputs(device)
        stream_probe.stream_probe_count_keys(
            key_lo, key_hi, counts, torch.from_numpy(keys[case.valid]).to(device), block_probe)
        got.append(counts.cpu().numpy().view(np.uint32))
    np.testing.assert_array_equal(got[0], got[1])
    np.testing.assert_array_equal(got[0], case.expected())


@pytest.mark.cuda
def test_kernel_partition_of_slots_past_2_31(cuda_device):
    """The 2**29-bucket table of ``huge_table_inputs``: the partition of its
    queries in a shuffled order, then the count, gives the expected hits."""
    if torch.cuda.get_device_properties(cuda_device).total_memory < 60 << 30:
        pytest.skip("the 2**29-bucket table needs 48 GiB of device memory")
    args, (slots, reps) = stream_count_cases.huge_table_inputs(cuda_device)
    key_lo, key_hi, counts, ordered, _, block_probe, shift, bpb = args
    shuffled = ordered[torch.randperm(ordered.numel(), device=cuda_device)]
    grouped, off = block_partition.block_partition(shuffled, key_lo.shape[0], bpb)
    check_partition(shuffled, grouped, off, key_lo.shape[0], bpb)
    stream_probe.stream_count(key_lo, key_hi, counts, grouped, off, block_probe, shift, bpb)
    hit, values = stream_count_cases.nonzero_counts(counts)
    np.testing.assert_array_equal(hit, slots)
    np.testing.assert_array_equal(values, reps)
