"""The block partition's dissection (``kmer_mapper_tpu_torch.scripts.
partition_dissect``: the cursor route) without jax: its wrapper on CPU
tensors (the twin), its kernel path's glue on a numpy stand-in library,
its refusals, and its ``main`` at a small size on the CPU. It also runs on
the GPU machine, which has no jax:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_partition_dissect.py

Tests of the CUDA kernels themselves carry the ``cuda`` marker and skip
where PyTorch sees no GPU. Tolerance 0 throughout."""
import contextlib
import ctypes
import types

import numpy as np
import pytest
import torch

from kmer_mapper_tpu_torch import native
from kmer_mapper_tpu_torch.ops import block_partition, block_partition_cases, stream_probe
from kmer_mapper_tpu_torch.scripts import partition_dissect as D

CASES = {c.name: c for c in block_partition_cases.cases()}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _cuda_stubs(monkeypatch):
    """Lets the launch path run without a GPU up to the library call."""
    monkeypatch.setattr(torch.cuda, "device", lambda device: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda *a: types.SimpleNamespace(cuda_stream=0))


def _view(ptr: int, n: int, ctype, dtype):
    return np.frombuffer((ctype * n).from_address(ptr), dtype=dtype) if n else np.zeros(0, dtype)


class StandIn:
    """The cursor kernels' contract in numpy, on the host memory behind the
    pointers."""

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


@pytest.mark.parametrize("variant", list(D.VARIANTS))
@pytest.mark.parametrize("name", list(CASES))
def test_cpu_tensors_run_the_twin(name, variant):
    """On CPU tensors each variant runs the twin, counted as such, and its
    result passes the dissection's own check."""
    case = CASES[name]
    keys, n_buckets, bpb = case.inputs("cpu")
    before = dict(D.launch_counts)
    grouped, off = D.cursor_partition(keys, n_buckets, bpb, variant)
    twin_grouped, twin_off = block_partition.block_partition_reference(keys, n_buckets, bpb)
    assert torch.equal(grouped, twin_grouped) and torch.equal(off, twin_off)
    D.check(keys, grouped, off, n_buckets, variant)
    assert D.launch_counts == {**before, "partition_dissect_reference":
                               before["partition_dissect_reference"] + 1}


@pytest.mark.parametrize("name", ["hits_misses_masking", "no_queries", "wide_table_33554432"])
def test_cursor_glue_on_a_stand_in(name, monkeypatch):
    """The cursor route on the stand-in: a histogram, its scan, a scatter,
    each launched once (none for no keys); a partition by block, which the
    dissection's check accepts."""
    _cuda_stubs(monkeypatch)
    lib = StandIn()
    monkeypatch.setattr(native, "library", lambda: lib)
    case = CASES[name]
    keys, n_buckets, bpb = case.inputs("cpu")
    n_blocks = n_buckets // bpb
    before = dict(D.launch_counts)
    grouped, off = D.cursor_kernels(keys, n_blocks)
    n = len(case.keys)
    assert D.launch_counts == {**before, "partition_dissect":
                               before["partition_dissect"] + 2 * bool(n)}
    shared = int(n_blocks + 1 <= D.SHARED_BINS)
    log2 = n_blocks.bit_length() - 1
    assert lib.calls == ([("histogram", n, log2, shared), ("scatter", n, log2)] if n else [])
    D.check(keys, grouped, off, n_buckets, "cursor")


def test_histogram_counts_in_shared_memory_only_where_it_fits(monkeypatch):
    _cuda_stubs(monkeypatch)
    lib = StandIn()
    monkeypatch.setattr(native, "library", lambda: lib)
    keys = torch.from_numpy(CASES["wide_table_33554432"].keys[:100])
    assert 8192 < D.SHARED_BINS <= 16384
    for n_blocks, shared in ((1, 1), (8192, 1), (16384, 0), (1 << 18, 0)):
        D.block_histogram(keys, n_blocks)
        assert lib.calls[-1] == ("histogram", 100, n_blocks.bit_length() - 1, shared)
    D.block_histogram(keys, 8192, shared=False)
    assert lib.calls[-1][3] == 0


def test_failed_launch_raises(monkeypatch):
    """A launch that returns an error raises and counts nothing: there is no
    fallback to the twin; an unknown variant is refused."""
    _cuda_stubs(monkeypatch)
    fail = lambda *a: 1  # noqa: E731
    lib = types.SimpleNamespace(block_histogram_launch=fail, block_scatter_launch=fail,
                                kmt_error_string=lambda rc: b"invalid argument")
    monkeypatch.setattr(native, "library", lambda: lib)
    keys = torch.from_numpy(CASES["chained_table"].keys)
    before = dict(D.launch_counts)
    with pytest.raises(RuntimeError, match="block_histogram kernel launch failed: invalid"):
        D.cursor_kernels(keys, 1 << 16)
    with pytest.raises(RuntimeError, match="block_scatter kernel launch failed: invalid"):
        D.block_scatter(keys, torch.zeros(9, dtype=torch.int32), 8)
    with pytest.raises(ValueError, match="unknown variant 'matrix'"):
        D.cursor_partition(keys, 1024, 128, "matrix")
    assert D.launch_counts == before


def test_check_refuses_a_wrong_partition():
    case = CASES["hits_misses_masking"]
    keys, n_buckets, bpb = case.inputs("cpu")
    grouped, off = block_partition.block_partition_reference(keys, n_buckets, bpb)
    for bad in (grouped.flip(0), grouped.clone().fill_(0)):
        with pytest.raises(AssertionError, match="cursor and the twin disagree"):
            D.check(keys, bad, off, n_buckets, "cursor")


def test_main_on_the_cpu(monkeypatch, capsys):
    """``main`` on the CPU at a small size: every table's report, each
    variant held to the twin."""
    monkeypatch.setattr(D, "BUCKETS", [1 << 10, 1 << 25])
    result = D.main(["--device", "cpu", "--keys", "5000"])
    assert set(result) == {1 << 10, 1 << 25}
    for report in result.values():
        assert {"radix", *D.VARIANTS, "twin", "torch.sort + count_offsets"} == set(
            report["times"])
        assert all(ms >= 0 for ms in report["times"].values()) and not report["passes"]
    assert "partition_dissect on cpu" in capsys.readouterr().out


@pytest.mark.cuda
@pytest.mark.parametrize("variant", list(D.VARIANTS))
@pytest.mark.parametrize("name", list(CASES))
def test_kernel_matches_twin(name, variant, cuda_device):
    """Kernels == twin: equal offsets, equal windows as multisets, every key
    inside its own block's window; the histogram in shared memory where the
    bins fit, and in device memory."""
    case = CASES[name]
    keys, n_buckets, bpb = case.inputs(cuda_device)
    grouped, off = D.cursor_partition(keys, n_buckets, bpb, variant)
    D.check(keys, grouped, off, n_buckets, variant)
    ordered = torch.sort(keys).values
    assert torch.equal(off, stream_probe.count_offsets(ordered, n_buckets, bpb))


@pytest.mark.cuda
def test_main_on_the_card(cuda_device):
    result = D.main(["--keys", str(1 << 20)])
    assert set(result) == set(D.BUCKETS)
    for report in result.values():
        assert set(report["passes"]) == {"one wave", "one a SM"}
