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


#: (case, slab count) of the plain pieces: one slab, three, and 264 (two
#: CTAs on each of an H100's 132 SMs)
SLAB_CASES = [(name, n_slabs) for name in CASES for n_slabs in (1, 3, 264)]


@pytest.mark.parametrize("name", ["hits_misses_masking", "poly_a_window", "extreme_words_1",
                                  "wide_table_536870912", "no_queries"])
def test_slab_rows_and_scan(name):
    """For each radix pass: each slab row counts its own keys' digits; the
    scan's bases are the counts of the same digit in the slabs before; the
    offsets end each digit where a stable sort by digit ends it; the slot
    rule writes the keys in that stable order."""
    case = CASES[name]
    keys = torch.from_numpy(case.keys)
    n_blocks = case.n_buckets // case.bpb
    n_slabs, slab_len = block_partition.slab_layout(len(keys), 5)
    assert n_slabs <= 5 and slab_len % block_partition.WARP_TILE == 0
    assert n_slabs * slab_len >= len(keys) > (n_slabs - 1) * slab_len or not len(keys)
    for shift, bits in block_partition.radix_passes(n_blocks):
        width = block_partition.digit_width(n_blocks, shift, bits)
        rows = block_partition.slab_histograms(keys, n_blocks, slab_len, shift, bits)
        assert rows.shape == (n_slabs, width) and rows.dtype == torch.int32
        digits = (block_partition.block_ids(keys, n_blocks) >> shift) & ((1 << bits) - 1)
        for s in range(n_slabs):
            own = torch.bincount(digits[s * slab_len:(s + 1) * slab_len], minlength=width)
            assert torch.equal(rows[s].long(), own)
        bases, off = block_partition.slab_bases(rows)
        assert off.dtype == torch.int32 and off.shape == (width + 1,)
        for s in range(n_slabs):
            assert torch.equal(bases[s].long(), rows[:s].long().sum(0))
        counts = torch.bincount(digits, minlength=width)
        assert torch.equal(off[1:].long(), torch.cumsum(counts, 0)) and int(off[0]) == 0
        out = block_partition.slab_scatter_reference(keys, bases, off, n_blocks, slab_len,
                                                     shift, bits)
        assert torch.equal(out, keys[torch.argsort(digits, stable=True)])


def test_radix_passes_cover_every_table_size():
    """The radix route's passes cover every bin of every table size, the
    invalid one included, with digits of at most 8 bits, as few passes as
    that takes."""
    for log2 in range(30):
        n_blocks = max(1, (1 << log2) // 128)
        passes = block_partition.radix_passes(n_blocks)
        shift, bits = passes[-1]
        assert all(b <= block_partition.RADIX_BITS for _, b in passes)
        assert [s for s, _ in passes] == [p * passes[0][1] for p in range(len(passes))]
        assert n_blocks >> (shift + bits) == 0 and len(passes) == -(-n_blocks.bit_length() // 8)
    assert block_partition.radix_passes(8192) == [(0, 7), (7, 7)]


@pytest.mark.parametrize("name,n_slabs", SLAB_CASES)
def test_radix_pieces_match_twin(name, n_slabs):
    """The radix route's plain pieces (per pass: the slab rows of its digit,
    their scan, the stable slot rule; then the offsets of the sorted keys)
    == the twin bit for bit."""
    case = CASES[name]
    keys, n_buckets, bpb = case.inputs("cpu")
    grouped, off = block_partition.radix_partition_reference(keys, n_buckets, bpb, n_slabs)
    twin_grouped, twin_off = block_partition.block_partition_reference(keys, n_buckets, bpb)
    assert torch.equal(off, twin_off) and torch.equal(grouped, twin_grouped)


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


def _counted(n: int, count, n_slabs: int) -> tuple[int, int]:
    """The keys and the slab length of a launch: the device count (an int32
    in host memory here) clamped to [0, n] cut into ``n_slabs`` slabs, as
    the kernels cut it."""
    assert count is not None, "the partition's launches take a count"
    c = min(max(int(_view(count, 1, ctypes.c_int32, np.int32)[0]), 0), n)
    return c, block_partition.slab_layout(c, n_slabs)[1]


class StandIn:
    """The partition kernels' contract in numpy, on the host memory behind
    the pointers: what the CUDA library does, so that the wrapper's glue
    (the slabs, the scans, the digits' offsets, the buffers, the shapes,
    the device count) runs on the CPU."""

    def __init__(self):
        self.calls = []

    def radix_slabs(self, device):
        self.calls.append(("radix_slabs",))
        return 264

    def partition_histogram_launch(self, keys, n, count, rows, n_slabs, log2, shift, bits,
                                   device, stream):
        n, slab_len = _counted(n, count, n_slabs)
        self.calls.append(("partition_histogram", n, slab_len, n_slabs, log2, shift, bits))
        k = torch.from_numpy(_view(keys, n, ctypes.c_int64, np.int64).copy())
        m = block_partition.slab_histograms(k, 1 << log2, slab_len, shift, bits).numpy()
        width = block_partition.digit_width(1 << log2, shift, bits)
        matrix = _view(rows, n_slabs * width, ctypes.c_int32, np.int32)
        matrix[:] = 0  # the slabs past the count's last are empty
        matrix[:m.size] = m.reshape(-1)
        return 0

    def radix_scatter_launch(self, keys, n, count, rows, doff, out, n_slabs, log2, shift, bits,
                             device, stream):
        n, slab_len = _counted(n, count, n_slabs)
        self.calls.append(("radix_scatter", n, slab_len, n_slabs, log2, shift, bits))
        k = torch.from_numpy(_view(keys, n, ctypes.c_int64, np.int64).copy())
        width = block_partition.digit_width(1 << log2, shift, bits)
        bases = torch.from_numpy(_view(rows, n_slabs * width, ctypes.c_int32, np.int32)
                                 .reshape(n_slabs, width).copy())
        d = torch.from_numpy(_view(doff, width + 1, ctypes.c_int32, np.int32).copy())
        _view(out, n, ctypes.c_int64, np.int64)[:] = block_partition.slab_scatter_reference(
            k, bases, d, 1 << log2, slab_len, shift, bits).numpy()
        return 0

    def radix_offsets_launch(self, ordered, n, count, off, log2, device, stream):
        n, _ = _counted(n, count, 1)
        self.calls.append(("radix_offsets", n, log2))
        k = torch.from_numpy(_view(ordered, n, ctypes.c_int64, np.int64).copy())
        _view(off, (1 << log2) + 1, ctypes.c_int32, np.int32)[:] = \
            block_partition.radix_offsets_reference(k, 1 << log2).numpy()
        return 0

    def partition_scan_launch(self, rows, totals, n_slabs, width, device, stream):
        self.calls.append(("partition_scan", n_slabs, width))
        m = _view(rows, n_slabs * width, ctypes.c_int32, np.int32).reshape(n_slabs, width)
        bases, off = block_partition.slab_bases(torch.from_numpy(m.copy()))
        _view(totals, width, ctypes.c_int32, np.int32)[:] = np.diff(off.numpy())
        m[:] = bases.numpy()
        return 0


@pytest.mark.parametrize("name", ["hits_misses_masking", "poly_a_window", "no_queries",
                                  "single_bucket_shift_32", "extreme_words_4096",
                                  "wide_table_33554432", "wide_table_536870912"])
def test_kernel_path_glue_on_a_stand_in(name, monkeypatch):
    """The CUDA branch's slabs, scans, offsets and shapes, with the kernels'
    work done by a numpy stand-in: a partition by block, each pass's
    kernels launched and counted once over every slab of one wave (the
    keys' number in a count on the device), then the offsets (none for no
    keys)."""
    _cuda_stubs(monkeypatch)
    lib = StandIn()
    monkeypatch.setattr(native, "library", lambda: lib)
    case = CASES[name]
    keys, n_buckets, bpb = case.inputs("cpu")
    n_blocks = n_buckets // bpb
    before = dict(block_partition.launch_counts)
    grouped, off = block_partition.radix_partition(keys, n_blocks)
    check_partition(keys, grouped, off, n_buckets, bpb)
    assert off.shape == (n_blocks + 1,) and off.is_contiguous()
    n = len(case.keys)
    log2 = n_blocks.bit_length() - 1
    passes = block_partition.radix_passes(n_blocks)
    n_slabs, (_, slab_len) = 264, block_partition.slab_layout(n, 264)
    expect = [("radix_slabs",)]
    for shift, bits in passes:
        width = block_partition.digit_width(n_blocks, shift, bits)
        expect += [("partition_histogram", n, slab_len, n_slabs, log2, shift, bits),
                   ("partition_scan", n_slabs, width),
                   ("radix_scatter", n, slab_len, n_slabs, log2, shift, bits)]
    expect.append(("radix_offsets", n, log2))
    launched = {"partition_histogram": len(passes), "partition_scan": len(passes),
                "radix_scatter": len(passes), "radix_offsets": 1}
    assert block_partition.launch_counts == {
        **before, **{k: before[k] + v * bool(n) for k, v in launched.items()}}
    assert lib.calls == (expect if n else [])
    # each pass is stable: the kernels' result is the twin's, bit for bit
    twin_grouped, twin_off = block_partition.block_partition_reference(keys, n_buckets, bpb)
    assert torch.equal(grouped, twin_grouped) and torch.equal(off, twin_off)


@pytest.mark.parametrize("name,n_slabs", [(name, n_slabs) for name in (
    "hits_misses_masking", "poly_a_window", "extreme_words_4096", "wide_table_536870912")
    for n_slabs in (1, 3, 264)])
def test_pass_wrappers_on_a_stand_in(name, n_slabs, monkeypatch):
    """Each kernel's wrapper at a slab count of the caller's, on the
    stand-in: the histogram's (slab, digit) shape, the scan in place with
    the digits' totals, a scatter into the caller's buffer, the offsets;
    each equal to its plain piece."""
    _cuda_stubs(monkeypatch)
    monkeypatch.setattr(native, "library", StandIn)
    case = CASES[name]
    keys = torch.from_numpy(case.keys)
    n_blocks = case.n_buckets // case.bpb
    _, slab_len = block_partition.slab_layout(len(keys), n_slabs)
    count = torch.tensor([len(keys)], dtype=torch.int32)
    for shift, bits in block_partition.radix_passes(n_blocks):
        rows = block_partition.partition_histogram(keys, n_blocks, shift, bits, count, n_slabs)
        assert torch.equal(rows, block_partition.slab_histograms(keys, n_blocks, slab_len,
                                                                 shift, bits, n_slabs))
        bases, doff = block_partition.slab_bases(rows)
        totals = block_partition.partition_scan(rows)
        assert torch.equal(rows, bases) and torch.equal(totals, doff.diff())
        out = torch.empty_like(keys)
        got = block_partition.radix_scatter(keys, rows, doff, n_blocks, shift, bits, count,
                                            out)
        assert got is out and torch.equal(out, block_partition.slab_scatter_reference(
            keys, bases, doff, n_blocks, slab_len, shift, bits))
        keys = out
    assert torch.equal(block_partition.radix_offsets(keys, n_blocks, count),
                       block_partition.radix_offsets_reference(keys, n_blocks))


@pytest.mark.parametrize("name", ["hits_misses_masking", "chained_table", "wide_table_33554432",
                                  "single_bucket_shift_32"])
def test_consume_alternates_through_the_callers_keys(name, monkeypatch):
    """With ``consume`` the radix passes alternate between the caller's keys
    and one other buffer: after two passes the result is in the keys' own
    memory; without it the keys are left as they were. Either way the
    result is the twin's. On a CPU tensor the twin runs and consumes
    nothing."""
    case = CASES[name]
    keys, n_buckets, bpb = case.inputs("cpu")
    n_blocks = n_buckets // bpb
    twin_grouped, twin_off = block_partition.block_partition_reference(keys, n_buckets, bpb)
    block_partition.block_partition(keys, n_buckets, bpb, consume=True)
    assert torch.equal(keys, torch.from_numpy(case.keys))
    _cuda_stubs(monkeypatch)
    lib = StandIn()
    monkeypatch.setattr(native, "library", lambda: lib)
    for consume in (False, True):
        given = keys.clone()
        grouped, off = block_partition.radix_partition(given, n_blocks, consume=consume)
        assert torch.equal(grouped, twin_grouped) and torch.equal(off, twin_off)
        passes = len(block_partition.radix_passes(n_blocks))
        assert (grouped.data_ptr() == given.data_ptr()) == (consume and passes % 2 == 0)
        if not consume:
            assert torch.equal(given, keys)


def _with_tail(keys: torch.Tensor, seed: int = 5, extra: int = 777) -> torch.Tensor:
    """The keys at the front of a longer buffer whose tail is garbage (random
    words and invalid keys), as the ragged step's capacity-sized key buffer
    holds them."""
    rng = np.random.default_rng(seed)
    tail = rng.integers(-(1 << 63), (1 << 63) - 1, extra, dtype=np.int64)
    tail[::3] = block_partition.INVALID_KEY
    return torch.cat([keys, torch.from_numpy(tail)])


@pytest.mark.parametrize("name", list(CASES))
def test_twin_partitions_the_device_count_of_a_capacity_buffer(name):
    """A buffer with a garbage tail and a count: the twin's partition of the
    count's keys == its partition of ``keys[:n]``, the tail kept; a count
    of -1 (a chunk whose lengths did not tile its buffer) partitions none,
    and a count past the buffer all of it."""
    case = CASES[name]
    keys, n_buckets, bpb = case.inputs("cpu")
    buffer = _with_tail(keys)
    n = keys.shape[0]
    grouped, off = block_partition.block_partition(
        buffer, n_buckets, bpb, count=torch.tensor([n, 99], dtype=torch.int32))
    twin_grouped, twin_off = block_partition.block_partition_reference(keys, n_buckets, bpb)
    assert grouped.shape == buffer.shape and torch.equal(grouped[n:], buffer[n:])
    assert torch.equal(grouped[:n], twin_grouped) and torch.equal(off, twin_off)
    _, none = block_partition.block_partition(buffer, n_buckets, bpb,
                                              count=torch.tensor([-1], dtype=torch.int32))
    assert not none.any()
    whole = block_partition.block_partition(
        buffer, n_buckets, bpb, count=torch.tensor([1 << 30], dtype=torch.int32))
    assert all(torch.equal(a, b) for a, b in zip(
        whole, block_partition.block_partition_reference(buffer, n_buckets, bpb)))


@pytest.mark.parametrize("name", ["hits_misses_masking", "poly_a_window", "no_queries",
                                  "extreme_words_4096", "wide_table_536870912",
                                  "revcomp_ragged_poly_a_k31_b0_rc1_s0"])
def test_device_count_glue_on_a_stand_in(name, monkeypatch):
    """With a device count the CUDA branch passes the count's address,
    launches every slab of one wave (the stand-in, like the kernels, cuts
    the count's keys into them) and equals the twin on ``keys[:n]``; the
    buffer past the count is not read."""
    _cuda_stubs(monkeypatch)
    lib = StandIn()
    monkeypatch.setattr(native, "library", lambda: lib)
    case = CASES[name]
    keys, n_buckets, bpb = case.inputs("cpu")
    n_blocks = n_buckets // bpb
    n = keys.shape[0]
    count = torch.tensor([n, 0], dtype=torch.int32)
    grouped, off = block_partition.radix_partition(_with_tail(keys), n_blocks, count=count)
    twin_grouped, twin_off = block_partition.block_partition_reference(keys, n_buckets, bpb)
    assert torch.equal(grouped[:n], twin_grouped) and torch.equal(off, twin_off)
    _, slab_len = block_partition.slab_layout(n, 264)
    histograms = [c for c in lib.calls if c[0] == "partition_histogram"]
    assert histograms and all(c[1:4] == (n, slab_len, 264) for c in histograms)
    assert lib.calls[-1] == ("radix_offsets", n, n_blocks.bit_length() - 1)
    with pytest.raises(ValueError, match="count is torch.int64"):
        block_partition.block_partition(keys, n_buckets, bpb, count=count.long())


def test_failed_launch_raises(monkeypatch):
    """A launch that returns an error raises and counts nothing: there is no
    fallback to the twin."""
    _cuda_stubs(monkeypatch)
    fail = lambda *a: 1  # noqa: E731
    lib = types.SimpleNamespace(radix_slabs=lambda *a: 264, partition_histogram_launch=fail,
                                partition_scan_launch=fail, radix_scatter_launch=fail,
                                radix_offsets_launch=fail,
                                kmt_error_string=lambda rc: b"invalid argument")
    monkeypatch.setattr(native, "library", lambda: lib)
    keys = torch.from_numpy(CASES["chained_table"].keys)
    before = dict(block_partition.launch_counts)
    for n_blocks in (8, 1 << 18):
        with pytest.raises(RuntimeError,
                           match="partition_histogram kernel launch failed: invalid"):
            block_partition.radix_partition(keys, n_blocks)
    rows = torch.zeros((1, 128), dtype=torch.int32)
    count = torch.tensor([len(keys)], dtype=torch.int32)
    with pytest.raises(RuntimeError, match="partition_scan kernel launch failed: invalid"):
        block_partition.partition_scan(rows)
    with pytest.raises(RuntimeError, match="radix_scatter kernel launch failed: invalid"):
        block_partition.radix_scatter(keys, rows, torch.zeros(129, dtype=torch.int32), 8192,
                                      0, 7, count)
    with pytest.raises(RuntimeError, match="radix_offsets kernel launch failed: invalid"):
        block_partition.radix_offsets(keys, 8, count)
    lib.radix_slabs = lambda *a: -1
    with pytest.raises(RuntimeError, match="radix_slabs failed: invalid"):
        block_partition.radix_partition(keys, 8)
    assert block_partition.launch_counts == before


def test_failed_build_raises(monkeypatch):
    _cuda_stubs(monkeypatch)

    def no_nvcc():
        raise RuntimeError("nvcc not found")

    monkeypatch.setattr(native, "library", no_nvcc)
    before = dict(block_partition.launch_counts)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        block_partition.radix_partition(torch.from_numpy(CASES["chained_table"].keys), 8)
    assert block_partition.launch_counts == before


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(CASES))
def test_kernel_matches_twin(name, cuda_device):
    """Kernel == twin: the twin's keys in the twin's order (stable passes),
    equal offsets, every key inside its own block's window; each pass's
    kernels and the offsets launched once (none for no keys)."""
    case = CASES[name]
    keys = case.inputs(cuda_device)[0]
    before = dict(block_partition.launch_counts)
    grouped, off = block_partition.block_partition(keys, case.n_buckets, case.bpb)
    torch.cuda.synchronize()
    n = len(case.keys)
    passes = len(block_partition.radix_passes(case.n_buckets // case.bpb))
    launched = {"partition_histogram": passes, "partition_scan": passes,
                "radix_scatter": passes, "radix_offsets": 1}
    assert block_partition.launch_counts == {
        **before, **{k: before[k] + v * bool(n) for k, v in launched.items()}}
    twin_grouped, twin_off = block_partition.block_partition_reference(*case.inputs("cpu"))
    assert torch.equal(grouped.cpu(), twin_grouped)
    assert torch.equal(off.cpu(), twin_off)
    check_partition(keys, grouped, off, case.n_buckets, case.bpb)


@pytest.mark.cuda
@pytest.mark.parametrize("name,n_slabs", SLAB_CASES)
def test_each_kernel_matches_its_plain_piece(name, n_slabs, cuda_device):
    """Each kernel at a slab count of the caller's against its plain piece on
    the same inputs, bit for bit: the histogram rows, the scan and the
    digits' totals, each pass's scatter, the offsets."""
    case = CASES[name]
    keys = case.inputs(cuda_device)[0]
    if not keys.numel():
        pytest.skip("no keys: the kernels are not launched")
    n_blocks = case.n_buckets // case.bpb
    _, slab_len = block_partition.slab_layout(keys.numel(), n_slabs)
    count = torch.tensor([keys.numel()], dtype=torch.int32, device=cuda_device)
    for shift, bits in block_partition.radix_passes(n_blocks):
        rows = block_partition.partition_histogram(keys, n_blocks, shift, bits, count, n_slabs)
        assert torch.equal(rows, block_partition.slab_histograms(keys, n_blocks, slab_len,
                                                                 shift, bits, n_slabs))
        bases, doff = block_partition.slab_bases(rows)
        totals = block_partition.partition_scan(rows)
        assert torch.equal(rows, bases) and torch.equal(totals, doff.diff())
        out = block_partition.radix_scatter(keys, rows, doff, n_blocks, shift, bits, count)
        assert torch.equal(out, block_partition.slab_scatter_reference(
            keys, bases, doff, n_blocks, slab_len, shift, bits))
        keys = out
    assert torch.equal(block_partition.radix_offsets(keys, n_blocks, count),
                       block_partition.radix_offsets_reference(keys, n_blocks))


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


def _placed(keys: torch.Tensor, offset: int) -> torch.Tensor:
    """A copy of ``keys`` as a contiguous view ``offset`` keys into a fresh
    buffer: at 1, a base on 8 bytes and not on 16."""
    buffer = torch.empty(keys.numel() + offset, dtype=keys.dtype, device=keys.device)
    buffer[offset:].copy_(keys)
    return buffer[offset:]


@pytest.mark.cuda
@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("name", list(CASES))
def test_kernels_partition_the_device_count(name, offset, cuda_device):
    """A capacity buffer with a garbage tail and a device count: the
    kernels == the twin on ``keys[:n]`` in order, and each kernel == its
    plain piece on the count's keys (the histogram's rows past the count's
    last slab zeros), the slabs cut on the card, so the count ends inside
    a slab's last tile. At ``offset`` 1 the keys and each pass's output
    are views ``buffer[1:]``, whose base lies on 8 bytes and not on 16,
    as the scatter's bulk copies must not need."""
    case = CASES[name]
    keys, n_buckets, bpb = case.inputs("cpu")
    n, n_blocks = keys.shape[0], n_buckets // bpb
    buffer = _placed(_with_tail(keys).to(cuda_device), offset)
    assert buffer.data_ptr() % 16 == 8 * offset
    count = torch.tensor([n, 0], dtype=torch.int32, device=cuda_device)
    grouped, off = block_partition.block_partition(buffer, n_buckets, bpb, count=count)
    twin_grouped, twin_off = block_partition.block_partition_reference(keys, n_buckets, bpb)
    assert torch.equal(grouped[:n].cpu(), twin_grouped) and torch.equal(off.cpu(), twin_off)
    n_slabs = block_partition.radix_slabs(buffer.device)
    _, slab_len = block_partition.slab_layout(n, n_slabs)
    cur, plain = buffer, keys.to(cuda_device)
    for shift, bits in block_partition.radix_passes(n_blocks):
        rows = block_partition.partition_histogram(cur, n_blocks, shift, bits, count, n_slabs)
        want = block_partition.slab_histograms(plain, n_blocks, slab_len, shift, bits, n_slabs)
        assert torch.equal(rows, want)
        bases, doff = block_partition.slab_bases(rows)
        block_partition.partition_scan(rows)
        out = block_partition.radix_scatter(cur, rows, doff, n_blocks, shift, bits, count,
                                            _placed(cur, offset))
        plain = block_partition.slab_scatter_reference(plain, bases, doff, n_blocks, slab_len,
                                                       shift, bits)
        assert torch.equal(out[:n], plain) and torch.equal(out[n:], cur[n:])
        cur = out
    assert torch.equal(block_partition.radix_offsets(cur, n_blocks, count),
                       block_partition.radix_offsets_reference(plain, n_blocks))
