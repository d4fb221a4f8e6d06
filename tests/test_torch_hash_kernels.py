"""The hash-key kernels' plain twins against the host oracle on every hazard
case of ``ops/hash_keys_cases.py``, the premise of the ragged kernel's
window rule on the packers' own output, the wrappers' argument checks and
their refusal to fall back. Jax-free, so it also runs on the GPU machine,
which has no jax:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_hash_kernels.py

Tests of the CUDA kernels themselves carry the ``cuda`` marker and skip
where PyTorch sees no GPU."""
import contextlib
import io
import types

import numpy as np
import pytest
import torch

from kmer_mapper_tpu_torch import native, oracle
from kmer_mapper_tpu_torch.index import kmer_index
from kmer_mapper_tpu_torch.io import native as native_loader
from kmer_mapper_tpu_torch.io import readers
from kmer_mapper_tpu_torch.models import mapper as mapper_mod
from kmer_mapper_tpu_torch.ops import hash_keys_cases, hashing

CASES = {c.name: c for c in hash_keys_cases.cases()}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _wrapper(case):
    return hashing.ragged_hash_keys if case.ragged else hashing.plane_hash_keys


def _twin(case):
    return (hashing.ragged_hash_keys_reference if case.ragged
            else hashing.plane_hash_keys_reference)


def _keys(case, out):
    """A wrapper's keys: the plane step's tensor, or the first ``count[0]``
    of the ragged step's buffer (its (keys, count) pair)."""
    if not case.ragged:
        return out
    keys, count = out
    assert count.dtype == torch.int32 and count.shape == (2,)
    assert count.tolist() == [case.n_keys(), case.n_keys() // (2 if case.revcomp else 1)]
    return keys[:case.n_keys()]


@pytest.mark.parametrize("name", list(CASES))
def test_twin_matches_oracle(name):
    case = CASES[name]
    kernel = "ragged_hash_keys" if case.ragged else "plane_hash_keys"
    before = dict(hashing.launch_counts)
    out = _wrapper(case)(*case.inputs("cpu"))
    keys = _keys(case, out)
    assert keys.dtype == torch.int64 and keys.numel() == case.n_keys()
    if case.ragged:  # on the CPU the twin returns exactly the keys
        assert out[0].numel() == case.n_keys()
    np.testing.assert_array_equal(np.sort(keys.numpy()), case.expected_keys())
    # on a CPU tensor the wrapper runs the twin and never counts a launch
    assert hashing.launch_counts[kernel] == before[kernel]
    assert (hashing.launch_counts[f"{kernel}_reference"]
            == before[f"{kernel}_reference"] + 1)


@pytest.mark.parametrize("revcomp", [False, True])
def test_plane_hashes_only_the_rows_the_buffer_holds(revcomp):
    """A partly filled strided buffer gives n_reads * (L - k + 1) keys (x2
    with revcomp), whatever its other rows hold."""
    k, L, rows = 21, 151, 8
    rng = np.random.default_rng(7)
    reads = [np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, L)] for _ in range(3)]
    chunk = readers.SequenceChunk(np.concatenate(reads), np.arange(3) * L)
    (packed, _, n_bases, n_reads, _, strided), = readers.pack_for_device(
        iter([chunk]), rows * L, rows, k, read_len=L)
    assert strided and n_reads == 3 and len(packed) == rows * hashing.read_stride(L) // 16
    words = torch.from_numpy(packed.view(np.int32))
    keys = hashing.plane_hash_keys(words, k, L, n_reads, 5, revcomp)
    assert keys.numel() == 3 * (L - k + 1) * (2 if revcomp else 1)
    expect = hash_keys_cases.expected_keys(
        [hash_keys_cases.unpack(packed[r * 10:(r + 1) * 10], L) for r in range(3)], k, 5,
        revcomp)
    np.testing.assert_array_equal(np.sort(keys.numpy()), expect)
    noisy = words.clone()
    noisy[3 * 10:] = torch.from_numpy(rng.integers(-2**31, 2**31, len(packed) - 30,
                                                   dtype=np.int64).astype(np.int32))
    assert torch.equal(hashing.plane_hash_keys(noisy, k, L, n_reads, 5, revcomp), keys)


def _packers(name, k):
    """Each packer's buffers of a ragged source: the numpy packer, and the
    native loader on the same reads as FASTA."""
    groups, buf, max_reads, _ = hash_keys_cases.ragged_sources()[name]
    out = {"numpy": hash_keys_cases.ragged_buffers(name, k)}
    if native_loader.available():
        fasta = b"".join(b">r\n%s\n" % part.tobytes() for group in groups for part in group)
        out["native"] = list(native_loader.pack_stream_native(
            io.BytesIO(fasta), "fasta", buf, max_reads, k, block_bytes=1 << 16))
    return out


@pytest.mark.parametrize("name,k", hash_keys_cases.ragged_configs())
def test_packer_lengths_tile_the_buffer(name, k):
    """The premise of the ragged kernel: in every buffer the packers emit,
    the lengths of the first n_reads reads add up to n_bases and the rest
    are 0, so the windows of each read (start + t, t <= len - k) are
    exactly ``window_mask``'s (no read start inside (t, t + k), t + k <=
    n_bases). The native loader packs the same buffers."""
    packers = _packers(name, k)
    if "native" in packers:
        assert len(packers["native"]) == len(packers["numpy"])
        for a, b in zip(packers["native"], packers["numpy"]):
            np.testing.assert_array_equal(a[0], b[0])
            np.testing.assert_array_equal(a[1], b[1])
            assert tuple(a[2:]) == tuple(b[2:])
    for buffers in packers.values():
        for packed, lengths, n_bases, n_reads, _ in buffers:
            lengths = lengths.astype(np.int64)
            assert lengths[:n_reads].sum() == n_bases and not lengths[n_reads:].any()
            buf = (len(packed) - 2) * 16
            per_read = np.zeros(buf, dtype=bool)
            for start, n in zip(np.cumsum(lengths) - lengths, lengths):
                per_read[start : start + max(0, n - k + 1)] = True
            starts = torch.from_numpy(np.cumsum(lengths) - lengths)
            np.testing.assert_array_equal(
                hashing.window_mask(starts, n_bases, k, buf).numpy(), per_read)


def _trimmed(case, device):
    """A ragged case's inputs with its lengths cut after the last read that
    holds a base (``lengths[:n_reads]``, as the pipeline stages them)."""
    words, lengths, *rest = case.inputs(device)
    nonzero = np.flatnonzero(case.lengths)
    return (words, lengths[: nonzero[-1] + 1 if len(nonzero) else 0], *rest)


RAGGED = [name for name, c in CASES.items() if c.ragged]


@pytest.mark.parametrize("name", RAGGED)
def test_ragged_keys_need_only_the_reads_lengths(name):
    """The lengths of the buffer's reads alone give the keys that the
    zero-padded ``max_reads`` array gives."""
    case = CASES[name]
    got = hashing.ragged_hash_keys(*_trimmed(case, "cpu"))
    want = hashing.ragged_hash_keys(*case.inputs("cpu"))
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_ragged_refuses_lengths_that_do_not_tile_the_buffer():
    case = next(c for c in CASES.values() if c.ragged and c.n_bases)
    words, lengths, n_bases, *rest = case.inputs("cpu")
    with pytest.raises(ValueError, match="add up to"):
        hashing.ragged_hash_keys(words, lengths, n_bases - 1, *rest)


def _untiled(case):
    """A ragged case's lengths made not to tile its buffer, each way: a sum
    one short, and one read made negative with the sum kept."""
    lengths = case.lengths.astype(np.int64)
    short = lengths.copy()
    short[np.flatnonzero(short)[0]] -= 1
    negative = np.concatenate([lengths, [-5, 5]])
    return {"short": short, "negative": negative}


@pytest.mark.parametrize("how", ["short", "negative"])
def test_host_lengths_that_do_not_tile_the_buffer_raise_before_the_upload(how):
    """``check_lengths`` (what the mappers run on host lengths before the
    upload) and the CPU wrapper raise on a sum other than n_bases and on a
    negative length."""
    case = next(c for c in CASES.values() if c.ragged and c.n_bases)
    lengths = _untiled(case)[how]
    match = "add up to" if how == "short" else "negative"
    for host in (lengths, torch.from_numpy(lengths.astype(np.int32))):
        with pytest.raises(ValueError, match=match):
            hashing.check_lengths(host, case.n_bases)
    words, _, n_bases, *rest = case.inputs("cpu")
    with pytest.raises(ValueError, match=match):
        hashing.ragged_hash_keys(words, torch.from_numpy(lengths.astype(np.int32)), n_bases,
                                 *rest)
    hashing.check_lengths(case.lengths, case.n_bases)


@pytest.mark.parametrize("name", RAGGED)
def test_offsets_twin_counts_the_valid_windows(name):
    """The offsets' twin: each read's start and first output slot, and the
    count (keys, valid windows) == the oracle's; (-1, -1) where the
    lengths do not tile the buffer."""
    case = CASES[name]
    _, lengths, n_bases, k, _, revcomp = case.inputs("cpu")
    before = dict(hashing.launch_counts)
    starts, offs, count = hashing.ragged_offsets(lengths, n_bases, k, revcomp)
    assert hashing.launch_counts["ragged_offsets_reference"] == (
        before["ragged_offsets_reference"] + 1)
    assert hashing.launch_counts["ragged_offsets"] == before["ragged_offsets"]
    lens = case.lengths.astype(np.int64)
    np.testing.assert_array_equal(starts.numpy(), np.cumsum(lens) - lens)
    windows = np.maximum(lens - k + 1, 0)
    np.testing.assert_array_equal(offs.numpy(), np.concatenate([[0], np.cumsum(windows)]))
    assert all(t.dtype == torch.int32 for t in (starts, offs, count))
    assert count.tolist() == [case.n_keys(), case.n_keys() // (2 if revcomp else 1)]
    for bad in _untiled(case).values() if case.n_bases else ():
        _, _, failed = hashing.ragged_offsets(torch.from_numpy(bad.astype(np.int32)), n_bases,
                                              k, revcomp)
        assert failed.tolist() == [-1, -1]


def test_wrappers_check_their_arguments():
    plane = next(c for c in CASES.values() if not c.ragged and c.n_reads)
    ragged = next(c for c in CASES.values() if c.ragged and c.n_bases)
    words, k, L, n_reads, seed, rc = plane.inputs("cpu")
    rows = len(words) // (hashing.read_stride(L) // 16)
    bad_plane = [
        ((words.to(torch.int64), k, L, n_reads, seed, rc), "int32 words"),
        ((words, 0, L, n_reads, seed, rc), "k=0"),
        ((words, L + 1, L, n_reads, seed, rc), "read_len"),
        ((words, k, L, rows + 1, seed, rc), "reads in a buffer"),
        ((words.to("meta"), k, L, n_reads, seed, rc), "no kernel for device meta"),
    ]
    for args, match in bad_plane:
        with pytest.raises(ValueError, match=match):
            hashing.plane_hash_keys(*args)
    words, lengths, n_bases, k, seed, rc = ragged.inputs("cpu")
    bad_ragged = [
        ((words, lengths.to(torch.int64), n_bases, k, seed, rc), "int32 read lengths"),
        ((words[:2], lengths, n_bases, k, seed, rc), "at least 3"),
        ((words, lengths, n_bases, 32, seed, rc), "k=32"),
        ((words, lengths, (len(words) - 1) * 16, k, seed, rc), "bases in a buffer"),
        ((words.to("meta"), lengths.to("meta"), n_bases, k, seed, rc),
         "no kernel for device meta"),
    ]
    for args, match in bad_ragged:
        with pytest.raises(ValueError, match=match):
            hashing.ragged_hash_keys(*args)


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
        plane_hash_keys_launch=lambda *a: calls.append(a) or 1,
        ragged_offsets_launch=lambda *a: calls.append(a) or 1,
        ragged_hash_keys_launch=lambda *a: calls.append(a) or 1,
        kmt_error_string=lambda rc: b"invalid argument",
    )
    monkeypatch.setattr(native, "library", lambda: lib)
    plane = next(c for c in CASES.values() if not c.ragged and c.n_reads == 1
                 and c.read_len == 151 and c.k == 31 and c.revcomp and c.seed)
    ragged = next(c for c in CASES.values() if c.ragged and c.n_keys())
    before = dict(hashing.launch_counts)
    with pytest.raises(RuntimeError, match="plane_hash_keys kernel launch failed: invalid"):
        hashing._plane_launch(*plane.inputs("cpu"))
    words, lengths, n_bases, k, seed, revcomp = ragged.inputs("cpu")
    with pytest.raises(RuntimeError, match="ragged_offsets kernel launch failed: invalid"):
        hashing._offsets_launch(lengths, n_bases, k, revcomp)
    starts, offs, count = hashing.ragged_offsets_reference(lengths, n_bases, k, revcomp)
    n_valid = ragged.n_keys() // (2 if revcomp else 1)
    assert int(offs[-1]) == n_valid and offs.numel() == starts.numel() + 1
    with pytest.raises(RuntimeError, match="ragged_hash_keys kernel launch failed: invalid"):
        hashing._ragged_launch(words, starts, offs, count, k, seed, revcomp)
    assert hashing.launch_counts == {**before, "ragged_offsets_reference":
                                     before["ragged_offsets_reference"] + 1}
    plane_args, offsets_args, ragged_args = calls
    # n_reads, words a row, read_len, k, seed, revcomp
    assert plane_args[2:8] == (1, 10, 151, 31, plane.seed, 1)
    # n_rows, then n_bases, k, revcomp
    assert offsets_args[1] == len(ragged.lengths)
    assert offsets_args[6:9] == (n_bases, k, int(revcomp))
    assert ragged_args[1] == len(ragged.packed) and ragged_args[4] == len(ragged.lengths)
    assert ragged_args[5] == count.data_ptr()
    assert ragged_args[7:10] == (k, seed, int(revcomp))


def test_failed_build_raises(monkeypatch):
    _cuda_stubs(monkeypatch)

    def no_nvcc():
        raise RuntimeError("nvcc not found")

    monkeypatch.setattr(native, "library", no_nvcc)
    plane = next(c for c in CASES.values() if not c.ragged and c.n_reads)
    before = dict(hashing.launch_counts)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        hashing._plane_launch(*plane.inputs("cpu"))
    assert hashing.launch_counts == before


def test_nothing_to_hash_launches_nothing(monkeypatch):
    """n_reads == 0: an empty tensor, no launch; a ragged buffer of no
    reads: the key buffer at capacity and no hash launch (on the card the
    offsets' kernel still writes the zero count)."""
    _cuda_stubs(monkeypatch)
    monkeypatch.setattr(native, "library", lambda: pytest.fail("a launch was attempted"))
    plane = next(c for c in CASES.values() if not c.ragged and not c.n_reads)
    ragged = next(c for c in CASES.values() if c.ragged and not c.n_keys())
    assert hashing._plane_launch(*plane.inputs("cpu")).numel() == 0
    words, lengths, _, k, seed, revcomp = ragged.inputs("cpu")
    starts, offs, count = hashing.ragged_offsets_reference(lengths[:0], 0, k, revcomp)
    assert offs.tolist() == [0] and count.tolist() == [0, 0]
    out = hashing._ragged_launch(words, starts, offs, count, k, seed, revcomp)
    assert out.numel() == hashing.ragged_capacity(len(words), revcomp)


def test_key_buffer_is_checked_and_reused(monkeypatch):
    """``out`` must hold the buffer's capacity of int64 keys on the words'
    device; a good one is the buffer the launch writes into."""
    _cuda_stubs(monkeypatch)
    calls = []
    monkeypatch.setattr(native, "library", lambda: types.SimpleNamespace(
        ragged_hash_keys_launch=lambda *a: calls.append(a) or 0))
    ragged = next(c for c in CASES.values() if c.ragged and c.n_keys() and c.revcomp)
    words, lengths, n_bases, k, seed, revcomp = ragged.inputs("cpu")
    starts, offs, count = hashing.ragged_offsets_reference(lengths, n_bases, k, revcomp)
    capacity = hashing.ragged_capacity(len(words), revcomp)
    assert capacity == (len(words) - 2) * 32 >= ragged.n_keys()
    for bad in (torch.empty(capacity - 1, dtype=torch.int64),
                torch.empty(capacity, dtype=torch.int32),
                torch.empty(2 * capacity, dtype=torch.int64)[::2]):
        with pytest.raises(ValueError, match="out is"):
            hashing._ragged_launch(words, starts, offs, count, k, seed, revcomp, bad)
    out = torch.empty(capacity + 3, dtype=torch.int64)
    assert hashing._ragged_launch(words, starts, offs, count, k, seed, revcomp, out) is out
    assert calls[0][6] == out.data_ptr()


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(CASES))
def test_kernel_matches_twin(name, cuda_device):
    """Kernel == twin bit for bit and in the same order, and == the oracle;
    the ragged step's count on the device == the twin's."""
    case = CASES[name]
    kernel = "ragged_hash_keys" if case.ragged else "plane_hash_keys"
    before = hashing.launch_counts[kernel]
    got = _keys(case, _wrapper(case)(*case.inputs(cuda_device)))
    torch.cuda.synchronize()
    launched = case.n_keys() if not case.ragged else len(case.lengths)
    assert hashing.launch_counts[kernel] == before + (1 if launched else 0)
    twin = _twin(case)(*case.inputs(cuda_device))
    assert torch.equal(got, twin)
    np.testing.assert_array_equal(np.sort(got.cpu().numpy()), case.expected_keys())


@pytest.mark.cuda
@pytest.mark.parametrize("name", RAGGED)
def test_kernel_on_trimmed_lengths_matches_twin(name, cuda_device):
    case = CASES[name]
    got = _keys(case, hashing.ragged_hash_keys(*_trimmed(case, cuda_device)))
    assert torch.equal(got, hashing.ragged_hash_keys_reference(*case.inputs(cuda_device)))


def _many_reads(seed: int = 3, n: int = 9000):
    """Lengths of more reads than one tile of the offsets' scan (2,048),
    zero and short ones among them."""
    rng = np.random.default_rng(seed)
    lengths = rng.integers(0, 160, n).astype(np.int32)
    lengths[rng.random(n) < 0.05] = 0
    return lengths


@pytest.mark.cuda
@pytest.mark.parametrize("name", RAGGED + ["many_reads"])
def test_offsets_kernel_matches_twin(name, cuda_device):
    """The offsets' kernel == its twin bit for bit: starts, offsets and the
    count, on every ragged case, on reads over several scan tiles, and on
    lengths that do not tile the buffer ((-1, -1))."""
    if name == "many_reads":
        lengths = _many_reads()
        variants = {"tiled": lengths.astype(np.int64)}
        n_bases, k, revcomp = int(lengths.sum()), 31, True
        bad = lengths.astype(np.int64)
        bad[5000] = -bad[4000] - 1
        variants["negative"] = bad
        variants["short"] = np.concatenate([lengths[:-1], [lengths[-1] + 1]])
    else:
        case = CASES[name]
        n_bases, k, revcomp = case.n_bases, case.k, case.revcomp
        variants = {"tiled": case.lengths, **(_untiled(case) if case.n_bases else {})}
    for lengths in variants.values():
        host = torch.from_numpy(np.asarray(lengths).astype(np.int32))
        got = hashing.ragged_offsets(host.to(cuda_device), n_bases, k, revcomp)
        want = hashing.ragged_offsets_reference(host, n_bases, k, revcomp)
        for a, b in zip(got, want):
            assert torch.equal(a.cpu(), b)


@pytest.mark.cuda
def test_ragged_keys_into_a_used_buffer_on_many_reads(cuda_device):
    """Reads over several scan tiles, with revcomp, hashed into a key buffer
    that holds garbage: the first count[0] keys == the twin's, in order,
    and the buffer past them is untouched."""
    lengths = _many_reads()
    n_bases = int(lengths.sum())
    rng = np.random.default_rng(9)
    words = torch.from_numpy(rng.integers(-2**31, 2**31, n_bases // 16 + 3,
                                          dtype=np.int64).astype(np.int32))
    args = (words, torch.from_numpy(lengths), n_bases, 31, 77, True)
    twin = hashing.ragged_hash_keys_reference(*args)
    capacity = hashing.ragged_capacity(len(words), True)
    out = torch.full((capacity,), -7, dtype=torch.int64, device=cuda_device)
    keys, count = hashing.ragged_hash_keys(*(a.to(cuda_device) if isinstance(a, torch.Tensor)
                                             else a for a in args), out=out)
    assert keys is out and count.tolist() == [twin.numel(), twin.numel() // 2]
    assert torch.equal(keys[:twin.numel()].cpu(), twin)
    assert (keys[twin.numel():] == -7).all()


def _ragged_mapper(device, seed: int = 21):
    """A small mapper, one ragged chunk's (words, lengths, n_bases) and its
    k-mers."""
    rng = np.random.default_rng(seed)
    k = 15
    lengths = rng.integers(0, 90, 40)
    codes = rng.integers(0, 4, int(lengths.sum()))
    kmers = oracle.kmer_hashes_ragged(codes, lengths, k)
    arrays = oracle.build_kmer_index(kmers[::3], rng.integers(0, 30, len(kmers[::3])), 1021)
    config = mapper_mod.MapperConfig(k=k, buf=4096, max_reads=64)
    mapper = mapper_mod.KmerMapper(kmer_index.KmerIndex.from_arrays(arrays), config, device)
    chunk = readers.SequenceChunk(np.frombuffer(b"ACGT", np.uint8)[codes],
                                  np.cumsum(lengths) - lengths)
    (packed, lens, n_bases, n_reads, _), = readers.pack_for_device(
        iter([chunk]), config.buf, config.max_reads, k)
    return mapper, (packed, lens[:n_reads], n_bases), kmers, arrays


def test_window_totals_sum_ints_and_device_counts():
    """``WindowTotals``: ints and count tensors summed when read (one
    read-back of the tensors); a -1 count adds nothing and makes this read
    and every later one raise, until the totals are reset."""
    totals = mapper_mod.WindowTotals()
    totals._reset_totals(10)
    totals._stats += [3, torch.tensor(5, dtype=torch.int32), 4]
    assert totals.n_kmers_mapped == 22 and not totals._stats
    totals._stats += [torch.tensor([7, -1], dtype=torch.int32)[1],
                      torch.tensor(2, dtype=torch.int32)]
    for _ in range(2):
        with pytest.raises(ValueError, match="did not tile"):
            totals.n_kmers_mapped
    assert totals._total_kmers == 24
    totals._reset_totals()
    assert totals.n_kmers_mapped == 0


def test_window_totals_read_each_devices_counts_apart(monkeypatch):
    """A sharded mapper's data rows leave their counts on their own
    devices: the totals stack each device's apart (one stack across two
    devices raises) and read each stack back. Stand-in: counts on the CPU
    and on the meta device, whose read-back yields 7s."""
    stacks = []
    stack, cpu = torch.stack, torch.Tensor.cpu

    def one_device_stack(tensors, *args, **kw):
        stacks.append({t.device.type for t in tensors})
        return stack(tensors, *args, **kw)

    def read_back(t):
        return torch.full(t.shape, 7, dtype=t.dtype) if t.device.type == "meta" else cpu(t)

    monkeypatch.setattr(torch, "stack", one_device_stack)
    monkeypatch.setattr(torch.Tensor, "cpu", read_back)
    totals = mapper_mod.WindowTotals()
    totals._reset_totals()
    meta = torch.empty(2, dtype=torch.int32, device="meta")
    totals._stats += [torch.tensor(5, dtype=torch.int32), meta[1], 4,
                      torch.tensor(3, dtype=torch.int32), meta[0]]
    assert totals.n_kmers_mapped == 5 + 4 + 3 + 2 * 7
    assert sorted(map(sorted, stacks)) == [["cpu"], ["meta"]]


def test_mapper_ragged_count_stays_a_tensor_and_faults_stick():
    """The ragged step appends its valid windows as a tensor, summed when
    n_kmers_mapped is read; host lengths that do not tile the buffer raise
    in map_chunk (before the upload); a -1 count raises at every read-back
    until reset_counts."""
    mapper, (packed, lens, n_bases), kmers, arrays = _ragged_mapper("cpu")
    mapper.map_chunk(packed, lens, n_bases)
    assert isinstance(mapper._stats[0], torch.Tensor)
    assert mapper.n_kmers_mapped == len(kmers)
    np.testing.assert_array_equal(mapper.node_counts(), oracle.map_kmers_to_index(arrays, kmers))
    for bad in (lens.astype(np.int64) + np.eye(1, len(lens), 0, dtype=np.int64)[0],
                torch.from_numpy(lens.astype(np.int32)).pin_memory()
                if torch.cuda.is_available() else torch.from_numpy(lens.astype(np.int32))):
        with pytest.raises(ValueError, match="add up to"):
            mapper.map_chunk(packed, bad, n_bases + (0 if isinstance(bad, np.ndarray) else 1))
    mapper._stats.append(torch.tensor([-1, -1], dtype=torch.int32)[1])
    for read in (lambda: mapper.n_kmers_mapped, mapper.slot_counts, mapper.node_counts,
                 lambda: mapper.n_kmers_mapped):
        with pytest.raises(ValueError, match="did not tile"):
            read()
    mapper.reset_counts()
    assert mapper.n_kmers_mapped == 0


@pytest.mark.cuda
def test_device_lengths_that_do_not_tile_raise_at_the_next_read_back(cuda_device):
    """Lengths already on the card are checked by the offsets' kernel: the
    chunk maps with no sync and counts nothing, and n_kmers_mapped,
    slot_counts and node_counts raise; a good chunk before it still
    counts."""
    mapper, (packed, lens, n_bases), kmers, arrays = _ragged_mapper(cuda_device)
    words = torch.from_numpy(packed.view(np.int32)).to(cuda_device)
    good = torch.from_numpy(lens.astype(np.int32)).to(cuda_device)
    mapper.map_chunk(words, good, n_bases)
    np.testing.assert_array_equal(mapper.node_counts(), oracle.map_kmers_to_index(arrays, kmers))
    before = mapper.slot_counts().copy()
    for bad_bases in (n_bases - 1, n_bases + 1):
        mapper.map_chunk(words, good, bad_bases)
        for read in (lambda: mapper.n_kmers_mapped, mapper.slot_counts, mapper.node_counts):
            with pytest.raises(ValueError, match="did not tile"):
                read()
        assert (mapper.counts.cpu().numpy().view(np.uint32) == before).all()
        mapper.reset_counts()
        mapper.counts.copy_(torch.from_numpy(before.view(np.int32)))
    negative = good.clone()
    negative[0], negative[1] = -3, good[1] + good[0] + 3
    mapper.map_chunk(words, negative, n_bases)
    with pytest.raises(ValueError, match="did not tile"):
        mapper.n_kmers_mapped
