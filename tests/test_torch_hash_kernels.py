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

from kmer_mapper_tpu_torch import native
from kmer_mapper_tpu_torch.io import native as native_loader
from kmer_mapper_tpu_torch.io import readers
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


@pytest.mark.parametrize("name", list(CASES))
def test_twin_matches_oracle(name):
    case = CASES[name]
    kernel = "ragged_hash_keys" if case.ragged else "plane_hash_keys"
    before = dict(hashing.launch_counts)
    keys = _wrapper(case)(*case.inputs("cpu"))
    assert keys.dtype == torch.int64 and keys.numel() == case.n_keys()
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
    assert torch.equal(hashing.ragged_hash_keys(*_trimmed(case, "cpu")),
                       hashing.ragged_hash_keys(*case.inputs("cpu")))


def test_ragged_refuses_lengths_that_do_not_tile_the_buffer():
    case = next(c for c in CASES.values() if c.ragged and c.n_bases)
    words, lengths, n_bases, *rest = case.inputs("cpu")
    with pytest.raises(ValueError, match="add up to"):
        hashing.ragged_hash_keys(words, lengths, n_bases - 1, *rest)


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
    words, lengths, _, k, seed, revcomp = ragged.inputs("cpu")
    starts, offs = hashing.ragged_offsets(lengths, k)
    n_valid = ragged.n_keys() // (2 if revcomp else 1)
    assert int(offs[-1]) == n_valid and offs.numel() == starts.numel() + 1
    with pytest.raises(RuntimeError, match="ragged_hash_keys kernel launch failed: invalid"):
        hashing._ragged_launch(words, starts, offs, n_valid, k, seed, revcomp)
    assert hashing.launch_counts == before
    plane_args, ragged_args = calls
    # n_reads, words a row, read_len, k, seed, revcomp
    assert plane_args[2:8] == (1, 10, 151, 31, plane.seed, 1)
    assert ragged_args[1] == len(ragged.packed) and ragged_args[4] == len(ragged.lengths)
    assert ragged_args[6:10] == (n_valid, k, seed, int(revcomp))


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
    """n_reads == 0, or no read as long as k: an empty tensor, no launch."""
    _cuda_stubs(monkeypatch)
    monkeypatch.setattr(native, "library", lambda: pytest.fail("a launch was attempted"))
    plane = next(c for c in CASES.values() if not c.ragged and not c.n_reads)
    ragged = next(c for c in CASES.values() if c.ragged and not c.n_keys())
    assert hashing._plane_launch(*plane.inputs("cpu")).numel() == 0
    words, lengths, _, k, seed, revcomp = ragged.inputs("cpu")
    starts, offs = hashing.ragged_offsets(lengths, k)
    assert int(offs[-1]) == 0
    assert hashing._ragged_launch(words, starts, offs, 0, k, seed, revcomp).numel() == 0


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(CASES))
def test_kernel_matches_twin(name, cuda_device):
    """Kernel == twin bit for bit and in the same order, and == the oracle."""
    case = CASES[name]
    kernel = "ragged_hash_keys" if case.ragged else "plane_hash_keys"
    before = hashing.launch_counts[kernel]
    got = _wrapper(case)(*case.inputs(cuda_device))
    torch.cuda.synchronize()
    assert hashing.launch_counts[kernel] == before + (1 if case.n_keys() else 0)
    twin = _twin(case)(*case.inputs(cuda_device))
    assert torch.equal(got, twin)
    np.testing.assert_array_equal(np.sort(got.cpu().numpy()), case.expected_keys())


@pytest.mark.cuda
@pytest.mark.parametrize("name", RAGGED)
def test_kernel_on_trimmed_lengths_matches_twin(name, cuda_device):
    case = CASES[name]
    got = hashing.ragged_hash_keys(*_trimmed(case, cuda_device))
    assert torch.equal(got, hashing.ragged_hash_keys_reference(*case.inputs(cuda_device)))
