"""The stream-count kernel and its plain twin against the host oracle on
every hazard case of the kernel's contract, plus the wrapper's argument
checks and the sort-key order. Jax-free, so it also runs on the GPU
machine, which has no jax:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels.py

Tests of the CUDA kernel itself carry the ``cuda`` marker and skip where
PyTorch sees no GPU."""
import numpy as np
import pytest
import torch

from kmer_mapper_tpu_torch.index import layout
from kmer_mapper_tpu_torch.ops import stream_count_cases, stream_probe

CASES = {c.name: c for c in stream_count_cases.cases()}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


def _u32(t):
    return t.cpu().numpy().view(np.uint32)


@pytest.mark.parametrize("name", list(CASES))
def test_twin_matches_oracle(name):
    case = CASES[name]
    before = dict(stream_probe.launch_counts)
    got = stream_probe.stream_count(*case.inputs("cpu"))
    np.testing.assert_array_equal(_u32(got), case.expected())
    # on a CPU tensor the wrapper runs the twin and never counts a launch
    assert stream_probe.launch_counts["stream_count"] == before["stream_count"]
    assert (stream_probe.launch_counts["stream_count_reference"]
            == before["stream_count_reference"] + 1)


def test_huge_table_case_logic_on_small_table():
    """The slot-past-2**31 case's construction, at a size the CPU holds."""
    args, (slots, reps) = stream_count_cases.huge_table_inputs("cpu", 1 << 12)
    counts = stream_probe.stream_count(*args)
    got = _u32(counts)
    np.testing.assert_array_equal(got[slots], reps)
    assert got.sum() == reps.sum()
    hit, values = stream_count_cases.nonzero_counts(counts, row=1000)
    np.testing.assert_array_equal(hit, slots)
    np.testing.assert_array_equal(values, reps)


def test_sort_key_orders_as_unsigned_pairs():
    rng = np.random.default_rng(5)
    m_lo = rng.integers(0, 1 << 32, 3000, dtype=np.int64)
    m_hi = rng.integers(0, 1 << 32, 3000, dtype=np.int64)
    m_lo[:1000] |= 1 << 31  # top bit set: would sort first as signed words
    m_lo[1000:1100] = m_lo[0]  # ties on m_lo order by m_hi
    m_lo[-5:] = m_hi[-5:] = 0xFFFFFFFF  # the invalid pair
    m_lo[-6], m_hi[-6] = 0, 0
    keys = stream_probe.sort_mixed(torch.from_numpy(m_lo), torch.from_numpy(m_hi))
    order = np.lexsort((m_hi, m_lo))
    lo, hi = stream_probe.split_key(keys)
    np.testing.assert_array_equal(lo.numpy(), m_lo[order])
    np.testing.assert_array_equal(hi.numpy(), m_hi[order])
    assert keys[-1] == torch.iinfo(torch.int64).max  # invalid sorts last


def test_stream_count_checks_its_arguments():
    args = list(CASES["table_64_buckets"].inputs("cpu"))
    bad = {
        0: args[0].to(torch.int64),  # key_lo dtype
        2: args[2][:-1],  # counts length
        3: args[3].to(torch.int32),  # sort keys dtype
        4: args[4][:-1],  # offsets length
        6: args[6] + 1,  # shift
        7: args[7] // 2,  # block size
    }
    for i, value in bad.items():
        with pytest.raises(ValueError):
            stream_probe.stream_count(*args[:i], value, *args[i + 1 :])
    with pytest.raises(ValueError, match="contiguous"):
        stream_probe.stream_count(
            args[0].t().contiguous().t(), *args[1:]
        )
    meta = [a.to("meta") if isinstance(a, torch.Tensor) else a for a in args]
    with pytest.raises(ValueError, match="no kernel"):
        stream_probe.stream_count(*meta)


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(CASES))
def test_kernel_matches_twin(name, cuda_device):
    case = CASES[name]
    before = stream_probe.launch_counts["stream_count"]
    got = stream_probe.stream_count(*case.inputs(cuda_device))
    torch.cuda.synchronize()
    assert stream_probe.launch_counts["stream_count"] == before + 1
    twin = stream_probe.stream_count_reference(*case.inputs(cuda_device))
    np.testing.assert_array_equal(_u32(got), _u32(twin))
    np.testing.assert_array_equal(_u32(got), case.expected())


@pytest.mark.cuda
def test_kernel_slots_past_2_31(cuda_device):
    if torch.cuda.get_device_properties(cuda_device).total_memory < 60 << 30:
        pytest.skip("the 2**29-bucket table needs 48 GiB of device memory")
    args, (slots, reps) = stream_count_cases.huge_table_inputs(cuda_device)
    counts = stream_probe.stream_count(*args)
    hit, values = stream_count_cases.nonzero_counts(counts)
    np.testing.assert_array_equal(hit, slots)
    np.testing.assert_array_equal(values, reps)
    assert slots.max() >= 1 << 31


@pytest.mark.cuda
@pytest.mark.parametrize("workers", [1, 4])
@pytest.mark.parametrize("kind", ["fixed_fastq", "ragged_fasta_gz", "fixed_revcomp"])
def test_map_file_on_cuda_matches_oracle(kind, workers, cuda_device, tmp_path):
    """The file path on the GPU: the plane step, the ragged step and
    revcomp all reach the kernel and give the oracle's node counts, with
    one framing worker and with four (a file this small stays one region;
    buffers staged in page-locked host memory either way)."""
    got, want = _map_file_case(kind, workers, cuda_device, tmp_path)
    np.testing.assert_array_equal(got, want)


def _map_file_case(kind, workers, device, tmp_path):
    """Node counts of ``pipeline.map_file`` on ``device`` for one file kind,
    and the oracle's."""
    import gzip

    from kmer_mapper_tpu_torch import oracle, pipeline
    from kmer_mapper_tpu_torch.index import kmer_index

    rng = np.random.default_rng(len(kind))
    k, revcomp = 31, kind == "fixed_revcomp"
    lengths = rng.integers(20, 300, 3000) if kind == "ragged_fasta_gz" else np.full(3000, 151)
    reads = ["".join(rng.choice(list("ACGTN"), n)) for n in lengths]
    if kind == "ragged_fasta_gz":
        path = tmp_path / "reads.fa.gz"
        with gzip.open(path, "wt") as f:
            f.write("".join(f">r{i}\n{s}\n" for i, s in enumerate(reads)))
    else:
        path = tmp_path / "reads.fq"
        path.write_text("".join(f"@r{i}\n{s}\n+\n{'I' * len(s)}\n" for i, s in enumerate(reads)))
    codes = oracle.encode_bytes(np.frombuffer("".join(reads).encode(), np.uint8))
    kmers = oracle.kmer_hashes_ragged(codes, lengths, k)
    if revcomp:
        kmers = np.concatenate([kmers, oracle.revcomp_hash(kmers, k)])
    entries = np.concatenate([kmers[::50], rng.integers(0, 1 << 62, 5000, dtype=np.uint64)])
    arrays = oracle.build_kmer_index(entries, rng.integers(0, 900, len(entries)), 20011)
    kmer_index.save_reference_npz(tmp_path / "index.npz", arrays)
    before = stream_probe.launch_counts["stream_count"]
    got = pipeline.map_file(
        str(tmp_path / "index.npz"), str(path), device=device, k=k,
        map_reverse_complements=revcomp, reader_workers=workers,
    )
    assert stream_probe.launch_counts["stream_count"] > before
    return got, oracle.map_kmers_to_index(arrays, kmers)


def _two_devices():
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")


@pytest.mark.cuda
def test_pinned_ring_event_waits_on_the_mappers_device():
    """With another device current, the ring's event still follows the
    mapper's stream: it is pending while that stream is busy. One recorded
    on the idle current device would complete at once and let the producer
    overwrite a buffer whose upload is still queued."""
    from kmer_mapper_tpu_torch import pipeline

    _two_devices()
    mapper_device = torch.device("cuda", 1)
    with torch.cuda.device(0):
        ring = pipeline.PinnedRing(1, 1024, mapper_device)
        buf, _ = ring._free.get()
        with torch.cuda.device(mapper_device):
            torch.cuda._sleep(1 << 30)  # about half a second of the mapper's stream
        ring.release(buf)
        _, event = ring._free.get()
        assert not event.query()
        event.synchronize()
        assert event.query()


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["fixed_fastq", "ragged_fasta_gz"])
def test_map_file_on_a_device_that_is_not_current(kind, tmp_path):
    _two_devices()
    with torch.cuda.device(0):
        got, want = _map_file_case(kind, 1, torch.device("cuda", 1), tmp_path)
    np.testing.assert_array_equal(got, want)


def test_pinned_ring_records_on_the_mappers_stream(monkeypatch):
    """The ring records its event on the current stream of the mapper's
    device, not of the thread's current device (no card needed: the CUDA
    calls are stood in for)."""
    from kmer_mapper_tpu_torch import pipeline

    recorded = []

    class Event:
        def record(self, stream=None):
            recorded.append(stream)

    monkeypatch.setattr(torch.cuda, "Event", Event)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: ("stream", device))
    ring = pipeline.PinnedRing(0, 16, torch.device("cuda", 1))
    ring.release(torch.zeros(16, dtype=torch.int32))
    assert recorded == [("stream", torch.device("cuda", 1))]
