"""The port's gzip input (``io/gzio.py``, ``readers.open_bytes``) against the
JAX package's: BGZF detection, the parallel libdeflate decode, trailing
plain members, a truncated tail, plain gzip, a host without libdeflate, and
BGZF through ``map_file``; BGZF files come from ``chip_smoke.write_bgzf``,
the writer the smoke test uses."""
import gzip
import importlib.util
from pathlib import Path

import numpy as np
import pytest

from kmer_mapper_tpu import pipeline as ref_pipeline
from kmer_mapper_tpu.index import kmer_index as ref_ki
from kmer_mapper_tpu.io import gzio as ref_gzio
from kmer_mapper_tpu.io import readers as ref_readers
from kmer_mapper_tpu_torch import oracle, pipeline
from kmer_mapper_tpu_torch.index import kmer_index
from kmer_mapper_tpu_torch.io import gzio, native, readers

_spec = importlib.util.spec_from_file_location(
    "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(smoke)
write_bgzf = smoke.write_bgzf


@pytest.fixture
def needs_libdeflate():
    if gzio.libdeflate() is None or ref_gzio.libdeflate() is None:
        pytest.skip("libdeflate not available")


def _read_all(stream, size):
    got = bytearray()
    try:
        while True:
            block = stream.read(size)
            if not block:
                return bytes(got)
            got += block
    finally:
        stream.close()


def test_bgzf_detection(tmp_path, needs_libdeflate):
    payload = b"x" * 100_000
    bg, plain = tmp_path / "a.gz", tmp_path / "b.gz"
    write_bgzf(bg, payload)
    plain.write_bytes(gzip.compress(payload))
    for path, expect in ((bg, True), (plain, False), (tmp_path / "missing.gz", False)):
        assert gzio.is_bgzf(str(path)) is expect is ref_gzio.is_bgzf(str(path))
    head = bg.read_bytes()[:64]
    assert gzio.bgzf_block_size(head) == ref_gzio.bgzf_block_size(head) > 18
    assert gzio.decoder_name(str(bg)) == "libdeflate-bgzf"
    assert gzio.decoder_name(str(plain)) in ("isal", "zlib")


@pytest.mark.parametrize("level", [1, 6])
def test_bgzf_roundtrip_parallel(tmp_path, needs_libdeflate, level):
    payload = np.random.default_rng(0).integers(0, 256, 3_000_000, dtype=np.uint8).tobytes()
    p = tmp_path / "big.gz"
    write_bgzf(p, payload, level=level)
    r = gzio.open_gzip(str(p), n_threads=3)
    assert isinstance(r, gzio.BgzfReader)
    got = _read_all(r, 123_457)  # an awkward size crosses member boundaries
    assert got == payload == _read_all(ref_gzio.open_gzip(str(p)), 123_457)
    assert gzip.decompress(p.read_bytes()) == payload  # a valid multi-member gzip


def test_bgzf_with_trailing_plain_gzip_members(tmp_path, needs_libdeflate):
    """``cat a.bgzf b.gz c.gz``: order holds and every member decodes."""
    rng = np.random.default_rng(1)
    head = rng.integers(0, 256, 400_000, dtype=np.uint8).tobytes()
    mid, tail = b"MID" * 50_000, b"TAIL" * 25_000
    p = tmp_path / "mixed.gz"
    write_bgzf(p, head)
    with open(p, "ab") as f:
        f.write(gzip.compress(mid))
        f.write(gzip.compress(tail))
    r = gzio.open_gzip(str(p))
    assert isinstance(r, gzio.BgzfReader)
    got = _read_all(r, 77_777)
    assert got == head + mid + tail == _read_all(ref_gzio.open_gzip(str(p)), 77_777)


def test_bgzf_read_all_contract(tmp_path, needs_libdeflate):
    payload = b"xyz" * 100_000
    p = tmp_path / "r.gz"
    write_bgzf(p, payload)
    r = gzio.open_gzip(str(p))
    assert r.read(-1) == payload
    r.close()


def test_bgzf_truncated_tail_raises(tmp_path, needs_libdeflate):
    p = tmp_path / "t.gz"
    write_bgzf(p, b"ok" * 50_000)
    with open(p, "ab") as f:
        f.write(gzip.compress(b"lost")[:-6])  # a truncated trailing member
    for module in (gzio, ref_gzio):
        r = module.open_gzip(str(p))
        with pytest.raises(OSError):
            r.read(-1)
        r.close()


def test_plain_gzip_through_open_bytes(tmp_path):
    """Plain gzip decodes on a background thread, as the JAX package's
    open_bytes does; a truncated file raises through it."""
    payload = b"@r0\nACGTACGTAC\n+\nIIIIIIIIII\n" * 50_000
    p = tmp_path / "p.fq.gz"
    p.write_bytes(gzip.compress(payload))
    stream = readers.open_bytes(str(p))
    assert isinstance(stream, readers._ThreadedReader)
    assert _read_all(stream, 1000) == payload == _read_all(ref_readers.open_bytes(str(p)), 1000)
    p.write_bytes(gzip.compress(payload)[:-100])
    stream = readers.open_bytes(str(p))
    with pytest.raises(EOFError):
        _read_all(stream, 1 << 16)


def test_bgzf_without_libdeflate_decodes_serially(tmp_path, monkeypatch):
    """A host without libdeflate (the card's host may have none) reads BGZF
    as the multi-member gzip it is."""
    payload = b"@r\nACGT\n+\nIIII\n" * 20_000
    p = tmp_path / "r.fq.gz"
    write_bgzf(p, payload, block_out=5000)
    monkeypatch.setattr(gzio, "libdeflate", lambda: None)
    assert gzio.decoder_name(str(p)) in ("isal", "zlib")
    stream = readers.open_bytes(str(p))
    assert not isinstance(stream, gzio.BgzfReader)
    assert _read_all(stream, 4096) == payload


def _fastq_index(rng, tmp_path):
    reads = ["".join(rng.choice(list("ACGT"), 80)) for _ in range(300)]
    fastq = "".join(f"@r{i}\n{s}\n+\n{'I' * len(s)}\n" for i, s in enumerate(reads)).encode()
    codes = oracle.encode_bytes(np.frombuffer("".join(reads).encode(), np.uint8))
    kmers = oracle.kmer_hashes_ragged(codes, np.full(len(reads), 80), 7)
    entries = np.unique(rng.choice(kmers, 400))
    arrays = oracle.build_kmer_index(entries, rng.integers(0, 40, len(entries)).astype(np.int32),
                                     499)
    kmer_index.save_reference_npz(tmp_path / "index.npz", arrays)
    return fastq, oracle.map_kmers_to_index(arrays, kmers)


@pytest.mark.parametrize("libdeflate", [True, False])
def test_bgzf_through_map_file(tmp_path, monkeypatch, libdeflate):
    """A BGZF FASTQ maps to the counts of its plain version, of the JAX
    package and of the oracle, with the native loader framing it."""
    if libdeflate and gzio.libdeflate() is None:
        pytest.skip("libdeflate not available")
    if not libdeflate:
        monkeypatch.setattr(gzio, "libdeflate", lambda: None)
    fastq, expect = _fastq_index(np.random.default_rng(5), tmp_path)
    plain, bg = tmp_path / "reads.fq", tmp_path / "reads.fq.gz"
    plain.write_bytes(fastq)
    write_bgzf(bg, fastq, block_out=4000)
    index = str(tmp_path / "index.npz")
    got_plain = pipeline.map_file(index, str(plain), device="cpu", k=7)
    before = native.frame_counts["buffers"]
    got_bgzf = pipeline.map_file(index, str(bg), device="cpu", k=7)
    assert native.frame_counts["buffers"] > before or not native.available()
    np.testing.assert_array_equal(got_bgzf, got_plain)
    np.testing.assert_array_equal(got_bgzf, expect)
    ref = ref_pipeline.map_file(ref_ki.load_index(index), str(bg), k=7, progress=False)
    np.testing.assert_array_equal(got_bgzf, ref)
