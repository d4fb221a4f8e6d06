"""The port's file path (readers, map_file, the CLI) against the JAX package's
and the numpy oracle, end to end on the CPU."""
import gzip

import numpy as np
import pytest

from kmer_mapper_tpu import cli as ref_cli
from kmer_mapper_tpu import oracle as ref_oracle
from kmer_mapper_tpu import pipeline as ref_pipeline
from kmer_mapper_tpu.index import kmer_index as ref_ki
from kmer_mapper_tpu.io import readers as ref_readers
from kmer_mapper_tpu_torch import cli, pipeline
from kmer_mapper_tpu_torch.io import readers


def _reads(rng, n, lengths, with_n):
    alphabet = list("ACGT" + ("N" if with_n else ""))
    return ["".join(rng.choice(alphabet, ln)) for ln in lengths]


def _write(path, reads, fmt, gz):
    if fmt == "fastq":
        text = "".join(f"@r{i}\n{s}\n+\n{'I' * len(s)}\n" for i, s in enumerate(reads))
    else:  # multi-line records
        text = "".join(f">r{i}\n{s[:40]}\n{s[40:]}\n" for i, s in enumerate(reads))
    data = text.encode()
    if gz:
        with gzip.open(path, "wb") as f:
            f.write(data)
    else:
        path.write_bytes(data)


def _index_npz(rng, reads, k, path):
    codes = [ref_oracle.encode_string(r.replace("N", "A")) for r in reads]
    kmers = ref_oracle.kmer_hashes_ragged(
        np.concatenate(codes), np.array([len(c) for c in codes]), k
    )
    entries = np.concatenate([
        kmers[:: max(1, len(kmers) // 3000)],
        kmers[:: max(1, len(kmers) // 500)],  # repeated entries
        rng.integers(0, 1 << (2 * k), 300, dtype=np.uint64),
    ])
    nodes = rng.integers(0, 400, len(entries)).astype(np.int32)
    arrays = ref_oracle.build_kmer_index(entries, nodes, 4099)
    ref_ki.save_reference_npz(path, arrays)
    return arrays, ref_oracle.map_kmers_to_index(arrays, kmers)


FILES = {
    # 1500 x 61 bases: two CPU buffers of fixed-length reads (plane step)
    "fastq_fixed": dict(fmt="fastq", gz=False, name="reads.fq", fixed=True, with_n=False),
    "fasta_gz_mixed": dict(fmt="fasta", gz=True, name="reads.fa.gz", fixed=False, with_n=False),
    "fastq_with_n": dict(fmt="fastq", gz=False, name="reads.fq", fixed=True, with_n=True),
}


@pytest.mark.parametrize("case", list(FILES))
def test_map_file_matches_jax_and_oracle(case, tmp_path):
    spec = FILES[case]
    rng = np.random.default_rng(len(case))
    k = 31
    lengths = [61] * 1500 if spec["fixed"] else list(rng.integers(20, 140, 900))
    reads = _reads(rng, len(lengths), lengths, spec["with_n"])
    path = tmp_path / spec["name"]
    _write(path, reads, spec["fmt"], spec["gz"])
    index_path = tmp_path / "index.npz"
    _, expect = _index_npz(rng, reads, k, index_path)
    got = pipeline.map_file(
        str(index_path), str(path), device="cpu", k=k, chunk_size=1 << 16
    )
    np.testing.assert_array_equal(got, expect)
    ref = ref_pipeline.map_file(
        str(index_path), str(path), k=k, chunk_size=1 << 16, progress=False
    )
    np.testing.assert_array_equal(got, ref)
    assert got.sum() > 0


def test_fixed_length_file_takes_the_plane_step(tmp_path):
    rng = np.random.default_rng(3)
    reads = _reads(rng, 1500, [61] * 1500, with_n=False)
    path = tmp_path / "reads.fq"
    _write(path, reads, "fastq", gz=False)
    _index_npz(rng, reads, 31, tmp_path / "index.npz")
    index = pipeline.load_index(str(tmp_path / "index.npz"))
    mapper, chunks = pipeline.make_mapper_and_chunks(
        index, str(path), k=31, chunk_size=1 << 16,
        map_reverse_complements=False, device="cpu",
    )
    assert mapper.config.read_len == 61 and mapper.config.buf == 1 << 16
    flags = [c[5] for c in chunks]
    assert len(flags) == 2 and all(flags)


@pytest.mark.parametrize("fmt,gz", [("fastq", False), ("fasta", True)])
def test_readers_match_jax(fmt, gz, tmp_path):
    rng = np.random.default_rng(11)
    reads = _reads(rng, 300, list(rng.integers(10, 90, 300)), with_n=True)
    path = tmp_path / ("reads." + ("fq" if fmt == "fastq" else "fa") + (".gz" if gz else ""))
    _write(path, reads, fmt, gz)
    got = list(readers.read_chunks(str(path), min_chunk_size=2000))
    expect = list(ref_readers.read_chunks(str(path), min_chunk_size=2000))
    assert len(got) == len(expect) > 1
    for a, b in zip(got, expect):
        np.testing.assert_array_equal(a.bases, b.bases)
        np.testing.assert_array_equal(a.read_starts, b.read_starts)
    for read_len in (0, 37):
        packs = list(readers.pack_for_device(iter(got), 1 << 11, 64, 21, read_len=read_len))
        ref_packs = list(
            ref_readers.pack_for_device(iter(expect), 1 << 11, 64, 21, read_len=read_len)
        )
        assert len(packs) == len(ref_packs)
        for a, b in zip(packs, ref_packs):
            np.testing.assert_array_equal(a[0], b[0])
            np.testing.assert_array_equal(a[1], b[1])
            assert a[2:] == b[2:]


def test_cli_map_writes_the_same_npy(tmp_path):
    rng = np.random.default_rng(21)
    reads = _reads(rng, 400, [51] * 400, with_n=True)
    path = tmp_path / "reads.fq"
    _write(path, reads, "fastq", gz=False)
    _, expect = _index_npz(rng, reads, 25, tmp_path / "index.npz")
    args = ["map", "-i", str(tmp_path / "index.npz"), "-f", str(path), "-k", "25"]
    cli.main(args + ["-o", str(tmp_path / "port"), "--device", "cpu"])
    ref_cli.main(args + ["-o", str(tmp_path / "ref")])
    got = np.load(tmp_path / "port.npy")
    np.testing.assert_array_equal(got, np.load(tmp_path / "ref.npy"))
    np.testing.assert_array_equal(got, expect)


def test_cli_map_without_a_gpu_needs_device_cpu(tmp_path, monkeypatch, caplog):
    """``--device`` defaults to cuda; with no GPU the map fails and names
    ``--device cpu`` instead of picking the CPU on its own."""
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rng = np.random.default_rng(22)
    reads = _reads(rng, 50, [40] * 50, with_n=False)
    path = tmp_path / "reads.fq"
    _write(path, reads, "fastq", gz=False)
    _index_npz(rng, reads, 21, tmp_path / "index.npz")
    args = ["map", "-i", str(tmp_path / "index.npz"), "-f", str(path), "-k", "21",
            "-o", str(tmp_path / "out")]
    with pytest.raises(SystemExit) as exc:
        cli.main(args)
    assert exc.value.code != 0
    assert "--device cpu" in caplog.text
    assert not (tmp_path / "out.npy").exists()
    cli.main(args + ["--device", "cpu"])
    assert np.load(tmp_path / "out.npy").sum() > 0


def test_cli_convert_index_then_map(tmp_path):
    """``convert-index`` writes the prebuilt table; mapping it gives the
    counts that mapping the reference .npz gives, and the JAX package reads
    the same file."""
    rng = np.random.default_rng(23)
    reads = _reads(rng, 300, [45] * 300, with_n=False)
    path = tmp_path / "reads.fq"
    _write(path, reads, "fastq", gz=False)
    _, expect = _index_npz(rng, reads, 21, tmp_path / "index.npz")
    cli.main(["convert-index", "-i", str(tmp_path / "index.npz"), "-o", str(tmp_path / "x.tpuidx")])
    assert (tmp_path / "x.tpuidx.npz").exists()
    common = ["-f", str(path), "-k", "21", "--device", "cpu"]
    cli.main(["map", "-i", str(tmp_path / "x.tpuidx.npz"), "-o", str(tmp_path / "a"), *common])
    cli.main(["map", "-i", str(tmp_path / "index.npz"), "-o", str(tmp_path / "b"), *common])
    got = np.load(tmp_path / "a.npy")
    np.testing.assert_array_equal(got, np.load(tmp_path / "b.npy"))
    np.testing.assert_array_equal(got, expect)
    ref_cli.main(["map", "-i", str(tmp_path / "x.tpuidx.npz"), "-f", str(path), "-k", "21",
                  "-o", str(tmp_path / "ref")])
    np.testing.assert_array_equal(got, np.load(tmp_path / "ref.npy"))


def test_cli_map_index_bundle_and_precedence(tmp_path, caplog):
    """``-b`` maps a bundle's kmer_index; ``-i`` wins where both are given;
    with neither, map exits non-zero."""
    import io
    import zipfile

    rng = np.random.default_rng(24)
    reads = _reads(rng, 200, [40] * 200, with_n=False)
    path = tmp_path / "reads.fq"
    _write(path, reads, "fastq", gz=False)
    _, expect = _index_npz(rng, reads, 21, tmp_path / "index.npz")
    with zipfile.ZipFile(tmp_path / "bundle.zip", "w") as zf:
        zf.writestr("kmer_index.npz", (tmp_path / "index.npz").read_bytes())
    other = io.BytesIO()
    ref_ki.save_reference_npz(other, ref_oracle.build_kmer_index(
        np.arange(5, dtype=np.uint64), np.arange(5, dtype=np.int32), 7))
    (tmp_path / "other.npz").write_bytes(other.getvalue())
    common = ["-f", str(path), "-k", "21", "--device", "cpu"]
    cli.main(["map", "-b", str(tmp_path / "bundle.zip"), "-o", str(tmp_path / "b"), *common])
    np.testing.assert_array_equal(np.load(tmp_path / "b.npy"), expect)
    cli.main(["map", "-i", str(tmp_path / "index.npz"), "-b", str(tmp_path / "other.npz"),
              "-o", str(tmp_path / "ib"), *common])
    np.testing.assert_array_equal(np.load(tmp_path / "ib.npy"), expect)
    with pytest.raises(SystemExit) as exc:
        cli.main(["map", "-o", str(tmp_path / "none"), *common])
    assert exc.value.code == 1
    assert "Either a kmer index (-i) or an index bundle (-b)" in caplog.text
