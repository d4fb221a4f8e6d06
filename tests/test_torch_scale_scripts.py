"""The port's scale scripts on the CPU at a small size:
``kmer_mapper_tpu_torch.scripts.scale_run`` on 20,000 reads and
``scale_drill`` at about 1M keys with one 1 Mi-base chunk, each running its
checks and printing its ``RESULT`` line; their generators against the JAX
scripts' (``bench.py``'s read chunk); their checks raising on wrong counts;
and both refusing CUDA without a GPU."""
import importlib.util
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import kmer_mapper_tpu  # noqa: F401  (imported before bench.py, whose generator imports it)
from kmer_mapper_tpu_torch.models.mapper import KmerMapper
from kmer_mapper_tpu_torch.scripts import scale_drill, scale_run

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The twins on one thread: the suite runs files on several workers at
    once, and torch's thread pools in each would contend for the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def result_line(out: str) -> dict:
    lines = [line for line in out.splitlines() if line.startswith("RESULT ")]
    assert len(lines) == 1, out
    return dict(field.split("=", 1) for field in lines[0].split()[1:])


@pytest.fixture
def drill_env(monkeypatch, tmp_path):
    """One 1 Mi-base chunk, and the index file in a temporary directory."""
    monkeypatch.setenv("STEPS", "1")
    monkeypatch.setenv("BUF_MI", "1")
    for name in ("SKIP_DEVICE", "REUSE_INDEX"):
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setattr(scale_drill.tempfile, "tempdir", str(tmp_path))
    return tmp_path


def test_scale_run_small_on_the_cpu(capsys):
    result = scale_run.main(["--reads", "20000", "--device", "cpu"])
    line = result_line(capsys.readouterr().out)
    assert result["reads"] == 20000 and result["kmers"] == 20000 * 121
    assert result["sum"] > 0 and result["prefix_kmers"] > 0
    assert int(line["sum"]) == result["sum"] and float(line["steady_s"]) > 0


def test_scale_run_writes_the_jax_scripts_reads(tmp_path):
    """The first draws of ``scripts/scale_run.py``'s writer, byte for byte."""
    path = tmp_path / "reads.fa"
    scale_run.write_reads(path, 2 * scale_run.CHUNK_READS, np.random.default_rng(0))
    rng = np.random.default_rng(0)
    want = b""
    for c in range(2):
        seqs = rng.choice(np.frombuffer(b"ACGT", np.uint8), (100_000, 151))
        want += b"".join(b">r%d\n" % (c * 100_000 + i) + seqs[i].tobytes() + b"\n"
                         for i in range(100_000))
    assert path.read_bytes() == want


def test_scale_run_prefix_check_raises_on_wrong_counts(tmp_path, monkeypatch):
    path = tmp_path / "reads.fa"
    scale_run.write_reads(path, 3000, np.random.default_rng(0))
    index = scale_run.make_index(path)
    n_kmers, hits = scale_run.check_prefix(index, path, tmp_path, torch.device("cpu"))
    # the first framed chunk: whole reads (the framer keeps the last record
    # of a block back until it has seen the end of the file)
    assert n_kmers % 121 == 0 and 2900 * 121 <= n_kmers <= 3000 * 121 and hits > 0
    real = scale_run.pipeline.map_file
    monkeypatch.setattr(scale_run.pipeline, "map_file",
                        lambda *a, **kw: real(*a, **kw) + np.uint32(1))
    with pytest.raises(AssertionError, match="first chunk's node counts differ"):
        scale_run.check_prefix(index, path, tmp_path, torch.device("cpu"))


def test_scale_drill_small_on_the_cpu(drill_env, capsys):
    result = scale_drill.main(["1", "--device", "cpu"])
    line = result_line(capsys.readouterr().out)
    assert (drill_env / "drill.tpuidx.npz").exists()
    assert result["buckets"] == 1 << 18 and 900_000 < result["n_keys"] <= 1_000_000
    assert result["buf_mi"] == 1 and result["steps"] == 1 and result["disk_gb"] > 0
    for key in ("build_s", "save_s", "load_s", "upload_s", "best_mk_s", "hash_keys_ms",
                "partition_ms", "count_ms", "finalize_card_ms", "finalize_host_s",
                "first_node_counts_s", "device_entries_s"):
        assert float(line[key]) == result[key] and result[key] > 0, key
    assert line["peak_device_gib"] == "None"  # no device memory on the CPU


def test_scale_drill_reuses_the_saved_index(drill_env, monkeypatch, capsys):
    first = scale_drill.main(["1", "--device", "cpu"])
    monkeypatch.setenv("REUSE_INDEX", "1")
    monkeypatch.setenv("BUF_MI", "2")
    reused = scale_drill.main(["1", "--device", "cpu"])
    assert reused["reused"] == 1 and "build_s" not in reused and "save_s" not in reused
    assert reused["n_keys"] == first["n_keys"] and reused["buf_mi"] == 2
    assert reused["best_mk_s"] > 0


def test_scale_drill_host_phases_only(drill_env, monkeypatch, capsys):
    monkeypatch.setenv("SKIP_DEVICE", "1")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    result = scale_drill.main(["1"])  # no device is picked: --device cuda is not refused
    assert "build_s" in result and "disk_gb" in result and "best_mk_s" not in result
    assert "the host" in capsys.readouterr().out


def test_scale_drill_raises_when_the_device_counts_differ(drill_env, monkeypatch):
    real = KmerMapper.node_counts
    monkeypatch.setattr(KmerMapper, "node_counts",
                        lambda self, **kw: real(self, **kw) + np.uint32(1))
    with pytest.raises(AssertionError, match="node counts differ from the host's"):
        scale_drill.main(["1", "--device", "cpu"])


def test_scale_drill_oracle_counts_each_hit():
    rng = np.random.default_rng(5)
    keys = np.unique(rng.integers(0, 1 << 62, 4000, dtype=np.uint64))
    nodes = rng.integers(0, 50, len(keys)).astype(np.int32)
    index = scale_drill.KmerIndex.from_entries(keys, nodes)
    entry = scale_drill.entry_kmers(index)
    np.testing.assert_array_equal(entry, keys)
    queries = np.concatenate([keys[::3], keys[::7], rng.integers(0, 1 << 62, 500,
                                                                 dtype=np.uint64)])
    want = np.zeros(index.max_node_id + 1, np.uint32)
    for q in queries:
        hit = np.flatnonzero(keys == q)
        if len(hit):
            want[nodes[hit[0]]] += 1
    got = scale_drill.oracle_counts(index, entry, queries)
    np.testing.assert_array_equal(got, want)


def test_make_read_chunk_equals_bench_py():
    path = list(sys.path)
    try:
        spec = importlib.util.spec_from_file_location("_bench_py", ROOT / "bench.py")
        bench = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(bench)
    finally:
        sys.path[:] = path
    assert not bench.RAGGED
    want = bench.make_read_chunk(np.random.default_rng(0), 1 << 16)
    got = scale_drill.make_read_chunk(np.random.default_rng(0), 1 << 16)
    np.testing.assert_array_equal(got.bases, want.bases)
    np.testing.assert_array_equal(got.read_starts, want.read_starts)


@pytest.mark.parametrize("main, argv", [(scale_run.main, []), (scale_drill.main, ["1"])])
def test_refuse_cuda_without_a_gpu(main, argv, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.delenv("SKIP_DEVICE", raising=False)
    with pytest.raises(SystemExit, match="--device cpu"):
        main(argv)
