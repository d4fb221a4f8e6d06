"""The port's config matrix (``kmer_mapper_tpu_torch.scripts.bench_matrix``)
on the CPU: its generator against ``scripts/bench_matrix.py``'s (same reads,
same index from the same seed), configurations 1-4 at full size and
configuration 5 on a (1, 2) grid of the CPU, each node-count vector equal
to the numpy oracle's and each sum to BENCH_MATRIX.md's, and the check
raising on a wrong sum or vector."""
import importlib.util
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import kmer_mapper_tpu  # noqa: F401  (before the script, whose index_from_reads imports it)
from kmer_mapper_tpu_torch import oracle
from kmer_mapper_tpu_torch.scripts import bench_matrix as M

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The twins on one thread: the suite runs files on several workers at
    once, and torch's thread pools in each would contend for the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
CPU = torch.device("cpu")
NAMES = ["1", "2", "3 k=16", "3 k=21", "3 k=31", "4", "5"]


def load_jax_script():
    """``scripts/bench_matrix.py`` as a module, with what its import does to
    ``sys.path`` undone."""
    path = list(sys.path)
    try:
        spec = importlib.util.spec_from_file_location(
            "_script_bench_matrix", ROOT / "scripts" / "bench_matrix.py")
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
    finally:
        sys.path[:] = path
    return module


@pytest.mark.parametrize("k, with_n", [(16, True), (21, True), (31, False)])
def test_generator_equals_the_jax_scripts(k, with_n):
    jax_script = load_jax_script()
    rng_jax, rng_port = np.random.default_rng(0), np.random.default_rng(0)
    reads = M.make_reads(rng_port, 300, with_n=with_n)
    assert reads == jax_script.make_reads(rng_jax, 300, with_n=with_n)
    assert any("N" in r for r in reads) == with_n
    clean = [r.replace("N", "A") for r in reads]
    want = jax_script.index_from_reads(rng_jax, clean, k, 5000, 700)
    got = M.index_from_reads(rng_port, clean, k, 5000, 700)
    assert got.n_unique == want.n_unique and got.max_node_id == want.max_node_id
    np.testing.assert_array_equal(got.entry_node, want.entry_node)
    np.testing.assert_array_equal(got.entry_slot, want.entry_slot)
    np.testing.assert_array_equal(got.entry_frequency, want.entry_frequency)
    np.testing.assert_array_equal(got.table.key_lo, want.table.key_lo)
    np.testing.assert_array_equal(got.table.key_hi, want.table.key_hi)
    # both generators leave the stream at the same place
    assert rng_port.integers(0, 1 << 62) == rng_jax.integers(0, 1 << 62)


def test_write_reads_equals_the_jax_scripts(tmp_path):
    jax_script = load_jax_script()
    reads = M.make_reads(np.random.default_rng(3), 20, with_n=True)
    for name, kw in [("a.fa", {}), ("a.fq", dict(fastq=True)),
                     ("a.fq.gz", dict(fastq=True, gz=True))]:
        port = M.write_reads(tmp_path / f"port_{name}", reads, **kw)
        ref = jax_script.write_reads(tmp_path / f"jax_{name}", reads, **kw)
        if name.endswith(".gz"):  # gzip headers hold the time: compare the payload
            import gzip

            assert gzip.open(port).read() == gzip.open(ref).read()
        else:
            assert Path(port).read_bytes() == Path(ref).read_bytes()


@pytest.mark.parametrize("n", [0, 1, 2, 5000])
def test_sorted_unique_is_np_unique(n):
    x = np.random.default_rng(n).integers(0, 1 << 62, n, dtype=np.uint64)
    x = np.concatenate([x, x[: n // 3]])  # repeats
    got = M.sorted_unique(x)
    np.testing.assert_array_equal(got, np.unique(x))
    assert got.dtype == np.uint64


@pytest.mark.parametrize("k", [1, 16, 21, 31])
def test_fixed_read_kmers_are_the_oracles(k):
    reads = M.make_reads(np.random.default_rng(k), 40, with_n=True)
    bases = np.frombuffer("".join(reads).encode(), np.uint8)
    want = oracle.kmer_hashes_ragged(oracle.encode_bytes(bases), np.full(40, M.READ_LEN), k)
    np.testing.assert_array_equal(M.fixed_read_kmers(bases, M.READ_LEN, k), want)


@pytest.fixture(scope="module")
def matrix(tmp_path_factory):
    """Configurations 1-5 (5 is 4 sharded) and their oracle vectors."""
    configs = M.make_configs(tmp_path_factory.mktemp("matrix"))
    configs.append(M.sharded_config(configs[-1]))
    oracle = {}
    for config in configs:
        if config.name != "5":
            oracle[config.name] = config.oracle_counts()
    oracle["5"] = oracle["4"]
    return {config.name: config for config in configs}, oracle


@pytest.mark.parametrize("name", NAMES)
def test_config_on_the_cpu_gives_the_matrix_sum_and_the_oracle(matrix, name):
    configs, oracle = matrix
    config = configs[name]
    got = M.run_config(config, CPU)
    assert int(got.sum()) == M.EXPECTED_SUMS[name]
    np.testing.assert_array_equal(got, oracle[name])
    M.check(name, got, M.EXPECTED_SUMS[name], oracle[name])
    assert config.sharded == (name == "5") and config.revcomp == name.startswith("3")


def test_the_check_raises_on_a_wrong_sum_or_vector(matrix):
    configs, oracle = matrix
    got = M.run_config(configs["1"], CPU)
    M.check("1", got, 15205, oracle["1"])
    with pytest.raises(AssertionError, match="sum 15205, expected 15206"):
        M.check("1", got, 15206, oracle["1"])
    moved = got.copy()
    i, j = int(np.argmax(moved)), int(np.argmin(moved))
    moved[i] -= 1
    moved[j] += 1  # the same sum, another vector
    with pytest.raises(AssertionError, match="differ from the numpy oracle"):
        M.check("1", moved, 15205, oracle["1"])
    with pytest.raises(AssertionError, match="differ from the numpy oracle"):
        M.check("1", got[:-1], int(got[:-1].sum()), oracle["1"])


def test_time_config_raises_when_a_run_differs(matrix, monkeypatch):
    configs, oracle = matrix
    runs = iter([M.run_config(configs["1"], CPU), np.zeros_like(oracle["1"])])
    monkeypatch.setattr(M, "run_config", lambda config, device: next(runs))
    with pytest.raises(AssertionError, match="config 1: node-count sum 0"):
        M.time_config(configs["1"], CPU, oracle["1"])


def test_main_prints_a_line_a_config(matrix, monkeypatch, capsys):
    configs, _ = matrix
    monkeypatch.setattr(M, "make_configs", lambda workdir: [configs["1"]])
    monkeypatch.setitem(M.EXPECTED_SUMS, "5", M.EXPECTED_SUMS["1"])
    rows = M.main(["--device", "cpu"])
    out = capsys.readouterr().out.splitlines()
    assert [row["name"] for row in rows] == ["1", "5"]
    assert out[0].startswith("bench_matrix on cpu")
    assert out[1].startswith("config 1 (toy .fa, one chunk): warm-up ")
    assert out[2].startswith("config 5 (config 4 sharded over (1, 2) grid of the CPU)")
    assert all(row["sum"] == 15205 and row["mk_s"] > 0 for row in rows)


def test_grid_args_on_the_cpu():
    grid, label = M.grid_args(CPU)
    assert grid == dict(devices=[CPU, CPU], index_parallel=2)
    assert label == "(1, 2) grid of the CPU"


def test_main_refuses_cuda_without_a_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="--device cpu"):
        M.main([])
