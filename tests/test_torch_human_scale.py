"""The human-scale policy and path of the port on the CPU: the buffer that
``pipeline.device_buf`` picks at the ``HUMAN_SCALE_BUCKETS`` gate (JAX's
``_buf_floor`` gate), the same node counts from ``map_file`` and
``map_file_sharded`` at both ends of it on fixed and ragged reads (== the
numpy oracle), the parts of ``chip_smoke.py``'s phase 12
(``scripts/human_scale.py``) end to end at a tiny key count with each of
their checks raising on wrong results, ``scale_drill``'s default buffer,
and the multi-process run of ``multihost_run`` over gloo."""
import logging

import numpy as np
import pytest
import torch

from kmer_mapper_tpu import oracle as ref_oracle
from kmer_mapper_tpu.ops import stream_probe as ref_stream_probe
from kmer_mapper_tpu_torch import compat, pipeline
from kmer_mapper_tpu_torch.index import layout
from kmer_mapper_tpu_torch.index.kmer_index import KmerIndex
from kmer_mapper_tpu_torch.ops import stream_probe
from kmer_mapper_tpu_torch.scripts import human_scale, multihost_run, scale_drill, scale_run

CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The twins on one thread: the suite runs files on several workers at
    once, and torch's thread pools in each would contend for the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_the_gate_is_jaxs():
    assert stream_probe.HUMAN_SCALE_BUCKETS == ref_stream_probe.HUMAN_SCALE_BUCKETS == 1 << 25
    assert pipeline.HUMAN_SCALE_BUF == 128 << 20 and pipeline.CUDA_BUF == 64 << 20


@pytest.mark.parametrize("n_buckets, n_shards, want", [
    ((1 << 25) - 1, 1, 64 << 20),
    (1 << 25, 1, 128 << 20),
    (1 << 26, 2, 128 << 20),
    (1 << 26, 4, 64 << 20),
    (1 << 20, 1, 64 << 20),  # the bench index
    (1 << 29, 8, 128 << 20),
    (64, 4, 64 << 20),  # shards under a chain block count as one block
])
def test_device_buf_at_the_gate(n_buckets, n_shards, want):
    assert pipeline.device_buf(n_buckets, n_shards) == want
    assert pipeline.buffer_bases(torch.device("cuda"), 2_500_000, n_buckets, n_shards) == want


@pytest.mark.parametrize("chunk_size", [1 << 10, 2_500_000, 1 << 30])
def test_the_cpu_buffer_ignores_the_table(chunk_size):
    want = pipeline._round_up(min(max(chunk_size, pipeline.CPU_BUF_FLOOR), pipeline.CUDA_BUF),
                              1 << 13)
    for n_buckets in (1 << 10, 1 << 25, 1 << 29):
        assert pipeline.buffer_bases(CPU, chunk_size, n_buckets) == want


def _fastq(path, rng, n_reads, read_len=61, ragged=False):
    """Reads of ``read_len`` bp, or with ``ragged`` of 40..read_len bp."""
    lengths = rng.integers(40, read_len + 1, n_reads) if ragged else [read_len] * n_reads
    reads = ["".join(rng.choice(list("ACGT"), n)) for n in lengths]
    path.write_text("".join(f"@r{i}\n{s}\n+\n{'I' * len(s)}\n" for i, s in enumerate(reads)))
    return reads


def _index(rng, reads, k=31):
    codes = [ref_oracle.encode_string(r) for r in reads]
    kmers = ref_oracle.kmer_hashes_ragged(np.concatenate(codes),
                                          np.array([len(c) for c in codes]), k)
    entries = np.concatenate([kmers[:: max(1, len(kmers) // 4000)],
                              rng.integers(0, 1 << 62, 4000, dtype=np.uint64)])
    nodes = rng.integers(0, 300, len(entries)).astype(np.int32)
    arrays = ref_oracle.build_kmer_index(entries, nodes, 16411)
    return arrays, ref_oracle.map_kmers_to_index(arrays, kmers)


@pytest.mark.parametrize("n_buckets", [(1 << 25) - 1, 1 << 25])
def test_config_on_cuda_follows_the_table(tmp_path, n_buckets):
    """The CUDA branch of ``config_and_chunks`` (no card needed: it only
    frames and packs on the host)."""
    path = tmp_path / "reads.fq"
    _fastq(path, np.random.default_rng(1), 50)
    config, chunks = pipeline.config_and_chunks(str(path), 31, 1 << 16, False,
                                                torch.device("cuda"), n_buckets=n_buckets)
    assert config.buf == pipeline.device_buf(n_buckets)
    assert config.max_reads == config.buf // 32 and config.read_len == 61
    assert sum(c[3] for c in chunks) == 50
    config, _ = pipeline.config_and_chunks(str(path), 31, 1 << 16, False,
                                           torch.device("cuda"), n_buckets=n_buckets,
                                           n_shards=2)
    assert config.buf == pipeline.CUDA_BUF


class _Figures(logging.Handler):
    def __init__(self):
        super().__init__(logging.INFO)
        self.bufs = []

    def emit(self, record):
        if hasattr(record, "figures"):
            self.bufs.append(record.figures["buf"])


@pytest.fixture
def small_gate(monkeypatch):
    """The CUDA rule on the CPU at a small size: buffers of 64 Ki bases, and
    of 128 Ki past the gate."""
    monkeypatch.setattr(pipeline, "CUDA_BUF", 1 << 16)
    monkeypatch.setattr(pipeline, "HUMAN_SCALE_BUF", 1 << 17)
    monkeypatch.setattr(pipeline, "buffer_bases",
                        lambda device, chunk_size, n_buckets, n_shards=1:
                        pipeline.device_buf(n_buckets, n_shards))
    catch = _Figures()
    log = logging.getLogger(pipeline.__name__)
    log.addHandler(catch)
    level = log.level
    log.setLevel(logging.INFO)
    yield catch
    log.removeHandler(catch)
    log.setLevel(level)


@pytest.mark.parametrize("ragged", [False, True])
@pytest.mark.parametrize("past_gate", [False, True])
def test_both_ends_of_the_gate_count_the_same(tmp_path, monkeypatch, small_gate, past_gate,
                                              ragged):
    """map_file and map_file_sharded (2 index shards) with the gate below
    and at the table's (and the shard's) bucket count, on reads of one
    length (the plane step) or of 40..61 bp (the ragged step): the buffers
    the policy names, and the same node counts as the oracle's."""
    rng = np.random.default_rng(5)
    path = tmp_path / "reads.fq"
    # 183,000 bases of fixed reads: 3 buffers of 64 Ki, 2 of 128 Ki; ragged
    # ones about 151,500: 3 and 2
    reads = _fastq(path, rng, 3000, ragged=ragged)
    arrays, want = _index(rng, reads)
    index = KmerIndex.from_arrays(arrays)
    n_buckets = index.table.n_buckets
    gate = n_buckets if past_gate else n_buckets + 1
    monkeypatch.setattr(stream_probe, "HUMAN_SCALE_BUCKETS", gate)
    got = pipeline.map_file(index, str(path), device=CPU, k=31)
    np.testing.assert_array_equal(got, want)
    assert small_gate.bufs[-1] == (1 << 17 if past_gate else 1 << 16)

    monkeypatch.setattr(stream_probe, "HUMAN_SCALE_BUCKETS",
                        n_buckets // 2 + (0 if past_gate else 1))
    got = pipeline.map_file_sharded(index, str(path), k=31, devices=[CPU] * 2,
                                    index_parallel=2)
    np.testing.assert_array_equal(got, want)
    assert small_gate.bufs[-1] == (1 << 17 if past_gate else 1 << 16)


def test_host_slots_equal_the_table_probe():
    rng = np.random.default_rng(9)
    keys = np.unique(rng.integers(0, 1 << 62, 20_000, dtype=np.uint64))
    index = KmerIndex.from_entries(keys, rng.integers(0, 100, len(keys)).astype(np.int32))
    entry = scale_drill.entry_kmers(index)
    q, slots = human_scale.library_hashes(rng, index, entry, 5000)
    np.testing.assert_array_equal(slots, layout.query_table(index.table, q))
    assert (slots >= 0).sum() == 2500
    q[:3] = [keys[0], keys[-1], np.uint64(0)]
    np.testing.assert_array_equal(human_scale.host_slots(index, entry, q),
                                  layout.query_table(index.table, q))


SMALL = dict(n_keys=1_000_000, draw=1 << 18, n_draws=5)


@pytest.fixture(scope="module")
def built(tmp_path_factory):
    workdir = tmp_path_factory.mktemp("human")
    return human_scale.build(SMALL["n_keys"], SMALL["draw"], SMALL["n_draws"], str(workdir)), \
        workdir


def test_build_is_the_drills_index(built, monkeypatch, tmp_path):
    """The index the drill builds from the same draws (STEPS 4, as drawn
    before the keys), saved and loaded again."""
    b, _ = built
    monkeypatch.setenv("STEPS", "4")
    monkeypatch.setenv("BUF_MI", "1")
    monkeypatch.setenv("SKIP_DEVICE", "1")
    monkeypatch.delenv("REUSE_INDEX", raising=False)
    monkeypatch.setattr(scale_drill.tempfile, "tempdir", str(tmp_path))
    drill_keys = human_scale.build(SMALL["n_keys"], 1 << 20, 4, str(tmp_path))["index"].n_unique
    assert scale_drill.main(["1"])["n_keys"] == drill_keys
    index = b["index"]
    assert index.n_unique == len(b["entry"]) and index.table.n_buckets == 1 << 18
    assert len(b["chunks"]) == SMALL["n_draws"]
    assert all(len(c.bases) == SMALL["draw"] // 151 * 151 for c in b["chunks"])
    np.testing.assert_array_equal(scale_drill.entry_kmers(index), b["entry"])


def test_the_parts_end_to_end_on_the_cpu(built):
    b, workdir = built
    file = human_scale.file_part(b, str(workdir), CPU)
    n_reads = sum(c.n_reads for c in b["chunks"])
    assert file["figures"]["kmers"] == n_reads * 121
    assert file["figures"]["buf"] == pipeline.buffer_bases(CPU, 2_500_000, 1 << 18)
    assert file["launches"]["stream_count_reference"] == file["figures"]["chunks"] >= 1
    assert file["counts"].sum() > 0 and file["prefix_kmers"] > 0
    ragged = human_scale.ragged_part(b, str(workdir), CPU)
    lengths = ragged["reads"].read_lengths
    assert n_reads * 151 - human_scale.RAGGED_MAX < ragged["reads"].n_bases <= n_reads * 151
    assert len(set(lengths)) > 1
    assert lengths.min() >= human_scale.RAGGED_MIN and lengths.max() <= human_scale.RAGGED_MAX
    assert ragged["launches"]["ragged_hash_keys_reference"] == 1
    assert ragged["reference_launches"]["ragged_hash_keys_reference"] >= 5
    assert ragged["counts"].sum() > 0
    lib = human_scale.library_part(b["index"], b["entry"], 1 << 12, CPU)
    assert lib["launches"]["probe_count_reference"] >= 1 and lib["mapper"] is not None
    del lib["mapper"]
    human_scale.release_library(b["index"], CPU)
    assert "_compat_mappers" not in b["index"].__dict__
    run = human_scale.sharded_part(b["path"], file["reads_path"], file["counts"],
                                   b["index"].table.n_buckets, [CPU] * 2)
    assert run["grid"] == (1, 2) and run["launches"]["stream_count_reference"] >= 2


def _add_one(fn):
    return lambda *a, **kw: fn(*a, **kw) + np.uint32(1)


@pytest.mark.parametrize("target, attr, match", [
    (human_scale, "map_chunk_counts", "the CLI's node counts differ from map_chunk's"),
    (scale_run.pipeline, "map_file", "first chunk's node counts differ"),
])
def test_file_part_raises_on_wrong_counts(built, monkeypatch, target, attr, match):
    b, workdir = built
    monkeypatch.setattr(target, attr, _add_one(getattr(target, attr)))
    with pytest.raises(AssertionError, match=match):
        human_scale.file_part(b, str(workdir), CPU)


@pytest.mark.parametrize("wrong, match", [
    (lambda fn: _add_one(fn), "map_file's node counts differ from map_chunk's"),
    (lambda fn: lambda *a, **kw: fn(*a, **dict(kw, chunk_size=1 << 16)), "the policy gives"),
])
def test_ragged_part_raises(built, monkeypatch, wrong, match):
    b, workdir = built
    monkeypatch.setattr(pipeline, "map_file", wrong(pipeline.map_file))
    with pytest.raises(AssertionError, match=match):
        human_scale.ragged_part(b, str(workdir), CPU)


def test_file_part_raises_on_another_buffer(built, monkeypatch):
    b, workdir = built
    monkeypatch.setattr(human_scale.pipeline, "buffer_bases", lambda *a: 1 << 16)
    with pytest.raises(AssertionError, match="the policy gives 65536"):
        human_scale.file_part(b, str(workdir), CPU)


@pytest.mark.parametrize("attr, wrong, match", [
    ("map_kmers_to_graph_index", lambda fn: _add_one(fn), "map_kmers_to_graph_index != "),
    ("in_graph_index", lambda fn: lambda *a, **kw: 1 - fn(*a, **kw), "in_graph_index != "),
])
def test_library_part_raises_on_wrong_results(built, monkeypatch, attr, wrong, match):
    b, _ = built
    monkeypatch.setattr(compat, attr, wrong(getattr(compat, attr)))
    try:
        with pytest.raises(AssertionError, match=match):
            human_scale.library_part(b["index"], b["entry"], 1 << 10, CPU)
    finally:
        human_scale.release_library(b["index"], CPU)


@pytest.mark.parametrize("wrong, match", [
    (_add_one, "!= the CLI's node counts"),
    # buffers of 64 Ki bases where the policy gives 2,506,752
    (lambda fn: lambda *a, **kw: fn(*a, **kw, chunk_size=1 << 16), "the policy gives"),
])
def test_sharded_part_raises(built, monkeypatch, wrong, match):
    b, workdir = built
    want = human_scale.map_chunk_counts(b["index"], b["chunks"], b["draw"], CPU)
    reads = workdir / "sharded.fq"
    human_scale.write_fastq(str(reads), b["chunks"])
    monkeypatch.setattr(pipeline, "map_file_sharded", wrong(pipeline.map_file_sharded))
    with pytest.raises(AssertionError, match=match):
        human_scale.sharded_part(b["path"], str(reads), want, b["index"].table.n_buckets,
                                 [CPU] * 2)


def test_scale_drill_default_buffer_follows_the_policy(monkeypatch, tmp_path):
    """Without BUF_MI the drill maps in ``device_buf``'s buffer for its
    table: its draws of ``CUDA_BUF`` bases joined two to a buffer."""
    monkeypatch.setenv("STEPS", "2")
    monkeypatch.delenv("BUF_MI", raising=False)
    monkeypatch.delenv("SKIP_DEVICE", raising=False)
    monkeypatch.delenv("REUSE_INDEX", raising=False)
    monkeypatch.setattr(scale_drill.tempfile, "tempdir", str(tmp_path))
    monkeypatch.setattr(scale_drill.pipeline, "CUDA_BUF", 1 << 20)
    asked, mapped = [], []

    def device_buf(n_buckets, n_shards=1):
        asked.append(n_buckets)
        return 1 << 21

    def device_phases(index, entry, chunks, buf, device):
        mapped.append((buf, [c.n_bases for c in chunks]))
        return phases(index, entry, chunks, buf, device)

    phases = scale_drill.device_phases
    monkeypatch.setattr(scale_drill.pipeline, "device_buf", device_buf)
    monkeypatch.setattr(scale_drill, "device_phases", device_phases)
    result = scale_drill.main(["1", "--device", "cpu"])
    assert asked == [1 << 18] and result["buf_mi"] == 2 and result["best_mk_s"] > 0
    assert mapped == [(1 << 21, [2 * ((1 << 20) // 151 * 151)])]


def test_merge_chunks_keeps_the_reads():
    rng = np.random.default_rng(4)
    chunks = [scale_drill.make_read_chunk(rng, n) for n in (1000, 1500, 900, 3000)]
    merged = scale_drill.merge_chunks(chunks, 2500)
    assert [c.n_bases for c in merged] == [906 + 1359, 755, 2869]
    np.testing.assert_array_equal(np.concatenate([c.bases for c in merged]),
                                  np.concatenate([c.bases for c in chunks]))
    lengths = np.concatenate([c.read_lengths for c in merged])
    assert len(lengths) == sum(c.n_reads for c in chunks) and set(lengths) == {151}


def _tiny_job(tmp_path):
    rng = np.random.default_rng(7)
    reads = ["".join(rng.choice(list("ACGT"), 60)) for _ in range(80)]
    codes = [ref_oracle.encode_string(r) for r in reads]
    kmers = ref_oracle.kmer_hashes_ragged(np.concatenate(codes), np.array([60] * 80), 31)
    entries = np.unique(rng.choice(kmers, 300))
    index = KmerIndex.from_entries(entries, rng.integers(0, 30, len(entries)).astype(np.int32))
    index_path = str(tmp_path / "index.tpuidx.npz")
    index.to_file(index_path)
    paths = []
    for j in range(4):
        p = tmp_path / f"reads{j}.fa"
        p.write_text("".join(f">r{i}\n{s}\n" for i, s in enumerate(reads[j * 20 : j * 20 + 20])))
        paths.append(str(p))
    arrays = ref_oracle.build_kmer_index(entries, index.entry_node, 1009)
    return index_path, paths, ref_oracle.map_kmers_to_index(arrays, kmers)


def test_multihost_run_over_gloo(tmp_path):
    """Two processes of one gloo group, two files each, over (1, 2) grids:
    every rank's all-reduced vector == the oracle's of all the reads."""
    index_path, paths, want = _tiny_job(tmp_path)
    result = multihost_run.run(index_path, paths, want, processes=2, index_parallel=2,
                               device="cpu")
    assert len(result["workers"]) == 2
    assert all("backend=gloo" in line and "files=2" in line for line in result["workers"])


def test_multihost_run_raises(tmp_path):
    index_path, paths, want = _tiny_job(tmp_path)
    with pytest.raises(ValueError, match="3 files for 2 processes"):
        multihost_run.run(index_path, paths[:3], want, processes=2, device="cpu")
    with pytest.raises(AssertionError, match="differ from the single-process vector"):
        multihost_run.run(index_path, paths, want + np.uint32(1), processes=2, device="cpu")
