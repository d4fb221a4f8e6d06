"""BENCHMARK.json and the benchmark's files: names, units, the byte
functions' worked bounds, the port's config for each cell, the packer
against the port's, and a configuration, traffic mix, metric and layer
kernel added as files alone."""
from __future__ import annotations

import json
import re
import shutil
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from kmer_mapper_tpu_torch import pipeline
from kmer_mapper_tpu_torch.io import readers
from kmer_mapper_tpu_torch.models.mapper import MapperConfig
from portbench import common, genome, harness
from portbench.spec import CHECKOUT, Spec
from portbench.tests import tiny

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SPEC = Spec()
BENCH = SPEC.bench


def _line(text):
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_benchmark_json_keeps_to_its_shape():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"] and 1 <= BENCH["run_seconds"] <= 51
    assert all(_line(word) for word in BENCH["command"]) and len(BENCH["command"]) <= 32
    assert (CHECKOUT / "BENCHMARK.json").stat().st_size <= 64 << 10
    names = []
    for config in BENCH["configs"]:
        assert set(config) == {"name", "source", "file", "reduced", "why"}
        assert config["file"].startswith("portbench/") and _line(config["source"])
        assert _line(config["why"]) and len(config["reduced"]) <= 16
        names.append(config["name"])
    for cell in BENCH["workloads"]:
        assert set(cell) == {"name", "config", "traffic", "chips", "why"}
        assert cell["config"] in names and cell["chips"] in (1, 4) and _line(cell["why"])
        assert (SPEC.home / "traffic" / f"{cell['traffic']}.json").exists()
        names += [cell["name"], cell["config"], cell["traffic"]]
    for metric in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(metric["unit"]) and metric["better"] in ("lower", "higher")
        names.append(metric["name"])
    assert all(NAME.match(n) for n in names)
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert 0.01 <= e2e["kmers_per_s"]["bound"] <= 0.25 and e2e["setup_s"]["bound"] <= 0.25
    assert all(m["source"] in ("host_clock", "device_trace") for m in e2e.values())
    cells = {c["name"] for c in BENCH["workloads"]}
    for metric in BENCH["per_layer"]:
        assert set(metric) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert metric["moves"] in e2e and _line(metric["layer"])
        assert set(metric.get("workloads", cells)) <= cells


@pytest.mark.parametrize("kind", ["configs", "traffic", "metrics", "kernels"])
def test_every_file_of_the_benchmark_parses(kind):
    root = SPEC.home / kind
    files = sorted(root.rglob("*.json" if kind != "metrics" else "*.py"))
    assert files
    for path in files:
        assert re.match(r"^[A-Za-z0-9_.-]+$", path.name)
        if kind == "metrics":
            assert callable(SPEC.reader(path.stem).read)
        else:
            data = json.loads(path.read_text())
            if kind == "kernels":
                assert data["match"]
            if kind == "configs":
                assert {"name", "source", "k", "genome_length", "n_kmers", "n_nodes",
                        "max_frequency", "seed", "assumed", "reduced"} <= set(data)


def test_each_metric_has_its_reader_and_each_group_its_kernels():
    for metric in BENCH["end_to_end"] + BENCH["per_layer"]:
        reader = SPEC.reader(metric["name"])
        group = getattr(reader, "GROUP", None)
        if group is not None:
            assert SPEC.kernels(group)


def _phase5_shape(strided):
    """Phase 5's chunk (PERF.md §6): 64 Mi bases, 2^20 buckets."""
    if strided:
        return common.BufferShape(strided=True, n_reads=444_429, n_bases=444_429 * 151,
                                  n_words=444_429 * 10, n_windows=53_775_909,
                                  n_keys=53_775_909, n_buckets=1 << 20, distinct_hits=587_500)
    return common.BufferShape(strided=False, n_reads=534_721, n_bases=67_108_760,
                              n_words=(64 << 20) // 16 + 2, n_windows=51_067_130,
                              n_keys=51_067_130, n_buckets=1 << 20, distinct_hits=0)


@pytest.mark.parametrize("metric,strided,mb,ms", [
    ("hash_roofline_pct", True, 448.0, 0.1337),
    ("hash_roofline_pct", False, 427.4, 0.1276),
    ("partition_roofline_pct", True, 860.5, 0.2568),
    ("count_roofline_pct", True, 502.0, 0.1499),
])
def test_byte_functions_give_the_worked_bounds(metric, strided, mb, ms):
    least = SPEC.reader(metric).least_bytes(_phase5_shape(strided))
    assert abs(least / 1e6 - mb) < 0.1
    assert abs(least / common.PEAK_BYTES_S * 1e3 - ms) < 0.0001


def _human_shape(strided, revcomp=False):
    """A buffer of the human-scale index: ``human.fixed151``'s (888,859
    reads of 151 bp), or one of the continuous layout."""
    if strided:
        n_windows = 107_551_939
        shape = dict(strided=True, n_reads=888_859, n_bases=888_859 * 151,
                     n_words=888_859 * 10, n_windows=n_windows, n_buckets=1 << 26,
                     distinct_hits=6_000_000)
    else:
        n_windows = 101_802_906
        shape = dict(strided=False, n_reads=1_067_521, n_bases=(128 << 20) - 5,
                     n_words=(128 << 20) // 16 + 2, n_windows=n_windows, n_buckets=1 << 26,
                     distinct_hits=5_500_000)
    return common.BufferShape(n_keys=n_windows * (2 if revcomp else 1), **shape)


#: the byte functions' values on ``_human_shape``: pinned, so that forward
#: traffic (a key a window) keeps its roofline shares
FORWARD_BYTES = {
    ("hash_roofline_pct", True): 895_969_872,
    ("partition_roofline_pct", True): 1_722_928_180,
    ("count_roofline_pct", True): 5_203_382_808,
    ("hash_roofline_pct", False): 852_247_762.75,
    ("partition_roofline_pct", False): 1_630_943_652,
    ("count_roofline_pct", False): 5_153_390_544,
}


@pytest.mark.parametrize("metric,strided", sorted(FORWARD_BYTES))
def test_the_byte_functions_of_forward_traffic_are_as_before(metric, strided):
    assert SPEC.reader(metric).least_bytes(_human_shape(strided)) == \
        FORWARD_BYTES[metric, strided]


@pytest.mark.parametrize("metric,strided", sorted(FORWARD_BYTES))
def test_the_byte_functions_charge_each_key_of_revcomp(metric, strided):
    # -r doubles the keys: the words and the table are read as before
    per_key = {"hash_roofline_pct": 8, "partition_roofline_pct": 16,
               "count_roofline_pct": 8}[metric]
    n_windows = _human_shape(strided).n_windows
    assert (SPEC.reader(metric).least_bytes(_human_shape(strided, revcomp=True))
            == FORWARD_BYTES[metric, strided] + per_key * n_windows)


def test_both151r_takes_the_ports_revcomp_config(tmp_path):
    config, traffic = SPEC.config("human_kage"), SPEC.traffic("both151r")
    assert traffic["revcomp"] is True
    assert traffic["pool_min_bytes"] == SPEC.traffic("fixed151")["pool_min_bytes"]
    n_buckets = 1 << 26
    made = harness.mapper_config(config, traffic, n_buckets, torch.device("cuda"),
                                 harness.CHUNK_SIZE, tmp_path)
    assert made == MapperConfig(k=31, buf=128 << 20, max_reads=(128 << 20) // 32,
                                revcomp=True, read_len=151)
    # the plane step's keys of a buffer: both hashes of each of its windows,
    # within int32
    keys = (made.buf // 151) * (151 - 30) * 2
    assert keys == 215_103_878 < 2**31


@pytest.mark.parametrize("cell,n_buckets,buf,reads,kmers", [
    ("human.fixed151", 1 << 26, 128 << 20, 888_859, 107_551_939),
])
def test_each_cell_takes_the_ports_config_for_its_table(cell, n_buckets, buf, reads, kmers,
                                                        tmp_path):
    the_cell = SPEC.cell(cell)
    config, traffic = SPEC.config(the_cell["config"]), SPEC.traffic(the_cell["traffic"])
    # the table the port builds for the configuration's k-mers: 8 keys a
    # bucket at most half full, a power of two
    assert n_buckets == 1 << (-(-config["n_kmers"] // 4) - 1).bit_length()
    made = harness.mapper_config(config, traffic, n_buckets, torch.device("cuda"),
                                 harness.CHUNK_SIZE, tmp_path)
    fixed = traffic["read_length_min"] == traffic["read_length_max"]
    assert made == MapperConfig(k=31, buf=pipeline.device_buf(n_buckets),
                                max_reads=max(1024, pipeline.device_buf(n_buckets) // 32),
                                revcomp=False, read_len=151 if fixed else 0)
    assert made.buf == buf
    lengths = [151] * (buf // 151) if fixed else genome.length_multiset(100, 151, buf)
    assert len(lengths) == reads and sum(x - 30 for x in lengths) == kmers
    assert reads <= made.max_reads


@pytest.mark.parametrize("traffic", ["fixed151", "ragged", "both151r", "ragged_both_r"])
def test_the_packed_buffers_equal_the_ports_packer(traffic):
    t = tiny.TinySpec().traffic(traffic)
    fixed = t["read_length_min"] == t["read_length_max"]
    g = genome.Genome(50_000, 3)
    gen = torch.Generator().manual_seed(9)
    buf = genome.make_buffer(g, t, 31, 1 << 14, fixed, gen, pinned=False)
    codes = genome.read_codes(g, buf.starts, buf.lengths, fixed, buf.reverse).reshape(-1)
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)[codes.numpy()]
    starts = np.concatenate([[0], np.cumsum(buf.lengths.numpy())[:-1]])
    chunk = readers.SequenceChunk(bases=bases, read_starts=starts.astype(np.int64))
    (packed, lengths, n_bases, n_reads, _, strided), = readers.pack_for_device(
        iter([chunk]), 1 << 14, 1 << 12, 31, read_len=151)
    assert strided == fixed and n_bases == buf.n_bases and n_reads == len(buf.lengths)
    assert np.array_equal(packed.view(np.int32), buf.words.numpy())
    if not fixed:
        assert np.array_equal(lengths[:n_reads], buf.read_lengths.numpy())
    assert buf.n_windows == int(np.maximum(buf.lengths.numpy() - 30, 0).sum())
    assert (buf.reverse is None) == (not t["revcomp"])


def test_a_config_traffic_metric_and_kernel_are_added_by_files_alone(tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(SPEC.home, root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(CHECKOUT / "BENCHMARK.json", root / "BENCHMARK.json")
    home = root / "portbench"
    config = json.loads((home / "configs" / "human_kage.json").read_text())
    config.update(name="tiny_kage", genome_length=200_000, n_kmers=8_000, n_nodes=2_000)
    (home / "configs" / "tiny_kage.json").write_text(json.dumps(config))
    traffic = json.loads((home / "traffic" / "fixed151.json").read_text())
    traffic.update(read_length_min=60, read_length_max=90, pool_min_bytes=2 * (1 << 14))
    (home / "traffic" / "short_ragged.json").write_text(json.dumps(traffic))
    (home / "kernels" / "twins").mkdir()
    (home / "kernels" / "twins" / "count_twin.json").write_text('{"match": "stream_count"}')
    (home / "metrics" / "twin_calls.py").write_text(textwrap.dedent("""
        GROUP = "twins"


        def read(record):
            return float(record.calls)
    """))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "tiny_kage", "source": "test", "reduced": [], "why": "t",
                             "file": "portbench/configs/tiny_kage.json"})
    bench["workloads"].append({"name": "tiny.short", "config": "tiny_kage",
                               "traffic": "short_ragged", "chips": 1, "why": "t"})
    bench["per_layer"].append({"name": "twin_calls", "unit": "calls", "better": "higher",
                               "source": "host_clock", "layer": "mapper",
                               "moves": "kmers_per_s", "workloads": ["tiny.short"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    script = textwrap.dedent(f"""
        import json, time
        from portbench import harness
        from portbench.spec import Spec
        spec = Spec()
        assert spec.kernels("twins") == ["stream_count"]
        r = harness.run(spec, spec.cell("tiny.short"), 3, 0.2, True, "cpu",
                        t_start=time.perf_counter(), chunk_size={1 << 14},
                        cache=spec.root / "cache")
        print(json.dumps(r))
    """)
    proc = subprocess.run([sys.executable, "-c", script], cwd=root, capture_output=True,
                          text=True, env={"PYTHONPATH": str(CHECKOUT), "PATH": "/usr/bin:/bin"},
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    assert result["correct"] is True
    assert result["metrics"]["twin_calls"]["value"] == result["attempted"] >= 1
