"""The reference against the port's CPU path on tiny cells, the faults and
the control that the comparison must catch, and the index cache."""
from __future__ import annotations

import time

import numpy as np
import pytest

from kmer_mapper_tpu_torch.models.mapper import KmerMapper
from portbench import control, harness
from portbench.tests import tiny

LAYOUTS = [("human_kage", "fixed151"), ("human_kage", "ragged")]


@pytest.mark.parametrize("config,traffic", LAYOUTS)
def test_the_reference_equals_the_port_on_the_cpu(config, traffic, tmp_path, monkeypatch):
    seen = []
    node_counts = KmerMapper.node_counts

    def keep(self, max_frequency=1000):
        out = node_counts(self, max_frequency=max_frequency)
        seen.append(out)
        return out

    monkeypatch.setattr(KmerMapper, "node_counts", keep)
    result = tiny.run(tiny.TinySpec(), tiny.cell(config, traffic), tmp_path)
    assert result["correct"] is True
    assert result["checks"] == {"nodes_off": {"value": 0, "limit": 0},
                                "kmers_off": {"value": 0, "limit": 0}}
    assert result["attempted"] >= 1 and result["failed"] == 0
    assert int(seen[-1].sum(dtype=np.int64)) > 1000  # k-mers hit nodes: not vacuous
    assert set(result["metrics"]) == {"kmers_per_s", "setup_s"}
    assert list(result)[-1] == "checks"


def _no_step(self, packed, lengths, n_bases, n_invalid=0, strided=False):
    """A step that returns the state unchanged."""


def _half_batch(map_chunk):
    def half(self, packed, lengths, n_bases, n_invalid=0, strided=False):
        if strided:
            n = n_bases // self.config.read_len // 2 * self.config.read_len
            return map_chunk(self, packed, lengths, n, n_invalid, strided)
        h = lengths.shape[0] // 2
        return map_chunk(self, packed, lengths[:h], int(lengths[:h].sum()), n_invalid, strided)
    return half


def _altered_answer(node_counts):
    def altered(self, max_frequency=1000):
        out = node_counts(self, max_frequency=max_frequency).copy()
        out[len(out) // 2] += 1
        return out
    return altered


FAULTS = {
    "state_unchanged": lambda: ("map_chunk", _no_step),
    "half_the_batch": lambda: ("map_chunk", _half_batch(KmerMapper.map_chunk)),
    "answer_altered": lambda: ("node_counts", _altered_answer(KmerMapper.node_counts)),
}


@pytest.mark.parametrize("traffic", ["fixed151", "ragged"])
@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_a_broken_timed_path_is_not_correct(fault, traffic, tmp_path, monkeypatch):
    name, broken = FAULTS[fault]()
    monkeypatch.setattr(KmerMapper, name, broken)
    result = tiny.run(tiny.TinySpec(), tiny.cell("human_kage", traffic), tmp_path)
    assert result["correct"] is False
    assert result["failed"] == result["attempted"]
    assert any(c["value"] > c["limit"] for c in result["checks"].values())


@pytest.mark.parametrize("traffic", ["fixed151", "ragged"])
def test_the_control_is_not_correct(traffic, tmp_path):
    # 32-bit keys collide once index k-mers times windows pass 2**32 many
    # times over: 400,000 k-mers and 3 buffers of ~52,000 windows
    spec = tiny.TinySpec(sizes={"genome_length": 10_000_000, "n_kmers": 400_000,
                                "n_nodes": 100_000})
    checks = control.control(spec, tiny.cell("human_kage", traffic), 7, "cpu",
                             chunk_size=tiny.CHUNK, cache=tmp_path)
    assert checks["nodes_off"]["value"] > 0
    assert checks["kmers_off"]["value"] == 0


def test_the_index_cache_is_built_once_and_loaded_after(tmp_path, monkeypatch):
    seen = []
    node_counts = KmerMapper.node_counts

    def keep(self, max_frequency=1000):
        out = node_counts(self, max_frequency=max_frequency)
        seen.append(out)
        return out

    monkeypatch.setattr(KmerMapper, "node_counts", keep)
    spec, the_cell = tiny.TinySpec(), tiny.cell("human_kage", "fixed151")
    config = spec.config("human_kage")
    path = harness.index_file(config, tmp_path)
    assert not path.exists()
    first = tiny.run(spec, the_cell, tmp_path, seed=5, seconds=0.0)
    assert path.exists() and first["correct"]
    built = path.read_bytes()

    def no_build(*args, **kwargs):
        raise AssertionError("the second run built the index again")

    monkeypatch.setattr(harness, "build_index", no_build)
    second = tiny.run(spec, the_cell, tmp_path, seed=5, seconds=0.0)
    assert second["correct"] and path.read_bytes() == built
    # each run: the node counts of the set-up's one buffer, then the window's
    # (none mapped in a window of 0 s)
    assert len(seen) == 4 and np.array_equal(seen[0], seen[2]) and seen[0].sum() > 0
    # another configuration, or another of its seeds, is another file
    other = dict(config, seed=config["seed"] + 1)
    assert harness.index_file(other, tmp_path) != path


def test_the_index_file_follows_the_ports_build(tmp_path, monkeypatch):
    source = tmp_path / "layout.py"
    source.write_text("A = 1\n")
    monkeypatch.setattr(harness, "build_sources", lambda: [source])
    config = tiny.TinySpec().config("human_kage")
    before = harness.index_file(config, tmp_path)
    assert harness.index_file(config, tmp_path) == before
    source.write_text("A = 2\n")
    assert harness.index_file(config, tmp_path) != before


def test_the_index_files_sources_cover_the_ports_index_package():
    names = {(p.parent.name, p.name) for p in harness.build_sources()}
    assert {("index", "kmer_index.py"), ("index", "layout.py"), ("ops", "u32hash.py"),
            ("portbench", "genome.py")} <= names


def test_setup_s_leaves_out_the_index_build(tmp_path, monkeypatch):
    build = harness.build_index

    def slow_build(*args, **kwargs):
        build(*args, **kwargs)
        time.sleep(5)

    monkeypatch.setattr(harness, "build_index", slow_build)
    result = tiny.run(tiny.TinySpec(), tiny.cell("human_kage", "fixed151"), tmp_path,
                      seconds=0.0)
    assert result["correct"] and result["metrics"]["setup_s"]["value"] < 5
