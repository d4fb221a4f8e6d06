"""The reference against the port's CPU path on tiny cells, the faults and
the control that the comparison must catch, the forward pool and its counts
pinned, reads from both strands, and the index cache."""
from __future__ import annotations

import dataclasses
import hashlib
import time

import numpy as np
import pytest
import torch

from kmer_mapper_tpu_torch.models.mapper import KmerMapper
from portbench import control, genome, harness, reference
from portbench.tests import tiny

#: each layout forward, and from both strands mapped with -r
TRAFFIC = ["fixed151", "ragged", "both151r", "ragged_both_r"]
REVCOMP_TRAFFIC = ["both151r", "ragged_both_r"]
LAYOUTS = [("human_kage", traffic) for traffic in TRAFFIC]


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


@pytest.mark.parametrize("traffic", TRAFFIC)
@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_a_broken_timed_path_is_not_correct(fault, traffic, tmp_path, monkeypatch):
    name, broken = FAULTS[fault]()
    monkeypatch.setattr(KmerMapper, name, broken)
    result = tiny.run(tiny.TinySpec(), tiny.cell("human_kage", traffic), tmp_path)
    assert result["correct"] is False
    assert result["failed"] == result["attempted"]
    assert any(c["value"] > c["limit"] for c in result["checks"].values())


@pytest.mark.parametrize("traffic", REVCOMP_TRAFFIC)
def test_a_port_without_revcomp_on_revcomp_traffic_is_not_correct(traffic, tmp_path,
                                                                 monkeypatch):
    mapper_config = harness.mapper_config

    def forward_only(*args, **kwargs):
        return dataclasses.replace(mapper_config(*args, **kwargs), revcomp=False)

    monkeypatch.setattr(harness, "mapper_config", forward_only)
    result = tiny.run(tiny.TinySpec(), tiny.cell("human_kage", traffic), tmp_path)
    assert result["correct"] is False
    # the same windows, each looked up by one hash of the two
    assert result["checks"]["kmers_off"]["value"] == 0
    assert result["checks"]["nodes_off"]["value"] > 0


@pytest.mark.parametrize("traffic", TRAFFIC)
def test_the_control_is_not_correct(traffic, tmp_path):
    # 32-bit keys collide once index k-mers times windows pass 2**32 many
    # times over: 400,000 k-mers and 3 buffers of ~52,000 windows
    spec = tiny.TinySpec(sizes={"genome_length": 10_000_000, "n_kmers": 400_000,
                                "n_nodes": 100_000})
    checks = control.control(spec, tiny.cell("human_kage", traffic), 7, "cpu",
                             chunk_size=tiny.CHUNK, cache=tmp_path)
    assert checks["nodes_off"]["value"] > 0
    assert checks["kmers_off"]["value"] == 0


#: a digest of a tiny pool's words, starts and lengths (3 buffers at seed
#: 2**31 + 11) and of the reference's node counts of them; the distinct
#: index k-mers each buffer hit, the windows and the node hits: pinned, so
#: that forward traffic keeps its data and its reference whatever strands
#: and -r add
FORWARD_POOLS = {
    "fixed151": ("e1db10215c942be141043577b68a98781e75bceec3e74fe4962083714b8a8288",
                 [1945, 1912, 1953], 157_542, 6_255),
    "ragged": ("81dc35c77c1d0d5d141f9f84e6b2f0b4b5c2dc533e0d14d00e68342d6c1f4d21",
               [1833, 1798, 1840], 149_403, 5_893),
}


def _tiny_pool(traffic_name: str, seed: int, buffers: int = 3):
    spec = tiny.TinySpec()
    config, traffic = spec.config("human_kage"), spec.traffic(traffic_name)
    fixed = traffic["read_length_min"] == traffic["read_length_max"]
    g = genome.Genome(config["genome_length"], config["seed"])
    gen = torch.Generator().manual_seed(seed)
    pool = [genome.make_buffer(g, traffic, config["k"], tiny.CHUNK, fixed, gen, pinned=False)
            for _ in range(buffers)]
    return config, traffic, g, pool


@pytest.mark.parametrize("traffic", sorted(FORWARD_POOLS))
def test_a_forward_pool_and_its_counts_are_as_before(traffic):
    config, _, g, pool = _tiny_pool(traffic, 2**31 + 11)
    ref = reference.NodeCountReference(genome.index_entries(config, "cpu"),
                                       config["max_frequency"])
    distinct = [ref.add(reference.buffer_hashes(g, buf, config["k"], "cpu")) for buf in pool]
    digest = hashlib.sha256()
    for buf in pool:
        assert buf.reverse is None
        for t in (buf.words, buf.starts, buf.lengths):
            digest.update(t.numpy().tobytes())
    nodes = ref.node_counts()
    digest.update(nodes.numpy().tobytes())
    assert (digest.hexdigest(), distinct, ref.windows, int(nodes.sum())) == \
        FORWARD_POOLS[traffic]


@pytest.mark.parametrize("traffic", REVCOMP_TRAFFIC)
def test_a_pool_from_both_strands_is_half_reverse_complements(traffic):
    config, _, g, pool = _tiny_pool(traffic, 2**33 + 7)
    k = config["k"]
    reverse = torch.cat([buf.reverse for buf in pool])
    assert abs(reverse.float().mean().item() - 0.5) <= 0.01
    for buf in pool:
        codes = genome.read_codes(g, buf.starts, buf.lengths, buf.strided, buf.reverse)
        forward = genome.read_codes(g, buf.starts, buf.lengths, buf.strided)
        at, read_of = 0, []
        for i, (start, length) in enumerate(zip(buf.starts.tolist(), buf.lengths.tolist())):
            window = g.codes(start + torch.arange(length))
            want = 3 - window.flip(0) if buf.reverse[i] else window
            got = codes[i] if buf.strided else codes[at:at + length]
            assert torch.equal(got, want)
            at += length
            read_of += [i] * max(length - k + 1, 0)
        assert not torch.equal(codes, forward)
        # the reference's two hashes of a reverse-strand read's windows are
        # those of the forward read's windows, the other way round
        got = reference.buffer_hashes(g, buf, k, "cpu", revcomp=True)
        fwd = reference.buffer_hashes(g, dataclasses.replace(buf, reverse=None), k, "cpu",
                                      revcomp=True)
        assert got.shape == fwd.shape == (2, buf.n_windows)
        flipped = torch.tensor(buf.reverse.numpy()[read_of])
        assert torch.equal(got[:, ~flipped], fwd[:, ~flipped])
        for a, b in ((0, 1), (1, 0)):
            assert torch.equal(got[a, flipped].sort().values, fwd[b, flipped].sort().values)


def test_reverse_strand_reads_hit_only_through_their_revcomp_hashes():
    config, _, g, pool = _tiny_pool("both151r", 2**32 + 3, buffers=2)
    kmers = genome.index_entries(config, "cpu").kmers
    for buf in pool:
        codes = genome.read_codes(g, buf.starts, buf.lengths, True, buf.reverse)
        hits_fwd = torch.isin(genome.window_hashes(codes, config["k"]), kmers).sum(1)
        hits_rc = torch.isin(reference.revcomp_hashes(codes, config["k"]), kmers).sum(1)
        rev = buf.reverse
        assert int(hits_fwd[rev].sum()) == 0 and int(hits_rc[rev].sum()) > 100
        assert int(hits_rc[~rev].sum()) == 0 and int(hits_fwd[~rev].sum()) > 100
        # a read hits as often on either strand: the same windows
        forward = genome.read_codes(g, buf.starts, buf.lengths, True)
        hits = torch.isin(genome.window_hashes(forward, config["k"]), kmers).sum(1)
        assert torch.equal(torch.where(rev, hits_rc, hits_fwd), hits)


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
