"""The port's multi-host helpers (``kmer_mapper_tpu_torch/parallel/multihost.py``)
and a two-process ``torch.distributed`` run (gloo, localhost) whose
all-reduced node counts equal the whole file's; mirrors
``tests/test_multihost.py``."""
from __future__ import annotations

import os
import socket
import subprocess
import sys
import textwrap

import numpy as np
import pytest

from kmer_mapper_tpu.parallel import multihost as jax_multihost
from kmer_mapper_tpu_torch.parallel import multihost


def test_host_shard_round_robin_disjoint_and_complete():
    paths = [f"f{i}" for i in range(10)]
    shards = [multihost.host_shard(paths, process_index=i, process_count=3) for i in range(3)]
    assert sorted(p for s in shards for p in s) == sorted(paths)
    assert all(not set(shards[i]) & set(shards[j]) for i in range(3) for j in range(i + 1, 3))
    assert shards[0] == ["f0", "f3", "f6", "f9"]
    assert shards == [jax_multihost.host_shard(paths, process_index=i, process_count=3)
                      for i in range(3)]


def test_host_shard_outside_a_process_group_is_everything():
    assert multihost.process_index_and_count() == (0, 1)
    assert multihost.host_shard(["a", "b"]) == ["a", "b"]
    shards = [multihost.host_shard(["a"], process_index=i, process_count=4) for i in range(4)]
    assert shards[0] == ["a"] and all(s == [] for s in shards[1:])


@pytest.mark.parametrize("vectors", [
    [np.array([1, 2, 3], np.uint32), np.array([10, 20], np.uint32)],
    [np.full(2, 0xFFFFFFFF, np.uint32), np.full(2, 0xFFFFFFFF, np.uint32)],
    [np.array([5, 0, 7], np.uint32)],
])
def test_merge_node_counts_matches_jax(vectors):
    """Ragged lengths add; sums past uint32 clamp to its top."""
    got = multihost.merge_node_counts(vectors)
    assert got.dtype == np.uint32
    np.testing.assert_array_equal(got, jax_multihost.merge_node_counts(vectors))


_WORKER = textwrap.dedent(
    """
    import sys
    import tempfile

    import numpy as np
    import torch

    rank, world, port = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
    from kmer_mapper_tpu_torch import oracle, pipeline
    from kmer_mapper_tpu_torch.index import kmer_index as ki
    from kmer_mapper_tpu_torch.parallel import multihost

    multihost.initialize(f"localhost:{port}", world, rank, backend="gloo")
    multihost.initialize(f"localhost:{port}", world, rank, backend="gloo")  # a no-op
    assert multihost.process_index_and_count() == (rank, world)
    print("SHARD", rank, ",".join(multihost.host_shard([f"f{i}" for i in range(5)])), flush=True)

    rng = np.random.default_rng(7)  # the same data in every process
    reads = ["".join(rng.choice(list("ACGT"), 60)) for _ in range(40)]
    codes = [oracle.encode_string(r) for r in reads]
    kmers = oracle.kmer_hashes_ragged(np.concatenate(codes), np.array([60] * 40), 9)
    entries = np.unique(rng.choice(kmers, 200))
    index = ki.KmerIndex.from_entries(entries, rng.integers(0, 30, len(entries)))

    def write_fa(rs):
        with tempfile.NamedTemporaryFile("w", suffix=".fa", delete=False) as f:
            f.write("".join(f">r{j}\\n{s}\\n" for j, s in enumerate(rs)))
            return f.name

    cpu = torch.device("cpu")
    # each process maps its shard of the reads; node_counts all-reduces
    merged = pipeline.map_file_sharded(index, write_fa(multihost.host_shard(reads)), k=9,
                                       devices=[cpu] * 2, index_parallel=2)
    torch.distributed.destroy_process_group()
    whole = pipeline.map_file(index, write_fa(reads), k=9, device=cpu)
    np.testing.assert_array_equal(merged, whole)
    print("MERGED_OK", rank, int(merged.sum()), flush=True)
    """
)


def test_two_process_gloo_run(tmp_path):
    """Two processes on localhost join one gloo group, map disjoint shards
    of the reads over a (1, 2) grid each, and the all-reduced node counts
    equal the single-process run's on the whole file."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    script = tmp_path / "worker.py"
    script.write_text(_WORKER)
    env = dict(os.environ, PYTHONPATH=os.getcwd())
    procs = [subprocess.Popen([sys.executable, str(script), str(i), "2", str(port)],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, env=env, text=True)
             for i in range(2)]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=90)
            outs.append((p.returncode, out, err))
    finally:
        for p in procs:
            p.kill()
    assert all(rc == 0 for rc, _, _ in outs), "\n".join(err[-2000:] for _, _, err in outs)
    shards, merged = {}, {}
    for _, out, _ in outs:
        for line in out.splitlines():
            if line.startswith("SHARD"):
                _, rank, files = (line.split(" ", 2) + [""])[:3]
                shards[int(rank)] = set(files.split(",")) - {""}
            elif line.startswith("MERGED_OK"):
                _, rank, total = line.split(" ", 2)
                merged[int(rank)] = int(total)
    assert shards[0] | shards[1] == {f"f{i}" for i in range(5)} and not shards[0] & shards[1]
    assert set(merged) == {0, 1} and merged[0] == merged[1] > 0
