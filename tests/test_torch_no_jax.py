"""The port and ``chip_smoke.py`` import, and the port maps a file and
answers the library calls, with jax and ``kmer_mapper_tpu`` blocked: the
machine it runs on has PyTorch and no JAX."""
import os
import subprocess
import sys
import textwrap
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

SCRIPT = textwrap.dedent(
    """
    import sys
    for name in ("jax", "jaxlib", "kmer_mapper_tpu"):
        sys.modules[name] = None  # any import of these now raises ImportError
    import importlib, importlib.util, pkgutil, tempfile, os
    import numpy as np
    import kmer_mapper_tpu_torch as pkg

    names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
    for name in names:
        importlib.import_module(name)
    for script in ("r2_kernel_dissect", "r2_window_dissect", "r3_iter_floor",
                   "r9_dot_orient", "r9_step_parts", "r9_block_pipeline",
                   "partition_dissect"):
        assert f"kmer_mapper_tpu_torch.scripts.{script}" in names, names
    for module in ("compat", "mapper", "gpu_counter", "ops.probe", "ops.probe_cases",
                   "index.pickled", "io.native", "io.gzio", "io.parallel_reader",
                   "command_line_interface", "util", "encodings", "tools",
                   "utils.timing", "utils.profiling", "ops.hashing", "ops.hash_keys_cases",
                   "ops.block_partition", "ops.block_partition_cases", "ops.finalize",
                   "ops.finalize_cases", "parallel", "parallel.mesh", "parallel.sharded",
                   "parallel.multihost"):
        assert f"kmer_mapper_tpu_torch.{module}" in names, names
    spec = importlib.util.spec_from_file_location("chip_smoke", "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    assert callable(smoke.phase_tiles) and callable(smoke.phase_library)
    assert callable(smoke.phase_file_feed)
    assert callable(smoke.phase_hash_hazards) and callable(smoke.phase_ragged_steady_state)
    assert callable(smoke.phase_partition_hazards) and callable(smoke.phase_sharded)
    from kmer_mapper_tpu_torch import oracle, pipeline
    from kmer_mapper_tpu_torch.index import kmer_index

    rng = np.random.default_rng(0)
    reads = ["".join(rng.choice(list("ACGT"), 40)) for _ in range(50)]
    d = tempfile.mkdtemp()
    with open(os.path.join(d, "r.fq"), "w") as f:
        f.write("".join(f"@{i}\\n{s}\\n+\\n{'I' * 40}\\n" for i, s in enumerate(reads)))
    codes = oracle.encode_bytes(np.frombuffer("".join(reads).encode(), np.uint8))
    kmers = oracle.kmer_hashes_ragged(codes, np.full(50, 40), 21)
    arrays = oracle.build_kmer_index(kmers[::3], rng.integers(0, 30, len(kmers[::3])), 101)
    kmer_index.save_reference_npz(os.path.join(d, "i.npz"), arrays)
    got = pipeline.map_file(os.path.join(d, "i.npz"), os.path.join(d, "r.fq"),
                            device="cpu", k=21)
    assert (got == oracle.map_kmers_to_index(arrays, kmers)).all() and got.sum() > 0
    # both chunk steps hash through the twins on the CPU, never a kernel
    from kmer_mapper_tpu_torch.ops import hashing
    assert hashing.launch_counts["plane_hash_keys_reference"] > 0
    ragged = [s[: 25 + i % 15] for i, s in enumerate(reads)]
    r_kmers = oracle.kmer_hashes_ragged(
        oracle.encode_bytes(np.frombuffer("".join(ragged).encode(), np.uint8)),
        np.array([len(s) for s in ragged]), 21)
    got_r = pipeline.map_sequences(os.path.join(d, "i.npz"), ragged, k=21, device="cpu")
    assert (got_r == oracle.map_kmers_to_index(arrays, r_kmers)).all() and got_r.sum() > 0
    assert hashing.launch_counts["ragged_hash_keys_reference"] > 0
    assert not hashing.launch_counts["plane_hash_keys"]
    assert not hashing.launch_counts["ragged_hash_keys"]
    # the native loader over two byte regions, and a BGZF file
    from kmer_mapper_tpu_torch.io import gzio, native, parallel_reader
    assert native.available()
    big = os.path.join(d, "r2.fq")  # ~290 KB: two regions of 64 K-base buffers
    with open(big, "w") as f:
        f.write("".join(f"@{i}\\n{s}\\n+\\n{'I' * 40}\\n" for i, s in enumerate(reads * 64)))
    before = native.frame_counts["buffers"]
    got2 = pipeline.map_file(os.path.join(d, "i.npz"), big, device="cpu", k=21,
                             chunk_size=1 << 12, reader_workers=2)
    assert len(parallel_reader.split_regions(
        big, "fastq", 2, min_region=2 * pipeline.CPU_BUF_FLOOR)) == 2
    assert native.frame_counts["buffers"] >= before + 2
    assert (got2 == 64 * got).all()
    payload = open(os.path.join(d, "r.fq"), "rb").read()
    smoke.write_bgzf(os.path.join(d, "r.fq.gz"), payload, block_out=1000)
    assert gzio.is_bgzf(os.path.join(d, "r.fq.gz"))
    got3 = pipeline.map_file(os.path.join(d, "i.npz"), os.path.join(d, "r.fq.gz"),
                             device="cpu", k=21)
    assert (got3 == got).all()
    from kmer_mapper_tpu_torch import gpu_counter, map_kmers_to_graph_index, in_graph_index

    counts = map_kmers_to_graph_index(arrays, arrays.max_node_id(), kmers, device="cpu")
    assert (counts == got).all()
    member = in_graph_index(arrays, kmers, device="cpu")
    assert (member == oracle.in_index(arrays, kmers)).all() and member.any()
    counter = gpu_counter.GpuCounter.from_kmers_and_nodes(arrays.kmers, arrays.nodes, 21,
                                                          device="cpu")
    counter.count(kmers, count_revcomps=True)
    assert counter.get_node_counts().sum() >= got.sum()
    # the sharded file path over a (2, 2) grid of the CPU
    import torch
    got4 = pipeline.map_file_sharded(os.path.join(d, "i.npz"), big, k=21, chunk_size=1 << 12,
                                     devices=[torch.device("cpu")] * 4, index_parallel=2)
    assert (got4 == got2).all()
    blocked = ("jax", "jaxlib", "kmer_mapper_tpu")
    assert not [m for m in sys.modules if m.split(".")[0] in blocked and sys.modules[m]]
    print("OK", len(names))
    """
)


def test_port_imports_and_maps_without_jax():
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run(
        [sys.executable, "-c", SCRIPT], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.strip().startswith("OK")
    assert int(proc.stdout.split()[-1]) >= 21  # every module of the package
