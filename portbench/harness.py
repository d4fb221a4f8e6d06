"""One run of a cell: the set-up, the timed window, the reference's check
and the metrics (``run.py`` is the command line around :func:`run`).

Set-up, as a user maps many samples against one converted index:
  1. the configuration's index: built by the port (``KmerIndex.from_entries``)
     from the entries of ``genome.index_entries`` and written with
     ``KmerIndex.to_file``, as ``cli convert-index`` writes it, into the
     checkout's ``.portbench_cache/index/`` by the first run of the
     configuration there; every run loads it with ``load_index``. The
     build is a user's one conversion of the index, not a part of mapping
     a sample: its seconds are printed apart and left out of ``setup_s``;
  2. the ``MapperConfig`` that the port's ``pipeline.config_and_chunks``
     makes for a FASTQ of the traffic's reads on that table (the buffer
     policy, ``max_reads``, the read length that picks the step);
  3. the pool: distinct buffers of reads drawn from ``--seed`` (from both
     strands for traffic mapped with ``-r``), in page-locked host memory, at
     least the traffic's ``pool_min_bytes`` of buffer bases (past the L2);
  4. ``KmerMapper(index, config, device)``, one buffer mapped, the first
     ``node_counts`` (the entries' upload and sort), two buffers mapped
     back to back (the allocator's warm-up), ``reset_counts``.
Window: ``map_chunk`` on the pool's buffers in turn for ``seconds``, ended
by a synchronize. Then ``n_kmers_mapped`` and ``node_counts`` are read, the
peak device memory, the program is freed, and the reference
(``reference.py``) counts the same buffers as many times each.
"""
from __future__ import annotations

import dataclasses
import gc
import hashlib
import json
import math
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from kmer_mapper_tpu_torch import oracle, pipeline
from kmer_mapper_tpu_torch.index import kmer_index
from kmer_mapper_tpu_torch.index.kmer_index import KmerIndex, load_index
from kmer_mapper_tpu_torch.models.mapper import KmerMapper, MapperConfig
from kmer_mapper_tpu_torch.ops import (block_partition, finalize, hashing, probe, stream_probe,
                                       u32hash)

from . import common, genome, reference
from .spec import CHECKOUT, Spec

#: the CLI's ``-c``; on CUDA the buffer does not follow it
CHUNK_SIZE = 2_500_000
#: reads of the sample FASTQ that the port picks its config for
SAMPLE_READS = 64
#: the checkout's cache of converted indexes
CACHE = CHECKOUT / ".portbench_cache"
LAUNCH_COUNTS = (hashing.launch_counts, block_partition.launch_counts,
                 stream_probe.launch_counts, probe.launch_counts, finalize.launch_counts)


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


@dataclasses.dataclass
class Record:
    """What a metric's reader reads of a run."""

    spec: Spec
    kmers: int  # k-mers mapped in the window
    window_s: float
    setup_s: float
    calls: int  # map_chunk calls in the window
    shapes: list  # common.BufferShape of each buffer of the pool
    mapped: list  # times each buffer was mapped in the window
    trace: common.Trace | None

    def device_seconds(self, group: str) -> float | None:
        """Device seconds of the operations of a kernel group in the traced
        window; None without a trace or where none ran."""
        if self.trace is None:
            return None
        return self.trace.device_seconds(self.spec.kernels(group)) or None

    def us_per_mkmer(self, group: str) -> float | None:
        seconds = self.device_seconds(group)
        return None if seconds is None else seconds * 1e6 / (self.kmers / 1e6)

    def least_bytes(self, per_buffer) -> float:
        """``per_buffer(shape)`` summed over the buffers the window mapped."""
        return float(sum(m * per_buffer(s) for s, m in zip(self.shapes, self.mapped)))

    def roofline_pct(self, group: str, per_buffer) -> float | None:
        return common.roofline_pct(self.least_bytes(per_buffer), self.device_seconds(group))


def build_sources() -> list[Path]:
    """The files whose code makes a converted index: the generator of the
    entries and the port's index package, which builds the table and
    writes the file, with the modules it imports from the rest of the port."""
    port = Path(kmer_index.__file__).parent
    return ([Path(genome.__file__)] + sorted(port.glob("*.py"))
            + [Path(u32hash.__file__), Path(oracle.__file__)])


def index_file(config: dict, cache: Path) -> Path:
    """The converted index of a configuration: named by the configuration,
    its seed and a digest of its file and of ``build_sources``, so that a
    change to the build or to the file's format builds anew."""
    digest = hashlib.sha256(json.dumps(config, sort_keys=True).encode())
    for path in build_sources():
        digest.update(path.read_bytes())
    return (cache / "index"
            / f"{config['name']}-{config['seed']}-{digest.hexdigest()[:16]}.tpuidx.npz")


def build_index(config: dict, path: Path, device) -> None:
    """The port builds the configuration's index from its entries and writes
    it as ``cli convert-index`` does."""
    entries = genome.index_entries(config, device)
    kmers = entries.kmers.cpu().numpy().view(np.uint64)
    nodes = entries.nodes.to(torch.int32).cpu().numpy()
    frequencies = entries.frequencies.cpu().numpy().astype(np.uint16)
    del entries
    index = KmerIndex.from_entries(kmers, nodes, frequencies)
    path.parent.mkdir(parents=True, exist_ok=True)
    partial = path.with_name(path.name.replace(".tpuidx.npz", ".partial.npz"))
    index.to_file(partial)
    os.replace(partial, path)


def sample_fastq(config: dict, traffic: dict, path: Path) -> None:
    """A FASTQ of SAMPLE_READS reads of the traffic's lengths."""
    g = genome.Genome(config["genome_length"], config["seed"])
    lengths = genome.length_multiset(traffic["read_length_min"], traffic["read_length_max"],
                                     SAMPLE_READS * traffic["read_length_max"])[:SAMPLE_READS]
    with open(path, "w") as f:
        for j, length in enumerate(lengths):
            codes = g.codes(torch.arange(length, dtype=torch.int64) + 1000 * j)
            seq = "".join("ACGT"[c] for c in codes.tolist())
            f.write(f"@r{j}\n{seq}\n+\n{'I' * length}\n")


def mapper_config(config: dict, traffic: dict, n_buckets: int, device: torch.device,
                  chunk_size: int, workdir: Path) -> MapperConfig:
    """The ``MapperConfig`` that ``pipeline.config_and_chunks`` makes on
    ``device`` for a FASTQ of the traffic's reads on a table of
    ``n_buckets``."""
    path = workdir / "sample.fq"
    sample_fastq(config, traffic, path)
    made, chunks = pipeline.config_and_chunks(str(path), config["k"], chunk_size,
                                              traffic["revcomp"], device, n_buckets=n_buckets)
    getattr(chunks, "close", lambda: None)()
    return made


def make_pool(config: dict, traffic: dict, made: MapperConfig, seed: int,
              device: torch.device) -> list[genome.Buffer]:
    """The distinct buffers of the window, drawn from ``seed`` on ``device``."""
    strided = made.read_len > 0
    if strided != (traffic["read_length_min"] == traffic["read_length_max"]):
        raise RuntimeError(f"the port's config (read_len {made.read_len}) takes another "
                           "step than the traffic's reads")
    n = math.ceil(traffic["pool_min_bytes"] / (made.buf // 4))
    generator = torch.Generator(device=device)
    generator.manual_seed(seed)
    g = genome.Genome(config["genome_length"], config["seed"])
    pool = [genome.make_buffer(g, traffic, config["k"], made.buf, strided, generator,
                               pinned=device.type == "cuda") for _ in range(n)]
    if pool[0].lengths.shape[0] > made.max_reads:
        raise RuntimeError(f"{pool[0].lengths.shape[0]} reads a buffer, past max_reads")
    return pool


def shape_of(buf: genome.Buffer, n_buckets: int, distinct_hits: int,
             revcomp: bool) -> common.BufferShape:
    return common.BufferShape(strided=buf.strided, n_reads=int(buf.lengths.shape[0]),
                              n_bases=buf.n_bases, n_words=int(buf.words.shape[0]),
                              n_windows=buf.n_windows,
                              n_keys=buf.n_windows * (2 if revcomp else 1),
                              n_buckets=n_buckets, distinct_hits=distinct_hits)


def launches() -> dict:
    out: dict = {}
    for counts in LAUNCH_COUNTS:
        out.update(counts)
    return out


def card_line(device: torch.device) -> str:
    if device.type != "cuda":
        return "card: none"
    try:
        proc = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,"
                               "clocks.max.sm", "--format=csv,noheader"],
                              capture_output=True, text=True, timeout=30)
        return "card (name, power limit, SM clock, max SM clock): " + proc.stdout.strip()
    except (OSError, subprocess.SubprocessError) as exc:
        return f"card: nvidia-smi failed ({exc})"


def check(config: dict, traffic: dict, pool: list, mapped: list, got_nodes: np.ndarray,
          got_kmers: int, device: torch.device) -> tuple[dict, list]:
    """The reference's counts of the pool's buffers, each as many times as
    the window mapped it, both hashes of a window where the traffic says
    ``revcomp``, judged against the program's: (the numbers compared with
    their limits, the distinct index k-mers each buffer hit)."""
    t = time.perf_counter()
    g = genome.Genome(config["genome_length"], config["seed"])
    ref = reference.NodeCountReference(genome.index_entries(config, device),
                                       config["max_frequency"])
    distinct = [ref.add(reference.buffer_hashes(g, buf, config["k"], device,
                                                revcomp=traffic["revcomp"]), times)
                if times else 0 for buf, times in zip(pool, mapped)]
    want_nodes = ref.node_counts()
    checks = reference.judge(got_nodes, got_kmers, want_nodes, ref.windows)
    log(f"reference {time.perf_counter() - t:.3f} s: {ref.windows} k-mers, "
        f"{int(want_nodes.sum())} node hits")
    return checks, distinct


def run(spec: Spec, cell: dict, seed: int, seconds: float, trace: bool, device,
        t_start: float, chunk_size: int = CHUNK_SIZE, cache: Path = CACHE) -> dict:
    """One run of ``cell``; returns the result line's object."""
    device = torch.device(device)
    cuda = device.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize(device)

    parts = {"start_s": time.perf_counter() - t_start}  # interpreter, torch, the port
    config = spec.config(cell["config"])
    traffic = spec.traffic(cell["traffic"])
    max_frequency = config["max_frequency"]
    path = index_file(config, cache)
    build_s = 0.0  # the conversion of the index: not a part of setup_s
    if not path.exists():
        t = time.perf_counter()
        build_index(config, path, device)
        build_s = time.perf_counter() - t
        log(f"index built in {build_s:.3f} s (not in setup_s): {path.name}, "
            f"{path.stat().st_size} bytes")
    t = time.perf_counter()
    index = load_index(str(path))
    parts["index_load_s"] = time.perf_counter() - t
    n_buckets = index.table.n_buckets
    with tempfile.TemporaryDirectory() as tmp:
        workdir = Path(tmp)
        t = time.perf_counter()
        made = mapper_config(config, traffic, n_buckets, device, chunk_size, workdir)
        parts["config_s"] = time.perf_counter() - t
        t = time.perf_counter()
        pool = make_pool(config, traffic, made, seed, device)
        sync()
        parts["pool_s"] = time.perf_counter() - t
        if cuda:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(device)
        t = time.perf_counter()
        index.table.block_max_probe()  # kept by the table for the mapper
        parts["bounds_s"] = time.perf_counter() - t
        t = time.perf_counter()
        mapper = KmerMapper(index, made, device)
        sync()
        parts["table_upload_s"] = time.perf_counter() - t

        def step(i: int) -> None:
            buf = pool[i]
            mapper.map_chunk(buf.words, buf.read_lengths, buf.n_bases, strided=buf.strided)

        t = time.perf_counter()
        step(0)
        sync()
        parts["first_map_s"] = time.perf_counter() - t
        t = time.perf_counter()
        mapper.node_counts(max_frequency=max_frequency)
        parts["first_node_counts_s"] = time.perf_counter() - t
        # two buffers back to back, as the window queues them: the caching
        # allocator takes what the window needs here, not inside it
        t = time.perf_counter()
        step(0)
        step(1 % len(pool))
        sync()
        parts["second_map_s"] = time.perf_counter() - t
        mapper.reset_counts()
        sync()
        setup_s = time.perf_counter() - t_start - build_s
        log(f"set-up {setup_s:.3f} s: " + ", ".join(f"{n} {v:.3f}" for n, v in parts.items()))
        log(f"config: buf {made.buf}, max_reads {made.max_reads}, read_len {made.read_len}, "
            f"revcomp {made.revcomp}; index {index.n_unique} k-mers, {n_buckets} buckets; "
            f"pool {len(pool)} buffers of {pool[0].lengths.shape[0]} reads, "
            f"{pool[0].n_windows} k-mers, "
            f"{shape_of(pool[0], n_buckets, 0, traffic['revcomp']).n_keys} keys")

        before = launches()
        traced = None
        if trace:
            from torch.profiler import ProfilerActivity, profile, record_function

            def traced_step(i: int) -> None:
                with record_function("map_chunk"):
                    step(i)

            activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
            with profile(activities=activities) as prof:
                with record_function(common.WINDOW_SPAN):
                    mapped, window_s = common.timed_window(
                        traced_step, len(pool), seconds, sync)
            trace_path = workdir / "trace.json"
            prof.export_chrome_trace(str(trace_path))
            del prof
            traced = common.Trace.from_file(trace_path)
            trace_path.unlink()
            log("device ops, s: " + json.dumps(traced.device_ops(top=100)))
            calls = max(sum(mapped), 1)
            log("trace launches a buffer, by kernel file: " + json.dumps(
                {f"{group}/{name}": traced.launches([match]) / calls
                 for group, files in spec.kernel_files().items()
                 for name, match in files.items()}))
        else:
            mapped, window_s = common.timed_window(step, len(pool), seconds, sync)
        calls = sum(mapped)
        after = launches()
        log(f"window {window_s:.4f} s, {calls} buffers; launches a buffer: " + json.dumps(
            {n: (after[n] - before[n]) / max(calls, 1) for n in after if after[n] != before[n]}))

        got_kmers = mapper.n_kmers_mapped
        got_nodes = mapper.node_counts(max_frequency=max_frequency)
        peak = torch.cuda.max_memory_allocated(device) if cuda else 0
        del mapper, index
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()
        log(f"{card_line(device)}; peak device memory {peak} bytes")

        checks, distinct = check(config, traffic, pool, mapped, got_nodes, got_kmers, device)

    correct = reference.is_correct(checks)
    kmers = sum(buf.n_windows * times for buf, times in zip(pool, mapped))
    record = Record(spec=spec, kmers=kmers, window_s=window_s, setup_s=setup_s, calls=calls,
                    shapes=[shape_of(b, n_buckets, d, traffic["revcomp"])
                            for b, d in zip(pool, distinct)],
                    mapped=mapped, trace=traced)
    wanted = spec.per_layer(cell["name"]) if trace else spec.end_to_end(cell["name"])
    metrics = {}
    for metric in wanted:
        value = spec.reader(metric["name"]).read(record)
        if value is not None:
            metrics[metric["name"]] = {"value": value, "unit": metric["unit"]}
    dev = {"platform": "gpu" if cuda else device.type,
           "kind": torch.cuda.get_device_name(device) if cuda else device.type,
           "count": 1, "memory_peak_bytes": peak}
    result = {"correct": correct, "attempted": calls, "failed": 0 if correct else calls,
              "metrics": metrics, "device": dev}
    if traced is not None:
        dev["busy_s"] = traced.busy_s()
        dev["window_s"] = traced.window_s
        if traced.device:
            result["breakdown"] = {"device_ops": traced.device_ops(),
                                   "idle_gaps": traced.idle_gaps()}
    result["checks"] = checks
    return result
