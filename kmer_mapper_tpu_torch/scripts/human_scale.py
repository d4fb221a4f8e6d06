"""The parts of ``chip_smoke.py``'s phase 12: the human-scale index through
the port's user entry points, the file CLI, the KAGE library calls and the
sharded file path, on ``scale_drill``'s table, each result held to the host
bit for bit. At the smoke's size the index is ``scale_drill``'s at its
default draw (127,494,474 keys in 2^25 buckets, a 2.15 GB table, 30M
nodes), built by ``scale_drill.build_index`` after four draws of 64 Mi
bases of 151-bp reads, saved with ``KmerIndex.to_file`` and loaded again
(:func:`build`); every entry point is given that file's path or the loaded
index. Parts, each raising when a result differs:

  (a) file (:func:`file_part`): the draws written as one FASTQ and mapped
      by the CLI in a fresh process, as ``python -m
      kmer_mapper_tpu_torch.cli map -i <index> -f <fq> -o <out> -k 31 -t 8``
      maps it; its buffer must be ``pipeline.buffer_bases``' for the table,
      and its ``.npy`` must equal the same reads mapped by
      ``KmerMapper.map_chunk`` in device-resident buffers of one draw each;
      the file's first framed chunk mapped as a file of its own == the host
      probe (``scale_run.check_prefix``);
  (a, ragged) (:func:`ragged_part`): one buffer of the draws' bases cut
      into reads of RAGGED_MIN..RAGGED_MAX bp, as a FASTQ through
      ``pipeline.map_file`` with the CLI's workers on the loaded index, one
      buffer of the policy's size on the ragged step == ``map_chunk`` over
      the same reads in buffers of one draw's size;
  (b) library (:func:`library_part`): hashes, half the index's keys and
      half uniform, through ``compat.map_kmers_to_graph_index`` and
      ``in_graph_index`` on the loaded index == the host (each hash's slot:
      a drawn key's own, a uniform hash's by a binary search of the
      entries' sorted k-mers; ``KmerIndex.node_counts``); the call split
      into upload, kernel and node counts;
  (c) sharded (:func:`sharded_part`): ``pipeline.map_file_sharded`` on the
      FASTQ over a (1, X) grid == (a)'s vector, in the buffers the policy
      gives a shard.

Each part's kernel launch counts are zeroed before it and read after it.
"""
from __future__ import annotations

import json
import logging
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from .. import compat, pipeline
from ..index.kmer_index import KmerIndex
from ..io import readers
from ..models.mapper import KmerMapper, MapperConfig
from ..ops import block_partition, finalize, hashing, probe, stream_probe
from . import scale_drill, scale_run
from .scale_drill import K, MAX_FREQUENCY, READ_LEN, log, rss_gb

#: draws of reads before the keys, as ``scale_drill`` draws them at its
#: default STEPS: the index is then the drill's
DRILL_STEPS = 4
#: the CLI's framing workers (``-t``) and its default ``--chunk-size``
CLI_THREADS = 8
CLI_CHUNK_SIZE = 2_500_000
#: read lengths of the ragged file: trimmed reads, short enough that one
#: 128 Mi-base buffer holds more reads (about 1.19M) than a wave of
#: ``ragged_offsets``' grid on an H100 (1,081,344)
RAGGED_MIN, RAGGED_MAX = 75, 151
LAUNCH_MODULES = (stream_probe, hashing, block_partition, probe, finalize)

#: the CLI's ``main`` in a fresh process (what ``python -m
#: kmer_mapper_tpu_torch.cli`` runs), then its run's figures and kernel
#: launch counts on one line
CLI_RUNNER = """
import json, logging, sys
from kmer_mapper_tpu_torch import cli, pipeline
from kmer_mapper_tpu_torch.scripts import human_scale

catch = human_scale.RunFigures()
logging.getLogger(pipeline.__name__).addHandler(catch)
cli.main(sys.argv[1:])
print("CLI_RESULT " + json.dumps({"figures": catch.figures,
                                  "launches": human_scale.launches()}))
"""


def zero_launches() -> None:
    for m in LAUNCH_MODULES:
        for name in m.launch_counts:
            m.launch_counts[name] = 0


def launches() -> dict:
    return {name: n for m in LAUNCH_MODULES for name, n in m.launch_counts.items()}


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def build(n_keys: int, draw: int, n_draws: int, workdir: str) -> dict:
    """The reads (``n_draws`` draws of ``draw`` bases, the keys drawn after
    the first DRILL_STEPS), the drill's index saved to ``workdir`` and
    loaded again, and its entries' k-mers (ascending)."""
    if n_draws < DRILL_STEPS:
        raise ValueError(f"human_scale: at least {DRILL_STEPS} draws of reads")
    rng = np.random.default_rng(0)
    chunks = [scale_drill.make_read_chunk(rng, draw) for _ in range(DRILL_STEPS)]
    built, build_s, entry = scale_drill.build_index(rng, chunks, n_keys)
    chunks += [scale_drill.make_read_chunk(rng, draw) for _ in range(n_draws - DRILL_STEPS)]
    if not np.all(entry[1:] > entry[:-1]):
        raise AssertionError("human_scale: the entries' k-mers are not ascending")
    path = os.path.join(workdir, "human.tpuidx.npz")
    t = time.perf_counter()
    built.to_file(path)
    save_s = time.perf_counter() - t
    del built
    t = time.perf_counter()
    index = KmerIndex.from_file(path)
    load_s = time.perf_counter() - t
    table = index.table
    log(f"index: {index.n_unique} keys in {table.n_buckets} buckets ({table.nbytes / 1e9:.2f} "
        f"GB, max_probe {table.max_probe}), {index.max_node_id + 1} nodes; build {build_s:.1f} "
        f"s, save {save_s:.1f} s ({os.path.getsize(path) / 1e9:.2f} GB), load {load_s:.1f} s "
        f"(RSS {rss_gb():.1f} GB)")
    return dict(index=index, entry=entry, chunks=chunks, draw=draw, path=path, build_s=build_s,
                save_s=save_s, load_s=load_s)


#: bytes of one record of :func:`fastq_bytes`
FASTQ_RECORD = 11 + 2 * READ_LEN + 4


def fastq_bytes(chunk, first_id: int) -> bytes:
    """The chunk's fixed-length reads as FASTQ records of one width: '@' and
    a 9-digit id, the read, '+', a quality line of 'I'."""
    n = chunk.n_reads
    rec = np.empty((n, FASTQ_RECORD), dtype=np.uint8)
    rec[:, 0] = ord("@")
    ids = np.arange(first_id, first_id + n, dtype=np.int64)
    for d in range(9):
        rec[:, 9 - d] = ord("0") + (ids // 10**d) % 10
    rec[:, 10] = ord("\n")
    rec[:, 11 : 11 + READ_LEN] = chunk.bases.reshape(n, READ_LEN)
    rec[:, 11 + READ_LEN : 14 + READ_LEN] = np.frombuffer(b"\n+\n", dtype=np.uint8)
    rec[:, 14 + READ_LEN : -1] = ord("I")
    rec[:, -1] = ord("\n")
    return rec.tobytes()


def write_fastq(path: str, chunks) -> int:
    """The chunks' reads as one FASTQ (:func:`fastq_bytes`). Returns the
    reads written."""
    first_id = 0
    with open(path, "wb") as f:
        for chunk in chunks:
            f.write(fastq_bytes(chunk, first_id))
            first_id += chunk.n_reads
    return first_id


def ragged_reads(rng, chunks, n_bases: int) -> readers.SequenceChunk:
    """The chunks' bases, joined and cut at ``n_bases``, as reads of
    RAGGED_MIN..RAGGED_MAX bp: the whole reads that fit."""
    bases = np.concatenate([c.bases for c in chunks])[:n_bases]
    lengths = rng.integers(RAGGED_MIN, RAGGED_MAX + 1, len(bases) // RAGGED_MIN + 1)
    lengths = lengths[: np.searchsorted(np.cumsum(lengths), len(bases), side="right")]
    starts = np.cumsum(lengths) - lengths
    return readers.SequenceChunk(bases=bases[: int(lengths.sum())], read_starts=starts)


def ragged_fastq_bytes(chunk) -> bytes:
    """A chunk's reads of any length as FASTQ: '@r' and an id, the read,
    '+', a quality line of 'I'."""
    ends = chunk.read_starts + chunk.read_lengths
    return b"".join(b"@r%d\n%s\n+\n%s\n" % (i, chunk.bases[s:e].tobytes(), b"I" * (e - s))
                    for i, (s, e) in enumerate(zip(chunk.read_starts, ends)))


class RunFigures(logging.Handler):
    """Keeps the figures of the latest ``map_file`` or ``map_file_sharded``
    run, read off its record (``record.figures``)."""

    def __init__(self):
        super().__init__(logging.INFO)
        self.figures = None

    def emit(self, record):
        if hasattr(record, "figures"):
            self.figures = record.figures


def run_cli(index_path: str, reads_path: str, out: str, device: torch.device,
            threads: int = CLI_THREADS) -> dict:
    """The CLI's ``map`` in a fresh process on ``device``: its node counts,
    its run's figures (``pipeline.map_file``'s), its kernel launches, the
    process's wall seconds and the tail of its log."""
    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (root, os.environ.get("PYTHONPATH")) if p))
    argv = ["map", "-i", index_path, "-f", reads_path, "-o", out, "-k", str(K),
            "-t", str(threads), "--device", str(device)]
    t = time.perf_counter()
    proc = subprocess.run([sys.executable, "-c", CLI_RUNNER, *argv], capture_output=True,
                          text=True, env=env)
    wall = time.perf_counter() - t
    lines = [line for line in proc.stdout.splitlines() if line.startswith("CLI_RESULT ")]
    if proc.returncode or len(lines) != 1:
        raise AssertionError(f"human_scale (a): the CLI exited {proc.returncode}:\n"
                             f"{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
    result = json.loads(lines[0].split(" ", 1)[1])
    log_tail = "\n".join(line for line in proc.stdout.splitlines()
                         if not line.startswith("CLI_RESULT "))[-2000:]
    return dict(result, counts=np.load(out if out.endswith(".npy") else out + ".npy"),
                wall_s=wall, log=log_tail)


def map_chunk_counts(index: KmerIndex, chunks, buf: int, device: torch.device,
                     read_len: int = READ_LEN) -> np.ndarray:
    """The chunks' node counts through ``KmerMapper.map_chunk``, each chunk
    packed alone in buffers of ``buf`` bases resident on ``device``: strided
    buffers of ``read_len``-bp reads through the plane step, or with
    ``read_len`` 0 continuous buffers and their reads' lengths through the
    ragged step."""
    config = MapperConfig(k=K, buf=buf, max_reads=max(1024, buf // 32), read_len=read_len)
    mapper = KmerMapper(index, config, device)
    for chunk in chunks:
        for packed, lengths, n_bases, n_reads, _, *strided in readers.pack_for_device(
                iter([chunk]), config.buf, config.max_reads, K, read_len=read_len):
            if bool(strided and strided[0]) != bool(read_len):
                raise AssertionError("human_scale: a chunk did not pack in its reads' layout")
            mapper.map_chunk(torch.from_numpy(packed.view(np.int32)).to(device),
                             torch.from_numpy(lengths[:n_reads].astype(np.int32)).to(device),
                             n_bases, strided=bool(read_len))
    return mapper.node_counts(max_frequency=MAX_FREQUENCY)


def file_part(built: dict, workdir: str, device: torch.device) -> dict:
    """(a): the FASTQ through the CLI, against map_chunk and the host probe."""
    index, chunks = built["index"], built["chunks"]
    n_buckets = index.table.n_buckets
    fq = os.path.join(workdir, "human.fq")
    t = time.perf_counter()
    n_reads = write_fastq(fq, chunks)
    log(f"file: {n_reads} reads, {os.path.getsize(fq) / 1e9:.2f} GB of FASTQ written in "
        f"{time.perf_counter() - t:.1f} s")
    run = run_cli(built["path"], fq, os.path.join(workdir, "human_counts.npy"), device)
    fig = run["figures"]
    want_buf = pipeline.buffer_bases(device, CLI_CHUNK_SIZE, n_buckets)
    if fig["buf"] != want_buf:
        raise AssertionError(f"human_scale (a): the CLI mapped in {fig['buf']}-base buffers, "
                             f"the policy gives {want_buf} for {n_buckets} buckets")
    if fig["kmers"] != n_reads * (READ_LEN - K + 1):
        raise AssertionError(f"human_scale (a): the CLI counted {fig['kmers']} k-mers")
    got = run["counts"]
    log(f"file (a): cli map in a fresh process, wall {run['wall_s']:.3f} s, the call "
        f"{fig['total_s']:.3f} s: index load {fig['load_s']:.3f} s, the device's start "
        f"{fig['init_s']:.3f} s, the chain blocks' bounds {fig['bounds_s']:.3f} s, table "
        f"upload {fig['upload_s']:.3f} s, loop {fig['map_s']:.3f} s ({fig['chunks']} buffers of "
        f"{fig['buf']} bases; waited {fig['queue_wait_s']:.3f} s on the host feed), first "
        f"node_counts with the entries' upload and sort {fig['node_counts_s']:.3f} s; "
        f"{fig['kmers'] / run['wall_s'] / 1e6:.1f} Mk/s of the wall, "
        f"{fig['kmers'] / fig['map_s'] / 1e6:.1f} of the loop; {int(got.sum(dtype=np.int64))} "
        f"node hits; launches {run['launches']}")

    zero_launches()
    t = time.perf_counter()
    want = map_chunk_counts(index, chunks, built["draw"], device)
    reference_launches = launches()
    if not np.array_equal(got, want):
        raise AssertionError("human_scale (a): the CLI's node counts differ from map_chunk's")
    log(f"file (a): == map_chunk over {len(chunks)} device-resident buffers of "
        f"{built['draw']} bases ({time.perf_counter() - t:.1f} s); launches "
        f"{reference_launches}")
    zero_launches()
    t = time.perf_counter()
    n_prefix, prefix_hits = scale_run.check_prefix(index, Path(fq), Path(workdir),
                                                     device)
    prefix_launches = launches()
    log(f"file (a): the first framed chunk as a file, {n_prefix} k-mers, {prefix_hits} node "
        f"hits == the host probe ({time.perf_counter() - t:.1f} s); launches "
        f"{prefix_launches}")
    return dict(counts=got, reads_path=fq, figures=fig, wall_s=run["wall_s"],
                launches=run["launches"], reference_launches=reference_launches,
                prefix_launches=prefix_launches, prefix_kmers=n_prefix)


def ragged_part(built: dict, workdir: str, device: torch.device) -> dict:
    """(a, ragged): one buffer of the policy's size cut from the draws'
    bases into reads of RAGGED_MIN..RAGGED_MAX bp, as a FASTQ through
    ``pipeline.map_file`` (what the CLI runs, with its workers) on the
    loaded index, against ``map_chunk`` over the same reads in buffers of
    one draw's size."""
    index = built["index"]
    buf = pipeline.buffer_bases(device, CLI_CHUNK_SIZE, index.table.n_buckets)
    reads = ragged_reads(np.random.default_rng(3), built["chunks"], buf)
    path = os.path.join(workdir, "human_ragged.fq")
    t = time.perf_counter()
    with open(path, "wb") as f:
        f.write(ragged_fastq_bytes(reads))
    write_s = time.perf_counter() - t
    n_kmers = int(np.maximum(reads.read_lengths - K + 1, 0).sum())
    catch = RunFigures()
    pipeline_log = logging.getLogger(pipeline.__name__)
    pipeline_log.addHandler(catch)
    level = pipeline_log.level
    pipeline_log.setLevel(logging.INFO)
    zero_launches()
    try:
        t = time.perf_counter()
        got = pipeline.map_file(index, path, device=device, k=K, chunk_size=CLI_CHUNK_SIZE,
                                max_frequency=MAX_FREQUENCY, reader_workers=CLI_THREADS)
        wall = time.perf_counter() - t
    finally:
        pipeline_log.removeHandler(catch)
        pipeline_log.setLevel(level)
    run_launches = launches()
    fig = catch.figures
    if fig["buf"] != buf or fig["chunks"] != 1 or fig["kmers"] != n_kmers:
        raise AssertionError(f"human_scale (a, ragged): {fig['chunks']} buffers of "
                             f"{fig['buf']} bases, {fig['kmers']} k-mers; the policy gives "
                             f"one of {buf} bases, {n_kmers} k-mers")
    zero_launches()
    want = map_chunk_counts(index, [reads], built["draw"], device, read_len=0)
    reference_launches = launches()
    if not np.array_equal(got, want):
        raise AssertionError("human_scale (a, ragged): map_file's node counts differ from "
                             "map_chunk's")
    log(f"file (a, ragged): {reads.n_reads} reads of {RAGGED_MIN}-{RAGGED_MAX} bp, "
        f"{reads.n_bases} bases ({os.path.getsize(path) / 1e9:.2f} GB of FASTQ written in "
        f"{write_s:.1f} s) through map_file on the loaded index: one buffer of {fig['buf']} "
        f"bases, wall {wall:.3f} s (table upload {fig['upload_s']:.3f} s, loop "
        f"{fig['map_s']:.3f} s, node counts {fig['node_counts_s']:.3f} s), {n_kmers} k-mers, "
        f"{int(got.sum(dtype=np.int64))} node hits == map_chunk over buffers of "
        f"{built['draw']} bases; launches {run_launches}")
    return dict(counts=got, reads=reads, figures=fig, wall_s=wall, launches=run_launches,
                reference_launches=reference_launches)


def library_hashes(rng, index: KmerIndex, entry: np.ndarray, n: int
                   ) -> tuple[np.ndarray, np.ndarray]:
    """``n`` uint64 hashes, half drawn from the entries' k-mers and half
    uniform, shuffled, and each one's table slot or -1: a drawn entry's own
    slot, a uniform hash's by :func:`host_slots`."""
    drawn = rng.integers(0, len(entry), n // 2)
    uniform = rng.integers(0, 1 << 62, n - n // 2, dtype=np.uint64)
    q = np.concatenate([entry[drawn], uniform])
    slots = np.concatenate([index.entry_slot[drawn].astype(np.int64),
                            host_slots(index, entry, uniform)])
    order = rng.permutation(n)
    return q[order], slots[order]


def host_slots(index: KmerIndex, entry: np.ndarray, hashes: np.ndarray) -> np.ndarray:
    """Each hash's table slot, or -1, on the host: a binary search of the
    entries' ascending k-mers ``entry`` (the hashes sorted first, so that
    the search walks the entries once)."""
    order = np.argsort(hashes)
    pos = np.minimum(np.searchsorted(entry, hashes[order]), len(entry) - 1)
    slots = np.empty(len(hashes), dtype=np.int64)
    slots[order] = np.where(entry[pos] == hashes[order], index.entry_slot[pos], -1)
    return slots


def library_part(index: KmerIndex, entry: np.ndarray, n_hashes: int,
                 device: torch.device) -> dict:
    """(b): the KAGE calls on the loaded index against the host; the call
    split into upload, kernel and node counts. The index keeps its cached
    mapper (``compat``) until :func:`release_library`."""
    t = time.perf_counter()
    q, slots = library_hashes(np.random.default_rng(2), index, entry, n_hashes)
    slot_counts = np.bincount(slots[slots >= 0], minlength=index.table.n_slots)
    want = index.node_counts(slot_counts, max_frequency=MAX_FREQUENCY)
    host_s = time.perf_counter() - t
    log(f"library: {len(q)} hashes, {int((slots >= 0).sum())} in the index; drawn, with the "
        f"host's slots and node counts, in {host_s:.1f} s")

    zero_launches()
    t = time.perf_counter()
    got = compat.map_kmers_to_graph_index(index, kmers=q, device=device)
    first_s = time.perf_counter() - t
    t = time.perf_counter()
    again = compat.map_kmers_to_graph_index(index, kmers=q, device=device)
    call_s = time.perf_counter() - t
    t = time.perf_counter()
    member = compat.in_graph_index(index, q, device=device)
    member_s = time.perf_counter() - t
    call_launches = launches()
    if not (np.array_equal(got, want) and np.array_equal(again, want)):
        raise AssertionError("human_scale (b): map_kmers_to_graph_index != the host")
    if not np.array_equal(member.astype(bool), slots >= 0):
        raise AssertionError("human_scale (b): in_graph_index != the host")

    # the cached mapper's stages alone, on the same hashes
    mapper = compat._shared_mapper(index, device=device)
    table = index.table
    mapper.reset_counts()
    sync(device)
    t = time.perf_counter()
    pieces = list(mapper._hash_pieces(q))
    sync(device)
    upload_s = time.perf_counter() - t
    t = time.perf_counter()
    for piece in pieces:
        probe.probe_count(mapper.key_lo, mapper.key_hi, mapper.counts, piece, table.max_probe,
                          table.seed, block_probe=mapper.block_probe)
    sync(device)
    kernel_s = time.perf_counter() - t
    del pieces
    t = time.perf_counter()
    split = mapper.node_counts(max_frequency=MAX_FREQUENCY)
    node_counts_s = time.perf_counter() - t
    if not np.array_equal(split, want):
        raise AssertionError("human_scale (b): the call's stages alone count otherwise")
    log(f"library (b): map_kmers_to_graph_index on {len(q)} hashes == the host: first call "
        f"{first_s:.3f} s (table upload, entries' upload and sort included), again "
        f"{call_s:.3f} s ({len(q) / call_s / 1e6:.1f} M hashes/s); its stages alone: upload "
        f"{upload_s:.4f} s, kernel {kernel_s:.4f} s, node counts {node_counts_s:.4f} s; "
        f"in_graph_index == the host ({int(member.sum())} in) in {member_s:.3f} s; "
        f"{int(want.sum(dtype=np.int64))} node hits; launches {call_launches}")
    return dict(hashes=q, slots=slots, first_s=first_s, call_s=call_s, upload_s=upload_s,
                kernel_s=kernel_s, node_counts_s=node_counts_s, in_index_s=member_s,
                host_s=host_s, launches=call_launches, mapper=mapper)


def release_library(index: KmerIndex, device: torch.device) -> None:
    """Drop the index's cached library mapper and its device memory (once
    no caller holds the mapper)."""
    index.__dict__.pop("_compat_mappers", None)
    if device.type == "cuda":
        torch.cuda.empty_cache()


def sharded_part(index_path: str, reads_path: str, want: np.ndarray, n_buckets: int,
                 devices: list) -> dict:
    """(c): ``map_file_sharded`` on a (1, len(devices)) grid over
    ``devices`` (one device named X times puts X shards on it) == ``want``,
    in the buffers the policy gives a shard."""
    x = len(devices)
    catch = RunFigures()
    pipeline_log = logging.getLogger(pipeline.__name__)
    pipeline_log.addHandler(catch)
    level = pipeline_log.level
    pipeline_log.setLevel(logging.INFO)
    zero_launches()
    try:
        t = time.perf_counter()
        got = pipeline.map_file_sharded(index_path, reads_path, k=K, devices=devices,
                                        index_parallel=x, max_frequency=MAX_FREQUENCY)
        wall = time.perf_counter() - t
    finally:
        pipeline_log.removeHandler(catch)
        pipeline_log.setLevel(level)
    run_launches = launches()
    if devices[0].type == "cuda":
        torch.cuda.empty_cache()
    fig = catch.figures
    want_buf = pipeline.buffer_bases(devices[0], CLI_CHUNK_SIZE, n_buckets, x)
    where = ", ".join(map(str, devices))
    if fig["buf"] != want_buf:
        raise AssertionError(f"human_scale (c): {x} shards over {where} mapped in "
                             f"{fig['buf']}-base buffers, the policy gives {want_buf}")
    if not np.array_equal(got, want):
        raise AssertionError(f"human_scale (c): map_file_sharded over (1, {x}) on {where} "
                             "!= the CLI's node counts")
    log(f"sharded (c): map_file_sharded, grid (1, {x}) on {where}: {fig['chunks']} buffers "
        f"of {fig['buf']} bases, wall {wall:.3f} s (loop {fig['map_s']:.3f} s), == the "
        f"CLI's vector; launches {run_launches}")
    return dict(grid=(1, x), devices=[str(d) for d in devices], wall_s=wall, buf=fig["buf"],
                map_s=fig["map_s"], launches=run_launches)
