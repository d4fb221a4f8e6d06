"""Human-scale index drill: build, store, load and map against an index of
~10^8 keys, the size of a human pangenome's (the counterpart of
``scripts/r8_scale_drill.py``).

    python -m kmer_mapper_tpu_torch.scripts.scale_drill [N_KEYS_MILLIONS] [--device cpu]

N_KEYS_MILLIONS defaults to 150 (about 127M unique keys in 2^25 buckets).
Environment:
    STEPS        draws of reads, each of one buffer (4)
    BUF_MI       the buffer and the draws, in Mi bases (default: draws of
                 ``pipeline.CUDA_BUF``, as the JAX drill draws them, mapped
                 in the file pipeline's buffer for the table,
                 ``pipeline.device_buf``: from 2^25 buckets two draws make
                 one buffer of 128 Mi)
    SKIP_DEVICE  1: the host phases only
    REUSE_INDEX  1: load the index a previous run saved
                 (``drill.tpuidx.npz`` in the temporary directory) instead
                 of building it; comparable only across runs with the same
                 BUF_MI, since half the keys are sampled from the first chunk

Phases, each timed, with the host's peak RSS after each:
  1. keys and build: buckets, table GB, chain bound, mean block rounds;
  2. ``KmerIndex.to_file`` / ``from_file``: seconds and GB on disk;
  3. device: the table upload, the draws as distinct device-resident chunks
     through ``KmerMapper.map_chunk`` in 3 windows after a first one (host
     clock around work that ends in a synchronize), the stage split (hash
     keys, partition, count; CUDA events), peak device memory;
  4. finalize: the first ``node_counts`` (the entries' upload and sort
     included), the entries' upload and sort alone, the finalize kernel's
     ms, the host ``KmerIndex.node_counts`` of the same slot counts (equal
     bit for bit), and one chunk's node counts == the numpy oracle's.
Prints one ``RESULT`` line on stdout.
"""
from __future__ import annotations

import argparse
import os
import resource
import sys
import tempfile
import time

import numpy as np
import torch

from .. import oracle, pipeline
from ..index.kmer_index import KmerIndex
from ..io import readers
from ..models.mapper import KmerMapper, MapperConfig
from ..ops import block_partition, finalize, hashing, stream_probe
from ..ops.u32hash import bucket_shift, feistel_unmix, join_u64
from . import device_arg, device_name, median_ms, pick_device, stage_split
from .bench_matrix import fixed_read_kmers, sorted_unique

K = 31
READ_LEN = 151
N_WINDOWS = 3
N_NODES = 30_000_000
MAX_FREQUENCY = 1000


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def rss_gb() -> float:
    """The process's peak resident set, GB."""
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6


def make_read_chunk(rng, n_bases: int) -> readers.SequenceChunk:
    """Random reads of READ_LEN bases filling ``n_bases`` (``bench.py``'s
    fixed-length generator)."""
    bases = rng.choice(np.frombuffer(b"ACGT", dtype=np.uint8), n_bases)
    n_reads = n_bases // READ_LEN
    starts = np.arange(n_reads, dtype=np.int64) * READ_LEN
    return readers.SequenceChunk(bases=bases[: n_reads * READ_LEN], read_starts=starts)


def merge_chunks(chunks, n_bases: int) -> list:
    """Consecutive chunks joined into chunks of at most ``n_bases`` bases
    (a chunk that alone is larger stays as it is)."""
    groups = [[]]
    for chunk in chunks:
        if groups[-1] and sum(c.n_bases for c in groups[-1]) + chunk.n_bases > n_bases:
            groups.append([])
        groups[-1].append(chunk)
    out = []
    for group in groups:
        offsets = np.cumsum([0] + [c.n_bases for c in group[:-1]])
        out.append(readers.SequenceChunk(
            bases=np.concatenate([c.bases for c in group]),
            read_starts=np.concatenate([c.read_starts + o for c, o in zip(group, offsets)])))
    return out


def entry_kmers(index: KmerIndex) -> np.ndarray:
    """Each entry's k-mer, unmixed from the table slot it points at."""
    lo, hi = index.table.key_words()
    return join_u64(*feistel_unmix(lo[index.entry_slot], hi[index.entry_slot],
                                   seed=index.table.seed))


def oracle_counts(index: KmerIndex, entry: np.ndarray, kmers: np.ndarray) -> np.ndarray:
    """The numpy oracle's node counts of ``kmers`` on the index whose
    entries hold the k-mers ``entry``: the reference-layout index of the
    entries whose k-mer occurs among ``kmers``, probed with the k-mers that
    equal one (the others hit nothing)."""
    hit = np.isin(entry, kmers)
    arrays = oracle.build_kmer_index(entry[hit], index.entry_node[hit],
                                     max(2, int(hit.sum() * 1.7) | 1))
    return oracle.map_kmers_to_index(arrays, kmers[np.isin(kmers, entry[hit])],
                                     max_node_id=index.max_node_id,
                                     max_frequency=MAX_FREQUENCY)


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def draw_keys(rng, chunks, n_keys: int) -> tuple[np.ndarray, np.ndarray]:
    """``n_keys`` keys, 3/4 of them uniform and 1/2 sampled from the first
    chunk's k-mers (across read ends, as the JAX drill samples them),
    unique and cut to ``n_keys``, and a random node each."""
    sample_codes = oracle.encode_bytes(chunks[0].bases[: READ_LEN * 100_000])
    sample_kmers = oracle.kmer_hashes(sample_codes, K)
    keys = sorted_unique(
        np.concatenate(
            [
                rng.integers(0, 1 << 62, n_keys * 3 // 4, dtype=np.uint64),
                rng.choice(sample_kmers, n_keys // 2),
            ]
        )
    )[:n_keys]
    return keys, rng.integers(0, N_NODES, len(keys)).astype(np.int32)


def build_index(rng, chunks, n_keys: int) -> tuple[KmerIndex, float, np.ndarray]:
    """Phase 1: the keys (:func:`draw_keys`) and their index. Returns the
    index, its build seconds and its entries' k-mers, read back from the
    table (== the keys)."""
    t = time.perf_counter()
    keys, nodes = draw_keys(rng, chunks, n_keys)
    log(f"keys: {len(keys)} unique in {time.perf_counter() - t:.1f} s "
        f"(RSS {rss_gb():.1f} GB)")
    t = time.perf_counter()
    index = KmerIndex.from_entries(keys, nodes)
    t_build = time.perf_counter() - t
    entry = entry_kmers(index)
    if not np.array_equal(entry, keys):
        raise AssertionError("scale_drill: the table does not hold the entries' keys")
    return index, t_build, entry


def device_phases(index: KmerIndex, entry: np.ndarray, chunks, buf: int,
                  device: torch.device) -> dict:
    """Phases 3 and 4 on ``device``; ``entry`` holds the entries' k-mers."""
    table = index.table
    config = MapperConfig(k=K, buf=buf, max_reads=max(1024, buf // 32), read_len=READ_LEN)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    t = time.perf_counter()
    mapper = KmerMapper(index, config, device)
    sync(device)
    upload_s = time.perf_counter() - t
    log(f"table -> device: {upload_s:.3f} s ({table.nbytes / 1e9:.2f} GB of key words, "
        f"{table.n_slots * 4 / 1e9:.2f} GB of zeroed counts)")
    dev_chunks = []
    for chunk in chunks:
        (packed, _, n_bases, n_reads, _, strided), = readers.pack_for_device(
            iter([chunk]), config.buf, config.max_reads, K, read_len=READ_LEN
        )
        if not strided:
            raise AssertionError("scale_drill: a chunk did not pack in the strided layout")
        dev_chunks.append((torch.from_numpy(packed.view(np.int32)).to(device), n_bases,
                           n_reads))
    kmers_per_window = sum(nr for _, _, nr in dev_chunks) * (READ_LEN - K + 1)

    def window():
        for words, nb, _ in dev_chunks:
            mapper.map_chunk(words, None, nb, strided=True)
        sync(device)

    t = time.perf_counter()
    window()
    first_s = time.perf_counter() - t
    log(f"first window: {first_s:.3f} s")
    rates = []
    for w in range(N_WINDOWS):
        t = time.perf_counter()
        window()
        rates.append(kmers_per_window / (time.perf_counter() - t))
        log(f"window {w}: {rates[-1] / 1e6:.1f} Mk/s")
    if mapper.n_kmers_mapped != (1 + N_WINDOWS) * kmers_per_window:
        raise AssertionError("scale_drill: the mapper counted another number of windows")

    n_buckets, seed = table.n_buckets, table.seed
    shift, bpb = bucket_shift(n_buckets), min(128, n_buckets)
    scratch = torch.zeros_like(mapper.counts)

    def count(state):
        keys, off = state
        stream_probe.stream_count(mapper.key_lo, mapper.key_hi, scratch, keys, off,
                                  mapper.block_probe, shift, bpb)
        return state

    stage_ms = stage_split(dev_chunks, [
        ("hash_keys", lambda c: hashing.plane_hash_keys(c[0], K, READ_LEN, c[2], seed)),
        ("partition", lambda keys: block_partition.block_partition(keys, n_buckets, bpb)),
        ("count", count),
    ], device)
    del scratch
    log("stage split, ms a chunk: " + ", ".join(f"{n} {v:.4f}" for n, v in stage_ms.items()))

    # phase 4: the finalize on the device against the host's
    t = time.perf_counter()
    got = mapper.node_counts(max_frequency=MAX_FREQUENCY)
    first_node_counts_s = time.perf_counter() - t
    # the mapping's and the first finalize's peak, before a second copy of the entries
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else None
    t = time.perf_counter()
    entries = index.device_entries(device)
    sync(device)
    entries_s = time.perf_counter() - t
    n_nodes = index.max_node_id + 1
    card = finalize.finalize(mapper.counts, *entries, MAX_FREQUENCY, n_nodes)
    card_ms = median_ms(lambda: finalize.finalize(mapper.counts, *entries, MAX_FREQUENCY,
                                                  n_nodes), device)
    del entries
    slot_counts = mapper.slot_counts()
    t = time.perf_counter()
    host = index.node_counts(slot_counts, max_frequency=MAX_FREQUENCY)
    host_s = time.perf_counter() - t
    if not (np.array_equal(got, host)
            and np.array_equal(card.cpu().numpy().view(np.uint32), host)):
        raise AssertionError("scale_drill: the device's node counts differ from the host's")
    log(f"finalize: first node_counts {first_node_counts_s:.3f} s (entries' upload and sort "
        f"alone {entries_s:.3f} s), the kernel {card_ms:.4f} ms, the host {host_s:.3f} s; "
        f"{int(host.sum(dtype=np.int64))} node hits, equal bit for bit "
        f"(RSS {rss_gb():.1f} GB)")

    # one chunk's node counts against the oracle
    mapper.reset_counts()
    words, nb, _ = dev_chunks[0]
    mapper.map_chunk(words, None, nb, strided=True)
    got = mapper.node_counts(max_frequency=MAX_FREQUENCY)
    del mapper, dev_chunks
    t = time.perf_counter()
    kmers = fixed_read_kmers(chunks[0].bases, READ_LEN, K)
    if not np.array_equal(got, oracle_counts(index, entry, kmers)):
        raise AssertionError("scale_drill: one chunk's node counts differ from the oracle's")
    log(f"chunk 0: {len(kmers)} k-mers, {int(got.sum(dtype=np.int64))} node hits == oracle "
        f"(checked in {time.perf_counter() - t:.1f} s)")
    return dict(upload_s=upload_s, first_window_s=first_s, best_mk_s=max(rates) / 1e6,
                **{f"{name}_ms": ms for name, ms in stage_ms.items()},
                peak_device_gib=None if peak is None else peak / 2**30,
                first_node_counts_s=first_node_counts_s, device_entries_s=entries_s,
                finalize_card_ms=card_ms, finalize_host_s=host_s)


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("n_keys_millions", nargs="?", type=int, default=150,
                        help="keys drawn, in millions, before the unique cut (default 150)")
    device_arg(parser)
    a = parser.parse_args(argv)
    skip_device = os.environ.get("SKIP_DEVICE") == "1"
    device = None if skip_device else pick_device(a.device)
    steps = int(os.environ.get("STEPS", 4))
    buf_env = int(os.environ.get("BUF_MI", 0)) << 20
    draw = buf_env or pipeline.CUDA_BUF
    n_keys = a.n_keys_millions * 1_000_000
    print(f"scale_drill on {'the host' if skip_device else device_name(device)}: "
          f"{n_keys} keys drawn, {steps} chunks of {draw >> 20} Mi bases drawn", flush=True)

    rng = np.random.default_rng(0)
    chunks = [make_read_chunk(rng, draw) for _ in range(steps)]
    path = os.path.join(tempfile.gettempdir(), "drill.tpuidx.npz")
    result = dict(steps=steps)
    if os.environ.get("REUSE_INDEX") == "1" and os.path.exists(path):
        t = time.perf_counter()
        index = KmerIndex.from_file(path)
        result.update(reused=1, load_s=time.perf_counter() - t)
        log(f"REUSED index from {path} in {result['load_s']:.1f} s: "
            f"{index.n_unique} keys (RSS {rss_gb():.1f} GB)")
        entry = entry_kmers(index)
    else:
        index, result["build_s"], entry = build_index(rng, chunks, n_keys)
    table = index.table
    block_rounds = float(table.block_max_probe().mean())
    result.update(n_keys=index.n_unique, buckets=table.n_buckets,
                  table_gb=table.nbytes / 1e9, max_probe=table.max_probe,
                  block_rounds_mean=block_rounds)
    log(f"BUILD {result.get('build_s', 0.0):.1f} s: {table.n_buckets} buckets, table "
        f"{table.nbytes / 1e9:.2f} GB, max_probe={table.max_probe}, block rounds mean "
        f"{block_rounds:.4f} (RSS {rss_gb():.1f} GB)")
    result["rss_build_gb"] = rss_gb()
    buf = buf_env or pipeline.device_buf(table.n_buckets)
    result["buf_mi"] = buf >> 20
    if buf > draw:
        chunks = merge_chunks(chunks, buf)
        log(f"the pipeline's buffer for {table.n_buckets} buckets: the {steps} draws as "
            f"{len(chunks)} chunks of up to {buf >> 20} Mi bases")

    if "build_s" in result:  # phase 2: the file that convert-index writes
        t = time.perf_counter()
        index.to_file(path)
        result["save_s"] = time.perf_counter() - t
        result["disk_gb"] = os.path.getsize(path) / 1e9
        t = time.perf_counter()
        loaded = KmerIndex.from_file(path)
        result["load_s"] = time.perf_counter() - t
        if loaded.n_unique != index.n_unique or not np.array_equal(
                loaded.table.key_lo, table.key_lo):
            raise AssertionError("scale_drill: the loaded index differs from the saved one")
        del loaded
        result["rss_file_gb"] = rss_gb()
        log(f"SAVE {result['save_s']:.1f} s ({result['disk_gb']:.2f} GB on disk), LOAD "
            f"{result['load_s']:.1f} s (RSS {result['rss_file_gb']:.1f} GB)")

    if not skip_device:
        result.update(device_phases(index, entry, chunks, buf, device))
        result["rss_device_gb"] = rss_gb()
    print("RESULT " + " ".join(f"{key}={value}" for key, value in result.items()),
          flush=True)
    return result


if __name__ == "__main__":
    main()
