"""Dissect the stream count in context, over a flat tile schedule: the
port's counterpart of ``scripts/r2_window_dissect.py``.

    python -m kmer_mapper_tpu_torch.scripts.r2_window_dissect [variant ...]

``stream_count_v`` launches ``csrc/r2_window_dissect.cu`` with one CTA per
``CAP``-query tile of the flat schedule that ``tile_schedule`` builds on the
device: each chain block's window, from its start rounded down to ``ALIGN``,
cut into ``ceil((end - base) / CAP)`` tiles. A long (poly-A) window is thus
spread over many CTAs, where ``stream_probe.stream_count`` gives each block
one. The variants full, nodma and empty compute what the same variants of
``r2_kernel_dissect`` compute; this script's nomm1 adds round p's counts at
bucket ``(local + p) & (bpb - 1)``, as its Pallas variant rolls them.

``main`` runs them where the main path would: 3 distinct chunks of random
151-bp reads packed continuously into 16 Mi-base buffers, the ragged step
(rolling hash, read-boundary mask, Feistel mix, sort, block offsets), then
the variant, 8 steps a window, against the bench index (2M uniform keys and
2M drawn from the first 5000 reads' k-mers). It prints ms per chunk and
k-mers per second for each variant, and a row with the main path's
per-block ``stream_probe.stream_count`` in the same place, on the main
path's offsets (``stream_probe.count_offsets``: windows end at the invalid
tail). The variants take ``block_offsets``, whose last window holds the
invalid tail, as the Pallas script's schedule does.
"""
from __future__ import annotations

import argparse
import dataclasses
import statistics
import time

import numpy as np
import torch

from .. import native, oracle
from ..index.kmer_index import KmerIndex
from ..index.layout import CHAIN_BLOCK
from ..io.readers import SequenceChunk, pack_for_device
from ..ops import hashing, stream_probe
from ..ops.u32hash import bucket_shift, from_int32_bits
from . import device_arg, device_name, pick_device
from .r2_kernel_dissect import KERNEL_IDS, canonical, check_blocks, variant_twin

#: this script's variants -> the kernel variant that runs
VARIANTS = {"full": "full", "nomm1": "nomm1_rolled", "nodma": "nodma", "empty": "empty"}
CAP = 1024  # queries per tile
ALIGN = 128  # a window's first tile starts at a multiple of min(ALIGN, CAP)
K, READ_LEN, BUF = 31, 151, 16 << 20
STEPS = 8  # chunk steps in a timed window
N_CHUNKS = 3
N_WINDOWS = 3
INDEX_UNIFORM = 2_000_000
INDEX_FROM_READS = 2_000_000
#: the row of ``main`` that runs the main path's per-block kernel
PER_BLOCK = "stream_count"

launch_counts = {"r2_window_dissect": 0, "r2_window_dissect_reference": 0}


def n_tiles_bound(n_queries: int, n_blocks: int, cap: int = CAP) -> int:
    """An upper bound of the schedule's tile count from the sizes alone: a
    window of length L takes at most ceil(L / cap) + 1 tiles (one more for
    its start rounded down to ALIGN), and the lengths sum to at most
    n_queries, so ceil(n / cap) + 2 * n_blocks tiles always suffice. The
    Pallas script sizes its schedule one tile per block tighter
    (``(n + pad) // CAP + n_blocks``); the extra CTAs here exit at once."""
    return -(-n_queries // cap) + 2 * n_blocks


def tile_schedule(off: torch.Tensor, n_queries: int, cap: int = CAP):
    """(t_group int32, t_off int64) of ``n_tiles_bound`` tiles, built with
    torch ops on ``off``'s device (no host sync): tile t serves chain block
    ``t_group[t]`` from sorted position ``t_off[t]``; tiles past the last one
    have ``t_group == n_blocks``. The schedule of scripts/r2_window_dissect.py
    ``:143-153``."""
    n_blocks = off.shape[0] - 1
    dev = off.device
    off64 = off.to(torch.int64)
    starts, ends = off64[:-1], off64[1:]
    bases = starts & ~(min(ALIGN, cap) - 1)
    nt = torch.where(ends > starts, (ends - bases + cap - 1) // cap, 0)
    csum = torch.cat([torch.zeros(1, dtype=torch.int64, device=dev), torch.cumsum(nt, 0)])
    t = torch.arange(n_tiles_bound(n_queries, n_blocks, cap), device=dev)
    t_group = torch.searchsorted(csum[1:], t, right=True)
    t_in = t - csum[t_group.clamp(max=n_blocks)]
    t_off = bases[t_group.clamp(max=n_blocks - 1)] + t_in * cap
    return t_group.to(torch.int32), t_off


def stream_count_v(key_lo, key_hi, counts, sorted_keys, off, block_probe,
                   shift: int, bpb: int, max_probe: int, variant: str,
                   cap: int = CAP) -> torch.Tensor:
    """counts += the variant's contribution of the sorted queries, in place;
    returns ``counts``. Arguments as ``r2_kernel_dissect.stream_count_v``,
    plus the tile size.

    CUDA tensors launch ``csrc/r2_window_dissect.cu`` (a failed build or
    launch raises); CPU tensors run :func:`stream_count_v_reference`."""
    name = "r2_window_dissect"
    v = canonical(variant, VARIANTS)
    stream_probe.check_count_args(key_lo, key_hi, counts, sorted_keys, off,
                                  block_probe, shift, bpb, name)
    check_blocks(block_probe.shape[0], name)
    if max_probe < 1 or cap < 1:
        raise ValueError(f"{name}: max_probe={max_probe}, cap={cap}: both must be >= 1")
    if counts.device.type == "cpu":
        return stream_count_v_reference(key_lo, key_hi, counts, sorted_keys, off,
                                        block_probe, shift, bpb, max_probe, variant)
    if counts.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {counts.device}")
    t_group, t_off = tile_schedule(off, sorted_keys.shape[0], cap)
    fn = native.library().r2_window_dissect_launch
    with torch.cuda.device(counts.device):
        rc = fn(
            key_lo.data_ptr(), key_hi.data_ptr(), counts.data_ptr(),
            sorted_keys.data_ptr(), off.data_ptr(), block_probe.data_ptr(),
            t_group.data_ptr(), t_off.data_ptr(), t_group.shape[0],
            block_probe.shape[0], shift, bpb, max_probe, cap, KERNEL_IDS[v],
            counts.device.index, torch.cuda.current_stream().cuda_stream,
        )
    if rc:
        raise RuntimeError(f"{name} kernel launch failed: {native.error_string(rc)}")
    launch_counts[name] += 1
    return counts


def stream_count_v_reference(key_lo, key_hi, counts, sorted_keys, off, block_probe,
                             shift: int, bpb: int, max_probe: int,
                             variant: str) -> torch.Tensor:
    """Plain-torch twin of the kernel: the tile split changes no count, so
    it is ``r2_kernel_dissect``'s twin of the same kernel variant."""
    launch_counts["r2_window_dissect_reference"] += 1
    return variant_twin(key_lo, key_hi, counts, sorted_keys, off, block_probe,
                        bpb, max_probe, canonical(variant, VARIANTS))


@dataclasses.dataclass
class Context:
    """The device-resident chunks and table of the in-context run."""

    index: KmerIndex
    key_lo: torch.Tensor
    key_hi: torch.Tensor
    block_probe: torch.Tensor
    chunks: list  # (int64-held packed words, int64 lengths, n_bases)
    buf: int

    @property
    def n_buckets(self) -> int:
        return self.index.table.n_buckets

    def sorted_chunk(self, i: int, main_path: bool = False):
        """The ragged step up to the count for chunk i: (sorted keys, block
        offsets, number of valid windows as a device scalar). The offsets
        are ``block_offsets``, or with ``main_path`` the count's
        ``count_offsets``, which end the last window at the invalid tail."""
        words, lengths, n_bases = self.chunks[i % len(self.chunks)]
        lo, hi = hashing.rolling_kmer_hash_packed(words, K)
        starts = torch.cumsum(lengths, 0) - lengths
        valid = hashing.window_mask(starts, n_bases, K, self.buf)
        keys = stream_probe.sort_queries(lo, hi, valid, self.index.table.seed)
        bpb = min(CHAIN_BLOCK, self.n_buckets)
        offsets = stream_probe.count_offsets if main_path else stream_probe.block_offsets
        return keys, offsets(keys, self.n_buckets, bpb), valid.sum()

    def count_args(self, counts, keys, off) -> tuple:
        """``stream_probe.stream_count``'s arguments for these sorted keys."""
        bpb = min(CHAIN_BLOCK, self.n_buckets)
        return (self.key_lo, self.key_hi, counts, keys, off, self.block_probe,
                bucket_shift(self.n_buckets), bpb)


def make_context(device) -> Context:
    """Random 151-bp reads packed continuously (``pack_for_device`` without
    ``read_len``) into ``N_CHUNKS`` buffers of ``BUF`` bases, and the bench
    index: ``INDEX_UNIFORM`` uniform keys plus ``INDEX_FROM_READS`` keys
    drawn from the first 5000 reads' k-mers, node ids below 3M."""
    rng = np.random.default_rng(0)
    lut = np.frombuffer(b"ACGT", dtype=np.uint8)
    n_reads = BUF // READ_LEN
    chunks = []
    for _ in range(N_CHUNKS):
        bases = lut[rng.integers(0, 4, n_reads * READ_LEN, dtype=np.uint8)]
        chunks.append(SequenceChunk(bases=bases, read_starts=np.arange(n_reads) * READ_LEN))
    sample = oracle.kmer_hashes(
        oracle.encode_bytes(chunks[0].bases[: READ_LEN * 5000]), K)
    entry = np.unique(np.concatenate([
        rng.integers(0, 1 << 62, INDEX_UNIFORM, dtype=np.uint64),
        rng.choice(sample, INDEX_FROM_READS),
    ]))
    index = KmerIndex.from_entries(entry, rng.integers(0, 3_000_000, len(entry)))
    table = index.table

    def words(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.uint32).view(np.int32)).to(device)

    resident = []
    for chunk in chunks:
        (packed, lengths, n_bases, _, _), = pack_for_device(iter([chunk]), BUF, BUF // 64, K)
        resident.append((from_int32_bits(words(packed)),
                         torch.from_numpy(lengths.astype(np.int64)).to(device), n_bases))
    return Context(index, words(table.key_lo), words(table.key_hi),
                   torch.from_numpy(table.block_max_probe()).to(device), resident, BUF)


def run(ctx: Context, variants, device) -> dict[str, tuple[float, float]]:
    """(ms per chunk, k-mers per second) of each variant (or ``PER_BLOCK``)
    in the composed step, ``STEPS`` chunks a window, the median of
    ``N_WINDOWS`` windows after a warm-up window; prints one line each."""
    max_probe = ctx.index.table.max_probe
    counts = torch.zeros(ctx.index.table.n_slots, dtype=torch.int32, device=device)
    out = {}
    for variant in variants:
        def window(v=variant):
            total = 0
            for i in range(STEPS):
                keys, off, n_valid = ctx.sorted_chunk(i, main_path=v == PER_BLOCK)
                args = ctx.count_args(counts, keys, off)
                if v == PER_BLOCK:
                    stream_probe.stream_count(*args)
                else:
                    stream_count_v(*args, max_probe, v)
                total = total + n_valid
            return int(total)  # waits for the window's work

        window()
        times, n_kmers = [], 0
        for _ in range(N_WINDOWS):
            t0 = time.perf_counter()
            n_kmers = window()
            times.append(time.perf_counter() - t0)
        sec = statistics.median(times)
        out[variant] = (sec / STEPS * 1e3, n_kmers / sec)
        print(f"{variant:12s} {sec / STEPS * 1e3:8.3f} ms/chunk  "
              f"{n_kmers / sec / 1e6:8.1f} Mk/s", flush=True)
    return out


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("variants", nargs="*", default=[*VARIANTS, PER_BLOCK],
                        help=f"variants to time (default: {', '.join(VARIANTS)} "
                             f"and {PER_BLOCK})")
    device_arg(parser)
    a = parser.parse_args(argv)
    for v in a.variants:
        if v != PER_BLOCK:
            canonical(v, VARIANTS)
    device = pick_device(a.device)
    ctx = make_context(device)
    print(f"r2_window_dissect on {device_name(device)}: {ctx.n_buckets} buckets, "
          f"max_probe {ctx.index.table.max_probe}, {len(ctx.chunks)} chunks of "
          f"{BUF} bases, {STEPS} steps a window", flush=True)
    return {"per_chunk": run(ctx, a.variants, device), "context": ctx}


if __name__ == "__main__":
    main()
