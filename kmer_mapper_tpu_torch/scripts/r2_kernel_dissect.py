"""Dissect the stream count, one CTA per chain block: the port's
counterpart of ``scripts/r2_kernel_dissect.py``.

    python -m kmer_mapper_tpu_torch.scripts.r2_kernel_dissect [variant ...]

``stream_count_v`` launches ``csrc/r2_kernel_dissect.cu``, the count of
``csrc/stream_count.cu`` (one CTA per chain block on the padded,
fingerprinted tile of ``csrc/count_tile.cuh``) with one part removed per
variant, so that the times of the variants split the kernel's time into
table staging, bucket addressing, the fingerprinted compare, the atomics
and the query loads:

    full        the count itself (equals ``stream_probe.stream_count``)
    nomm2       each hit of key lane k, in any round, adds 1 to slot
                (bucket 0 of the block, lane k): no per-slot hit addressing
    nomm1       every live query adds 1 to all 8 slots of its own bucket
                for each of its rounds: no compare (the Pallas variant does
                not roll its count tile by the round either)
    nohot       round p compares each live query with bucket p of its block
                and counts hits there: no bucket addressing
    nodma       the query at sorted position i is the key stored in slot
                ``i mod (bpb * 8)`` of its block's staged keys: no query loads
    empty       counts unchanged; the key tile is still staged
    empty_notb  counts unchanged, nothing staged: the grid and window bounds
    tbhoist     runs as full (see ``VARIANTS``)

A query is live when it is not the all-ones pair and its bucket lies in its
block; it walks ``max(1, min(max_probe, block_probe[b]))`` rounds, as the
Pallas kernel does. ``hazard_cases`` are the inputs that the variants are
held to their twin on besides the script's. ``main`` builds the script's
inputs (4,000,000 uniform keys, 16 Mi queries of which half are drawn from
the keys) and prints one line per variant: the median of 5 CUDA-event times
and ns per query.
"""
from __future__ import annotations

import argparse
import dataclasses

import numpy as np
import torch

from .. import native
from ..index import layout
from ..index.layout import BUCKET_KEYS
from ..ops import stream_count_cases, stream_probe
from ..ops.stream_count_cases import Case
from ..ops.u32hash import MASK32, bucket_from_mlo_torch, from_int32_bits, to_int32_bits
from . import device_arg, device_name, median_ms, pick_device

#: kernel variant -> its id in csrc/block_count.cuh; ``nomm1_rolled`` is
#: r2_window_dissect's nomm1, which adds round p's counts at bucket local + p
KERNEL_IDS = {"full": 0, "nomm2": 1, "nomm1": 2, "nohot": 3, "nodma": 4,
              "empty": 5, "empty_notb": 6, "nomm1_rolled": 7}
#: this script's variants -> the kernel variant that runs. The Pallas
#: ``tbhoist`` stages the key tile's byte planes once per program instead of
#: once per block; it does not trace (scripts/r2_kernel_dissect.py:75 indexes
#: a value with ``pl.ds``). Its function is full's, and a CTA here stages its
#: block's keys once already, so it runs as full.
VARIANTS = {v: v for v in ("full", "nomm2", "nomm1", "nohot", "nodma", "empty",
                           "empty_notb")} | {"tbhoist": "full"}
#: chain blocks per program of the Pallas grid, which has n_blocks // COARSE
#: programs
COARSE = 8
N_KEYS = 4_000_000
N_QUERIES = 16 << 20

#: kernel launches and twin calls since import; a run that must show which
#: one counted resets them first
launch_counts = {"r2_kernel_dissect": 0, "r2_kernel_dissect_reference": 0}


def canonical(variant: str, variants=VARIANTS) -> str:
    """The kernel variant that runs for a script's ``variant``."""
    if variant not in variants:
        raise ValueError(f"unknown variant {variant!r}; expected one of {tuple(variants)}")
    return variants[variant]


def check_blocks(n_blocks: int, name: str) -> None:
    """The Pallas grid runs n_blocks // COARSE programs of COARSE blocks and
    drops the rest, so a result for other tables could not be held to it."""
    if n_blocks % COARSE:
        raise ValueError(
            f"{name}: {n_blocks} chain blocks is not a multiple of {COARSE}; the TPU "
            f"kernel's grid (n_blocks // {COARSE}) would drop the last "
            f"{n_blocks % COARSE}, so this table has no reference result"
        )


def stream_count_v(key_lo, key_hi, counts, sorted_keys, off, block_probe,
                   shift: int, bpb: int, max_probe: int, variant: str) -> torch.Tensor:
    """counts += the variant's contribution of the sorted queries, in place;
    returns ``counts``. Arguments as ``stream_probe.stream_count``, plus the
    table's chain bound ``max_probe`` and the variant's name.

    CUDA tensors launch ``csrc/r2_kernel_dissect.cu`` (a failed build or
    launch raises); CPU tensors run :func:`stream_count_v_reference`."""
    name = "r2_kernel_dissect"
    v = canonical(variant)
    stream_probe.check_count_args(key_lo, key_hi, counts, sorted_keys, off,
                                  block_probe, shift, bpb, name)
    check_blocks(block_probe.shape[0], name)
    if max_probe < 1:
        raise ValueError(f"{name}: max_probe={max_probe} < 1")
    if counts.device.type == "cpu":
        return stream_count_v_reference(key_lo, key_hi, counts, sorted_keys, off,
                                        block_probe, shift, bpb, max_probe, variant)
    if counts.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {counts.device}")
    if key_lo.data_ptr() % 16 or key_hi.data_ptr() % 16:
        raise ValueError(f"{name}: the key words must start on 16 bytes (16-byte copies)")
    fn = native.library().r2_kernel_dissect_launch
    with torch.cuda.device(counts.device):
        rc = fn(
            key_lo.data_ptr(), key_hi.data_ptr(), counts.data_ptr(),
            sorted_keys.data_ptr(), off.data_ptr(), block_probe.data_ptr(),
            block_probe.shape[0], shift, bpb, max_probe, KERNEL_IDS[v],
            counts.device.index, torch.cuda.current_stream().cuda_stream,
        )
    if rc:
        raise RuntimeError(f"{name} kernel launch failed: {native.error_string(rc)}")
    launch_counts[name] += 1
    return counts


def stream_count_v_reference(key_lo, key_hi, counts, sorted_keys, off, block_probe,
                             shift: int, bpb: int, max_probe: int,
                             variant: str) -> torch.Tensor:
    """Plain-torch twin of the kernel (same contract, same result)."""
    launch_counts["r2_kernel_dissect_reference"] += 1
    return variant_twin(key_lo, key_hi, counts, sorted_keys, off, block_probe,
                        bpb, max_probe, canonical(variant))


def variant_twin(key_lo, key_hi, counts, sorted_keys, off, block_probe,
                 bpb: int, max_probe: int, variant: str) -> torch.Tensor:
    """What every variant computes, in plain torch: for each live query,
    walk its rounds with a row gather and an 8-lane compare, send each hit
    (or, for nomm1, each round) to the variant's slots, and add them into
    ``counts`` with wrapping 32-bit arithmetic. ``variant`` is a kernel
    variant (a key of ``KERNEL_IDS``); the twins of both r2 kernels use it."""
    v = variant
    if v not in KERNEL_IDS:
        raise ValueError(f"unknown kernel variant {v!r}")
    if v in ("empty", "empty_notb"):
        return counts
    dev = counts.device
    n_buckets, n_blocks = key_lo.shape[0], block_probe.shape[0]
    tile = bpb * BUCKET_KEYS
    off64 = off.to(torch.int64)
    first, last = int(off64[0]), int(off64[-1])
    block = torch.repeat_interleave(torch.arange(n_blocks, device=dev), off64[1:] - off64[:-1])
    if v == "nodma":
        slot = block * tile + (torch.arange(first, last, device=dev) & (tile - 1))
        m_lo = from_int32_bits(key_lo.reshape(-1)[slot])
        m_hi = from_int32_bits(key_hi.reshape(-1)[slot])
    else:
        m_lo, m_hi = stream_probe.split_key(sorted_keys[first:last])
    local = bucket_from_mlo_torch(m_lo, n_buckets) - block * bpb
    live = ~((m_lo == stream_probe.INVALID_WORD) & (m_hi == stream_probe.INVALID_WORD))
    live &= (local >= 0) & (local < bpb)
    rounds = block_probe.to(torch.int64).clamp(min=1, max=max_probe)[block]
    q_lo, q_hi = to_int32_bits(m_lo), to_int32_bits(m_hi)
    lanes = torch.arange(BUCKET_KEYS, device=dev)
    hits = torch.zeros(n_buckets * BUCKET_KEYS, dtype=torch.int64, device=dev)
    for p in range(int(rounds.max()) if rounds.numel() else 0):
        sel = torch.nonzero(live & (p < rounds)).squeeze(1)
        if sel.numel() == 0:
            continue
        row = {"nohot": torch.full_like(sel, p), "nomm1": local[sel]}.get(v, local[sel] + p)
        b = block[sel] * bpb + (row & (bpb - 1))
        if v in ("nomm1", "nomm1_rolled"):
            slots = (b[:, None] * BUCKET_KEYS + lanes).reshape(-1)
        else:
            match = (key_lo[b] == q_lo[sel, None]) & (key_hi[b] == q_hi[sel, None])
            r, lane = torch.nonzero(match, as_tuple=True)
            dst = block[sel][r] * bpb if v == "nomm2" else b[r]
            slots = dst * BUCKET_KEYS + lane
        hits.index_add_(0, slots, torch.ones_like(slots))
    total = (counts.to(torch.int64) & MASK32) + hits
    counts.copy_(to_int32_bits(total & MASK32))
    return counts


def one_key_case(seed: int = 7) -> Case:
    """A chained table of 1024 buckets (8 chain blocks) in which every other
    bucket holds its lane 0's key in all 8 lanes (all-ones where lane 0 is
    empty), so that a query of such a key hits 8 slots of one bucket, and
    the other buckets keep their empty (all-ones) slots. The host oracle
    (``layout.query_table``) finds one slot a query, so this case has no
    ``expected`` counts: it holds a kernel to its twin."""
    rng = np.random.default_rng(seed)
    keys = np.unique(rng.integers(0, 1 << 62, 3000, dtype=np.uint64))
    table = layout.build_table(keys, n_buckets=1024)
    key_lo, key_hi = table.key_lo.copy(), table.key_hi.copy()
    key_lo[::2], key_hi[::2] = key_lo[::2, :1], key_hi[::2, :1]
    table = dataclasses.replace(table, key_lo=key_lo, key_hi=key_hi)
    queries = np.concatenate([rng.choice(keys, 4000),
                              rng.integers(0, 1 << 62, 1000, dtype=np.uint64)])
    counts0 = rng.integers(0, 1 << 32, table.n_slots, dtype=np.int64).astype(np.uint32)
    return Case("one_key_buckets", table, queries, rng.random(len(queries)) < 0.9, counts0)


def hazard_cases() -> list[Case]:
    """The inputs the variants are held to their twin on: each case of
    ``ops.stream_count_cases`` whose table the TPU grid takes (a block count
    that is a multiple of ``COARSE``; every such table has empty slots,
    whose fingerprint nibble is 0), then :func:`one_key_case`."""
    def n_blocks(case):
        return case.table.n_buckets // min(layout.CHAIN_BLOCK, case.table.n_buckets)

    table_cases = [c for c in stream_count_cases.cases() if n_blocks(c) % COARSE == 0]
    return table_cases + [one_key_case()]


def make_inputs(device):
    """The script's inputs: (stream_count's arguments, max_probe). A table
    of ``N_KEYS`` uniform random keys built by ``layout.build_table``, and
    ``N_QUERIES`` queries, half drawn from the keys, sorted on ``device``."""
    rng = np.random.default_rng(0)
    keys = np.unique(rng.integers(0, 1 << 62, N_KEYS, dtype=np.uint64))
    table = layout.build_table(keys)
    queries = np.concatenate([
        rng.choice(keys, N_QUERIES // 2),
        rng.integers(0, 1 << 62, N_QUERIES - N_QUERIES // 2, dtype=np.uint64),
    ])
    case = Case("r2_kernel_dissect", table, queries, np.ones(len(queries), bool),
                np.zeros(table.n_slots, np.uint32))
    return case.inputs(device), table.max_probe


def run(args, max_probe: int, variants, device) -> dict[str, float]:
    """Median ms of each variant on ``args`` (stream_count's arguments);
    prints one line per variant."""
    key_lo, key_hi, counts, sorted_keys, off, block_probe, shift, bpb = args
    n = sorted_keys.shape[0]
    out = {}
    for variant in variants:
        c = counts.clone()
        out[variant] = ms = median_ms(
            lambda: stream_count_v(key_lo, key_hi, c, sorted_keys, off, block_probe,
                                   shift, bpb, max_probe, variant),
            device,
        )
        alias = f" (runs {VARIANTS[variant]})" if VARIANTS[variant] != variant else ""
        print(f"{variant:10s} {ms:9.4f} ms  {ms * 1e6 / max(n, 1):8.4f} ns/query{alias}",
              flush=True)
    return out


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("variants", nargs="*", default=list(VARIANTS),
                        help=f"variants to time (default: all of {', '.join(VARIANTS)})")
    device_arg(parser)
    a = parser.parse_args(argv)
    for v in a.variants:
        canonical(v)
    device = pick_device(a.device)
    args, max_probe = make_inputs(device)
    n_buckets = args[0].shape[0]
    print(f"r2_kernel_dissect on {device_name(device)}: {n_buckets} buckets, "
          f"max_probe {max_probe}, {args[3].shape[0]} queries", flush=True)
    return {"ms": run(args, max_probe, a.variants, device), "args": args,
            "max_probe": max_probe}


if __name__ == "__main__":
    main()
