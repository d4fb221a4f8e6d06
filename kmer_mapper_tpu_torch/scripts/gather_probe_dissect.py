"""The gather probe's design points, each switched to its other side: the
measurement behind the design of ``csrc/gather_probe.cu``.

    python -m kmer_mapper_tpu_torch.scripts.gather_probe_dissect [variant ...]

:func:`slots_variant` and :func:`count_variant` launch
``csrc/gather_probe_dissect.cu``, which computes what ``ops.probe``'s
kernel computes with each design point switchable by an option bit (0 is
the library path's design); two more points are the caller's arguments.
The variants:

    library          the library path's kernel itself (``ops.probe``)
    baseline         this kernel with no bit set: the library path's design
    plain_streams    queries loaded and slots stored with no evict-first hint
    plain_table      lo rows under the normal L2 policy, not evict-last
    normal_hits      hi words and count adds under the normal L2 policy,
                     not evict-first
    no_aggregate     counts: one add a hit, no warp aggregation
    four_per_thread  four queries a thread, their first rounds' row loads
                     issued before any compare
    no_bounds        no block bounds: every query walks max_probe rounds
    valid_array      counts: an all-true valid array, not a null pointer
    all              every bit switched and no block bounds

``main`` builds a table of the bench index's size and load (``BENCH_KEYS``
random keys in ``BENCH_BUCKETS`` buckets) and one ten times the card's L2
(``LARGE_KEYS`` in ``LARGE_BUCKETS``). It times every variant in both
modes, warm (back to back) and cold (after an L2 flush), on ``N_QUERIES``
queries of two batches on the bench-sized table: half hits, and skewed (a
quarter one key, the rest half hits). Then it times the four pairs of L2
policies (lo rows evict-last or normal, hits evict-first or normal) on the
large table and on tables of ``SWEEP_BUCKETS`` buckets at the bench load,
each with a half-hit and a miss-only batch. Every variant's slots and
counts must equal the library path's kernel (``--device cpu``: its twin),
or the script raises.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from .. import native
from ..index import layout
from ..ops import probe
from . import cold_ms, device_arg, device_name, median_ms, pick_device

#: option bits of ``csrc/gather_probe_dissect.cu``
PLAIN_STREAMS, PLAIN_TABLE, NO_AGGREGATE, FOUR_PER_THREAD, NORMAL_HITS = 1, 2, 4, 8, 16
ALL_OPTIONS = 31
#: variant: (option bits, None for the library path's kernel; block bounds
#: passed; valid array passed)
VARIANTS = {
    "library": (None, True, False),
    "baseline": (0, True, False),
    "plain_streams": (PLAIN_STREAMS, True, False),
    "plain_table": (PLAIN_TABLE, True, False),
    "normal_hits": (NORMAL_HITS, True, False),
    "no_aggregate": (NO_AGGREGATE, True, False),
    "four_per_thread": (FOUR_PER_THREAD, True, False),
    "no_bounds": (0, False, False),
    "valid_array": (0, True, True),
    "all": (ALL_OPTIONS, False, False),
}
#: the pairs of L2 policies: lo rows, hits
POLICIES = {
    ("evict-last", "evict-first"): 0,
    ("normal", "evict-first"): PLAIN_TABLE,
    ("evict-last", "normal"): NORMAL_HITS,
    ("normal", "normal"): PLAIN_TABLE | NORMAL_HITS,
}
N_QUERIES = 1 << 24
BENCH_BUCKETS = 1 << 20  # the bench index: 2,583,023 keys in 2^20 buckets
BENCH_KEYS = 2_583_023
LARGE_BUCKETS = 1 << 23  # 537 MB of key words, ten times the L2
LARGE_KEYS = 1 << 24
SWEEP_BUCKETS = [1 << e for e in range(17, 20)]  # 4.2 ... 16.8 MB of lo words
SEED = 7

launch_counts = {"gather_probe_dissect": 0}


def _check_options(options: int) -> None:
    if not 0 <= options <= ALL_OPTIONS:
        raise ValueError(f"gather_probe_dissect: options={options} outside [0, {ALL_OPTIONS}]")


def _launch(mode, options, key_lo, key_hi, block_probe, queries, valid, counts, out,
            max_probe, seed):
    if key_lo.device.type != "cuda":
        raise ValueError(f"gather_probe_dissect: no kernel for device {key_lo.device}")
    rc = probe.launch_with(native.library().gather_probe_dissect_launch, mode, key_lo, key_hi,
                           block_probe, queries, valid, counts, out, max_probe, seed, options)
    if rc:
        raise RuntimeError(f"gather_probe_dissect kernel launch failed: "
                           f"{native.error_string(rc)}")
    launch_counts["gather_probe_dissect"] += 1


def slots_variant(options: int, key_lo, key_hi, queries, max_probe: int, seed: int, *,
                  block_probe=None) -> torch.Tensor:
    """:func:`ops.probe.probe_slots` under the option bits; CPU tensors run
    its twin."""
    _check_options(options)
    probe.check_args("slots_variant", key_lo, key_hi, queries, max_probe, block_probe)
    if key_lo.shape[0] * layout.BUCKET_KEYS > 1 << 31:
        raise ValueError("slots_variant: a table of more than 2**31 slots has slots past int32")
    if key_lo.device.type == "cpu":
        return probe.probe_slots_reference(key_lo, key_hi, queries, max_probe, seed,
                                           block_probe=block_probe)
    out = torch.empty(queries.shape[0], dtype=torch.int32, device=key_lo.device)
    _launch(1, options, key_lo, key_hi, block_probe, queries, None, None, out, max_probe, seed)
    return out


def count_variant(options: int, key_lo, key_hi, counts, queries, max_probe: int, seed: int, *,
                  block_probe=None, valid=None) -> torch.Tensor:
    """:func:`ops.probe.probe_count` under the option bits; CPU tensors run
    its twin."""
    _check_options(options)
    probe.check_args("count_variant", key_lo, key_hi, queries, max_probe, block_probe,
                     valid=valid, counts=counts)
    if key_lo.device.type == "cpu":
        return probe.probe_count_reference(key_lo, key_hi, counts, queries, max_probe, seed,
                                           block_probe=block_probe, valid=valid)
    _launch(0, options, key_lo, key_hi, block_probe, queries, valid, counts, None, max_probe,
            seed)
    return counts


def random_table(rng, n_keys: int, n_buckets: int, device):
    """(keys, table, key_lo, key_hi, block_probe): up to ``n_keys`` unique
    random keys built into ``n_buckets`` buckets, its words and block
    bounds on ``device``."""
    keys = np.unique(rng.integers(0, 1 << 62, n_keys, dtype=np.uint64))
    table = layout.build_table(keys, n_buckets=n_buckets)
    key_lo, key_hi = (torch.from_numpy(w.view(np.int32)).to(device)
                      for w in (table.key_lo, table.key_hi))
    return keys, table, key_lo, key_hi, torch.from_numpy(table.block_max_probe()).to(device)


def probe_batch(rng, keys, n: int, hit_share: float, hot_share: float = 0.0,
                device="cuda") -> torch.Tensor:
    """n raw int64 queries on ``device``, shuffled: ``hot_share`` of them one
    key, ``hit_share`` of the rest drawn from ``keys``, the others uniform."""
    n_hot = int(n * hot_share)
    n_hit = int((n - n_hot) * hit_share)
    q = np.concatenate([np.full(n_hot, keys[len(keys) // 3], np.uint64),
                        rng.choice(keys, n_hit),
                        rng.integers(0, 1 << 62, n - n_hot - n_hit, dtype=np.uint64)])
    q = torch.from_numpy(q.view(np.int64)).to(device)
    return q[torch.randperm(n, device=q.device)]


def time_variant(options, table, key_lo, key_hi, queries, device, *, block_probe,
                 valid=None, want=None) -> tuple[float, float, float, float]:
    """(slots warm, slots cold, counts warm, counts cold) ms of one variant
    (``options`` None: the library path's kernel); raises unless its slots
    and counts equal ``want`` (the library path's kernel's, computed here
    when not given)."""
    args = (key_lo, key_hi, queries, table.max_probe, table.seed)
    counts = torch.zeros(table.n_slots, dtype=torch.int32, device=device)
    if want is None:
        want = (probe.probe_slots(*args, block_probe=block_probe),
                probe.probe_count(key_lo, key_hi, torch.zeros_like(counts), queries,
                                  table.max_probe, table.seed, block_probe=block_probe))
    count_args = (key_lo, key_hi, counts, queries, table.max_probe, table.seed)

    def slots_fn():
        if options is None:
            return probe.probe_slots(*args, block_probe=block_probe)
        return slots_variant(options, *args, block_probe=block_probe)

    def count_fn():
        if options is None:
            return probe.probe_count(*count_args, block_probe=block_probe, valid=valid)
        return count_variant(options, *count_args, block_probe=block_probe, valid=valid)

    if not torch.equal(slots_fn(), want[0]):
        raise AssertionError(f"gather_probe_dissect: options {options} changed the slots")
    if not torch.equal(count_fn(), want[1]):
        raise AssertionError(f"gather_probe_dissect: options {options} changed the counts")
    return (median_ms(slots_fn, device), cold_ms(slots_fn, device),
            median_ms(count_fn, device), cold_ms(count_fn, device))


def design_points(variants, table, key_lo, key_hi, block_probe, queries, device,
                  what: str) -> dict:
    """Each variant's four times on one batch; prints one line each."""
    want = (probe.probe_slots(key_lo, key_hi, queries, table.max_probe, table.seed,
                              block_probe=block_probe),
            probe.probe_count(key_lo, key_hi,
                              torch.zeros(table.n_slots, dtype=torch.int32, device=device),
                              queries, table.max_probe, table.seed, block_probe=block_probe))
    ones = torch.ones(queries.numel(), dtype=torch.bool, device=device)
    print(f"design points on {what}, ms: slots warm, cold; counts warm, cold", flush=True)
    out = {}
    for name in variants:
        options, bounds, valid = VARIANTS[name]
        out[name] = t = time_variant(options, table, key_lo, key_hi, queries, device,
                                     block_probe=block_probe if bounds else None,
                                     valid=ones if valid else None, want=want)
        print(f"  {name:16s} slots {t[0]:8.4f} {t[1]:8.4f}   counts {t[2]:8.4f} {t[3]:8.4f}",
              flush=True)
    return out


def policies(table, key_lo, key_hi, block_probe, queries, device, what: str) -> dict:
    """The four pairs of L2 policies' times on one batch; prints one line
    each."""
    print(f"L2 policies on {what} ({table.key_lo.nbytes / 1e6:.1f} MB of lo words), ms: "
          "slots warm, cold; counts warm, cold", flush=True)
    out = {}
    for (rows, hits), options in POLICIES.items():
        out[rows, hits] = t = time_variant(options, table, key_lo, key_hi, queries, device,
                                           block_probe=block_probe)
        print(f"  rows {rows:10s} hits {hits:11s} slots {t[0]:8.4f} {t[1]:8.4f}   counts "
              f"{t[2]:8.4f} {t[3]:8.4f}", flush=True)
    return out


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("variants", nargs="*", default=list(VARIANTS),
                        help=f"variants to time (default: all of {', '.join(VARIANTS)})")
    device_arg(parser)
    a = parser.parse_args(argv)
    bad = [v for v in a.variants if v not in VARIANTS]
    if bad:
        parser.error(f"unknown variants {bad}")
    device = pick_device(a.device)
    rng = np.random.default_rng(SEED)
    print(f"gather_probe_dissect on {device_name(device)}: {N_QUERIES} queries", flush=True)
    result = {"design": {}, "policies": {}}
    keys, table, key_lo, key_hi, block_probe = random_table(rng, BENCH_KEYS, BENCH_BUCKETS,
                                                            device)
    for what, hit_share, hot_share in (("half hits", 0.5, 0.0),
                                       ("skewed: a quarter one key", 0.5, 0.25)):
        batch = probe_batch(rng, keys, N_QUERIES, hit_share, hot_share, device)
        what = f"{table.n_buckets} buckets, {what}"
        result["design"][what] = design_points(a.variants, table, key_lo, key_hi, block_probe,
                                               batch, device, what)
    for n_keys, n_buckets in [(LARGE_KEYS, LARGE_BUCKETS)] + [
            (round(BENCH_KEYS * b / BENCH_BUCKETS), b) for b in SWEEP_BUCKETS]:
        keys, table, key_lo, key_hi, block_probe = random_table(rng, n_keys, n_buckets, device)
        for what, hit_share in (("half hits", 0.5), ("miss-only", 0.0)):
            batch = probe_batch(rng, keys, N_QUERIES, hit_share, device=device)
            what = f"{n_buckets} buckets, {what}"
            result["policies"][what] = policies(table, key_lo, key_hi, block_probe, batch,
                                                device, what)
        del key_lo, key_hi, block_probe, batch
        if device.type == "cuda":
            torch.cuda.empty_cache()
    return result


if __name__ == "__main__":
    main()
