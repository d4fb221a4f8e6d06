"""The block partition's first design, the cursor route, timed beside the
main path's radix route: the measurement behind the design of
``csrc/block_partition.cu``.

    python -m kmer_mapper_tpu_torch.scripts.partition_dissect [--keys N]

:func:`cursor_partition` launches ``csrc/partition_dissect.cu``, which
computes what ``ops.block_partition.block_partition`` computes (the keys
grouped by chain block and each block's window; the order inside a window
unspecified) in two kernels: ``block_histogram`` (warp-aggregated atomics
on one bin a chain block) and ``block_scatter`` (returning atomics on a
cursor array in device memory). The variants:

    cursor            the histogram in shared memory where its bins fit
                      (:data:`SHARED_BINS`), else in device memory
    device_histogram  the histogram in device memory on every table

:func:`report` times on the same keys the main path's partition, each
variant whole and in its kernels, the twin and ``torch.sort`` +
``count_offsets``; each variant's result must equal the twin's (offsets
exact, windows equal as multisets), or it raises. :func:`radix_pass_ms`
times the main path's kernels pass by pass at a slab count of the
caller's. ``main`` runs both on ``N_KEYS`` random keys for tables of each
of ``BUCKETS`` buckets, the passes at the main path's slab count (one wave
of the histogram kernel) and at one CTA an SM.
"""
from __future__ import annotations

import argparse

import torch

from .. import native
from ..ops import block_partition as bp
from ..ops import stream_probe
from . import device_arg, device_name, median_ms, pick_device

#: variant: where the histogram counts (None: in shared memory where the
#: bins fit)
VARIANTS = {"cursor": None, "device_histogram": False}
#: histogram bins (chain blocks + 1) that ``block_histogram`` counts in
#: shared memory, 48 KB of int32 (``kSharedBins`` of
#: ``csrc/partition_dissect.cu``)
SHARED_BINS = 12288
N_KEYS = 53_775_909  # the keys of one 64 Mi-base chunk of 151-bp reads, k=31
BUCKETS = [1 << 20, 1 << 25, 1 << 29]  # the bench index, a human-scale index, 2^29
SEED = 9

#: kernel launches and twin calls since import; a run that must show which
#: one ran resets them first
launch_counts = {"partition_dissect": 0, "partition_dissect_reference": 0}


def _launch(name: str, fn, device: torch.device, *args) -> None:
    with torch.cuda.device(device):
        rc = fn(*args, device.index, torch.cuda.current_stream().cuda_stream)
    if rc:
        raise RuntimeError(f"{name} kernel launch failed: {native.error_string(rc)}")
    launch_counts["partition_dissect"] += 1


def block_histogram(keys: torch.Tensor, n_blocks: int, shared: bool | None = None):
    """int32[n_blocks + 1]: the keys of each chain block, then the invalid
    keys, from one launch of ``block_histogram_kernel`` (none for no keys).
    ``shared`` picks where it counts (None: in shared memory where the bins
    fit, :data:`SHARED_BINS`)."""
    hist = torch.zeros(n_blocks + 1, dtype=torch.int32, device=keys.device)
    if not keys.numel():
        return hist
    if shared is None:
        shared = n_blocks + 1 <= SHARED_BINS
    _launch("block_histogram", native.library().block_histogram_launch, keys.device,
            keys.data_ptr(), keys.shape[0], hist.data_ptr(), n_blocks.bit_length() - 1,
            int(shared))
    return hist


def block_scatter(keys: torch.Tensor, cursor: torch.Tensor, n_blocks: int) -> torch.Tensor:
    """The keys, each written into its bin's window from one launch of
    ``block_scatter_kernel`` (none for no keys): ``cursor`` (int32[n_blocks
    + 1], each bin's first slot) is advanced in place."""
    out = torch.empty_like(keys)
    if not keys.numel():
        return out
    _launch("block_scatter", native.library().block_scatter_launch, keys.device,
            keys.data_ptr(), keys.shape[0], cursor.data_ptr(), out.data_ptr(),
            n_blocks.bit_length() - 1)
    return out


def cursor_partition(keys: torch.Tensor, n_buckets: int, bpb: int, variant: str = "cursor"):
    """(grouped keys, off) as ``block_partition`` gives them, from the
    variant's kernels (:func:`cursor_kernels`). CUDA tensors launch the
    kernels (a failed build or launch raises); CPU tensors run
    :func:`cursor_partition_reference`."""
    if variant not in VARIANTS:
        raise ValueError(f"unknown variant {variant!r}; expected one of {tuple(VARIANTS)}")
    n_blocks = bp.check_partition_args(keys, n_buckets, bpb)
    if keys.device.type == "cpu":
        return cursor_partition_reference(keys, n_buckets, bpb)
    return cursor_kernels(keys, n_blocks, VARIANTS[variant])


def cursor_kernels(keys: torch.Tensor, n_blocks: int, shared: bool | None = None):
    """The cursor route's (grouped keys, off): ``block_histogram``
    (``shared`` as there), its exclusive scan (a ``torch.cumsum``),
    ``block_scatter``."""
    hist = block_histogram(keys, n_blocks, shared)
    off = hist.new_zeros(n_blocks + 2)
    torch.cumsum(hist, 0, dtype=torch.int32, out=off[1:])
    off = off[:-1]
    return block_scatter(keys, off.clone(), n_blocks), off


def cursor_partition_reference(keys: torch.Tensor, n_buckets: int, bpb: int):
    """The twin: ``block_partition_reference``."""
    launch_counts["partition_dissect_reference"] += 1
    return bp.block_partition_reference(keys, n_buckets, bpb)


def check(keys: torch.Tensor, grouped: torch.Tensor, off: torch.Tensor, n_buckets: int,
          what: str) -> None:
    """Raises unless (grouped, off) is the twin's partition of ``keys``:
    equal offsets, every key in its own block's window, the invalid keys
    after the last, the same keys (so every window is equal as a
    multiset)."""
    bpb = min(128, n_buckets)
    n_blocks = n_buckets // bpb
    twin, twin_off = bp.block_partition_reference(keys, n_buckets, bpb)
    end = int(off[-1])
    owner = torch.repeat_interleave(torch.arange(n_blocks, device=keys.device),
                                    (off[1:] - off[:-1]).long())
    if (not torch.equal(off, twin_off)
            or not torch.equal(bp.block_ids(grouped[:end], n_blocks), owner)
            or not bool((grouped[end:] == bp.INVALID_KEY).all())
            or not torch.equal(torch.sort(grouped).values, torch.sort(twin).values)):
        raise AssertionError(f"partition_dissect: {what} and the twin disagree")


def radix_pass_ms(keys: torch.Tensor, n_buckets: int, n_slabs: int, device) -> dict:
    """The main path's kernels at ``n_slabs`` slabs, each pass apart: its
    histogram rows, its scan (of a fresh copy of the rows, the copy's own
    time taken off) and its scatter; then the offsets. The keys that the
    passes leave sorted must equal the twin's, in order."""
    bpb = min(128, n_buckets)
    n_blocks = n_buckets // bpb
    count = torch.full((1,), keys.numel(), dtype=torch.int32, device=keys.device)
    t, cur = {}, keys
    for p, (shift, bits) in enumerate(bp.radix_passes(n_blocks)):
        rows = bp.partition_histogram(cur, n_blocks, shift, bits, count, n_slabs)
        t[f"pass {p} histogram"] = median_ms(
            lambda: bp.partition_histogram(cur, n_blocks, shift, bits, count, n_slabs), device)
        copy_ms = median_ms(lambda: rows.clone(), device)
        t[f"pass {p} scan"] = median_ms(lambda: bp.partition_scan(rows.clone()),
                                        device) - copy_ms
        doff = rows.new_zeros(rows.shape[1] + 1)
        torch.cumsum(bp.partition_scan(rows), 0, dtype=torch.int32, out=doff[1:])
        t[f"pass {p} scatter"] = median_ms(
            lambda: bp.radix_scatter(cur, rows, doff, n_blocks, shift, bits, count), device)
        cur = bp.radix_scatter(cur, rows, doff, n_blocks, shift, bits, count)
    t["offsets"] = median_ms(lambda: bp.radix_offsets(cur, n_blocks, count), device)
    twin, twin_off = bp.block_partition_reference(keys, n_buckets, bpb)
    if not torch.equal(cur, twin) or not torch.equal(bp.radix_offsets(cur, n_blocks, count),
                                                     twin_off):
        raise AssertionError(f"partition_dissect: the passes at {n_slabs} slabs and the twin "
                             "disagree")
    t["sum"] = sum(t.values())
    return t


def report(keys: torch.Tensor, n_buckets: int, device, what: str = "") -> dict:
    """Device ms (median of 5; the twin's of 3) on ``keys`` for a table of
    ``n_buckets``: the main path's partition, each variant whole and (on the
    card) its kernels alone, the twin and ``torch.sort`` +
    ``count_offsets``. Each variant's result is held to the twin first."""
    bpb = min(128, n_buckets)
    n_blocks = n_buckets // bpb
    t = {"radix": median_ms(lambda: bp.block_partition(keys, n_buckets, bpb), device)}
    for variant, shared in VARIANTS.items():
        check(keys, *cursor_partition(keys, n_buckets, bpb, variant), n_buckets, variant)
        t[variant] = median_ms(lambda: cursor_partition(keys, n_buckets, bpb, variant), device)
        if device.type != "cuda":
            continue
        hist = block_histogram(keys, n_blocks, shared)
        cursor = hist.new_zeros(n_blocks + 2)
        torch.cumsum(hist, 0, dtype=torch.int32, out=cursor[1:])
        t[f"{variant}: block_histogram"] = median_ms(
            lambda: block_histogram(keys, n_blocks, shared), device)
        t[f"{variant}: block_scatter"] = median_ms(
            lambda: block_scatter(keys, cursor[:-1].clone(), n_blocks), device)
    t["twin"] = median_ms(lambda: bp.block_partition_reference(keys, n_buckets, bpb), device,
                          reps=3)
    t["torch.sort + count_offsets"] = median_ms(
        lambda: stream_probe.count_offsets(torch.sort(keys).values, n_buckets, bpb), device)
    print(f"partition_dissect{what}: {keys.numel()} keys, {n_buckets} buckets ({n_blocks} "
          "chain blocks), ms: " + ", ".join(f"{name} {ms:.4f}" for name, ms in t.items()),
          flush=True)
    return t


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    device_arg(parser)
    parser.add_argument("--keys", type=int, default=N_KEYS, help="random keys a table")
    a = parser.parse_args(argv)
    device = pick_device(a.device)
    gen = torch.Generator(device=device).manual_seed(SEED)
    keys = torch.randint(-(1 << 63), (1 << 63) - 1, (a.keys,), generator=gen, device=device,
                         dtype=torch.int64)
    print(f"partition_dissect on {device_name(device)}", flush=True)
    result = {}
    for n_buckets in BUCKETS:
        result[n_buckets] = {"times": report(keys, n_buckets, device,
                                             f" ({n_buckets} buckets)"), "passes": {}}
        if device.type != "cuda":
            continue
        sms = torch.cuda.get_device_properties(keys.device).multi_processor_count
        for label, n_slabs in (("one wave", bp.radix_slabs(keys.device)), ("one a SM", sms)):
            t = radix_pass_ms(keys, n_buckets, n_slabs, device)
            result[n_buckets]["passes"][label] = t
            print(f"partition_dissect ({n_buckets} buckets): the main path's kernels at "
                  f"{label}, {n_slabs} slabs, ms: "
                  + ", ".join(f"{name} {ms:.4f}" for name, ms in t.items()), flush=True)
    return result


if __name__ == "__main__":
    main()
