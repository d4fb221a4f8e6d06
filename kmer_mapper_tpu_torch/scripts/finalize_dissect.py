"""The node-count finalize's other designs beside the main path's: the
measurement behind ``csrc/node_counts.cu`` (the entries in slot order, and
equal nodes combined only in the warps where one repeats).

    python -m kmer_mapper_tpu_torch.scripts.finalize_dissect [variant ...] [--device cpu]

Each variant computes what ``ops.finalize.finalize`` computes, on the
entry order it takes (:data:`ORDERS`):

    main         the main path's kernel (``ops.finalize``), entries by slot
    entry_order  the main path's kernel on the index's own entry order
    plain_entry  a thread an entry, an atomic each, no combining, in entry
                 order: the first design
    csr          entries by node and their offsets: a thread a node, a plain
                 store, no atomic and no zeroed output

:func:`node_counts_variant` launches ``csrc/finalize_dissect.cu`` for the
last two on CUDA tensors and runs the finalize's twin on CPU tensors.
``main`` times every variant (median of 5) on entries of the 2^26-hash
library call's shape (:data:`N_ENTRIES` entries on distinct random slots of
:data:`N_SLOTS`, nodes uniform over :data:`N_NODES`, every slot hit) and on
the hazard cases ``one_node`` and ``two_hot_nodes`` of
``ops/finalize_cases.py``; every variant must equal the twin or the script
raises.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from .. import native
from ..ops import finalize, finalize_cases
from . import device_arg, device_name, median_ms, pick_device

#: the kernel id of each variant of ``csrc/finalize_dissect.cu``
KERNELS = {"plain": 0, "csr": 1}
#: each variant's entry order: by slot, by node, or the index's own
ORDERS = {"main": "slot", "entry_order": "entry", "plain_entry": "entry", "csr": "node"}
#: the 2^26-hash library call's shape (chip_smoke.py phase 8's bench index)
N_ENTRIES, N_SLOTS, N_NODES = 2_583_023, 1 << 23, 3_000_000
SEED = 5
MAX_FREQUENCY = 1000

#: launches of the dissection kernel since import
launch_counts = {"finalize_dissect": 0}


def ordered(entries, order: str):
    """The (slot, node, frequency) entries stably sorted by slot or by node,
    or as given (``"entry"``)."""
    if order == "entry":
        return entries
    pick = torch.argsort(entries[0 if order == "slot" else 1], stable=True)
    return tuple(t[pick] for t in entries)


def node_offsets(node: torch.Tensor, n_nodes: int) -> torch.Tensor:
    """int32[n_nodes + 1]: the first position of each node in entries
    sorted by node (``csr``'s offsets)."""
    nodes = torch.arange(n_nodes + 1, dtype=torch.int32, device=node.device)
    return torch.searchsorted(node, nodes).to(torch.int32)


def node_counts_variant(counts, slot, node, freq, max_frequency: int, n_nodes: int,
                        variant: str, off: torch.Tensor | None = None) -> torch.Tensor:
    """int32[n_nodes]: ``finalize``'s node counts by one launch of the
    variant's kernel (``csr`` takes :func:`node_offsets`, made here when not
    given; it needs the entries sorted by node); the finalize's twin on CPU
    tensors."""
    finalize.check_args(counts, slot, node, freq, n_nodes)
    if variant not in KERNELS:
        raise ValueError(f"finalize_dissect: no variant {variant!r} (of {sorted(KERNELS)})")
    if counts.device.type == "cpu":
        return finalize.finalize_reference(counts, slot, node, freq, max_frequency, n_nodes)
    if variant == "csr" and off is None:
        off = node_offsets(node, n_nodes)
    out = (counts.new_empty if variant == "csr" else counts.new_zeros)(n_nodes)
    with torch.cuda.device(counts.device):
        rc = native.library().finalize_dissect_launch(
            KERNELS[variant], counts.data_ptr(), slot.data_ptr(), node.data_ptr(),
            freq.data_ptr(), None if off is None else off.data_ptr(), slot.shape[0],
            max(-1, min(int(max_frequency), 1 << 16)), out.data_ptr(), n_nodes,
            counts.device.index, torch.cuda.current_stream().cuda_stream)
    if rc:
        raise RuntimeError(f"finalize_dissect kernel launch failed: {native.error_string(rc)}")
    launch_counts["finalize_dissect"] += 1
    return out


def report(counts, entries, max_frequency: int, n_nodes: int, device,
           variants=tuple(ORDERS)) -> dict[str, float]:
    """Median ms of each variant on these entries (each in its own order),
    after checking it against the finalize's twin; raises on a difference."""
    twin = finalize.finalize_reference(counts, *entries, max_frequency, n_nodes)
    times = {}
    for name in variants:
        e = ordered(entries, ORDERS[name])
        if name in ("main", "entry_order"):
            def run(e=e):
                return finalize.finalize(counts, *e, max_frequency, n_nodes)
        else:
            off = node_offsets(e[1], n_nodes) if name == "csr" else None
            kernel = name.removesuffix("_entry")

            def run(e=e, off=off, kernel=kernel):
                return node_counts_variant(counts, *e, max_frequency, n_nodes, kernel, off)
        if not torch.equal(run(), twin):
            raise AssertionError(f"finalize_dissect: {name} != the finalize's twin")
        times[name] = median_ms(run, device)
    return times


def library_shaped(device):
    """(counts, entries in entry order, max_frequency, n_nodes) of the
    2^26-hash call's shape, from :data:`SEED`."""
    rng = np.random.default_rng(SEED)
    slot = rng.choice(N_SLOTS, N_ENTRIES, replace=False).astype(np.int32)
    node = rng.integers(0, N_NODES, N_ENTRIES).astype(np.int32)
    counts = rng.integers(1, 5, N_SLOTS).astype(np.int32)
    entries = tuple(torch.from_numpy(a).to(device)
                    for a in (slot, node, np.ones(N_ENTRIES, np.int32)))
    return torch.from_numpy(counts).to(device), entries, MAX_FREQUENCY, N_NODES


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("variants", nargs="*", help=f"of {list(ORDERS)} (default: all)")
    device_arg(parser)
    a = parser.parse_args(argv)
    variants = a.variants or list(ORDERS)
    unknown = sorted(set(variants) - set(ORDERS))
    if unknown:
        parser.error(f"no variant {unknown} (of {list(ORDERS)})")
    device = pick_device(a.device)
    cases = finalize_cases.cases()
    inputs = {"library call": library_shaped(device)}
    for name in ("one_node", "two_hot_nodes"):
        counts, *entries, max_frequency, n_nodes = cases[name].inputs(device)
        inputs[name] = (counts, tuple(entries), max_frequency, n_nodes)
    print(f"finalize_dissect on {device_name(device)}", flush=True)
    result = {}
    for what, (counts, entries, max_frequency, n_nodes) in inputs.items():
        result[what] = report(counts, entries, max_frequency, n_nodes, device, variants)
        print(f"finalize_dissect ({what}: {entries[0].numel()} entries, {n_nodes} nodes), ms: "
              + ", ".join(f"{name} {ms:.4f}" for name, ms in result[what].items()),
              flush=True)
    return result


if __name__ == "__main__":
    main()
