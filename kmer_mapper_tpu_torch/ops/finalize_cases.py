"""Hazard cases of the node-count finalize (``ops/finalize.py``), shared by
the CPU tests and ``chip_smoke.py``.

Each case is slot counts (uint32) and entries (slot, node, uint16
frequency) with a frequency bound and a node count; :meth:`Case.expected`
is the answer in numpy, summed in uint64 and masked to 32 bits (the
wrapping uint32 sum of JAX's ``.at[].add``); :meth:`Case.ordered` gives
the same case with its entries shuffled or sorted by slot.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

MAX_FREQUENCY = 1000


@dataclasses.dataclass
class Case:
    counts: np.ndarray  # uint32[n_slots]
    slot: np.ndarray  # int32[n]
    node: np.ndarray  # int32[n]
    frequency: np.ndarray  # uint16[n]
    max_frequency: int
    n_nodes: int

    def expected(self) -> np.ndarray:
        keep = self.frequency <= self.max_frequency
        out = np.zeros(self.n_nodes, dtype=np.uint64)
        np.add.at(out, self.node[keep], self.counts[self.slot[keep]].astype(np.uint64))
        return (out & np.uint64(0xFFFFFFFF)).astype(np.uint32)

    def ordered(self, order: str, seed: int = 0) -> "Case":
        """The same case with its entries shuffled (``"shuffled"``) or
        sorted by slot (``"slot"``, stable: ``KmerIndex.device_entries``'
        order); the sums do not change."""
        if order == "slot":
            pick = np.argsort(self.slot, kind="stable")
        elif order == "shuffled":
            pick = np.random.default_rng(seed).permutation(len(self.slot))
        else:
            raise ValueError(f"no entry order {order!r}")
        return dataclasses.replace(self, slot=self.slot[pick], node=self.node[pick],
                                   frequency=self.frequency[pick])

    def inputs(self, device) -> tuple:
        """``finalize``'s arguments on ``device``: int32 counts and entries."""
        def dev(a):
            return torch.from_numpy(np.ascontiguousarray(a).view(np.int32)
                                    if a.dtype == np.uint32 else a.astype(np.int32)).to(device)

        return (dev(self.counts), dev(self.slot), dev(self.node), dev(self.frequency),
                self.max_frequency, self.n_nodes)


def _case(rng, n_slots: int, n: int, n_nodes: int, counts=None, frequency=None,
          node=None) -> Case:
    if counts is None:
        counts = rng.integers(0, 5, n_slots).astype(np.uint32)
        counts[rng.random(n_slots) < 0.7] = 0  # most slots never hit
    return Case(
        counts=counts,
        slot=rng.integers(0, n_slots, n).astype(np.int32),
        node=(rng.integers(0, n_nodes, n) if node is None else node).astype(np.int32),
        frequency=(np.ones(n) if frequency is None else frequency).astype(np.uint16),
        max_frequency=MAX_FREQUENCY, n_nodes=n_nodes,
    )


def cases(seed: int = 0) -> dict[str, Case]:
    rng = np.random.default_rng(seed)
    out = {"random": _case(rng, 4096, 20_000, 3000,
                           frequency=rng.choice([1, 2, 999, 1000, 1001, 65535], 20_000))}
    # the strict skip: frequency == max_frequency is kept, one more dropped
    bound = _case(rng, 64, 6, 3, counts=np.arange(1, 65, dtype=np.uint32),
                  frequency=np.array([MAX_FREQUENCY, MAX_FREQUENCY + 1, 0, 65535,
                                      MAX_FREQUENCY - 1, MAX_FREQUENCY]))
    bound.node = np.array([0, 0, 1, 1, 2, 2], dtype=np.int32)
    out["frequency_bound"] = bound
    out["one_node"] = _case(rng, 4096, 100_000, 10, node=np.full(100_000, 7))
    # one node's counts 0xFFFFFFFF + 1 (wraps to 0), another's past 2**32
    wrap_counts = np.array([0xFFFFFFFF, 1, 0x80000000, 0x80000001, 3, 0xFFFFFFFE],
                           dtype=np.uint32)
    wrap = Case(counts=wrap_counts, slot=np.array([0, 1, 2, 3, 4, 5, 5, 5], dtype=np.int32),
                node=np.array([0, 0, 1, 1, 1, 2, 2, 2], dtype=np.int32),
                frequency=np.ones(8, dtype=np.uint16), max_frequency=MAX_FREQUENCY, n_nodes=3)
    out["wrap"] = wrap
    # max_node_id 10**3 times the entry count: almost every node empty
    out["sparse_nodes"] = _case(rng, 1024, 500, 500_000)
    out["no_entries"] = _case(rng, 256, 0, 17)
    # one k-mer on 10**4 nodes: every entry gathers one count, near 2**32, and
    # a warp's lanes fall in groups of equal nodes whose sums wrap
    out["one_slot"] = _case(rng, 64, 30_000, 10_000,
                            counts=np.full(64, 0xFFFFFFF0, dtype=np.uint32))
    out["one_slot"].slot[:] = 37
    # two hot nodes share 80% of the entries, so most warps hold two groups
    # of equal nodes besides single ones; the counts near 2**32 make their
    # sums wrap
    hot = _case(rng, 2048, 20_000, 1000,
                counts=rng.integers(0xF0000000, 0xFFFFFFFF, 2048, dtype=np.uint64)
                .astype(np.uint32))
    pick = rng.random(20_000)
    hot.node[pick < 0.4] = 3
    hot.node[pick >= 0.6] = 5
    out["two_hot_nodes"] = hot
    return out
