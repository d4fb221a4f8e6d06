"""The plain reference of a mapping run, and the comparison that decides
``correct``.

The reference works from what the benchmark made: the index's entries
(k-mer hash, node, frequency) and the pool's reads (their starts, lengths
and strands in the genome, from which it rebuilds each read, a
reverse-strand read as the reverse complement of its window). It hashes
every window that lies in one read and, where the traffic says
``revcomp`` (the mapper's ``-r``), also the window's reverse complement
(the read's codes complemented and reversed, then hashed as a forward
window is), finds each hash among the index's distinct k-mers by a binary
search, counts the hits of each distinct k-mer, every hit of either hash
of a window, times the number of times the window mapped the buffer, and
adds each entry's count to its node where the entry's frequency is at most
``max_frequency``. A window is one k-mer mapped, whether it makes one key
or two. Plain torch, on the device the run used, a buffer at a time. It
imports nothing of the program and reads nothing the program made.

The control (``key=key32``) is the same reference, both hashes of a
window under ``revcomp`` alike, with 32-bit keys in place of the 62-bit
k-mer hashes: the precision below the one the configuration states.
"""
from __future__ import annotations

import numpy as np
import torch

from .genome import M32, Buffer, Entries, Genome, mix32, read_codes, window_hashes

#: each number compared, and its limit: node counts and k-mers are exact
LIMITS = {"nodes_off": 0, "kmers_off": 0}


def key32(hashes: torch.Tensor) -> torch.Tensor:
    """The control's 32-bit key of 62-bit k-mer hashes."""
    return mix32(mix32(hashes & M32) ^ (hashes >> 32))


def revcomp_hashes(codes: torch.Tensor, k: int) -> torch.Tensor:
    """The hashes of the reverse complement of every window of the rows of
    ``codes``, aligned with ``window_hashes(codes, k)``: the codes
    complemented (``3 - c``) and reversed, their windows hashed, and the
    result reversed back, so that entry ``t`` is that of window ``t``."""
    return window_hashes(3 - codes.flip(-1), k).flip(-1)


def buffer_hashes(genome: Genome, buf: Buffer, k: int, device,
                  revcomp: bool = False) -> torch.Tensor:
    """The hashes of the buffer's valid windows (those that lie in one
    read): one a window, or with ``revcomp`` (2, windows), the forward
    hashes and those of each window's reverse complement."""
    starts, lengths = buf.starts.to(device), buf.lengths.to(device)
    reverse = None if buf.reverse is None else buf.reverse.to(device)
    codes = read_codes(genome, starts, lengths, buf.strided, reverse)
    hashes = window_hashes(codes, k)
    if revcomp:
        hashes = torch.stack([hashes, revcomp_hashes(codes, k)])
    if buf.strided:
        return hashes.reshape(hashes.shape[:-2] + (-1,))
    read = torch.repeat_interleave(torch.arange(lengths.shape[0], device=device), lengths)
    first = torch.cumsum(lengths, 0) - lengths
    at = torch.arange(codes.shape[0], device=device) - first[read]
    n = hashes.shape[-1]
    return hashes[..., at[:n] <= (lengths[read] - k)[:n]]


class NodeCountReference:
    """Node counts of windows on the entries, accumulated a buffer at a time."""

    def __init__(self, entries: Entries, max_frequency: int, key=None):
        self.key = key
        keys = entries.kmers if key is None else key(entries.kmers)
        self.distinct, self.entry_key = torch.unique(keys, return_inverse=True)
        self.counts = torch.zeros(self.distinct.shape[0], dtype=torch.int64,
                                  device=keys.device)
        self.nodes = entries.nodes
        self.kept = entries.frequencies <= max_frequency
        self.n_nodes = entries.n_nodes
        self.windows = 0

    def add(self, hashes: torch.Tensor, times: int = 1) -> int:
        """Counts the hashes of windows ``times`` over: (windows,), or
        (hashes a window, windows), every hit of each hash of a window
        counted, the window counted once; returns how many distinct index
        k-mers they hit."""
        self.windows += hashes.shape[-1] * times
        hashes = hashes.reshape(-1)
        if not hashes.shape[0] or not self.distinct.shape[0]:
            return 0
        q = hashes if self.key is None else self.key(hashes)
        at = torch.searchsorted(self.distinct, q).clamp_(max=self.distinct.shape[0] - 1)
        hit = at[self.distinct[at] == q]
        per_key = torch.bincount(hit, minlength=self.distinct.shape[0])
        self.counts += per_key * times
        return int(per_key.count_nonzero())

    def node_counts(self) -> torch.Tensor:
        """int64 hits a node."""
        weights = torch.where(self.kept, self.counts[self.entry_key], 0)
        out = torch.zeros(self.n_nodes, dtype=torch.int64, device=weights.device)
        return out.index_add_(0, self.nodes, weights)


def judge(got_nodes: np.ndarray, got_kmers: int, want_nodes: torch.Tensor,
          want_kmers: int) -> dict:
    """Each number compared, with its limit: the nodes whose count differs
    from the reference's (counts are uint32 and wrap, as the reference's
    do), and the difference in k-mers mapped."""
    want = (want_nodes & M32).cpu().numpy().astype(np.uint32)
    got = np.asarray(got_nodes)
    if got.shape != want.shape:
        nodes_off = max(got.size, want.size)
    else:
        nodes_off = int(np.count_nonzero(got != want))
    values = {"nodes_off": nodes_off, "kmers_off": abs(int(got_kmers) - int(want_kmers))}
    return {name: {"value": values[name], "limit": limit} for name, limit in LIMITS.items()}


def is_correct(checks: dict) -> bool:
    return all(c["value"] <= c["limit"] for c in checks.values())
