"""Drop-in programmatic API matching the reference's library surface.

KAGE uses the reference as a library: ``map_kmers_to_graph_index(index,
max_node_id, kmers, max_index_lookup_frequency)`` (``kmer_mapper/mapper.pyx:19``),
``in_graph_index(index, kmers)`` (``:81``) and the ``GpuCounter`` class
(``kmer_mapper/gpu_counter.py``). The torch counterpart of
``kmer_mapper_tpu/compat.py``: the wrappers accept a reference-layout
:class:`~kmer_mapper_tpu_torch.oracle.KmerIndexArrays`, a
:class:`~kmer_mapper_tpu_torch.index.kmer_index.KmerIndex` or an index path.

The reference's signatures name no device. Here each call takes a
keyword-only ``device``, ``"cuda"`` by default; without a GPU the call
raises and names ``device="cpu"``: it never moves to the CPU on its own.
"""
from __future__ import annotations

import logging
import os
import weakref

import numpy as np
import torch

from . import oracle
from .index.kmer_index import KmerIndex, load_index
from .models.mapper import KmerMapper, MapperConfig

logger = logging.getLogger(__name__)

# KAGE calls these wrappers per batch with the same index object or path
# (``mapper.pyx:19,81``); building the table costs seconds to minutes for a
# real index, so resolved indexes are cached (object keys by id(), evicted
# by weakref.finalize, as the arrays dataclass is not hashable) and the
# device-resident mappers live ON the KmerIndex, so they die with it (a
# global mapper cache would pin the index through mapper.index).
_path_cache: dict[str, KmerIndex] = {}
_obj_cache: dict[int, KmerIndex] = {}


def _device(device) -> torch.device:
    """The device asked for; raises when that is CUDA and there is no GPU."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={str(device)!r}: PyTorch sees no CUDA device; pass "
            'device="cpu" to run on the CPU'
        )
    return device


def _as_index(index) -> KmerIndex:
    if isinstance(index, KmerIndex):
        return index
    if isinstance(index, (str, os.PathLike)):
        key = str(index)
        hit = _path_cache.get(key)
        if hit is None:
            hit = _path_cache[key] = load_index(index)
        return hit
    hit = _obj_cache.get(id(index))
    if hit is None:
        hit = load_index(index)
        _obj_cache[id(index)] = hit
        try:
            weakref.finalize(index, _obj_cache.pop, id(index), None)
        except TypeError:
            pass  # not weakref-able: the entry lives as long as the process
    return hit


def _shared_mapper(index: KmerIndex, k: int = 31, *, device="cuda") -> KmerMapper:
    """The index's mapper for (k, device), made once: a caller alternating k
    or devices never uploads the table again."""
    device = _device(device)
    mappers = getattr(index, "_compat_mappers", None)
    if mappers is None:
        mappers = index._compat_mappers = {}
    mapper = mappers.get((k, device))
    if mapper is None:
        mapper = mappers[(k, device)] = KmerMapper(index, MapperConfig(k=k), device)
    return mapper


def map_kmers_to_graph_index(
    index,
    max_node_id: int | None = None,
    kmers: np.ndarray | None = None,
    max_index_lookup_frequency: int = 1000,
    *,
    device="cuda",
) -> np.ndarray:
    """Per-node hit counts for a flat array of uint64 kmer hashes.

    The signature of ``kmer_mapper.mapper.map_kmers_to_graph_index``
    (``mapper.pyx:19-72``), plus ``device``; entries with a frequency above
    ``max_index_lookup_frequency`` count nothing. Repeated calls with the
    same index reuse its device-resident table."""
    assert kmers is not None, "kmers required"
    mapper = _shared_mapper(_as_index(index), device=device)
    mapper.reset_counts()
    mapper.map_hashes(np.asarray(kmers, dtype=np.uint64))
    counts = mapper.node_counts(max_frequency=max_index_lookup_frequency)
    if max_node_id is not None and max_node_id + 1 != len(counts):
        if max_node_id + 1 < len(counts):
            logger.warning(
                "max_node_id=%d drops counts for %d higher nodes present in the "
                "index (the reference would write out of bounds here)",
                max_node_id,
                len(counts) - (max_node_id + 1),
            )
        out = np.zeros(max_node_id + 1, dtype=np.uint32)
        n = min(len(counts), max_node_id + 1)
        out[:n] = counts[:n]
        return out
    return counts


def in_graph_index(
    index, kmers: np.ndarray, max_index_lookup_frequency: int = 1000, *, device="cuda"
) -> np.ndarray:
    """uint8[n] membership per kmer (``mapper.pyx:81-130``; like the
    reference, the frequency argument is ignored)."""
    mapper = _shared_mapper(_as_index(index), device=device)
    return mapper.in_index(np.asarray(kmers, dtype=np.uint64))


class TpuCounter:
    """The class surface of the reference's ``GpuCounter``
    (``kmer_mapper/gpu_counter.py``): build a device counter from the
    index's (kmers, nodes), stream uint64 hash batches through :meth:`count`
    (optionally with reverse complements), then turn unique-kmer counts into
    node counts. Backed by the block-chained table and the port's kernels."""

    def __init__(self, unique_kmers, kmers, nodes, k: int, *, device="cuda"):
        self.unique_kmers = np.asarray(unique_kmers, dtype=np.uint64)
        self.kmers = np.asarray(kmers, dtype=np.uint64)
        self.nodes = np.asarray(nodes, dtype=np.int32)
        self.k = k
        self.device = _device(device)
        self._mapper: KmerMapper | None = None

    @classmethod
    def from_kmers_and_nodes(cls, kmers, nodes, k: int, *, device="cuda") -> "TpuCounter":
        return cls(np.unique(kmers), kmers, nodes, k, device=device)

    def initialize(self, *_ignored) -> None:
        """Build the device table (``initialize_cuda``; the table size
        argument is ignored: the size follows from the key set)."""
        index = KmerIndex.from_counter_keys(self.unique_kmers)
        self._mapper = KmerMapper(index, MapperConfig(k=self.k), self.device)

    initialize_cuda = initialize  # drop-in name

    def count(self, kmers, count_revcomps: bool = False) -> None:
        if self._mapper is None:
            self.initialize()
        kmers = np.asarray(kmers, dtype=np.uint64)
        self._mapper.map_hashes(kmers)
        if count_revcomps:
            self._mapper.map_hashes(oracle.revcomp_hash(kmers, self.k))

    def get_node_counts(self, min_nodes: int = 0) -> np.ndarray:
        """Unique-kmer counts distributed to the index entries and summed by
        node (``gpu_counter.py:26-37``: length max(min_nodes, max node + 1);
        uint32 rather than float64)."""
        assert self._mapper is not None, "count() nothing yet"
        got_kmers, got_counts = self._mapper.kmer_counts()
        out = oracle.node_counts_from_kmer_counts(
            self.kmers, self.nodes, got_kmers, got_counts, min_nodes=0
        )
        if len(out) < min_nodes:
            out = np.pad(out, (0, min_nodes - len(out)))
        return out


# numpy-only equivalents (no device required)
map_kmers_to_graph_index_numpy = oracle.map_kmers_to_index
in_graph_index_numpy = oracle.in_index
