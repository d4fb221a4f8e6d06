"""Index loading and the device-ready index structure (host numpy).

A copy of the reference-format ``.npz`` path of
``kmer_mapper_tpu/index/kmer_index.py``, pinned by
``tests/test_torch_layout.py``. Loading produces a :class:`KmerIndex`: the
block-chained bucket table of unique kmers (``layout.py``) plus per-entry
arrays that turn unique-kmer slot counts into graph-node counts with the
reference's per-entry frequency filter.
"""
from __future__ import annotations

import dataclasses
import logging
import os

import numpy as np

from ..oracle import KmerIndexArrays
from . import layout

logger = logging.getLogger(__name__)

_REF_FIELDS = ("hashes_to_index", "n_kmers", "kmers", "nodes", "frequencies", "modulo")


def _npz_get(data, name):
    for key in (name, "_" + name):
        if key in data:
            try:
                return data[key]
            except ValueError:
                # a None attribute written by the reference's ``to_file`` is
                # a 0-d object array, unreadable without pickle: treat it as
                # absent but keep trying the "_"-prefixed twin
                continue
    return None


def load_reference_npz(path_or_file) -> KmerIndexArrays:
    """Load a ``graph_kmer_index`` KmerIndex/MinimalKmerIndex ``.npz``."""
    with np.load(path_or_file, allow_pickle=False) as data:
        fields = {name: _npz_get(data, name) for name in _REF_FIELDS}
    if fields["kmers"] is None or fields["hashes_to_index"] is None:
        raise ValueError("not a KmerIndex .npz (missing kmers/hashes_to_index)")
    n = len(fields["kmers"])
    if fields["frequencies"] is None:
        fields["frequencies"] = np.ones(n, dtype=np.uint16)  # minimal index form
    if fields["n_kmers"] is None:
        # bucket lengths follow from consecutive bucket starts
        starts = fields["hashes_to_index"].astype(np.int64)
        fields["n_kmers"] = np.maximum(np.diff(np.append(starts, n)), 0)
    modulo = int(np.asarray(fields["modulo"]).reshape(-1)[0])
    return KmerIndexArrays(
        hashes_to_index=fields["hashes_to_index"].astype(np.int32),
        n_kmers=fields["n_kmers"].astype(np.int32),
        kmers=fields["kmers"].astype(np.uint64),
        nodes=fields["nodes"].astype(np.int32),
        frequencies=fields["frequencies"].astype(np.uint16),
        modulo=modulo,
    )


def save_reference_npz(path, index: KmerIndexArrays) -> None:
    """Write the reference-compatible ``.npz`` layout."""
    np.savez(
        path,
        hashes_to_index=index.hashes_to_index,
        n_kmers=index.n_kmers,
        kmers=index.kmers,
        nodes=index.nodes,
        frequencies=index.frequencies,
        modulo=np.uint64(index.modulo),
    )


@dataclasses.dataclass
class KmerIndex:
    """Unique-kmer table plus the per-entry finalization arrays."""

    table: layout.TableArrays
    # an entry is one (kmer, node) pair; kmers may repeat
    entry_slot: np.ndarray  # int32[N] table slot of the entry's kmer
    entry_node: np.ndarray  # int32[N]
    entry_frequency: np.ndarray  # uint16[N]
    max_node_id: int
    n_unique: int

    @classmethod
    def from_arrays(
        cls, index: KmerIndexArrays, max_load: float = layout.DEFAULT_MAX_LOAD
    ) -> "KmerIndex":
        return cls.from_entries(
            index.kmers, index.nodes, index.frequencies, max_load=max_load
        )

    @classmethod
    def from_entries(
        cls,
        kmers: np.ndarray,
        nodes: np.ndarray,
        frequencies: np.ndarray | None = None,
        max_load: float = layout.DEFAULT_MAX_LOAD,
    ) -> "KmerIndex":
        """Build from (kmer, node) entry pairs. Entry slots come from the
        build's own slot record, not from probing every entry again."""
        kmers = np.asarray(kmers, dtype=np.uint64)
        nodes = np.asarray(nodes, dtype=np.int32)
        unique, inverse = np.unique(kmers, return_inverse=True)
        if frequencies is None:
            counts = np.bincount(inverse, minlength=len(unique))
            frequencies = np.minimum(counts[inverse], 65535).astype(np.uint16)
        table = layout.build_table(unique, max_load=max_load)
        entry_slot = table.build_slots[inverse]
        table.build_slots = None  # build byproduct, not needed again
        return cls(
            table=table,
            entry_slot=entry_slot.astype(np.int32),
            entry_node=nodes,
            entry_frequency=np.asarray(frequencies, dtype=np.uint16),
            max_node_id=int(nodes.max()) if len(nodes) else 0,
            n_unique=len(unique),
        )

    def node_counts(
        self, slot_counts: np.ndarray, max_frequency: int = 1000
    ) -> np.ndarray:
        """Unique-kmer slot counts -> per-node hit counts, skipping entries
        with ``frequency > max_frequency``. Returns uint32[max_node_id+1]."""
        slot_counts = np.asarray(slot_counts).reshape(-1)
        ok = self.entry_frequency <= max_frequency
        weights = slot_counts[self.entry_slot[ok]].astype(np.float64)
        out = np.bincount(
            self.entry_node[ok].astype(np.int64),
            weights=weights,
            minlength=self.max_node_id + 1,
        )
        return out.astype(np.uint32)


def load_index(source) -> KmerIndex:
    """A :class:`KmerIndex` from itself, from reference-layout arrays, or
    from a reference-format ``.npz`` path (``path`` or ``path + ".npz"``,
    the latter first, as the reference resolves it)."""
    if isinstance(source, KmerIndex):
        return source
    if isinstance(source, KmerIndexArrays):
        return KmerIndex.from_arrays(source)
    path = str(source)
    if not path.endswith(".npz") and os.path.exists(path + ".npz"):
        path = path + ".npz"
    arrays = load_reference_npz(path)
    logger.info(
        "Loaded reference-format index: %d entries, modulo %d",
        len(arrays.kmers),
        arrays.modulo,
    )
    return KmerIndex.from_arrays(arrays)
