"""Index loading and the device-ready index structure (host numpy).

A jax-free copy of ``kmer_mapper_tpu/index/kmer_index.py``, pinned by
``tests/test_torch_layout.py`` and ``tests/test_torch_index_forms.py``.
Input forms follow the reference's index resolution
(``kmer_mapper/util.py:38-68``), in :func:`load_index`'s order:

1. this package's prebuilt ``.tpuidx.npz`` (table + finalization arrays,
   format ``tpuidx-v4``, the same file the JAX package writes and reads),
2. a counter-style ``.npz`` (field ``counter_keys``),
3. a pickled ``CounterKmerIndex`` or ``IndexBundle`` (``pickled.py``),
4. a ``graph_kmer_index`` KmerIndex/MinimalKmerIndex ``.npz``,
5. an index bundle: a zip holding a ``kmer_index`` member.

Loading produces a :class:`KmerIndex`: the block-chained bucket table of
unique kmers (``layout.py``) plus per-entry arrays that turn unique-kmer
slot counts into graph-node counts with the reference's per-entry
frequency filter.
"""
from __future__ import annotations

import dataclasses
import io
import logging
import os
import zipfile

import numpy as np
import torch

from ..ops.u32hash import feistel_unmix, join_u64
from ..oracle import KmerIndexArrays, build_kmer_index
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
        extra_keys: np.ndarray | None = None,
    ) -> "KmerIndex":
        """Build from (kmer, node) entry pairs. Entry slots come from the
        build's own slot record, not from probing every entry again.
        ``extra_keys`` are countable kmers with no node (a CounterKmerIndex
        may count keys that carry no entry): probed and counted, but added
        to no node."""
        kmers = np.asarray(kmers, dtype=np.uint64)
        nodes = np.asarray(nodes, dtype=np.int32)
        all_keys = kmers
        if extra_keys is not None and len(extra_keys):
            all_keys = np.concatenate([kmers, np.asarray(extra_keys, np.uint64)])
        unique, inverse = np.unique(all_keys, return_inverse=True)
        inverse = inverse[: len(kmers)]
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

    @classmethod
    def from_counter_keys(cls, unique_kmers: np.ndarray) -> "KmerIndex":
        """Counter-only index (no node mapping): node i is unique kmer i."""
        unique = np.unique(np.asarray(unique_kmers, dtype=np.uint64))
        table = layout.build_table(unique)
        slot = table.build_slots
        table.build_slots = None
        return cls(
            table=table,
            entry_slot=slot.astype(np.int32),
            entry_node=np.arange(len(unique), dtype=np.int32),
            entry_frequency=np.ones(len(unique), dtype=np.uint16),
            max_node_id=len(unique) - 1 if len(unique) else 0,
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

    def shard_entries(self, x: int, n_shards: int) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """The entries of index shard ``x`` of ``n_shards`` equal bucket
        ranges (shard x holds buckets ``[x * nb_local, (x + 1) * nb_local)``),
        those with ``entry_slot // (nb_local * 8) == x``, in entry order:
        (slot in the shard's own counts, node, frequency), all int32."""
        n_slots = self.table.n_slots
        if n_shards < 1 or n_slots % n_shards or not 0 <= x < n_shards:
            raise ValueError(f"no shard {x} of {n_slots} slots in {n_shards} equal shards")
        per = n_slots // n_shards
        slot = self.entry_slot.astype(np.int64)
        pick = np.flatnonzero(slot // per == x) if n_shards > 1 else slice(None)
        return ((slot[pick] - x * per).astype(np.int32), self.entry_node[pick].astype(np.int32),
                self.entry_frequency[pick].astype(np.int32))

    def device_entries(self, device, shard: tuple[int, int] = (0, 1)):
        """(slot, node, frequency) int32 tensors of the entries of index shard
        ``shard = (x, n_shards)`` (:meth:`shard_entries`; by default the whole
        table), uploaded to ``device`` for ``ops/finalize.finalize`` and
        sorted there by slot (stably): any order gives the same node counts,
        and in slot order a warp's gathers of the slot counts fall in
        neighbouring sectors. The caller keeps them (the mappers hold them
        from their first ``node_counts`` on), so the upload and the sort
        happen once, outside every finalize; the frequency is int32 because
        torch's uint16 lacks comparisons on the CPU."""
        x, n_shards = shard
        slot, node, freq = (torch.from_numpy(np.ascontiguousarray(a)).to(device)
                            for a in self.shard_entries(x, n_shards))
        order = torch.argsort(slot, stable=True)
        return slot[order], node[order], freq[order]

    def get(self, kmer: int) -> np.ndarray:
        """Graph nodes of a kmer hash (the reference's ``KmerIndex.get``)."""
        slot = layout.query_table(self.table, np.array([kmer], dtype=np.uint64))[0]
        if slot < 0:
            return np.zeros(0, dtype=np.int32)
        return self.entry_node[self.entry_slot == slot]

    def kmer_counts(self, slot_counts: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """(unique kmers in slot order, their counts): the counter view. The
        table stores mixed words; unmixing recovers the raw kmers."""
        m_lo, m_hi = self.table.key_words()
        occupied = ~((m_lo == layout.EMPTY) & (m_hi == layout.EMPTY))
        lo, hi = feistel_unmix(m_lo, m_hi, seed=self.table.seed)
        counts = np.asarray(slot_counts).reshape(-1)
        return join_u64(lo, hi)[occupied], counts[occupied]

    def to_file(self, path) -> None:
        """Write the ``tpuidx-v4`` file that both packages read."""
        np.savez(
            path,
            format=np.array(["tpuidx-v4"]),
            table_key_lo=self.table.key_lo,
            table_key_hi=self.table.key_hi,
            table_max_probe=np.int64(self.table.max_probe),
            table_seed=np.int64(self.table.seed),
            entry_slot=self.entry_slot,
            entry_node=self.entry_node,
            entry_frequency=self.entry_frequency,
            max_node_id=np.int64(self.max_node_id),
            n_unique=np.int64(self.n_unique),
        )

    @classmethod
    def from_file(cls, path_or_file) -> "KmerIndex":
        with np.load(path_or_file, allow_pickle=False) as data:
            fmt = str(data["format"][0]) if "format" in data else "?"
            if fmt != "tpuidx-v4":
                raise ValueError(
                    f"unsupported .tpuidx format {fmt!r} (this build reads "
                    "tpuidx-v4, which stores mixed table words; re-run "
                    "convert-index on the source .npz)"
                )
            key_lo = data["table_key_lo"]
            max_probe = int(data["table_max_probe"])
            if not 1 <= max_probe <= layout.MAX_PROBE_HARD:
                # no build makes chains this deep: a corrupt or foreign file
                raise ValueError(
                    f"corrupt .tpuidx: table_max_probe={max_probe} outside "
                    f"[1, {layout.MAX_PROBE_HARD}]"
                )
            table = layout.TableArrays(
                key_lo=key_lo,
                key_hi=data["table_key_hi"],
                n_buckets=key_lo.shape[0],
                max_probe=max_probe,
                seed=int(data["table_seed"]),
            )
            return cls(
                table=table,
                entry_slot=data["entry_slot"],
                entry_node=data["entry_node"],
                entry_frequency=data["entry_frequency"],
                max_node_id=int(data["max_node_id"]),
                n_unique=int(data["n_unique"]),
            )


def _is_tpuidx(path_or_file) -> bool:
    try:
        with np.load(path_or_file, allow_pickle=False) as data:
            return "table_key_lo" in data
    except Exception:
        return False


def load_index(source) -> KmerIndex:
    """Resolve any supported index form into a :class:`KmerIndex`
    (reference: ``_get_kmer_index_from_args``, ``util.py:38-68``). A path
    ``p`` without ``.npz`` reads ``p + ".npz"`` first when it exists, as the
    reference resolves it."""
    if isinstance(source, KmerIndex):
        return source
    if isinstance(source, KmerIndexArrays):
        return KmerIndex.from_arrays(source)
    path = str(source)
    if not path.endswith(".npz") and os.path.exists(path + ".npz"):
        path = path + ".npz"
    if _is_tpuidx(path):
        logger.info("Loading prebuilt index %s", path)
        return KmerIndex.from_file(path)
    try:
        with np.load(path, allow_pickle=False) as data:
            if "counter_keys" in data:
                logger.info("Kmer index is counter index")
                return KmerIndex.from_counter_keys(data["counter_keys"])
    except Exception:
        pass
    # pickled CounterKmerIndex (util.py:63-66) or IndexBundle (util.py:51-53):
    # pickles are not zipfiles, so sniff first
    from .pickled import is_pickle_file, load_pickled_index

    if is_pickle_file(path):
        logger.info("Kmer index is a pickle file (counter index or bundle)")
        return load_pickled_index(path)
    # a bundle is a zip that is not itself a loadable .npz index
    try:
        arrays = load_reference_npz(path)
    except Exception:
        if zipfile.is_zipfile(path):
            return load_bundle(path)
        raise
    logger.info(
        "Loaded reference-format index: %d entries, modulo %d",
        len(arrays.kmers),
        arrays.modulo,
    )
    return KmerIndex.from_arrays(arrays)


def load_bundle(path) -> KmerIndex:
    """Index bundle: a zip archive holding a kmer_index ``.npz`` member
    (``graph_kmer_index.IndexBundle``, ``util.py:51-53``)."""
    with zipfile.ZipFile(path) as zf:
        names = [n for n in zf.namelist() if "kmer_index" in n]
        if not names:
            raise ValueError(f"bundle {path} has no kmer_index member")
        with zf.open(names[0]) as member:
            payload = io.BytesIO(member.read())
    if _is_tpuidx(payload):
        payload.seek(0)
        return KmerIndex.from_file(payload)
    payload.seek(0)
    return KmerIndex.from_arrays(load_reference_npz(payload))


def build_toy_index(
    n_unique: int, k: int, n_nodes: int, seed: int = 0, dup_fraction: float = 0.2
) -> KmerIndexArrays:
    """A reference-layout index of random kmers, for tests and benchmarks."""
    rng = np.random.default_rng(seed)
    mask = np.uint64(4**k - 1) if k < 32 else np.uint64(0xFFFFFFFFFFFFFFFF)
    kmers = np.unique(rng.integers(0, 1 << 62, n_unique * 2, dtype=np.uint64) & mask)[:n_unique]
    n_dup = int(len(kmers) * dup_fraction)
    entry_kmers = np.concatenate([kmers, rng.choice(kmers, n_dup)])
    nodes = rng.integers(0, n_nodes, len(entry_kmers)).astype(np.int32)
    modulo = max(2, int(len(entry_kmers) * 1.7) | 1)
    return build_kmer_index(entry_kmers, nodes, modulo)
