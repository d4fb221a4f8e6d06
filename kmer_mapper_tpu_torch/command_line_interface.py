"""Drop-in module path of ``kmer_mapper.command_line_interface``.

The torch counterpart of ``kmer_mapper_tpu/command_line_interface.py``: the
reference's ``main`` / ``run_argument_parser`` and its entry functions
``map_bnp``, ``map_cpu`` and ``map_gpu``
(``kmer_mapper/command_line_interface.py:28-152``) over the port's pipeline
and library calls. The reference's signatures name
no device; each function here takes a keyword-only ``device``, ``"cuda"`` by
default, and never moves to the CPU on its own.
"""
from __future__ import annotations

import numpy as np

from .cli import main, run_argument_parser


def map_bnp(args, *, device="cuda"):
    """Run the mapping a parsed-args namespace describes
    (``command_line_interface.py:82-152``). ``args.kmer_index`` may hold an
    in-memory index; returns the node counts where ``output_file`` is None,
    as the reference does, else writes them there."""
    from . import pipeline
    from .compat import _device
    from .util import _get_kmer_index_from_args

    index = _get_kmer_index_from_args(args)  # -i / -b / in-memory precedence
    node_counts = pipeline.map_file(
        index,
        args.reads,
        device=_device(device),
        k=getattr(args, "kmer_size", 31),
        chunk_size=getattr(args, "chunk_size", 2_500_000),
        max_frequency=getattr(args, "max_hits_per_kmer", 1000),
        map_reverse_complements=bool(getattr(args, "map_reverse_complements", False)),
    )
    output_file = getattr(args, "output_file", None)
    if output_file is None:
        return node_counts
    np.save(output_file, node_counts)
    return None


def map_cpu(args, kmer_index, chunk_sequence, *, device="cuda"):
    """Map one chunk of sequences and return its partial node counts, which
    the caller sums (the reference's pool worker,
    ``command_line_interface.py:32-56``). The third argument is the chunk
    itself (a list of str/bytes sequences or a (bases, lengths) pair), not
    the reference's shared-memory name; N counts as A."""
    from .compat import _as_index, map_kmers_to_graph_index
    from .util import get_kmer_hashes_from_chunk_sequence

    kmer_size = (
        args["kmer_size"] if isinstance(args, dict) else getattr(args, "kmer_size", 31)
    )
    hashes = get_kmer_hashes_from_chunk_sequence(chunk_sequence, kmer_size)
    index = _as_index(kmer_index)
    return map_kmers_to_graph_index(index, index.max_node_id, hashes, device=device)


def map_gpu(index, chunks, k, hash_map_size=0, map_reverse_complements=False, *,
            device="cuda"):
    """The reference's GPU loop (``command_line_interface.py:59-79``): a
    counter built from the index's (kmers, nodes) counts every chunk's
    hashes (and their reverse complements when asked), then the node counts.
    ``chunks`` yields objects with a ``.sequence`` (the reference's shape)
    or plain lists of sequences."""
    from .compat import TpuCounter, _as_index
    from .ops.u32hash import feistel_unmix, join_u64
    from .util import get_kmer_hashes_from_chunk_sequence

    kmers = getattr(index, "_kmers", None)
    nodes = getattr(index, "_nodes", None)
    if kmers is None or nodes is None:
        resolved = _as_index(index)
        m_lo, m_hi = resolved.table.key_words()
        slot = resolved.entry_slot
        kmers = join_u64(*feistel_unmix(m_lo[slot], m_hi[slot], seed=resolved.table.seed))
        nodes = resolved.entry_node
    kmers = np.asarray(kmers, dtype=np.uint64)
    nodes = np.asarray(nodes)
    counter = TpuCounter.from_kmers_and_nodes(kmers, nodes, k, device=device)
    counter.initialize_cuda(hash_map_size)
    for chunk in chunks:
        hashes = get_kmer_hashes_from_chunk_sequence(getattr(chunk, "sequence", chunk), k)
        counter.count(hashes, count_revcomps=map_reverse_complements)
    min_nodes = int(nodes.max()) if len(nodes) else 0
    return counter.get_node_counts(min_nodes=min_nodes)


__all__ = ["main", "run_argument_parser", "map_bnp", "map_cpu", "map_gpu"]
