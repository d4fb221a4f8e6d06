"""Drop-in module path of ``kmer_mapper.mapper`` (the reference's compiled
Cython extension, ``kmer_mapper/mapper.pyx``), as ``kmer_mapper_tpu/mapper.py``
gives it for the JAX package.

KAGE-style callers do ``from kmer_mapper.mapper import map_kmers_to_graph_index``;
the same import works with only the package name changed. Bodies live in
:mod:`kmer_mapper_tpu_torch.compat`.
"""
from .compat import in_graph_index, map_kmers_to_graph_index

# the reference's no-memory-maps variant exists "so that ray-stuff works"
# (``mapper.pyx:137-190``); there are no memoryview workers here, so it is
# the same function
in_graph_index_no_memory_maps = in_graph_index

__all__ = [
    "map_kmers_to_graph_index",
    "in_graph_index",
    "in_graph_index_no_memory_maps",
]
