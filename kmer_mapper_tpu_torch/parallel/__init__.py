"""Multi-device and multi-host mapping (``kmer_mapper_tpu.parallel``)."""
from . import multihost
from .mesh import DATA_AXIS, INDEX_AXIS, make_mesh
from .sharded import ShardedKmerMapper, batch_packed_chunks, finalize

__all__ = [
    "multihost",
    "DATA_AXIS",
    "INDEX_AXIS",
    "make_mesh",
    "ShardedKmerMapper",
    "batch_packed_chunks",
    "finalize",
]
