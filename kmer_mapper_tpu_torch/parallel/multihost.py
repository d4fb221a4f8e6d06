"""Several hosts, one job: each maps its own shard of the input files.

The torch counterpart of ``kmer_mapper_tpu/parallel/multihost.py``. Every
process runs its own input pipeline over a disjoint shard of the reads
(:func:`host_shard`), maps it on its local devices, and the node-count
vectors are summed once at the end:

* **One process group**: call :func:`initialize` in every process, map each
  process's shard with ``pipeline.map_file_sharded``; its
  ``ShardedKmerMapper.node_counts`` all-reduces the vector across the
  processes, so every process gets the whole job's counts.
* **Independent jobs**: run one ``map_file`` per host on its shard and
  combine the saved ``.npy`` vectors with :func:`merge_node_counts`.
"""
from __future__ import annotations

import numpy as np
import torch


def initialize(coordinator_address: str | None = None, num_processes: int | None = None,
               process_id: int | None = None, backend: str | None = None) -> None:
    """Join the ``torch.distributed`` process group: ``coordinator_address``
    is the ``host:port`` of process 0 (``tcp://`` is added), the backend nccl
    where CUDA is available, else gloo. A second call keeps the existing
    group."""
    import torch.distributed as dist

    if dist.is_initialized():
        return
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    init_method = None if coordinator_address is None else f"tcp://{coordinator_address}"
    dist.init_process_group(backend, init_method=init_method, world_size=num_processes,
                            rank=process_id)


def process_index_and_count() -> tuple[int, int]:
    """(rank, world size) of the process group, (0, 1) outside one."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def host_shard(paths: list, process_index: int | None = None,
               process_count: int | None = None) -> list:
    """The items of ``paths`` this process maps (round-robin)."""
    rank, world = process_index_and_count()
    i = rank if process_index is None else process_index
    n = world if process_count is None else process_count
    return [p for j, p in enumerate(paths) if j % n == i]


def merge_node_counts(count_vectors) -> np.ndarray:
    """Sum per-host node-count vectors of any lengths; a sum past the uint32
    range is clamped to its top."""
    arrays = [np.asarray(v) for v in count_vectors]
    n = max(len(a) for a in arrays)
    out = np.zeros(n, dtype=np.uint64)
    for a in arrays:
        out[: len(a)] += a.astype(np.uint64)
    return np.minimum(out, np.iinfo(np.uint32).max).astype(np.uint32)
