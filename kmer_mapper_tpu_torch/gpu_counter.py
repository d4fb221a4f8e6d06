"""Drop-in module path of ``kmer_mapper.gpu_counter``, as
``kmer_mapper_tpu/gpu_counter.py`` gives it for the JAX package.

The reference's ``GpuCounter`` wraps the CUDA ``cucounter`` table; here the
same class surface (``from_kmers_and_nodes`` / ``initialize_cuda`` /
``count(..., count_revcomps)`` / ``get_node_counts``) is
:class:`kmer_mapper_tpu_torch.compat.TpuCounter`.
"""
from .compat import TpuCounter

GpuCounter = TpuCounter  # drop-in name

__all__ = ["GpuCounter", "TpuCounter"]
