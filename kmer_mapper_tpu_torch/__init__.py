"""kmer_mapper_tpu on PyTorch and CUDA.

``kmer_mapper_tpu`` ported to torch, with its TPU kernels rewritten by hand
in CUDA C++ for Hopper (``csrc/``): the file path with its native host
loader (``native/``, built with g++ at first use), the pre-hashed library
calls, the reference's entry functions and every index form. The package
imports torch and numpy and never jax or ``kmer_mapper_tpu``; its numpy
host layers are copies of the JAX package's, held identical to them by
``tests/test_torch_*.py``. Importing it builds nothing: the kernels are
built with nvcc at their first launch.

    from kmer_mapper_tpu_torch import pipeline
    counts = pipeline.map_file("index.npz", "reads.fq", device="cuda")

    from kmer_mapper_tpu_torch import map_kmers_to_graph_index
    counts = map_kmers_to_graph_index("index.npz", kmers=hashes)  # device="cuda"
"""
from . import oracle
from .compat import TpuCounter, in_graph_index, map_kmers_to_graph_index
from .index.kmer_index import KmerIndex, load_index
from .models.mapper import KmerMapper, MapperConfig

__all__ = [
    "oracle",
    "load_index",
    "KmerIndex",
    "KmerMapper",
    "MapperConfig",
    "map_kmers_to_graph_index",
    "in_graph_index",
    "TpuCounter",
]
