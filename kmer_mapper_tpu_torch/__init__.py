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

    from kmer_mapper_tpu_torch import map_file_sharded
    counts = map_file_sharded("index.npz", "reads.fq", index_parallel=2)  # every card
"""
from . import oracle
from .compat import TpuCounter, in_graph_index, map_kmers_to_graph_index
from .index.kmer_index import KmerIndex, load_index, load_reference_npz, save_reference_npz
from .models.mapper import KmerMapper, MapperConfig, default_config
from .oracle import KmerIndexArrays, build_kmer_index
from .pipeline import map_file, map_file_sharded, map_sequences

__version__ = "0.1.0"

__all__ = [
    "oracle",
    "KmerIndex",
    "load_index",
    "load_reference_npz",
    "save_reference_npz",
    "KmerIndexArrays",
    "build_kmer_index",
    "KmerMapper",
    "MapperConfig",
    "default_config",
    "map_file",
    "map_file_sharded",
    "map_sequences",
    "map_kmers_to_graph_index",
    "in_graph_index",
    "TpuCounter",
    "__version__",
]
