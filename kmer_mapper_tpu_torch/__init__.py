"""kmer_mapper_tpu on PyTorch and CUDA.

The fixed-read-length mapping path of ``kmer_mapper_tpu`` ported to torch,
with its one TPU kernel rewritten in CUDA C++ for Hopper
(``csrc/stream_count.cu``). The package imports torch and numpy and never
jax or ``kmer_mapper_tpu``; its numpy host layers are copies of the JAX
package's, held identical to them by ``tests/test_torch_*.py``.

    from kmer_mapper_tpu_torch import pipeline
    counts = pipeline.map_file("index.npz", "reads.fq", device="cuda")
"""
