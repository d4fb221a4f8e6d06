"""The benchmark of kmer_mapper_tpu_torch (``python3 -m portbench.run``).

It imports the port (``kmer_mapper_tpu_torch``) and never JAX or the JAX
package; its reference (``reference.py``) imports nothing of the port.
"""
