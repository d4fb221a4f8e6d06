"""The port's package surface against the JAX package's: the names of
``kmer_mapper_tpu.__init__``, the numpy-only library aliases, and the
oracle and encode functions only the tests use, mirroring
``tests/test_device_ops.py:11-38``. Every comparison is exact."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import kmer_mapper_tpu
import kmer_mapper_tpu_torch
from kmer_mapper_tpu import compat as jax_compat
from kmer_mapper_tpu import oracle as jax_oracle
from kmer_mapper_tpu.ops import encode as jax_encode
from kmer_mapper_tpu_torch import compat, oracle
from kmer_mapper_tpu_torch.ops import encode


def test_package_exports_the_jax_names():
    """Every name of the JAX package's __all__ (its TpuKmerIndex is the
    port's KmerIndex) is exported and importable."""
    want = {"KmerIndex" if n == "TpuKmerIndex" else n for n in kmer_mapper_tpu.__all__}
    assert want <= set(kmer_mapper_tpu_torch.__all__)
    for name in kmer_mapper_tpu_torch.__all__:
        assert getattr(kmer_mapper_tpu_torch, name) is not None
    assert kmer_mapper_tpu_torch.default_config(k=21).k == 21


def test_numpy_aliases_match_jax():
    rng = np.random.default_rng(0)
    kmers = rng.integers(0, 1 << 30, 500, dtype=np.uint64)
    arrays = oracle.build_kmer_index(kmers[:300], rng.integers(0, 50, 300).astype(np.int32), 601)
    ref = jax_oracle.build_kmer_index(kmers[:300], arrays.nodes, 601)
    np.testing.assert_array_equal(compat.map_kmers_to_graph_index_numpy(arrays, kmers),
                                  jax_compat.map_kmers_to_graph_index_numpy(ref, kmers))
    np.testing.assert_array_equal(compat.in_graph_index_numpy(arrays, kmers),
                                  jax_compat.in_graph_index_numpy(ref, kmers))


def test_device_encode_matches_oracle():
    ascii_bytes = np.frombuffer(b"ACGTacgtNnACGT", dtype=np.uint8)
    codes, invalid = encode.encode_bases(torch.from_numpy(ascii_bytes.copy()))
    np.testing.assert_array_equal(codes.numpy(), oracle.encode_bytes(ascii_bytes))
    assert int(invalid.sum()) == 0
    bad = np.frombuffer(b"AXG", dtype=np.uint8)
    codes, invalid = encode.encode_bases(torch.from_numpy(bad.copy()))
    np.testing.assert_array_equal(invalid.numpy(), [0, 1, 0])
    jax_codes, jax_invalid = jax_encode.encode_bases(jnp.asarray(bad))
    np.testing.assert_array_equal(codes.numpy(), np.asarray(jax_codes))
    np.testing.assert_array_equal(invalid.numpy(), np.asarray(jax_invalid))


def test_host_pack_device_unpack_roundtrip():
    rng = np.random.default_rng(0)
    bases = rng.choice(np.frombuffer(b"ACGTacgtNn", dtype=np.uint8), 1000)
    out_words = (len(bases) + 15) // 16 + 2
    packed, n_invalid = encode.host_encode_pack(bases, out_words)
    assert n_invalid == 0
    codes = encode.unpack_codes(torch.from_numpy(packed.astype(np.int64))).numpy()
    np.testing.assert_array_equal(codes[: len(bases)], oracle.encode_bytes(bases))
    np.testing.assert_array_equal(codes[len(bases) :], 0)
    np.testing.assert_array_equal(codes, np.asarray(jax_encode.unpack_codes(jnp.asarray(packed))))
    packed, n_invalid = encode.host_encode_pack(np.frombuffer(b"AXGZ", np.uint8), 1)
    assert n_invalid == 2


@pytest.mark.parametrize("k", [1, 5, 16, 31])
def test_oracle_copies_match_jax(k):
    rng = np.random.default_rng(k)
    seq = "".join(rng.choice(list("ACGT"), 200))
    codes = oracle.encode_string(seq)
    np.testing.assert_array_equal(codes, jax_oracle.encode_string(seq))
    assert oracle.decode_to_string(codes) == seq == jax_oracle.decode_to_string(codes)
    conv = oracle.kmer_hashes_convolve(codes, k)
    np.testing.assert_array_equal(conv, oracle.kmer_hashes(codes, k))
    np.testing.assert_array_equal(conv, jax_oracle.kmer_hashes_convolve(codes, k))
    assert len(oracle.kmer_hashes_convolve(codes[: k - 1], k)) == 0
