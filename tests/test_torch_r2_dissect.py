"""The r2 dissection kernels' twins (``kmer_mapper_tpu_torch.scripts.
r2_kernel_dissect`` and ``r2_window_dissect``) against the Pallas variants
of ``scripts/r2_kernel_dissect.py`` and ``scripts/r2_window_dissect.py``,
run in forced TPU interpret mode on the CPU, bit for bit, and against the
host oracle. The inputs: a dense 1024-bucket table with chains, queries of
which some are invalid, and one chain block whose window spans more than
ten 128-query tiles."""
import importlib.util
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

import kmer_mapper_tpu  # noqa: F401  (imported before the scripts, which import it)
from kmer_mapper_tpu_torch.index import layout
from kmer_mapper_tpu_torch.ops import stream_probe
from kmer_mapper_tpu_torch.ops.stream_count_cases import Case
from kmer_mapper_tpu_torch.ops.u32hash import bucket_from_mlo
from kmer_mapper_tpu_torch.scripts import r2_kernel_dissect, r2_window_dissect

SCRIPTS = Path(__file__).resolve().parents[1] / "scripts"
CAP = 128
#: variants whose Pallas function is defined (nodma reads scratch that was
#: never written; tbhoist does not trace)
A_VARIANTS = ["full", "nomm2", "nomm1", "nohot", "empty", "empty_notb"]
B_VARIANTS = ["full", "nomm1", "empty"]


def load_script(name):
    """``scripts/<name>.py`` as a module, with what its import does to
    ``sys.path`` and JAX's compilation cache dir undone."""
    path, cache = list(sys.path), jax.config.jax_compilation_cache_dir
    try:
        spec = importlib.util.spec_from_file_location(f"_script_{name}", SCRIPTS / f"{name}.py")
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
    finally:
        sys.path[:] = path
        jax.config.update("jax_compilation_cache_dir", cache)
    return module


@pytest.fixture(scope="module")
def pallas():
    return {"a": load_script("r2_kernel_dissect"), "b": load_script("r2_window_dissect")}


@pytest.fixture(scope="module")
def case():
    rng = np.random.default_rng(7)
    keys = np.unique(rng.integers(0, 1 << 62, 5000, dtype=np.uint64))
    table = layout.build_table(keys, n_buckets=1024)
    assert table.n_buckets == 1024 and table.max_probe > 1
    queries = np.concatenate([
        rng.choice(keys, 3000),
        np.full(1500, keys[17]),  # one block's window spans > 10 tiles
        rng.integers(0, 1 << 62, 1000, dtype=np.uint64),
    ])
    valid = rng.random(len(queries)) < 0.9
    valid[3000:4500] = True
    counts0 = rng.integers(0, 1 << 32, table.n_slots, dtype=np.int64).astype(np.uint32)
    counts0[::7] = 0xFFFFFFFF  # hits wrap past 2**32
    return Case("r2_dissect", table, queries, valid, counts0)


def pallas_args(case):
    """The Pallas scripts' arguments for the case's sorted queries: the
    bucket row holds 0xFFFFFFFF for invalid queries, which the Pallas
    kernels skip only through an out-of-range bucket."""
    key_lo, key_hi, counts, keys, off, block_probe, _, _ = case.inputs("cpu")
    m_lo, m_hi = (w.numpy().astype(np.uint32) for w in stream_probe.split_key(keys))
    invalid = (m_lo == 0xFFFFFFFF) & (m_hi == 0xFFFFFFFF)
    sb = np.where(invalid, np.uint32(0xFFFFFFFF),
                  bucket_from_mlo(m_lo, case.table.n_buckets).astype(np.uint32))
    return (jnp.asarray(case.table.key_lo), jnp.asarray(case.table.key_hi),
            jnp.asarray(case.counts0), jnp.asarray(sb), jnp.asarray(m_lo),
            jnp.asarray(m_hi), jnp.asarray(off.numpy()), case.table.max_probe,
            jnp.asarray(block_probe.numpy()))


def port(fn, case, variant):
    args = case.inputs("cpu")
    got = fn(*args, case.table.max_probe, variant)
    return got.numpy().view(np.uint32)


def test_case_has_a_long_window_and_invalid_queries(case):
    _, _, _, keys, off, _, _, _ = case.inputs("cpu")
    assert int((off[1:] - off[:-1]).max()) > 10 * CAP
    assert int((keys == torch.iinfo(torch.int64).max).sum()) > 0


@pytest.mark.parametrize("variant", A_VARIANTS)
def test_kernel_dissect_twin_matches_pallas(variant, case, pallas):
    with pltpu.force_tpu_interpret_mode():
        expect = np.asarray(pallas["a"].stream_count_v(
            *pallas_args(case), variant, cap=CAP, coarse=8))
    got = port(r2_kernel_dissect.stream_count_v, case, variant)
    np.testing.assert_array_equal(got, expect)
    if variant.startswith("empty"):
        np.testing.assert_array_equal(got, case.counts0)
    else:
        assert not np.array_equal(got, case.counts0)


@pytest.mark.parametrize("variant", B_VARIANTS)
def test_window_dissect_twin_matches_pallas(variant, case, pallas, monkeypatch):
    monkeypatch.setattr(pallas["b"], "CAP", CAP)
    with pltpu.force_tpu_interpret_mode():
        expect = np.asarray(pallas["b"].stream_count_v(*pallas_args(case), variant))
    got = port(r2_window_dissect.stream_count_v, case, variant)
    np.testing.assert_array_equal(got, expect)


@pytest.mark.parametrize("module", [r2_kernel_dissect, r2_window_dissect])
def test_full_twin_matches_oracle_and_stream_count(module, case):
    got = port(module.stream_count_v, case, "full")
    np.testing.assert_array_equal(got, case.expected())
    ref = stream_probe.stream_count(*case.inputs("cpu")).numpy().view(np.uint32)
    np.testing.assert_array_equal(got, ref)


def test_tbhoist_runs_as_full(case):
    np.testing.assert_array_equal(port(r2_kernel_dissect.stream_count_v, case, "tbhoist"),
                                  port(r2_kernel_dissect.stream_count_v, case, "full"))
