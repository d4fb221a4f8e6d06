"""The block-pipeline kernel's twin (``kmer_mapper_tpu_torch.scripts.
r9_block_pipeline``) against the Pallas variants of
``scripts/r9_block_pipeline.py`` run in forced TPU interpret mode on the
CPU, bit for bit, at GRID 3, TILES 2 and LANES 256: the script's inputs,
the port's hit-dense ones and its hazards (``S.HAZARDS``)."""
import importlib.util
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from kmer_mapper_tpu_torch.scripts import r9_block_pipeline as P
from kmer_mapper_tpu_torch.scripts import r9_step_parts as S

SCRIPT = Path(__file__).resolve().parents[1] / "scripts" / "r9_block_pipeline.py"
GRID, TILES, LANES = 3, 2, 256


@pytest.fixture(scope="module")
def pallas():
    """``scripts/r9_block_pipeline.py`` as a module, with what its import
    does to ``sys.path`` and JAX's compilation cache dir undone."""
    path, cache = list(sys.path), jax.config.jax_compilation_cache_dir
    try:
        spec = importlib.util.spec_from_file_location("_script_r9_block_pipeline", SCRIPT)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
    finally:
        sys.path[:] = path
        jax.config.update("jax_compilation_cache_dir", cache)
    return module


def inputs(kind, variant):
    """(key_lo, key_hi, counts_in, q) uint32 numpy arrays of GRID * 16
    groups: the script's uniform random keys and queries from zero counts,
    the port's hit-dense recipe (random counts_in), or one of its hazards
    (all-ones keys and lanes, buckets of one key)."""
    flags, n_groups = P.FLAGS[variant], GRID * S.COARSE
    if kind == "script":
        rng = np.random.default_rng(10)
        shape = S.step_shape(flags, n_groups)
        klo, khi = (rng.integers(0, 1 << 32, shape, dtype=np.uint32) for _ in range(2))
        q = rng.integers(0, 1 << 32, (2, LANES), dtype=np.uint32)
        return klo, khi, np.zeros(shape, np.uint32), q
    if kind == "dense":
        arrays = S.make_step_inputs("cpu", flags, n_groups, LANES, seed=12)
    else:
        arrays = S.step_hazard_inputs("cpu", kind, flags, n_groups, LANES, seed=12)
    return tuple(x.numpy().view(np.uint32) for x in arrays)


@pytest.mark.parametrize("kind", ["script", "dense", *S.HAZARDS])
@pytest.mark.parametrize("variant", P.VARIANTS)
def test_twin_matches_pallas(variant, kind, pallas, monkeypatch):
    for name, value in (("GRID", GRID), ("TILES", TILES), ("LANES", LANES)):
        monkeypatch.setattr(pallas, name, value)
    arrays = inputs(kind, variant)
    with pltpu.force_tpu_interpret_mode():
        call, kfull, cfull = pallas.make_kernel(variant)  # built inside the context
        expect = np.asarray(call(*(jnp.asarray(a) for a in arrays)))
    assert kfull == cfull == arrays[0].shape
    got = P.block_pipeline(*(torch.from_numpy(a.view(np.int32)) for a in arrays), variant,
                           GRID, TILES).numpy().view(np.uint32)
    np.testing.assert_array_equal(got, expect)
    if kind != "script":
        # every step's block changed: each step owns its block
        changed = (expect != arrays[2]).reshape(GRID, -1).any(axis=1)
        assert changed.all()
