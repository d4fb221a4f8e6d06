"""The step-overhead kernel's twin (``kmer_mapper_tpu_torch.scripts.
r9_step_parts``) against the Pallas variants of ``scripts/r9_step_parts.py``
run in forced TPU interpret mode on the CPU, bit for bit, at GRID 3, TILES 2
and LANES 256; and the Pallas result pinned as counts_in plus the last grid
step alone."""
import importlib.util
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from kmer_mapper_tpu_torch.scripts import r9_step_parts as S

SCRIPT = Path(__file__).resolve().parents[1] / "scripts" / "r9_step_parts.py"
GRID, TILES, LANES = 3, 2, 256


@pytest.fixture(scope="module")
def pallas():
    """``scripts/r9_step_parts.py`` as a module, with what its import does
    to ``sys.path`` and JAX's compilation cache dir undone."""
    path, cache = list(sys.path), jax.config.jax_compilation_cache_dir
    try:
        spec = importlib.util.spec_from_file_location("_script_r9_step_parts", SCRIPT)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
    finally:
        sys.path[:] = path
        jax.config.update("jax_compilation_cache_dir", cache)
    return module


def inputs(kind, variant):
    """(key_lo, key_hi, counts_in, q) uint32 numpy arrays: the script's
    uniform random keys and queries from zero counts, or the port's
    hit-dense recipe (random counts_in)."""
    shape = S.step_shape(S.FLAGS[variant], S.COARSE)
    if kind == "script":
        rng = np.random.default_rng(8)
        klo, khi = (rng.integers(0, 1 << 32, shape, dtype=np.uint32) for _ in range(2))
        q = rng.integers(0, 1 << 32, (2, LANES), dtype=np.uint32)
        return klo, khi, np.zeros(shape, np.uint32), q
    return tuple(x.numpy().view(np.uint32) for x in S.make_inputs("cpu", variant, LANES, seed=9))


def run_pallas(pallas, monkeypatch, variant, arrays):
    for name, value in (("GRID", GRID), ("TILES", TILES), ("LANES", LANES)):
        monkeypatch.setattr(pallas, name, value)
    with pltpu.force_tpu_interpret_mode():
        call, kshape, cshape = pallas.make_kernel(variant)  # built inside the context
        out = np.asarray(call(*(jnp.asarray(a) for a in arrays)))
    assert kshape == cshape == arrays[0].shape
    return out


def twin(variant, arrays):
    t = [torch.from_numpy(a.view(np.int32)) for a in arrays]
    return S.step_parts(*t, variant, GRID, TILES).numpy().view(np.uint32)


@pytest.mark.parametrize("kind", ["script", "dense"])
@pytest.mark.parametrize("variant", S.VARIANTS)
def test_twin_matches_pallas(variant, kind, pallas, monkeypatch):
    arrays = inputs(kind, variant)
    expect = run_pallas(pallas, monkeypatch, variant, arrays)
    np.testing.assert_array_equal(twin(variant, arrays), expect)
    if kind == "dense":
        assert (expect != arrays[2]).any()  # the tile body found hits


def test_pallas_result_is_counts_in_plus_the_last_step(pallas, monkeypatch):
    """Every key and query equal: each of the 2 tiles of a step adds its
    live lanes into the same 8 key lanes, and the result holds one step's
    worth, not GRID steps'."""
    shape = S.step_shape(0, S.COARSE)
    arrays = (np.full(shape, 5, np.uint32), np.full(shape, 7, np.uint32),
              np.full(shape, 3, np.uint32), np.stack([np.full(LANES, 5), np.full(LANES, 7)])
              .astype(np.uint32))
    expect = run_pallas(pallas, monkeypatch, "newfull", arrays)
    one_step = sum(LANES - (t & 63) for t in range(TILES)) * S.K
    assert int(expect.astype(np.int64).sum() - arrays[2].astype(np.int64).sum()) == one_step
    np.testing.assert_array_equal(twin("newfull", arrays), expect)
    dense = inputs("dense", "newfull")
    every_step = S.steps_twin(*(torch.from_numpy(a.view(np.int32)) for a in dense), 0,
                              torch.arange(GRID), TILES).numpy().view(np.uint32)
    assert not np.array_equal(run_pallas(pallas, monkeypatch, "newfull", dense), every_step)
