"""The dot-orientation kernel's twin (``kmer_mapper_tpu_torch.scripts.
r9_dot_orient``) against the Pallas variants of ``scripts/r9_dot_orient.py``
run in forced TPU interpret mode on the CPU, bit for bit, at ITERS 8 and
LANES 256."""
import importlib.util
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from kmer_mapper_tpu_torch.scripts import r9_dot_orient as D

SCRIPT = Path(__file__).resolve().parents[1] / "scripts" / "r9_dot_orient.py"
ITERS, LANES = 8, 256


@pytest.fixture(scope="module")
def pallas():
    """``scripts/r9_dot_orient.py`` as a module, with what its import does
    to ``sys.path`` and JAX's compilation cache dir undone."""
    path, cache = list(sys.path), jax.config.jax_compilation_cache_dir
    try:
        spec = importlib.util.spec_from_file_location("_script_r9_dot_orient", SCRIPT)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
    finally:
        sys.path[:] = path
        jax.config.update("jax_compilation_cache_dir", cache)
    return module


def inputs(kind, variant):
    """(tb float32 holding bf16 values, q uint32) as numpy: the script's
    uniform random bytes and queries, the port's hit-dense recipe, or the
    hit-dense tile with carries between planes (g0 + 256, g1 - 1), which
    the float32 packing counts as the same key."""
    if kind == "script":
        rng = np.random.default_rng(4)
        tb = rng.integers(0, 256, D.tb_shape(variant)).astype(np.float32)
        return tb, rng.integers(0, 1 << 32, (2, LANES), dtype=np.uint32)
    tb, q = D.make_inputs("cpu", variant, LANES, seed=6)
    tb = tb.to(torch.float32).numpy().copy()
    if kind == "carry":
        planes = tb.T if D.LAYOUTS[variant][0] else tb  # (W8, GPB): row p*8+k
        g0, g1 = planes[: D.K], planes[D.K : 2 * D.K]  # views
        carry = (g0 % 2 == 0) & (g1 >= 1) & (np.random.default_rng(7).random(g0.shape) < 0.5)
        g0[carry] += 256  # exact in bf16: even values below 512
        g1[carry] -= 1
        assert carry.any()
    return tb, q.numpy().view(np.uint32)


@pytest.mark.parametrize("kind", ["script", "dense", "carry"])
@pytest.mark.parametrize("variant", D.VARIANTS)
def test_twin_matches_pallas(variant, kind, pallas, monkeypatch):
    monkeypatch.setattr(pallas, "ITERS", ITERS)
    monkeypatch.setattr(pallas, "LANES", LANES)
    tb, q = inputs(kind, variant)
    with pltpu.force_tpu_interpret_mode():
        call, shape = pallas.make_kernel(variant)  # built inside the context
        expect = np.asarray(call(jnp.asarray(tb, dtype=jnp.bfloat16), jnp.asarray(q)))
    assert shape == D.tb_shape(variant)
    got = D.dot_orient(torch.from_numpy(tb).to(torch.bfloat16),
                       torch.from_numpy(q.view(np.int32)), variant, ITERS).numpy()
    np.testing.assert_array_equal(got.view(np.uint32), expect)
    if kind != "script":
        assert expect.sum() > 0  # the tile body found hits
