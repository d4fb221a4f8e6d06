"""The iteration-floor kernel's twin (``kmer_mapper_tpu_torch.scripts.
r3_iter_floor``) against the Pallas variants of ``scripts/r3_iter_floor.py``
run in forced TPU interpret mode on the CPU, bit for bit, at CAP 128,
N_ITER 8 and N_GRID 2."""
import importlib.util
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from kmer_mapper_tpu_torch.scripts import r3_iter_floor

SCRIPT = Path(__file__).resolve().parents[1] / "scripts" / "r3_iter_floor.py"
CAP, N_ITER, N_GRID = 128, 8, 2
#: variants whose Pallas function is defined (vmem and mm read scratch that
#: was never written)
VARIANTS = ["loop", "smem", "dma", "full", "grid"]
#: the float32 just above the bf16 tie between 1.0 and 1.0078125
ABOVE_TIE = np.nextafter(np.float32(1.00390625), np.float32(2))


@pytest.fixture(scope="module")
def pallas():
    """``scripts/r3_iter_floor.py`` as a module, with what its import does
    to ``sys.path`` and JAX's compilation cache dir undone."""
    path, cache = list(sys.path), jax.config.jax_compilation_cache_dir
    try:
        spec = importlib.util.spec_from_file_location("_script_r3_iter_floor", SCRIPT)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
    finally:
        sys.path[:] = path
        jax.config.update("jax_compilation_cache_dir", cache)
    return module


def inputs(kind):
    """(off, tb, q) as numpy: the script's random recipe, the port's dense
    recipe (hits in the tile compute), large scalars (the int32 carry
    wraps), or tb values near 1.0 that bf16 rounds to 1.0 or away from it."""
    rng = np.random.default_rng(3)
    if kind == "script":
        off = rng.integers(0, 1 << 20, 2 * 8192, dtype=np.int32)
        tb = rng.random((128, 64), dtype=np.float32)
        q = rng.integers(0, 1 << 30, (4, 64 * CAP), dtype=np.int64).astype(np.uint32)
        return off, tb, q
    off, tb, q = (x.numpy() for x in r3_iter_floor.make_inputs("cpu", CAP, seed=5))
    q = q.view(np.uint32).copy()
    if kind == "wrap":
        off = rng.integers(1 << 30, (1 << 31) - 1, 2 * 8192, dtype=np.int64).astype(np.int32)
    elif kind == "bf16":
        q[1:] = 0x01010101  # every byte plane is 1
        # each key plane rounds to 1.0 (exactly, or from a tie below or
        # above it), except one plane of every other key, which rounds away
        to_one = np.float32([1.0, 1.00390625, 0.998046875])
        tb = to_one[rng.integers(0, 3, (128, 8, 8))]
        away = rng.random((128, 8)) < 0.5
        rows, lanes = np.nonzero(away)
        tb[rows, rng.integers(0, 8, len(rows)), lanes] = ABOVE_TIE
        tb = tb.reshape(128, 64)
    return off, tb, q


#: every variant on the script's and the dense inputs; large scalars where
#: they change only the carry (full's windows would wrap as int32 in the
#: reference); the bf16 inputs on full, the only variant that reads tb
CASES = ([(v, kind) for kind in ("script", "dense") for v in VARIANTS]
         + [("smem", "wrap"), ("dma", "wrap"), ("full", "bf16")])


@pytest.mark.parametrize("variant,kind", CASES)
def test_twin_matches_pallas(variant, kind, pallas, monkeypatch):
    for name, value in (("CAP", CAP), ("N_ITER", N_ITER), ("N_GRID", N_GRID)):
        monkeypatch.setattr(pallas, name, value)
    off, tb, q = inputs(kind)
    with pltpu.force_tpu_interpret_mode():
        expect = np.asarray(pallas.make_variant(variant)(
            jnp.asarray(off), jnp.asarray(tb), jnp.asarray(q)))
    got = r3_iter_floor.iter_floor(
        torch.from_numpy(off), torch.from_numpy(tb), torch.from_numpy(q.view(np.int32)),
        variant, N_ITER, N_GRID, CAP,
    ).numpy()
    np.testing.assert_array_equal(got.view(np.uint32), expect.view(np.uint32))
    if variant == "full" and kind in ("dense", "bf16"):
        assert got[1:].sum() > 0  # the tile compute found hits


def test_bf16_rounding_matches_jax_near_one():
    """torch's and JAX's bf16 casts both round to nearest even."""
    x = np.float32([1.0, 1.0039062, 1.00390625, ABOVE_TIE, 1.01171875, 0.99609375,
                    0.998046875, 255.0, 254.5])
    got = torch.from_numpy(x).to(torch.bfloat16).to(torch.float32).numpy()
    expect = np.asarray(jnp.asarray(x).astype(jnp.bfloat16).astype(jnp.float32))
    np.testing.assert_array_equal(got, expect)
    np.testing.assert_array_equal(got[:4], np.float32([1.0, 1.0, 1.0, 1.0078125]))
