"""The grid step with its block movement: the port's counterpart of
``scripts/r9_block_pipeline.py``.

    python -m kmer_mapper_tpu_torch.scripts.r9_block_pipeline [variant ...] [--device cpu]

``block_pipeline`` launches ``csrc/r9_block_pipeline.cu``: the steps of
``r9_step_parts`` (``GRID`` steps of ``TILES`` tiles, the tile body of
``csrc/r9_tile.cuh``), where step c owns groups 16c .. 16c+15 of key and
count arrays of ``GRID * COARSE`` = 8192 groups (33.5 MB each): it reads
its key and count blocks, runs its tiles on them and writes its count
block back. The result is counts_in plus every step's tiles.

    new   keys and counts (8192, 8, 128), the 3-D plane layout
    old   keys and counts (1048576, 8), row g*128 + bucket: the 2-D layout

``main`` prints the grid, then ms and ns per tile for each variant.
"""
from __future__ import annotations

import sys

import torch

from .r9_step_parts import (
    BUCKET_MAJOR, COARSE, OWN_BLOCKS, check_steps, launch_steps, make_step_inputs, run_main,
    steps_twin,
)

VARIANTS = ("new", "old")
FLAGS = {"new": OWN_BLOCKS, "old": OWN_BLOCKS | BUCKET_MAJOR}
LANES = 7168
GRID = 512
TILES = 18

launch_counts = {"r9_block_pipeline": 0, "r9_block_pipeline_reference": 0}


def block_pipeline(key_lo, key_hi, counts_in, q, variant: str, grid: int | None = None,
                   tiles: int | None = None) -> torch.Tensor:
    """counts_in plus ``grid`` steps of ``tiles`` tiles (the module's
    ``GRID`` and ``TILES`` by default), each on its own block of 16 groups,
    as a new tensor. Keys and counts are int32 bit patterns of uint32 of
    ``grid * 16`` groups in the variant's layout, ``q`` (2, lanes).

    CUDA tensors launch ``csrc/r9_block_pipeline.cu`` (a failed build or
    launch raises); CPU tensors run :func:`block_pipeline_reference`."""
    grid = GRID if grid is None else grid
    tiles = TILES if tiles is None else tiles
    if variant not in VARIANTS:
        raise ValueError(f"unknown variant {variant!r}; expected one of {VARIANTS}")
    if grid < 1 or tiles < 0:
        raise ValueError(f"r9_block_pipeline: grid={grid} must be >= 1, tiles={tiles} >= 0")
    check_steps("r9_block_pipeline", key_lo, key_hi, counts_in, q, FLAGS[variant],
                grid * COARSE)
    if key_lo.device.type == "cpu":
        return block_pipeline_reference(key_lo, key_hi, counts_in, q, variant, grid, tiles)
    if key_lo.device.type != "cuda":
        raise ValueError(f"r9_block_pipeline: no kernel for device {key_lo.device}")
    out = launch_steps("r9_block_pipeline", key_lo, key_hi, counts_in, q,
                       VARIANTS.index(variant), grid, tiles)
    launch_counts["r9_block_pipeline"] += 1
    return out


def block_pipeline_reference(key_lo, key_hi, counts_in, q, variant: str, grid: int,
                             tiles: int) -> torch.Tensor:
    """Plain-torch twin of the kernel: counts_in plus every step's tiles on
    its own block."""
    launch_counts["r9_block_pipeline_reference"] += 1
    steps = torch.arange(grid, device=key_lo.device)
    return steps_twin(key_lo, key_hi, counts_in, q, FLAGS[variant], steps, tiles)


def make_inputs(device, variant: str = "new", lanes: int | None = None, seed: int = 0):
    """``r9_step_parts.make_step_inputs`` for ``GRID * COARSE`` groups."""
    return make_step_inputs(device, FLAGS[variant], GRID * COARSE,
                            LANES if lanes is None else lanes, seed)


def main(argv=None) -> dict:
    return run_main(sys.modules[__name__], "r9_block_pipeline", block_pipeline, argv)


if __name__ == "__main__":
    main()
