"""The parts of a grid step's overhead around the tile body: the port's
counterpart of ``scripts/r9_step_parts.py``.

    python -m kmer_mapper_tpu_torch.scripts.r9_step_parts [variant ...] [--device cpu]

``step_parts`` launches ``csrc/r9_step_parts.cu``: ``GRID`` steps of
``TILES`` tiles over one block of ``COARSE`` = 16 key groups (128 buckets x
8 key lanes of (lo, hi) words each) and their uint32 counts. Tile t of step
c runs the tile body of ``csrc/r9_tile.cuh`` on key group
``g = (7 t + c) % 16``: lane l looks at bucket ``(37 l + t + c) & 127``, is
live when ``l >= t & 63``, and each key lane whose (lo, hi) equals the
lane's query adds one to count group g at (key lane, bucket). As in the
Pallas kernel, whose counts have a constant block index and are reset to
``counts_in`` at every step, the result is ``counts_in`` plus the LAST
step's tiles; every step still does its work.

    newfull    keys and counts (16, 8, 128), the 3-D plane layout
    tbstatic   newfull, every tile reads key group 0
    rmwstatic  newfull, every tile adds into count group 0
    noprep     newfull, the keys staged once per CTA (persistent CTAs, each
               on its first step), where newfull stages them every step
    oldfull    keys and counts (2048, 8), row g*128 + bucket: the 2-D layout

The kernel runs the steps on persistent CTAs, one per SM, each with the
whole block in shared memory (128 KB of key words, 64 KB of counts and a
word of 4-bit key fingerprints a bucket, 8 KB), staged with 16-byte copies:
a live lane reads its bucket's fingerprint word and compares key words only
in the key lanes whose fingerprint is its query's. ``candidate_loop``
counts, in torch, the candidates a live lane meets and the trips a warp's
candidate loop makes. ``main`` prints the grid, then ms and ns per tile for
each variant.
"""
from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from .. import native
from ..ops.u32hash import MASK32, from_int32_bits, to_int32_bits
from . import device_arg, device_name, median_ms, pick_device
from .r9_dot_orient import GPB, K, fingerprint, key_pool, loop_counts, pool_queries, tile_counts

VARIANTS = ("newfull", "tbstatic", "rmwstatic", "noprep", "oldfull")
#: csrc/r9_tile.cuh StepFlags
BUCKET_MAJOR, TB_STATIC, RMW_STATIC, PREP_ONCE, OWN_BLOCKS = 1, 2, 4, 8, 16
FLAGS = {"newfull": 0, "tbstatic": TB_STATIC, "rmwstatic": RMW_STATIC,
         "noprep": PREP_ONCE, "oldfull": BUCKET_MAJOR}
LANES = 7168
COARSE = 16  # key groups of a step
GRID = 512  # steps: 8192 chain blocks / COARSE
TILES = 18  # tiles per step: ~ the bench's tile count per chunk
STEP_THREADS = 1024

#: step inputs with keys the tile body must not treat specially
#: (``step_hazard_inputs``)
HAZARDS = ("allones", "onekey")

launch_counts = {"r9_step_parts": 0, "r9_step_parts_reference": 0}


def step_shape(flags: int, n_groups: int) -> tuple:
    """Shape of the key and count arrays of ``n_groups`` groups."""
    return (n_groups * GPB, K) if flags & BUCKET_MAJOR else (n_groups, K, GPB)


def check_steps(name, key_lo, key_hi, counts_in, q, flags: int, n_groups: int):
    """Raises ValueError unless the step kernels' arguments fit."""
    shape = step_shape(flags, n_groups)
    expect = ((key_lo, shape), (key_hi, shape), (counts_in, shape), (q, (2, q.shape[-1])))
    for arg, (t, s) in zip(("key_lo", "key_hi", "counts_in", "q"), expect):
        if t.dtype != torch.int32 or tuple(t.shape) != s:
            raise ValueError(f"{name}: {arg} is {t.dtype}{tuple(t.shape)}, "
                             f"expected torch.int32{s}")
        if not t.is_contiguous() or t.device != key_lo.device:
            raise ValueError(f"{name}: {arg} must be contiguous, on {key_lo.device}")
    if q.shape[1] < 1:
        raise ValueError(f"{name}: no query lanes")


def steps_twin(key_lo, key_hi, counts_in, q, flags: int, steps: torch.Tensor,
               tiles: int) -> torch.Tensor:
    """counts_in plus the tiles of ``steps`` (the step ids whose counts
    reach the result), for the step kernels' flags; same contract and bits
    as the kernels."""
    bucket_major = flags & BUCKET_MAJOR
    n_groups = key_lo.numel() // (K * GPB)

    def by_key_lane(x):  # (group, key lane, bucket) order, flat
        return x.view(n_groups, GPB, K).transpose(1, 2).reshape(-1) if bucket_major else x.view(-1)

    klo, khi = by_bucket(key_lo, flags), by_bucket(key_hi, flags)
    q_lo, q_hi = from_int32_bits(q[0]), from_int32_bits(q[1])
    t, c, g_tb, g_cnt = step_tiles(flags, steps, tiles)

    def match(sel, bp):
        rows = g_tb[sel, None]
        return (klo[rows, bp] == q_lo[None, :, None]) & (khi[rows, bp] == q_hi[None, :, None])

    hits = tile_counts(match, t, c, g_cnt, q.shape[1], n_groups)
    total = to_int32_bits((by_key_lane(from_int32_bits(counts_in)) + hits) & MASK32)
    if bucket_major:
        total = total.view(n_groups, K, GPB).transpose(1, 2)
    return total.reshape(counts_in.shape).contiguous()


def by_bucket(x, flags: int) -> torch.Tensor:
    """int64 (group, bucket, key lane) words of int32 keys in the layout of
    ``flags``."""
    n_groups = x.numel() // (K * GPB)
    x = from_int32_bits(x)
    return x.view(n_groups, GPB, K) if flags & BUCKET_MAJOR else x.transpose(1, 2)


def step_tiles(flags: int, steps: torch.Tensor, tiles: int):
    """(t, c, g_tb, g_cnt), one entry a tile of each step of ``steps``: the
    tile index, the step, and the key and count group it runs on."""
    t = torch.arange(tiles, device=steps.device).repeat(steps.numel())
    c = steps.repeat_interleave(tiles)
    g = (t * 7 + c) % COARSE
    base = c * COARSE if flags & OWN_BLOCKS else torch.zeros_like(c)
    return (t, c, base + (0 if flags & TB_STATIC else g),
            base + (0 if flags & RMW_STATIC else g))


def step_parts(key_lo, key_hi, counts_in, q, variant: str, grid: int | None = None,
               tiles: int | None = None) -> torch.Tensor:
    """counts_in plus the last of ``grid`` steps of ``tiles`` tiles (the
    module's ``GRID`` and ``TILES`` by default), as a new tensor. Keys and
    counts are int32 bit patterns of uint32 in the variant's layout
    (:func:`step_shape`), ``q`` (2, lanes).

    CUDA tensors launch ``csrc/r9_step_parts.cu`` (a failed build or launch
    raises); CPU tensors run :func:`step_parts_reference`."""
    grid = GRID if grid is None else grid
    tiles = TILES if tiles is None else tiles
    if variant not in VARIANTS:
        raise ValueError(f"unknown variant {variant!r}; expected one of {VARIANTS}")
    check_steps("r9_step_parts", key_lo, key_hi, counts_in, q, FLAGS[variant], COARSE)
    if grid < 1 or tiles < 0:
        raise ValueError(f"r9_step_parts: grid={grid} must be >= 1, tiles={tiles} >= 0")
    if key_lo.device.type == "cpu":
        return step_parts_reference(key_lo, key_hi, counts_in, q, variant, grid, tiles)
    if key_lo.device.type != "cuda":
        raise ValueError(f"r9_step_parts: no kernel for device {key_lo.device}")
    if any(t.data_ptr() % 16 for t in (key_lo, key_hi, counts_in)):
        raise ValueError("r9_step_parts: keys and counts must start on 16 bytes (16-byte "
                         "copies)")
    dev = key_lo.device
    out = torch.empty_like(counts_in)
    ctas = n_ctas(dev, grid)  # persistent: one per SM, at most one per step
    sink = torch.empty(ctas * STEP_THREADS, dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        rc = native.library().r9_step_parts_launch(
            key_lo.data_ptr(), key_hi.data_ptr(), counts_in.data_ptr(), q.data_ptr(),
            out.data_ptr(), sink.data_ptr(), grid, tiles, q.shape[1], ctas,
            VARIANTS.index(variant), dev.index, torch.cuda.current_stream().cuda_stream,
        )
    if rc:
        raise RuntimeError(f"r9_step_parts kernel launch failed: {native.error_string(rc)}")
    launch_counts["r9_step_parts"] += 1
    return out


def step_parts_reference(key_lo, key_hi, counts_in, q, variant: str, grid: int,
                         tiles: int) -> torch.Tensor:
    """Plain-torch twin of the kernel: counts_in plus step ``grid - 1``
    alone, since every step starts again from counts_in."""
    launch_counts["r9_step_parts_reference"] += 1
    last = torch.full((1,), grid - 1, dtype=torch.int64, device=key_lo.device)
    return steps_twin(key_lo, key_hi, counts_in, q, FLAGS[variant], last, tiles)


def candidate_loop(key_lo, key_hi, counts_in, q, variant: str, grid: int | None = None,
                   tiles: int | None = None) -> dict:
    """:func:`steps_candidate_loop` of the kernel over all ``grid`` steps
    (each does its tiles' work)."""
    grid = GRID if grid is None else grid
    tiles = TILES if tiles is None else tiles
    flags = FLAGS[variant]
    check_steps("r9_step_parts", key_lo, key_hi, counts_in, q, flags, COARSE)
    return steps_candidate_loop(key_lo, key_hi, q, flags, grid, tiles)


def steps_candidate_loop(key_lo, key_hi, q, flags: int, grid: int, tiles: int) -> dict:
    """``r9_dot_orient.loop_counts`` of a step kernel's ``grid`` steps of
    ``tiles`` tiles for the kernel's flags: a lane's candidates are the key
    lanes of its bucket whose fingerprint of (lo, hi) equals its query's,
    its hits those whose words do."""
    klo, khi = by_bucket(key_lo, flags), by_bucket(key_hi, flags)
    key_fp = fingerprint(klo, khi)
    q_lo, q_hi = from_int32_bits(q[0]), from_int32_bits(q[1])
    q_fp = fingerprint(q_lo, q_hi)
    t, c, g_tb, _ = step_tiles(flags, torch.arange(grid, device=q.device), tiles)

    def candidates(sel, bp):
        return key_fp[g_tb[sel, None], bp] == q_fp[None, :, None]

    def hits(sel, bp):
        rows = g_tb[sel, None]
        return (klo[rows, bp] == q_lo[None, :, None]) & (khi[rows, bp] == q_hi[None, :, None])

    return loop_counts(candidates, hits, t, c, q.shape[1])


def step_keys(n_groups: int, lanes: int, seed: int = 0):
    """(key_lo, key_hi, counts_in) int64 (n_groups, K, GPB) and q uint32
    (2, lanes) of :func:`make_step_inputs`, in the 3-D layout, as numpy."""
    rng = np.random.default_rng(seed)
    pool = key_pool(rng)
    keys = pool[rng.integers(0, len(pool), (n_groups, K, GPB))]  # (g, k, b, word)
    counts = rng.integers(0, 1 << 32, (n_groups, K, GPB), dtype=np.int64)
    return keys[..., 0], keys[..., 1], counts, pool_queries(rng, pool, lanes)


def step_tensors(device, flags: int, key_lo, key_hi, counts, q):
    """The numpy arrays of :func:`step_keys` as int32 bit patterns on
    ``device``, keys and counts in the layout of ``flags``."""
    arrays = [key_lo, key_hi, counts]
    if flags & BUCKET_MAJOR:
        n_groups = key_lo.shape[0]
        arrays = [a.transpose(0, 2, 1).reshape(n_groups * GPB, K) for a in arrays]
    return tuple(torch.from_numpy(np.ascontiguousarray(a).astype(np.uint32).view(np.int32))
                 .to(device) for a in (*arrays, q))


def make_step_inputs(device, flags: int, n_groups: int, lanes: int, seed: int = 0):
    """(key_lo, key_hi, counts_in, q) int32 bit patterns in the layout of
    ``flags``, built so that the tile body hits: every key slot holds a key
    of a pool of ``r9_dot_orient.POOL``, and most query lanes too;
    counts_in is random. One seed gives the same keys in both layouts."""
    return step_tensors(device, flags, *step_keys(n_groups, lanes, seed))


def step_hazard_inputs(device, kind: str, flags: int, n_groups: int, lanes: int,
                       seed: int = 0):
    """:func:`make_step_inputs` with keys a fingerprinted tile could treat
    specially:

    allones  one key lane of every bucket (lane b % 8) holds the all-ones
             pair, an ordinary key here (an empty slot in the main path's
             count tile), and so does every 8th query lane;
    onekey   every other bucket's 8 key lanes hold one key (its lane 0's),
             so a query of it hits all 8."""
    if kind not in HAZARDS:
        raise ValueError(f"unknown hazard {kind!r}; expected one of {HAZARDS}")
    key_lo, key_hi, counts, q = step_keys(n_groups, lanes, seed)
    if kind == "allones":
        b = np.arange(GPB)
        key_lo[:, b % K, b] = key_hi[:, b % K, b] = MASK32
        q[:, ::8] = MASK32
    else:
        key_lo[:, :, ::2] = key_lo[:, :1, ::2]
        key_hi[:, :, ::2] = key_hi[:, :1, ::2]
    return step_tensors(device, flags, key_lo, key_hi, counts, q)


def make_inputs(device, variant: str = "newfull", lanes: int | None = None, seed: int = 0):
    return make_step_inputs(device, FLAGS[variant], COARSE, LANES if lanes is None else lanes,
                            seed)


def n_ctas(device: torch.device, grid: int) -> int:
    """The persistent CTAs of a step kernel on ``device`` (one per SM)."""
    if device.type != "cuda":
        return grid
    return min(grid, torch.cuda.get_device_properties(device).multi_processor_count)


def run_main(module, name: str, fn, argv) -> dict:
    """The main of a step script: times each variant of ``fn`` on
    ``module.make_inputs``; prints one line each."""
    parser = argparse.ArgumentParser(description=module.__doc__.split("\n\n")[0])
    parser.add_argument("variants", nargs="*", default=list(module.VARIANTS),
                        help=f"variants to time (default: all of {', '.join(module.VARIANTS)})")
    device_arg(parser)
    a = parser.parse_args(argv)
    bad = [v for v in a.variants if v not in module.VARIANTS]
    if bad:
        parser.error(f"unknown variants {bad}")
    device = pick_device(a.device)
    grid, tiles = module.GRID, module.TILES
    print(f"{name} on {device_name(device)}: GRID {grid} x TILES {tiles}, LANES "
          f"{module.LANES}, grid {n_ctas(device, grid)} persistent CTAs", flush=True)
    out = {"ms": {}, "inputs": {}}
    for variant in a.variants:
        out["inputs"][variant] = inputs = module.make_inputs(device, variant)
        out["ms"][variant] = ms = median_ms(lambda: fn(*inputs, variant), device)
        print(f"{variant:9s} {ms:9.4f} ms  {ms * 1e6 / (grid * tiles):9.2f} ns per tile",
              flush=True)
    return out


def main(argv=None) -> dict:
    return run_main(sys.modules[__name__], "r9_step_parts", step_parts, argv)


if __name__ == "__main__":
    main()
