"""The floor of one tile iteration of the count, piece by piece: the port's
counterpart of ``scripts/r3_iter_floor.py``.

    python -m kmer_mapper_tpu_torch.scripts.r3_iter_floor [variant ...]

``iter_floor`` launches ``csrc/r3_iter_floor.cu``: ``N_ITER`` iterations
over ``CAP``-lane tiles of a (4, 64 * CAP) query array, tile t at column
(t % 64) * CAP, each iteration reading the scalars a = off[t % 8192] and
b = off[8192 + t % 8192]. The output is f32 (128, 8): row 0 holds
float32(int32 loop carry), rows 1..127 the accumulator rows 0..126.

    loop   carry += t
    smem   carry += a + b
    vmem   smem, and acc[0, lane] += float(q[0]) of tile t % 4, in t order
           (a stand-in: the Pallas variant reads scratch that was never
           written)
    dma    smem over the (4, CAP) tiles copied into shared memory, and
           acc[0, lane] += float(q[0]) of tile t % 64, in t order
    mm     full's tile compute on vmem's stand-in tiles, no copies (a
           stand-in, as for vmem)
    full   dma's copies plus the tile compute: a lane is live when its
           position lies in [a, a + CAP) and local_b = q[0] - b % 997 in
           [0, 128); it hits key lane k when all 8 bytes of (q[1], q[2])
           equal bf16(tb[local_b, p * 8 + k]), and hits count in
           acc[local_b, k]
    grid   ``N_GRID`` CTAs of one iteration, each adding its carry (0)
           into the zeroed output: the launch floor

The kernel spreads the loop over the card. The carry and the hit counts do
not depend on the order of the iterations: loop, smem, mm and full run a
(64, CAP / L, 2) grid, CTA (j, s, p) taking half p of the iterations
t = j (mod 64) and L lanes of tile j, staged once, and sum into a uint32
scratch that the last CTA converts to f32. vmem and dma sum floats in t order, so each lane
stays one serial chain of ``N_ITER`` adds (one warp a CTA): their floor is
``N_ITER`` dependent float adds, not the card's rates.

``main`` times every variant (median of 5 CUDA-event times) and prints ms
and ns per iteration (per CTA for grid).
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from .. import native
from ..ops.u32hash import MASK32
from . import device_arg, device_name, median_ms, pick_device

VARIANTS = ("loop", "smem", "vmem", "dma", "mm", "full", "grid")
#: variants whose Pallas kernels read scratch that was never written: they
#: have no reference result and are held to their twin only
STAND_INS = ("vmem", "mm")
CAP = 1024  # lanes of a tile
BPB = 128  # rows of the key and count tiles
K = 8  # key lanes
N_ITER = 16384
N_GRID = 1024
N_TILES = 64  # tile t sits at column (t % 64) * CAP
N_SLOTS = 4  # tiles in flight
OFF_HALF = 8192  # a = off[t % 8192], b = off[8192 + t % 8192]
MOD = 997
#: the kernel's uint32 scratch: the count tile, the carry, the last-CTA ticket
SCRATCH_WORDS = BPB * K + 2

launch_counts = {"r3_iter_floor": 0, "r3_iter_floor_reference": 0}


def _check(off, tb, q, variant, cap):
    if variant not in VARIANTS:
        raise ValueError(f"unknown variant {variant!r}; expected one of {VARIANTS}")
    expect = ((off, torch.int32, (2 * OFF_HALF,)), (tb, torch.float32, (BPB, 8 * K)),
              (q, torch.int32, (4, N_TILES * cap)))
    for arg, (t, dtype, shape) in zip(("off", "tb", "q"), expect):
        if t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(f"r3_iter_floor: {arg} is {t.dtype}{tuple(t.shape)}, "
                             f"expected {dtype}{shape}")
        if not t.is_contiguous() or t.device != off.device:
            raise ValueError(f"r3_iter_floor: {arg} must be contiguous, on {off.device}")
    if not (32 <= cap <= 1024 and cap % 32 == 0):
        raise ValueError(f"r3_iter_floor: cap={cap} is not a multiple of 32 in [32, 1024]")


def iter_floor(off, tb, q, variant: str, n_iter: int | None = None,
               n_grid: int | None = None, cap: int | None = None) -> torch.Tensor:
    """The variant's f32 (128, 8) output. ``off`` int32 (16384,), ``tb`` f32
    (128, 64), ``q`` int32 bit patterns of uint32 (4, 64 * cap); the sizes
    default to the module's ``N_ITER``, ``N_GRID`` and ``CAP``.

    CUDA tensors launch ``csrc/r3_iter_floor.cu`` (a failed build or launch
    raises); CPU tensors run :func:`iter_floor_reference`."""
    n_iter = N_ITER if n_iter is None else n_iter
    n_grid = N_GRID if n_grid is None else n_grid
    cap = CAP if cap is None else cap
    _check(off, tb, q, variant, cap)
    if off.device.type == "cpu":
        return iter_floor_reference(off, tb, q, variant, n_iter, n_grid, cap)
    if off.device.type != "cuda":
        raise ValueError(f"r3_iter_floor: no kernel for device {off.device}")
    if q.data_ptr() % 16:
        raise ValueError("r3_iter_floor: q must start on 16 bytes (16-byte copies)")
    sink = torch.empty(cap, dtype=torch.float32, device=off.device)
    if variant == "grid":  # its CTAs add into a zeroed output, with no scratch
        out = torch.zeros(BPB, K, dtype=torch.float32, device=off.device)
        scratch_ptr = 0
    else:  # the last CTA writes every entry
        out = torch.empty(BPB, K, dtype=torch.float32, device=off.device)
        scratch = torch.zeros(SCRATCH_WORDS, dtype=torch.int32, device=off.device)
        scratch_ptr = scratch.data_ptr()
    with torch.cuda.device(off.device):
        rc = native.library().r3_iter_floor_launch(
            off.data_ptr(), tb.data_ptr(), q.data_ptr(), out.data_ptr(), sink.data_ptr(),
            scratch_ptr, n_iter, n_grid, cap, VARIANTS.index(variant), off.device.index,
            torch.cuda.current_stream().cuda_stream,
        )
    if rc:
        raise RuntimeError(f"r3_iter_floor kernel launch failed: {native.error_string(rc)}")
    launch_counts["r3_iter_floor"] += 1
    return out


def iter_floor_reference(off, tb, q, variant: str, n_iter: int, n_grid: int,
                         cap: int) -> torch.Tensor:
    """Plain-torch twin of the kernel (same contract, same bits)."""
    launch_counts["r3_iter_floor_reference"] += 1
    dev = off.device
    out = torch.zeros(BPB, K, dtype=torch.float32, device=dev)
    if variant == "grid":  # n_grid programs of one iteration each add 0
        return out
    t = torch.arange(n_iter, device=dev)
    if variant == "loop":
        carry = int(t.sum())
    else:
        a = off[t % OFF_HALF].to(torch.int64)
        b = off[OFF_HALF + t % OFF_HALF].to(torch.int64)
        carry = int(a.sum()) + int(b.sum())
    carry = (carry + (1 << 31)) % (1 << 32) - (1 << 31)  # wraps as int32
    out[0] = torch.tensor(carry, dtype=torch.int32, device=dev).to(torch.float32)
    if variant in ("vmem", "dma"):
        tiles = q[0].to(torch.float32).view(N_TILES, cap)
        acc = torch.zeros(cap, dtype=torch.float32, device=dev)
        for j in (t % (N_TILES if variant == "dma" else N_SLOTS)).tolist():
            acc += tiles[j]  # one f32 add per lane per iteration, in t order
        out[1] = acc[:K]
    elif variant in ("mm", "full"):
        tile = t % (N_TILES if variant == "full" else N_SLOTS)
        lane = torch.arange(cap, device=dev)
        pos = (t % N_TILES)[:, None] * cap + lane
        col = tile[:, None] * cap + lane
        local = q[0].to(torch.int64)[col] - torch.remainder(b, MOD)[:, None]
        live = (pos >= a[:, None]) & (pos < a[:, None] + cap) & (local >= 0) & (local < BPB)
        ti, li = torch.nonzero(live, as_tuple=True)
        c, lb = col[ti, li], local[ti, li]
        words = [q[1].to(torch.int64)[c] & MASK32, q[2].to(torch.int64)[c] & MASK32]
        planes = torch.stack([(words[p // 4] >> (8 * (p % 4))) & 0xFF for p in range(8)], 1)
        keys = tb.to(torch.bfloat16).to(torch.float32)[lb].view(-1, 8, K)
        hit = (keys == planes.to(torch.float32)[:, :, None]).all(dim=1)
        rows, lanes = torch.nonzero(hit, as_tuple=True)
        slots = lb[rows] * K + lanes
        acc = torch.zeros(BPB * K, dtype=torch.int64, device=dev)
        acc.index_add_(0, slots, torch.ones_like(slots))
        out[1:] = acc.view(BPB, K)[: BPB - 1].to(torch.float32)
    return out


def make_inputs(device, cap: int = CAP, seed: int = 0):
    """(off, tb, q) at the script's shapes, built so that the tile compute
    has work: the windows [a, a + cap) follow the tiles, b is a multiple of
    997 so local_b = q[0], and three lanes in four carry a key of the tile's
    row ``local_b``, whose bytes ``tb`` holds."""
    rng = np.random.default_rng(seed)
    i = np.arange(OFF_HALF)
    a = np.maximum(0, (i % N_TILES) * cap + rng.integers(-cap // 2, cap // 2, OFF_HALF))
    b = MOD * rng.integers(0, 1000, OFF_HALF)
    off = np.concatenate([a, b]).astype(np.int32)
    words = rng.integers(0, 1 << 32, (BPB, K, 2), dtype=np.int64)
    tb = np.empty((BPB, 8, K), np.float32)
    for p in range(8):
        tb[:, p, :] = (words[:, :, p // 4] >> (8 * (p % 4))) & 0xFF
    n_cols = N_TILES * cap
    q0 = rng.integers(0, BPB, n_cols)
    k = rng.integers(0, K, n_cols)
    q1, q2 = words[q0, k, 0], words[q0, k, 1]
    miss = rng.random(n_cols) < 0.25
    q1[miss] = rng.integers(0, 1 << 32, miss.sum(), dtype=np.int64)
    q = np.stack([q0, q1, q2, q2]).astype(np.uint32).view(np.int32)
    return tuple(torch.from_numpy(np.ascontiguousarray(x)).to(device)
                 for x in (off, tb.reshape(BPB, 8 * K), q))


def run(inputs, variants, device) -> dict[str, float]:
    """Median ms of each variant; prints one line each."""
    out = {}
    for variant in variants:
        out[variant] = ms = median_ms(lambda: iter_floor(*inputs, variant), device)
        n = N_GRID if variant == "grid" else N_ITER
        unit = "CTA" if variant == "grid" else "iteration"
        print(f"{variant:5s} {ms:9.4f} ms  {ms * 1e6 / n:8.2f} ns per {unit}", flush=True)
    return out


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("variants", nargs="*", default=list(VARIANTS),
                        help=f"variants to time (default: all of {', '.join(VARIANTS)})")
    device_arg(parser)
    a = parser.parse_args(argv)
    bad = [v for v in a.variants if v not in VARIANTS]
    if bad:
        parser.error(f"unknown variants {bad}")
    device = pick_device(a.device)
    inputs = make_inputs(device, CAP)
    print(f"r3_iter_floor on {device_name(device)}: CAP {CAP}, N_ITER {N_ITER}, "
          f"N_GRID {N_GRID}", flush=True)
    return {"ms": run(inputs, a.variants, device), "inputs": inputs}


if __name__ == "__main__":
    main()
