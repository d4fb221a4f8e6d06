"""The tile body under the two MXU dot orientations: the port's counterpart
of ``scripts/r9_dot_orient.py``.

    python -m kmer_mapper_tpu_torch.scripts.r9_dot_orient [variant ...] [--device cpu]

``dot_orient`` launches ``csrc/r9_dot_orient.cu``: the tile body of
``csrc/r9_tile.cuh`` runs ``ITERS`` times on one bf16 key tile ``tb`` of
byte planes (plane p of key lane k at bucket b: row p*8+k, column b) and
one (2, LANES) query array. In tile i, lane l looks at bucket
``bp = (37 l + i) & 127`` and is live when ``l >= i & 63``; a live lane hits
key lane k when the float32 packing of the 8 planes of (k, bp),
``g0 + 256 g1 + 65536 g2``, ``g3 + 256 g4 + 65536 g5``, ``g6 + 256 g7``,
equals that of its query's bytes, and each hit adds one to counts[k][bp].
The variants are the layouts the Pallas variants' dot orientations give:

    old     tb (GPB, W8), counts (GPB, K)
    new     tb (W8, GPB), counts (K, GPB)
    d1old   tb (GPB, W8), counts (K, GPB)
    d2old   tb (W8, GPB), counts (GPB, K)

The kernel spreads the iterations over CTAs of ``ITERS_PER_CTA`` each (an
order-free integer sum). ``main`` prints the grid, then ms and ns per tile
for each variant.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from .. import native
from ..ops.u32hash import MASK32, from_int32_bits, to_int32_bits
from . import device_arg, device_name, median_ms, pick_device

VARIANTS = ("old", "new", "d1old", "d2old")
#: variant -> (tb bucket-major, counts bucket-major)
LAYOUTS = {"old": (True, True), "new": (False, False),
           "d1old": (True, False), "d2old": (False, True)}
GPB = 128  # buckets of a key tile
K = 8  # key lanes of a bucket
PLANES = 8  # byte planes of a (lo, hi) key
W8 = PLANES * K
LANES = 7168  # S=4 x cap=1792, the bench config
ITERS = 4096
ITERS_PER_CTA = 8
POOL = 16  # distinct keys the hit-dense inputs draw from
HIT_SHARE = 0.9  # share of query lanes drawn from the pool
#: elements of (tiles, lanes, key lanes) a twin handles at once
TWIN_ELEMENTS = 1 << 24

launch_counts = {"r9_dot_orient": 0, "r9_dot_orient_reference": 0}


def lane_buckets(t: torch.Tensor, c: torch.Tensor, lanes: int):
    """(bp int64, live bool), both (len(t), lanes): the bucket each lane of
    tile t[j] at step c[j] looks at, and whether it is live."""
    lane = torch.arange(lanes, device=t.device)
    bp = (lane * 37 + (t + c)[:, None]) & (GPB - 1)
    return bp, lane >= (t[:, None] & 63)


def tile_counts(match, t, c, dst, lanes: int, n_groups: int) -> torch.Tensor:
    """int64 hits in (group, key lane, bucket) order, n_groups * K * GPB of
    them: tile j (t[j] at step c[j]) adds, for each live lane and key lane k
    that ``match(j_slice, bp)`` (bool (tiles, lanes, K)) finds, one at
    (dst[j], k, bp). Works through the tiles in chunks."""
    dev = t.device
    out = torch.zeros(n_groups * K * GPB, dtype=torch.int64, device=dev)
    key_lane = torch.arange(K, device=dev)
    step = max(1, TWIN_ELEMENTS // (lanes * K))
    for j0 in range(0, t.numel(), step):
        sel = slice(j0, j0 + step)
        bp, live = lane_buckets(t[sel], c[sel], lanes)
        hit = match(sel, bp) & live[:, :, None]
        slots = ((dst[sel, None, None] * K + key_lane) * GPB + bp[:, :, None])[hit]
        out.index_add_(0, slots, torch.ones_like(slots))
    return out


def tb_shape(variant: str) -> tuple[int, int]:
    return (GPB, W8) if LAYOUTS[variant][0] else (W8, GPB)


def count_shape(variant: str) -> tuple[int, int]:
    return (GPB, K) if LAYOUTS[variant][1] else (K, GPB)


def _check(tb, q, variant):
    if variant not in VARIANTS:
        raise ValueError(f"unknown variant {variant!r}; expected one of {VARIANTS}")
    expect = ((tb, torch.bfloat16, tb_shape(variant)), (q, torch.int32, (2, q.shape[-1])))
    for arg, (t, dtype, shape) in zip(("tb", "q"), expect):
        if t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(f"r9_dot_orient: {arg} is {t.dtype}{tuple(t.shape)}, "
                             f"expected {dtype}{shape}")
        if not t.is_contiguous() or t.device != tb.device:
            raise ValueError(f"r9_dot_orient: {arg} must be contiguous, on {tb.device}")
    if q.shape[1] < 1:
        raise ValueError("r9_dot_orient: no query lanes")


def dot_orient(tb, q, variant: str, iters: int | None = None) -> torch.Tensor:
    """The variant's count tile, uint32 counts as int32 bit patterns, after
    ``iters`` (default ``ITERS``) tiles. ``tb`` bf16 in the variant's
    layout, ``q`` int32 bit patterns of uint32 (2, lanes).

    CUDA tensors launch ``csrc/r9_dot_orient.cu`` (a failed build or launch
    raises); CPU tensors run :func:`dot_orient_reference`."""
    iters = ITERS if iters is None else iters
    _check(tb, q, variant)
    if iters < 1:
        raise ValueError(f"r9_dot_orient: iters={iters} must be >= 1")
    if tb.device.type == "cpu":
        return dot_orient_reference(tb, q, variant, iters)
    if tb.device.type != "cuda":
        raise ValueError(f"r9_dot_orient: no kernel for device {tb.device}")
    out = torch.zeros(count_shape(variant), dtype=torch.int32, device=tb.device)
    tb_bm, count_bm = LAYOUTS[variant]
    with torch.cuda.device(tb.device):
        rc = native.library().r9_dot_orient_launch(
            tb.data_ptr(), q.data_ptr(), out.data_ptr(), iters, ITERS_PER_CTA, q.shape[1],
            int(tb_bm) | int(count_bm) << 1, tb.device.index,
            torch.cuda.current_stream().cuda_stream,
        )
    if rc:
        raise RuntimeError(f"r9_dot_orient kernel launch failed: {native.error_string(rc)}")
    launch_counts["r9_dot_orient"] += 1
    return out


def query_packs(q: torch.Tensor):
    """The float32 packing of each query lane's 8 bytes (three rows)."""
    lo, hi = from_int32_bits(q[0]), from_int32_bits(q[1])
    packs = (lo & 0xFFFFFF, (lo >> 24) | ((hi & 0xFFFF) << 8), hi >> 16)
    return [p.to(torch.float32) for p in packs]


def dot_orient_reference(tb, q, variant: str, iters: int) -> torch.Tensor:
    """Plain-torch twin of the kernel (same contract, same bits): the
    packed planes of every (key lane, bucket), compared with every live
    lane of every tile, the hits added up per (key lane, bucket)."""
    launch_counts["r9_dot_orient_reference"] += 1
    dev = tb.device
    planes = tb.to(torch.float32)
    planes = (planes.T if LAYOUTS[variant][0] else planes).reshape(PLANES, K, GPB)
    g = planes.transpose(1, 2)  # (plane, bucket, key lane)
    # the kernel's float32 order: (g0 + 256 g1) + 65536 g2
    packs = (g[0] + 256.0 * g[1] + 65536.0 * g[2], g[3] + 256.0 * g[4] + 65536.0 * g[5],
             g[6] + 256.0 * g[7])
    qp = query_packs(q)

    def match(sel, bp):
        hit = None
        for key, lane in zip(packs, qp):
            eq = key[bp] == lane[None, :, None]
            hit = eq if hit is None else hit & eq
        return hit

    t = torch.arange(iters, device=dev)
    zero = torch.zeros_like(t)
    hits = tile_counts(match, t, zero, zero, q.shape[1], 1).view(K, GPB)
    counts = to_int32_bits(hits & MASK32)
    return (counts.T if LAYOUTS[variant][1] else counts).contiguous()


def key_pool(rng, n: int = POOL) -> np.ndarray:
    """int64 (n, 2): n distinct-ish random (lo, hi) uint32 keys."""
    return rng.integers(0, 1 << 32, (n, 2), dtype=np.int64)


def pool_queries(rng, pool: np.ndarray, lanes: int) -> np.ndarray:
    """uint32 (2, lanes): ``HIT_SHARE`` of the lanes hold a key of the pool,
    the others a random (lo, hi)."""
    q = pool[rng.integers(0, len(pool), lanes)]
    miss = rng.random(lanes) >= HIT_SHARE
    q[miss] = rng.integers(0, 1 << 32, (int(miss.sum()), 2), dtype=np.int64)
    return np.ascontiguousarray(q.T).astype(np.uint32)


def byte_planes(keys: np.ndarray) -> np.ndarray:
    """(8, *shape) bytes of int64 (*shape, 2) (lo, hi) keys: planes 0-3 the
    bytes of lo, 4-7 those of hi, least significant first."""
    return np.stack([(keys[..., p // 4] >> (8 * (p % 4))) & 0xFF for p in range(PLANES)])


def make_inputs(device, variant: str = "new", lanes: int | None = None, seed: int = 0):
    """(tb, q) in the variant's layout, built so that the tile body hits:
    every (key lane, bucket) holds a key of a pool of ``POOL``, and
    ``HIT_SHARE`` of the query lanes too. The Pallas script's uniform random
    bytes and queries would give a count of zero."""
    lanes = LANES if lanes is None else lanes
    rng = np.random.default_rng(seed)
    pool = key_pool(rng)
    keys = pool[rng.integers(0, POOL, (K, GPB))]
    planes = byte_planes(keys).reshape(W8, GPB).astype(np.float32)
    if LAYOUTS[variant][0]:
        planes = planes.T
    tb = torch.from_numpy(np.ascontiguousarray(planes)).to(torch.bfloat16)
    q = torch.from_numpy(pool_queries(rng, pool, lanes).view(np.int32))
    return tb.to(device), q.to(device)


def n_ctas(iters: int | None = None) -> int:
    iters = ITERS if iters is None else iters
    return -(-iters // ITERS_PER_CTA)


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
    print(f"r9_dot_orient on {device_name(device)}: ITERS {ITERS}, LANES {LANES}, grid "
          f"{n_ctas()} CTAs of {ITERS_PER_CTA} tiles", flush=True)
    out = {"ms": {}, "inputs": {}}
    for variant in a.variants:
        out["inputs"][variant] = inputs = make_inputs(device, variant)
        out["ms"][variant] = ms = median_ms(lambda: dot_orient(*inputs, variant), device)
        print(f"{variant:6s} {ms:9.4f} ms  {ms * 1e6 / ITERS:9.2f} ns per tile", flush=True)
    return out


if __name__ == "__main__":
    main()
