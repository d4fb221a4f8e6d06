"""Partition of a chunk's sort keys by chain block: the stage between the
hash-key kernels and the stream count on both chunk steps.

The count (``stream_probe.stream_count``) runs one CTA per 128-bucket chain
block over that block's window of keys and is indifferent to the order
inside a window, so the keys need grouping by block, not sorting. The JAX
package sorts them (``lax.sort``) and bisects for each block's window
(``block_offsets``); here a histogram by block, its exclusive scan and a
scatter into each block's window do the same work in one read for the
histogram and one read and one write for the scatter.

A key's block is the top ``log2(n_blocks)`` bits of its m_lo word
(``block_ids``). The all-ones invalid key (:data:`INVALID_KEY`) belongs to
no block: it lands after the last window, so the windows end where
``stream_probe.count_offsets`` ends them.

:func:`block_partition` launches ``csrc/block_partition.cu`` on a CUDA
tensor (``block_histogram``, ``torch.cumsum``, ``block_scatter``; a failed
build or launch raises) and runs its plain twin
:func:`block_partition_reference` on a CPU tensor; any other device raises.
The order inside a window is unspecified: the kernel's depends on the order
in which warps reserve slots, the twin's is the input order.
"""
from __future__ import annotations

import torch

from .. import native
from ..index.layout import CHAIN_BLOCK

#: the sort key of the all-ones invalid (m_lo, m_hi) pair, the largest
#: int64 (``stream_probe.sort_key(INVALID_WORD, INVALID_WORD)``)
INVALID_KEY = (1 << 63) - 1
#: histogram bins (chain blocks + 1) that the kernel counts in shared
#: memory, 48 KB of int32 (``kSharedBins`` of ``csrc/block_partition.cu``)
SHARED_BINS = 12288

#: launches of the two CUDA kernels and calls of the plain twin since
#: import; a run that must show which one ran resets them first
launch_counts = {"block_histogram": 0, "block_scatter": 0, "block_partition_reference": 0}


def check_partition_args(keys: torch.Tensor, n_buckets: int, bpb: int) -> int:
    """Raises ValueError unless the arguments fit the partition's contract
    (contiguous int64 keys, fewer than 2**31 of them, a power-of-two table
    and its chain-block size); returns the number of chain blocks."""
    if keys.dtype != torch.int64 or keys.dim() != 1 or not keys.is_contiguous():
        raise ValueError(f"block_partition: keys is {keys.dtype}{tuple(keys.shape)}, "
                         "expected contiguous int64 sort keys")
    if keys.device.type not in ("cpu", "cuda"):
        raise ValueError(f"block_partition: no kernel for device {keys.device}")
    if n_buckets < 1 or n_buckets & (n_buckets - 1) or bpb != min(CHAIN_BLOCK, n_buckets):
        raise ValueError(f"block_partition: n_buckets={n_buckets}, bpb={bpb} (need a power "
                         "of two and its chain-block size)")
    if keys.shape[0] >= 1 << 31:
        raise ValueError("block_partition: more than 2**31 - 1 keys in one call")
    return n_buckets // bpb


def block_ids(keys: torch.Tensor, n_blocks: int) -> torch.Tensor:
    """int64 chain block of each sort key, ``n_blocks`` for the invalid key:
    m_lo (``stream_probe.split_key``) shifted down to its top
    ``log2(n_blocks)`` bits, which is ``(m_lo >> shift) // bpb``."""
    m_lo = (keys >> 32) + (1 << 31)
    block = m_lo >> (32 - (n_blocks.bit_length() - 1))
    return torch.where(keys == INVALID_KEY, n_blocks, block)


def block_partition(keys: torch.Tensor, n_buckets: int, bpb: int):
    """(grouped keys, off): a permutation of ``keys`` in which chain block
    b's keys fill ``[off[b], off[b+1])``, and int32 ``off[n_blocks + 1]``
    with ``off[0] == 0``; the invalid keys follow ``off[n_blocks]``. The
    order inside a window is unspecified. ``n_buckets`` and ``bpb`` are the
    table's (``bpb = min(128, n_buckets)``)."""
    n_blocks = check_partition_args(keys, n_buckets, bpb)
    if keys.device.type == "cpu":
        return block_partition_reference(keys, n_buckets, bpb)
    return _partition_launch(keys, n_blocks)


def _partition_launch(keys: torch.Tensor, n_blocks: int, shared: bool | None = None):
    """The kernels' (grouped keys, off) on the keys' device and current
    stream: ``block_histogram`` (``shared`` as there), its exclusive scan,
    ``block_scatter``; raises if the build or a launch fails."""
    hist = block_histogram(keys, n_blocks, shared)
    off = hist.new_zeros(n_blocks + 2)
    torch.cumsum(hist, 0, dtype=torch.int32, out=off[1:])
    off = off[:-1]
    return block_scatter(keys, off.clone(), n_blocks), off


def _launch(name: str, fn, device: torch.device, *args) -> None:
    with torch.cuda.device(device):
        rc = fn(*args, device.index, torch.cuda.current_stream().cuda_stream)
    if rc:
        raise RuntimeError(f"{name} kernel launch failed: {native.error_string(rc)}")
    launch_counts[name] += 1


def block_histogram(keys: torch.Tensor, n_blocks: int, shared: bool | None = None):
    """int32[n_blocks + 1]: the keys of each chain block, then the invalid
    keys, from one launch of ``block_histogram_kernel`` on the keys' CUDA
    device and current stream (none for no keys). ``shared`` picks where
    the kernel counts (None: in shared memory where the bins fit,
    :data:`SHARED_BINS`)."""
    hist = torch.zeros(n_blocks + 1, dtype=torch.int32, device=keys.device)
    if not keys.numel():
        return hist
    if shared is None:
        shared = n_blocks + 1 <= SHARED_BINS
    _launch("block_histogram", native.library().block_histogram_launch, keys.device,
            keys.data_ptr(), keys.shape[0], hist.data_ptr(), n_blocks.bit_length() - 1,
            int(shared))
    return hist


def block_scatter(keys: torch.Tensor, cursor: torch.Tensor, n_blocks: int) -> torch.Tensor:
    """The keys, each written into its bin's window from one launch of
    ``block_scatter_kernel`` (none for no keys): ``cursor`` (int32[n_blocks
    + 1], each bin's first slot) is advanced in place."""
    out = torch.empty_like(keys)
    if not keys.numel():
        return out
    _launch("block_scatter", native.library().block_scatter_launch, keys.device,
            keys.data_ptr(), keys.shape[0], cursor.data_ptr(), out.data_ptr(),
            n_blocks.bit_length() - 1)
    return out


def block_partition_reference(keys: torch.Tensor, n_buckets: int, bpb: int):
    """Plain-torch twin of :func:`block_partition` (same contract): the
    block ids' ``bincount``, its ``cumsum``, and the keys in the order of a
    stable ``argsort`` of their block ids, so each window keeps the input
    order."""
    launch_counts["block_partition_reference"] += 1
    n_blocks = n_buckets // bpb
    bins = block_ids(keys, n_blocks)
    hist = torch.bincount(bins, minlength=n_blocks + 1)
    off = torch.zeros(n_blocks + 1, dtype=torch.int32, device=keys.device)
    off[1:] = torch.cumsum(hist[:n_blocks], 0)
    return keys[torch.argsort(bins, stable=True)], off

