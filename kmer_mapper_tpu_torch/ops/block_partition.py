"""Partition of a chunk's sort keys by chain block: the stage between the
hash-key kernels and the stream count on both chunk steps.

The count (``stream_probe.stream_count``) runs one CTA per 128-bucket chain
block over that block's window of keys and is indifferent to the order
inside a window, so the keys need grouping by block, not sorting. The JAX
package sorts them (``lax.sort``) and bisects for each block's window
(``block_offsets``); here a radix sort of the keys' blocks does the same
work without comparing keys.

A key's block is the top ``log2(n_blocks)`` bits of its m_lo word
(``block_ids``). The all-ones invalid key (:data:`INVALID_KEY`) belongs to
no block: it lands after the last window, so the windows end where
``stream_probe.count_offsets`` ends them.

:func:`block_partition` launches ``csrc/block_partition.cu`` on a CUDA
tensor (a failed build or launch raises) and runs its plain twin
:func:`block_partition_reference` on a CPU tensor; any other device raises.
On the card, for every table size, it runs :func:`radix_partition`: a
least-significant-digit radix sort of the keys' bins, :func:`radix_passes`
passes of at most 8 bits (two of 7 on a table of 2**20 buckets). Each pass
runs ``partition_histogram`` (each CTA counts the digits of a contiguous
slab of keys into one row of a (slab, digit) matrix), ``partition_scan``
(the matrix's scan down each digit and the digits' totals, whose
``torch.cumsum`` gives each digit's first slot) and ``radix_scatter``
(each CTA ranks its slab's keys stably, a 4096-key tile at a time in
shared memory, and writes each digit's keys of a tile as one run);
``radix_offsets`` finds the windows' bounds in the sorted keys. No global
atomics; a pass reads and writes each key once. The slabs are one wave of
the scatter kernel (:func:`radix_slabs`). Its plain pieces are
:func:`radix_passes`, :func:`slab_histograms`, :func:`slab_bases`,
:func:`slab_scatter_reference` and :func:`radix_offsets_reference`,
composed in :func:`radix_partition_reference`, which equals the twin bit
for bit, as the kernels do: the keys of a window keep the input order.

The kernels take the number of keys to partition from device memory: a
``count``, an int32 tensor on the keys' device whose first element is how
many of the keys to partition (clamped to the keys' length; -1 counts as
none), each CTA cutting its own slab from it. The ragged step's keys lie in
a buffer sized by capacity with their number on the card
(``hashing.ragged_hash_keys``' count), so the host never learns it; the
keys past it are neither read nor written. Without a count,
:func:`block_partition` and :func:`radix_partition` partition every key,
and write their number into a count on the card for the kernels (one fill,
no sync).

``launch_counts`` counts each kernel's launches by those names. The first
design (a histogram and a scatter with atomics on a cursor array) is timed
by ``scripts/partition_dissect.py``.
"""
from __future__ import annotations

import torch

from .. import native
from ..index.layout import CHAIN_BLOCK

#: the sort key of the all-ones invalid (m_lo, m_hi) pair, the largest
#: int64 (``stream_probe.sort_key(INVALID_WORD, INVALID_WORD)``)
INVALID_KEY = (1 << 63) - 1
#: the most bits of a radix digit (``kRadixMaxBits``): 256 digits a pass
RADIX_BITS = 8
#: keys of a warp's tile in the histogram kernel (``kWarpTile``); a slab is
#: a whole number of them
WARP_TILE = 128

#: launches of the CUDA kernels and calls of the plain twin since import; a
#: run that must show which one ran resets them first
launch_counts = {"partition_histogram": 0, "partition_scan": 0, "radix_scatter": 0,
                 "radix_offsets": 0, "block_partition_reference": 0}


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


def block_partition(keys: torch.Tensor, n_buckets: int, bpb: int, *, consume: bool = False,
                    count: torch.Tensor | None = None):
    """(grouped keys, off): a permutation of ``keys`` in which chain block
    b's keys fill ``[off[b], off[b+1])``, and int32 ``off[n_blocks + 1]``
    with ``off[0] == 0``; the invalid keys follow ``off[n_blocks]``. The
    order inside a window is unspecified. ``n_buckets`` and ``bpb`` are the
    table's (``bpb = min(128, n_buckets)``). ``consume`` lets the kernels
    use ``keys``' memory for a pass, for a caller that reads the keys no
    more (its contents are then undefined): the chunk steps consume theirs
    (``stream_probe.stream_probe_count_keys``); a check against the twin on
    the same keys does not. With ``count`` (see the module's note) only the
    first ``count[0]`` keys are partitioned: the grouped keys are as long as
    ``keys``, and past the count their entries are unspecified."""
    n_blocks = check_partition_args(keys, n_buckets, bpb)
    if count is not None:
        _check_count(count, keys)
    if keys.device.type == "cpu":
        if count is None:
            return block_partition_reference(keys, n_buckets, bpb)
        n = _host_count(count, keys)
        grouped, off = block_partition_reference(keys[:n], n_buckets, bpb)
        return torch.cat([grouped, keys[n:]]), off
    return radix_partition(keys, n_blocks, consume=consume, count=count)


def _check_count(count: torch.Tensor, keys: torch.Tensor) -> None:
    if (count.dtype != torch.int32 or count.dim() != 1 or not count.numel()
            or count.device != keys.device):
        raise ValueError(f"block_partition: count is {count.dtype}{tuple(count.shape)} on "
                         f"{count.device}, expected int32[>= 1] on {keys.device}")


def _host_count(count: torch.Tensor, keys: torch.Tensor) -> int:
    """The keys a CPU count names, clamped as the kernels clamp it."""
    return min(max(int(count[0]), 0), keys.shape[0])


def slab_layout(n: int, n_slabs: int) -> tuple[int, int]:
    """(slabs, slab length) for ``n`` keys cut into at most ``n_slabs``
    contiguous slabs: the length is a whole number of warp tiles
    (:data:`WARP_TILE`), and no slab is empty (none for no keys)."""
    slab_len = -(-max(n, 1) // n_slabs)
    slab_len = -(-slab_len // WARP_TILE) * WARP_TILE
    return -(-n // slab_len), slab_len


def partition_histogram(keys: torch.Tensor, n_blocks: int, shift: int, bits: int,
                        count: torch.Tensor, n_slabs: int) -> torch.Tensor:
    """int32 (n_slabs, :func:`digit_width`): the count's keys cut into
    ``n_slabs`` slabs as :func:`slab_layout` cuts them, row s the counts of
    the radix digits ``(bin >> shift) & (2**bits - 1)`` of slab s's keys
    (:func:`slab_histograms`; rows past the last slab with keys are zeros),
    from one launch of ``partition_histogram_kernel`` (a CTA a slab, each
    cutting its slab from the device count)."""
    width = digit_width(n_blocks, shift, bits)
    rows = torch.empty((n_slabs, width), dtype=torch.int32, device=keys.device)
    _launch("partition_histogram", native.library().partition_histogram_launch, keys.device,
            keys.data_ptr(), keys.shape[0], count.data_ptr(), rows.data_ptr(), n_slabs,
            n_blocks.bit_length() - 1, shift, bits)
    return rows


def partition_scan(rows: torch.Tensor) -> torch.Tensor:
    """Scans ``rows`` down each digit's column in place (exclusive: row s
    becomes the digit's keys in the slabs before s, :func:`slab_bases`) from
    one launch of ``partition_scan_kernel``; returns the int32 totals of
    the digits."""
    totals = torch.empty(rows.shape[1], dtype=torch.int32, device=rows.device)
    _launch("partition_scan", native.library().partition_scan_launch, rows.device,
            rows.data_ptr(), totals.data_ptr(), rows.shape[0], rows.shape[1])
    return totals


def radix_passes(n_blocks: int) -> list[tuple[int, int]]:
    """(shift, bits) of each LSD pass of the radix route over the bins 0 ..
    n_blocks: as few passes of at most :data:`RADIX_BITS` bits as cover
    the bins' bits, their digits of equal width, the lowest first."""
    n_bits = n_blocks.bit_length()  # the invalid bin, n_blocks, needs the top bit
    passes = -(-n_bits // RADIX_BITS)
    bits = -(-n_bits // passes)
    return [(p * bits, bits) for p in range(passes)]


def digit_width(n_blocks: int, shift: int, bits: int) -> int:
    """The digits of one radix pass that the bins 0 .. n_blocks can take."""
    return min(1 << bits, (n_blocks >> shift) + 1)


def radix_partition(keys: torch.Tensor, n_blocks: int, *, consume: bool = False,
                    count: torch.Tensor | None = None):
    """(grouped keys, off), the keys sorted by bin: for each pass of
    :func:`radix_passes`, :func:`partition_histogram` of its digit,
    :func:`partition_scan`, a ``torch.cumsum`` of the digits' totals and
    :func:`radix_scatter`; then :func:`radix_offsets` of the keys, which
    the passes leave sorted by bin (each pass is stable). Any table size;
    raises if the build or a launch fails. The passes alternate between
    two buffers besides ``keys``, or with ``consume`` between ``keys`` and
    one other (:func:`block_partition`). The kernels take the number of
    keys from ``count`` (the module's note; every key without one), each
    pass's :func:`radix_slabs` slabs cut on the card."""
    off = torch.zeros(n_blocks + 1, dtype=torch.int32, device=keys.device)
    if not keys.numel():
        return torch.empty_like(keys), off
    if count is None:
        count = torch.full((1,), keys.shape[0], dtype=torch.int32, device=keys.device)
    n_slabs = radix_slabs(keys.device)
    given, free = keys, None  # free: a buffer that no later pass reads
    for shift, bits in radix_passes(n_blocks):
        rows = partition_histogram(keys, n_blocks, shift, bits, count, n_slabs)
        doff = torch.zeros(rows.shape[1] + 1, dtype=torch.int32, device=keys.device)
        torch.cumsum(partition_scan(rows), 0, dtype=torch.int32, out=doff[1:])
        out = torch.empty_like(keys) if free is None else free
        radix_scatter(keys, rows, doff, n_blocks, shift, bits, count, out)
        free = keys if keys is not given or consume else None
        keys = out
    return keys, radix_offsets(keys, n_blocks, count)


def radix_slabs(device: torch.device) -> int:
    """The partition's slab count on CUDA ``device`` (a tensor's, with its
    index): one wave of the scatter kernel, the SMs times the CTAs of it
    that an SM holds (``radix_slabs`` of the library)."""
    n = native.library().radix_slabs(device.index)
    if n <= 0:
        raise RuntimeError(f"radix_slabs failed: {native.error_string(-n)}")
    return n


def radix_scatter(keys: torch.Tensor, rows: torch.Tensor, doff: torch.Tensor, n_blocks: int,
                  shift: int, bits: int, count: torch.Tensor,
                  out: torch.Tensor | None = None) -> torch.Tensor:
    """One LSD pass over the count's keys, in the slabs of
    :func:`partition_histogram` with the same count: each slab's keys
    grouped by digit ``(bin >> shift) & (2**bits - 1)``, each key at
    ``doff[d] + rows[s, d] +`` its stable rank (the scanned (slab, digit)
    matrix and its digits' first slots), from one launch of
    ``radix_scatter_kernel``, into ``out`` (a new tensor by default; never
    ``keys``' own memory), which is left as it was past the count."""
    if out is None:
        out = torch.empty_like(keys)
    _launch("radix_scatter", native.library().radix_scatter_launch, keys.device,
            keys.data_ptr(), keys.shape[0], count.data_ptr(), rows.data_ptr(), doff.data_ptr(),
            out.data_ptr(), rows.shape[0], n_blocks.bit_length() - 1, shift, bits)
    return out


def radix_offsets(ordered: torch.Tensor, n_blocks: int, count: torch.Tensor) -> torch.Tensor:
    """int32[n_blocks + 1]: each chain block's first position in the
    count's first keys, sorted by bin, from one launch of
    ``radix_search_offsets_kernel`` (a binary search a bin, where the keys
    are at least 64 times the bins) or of ``radix_offsets_kernel`` (one
    read of the keys)."""
    off = torch.empty(n_blocks + 1, dtype=torch.int32, device=ordered.device)
    _launch("radix_offsets", native.library().radix_offsets_launch, ordered.device,
            ordered.data_ptr(), ordered.shape[0], count.data_ptr(), off.data_ptr(),
            n_blocks.bit_length() - 1)
    return off


def _launch(name: str, fn, device: torch.device, *args) -> None:
    with torch.cuda.device(device):
        rc = fn(*args, device.index, torch.cuda.current_stream().cuda_stream)
    if rc:
        raise RuntimeError(f"{name} kernel launch failed: {native.error_string(rc)}")
    launch_counts[name] += 1


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


def _digits(keys: torch.Tensor, n_blocks: int, shift: int, bits: int) -> torch.Tensor:
    """Each key's radix digit ``(bin >> shift) & (2**bits - 1)``."""
    return (block_ids(keys, n_blocks) >> shift) & ((1 << bits) - 1)


def slab_histograms(keys: torch.Tensor, n_blocks: int, slab_len: int, shift: int,
                    bits: int, n_slabs: int | None = None) -> torch.Tensor:
    """int32 (slabs, :func:`digit_width`) matrix of ``partition_histogram``:
    row s counts the radix digits of keys ``[s*slab_len,
    (s+1)*slab_len)``; ``n_slabs`` rows (as the kernel writes them, the
    rows past the last slab with keys zeros), by default as many as hold
    keys."""
    width = digit_width(n_blocks, shift, bits)
    if n_slabs is None:
        n_slabs = -(-keys.shape[0] // slab_len)
    slab = torch.arange(keys.shape[0], device=keys.device) // slab_len
    cells = torch.bincount(slab * width + _digits(keys, n_blocks, shift, bits),
                           minlength=n_slabs * width)
    return cells.view(n_slabs, width).to(torch.int32)


def slab_bases(rows: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``partition_scan`` and the offsets after it: (bases, off), where
    ``bases[s, d]`` is the number of digit d's keys in slabs before s (the
    column's exclusive scan) and int32 ``off[width + 1]`` the exclusive
    scan of the columns' totals. Slab s's keys of digit d go to ``off[d] +
    bases[s, d]`` onwards: the (digit, slab) order of the matrix."""
    column = torch.cumsum(rows, 0, dtype=torch.int64)
    off = torch.zeros(rows.shape[1] + 1, dtype=torch.int64, device=rows.device)
    if rows.shape[0]:
        off[1:] = torch.cumsum(column[-1], 0)
    return (column - rows).to(torch.int32), off.to(torch.int32)


def slab_scatter_reference(keys: torch.Tensor, bases: torch.Tensor, off: torch.Tensor,
                           n_blocks: int, slab_len: int, shift: int,
                           bits: int) -> torch.Tensor:
    """``radix_scatter``'s slot rule in plain torch: each key of slab s and
    radix digit d at ``off[d] + bases[s, d] +`` its rank, in input order,
    among slab s's keys of d."""
    width = bases.shape[1]
    digit = _digits(keys, n_blocks, shift, bits)
    slab = torch.arange(keys.shape[0], device=keys.device) // slab_len
    cell = slab * width + digit
    order = torch.argsort(cell, stable=True)
    sizes = torch.bincount(cell, minlength=bases.numel())
    first = torch.cumsum(sizes, 0) - sizes
    rank = torch.empty_like(cell)
    rank[order] = torch.arange(keys.shape[0], device=keys.device) - first[cell[order]]
    slot = off.long()[digit] + bases.long()[slab, digit] + rank
    out = torch.empty_like(keys)
    out[slot] = keys
    return out


def radix_offsets_reference(ordered: torch.Tensor, n_blocks: int) -> torch.Tensor:
    """``radix_offsets``' rule in plain torch: ``off[b]`` the first position
    of the keys, sorted by bin, whose bin is b or more."""
    b = torch.arange(n_blocks + 1, device=ordered.device)
    return torch.searchsorted(block_ids(ordered, n_blocks), b).to(torch.int32)


def radix_partition_reference(keys: torch.Tensor, n_buckets: int, bpb: int, n_slabs: int):
    """The radix route in plain torch, from its pieces: for each pass of
    :func:`radix_passes`, the slab rows of its digit, their scan and the
    stable slot rule; then the offsets of the sorted keys. LSD passes of a
    stable rule sort by bin, so it equals :func:`block_partition_reference`
    exactly."""
    n_blocks = n_buckets // bpb
    _, slab_len = slab_layout(keys.shape[0], n_slabs)
    for shift, bits in radix_passes(n_blocks):
        bases, doff = slab_bases(slab_histograms(keys, n_blocks, slab_len, shift, bits))
        keys = slab_scatter_reference(keys, bases, doff, n_blocks, slab_len, shift, bits)
    return keys, radix_offsets_reference(keys, n_blocks)
