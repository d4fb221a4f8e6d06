"""Node-count finalize: slot counts -> per-node hit counts, on the device.

The torch counterpart of ``kmer_mapper_tpu/parallel/sharded.py:make_finalize``
(the single-device JAX path does the same on the host,
``index/kmer_index.py:node_counts``): each index entry (a (k-mer, node)
pair) adds its k-mer's slot count to its node, unless its frequency is above
``max_frequency`` (the reference's strict ``> max_frequency`` skip). Sums
wrap modulo 2**32, as JAX's uint32 ``.at[].add`` does.

:func:`finalize` launches the hand-written kernel ``csrc/node_counts.cu`` on
CUDA tensors (a failed build or launch raises) and runs its plain twin
:func:`finalize_reference` on CPU tensors; any other device raises. Counts
are int32 in slot order whose bits are the wrapping uint32 counts; the
entry arrays are int32 (``KmerIndex.device_entries``, sorted by slot: any
order gives the same sums, and slot order is the one whose gathers the
kernel reads fastest); the result is int32 ``[n_nodes]`` holding the bits
of the uint32 node counts.
"""
from __future__ import annotations

import torch

from .. import native
from .u32hash import MASK32, to_int32_bits

#: launches of the CUDA kernel and calls of its plain twin since import; a
#: run that must show which one ran resets them first
launch_counts = {"node_counts": 0, "finalize_reference": 0}
#: an entry's frequency is a uint16; a bound at or past it keeps every entry
_MAX_FREQUENCY = 1 << 16


def check_args(counts, entry_slot, entry_node, entry_frequency, n_nodes: int) -> None:
    """Raises ValueError unless the arguments fit the kernel's contract."""
    n = entry_slot.shape[0] if entry_slot.dim() == 1 else -1
    expect = {
        "counts": (counts, (counts.shape[0],)),
        "entry_slot": (entry_slot, (n,)),
        "entry_node": (entry_node, (n,)),
        "entry_frequency": (entry_frequency, (n,)),
    }
    for arg, (t, shape) in expect.items():
        if t.dtype != torch.int32 or tuple(t.shape) != shape:
            raise ValueError(f"finalize: {arg} is {t.dtype}{tuple(t.shape)}, "
                             f"expected torch.int32{shape}")
        if not t.is_contiguous():
            raise ValueError(f"finalize: {arg} is not contiguous")
        if t.device != counts.device:
            raise ValueError(f"finalize: {arg} is on {t.device}, counts on {counts.device}")
    if n_nodes < 1:
        raise ValueError(f"finalize: n_nodes={n_nodes} < 1")
    if counts.device.type not in ("cpu", "cuda"):
        raise ValueError(f"finalize: no kernel for device {counts.device}")


def finalize(counts, entry_slot, entry_node, entry_frequency, max_frequency: int,
             n_nodes: int) -> torch.Tensor:
    """int32[n_nodes]: the bits of ``sum counts[entry_slot]`` over each
    node's entries with ``entry_frequency <= max_frequency``, modulo 2**32."""
    check_args(counts, entry_slot, entry_node, entry_frequency, n_nodes)
    max_frequency = max(-1, min(int(max_frequency), _MAX_FREQUENCY))
    if counts.device.type == "cpu":
        return finalize_reference(counts, entry_slot, entry_node, entry_frequency,
                                  max_frequency, n_nodes)
    out = counts.new_zeros(n_nodes)
    if entry_slot.shape[0] == 0:  # nothing to add: no launch
        return out
    with torch.cuda.device(counts.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = native.library().node_counts_launch(
            counts.data_ptr(), entry_slot.data_ptr(), entry_node.data_ptr(),
            entry_frequency.data_ptr(), entry_slot.shape[0], max_frequency, out.data_ptr(),
            counts.device.index, stream,
        )
    if rc:
        raise RuntimeError(f"node_counts kernel launch failed: {native.error_string(rc)}")
    launch_counts["node_counts"] += 1
    return out


def finalize_reference(counts, entry_slot, entry_node, entry_frequency, max_frequency: int,
                       n_nodes: int) -> torch.Tensor:
    """Plain-torch twin of :func:`finalize` (same contract, same result): the
    kept entries' slot counts as int64, ``index_add_`` by node, masked to
    32 bits."""
    launch_counts["finalize_reference"] += 1
    weights = counts[entry_slot.long()].long() & MASK32
    weights = torch.where(entry_frequency <= max_frequency, weights, 0)
    out = torch.zeros(n_nodes, dtype=torch.int64, device=counts.device)
    out.index_add_(0, entry_node.long(), weights)
    return to_int32_bits(out & MASK32)
