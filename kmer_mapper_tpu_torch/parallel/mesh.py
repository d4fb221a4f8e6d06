"""The (data, index) grid of devices that a sharded run maps on.

The torch counterpart of ``kmer_mapper_tpu/parallel/mesh.py``:

* **data axis**: chunks of reads fan out over the rows of the grid; each
  row folds its chunks into its own count state, and the rows' counts add
  once, at the node-count finalize;
* **index axis**: the table is split into equal, contiguous bucket ranges,
  one a column; each cell probes its row's whole query stream against its
  own range and counts only the keys it holds, so the hot loop needs no
  communication at all.

A cell is a ``torch.device``. The grid may name one device more than once:
the CPU tests put every cell on ``cpu``, and a single card can hold several
cells (each with its own table shard and counts).
"""
from __future__ import annotations

import dataclasses

import torch

DATA_AXIS = "data"
INDEX_AXIS = "index"


@dataclasses.dataclass(frozen=True)
class Mesh:
    """``devices[d][x]`` is the device of data row d's index shard x."""

    devices: tuple[tuple[torch.device, ...], ...]

    @property
    def shape(self) -> dict[str, int]:
        return {DATA_AXIS: len(self.devices), INDEX_AXIS: len(self.devices[0])}

    @property
    def size(self) -> int:
        return len(self.devices) * len(self.devices[0])


def make_mesh(n_devices: int | None = None, index_parallel: int | None = None,
              devices=None) -> Mesh:
    """A (data, index) grid over ``devices`` (by default every CUDA device,
    ``cuda:0`` ... ``cuda:n-1``), the first ``n_devices`` of them, in rows of
    ``index_parallel`` (default 1: every row holds the whole table; raise it
    for a table that does not fit one card). ``devices`` may repeat a device.
    Asking for more CUDA devices than ``torch.cuda.device_count()`` raises."""
    if devices is None:
        count = torch.cuda.device_count()
        if count == 0 or (n_devices or 0) > count:
            raise ValueError(f"{n_devices or 'every'} CUDA device(s) asked for, but "
                             f"torch.cuda.device_count() is {count} (on the CPU pass "
                             f"devices=[torch.device('cpu')] * n)")
        devices = [torch.device("cuda", i) for i in range(count)]
    devices = [torch.device(d) for d in devices]
    # "cuda" names the current card: give it its index, as tensors report it
    devices = [torch.device("cuda", torch.cuda.current_device())
               if d.type == "cuda" and d.index is None else d for d in devices]
    if n_devices is not None:
        if n_devices > len(devices):
            raise ValueError(f"{n_devices} devices asked for, {len(devices)} given")
        devices = devices[:n_devices]
    index_parallel = 1 if index_parallel is None else index_parallel
    if not devices or index_parallel < 1 or len(devices) % index_parallel:
        raise ValueError(f"{len(devices)} devices do not split into rows of "
                         f"index_parallel={index_parallel}")
    rows = [tuple(devices[i : i + index_parallel])
            for i in range(0, len(devices), index_parallel)]
    return Mesh(tuple(rows))
