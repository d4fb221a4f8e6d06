"""A traced run on the card, in this process: it is correct, and the generic
kernels that the partition's group counts by name (an int fill, CUB's scan)
are the partition's own. A stray ``torch.zeros`` or ``cumsum`` elsewhere in
``map_chunk`` would move device time into the partition's metrics; here it
fails."""
from __future__ import annotations

import time

import pytest

from kmer_mapper_tpu_torch.ops import block_partition
from portbench import common, harness
from portbench.tests import tiny

#: 2^20 buckets (8,192 chain blocks, two radix passes), 64 Mi-base buffers
SIZES = {"genome_length": 64_000_000, "n_kmers": 2_600_000, "n_nodes": 600_000}


@pytest.fixture(scope="module")
def card_run(tmp_path_factory):
    torch = pytest.importorskip("torch")
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    traces = []
    from_file = common.Trace.from_file.__func__

    def keep(cls, path):
        traces.append(from_file(cls, path))
        return traces[-1]

    before = dict(block_partition.launch_counts)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(common.Trace, "from_file", classmethod(keep))
        # the cell's own name, so that it reports the cell's per-layer metrics
        cell = dict(tiny.cell("human_kage", "fixed151"), name="human.fixed151")
        result = harness.run(tiny.TinySpec(sizes=SIZES, buffers=2048), cell, 2**31 + 5, 1.0,
                             True, "cuda",
                             t_start=time.perf_counter(), cache=tmp_path_factory.mktemp("cache"))
    after = block_partition.launch_counts
    delta = {name: after[name] - before[name] for name in after}
    return result, traces[-1], delta


@pytest.mark.cuda
def test_a_traced_run_on_the_card_is_correct(card_run):
    result, trace, _ = card_run
    assert result["correct"] is True and result["attempted"] >= 10
    assert trace.busy_s() > 0
    assert {"partition_us_per_Mkmer", "count_roofline_pct"} <= set(result["metrics"])


@pytest.mark.cuda
def test_the_partitions_generic_kernels_are_its_own(card_run):
    result, trace, delta = card_run
    calls = result["attempted"]
    # the set-up maps three buffers before the window, each like the window's
    buffers = calls + 3
    assert delta["partition_scan"] % buffers == 0
    passes = delta["partition_scan"] // buffers
    assert passes == 2
    # a pass: one torch.cumsum of its digit totals (CUB's init and scan
    # kernels) and one torch.zeros of its digit offsets; a buffer: the
    # block offsets' torch.zeros and the plane step's key count (torch.full)
    assert trace.launches(["DeviceScanInitKernel"]) == passes * calls
    assert trace.launches(["DeviceScanKernel"]) == passes * calls
    assert trace.launches(["FillFunctor<int>"]) == (passes + 2) * calls
