"""The stage spans on the card, in the traced run of ``test_portbench_card``:
every device operation of the window is launched inside a stage span, each
span's device time equals that of its layer's kernel names, and the
partition's span holds the partition's own launches with the fills and
scans that its group counts by name."""
from __future__ import annotations

import pytest

from kmer_mapper_tpu_torch.ops import block_partition
from portbench import spans
from portbench.tests.test_portbench_card import card_run  # noqa: F401 (a fixture)

TWINS = {"upload_span_us_per_Mkmer": "upload_us_per_Mkmer",
         "hash_span_us_per_Mkmer": "hash_us_per_Mkmer",
         "partition_span_us_per_Mkmer": "partition_us_per_Mkmer",
         "count_span_us_per_Mkmer": "count_us_per_Mkmer"}


@pytest.mark.cuda
def test_every_device_op_is_launched_in_a_stage_span(card_run):  # noqa: F811
    result, _, _ = card_run
    assert result["metrics"]["unspanned_device_pct"]["value"] <= 0.1


@pytest.mark.cuda
@pytest.mark.parametrize("metric", sorted(TWINS))
def test_a_spans_device_time_equals_its_kernel_names(card_run, metric):  # noqa: F811
    result, _, _ = card_run
    got = result["metrics"][metric]["value"]
    assert got == pytest.approx(result["metrics"][TWINS[metric]]["value"], rel=0.01)


@pytest.mark.cuda
def test_the_partition_span_holds_its_launches_and_generic_kernels(card_run):  # noqa: F811
    result, trace, delta = card_run
    calls = result["attempted"]
    buffers = calls + 3  # the set-up maps three buffers before the window
    passes = delta["partition_scan"] // buffers
    own = sum(delta[name] for name in block_partition.launch_counts
              if not name.endswith("_reference")) // buffers
    # a pass: CUB's init and scan kernels and one int fill; a buffer: two
    # more fills (test_portbench_card pins these by name)
    assert spans.credit(trace).ops["kmt.partition"] == (own + 2 * passes + passes + 2) * calls
