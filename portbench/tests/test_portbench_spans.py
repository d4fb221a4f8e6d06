"""The stage spans' readers (``portbench/spans.py``) on a made-up trace: the
innermost stage span takes an operation, one launched outside every stage
span is unspanned, and where the operations do not tie to their launch
calls, or the program has no stage spans, nothing is read."""
from __future__ import annotations

import pytest

from portbench import common, harness, spans
from portbench.spec import Spec

SPAN_METRICS = {"upload_span_us_per_Mkmer": "kmt.upload", "hash_span_us_per_Mkmer": "kmt.hash",
                "partition_span_us_per_Mkmer": "kmt.partition",
                "count_span_us_per_Mkmer": "kmt.count"}
READERS = [*SPAN_METRICS, "unspanned_device_pct"]


def _x(cat, name, ts, dur, tid=1):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "pid": 1, "tid": tid}


def _events(stage_spans=True, extra_op=False, call="cudaMemcpyAsync"):
    """A window of 1000 us: the upload's copy, a partition with a hash span
    nested in it (as a stage calling another would be), a launch between
    the spans, the count; launch calls and operations in the same order."""
    host = [_x("user_annotation", common.WINDOW_SPAN, 0.0, 1000.0),
            _x("user_annotation", "map_chunk", 5.0, 700.0)]
    if stage_spans:
        host += [_x("user_annotation", "kmt.upload", 10.0, 40.0),
                 _x("user_annotation", "kmt.partition", 100.0, 300.0),
                 _x("user_annotation", "kmt.hash", 150.0, 50.0),
                 _x("user_annotation", "kmt.count", 500.0, 100.0),
                 _x("user_annotation", "kmt.count", 0.0, 900.0, tid=2)]  # another thread's
    host += [_x("cuda_runtime", call, 20.0, 5.0),
             _x("cuda_runtime", "cudaLaunchKernel", 120.0, 5.0),
             _x("cpu_op", "aten::zeros", 140.0, 30.0),
             _x("cuda_runtime", "cudaLaunchKernel", 160.0, 5.0),
             _x("cuda_runtime", "cudaLaunchKernel", 300.0, 5.0),
             _x("cuda_runtime", "cudaLaunchKernel", 450.0, 5.0),
             _x("cuda_runtime", "cudaLaunchCooperativeKernel", 550.0, 5.0),
             _x("cuda_runtime", "cudaStreamSynchronize", 900.0, 90.0),
             _x("cuda_runtime", "cudaLaunchKernel", 600.0, 5.0, tid=2)]  # not the window's
    device = [("Memcpy HtoD (Pinned -> Device)", "gpu_memcpy", 60.0, 20.0),
              ("void radix_scatter_kernel(long const*)", "kernel", 80.0, 30.0),
              ("void plane_hash_keys_kernel(unsigned int const*)", "kernel", 110.0, 40.0),
              ("void partition_histogram_kernel(long const*)", "kernel", 150.0, 50.0),
              ("void at::native::vectorized_elementwise_kernel<4, FillFunctor<int>>", "kernel",
               200.0, 10.0),
              ("void stream_count_kernel(unsigned int const*)", "kernel", 950.0, 100.0)]
    if extra_op:
        device.append(("void other_stream_kernel()", "kernel", 960.0, 10.0))
    dev = [{"ph": "X", "cat": c, "name": n, "ts": ts, "dur": d, "pid": 0, "tid": 7}
           for n, c, ts, d in device]
    return host + dev


def _record(events) -> harness.Record:
    return harness.Record(spec=Spec(), kmers=2_000_000, window_s=1e-3, setup_s=1.0, calls=1,
                          shapes=[], mapped=[1], trace=common.Trace(events))


def test_the_innermost_stage_span_takes_an_op():
    got = spans.credit(common.Trace(_events()))
    # the count's kernel runs past the window: 50 of its 100 us are inside
    assert got.seconds == pytest.approx({"kmt.upload": 20e-6, "kmt.partition": 80e-6,
                                         "kmt.hash": 40e-6, "": 10e-6, "kmt.count": 50e-6})
    assert got.ops == {"kmt.upload": 1, "kmt.partition": 2, "kmt.hash": 1, "": 1,
                       "kmt.count": 1}
    record = _record(_events())
    want = {"upload_span_us_per_Mkmer": 10.0, "hash_span_us_per_Mkmer": 20.0,
            "partition_span_us_per_Mkmer": 40.0, "count_span_us_per_Mkmer": 25.0}
    for name, value in want.items():
        assert Spec().reader(name).read(record) == pytest.approx(value)


def test_an_op_launched_outside_every_stage_span_is_unspanned():
    record = _record(_events())
    # the fill launched between the partition and the count: 10 of 200 us
    assert Spec().reader("unspanned_device_pct").read(record) == pytest.approx(5.0)


@pytest.mark.parametrize("events", [
    _events(extra_op=True),  # an operation with no launch call on the window's thread
    _events(call="cudaLaunchKernel"),  # the copy tied to a kernel's launch
    _events(stage_spans=False),  # a program without the stage spans
], ids=["op_without_its_launch", "kinds_differ", "no_stage_spans"])
def test_nothing_is_read_where_the_ops_do_not_tie_or_no_stage_span_is_open(events):
    assert spans.credit(common.Trace(events)) is None
    record = _record(events)
    for name in READERS:
        assert Spec().reader(name).read(record) is None
    assert all(Spec().reader(name).read(harness.Record(**{**record.__dict__, "trace": None}))
               is None for name in READERS)
