"""The stage spans' readers (``portbench/spans.py``) on a made-up trace: the
innermost stage span takes an operation, tied to its launch call by
correlation id whatever order the operations run in; one launched outside
every stage span or by another thread is unspanned; and where an operation
ties to no recorded call, or the program has no stage spans, nothing is
read."""
from __future__ import annotations

import pytest

from portbench import common, harness, spans
from portbench.spec import Spec

SPAN_METRICS = {"upload_span_us_per_Mkmer": "kmt.upload", "hash_span_us_per_Mkmer": "kmt.hash",
                "partition_span_us_per_Mkmer": "kmt.partition",
                "count_span_us_per_Mkmer": "kmt.count"}
READERS = [*SPAN_METRICS, "unspanned_device_pct"]


def _x(cat, name, ts, dur, tid=1, cid=None):
    event = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "pid": 1, "tid": tid}
    if cid is not None:
        event["args"] = {"correlation": cid}
    return event


def _events(stage_spans=True, extra_op=False, ids=True, swapped=False, lost_call=False):
    """A window of 1000 us: the upload's copy, a partition with a hash span
    nested in it (as a stage calling another would be), a launch between
    the spans, the count; each operation with the correlation id of its
    launch call (none where not ``ids``), the operations in the order of
    their calls but for the partition's scatter and the hash where
    ``swapped``; with ``extra_op`` an operation launched by another
    thread; with ``lost_call`` the hash kernel's launch call not recorded."""
    host = [_x("user_annotation", common.WINDOW_SPAN, 0.0, 1000.0),
            _x("user_annotation", "map_chunk", 5.0, 700.0)]
    if stage_spans:
        host += [_x("user_annotation", "kmt.upload", 10.0, 40.0),
                 _x("user_annotation", "kmt.partition", 100.0, 300.0),
                 _x("user_annotation", "kmt.hash", 150.0, 50.0),
                 _x("user_annotation", "kmt.count", 500.0, 100.0),
                 _x("user_annotation", "kmt.count", 0.0, 900.0, tid=2)]  # another thread's
    def cid(i):
        return i if ids else None

    host += [_x("cuda_runtime", "cudaMemcpyAsync", 20.0, 5.0, cid=cid(1)),
             _x("cuda_runtime", "cudaLaunchKernel", 120.0, 5.0, cid=cid(2)),
             _x("cpu_op", "aten::zeros", 140.0, 30.0),
             _x("cuda_runtime", "cudaLaunchKernel", 160.0, 5.0, cid=cid(3)),
             _x("cuda_runtime", "cudaLaunchKernel", 300.0, 5.0, cid=cid(4)),
             _x("cuda_runtime", "cudaLaunchKernel", 450.0, 5.0, cid=cid(5)),
             _x("cuda_runtime", "cudaLaunchCooperativeKernel", 550.0, 5.0, cid=cid(6)),
             _x("cuda_runtime", "cudaStreamSynchronize", 900.0, 90.0, cid=cid(7)),
             # not the window's thread
             _x("cuda_runtime", "cudaLaunchKernel", 600.0, 5.0, tid=2, cid=cid(8))]
    scatter, hashing = (110.0, 80.0) if swapped else (80.0, 110.0)
    device = [("Memcpy HtoD (Pinned -> Device)", "gpu_memcpy", 60.0, 20.0, 1),
              ("void radix_scatter_kernel(long const*)", "kernel", scatter, 30.0, 2),
              ("void plane_hash_keys_kernel(unsigned int const*)", "kernel", hashing, 40.0, 3),
              ("void partition_histogram_kernel(long const*)", "kernel", 150.0, 50.0, 4),
              ("void at::native::vectorized_elementwise_kernel<4, FillFunctor<int>>", "kernel",
               200.0, 10.0, 5),
              ("void stream_count_kernel(unsigned int const*)", "kernel", 950.0, 100.0, 6)]
    if extra_op:
        device.append(("void other_stream_kernel()", "kernel", 960.0, 10.0, 8))
    if lost_call:
        host = [e for e in host if e.get("args", {}).get("correlation") != 3]
    dev = [{"ph": "X", "cat": c, "name": n, "ts": ts, "dur": d, "pid": 0, "tid": 7,
            **({"args": {"correlation": i}} if ids else {})}
           for n, c, ts, d, i in device]
    return host + dev


def _record(events) -> harness.Record:
    return harness.Record(spec=Spec(), kmers=2_000_000, window_s=1e-3, setup_s=1.0, calls=1,
                          shapes=[], mapped=[1], trace=common.Trace(events))


@pytest.mark.parametrize("swapped", [False, True], ids=["in_launch_order", "out_of_order"])
def test_the_innermost_stage_span_takes_an_op(swapped):
    got = spans.credit(common.Trace(_events(swapped=swapped)))
    # the count's kernel runs past the window: 50 of its 100 us are inside
    assert got.seconds == pytest.approx({"kmt.upload": 20e-6, "kmt.partition": 80e-6,
                                         "kmt.hash": 40e-6, "": 10e-6, "kmt.count": 50e-6})
    assert got.ops == {"kmt.upload": 1, "kmt.partition": 2, "kmt.hash": 1, "": 1,
                       "kmt.count": 1}
    record = _record(_events(swapped=swapped))
    want = {"upload_span_us_per_Mkmer": 10.0, "hash_span_us_per_Mkmer": 20.0,
            "partition_span_us_per_Mkmer": 40.0, "count_span_us_per_Mkmer": 25.0}
    for name, value in want.items():
        assert Spec().reader(name).read(record) == pytest.approx(value)


def test_an_op_launched_outside_every_stage_span_is_unspanned():
    record = _record(_events())
    # the fill launched between the partition and the count: 10 of 200 us
    assert Spec().reader("unspanned_device_pct").read(record) == pytest.approx(5.0)


def test_an_op_launched_by_another_thread_is_unspanned():
    record = _record(_events(extra_op=True))
    # the fill and the other thread's kernel: 20 of 210 us
    assert Spec().reader("unspanned_device_pct").read(record) == pytest.approx(2000 / 210)
    assert spans.credit(record.trace).ops[spans.UNSPANNED] == 2


@pytest.mark.parametrize("events", [
    _events(ids=False),  # a trace without correlation ids
    _events(lost_call=True),  # an operation whose launch call was not recorded
    _events(lost_call=True, extra_op=True),  # ... beside another thread's
    _events(stage_spans=False),  # a program without the stage spans
], ids=["no_correlation_ids", "lost_call", "lost_call_beside_another_thread",
        "no_stage_spans"])
def test_nothing_is_read_where_the_ops_do_not_tie_or_no_stage_span_is_open(events):
    assert spans.credit(common.Trace(events)) is None
    record = _record(events)
    for name in READERS:
        assert Spec().reader(name).read(record) is None
    assert all(Spec().reader(name).read(harness.Record(**{**record.__dict__, "trace": None}))
               is None for name in READERS)
