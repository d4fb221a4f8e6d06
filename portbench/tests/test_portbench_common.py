"""The shared arithmetic: the window, the spread, the roofline and the
trace reader, on made-up events."""
from __future__ import annotations

import statistics

import pytest

from portbench import common, harness
from portbench.spec import Spec


def _events():
    win = {"ph": "X", "cat": "user_annotation", "name": common.WINDOW_SPAN, "ts": 100.0,
           "dur": 1000.0, "pid": 1, "tid": 1}
    host = [{"ph": "X", "cat": "cpu_op", "name": "aten::to", "ts": 150.0, "dur": 200.0,
             "pid": 1, "tid": 1},
            {"ph": "X", "cat": "user_annotation", "name": "map_chunk", "ts": 140.0,
             "dur": 300.0, "pid": 1, "tid": 1},
            {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 400.0,
             "dur": 60.0, "pid": 1, "tid": 1},  # 40 of it inside the region
            {"ph": "X", "cat": "user_annotation", "name": "map_chunk", "ts": 500.0,
             "dur": 100.0, "pid": 1, "tid": 1},
            {"ph": "X", "cat": "cuda_runtime", "name": "cudaStreamSynchronize", "ts": 700.0,
             "dur": 400.0, "pid": 1, "tid": 1},
            {"ph": "X", "cat": "cpu_op", "name": "elsewhere", "ts": 150.0, "dur": 900.0,
             "pid": 1, "tid": 2}]
    device = [("Memcpy HtoD (Pinned -> Device)", "gpu_memcpy", 50.0, 100.0),  # half inside
              ("void stream_count_kernel(unsigned int const*)", "kernel", 300.0, 100.0),
              ("radix_scatter_kernel(long long const*)", "kernel", 350.0, 150.0),  # overlaps
              ("plane_hash_keys_kernel(unsigned int const*)", "kernel", 800.0, 100.0),
              ("after", "kernel", 1200.0, 50.0)]  # outside
    dev = [{"ph": "X", "cat": c, "name": n, "ts": ts, "dur": d, "pid": 0, "tid": 7}
           for n, c, ts, d in device]
    return [win, *host, *dev, {"ph": "i", "name": "instant", "ts": 5.0}]


def test_the_trace_reader_clips_to_the_window_and_merges_overlaps():
    trace = common.Trace(_events())
    assert trace.window_s == pytest.approx(1000e-6)
    assert trace.device_seconds(["Memcpy HtoD"]) == pytest.approx(50e-6)
    assert trace.device_seconds(["stream_count_kernel", "radix_scatter"]) == pytest.approx(
        250e-6)
    assert trace.device_seconds(["after"]) == 0.0
    assert trace.busy_s() == pytest.approx((50 + 200 + 100) * 1e-6)
    ops = dict(trace.device_ops())
    assert ops["radix_scatter_kernel"] == pytest.approx(150e-6)
    assert ops["stream_count_kernel"] == pytest.approx(100e-6)
    gaps = trace.idle_gaps()
    # gaps: 150-300 (under aten::to), 500-800 (a map_chunk region), 900-1100
    # (the sync)
    assert [g[0] for g in gaps] == ["map_chunk", "cudaStreamSynchronize", "aten::to"]
    assert [g[1] for g in gaps] == pytest.approx([300e-6, 200e-6, 150e-6])


def test_the_trace_needs_one_window():
    with pytest.raises(ValueError):
        common.Trace([e for e in _events() if e.get("name") != common.WINDOW_SPAN])


def test_per_layer_readers_read_the_trace():
    spec = Spec()
    shape = common.BufferShape(strided=True, n_reads=10, n_bases=1510, n_words=100,
                               n_windows=1210, n_keys=1210, n_buckets=128, distinct_hits=5)
    record = harness.Record(spec=spec, kmers=2_000_000, window_s=1e-3, setup_s=1.0, calls=4,
                            shapes=[shape, shape], mapped=[3, 1],
                            trace=common.Trace(_events()))
    assert record.us_per_mkmer("upload") == pytest.approx(50 / 2)
    assert record.least_bytes(lambda s: s.n_windows) == 4 * 1210
    hash_bytes = 4 * (4 * 100 + 8 * 1210)
    assert spec.reader("hash_roofline_pct").read(record) == pytest.approx(
        100 * hash_bytes / common.PEAK_BYTES_S / 100e-6)
    # two regions of 300 and 100 us, less 40 us of runtime call inside one
    assert spec.reader("map_chunk_host_us").read(record) == pytest.approx(180.0)
    assert spec.reader("device_idle_pct").read(record) == pytest.approx(65.0)
    assert spec.reader("kmers_per_s").read(record) == pytest.approx(2000.0)
    no_trace = harness.Record(**{**record.__dict__, "trace": None})
    for name in ("hash_us_per_Mkmer", "count_roofline_pct", "device_idle_pct",
                 "map_chunk_host_us"):
        assert spec.reader(name).read(no_trace) is None


def test_spread_is_the_quartile_distance_over_the_median():
    values = [10.0, 10.2, 9.9, 10.1, 10.4, 9.8]
    q1, _, q3 = statistics.quantiles(values, n=4)
    assert common.spread(values) == pytest.approx((q3 - q1) / statistics.median(values))


def test_the_window_steps_in_turn_and_times_to_the_end_of_the_sync():
    stepped, synced = [], []
    mapped, seconds = common.timed_window(stepped.append, 3, 0.05, lambda: synced.append(1))
    assert stepped[:4] == [0, 1, 2, 0] and synced == [1]
    assert sum(mapped) == len(stepped) and max(mapped) - min(mapped) <= 1
    assert seconds >= 0.05
    assert common.roofline_pct(0, 1.0) is None and common.roofline_pct(3.35e12, 2.0) == 50.0
