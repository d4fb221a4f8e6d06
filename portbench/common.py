"""The benchmark's shared arithmetic: the timed window, the spread of a set
of runs, the roofline, and the reader of a ``torch.profiler`` trace.

The peak is the published one of one NVIDIA H100 SXM5 80GB (NVIDIA's data
sheet): HBM3 at 3.35 TB/s. Every layer of the mapping step is bound by
bytes, so only the bytes' peak is used.
"""
from __future__ import annotations

import bisect
import dataclasses
import json
import statistics
import time
from typing import Callable

#: HBM bandwidth of one H100 SXM5 80GB, bytes a second (NVIDIA's data sheet)
PEAK_BYTES_S = 3.35e12
#: the name of the host region around the timed window in a traced run
WINDOW_SPAN = "portbench.window"
#: trace categories of work on the device
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
#: trace categories of the host's CUDA API calls
CALL_CATEGORIES = ("cuda_runtime", "cuda_driver")
#: trace categories of work on the host
HOST_CATEGORIES = ("cpu_op", "user_annotation") + CALL_CATEGORIES


def timed_window(step: Callable[[int], None], n_items: int, seconds: float,
                 sync: Callable[[], None]) -> tuple[list[int], float]:
    """Calls ``step(i)`` on items 0, 1, ..., n_items - 1, 0, ... until
    ``seconds`` have passed on the host clock, then ``sync()``. Returns the
    times each item was stepped and the window's seconds, to the end of the
    sync: all the work and all the time."""
    mapped = [0] * n_items
    i = 0
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        step(i)
        mapped[i] += 1
        i = (i + 1) % n_items
    sync()
    return mapped, time.perf_counter() - t0


def spread(values: list[float]) -> float:
    """The distance between the first and the third quartile
    (``statistics.quantiles(values, n=4)``) as a share of the median."""
    q1, _, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / statistics.median(values)


def roofline_pct(least_bytes: float, seconds: float | None) -> float | None:
    """The least time the bytes take at the HBM peak, as a percentage of
    ``seconds``; None where nothing was timed."""
    if not seconds or least_bytes <= 0:
        return None
    return 100.0 * least_bytes / PEAK_BYTES_S / seconds


@dataclasses.dataclass
class BufferShape:
    """What a byte function may read of one buffer of the pool."""

    strided: bool  # stride-padded fixed-length reads (else continuous)
    n_reads: int
    n_bases: int
    n_words: int  # int32 words of the packed buffer handed to the mapper
    n_windows: int  # valid k-mer windows: the k-mers mapped (kmers_per_s counts them)
    n_keys: int  # the keys the step makes: n_windows, twice that under revcomp
    n_buckets: int  # the table's buckets (8 slots of 8 bytes each)
    distinct_hits: int  # distinct index k-mers the buffer's keys hit (either hash of a window)


def correlation(event: dict) -> int:
    """The profiler's correlation id of a CUDA call or of the device
    operation it launched (both carry it); -1 where the event has none."""
    return int(event.get("args", {}).get("correlation", -1))


class Trace:
    """The events of a ``torch.profiler`` Chrome trace inside its timed
    window (the ``WINDOW_SPAN`` region on the host); times in seconds."""

    def __init__(self, events: list[dict]):
        events = [e for e in events if e.get("ph") == "X" and "dur" in e]
        spans = [e for e in events if e.get("name") == WINDOW_SPAN]
        if len(spans) != 1:
            raise ValueError(f"the trace holds {len(spans)} {WINDOW_SPAN} regions, not one")
        win = spans[0]
        self.start = float(win["ts"])
        self.end = self.start + float(win["dur"])
        device = sorted(
            (float(e["ts"]), float(e["ts"]) + float(e["dur"]), e.get("name", "?"), correlation(e))
            for e in events if e.get("cat") in DEVICE_CATEGORIES)
        self.device = [(a, b, name) for a, b, name, _ in device]
        #: the correlation id of each operation of ``device``
        self.device_ids = [c for _, _, _, c in device]
        own = [e for e in events if e.get("tid") == win.get("tid")
               and e.get("pid") == win.get("pid")]
        self.host = [(float(e["ts"]), float(e["ts"]) + float(e["dur"]), e.get("name", "?"),
                      e.get("cat"))
                     for e in own if e.get("cat") in HOST_CATEGORIES]
        #: the start of each CUDA call of the window's thread, by correlation id
        self.call_starts = {correlation(e): float(e["ts"]) for e in own
                            if e.get("cat") in CALL_CATEGORIES and correlation(e) >= 0}
        #: the correlation ids of the CUDA calls of every other thread
        self.other_calls = {correlation(e) for e in events
                            if e.get("cat") in CALL_CATEGORIES and correlation(e) >= 0
                            } - self.call_starts.keys()

    @classmethod
    def from_file(cls, path) -> "Trace":
        with open(path) as f:
            return cls(json.load(f)["traceEvents"])

    @property
    def window_s(self) -> float:
        return (self.end - self.start) / 1e6

    def _inside(self):
        for a, b, name in self.device:
            a, b = max(a, self.start), min(b, self.end)
            if b > a:
                yield a, b, name

    def device_seconds(self, patterns: list[str]) -> float:
        """Device time of the operations whose name holds one of
        ``patterns``, inside the window."""
        return sum(b - a for a, b, name in self._inside()
                   if any(p in name for p in patterns)) / 1e6

    def launches(self, patterns: list[str]) -> int:
        """Device operations whose name holds one of ``patterns`` that
        start inside the window."""
        return sum(1 for a, _, name in self.device
                   if self.start <= a < self.end and any(p in name for p in patterns))

    def host_self_s(self, region: str) -> tuple[float, int]:
        """(seconds, count) of the host regions named ``region`` in the
        window, less the CUDA runtime calls inside them (launches and
        copies, in which the host may wait for room in the device's queue):
        the host's own work in them."""
        regions = sorted((s, e) for s, e, name, cat in self.host
                         if name == region and cat == "user_annotation"
                         and self.start <= s and e <= self.end)
        starts = [s for s, _ in regions]
        total = sum(e - s for s, e in regions)
        for s, e, _, cat in self.host:
            if cat != "cuda_runtime":
                continue
            i = bisect.bisect_right(starts, s) - 1
            if i >= 0 and s < regions[i][1]:
                total -= min(e, regions[i][1]) - s
        return total / 1e6, len(regions)

    def _busy(self) -> list[tuple[float, float]]:
        merged: list[list[float]] = []
        for a, b, _ in self._inside():
            if merged and a <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], b)
            else:
                merged.append([a, b])
        return [(a, b) for a, b in merged]

    def busy_s(self) -> float:
        """Seconds of the window in which some operation ran on the device."""
        return sum(b - a for a, b in self._busy()) / 1e6

    def device_ops(self, top: int = 10) -> list[list]:
        """[name, seconds] of the device operations that took the most time."""
        total: dict[str, float] = {}
        for a, b, name in self._inside():
            key = short_name(name)
            total[key] = total.get(key, 0.0) + (b - a) / 1e6
        return [[n, s] for n, s in sorted(total.items(), key=lambda x: -x[1])[:top]]

    def idle_gaps(self, top: int = 10) -> list[list]:
        """[what the host was doing, seconds] of the longest stretches of
        the window with nothing on the device: the innermost host region
        open where the stretch begins."""
        gaps, cursor = [], self.start
        for a, b in self._busy() + [(self.end, self.end)]:
            if a > cursor:
                gaps.append((a - cursor, cursor))
            cursor = max(cursor, b)
        out = []
        for length, at in sorted(gaps, reverse=True)[:top]:
            open_regions = [(s, name) for s, e, name, _ in self.host if s <= at < e]
            label = max(open_regions)[1] if open_regions else "host idle"
            out.append([short_name(label), length / 1e6])
        return out


def short_name(name: str) -> str:
    """A kernel's or region's name without its namespace and arguments."""
    name = name.replace("(anonymous namespace)::", "").split("(")[0].strip()
    if name.startswith("void "):
        name = name[5:]
    return name[:120]
