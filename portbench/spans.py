"""The window's device time credited to the port's stage spans.

The port names the stages of ``KmerMapper.map_chunk`` with
``record_function`` regions (``kmer_mapper_tpu_torch/utils/profiling.py``):
``kmt.upload``, ``kmt.hash``, ``kmt.partition``, ``kmt.count``. The trace
holds them as ``user_annotation`` events on the thread that launched the
work. A device operation of the window is credited to the innermost of
them open on the window's thread when the call that launched it began; one
launched in none of them is unspanned. So a stage's time follows the work
it launches, whatever kernels implement it.

An operation is tied to the CUDA call that launched it by the correlation
id that the profiler gives both. One launched by a call of another thread
is unspanned. Where an operation of the window ties to no recorded call
(the trace carries no correlation ids, or lost a call's record), or the
window holds no stage span, nothing is credited and every reader gives
None. The trace of a program without the spans credits nothing either.
"""
from __future__ import annotations

import dataclasses

#: the port's stage spans (``kmer_mapper_tpu_torch/utils/profiling.py``);
#: named here, not imported, so that the readers run on a port without them
STAGES = ("kmt.upload", "kmt.hash", "kmt.partition", "kmt.count")
#: the key of the operations launched outside every stage span
UNSPANNED = ""


@dataclasses.dataclass
class Credit:
    """Device seconds (clipped to the window) and operations, by the stage
    span that launched them (``UNSPANNED``: none)."""

    seconds: dict[str, float]
    ops: dict[str, int]

    def share(self, span: str) -> float:
        total = sum(self.seconds.values())
        return self.seconds.get(span, 0.0) / total if total else 0.0


def credit(trace) -> Credit | None:
    """The window's device operations credited to the stage spans of a
    ``common.Trace``; None without a trace, without an operation or a stage
    span in the window, or where an operation ties to no recorded call."""
    if trace is None:
        return None
    ops = [(cid, a, b) for (a, b, _), cid in zip(trace.device, trace.device_ids)
           if trace.start <= a < trace.end]
    spans = sorted((s, e, name) for s, e, name, cat in trace.host
                   if cat == "user_annotation" and name in STAGES
                   and trace.start <= s < trace.end)
    if not ops or not spans:
        return None
    if any(cid not in trace.call_starts and cid not in trace.other_calls for cid, _, _ in ops):
        return None
    seconds: dict[str, float] = {}
    counted: dict[str, int] = {}

    def add(stage: str, a: float, b: float) -> None:
        seconds[stage] = seconds.get(stage, 0.0) + max(0.0, min(b, trace.end) - a) / 1e6
        counted[stage] = counted.get(stage, 0) + 1

    for cid, a, b in ops:
        if cid in trace.other_calls:
            add(UNSPANNED, a, b)
    tied = sorted((trace.call_starts[cid], a, b) for cid, a, b in ops
                  if cid in trace.call_starts)
    open_spans: list[tuple[float, float, str]] = []  # nested, innermost last
    i = 0
    for t, a, b in tied:  # in the order of the launch calls
        while i < len(spans) and spans[i][0] <= t:
            while open_spans and open_spans[-1][1] <= spans[i][0]:
                open_spans.pop()
            open_spans.append(spans[i])
            i += 1
        while open_spans and open_spans[-1][1] <= t:
            open_spans.pop()
        add(open_spans[-1][2] if open_spans else UNSPANNED, a, b)
    return Credit(seconds, counted)


def us_per_mkmer(record, span: str) -> float | None:
    """Device microseconds of the operations launched in ``span``, a
    million k-mers of the window; None where nothing was credited to it."""
    got = credit(record.trace)
    if got is None or not got.seconds.get(span):
        return None
    return got.seconds[span] * 1e6 / (record.kmers / 1e6)
