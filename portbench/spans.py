"""The window's device time credited to the port's stage spans.

The port names the stages of ``KmerMapper.map_chunk`` with
``record_function`` regions (``kmer_mapper_tpu_torch/utils/profiling.py``):
``kmt.upload``, ``kmt.hash``, ``kmt.partition``, ``kmt.count``. The trace
holds them as ``user_annotation`` events on the thread that launched the
work. A device operation of the window is credited to the innermost of
them open on the window's thread when the call that launched it began; one
launched in none of them is unspanned. So a stage's time follows the work
it launches, whatever kernels implement it.

An operation is tied to its launch call by order, since ``common.Trace``
keeps of each event its times, name and category and not the correlation id
that the profiler gives both. The window's operations run on one stream,
launched by the window's thread after a synchronize and finished by one
inside the window, so the card starts them in the order of their launch
calls: the k-th launch call in the window made the k-th operation to start
in it. The tie is made only where the two counts agree and each pair is of
one kind (a copy call and a copy, a set call and a set, any other launch
and a kernel); otherwise nothing is credited and every reader gives None.
The trace of a program without the spans credits nothing either.
"""
from __future__ import annotations

import dataclasses

#: the port's stage spans (``kmer_mapper_tpu_torch/utils/profiling.py``);
#: named here, not imported, so that the readers run on a port without them
STAGES = ("kmt.upload", "kmt.hash", "kmt.partition", "kmt.count")
#: the key of the operations launched outside every stage span
UNSPANNED = ""
#: trace categories of the host's CUDA API calls
CALL_CATEGORIES = ("cuda_runtime", "cuda_driver")
#: parts of the names of the calls that each put one operation on a stream
#: (``cudaLaunchKernel``, ``cudaLaunchCooperativeKernel``, ``cuLaunchKernel``,
#: ``cudaMemcpyAsync``, ``cudaMemsetAsync``, ...)
LAUNCH_CALLS = ("Launch", "Memcpy", "Memset")


def _kind(name: str) -> str:
    """What a launch call puts on the stream, or what an operation is."""
    for kind in ("Memcpy", "Memset"):
        if kind in name:
            return kind
    return "kernel"


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
    span in the window, or where the operations do not tie to the launch
    calls one for one."""
    if trace is None:
        return None
    calls = sorted((s, name) for s, _, name, cat in trace.host
                   if cat in CALL_CATEGORIES and any(p in name for p in LAUNCH_CALLS)
                   and trace.start <= s < trace.end)
    ops = [(a, b, name) for a, b, name in trace.device if trace.start <= a < trace.end]
    spans = sorted((s, e, name) for s, e, name, cat in trace.host
                   if cat == "user_annotation" and name in STAGES
                   and trace.start <= s < trace.end)
    if not ops or not spans or len(calls) != len(ops):
        return None
    if any(_kind(call) != _kind(op) for (_, call), (_, _, op) in zip(calls, ops)):
        return None
    seconds: dict[str, float] = {}
    counted: dict[str, int] = {}
    open_spans: list[tuple[float, float, str]] = []  # nested, innermost last
    i = 0
    for (t, _), (a, b, _) in zip(calls, ops):
        while i < len(spans) and spans[i][0] <= t:
            while open_spans and open_spans[-1][1] <= spans[i][0]:
                open_spans.pop()
            open_spans.append(spans[i])
            i += 1
        while open_spans and open_spans[-1][1] <= t:
            open_spans.pop()
        stage = open_spans[-1][2] if open_spans else UNSPANNED
        seconds[stage] = seconds.get(stage, 0.0) + max(0.0, min(b, trace.end) - a) / 1e6
        counted[stage] = counted.get(stage, 0) + 1
    return Credit(seconds, counted)


def us_per_mkmer(record, span: str) -> float | None:
    """Device microseconds of the operations launched in ``span``, a
    million k-mers of the window; None where nothing was credited to it."""
    got = credit(record.trace)
    if got is None or not got.seconds.get(span):
        return None
    return got.seconds[span] * 1e6 / (record.kmers / 1e6)
