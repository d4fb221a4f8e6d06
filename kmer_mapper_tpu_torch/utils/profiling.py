"""Device traces of the mapping loop, and the spans that name its stages.

The torch counterpart of ``kmer_mapper_tpu/utils/profiling.py``:
``torch.profiler`` in place of ``jax.profiler``. :func:`trace` records the
host's torch operations and, where CUDA is in use, the device's kernels and
copies, and writes a Chrome trace (``*.pt.trace.json``, for TensorBoard or
Perfetto) into ``logdir``; :func:`span` names a region of it.

A span is a ``record_function`` region: a ``user_annotation`` event in the
same trace as the device's records, on their clock, and every kernel or
copy launched inside it is tied to its launch by the trace's correlation
id. The spans, by name:

    map_chunk      one chunk's step in ``pipeline.map_file``'s loop
    kmt.feed_wait  that loop waiting on the host feed for its next chunk
                   (what the run's ``queue_wait_s`` sums)
    kmt.upload     ``KmerMapper.map_chunk``: the chunk's words to the
                   device, and apart the ragged step's read lengths with
                   their host check. On CUDA a page-locked chunk's copies
                   run on the mapper's copy stream, into its two device
                   staging slots, beside the previous chunk's kernels (the
                   mapper's stream waits for them); numpy input goes on the
                   mapper's stream. A ``pipeline.PinnedRing`` host buffer is
                   rewritten only once the event recorded on the copy
                   stream after its copies (``KmerMapper.upload_done``)
                   has completed
    kmt.hash       ``ops/hashing.py``: the hash-key kernels of both steps
    kmt.partition  ``ops/block_partition.py``: the block partition, every
                   radix pass with its fills and scans, and the offsets
    kmt.count      ``ops/stream_probe.py``: the stream count

The four ``kmt.*`` stages tile the device work of ``map_chunk``: a kernel,
copy or fill added to the mapping step is launched inside its stage's span
(on the sharded grid too, which calls the same entry functions).

The gate: a span is recorded only while a profiler records
(``torch.autograd._profiler_enabled()``); otherwise :func:`span` returns one
shared no-op context, so the untraced step constructs no
``record_function``: a span costs it one check of the profiler's state.
"""
from __future__ import annotations

import contextlib

import torch
from torch.profiler import ProfilerActivity, profile, record_function, tensorboard_trace_handler

MAP_CHUNK = "map_chunk"
FEED_WAIT = "kmt.feed_wait"
UPLOAD = "kmt.upload"
HASH = "kmt.hash"
PARTITION = "kmt.partition"
COUNT = "kmt.count"

_NO_SPAN = contextlib.nullcontext()


@contextlib.contextmanager
def trace(logdir: str):
    """Trace everything inside the context into ``logdir``."""
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(logdir)) as prof:
        yield prof


def span(name: str):
    """A region named ``name`` in the trace while a profiler records; else
    a shared no-op context."""
    if torch.autograd._profiler_enabled():
        return record_function(name)
    return _NO_SPAN
