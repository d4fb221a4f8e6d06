"""Device traces of the mapping loop.

The torch counterpart of ``kmer_mapper_tpu/utils/profiling.py``:
``torch.profiler`` in place of ``jax.profiler``. :func:`trace` records the
host's torch operations and, where CUDA is in use, the device's kernels and
copies, and writes a Chrome trace (``*.pt.trace.json``, for TensorBoard or
Perfetto) into ``logdir``; :func:`step_annotation` names a region of it.
"""
from __future__ import annotations

import contextlib

import torch
from torch.profiler import ProfilerActivity, profile, record_function, tensorboard_trace_handler


@contextlib.contextmanager
def trace(logdir: str):
    """Trace everything inside the context into ``logdir``."""
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(logdir)) as prof:
        yield prof


def step_annotation(name: str):
    """A named region (one chunk's step) in the trace."""
    return record_function(name)
