"""Wall-clock spans and memory logging.

The torch counterpart of ``kmer_mapper_tpu/utils/timing.py``: the
reference's ``time.perf_counter()`` DEBUG spans and its
``log_memory_usage_now`` (``kmer_mapper/util.py:33-35``). For device traces
see ``utils/profiling.py``.
"""
from __future__ import annotations

import contextlib
import logging
import resource
import time

import torch

logger = logging.getLogger(__name__)


@contextlib.contextmanager
def span(name: str, level: int = logging.DEBUG):
    """Log the wall time of the block at ``level``."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        logger.log(level, "%s took %.4f sec", name, time.perf_counter() - t0)


def log_memory_usage_now(logplace: str = "") -> float:
    """Log the host's peak resident set in GB, and the device's peak
    allocation where CUDA is in use; returns the host figure."""
    gb = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        logger.info("Memory usage (%s): %.4f GB host, %.4f GB device peak", logplace, gb,
                    torch.cuda.max_memory_allocated() / 1e9)
    else:
        logger.info("Memory usage (%s): %.4f GB", logplace, gb)
    return gb
