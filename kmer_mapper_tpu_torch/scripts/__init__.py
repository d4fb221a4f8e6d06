"""Dissection scripts of the port's kernels on the GPU: the counterparts of
the Pallas measurement scripts under ``scripts/``, and the gather probe's.

    python -m kmer_mapper_tpu_torch.scripts.r2_kernel_dissect [variant ...]
    python -m kmer_mapper_tpu_torch.scripts.r2_window_dissect [variant ...]
    python -m kmer_mapper_tpu_torch.scripts.r3_iter_floor [variant ...]
    python -m kmer_mapper_tpu_torch.scripts.r9_dot_orient [variant ...]
    python -m kmer_mapper_tpu_torch.scripts.r9_step_parts [variant ...]
    python -m kmer_mapper_tpu_torch.scripts.r9_block_pipeline [variant ...]
    python -m kmer_mapper_tpu_torch.scripts.gather_probe_dissect [variant ...]
    python -m kmer_mapper_tpu_torch.scripts.partition_dissect [--keys N]
    python -m kmer_mapper_tpu_torch.scripts.finalize_dissect [variant ...]

and the counterparts of the repo's whole-system scripts under ``scripts/``,
with the drill's index through the user's entry points and a job of
several processes (no kernel of their own: they drive the pipeline, the
library calls and the mappers):

    python -m kmer_mapper_tpu_torch.scripts.bench_matrix
    python -m kmer_mapper_tpu_torch.scripts.scale_run [--reads N]
    python -m kmer_mapper_tpu_torch.scripts.scale_drill [N_KEYS_MILLIONS]
    python -m kmer_mapper_tpu_torch.scripts.human_scale [N_KEYS_MILLIONS]
    python -m kmer_mapper_tpu_torch.scripts.multihost_run -i INDEX --expect NPY READS ...

Each module holds a hand-written CUDA kernel (``csrc/<name>.cu``) with its
variants, the kernel's plain-torch twin and a ``main`` that times every
variant on the card and prints one line per variant (``--device cpu`` runs
the twins instead). Wrappers launch the kernel on CUDA tensors and run the
twin only on CPU tensors. The r2 and r3 scripts take the stream count
apart; the three r9 scripts run its tile body (``csrc/r9_tile.cuh``) under
the layouts of the TPU kernel's tiles. ``gather_probe_dissect`` switches
the gather probe's design points one at a time; ``partition_dissect``
times the block partition's first design beside the main path's, and
``finalize_dissect`` the node-count finalize's other designs beside its.
"""
from __future__ import annotations

import argparse
import statistics
import sys
import time

import torch


def device_arg(parser: argparse.ArgumentParser) -> None:
    parser.add_argument("--device", default="cuda",
                        help="torch device (default: cuda; --device cpu runs the "
                             "plain twins, at a small size)")


def pick_device(name: str) -> torch.device:
    """The device a script was asked for; exits when that is CUDA and
    PyTorch sees no GPU (a script never falls back to the CPU)."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        sys.exit(f"--device {name}: PyTorch sees no CUDA device; pass --device cpu "
                 "to run the plain twins on the CPU")
    return device


def device_name(device: torch.device) -> str:
    if device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return "cpu (plain twins; host clock)"


#: GPU cycles (~11 ms on an H100) that the stream is held while timed
#: launches are queued behind it
HOLD_CYCLES = 20_000_000


def median_ms(fn, device: torch.device, reps: int = 5) -> float:
    """Median milliseconds of ``reps`` calls of ``fn`` after one warm-up.
    On a GPU: a CUDA event after each call, all queued while the stream is
    held by ``torch.cuda._sleep``, so that each interval is the device's
    time for one call and not the host's launch overhead (a call that
    synchronises inside, as the twins do, is timed with its host work). On
    the CPU: the host clock."""
    fn()
    if device.type != "cuda":
        times = []
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(times)
    events = [torch.cuda.Event(enable_timing=True) for _ in range(reps + 1)]
    torch.cuda.synchronize(device)
    torch.cuda._sleep(HOLD_CYCLES)
    events[0].record()
    for event in events[1:]:
        fn()
        event.record()
    events[-1].synchronize()
    return statistics.median(a.elapsed_time(b) for a, b in zip(events, events[1:]))


def cold_ms(fn, device: torch.device, reps: int = 5) -> float:
    """Median milliseconds of one call of ``fn`` after the L2 has been
    flushed by a 256 MiB fill, as a caller whose data left the cache finds
    it. On a GPU the stream is held by ``torch.cuda._sleep`` behind the
    fill, so the events time the device and not the host's launch. On the
    CPU: :func:`median_ms`."""
    if device.type != "cuda":
        return median_ms(fn, device, reps)
    flush = torch.empty(1 << 26, dtype=torch.int32, device=device)
    fn()
    times = []
    for r in range(reps):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        torch.cuda.synchronize(device)
        flush.fill_(r)
        torch.cuda._sleep(HOLD_CYCLES // 4)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def stage_split(dev_chunks, stages, device: torch.device) -> dict:
    """Mean ms a chunk of each stage of a chunk step, over ``dev_chunks``:
    CUDA events recorded around each stage on a GPU (the card's time, with
    the host's launch overhead where the card waits for it), the host clock
    on the CPU. ``stages`` are (name, fn) pairs; each fn takes the state
    the previous one returned, the first the chunk."""
    cuda = device.type == "cuda"
    stage_ms = dict.fromkeys((name for name, _ in stages), 0.0)
    for chunk in dev_chunks:
        if cuda:
            marks = [torch.cuda.Event(enable_timing=True) for _ in range(len(stages) + 1)]
            marks[0].record()
        else:
            marks = [time.perf_counter()]
        state = chunk
        for i, (_, fn) in enumerate(stages):
            state = fn(state)
            if cuda:
                marks[i + 1].record()
            else:
                marks.append(time.perf_counter())
        if cuda:
            torch.cuda.synchronize(device)
        for i, name in enumerate(stage_ms):
            ms = marks[i].elapsed_time(marks[i + 1]) if cuda else (marks[i + 1] - marks[i]) * 1e3
            stage_ms[name] += ms / len(dev_chunks)
    return stage_ms
