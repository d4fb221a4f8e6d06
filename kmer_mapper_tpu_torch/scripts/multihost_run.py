"""Several processes, one job: each process maps its shard of the reads
files on a device of its own, and ``ShardedKmerMapper.node_counts``
all-reduces the node counts over the ``torch.distributed`` group (NCCL on
CUDA, gloo on the CPU), as ``parallel/multihost.py`` describes.

    python -m kmer_mapper_tpu_torch.scripts.multihost_run -i INDEX --expect COUNTS.npy
        [--processes N] [--index-parallel X] [--device cpu] READS [READS ...]

Starts N (2) worker processes of this module on localhost, each given the
group's address (a free port), the world size and its rank. Worker r
joins the group (``multihost.initialize``), takes its files of
``multihost.host_shard(READS)`` and maps each with
``pipeline.map_file_sharded`` on a (1, X) grid of its own device
(``cuda:r``, or the CPU); every call's vector is the whole group's, and a
worker's sum of them must equal ``--expect``, the single-process node
counts of all the files. The number of files must be a multiple of N, so
that every process makes the same collective calls. Prints each worker's
figures and one ``RESULT`` line; exits non-zero when a worker fails or a
vector differs.
"""
from __future__ import annotations

import argparse
import os
import socket
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

#: seconds a worker may take
WORKER_TIMEOUT_S = 600


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def worker(a) -> None:
    """One process of the group: map this rank's files, save the summed
    all-reduced vector to ``a.out``."""
    from .. import pipeline
    from ..parallel import multihost

    if a.device == "cuda":
        device = torch.device("cuda", a.rank)
        torch.cuda.set_device(device)
    else:
        device = torch.device(a.device)
    multihost.initialize(f"localhost:{a.port}", a.processes, a.rank,
                         backend="nccl" if device.type == "cuda" else "gloo")
    import torch.distributed as dist

    try:
        files = multihost.host_shard(a.reads)
        total = None
        t = time.perf_counter()
        for path in files:
            counts = pipeline.map_file_sharded(a.index, path, k=a.k, devices=[device] * a.x,
                                               index_parallel=a.x)
            total = counts if total is None else total + counts  # uint32, wrapping
        wall = time.perf_counter() - t
        np.save(a.out, total)
        print(f"WORKER rank={a.rank} backend={dist.get_backend()} device={device} "
              f"files={len(files)} wall_s={wall} sum={int(total.sum(dtype=np.int64))}",
              flush=True)
    finally:
        dist.destroy_process_group()


def run(index: str, reads: list[str], expect: np.ndarray, *, processes: int = 2,
        index_parallel: int = 1, device: str = "cuda", k: int = 31) -> dict:
    """Start the workers and hold each one's vector to ``expect``. Returns
    the workers' lines and the call's wall seconds."""
    if len(reads) % processes:
        raise ValueError(f"multihost_run: {len(reads)} files for {processes} processes")
    if device == "cuda" and torch.cuda.device_count() < processes:
        raise RuntimeError(f"multihost_run: {processes} processes need as many cards; "
                           f"torch.cuda.device_count() is {torch.cuda.device_count()}")
    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (root, os.environ.get("PYTHONPATH")) if p))
    port = free_port()
    with tempfile.TemporaryDirectory(prefix="kmt_multihost_") as tmp:
        outs = [os.path.join(tmp, f"rank{r}.npy") for r in range(processes)]
        t = time.perf_counter()
        procs = [subprocess.Popen(
            [sys.executable, "-m", __spec__.name, "--worker", str(r), "--port", str(port),
             "--processes", str(processes), "--index-parallel", str(index_parallel),
             "--device", device, "-k", str(k), "-i", index, "--out", outs[r], *reads],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
            for r in range(processes)]
        results = []
        try:
            for p in procs:
                out, err = p.communicate(timeout=WORKER_TIMEOUT_S)
                results.append((p.returncode, out, err))
        finally:
            for p in procs:
                p.kill()
                p.wait()
        wall = time.perf_counter() - t
        failed = [r for r, (rc, _, _) in enumerate(results) if rc]
        if failed:
            raise AssertionError("multihost_run: workers " + ", ".join(map(str, failed))
                                 + " failed:\n" + "\n".join(results[r][2][-3000:]
                                                            for r in failed))
        lines = [line for _, out, _ in results for line in out.splitlines()
                 if line.startswith("WORKER ")]
        for r, path in enumerate(outs):
            got = np.load(path)
            if not np.array_equal(got, expect):
                differ = int((got != expect).sum()) if got.shape == expect.shape else None
                raise AssertionError(
                    f"multihost_run: rank {r}'s all-reduced node counts differ from the "
                    f"single-process vector: sum {int(got.sum(dtype=np.int64))} against "
                    f"{int(expect.sum(dtype=np.int64))}, {differ} of {len(expect)} nodes "
                    "differ; " + "; ".join(lines))
    for line in lines:
        log(line)
    return dict(workers=lines, wall_s=wall)


def main(argv=None) -> dict | None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("reads", nargs="+", help="reads files, a multiple of --processes")
    parser.add_argument("-i", "--index", required=True, help="index file")
    parser.add_argument("--expect", help="the single-process node counts (.npy)")
    parser.add_argument("--processes", type=int, default=2)
    parser.add_argument("--index-parallel", dest="x", type=int, default=1,
                        help="index shards on each process's device (default 1)")
    parser.add_argument("-k", type=int, default=31)
    parser.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                        help="cuda: process r on cuda:r over NCCL; cpu: gloo")
    parser.add_argument("--worker", dest="rank", type=int, default=None,
                        help=argparse.SUPPRESS)
    parser.add_argument("--port", type=int, help=argparse.SUPPRESS)
    parser.add_argument("--out", help=argparse.SUPPRESS)
    a = parser.parse_args(argv)
    if a.rank is not None:
        worker(a)
        return None
    if a.expect is None:
        parser.error("--expect is required")
    result = run(a.index, a.reads, np.load(a.expect), processes=a.processes,
                 index_parallel=a.x, device=a.device, k=a.k)
    print(f"RESULT processes={a.processes} device={a.device} index_parallel={a.x} "
          f"wall_s={result['wall_s']} equal=1", flush=True)
    return result


if __name__ == "__main__":
    main()
