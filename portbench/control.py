"""The control of the comparison that decides ``correct``: the reference
computed with 32-bit keys in place of the 62-bit k-mer hashes (the
precision below the one the configuration states) is put in the program's
place, on a cell's own pool at its own size, and judged as a run is
judged. It has to come out not correct. The benchmark's runs never run it.

    python3 -m portbench.control --workload <cell> --seeds <n> [<n> ...]

One JSON line a seed: the numbers compared, their limits, ``correct``.
"""
from __future__ import annotations

import argparse
import json
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from kmer_mapper_tpu_torch.index.kmer_index import load_index

from . import genome, harness, reference
from .genome import M32
from .spec import Spec


def control(spec: Spec, cell: dict, seed: int, device, chunk_size: int = harness.CHUNK_SIZE,
            cache: Path = harness.CACHE) -> dict:
    """The control's checks on the pool a run of ``cell`` with ``seed`` maps
    (each buffer once)."""
    device = torch.device(device)
    config, traffic = spec.config(cell["config"]), spec.traffic(cell["traffic"])
    path = harness.index_file(config, cache)
    if not path.exists():
        harness.build_index(config, path, device)
    n_buckets = load_index(str(path)).table.n_buckets
    with tempfile.TemporaryDirectory() as tmp:
        made = harness.mapper_config(config, traffic, n_buckets, device, chunk_size, Path(tmp))
    pool = harness.make_pool(config, traffic, made, seed, device)
    g = genome.Genome(config["genome_length"], config["seed"])
    entries = genome.index_entries(config, device)
    full = reference.NodeCountReference(entries, config["max_frequency"])
    low = reference.NodeCountReference(entries, config["max_frequency"], key=reference.key32)
    for buf in pool:
        hashes = reference.buffer_hashes(g, buf, config["k"], device,
                                         revcomp=traffic["revcomp"])
        full.add(hashes)
        low.add(hashes)
    got = (low.node_counts() & M32).cpu().numpy().astype(np.uint32)
    return reference.judge(got, low.windows, full.node_counts(), full.windows)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", type=int, nargs="+", required=True)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    spec = Spec()
    cell = spec.cell(args.workload)
    for seed in args.seeds:
        t = time.perf_counter()
        checks = control(spec, cell, seed, args.device)
        print(json.dumps({"workload": args.workload, "seed": seed, "checks": checks,
                          "correct": reference.is_correct(checks),
                          "seconds": time.perf_counter() - t}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
