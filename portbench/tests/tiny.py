"""Tiny cells for the CPU tests: the real configurations and traffic with
the genome, the index and the pool cut down, run on the CPU (the port runs
its plain twins there) with buffers of 64 Ki bases."""
from __future__ import annotations

import time
from pathlib import Path

from portbench import harness
from portbench.spec import Spec

#: the CPU's buffer: pipeline.buffer_bases keeps chunk_size within its floor
CHUNK = 1 << 16
SIZES = {"genome_length": 300_000, "n_kmers": 12_000, "n_nodes": 3_000}


class TinySpec(Spec):
    """The repo's spec with every configuration cut to ``sizes`` and every
    pool to ``buffers`` buffers."""

    def __init__(self, root=None, sizes=None, buffers: int = 3):
        super().__init__(*(() if root is None else (root,)))
        self.sizes = dict(SIZES if sizes is None else sizes)
        self.buffers = buffers

    def config(self, name):
        config = super().config(name)
        config.update(self.sizes)
        config["name"] = f"{name}_tiny"
        return config

    def traffic(self, name):
        traffic = dict(TWINS[name]) if name in TWINS else super().traffic(name)
        traffic["pool_min_bytes"] = self.buffers * CHUNK // 4
        return traffic


#: reads of several lengths, for the tests of the continuous layout and the
#: ragged step (no cell sends such traffic yet: no length histogram of
#: trimmed reads has been taken from a public source)
RAGGED = {"what": "reads of 100-151 bp, each length equally often", "read_length_min": 100,
          "read_length_max": 151, "revcomp": False}
#: the ragged twin of ``both151r``: reads from both strands, mapped with -r
RAGGED_BOTH_R = dict(RAGGED, revcomp=True)
#: the tests' traffic mixes that no cell sends, by name
TWINS = {"ragged": RAGGED, "ragged_both_r": RAGGED_BOTH_R}


def cell(config: str, traffic: str) -> dict:
    return {"name": f"{config}.{traffic}", "config": config, "traffic": traffic, "chips": 1}


def run(spec: Spec, the_cell: dict, cache: Path, seed: int = 2**31 + 11, trace: bool = False,
        seconds: float = 0.2) -> dict:
    return harness.run(spec, the_cell, seed, seconds, trace, "cpu", t_start=time.perf_counter(),
                       chunk_size=CHUNK, cache=cache)
