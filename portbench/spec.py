"""Finds what ``BENCHMARK.json`` names: a cell, its configuration and
traffic files, the readers of its metrics and the kernel names of a layer.
Each is a file of its own, found by its name, so that a configuration, a
traffic mix, a metric or a layer's kernel is added by adding files.

    portbench/configs/<config>.json     (the path BENCHMARK.json gives)
    portbench/traffic/<traffic>.json
    portbench/metrics/<metric>.py       read(record) -> number or None
    portbench/kernels/<group>/*.json    {"match": "<part of a kernel name>"}
"""
from __future__ import annotations

import importlib.util
import json
from pathlib import Path

#: the checkout: the directory that holds BENCHMARK.json and portbench/
CHECKOUT = Path(__file__).resolve().parent.parent


class Spec:
    def __init__(self, root: Path | str = CHECKOUT):
        self.root = Path(root)
        self.home = self.root / "portbench"
        with open(self.root / "BENCHMARK.json") as f:
            self.bench = json.load(f)

    def cell(self, name: str) -> dict:
        for cell in self.bench["workloads"]:
            if cell["name"] == name:
                return cell
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, name: str) -> dict:
        for config in self.bench["configs"]:
            if config["name"] == name:
                with open(self.root / config["file"]) as f:
                    return json.load(f)
        raise KeyError(f"no configuration {name!r} in BENCHMARK.json")

    def traffic(self, name: str) -> dict:
        with open(self.home / "traffic" / f"{name}.json") as f:
            return json.load(f)

    def end_to_end(self, cell: str) -> list[dict]:
        """The end-to-end metrics the cell reports."""
        return [m for m in self.bench["end_to_end"] if cell in m.get("workloads", [cell])]

    def per_layer(self, cell: str) -> list[dict]:
        """The per-layer metrics the cell reports in a traced run: those
        that list it, and those that list no cells and move an end-to-end
        metric of it."""
        moved = {m["name"] for m in self.end_to_end(cell)}
        return [m for m in self.bench["per_layer"]
                if cell in m.get("workloads", ()) or
                ("workloads" not in m and m["moves"] in moved)]

    def reader(self, metric: str):
        """The module ``metrics/<metric>.py``; its ``read(record)`` gives
        the metric's value, or None where it found nothing to read."""
        path = self.home / "metrics" / f"{metric}.py"
        spec = importlib.util.spec_from_file_location(f"portbench_metric_{metric}", path)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        return module

    def kernels(self, group: str) -> list[str]:
        """The name patterns of the device operations of a layer's group:
        one file a kernel under ``kernels/<group>/``."""
        out = []
        for path in sorted((self.home / "kernels" / group).glob("*.json")):
            with open(path) as f:
                out.append(json.load(f)["match"])
        if not out:
            raise KeyError(f"no kernels listed under kernels/{group}/")
        return out

    def kernel_files(self) -> dict[str, dict[str, str]]:
        """{group: {file's stem: its pattern}} of every group."""
        out: dict[str, dict[str, str]] = {}
        for path in sorted((self.home / "kernels").glob("*/*.json")):
            with open(path) as f:
                out.setdefault(path.parent.name, {})[path.stem] = json.load(f)["match"]
        return out
