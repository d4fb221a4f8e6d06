"""No module of the benchmark imports JAX or the JAX package, the
reference imports nothing of the port, and a run refuses without a card,
without the port, or with JAX loaded."""
from __future__ import annotations

import ast
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from portbench import run
from portbench.spec import CHECKOUT

HOME = CHECKOUT / "portbench"
FORBIDDEN = {"jax", "jaxlib", "flax", "kmer_mapper_tpu"}
MODULES = sorted(p for p in HOME.rglob("*.py") if "__pycache__" not in p.parts)


def imported(path: Path) -> set[str]:
    """Every module a file imports, by its full dotted name; a relative
    import as ``portbench.<name>``."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            if node.level:
                base = ".".join(path.relative_to(CHECKOUT).with_suffix("").parts[:-node.level])
                module = f"{base}.{node.module}" if node.module else base
                names.update(f"{module}.{a.name}" for a in node.names)
                names.add(module)
            else:
                names.add(node.module)
    return names


@pytest.mark.parametrize("path", MODULES, ids=lambda p: str(p.relative_to(HOME)))
def test_no_module_imports_jax_or_the_jax_package(path):
    tops = {name.split(".")[0] for name in imported(path)}
    assert not tops & FORBIDDEN


def test_the_reference_imports_nothing_of_the_port():
    """reference.py and what it imports of the benchmark, followed through."""
    todo, seen = ["portbench.reference"], set()
    while todo:
        module = todo.pop()
        if module in seen:
            continue
        seen.add(module)
        path = CHECKOUT / Path(*module.split(".")).with_suffix(".py")
        if not path.exists():
            continue
        for name in imported(path):
            assert name.split(".")[0] != "kmer_mapper_tpu_torch", (module, name)
            if name.startswith("portbench."):
                todo.append(name)
    assert "portbench.genome" in seen


def test_forbidden_modules_compare_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "kmer_mapper_tpu_torch", sys.modules["portbench"])
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "kmer_mapper_tpu.oracle", sys.modules["portbench"])
    assert run.forbidden_modules() == ["kmer_mapper_tpu"]


def _run(cwd, env=None):
    return subprocess.run([sys.executable, "-m", "portbench.run", "--workload",
                           "human.fixed151", "--seed", "3", "--seconds", "1", "--trace", "0"],
                          cwd=cwd, capture_output=True, text=True, timeout=300,
                          env=dict(os.environ, **(env or {})))


def test_a_run_without_a_card_exits_non_zero_and_prints_no_result():
    proc = _run(CHECKOUT, {"CUDA_VISIBLE_DEVICES": ""})
    assert proc.returncode != 0 and proc.stdout.strip() == ""


def test_a_run_with_only_the_benchmarks_files_exits_non_zero(tmp_path):
    shutil.copytree(HOME, tmp_path / "portbench", ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(CHECKOUT / "BENCHMARK.json", tmp_path)
    proc = _run(tmp_path, {"PYTHONPATH": ""})
    assert proc.returncode != 0 and proc.stdout.strip() == ""
