"""Build and load the port's CUDA kernels (``csrc/*.cu``) at first use.

``nvcc`` compiles each source into an object, all at once in parallel,
and links them into one shared library with a plain C interface under
``_build/``, named by a hash of the sources, headers and flags, so an edited
source rebuilds and an unchanged one loads at once. The library is bound
with ``ctypes``. Importing this module needs neither nvcc nor a
GPU; :func:`library` does.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

_PKG = Path(__file__).resolve().parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "--ptxas-options=-v",
)


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (shutil.which("nvcc"), os.path.join(cuda_home, "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME/bin): the CUDA kernels are built "
        "from kmer_mapper_tpu_torch/csrc with the CUDA toolkit"
    )


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def library_path() -> Path:
    """Path of the built library for the current sources, headers and flags."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cu*")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libkmt_kernels-{h.hexdigest()[:16]}.so"


def _run(cmd: list[str], label: str) -> str:
    """Runs one nvcc; returns its report, headed by its label and seconds."""
    t = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(
            f"nvcc failed with code {proc.returncode}:\n{' '.join(cmd)}\n"
            f"{proc.stdout}{proc.stderr}"
        )
    return f"nvcc {label}: {time.perf_counter() - t:.2f} s\n{proc.stdout}{proc.stderr}"


def build() -> Path:
    """Compile the sources unless this exact build exists; returns its path.
    One nvcc per source, all started together, then one link. The
    compiler's report (each nvcc's seconds, registers and shared memory per
    kernel) is kept beside the library as ``.log``."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(exist_ok=True)
    tag = f"{out.stem}.{os.getpid()}"
    nvcc = _nvcc()
    compiles = [[nvcc, *NVCC_FLAGS, "-c", "-o", str(BUILD_DIR / f"{src.stem}.{tag}.o"),
                 str(src)] for src in _sources()]
    with ThreadPoolExecutor(len(compiles)) as pool:
        logs = list(pool.map(_run, compiles, [src.name for src in _sources()]))
    objects = [cmd[cmd.index("-o") + 1] for cmd in compiles]
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    try:
        logs.append(_run([nvcc, "-shared", "-o", str(tmp), *objects], "link"))
    finally:
        for obj in objects:
            Path(obj).unlink(missing_ok=True)
    out.with_suffix(".log").write_text("".join(logs))
    os.replace(tmp, out)  # atomic: concurrent builders never load a partial file
    return out


def build_log() -> str:
    """The compiler's report of the current build ("" if none was made here)."""
    log = library_path().with_suffix(".log")
    return log.read_text() if log.exists() else ""


@functools.cache
def library() -> ctypes.CDLL:
    """The loaded kernel library, built first if needed."""
    lib = ctypes.CDLL(str(build()))
    lib.stream_count_launch.argtypes = (
        [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    )
    lib.stream_count_launch.restype = ctypes.c_int
    lib.gather_probe_launch.argtypes = (
        [ctypes.c_void_p] * 7 + [ctypes.c_longlong] + [ctypes.c_int] * 3
        + [ctypes.c_uint] + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    )
    lib.gather_probe_launch.restype = ctypes.c_int
    lib.node_counts_launch.argtypes = (
        [ctypes.c_void_p] * 4 + [ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
                                 ctypes.c_void_p]
    )
    lib.node_counts_launch.restype = ctypes.c_int
    lib.plane_hash_keys_launch.argtypes = (
        [ctypes.c_void_p] * 2 + [ctypes.c_int] * 4
        + [ctypes.c_uint, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    )
    # lengths, n_rows, starts, offs, count, slots, n_bases, k, revcomp, device,
    # stream (one cooperative launch)
    lib.ragged_offsets_launch.argtypes = [
        ctypes.c_void_p, ctypes.c_int, *[ctypes.c_void_p] * 4, ctypes.c_longlong,
        *[ctypes.c_int] * 3, ctypes.c_void_p,
    ]
    lib.ragged_offsets_grid.argtypes = [ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
    lib.ragged_hash_keys_launch.argtypes = [
        ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_uint, ctypes.c_int,
        ctypes.c_int, ctypes.c_void_p,
    ]
    # the partition's launches take the keys' count in device memory
    lib.partition_histogram_launch.argtypes = [
        ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p,
        *[ctypes.c_int] * 5, ctypes.c_void_p,
    ]
    lib.radix_slabs.argtypes = [ctypes.c_int]
    lib.radix_scatter_launch.argtypes = [
        ctypes.c_void_p, ctypes.c_longlong, *[ctypes.c_void_p] * 4,
        *[ctypes.c_int] * 5, ctypes.c_void_p,
    ]
    lib.radix_offsets_launch.argtypes = [
        ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_int, ctypes.c_void_p,
    ]
    lib.partition_scan_launch.argtypes = (
        [ctypes.c_void_p] * 2 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    )
    for fn in (lib.plane_hash_keys_launch, lib.ragged_offsets_launch,
               lib.ragged_offsets_grid, lib.ragged_hash_keys_launch,
               lib.partition_histogram_launch, lib.partition_scan_launch, lib.radix_slabs,
               lib.radix_scatter_launch, lib.radix_offsets_launch):
        fn.restype = ctypes.c_int
    # the dissection kernels of kmer_mapper_tpu_torch/scripts; each takes its
    # variant as an int
    lib.r2_kernel_dissect_launch.argtypes = (
        [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    )
    lib.r2_window_dissect_launch.argtypes = (
        [ctypes.c_void_p] * 7 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
    )
    lib.r2_window_ranges_launch.argtypes = (
        [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    )
    lib.r3_iter_floor_launch.argtypes = (
        [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    )
    lib.r9_dot_orient_launch.argtypes = (
        [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    )
    lib.r9_step_parts_launch.argtypes = (
        [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    )
    lib.r9_block_pipeline_launch.argtypes = (
        [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    )
    lib.finalize_dissect_launch.argtypes = (
        [ctypes.c_int] + [ctypes.c_void_p] * 5
        + [ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
           ctypes.c_void_p]
    )
    lib.gather_probe_dissect_launch.argtypes = (
        [ctypes.c_void_p] * 7 + [ctypes.c_longlong] + [ctypes.c_int] * 3
        + [ctypes.c_uint] + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    )
    # the partition's cursor route (partition_dissect.cu) takes none
    lib.block_histogram_launch.argtypes = [
        ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_void_p,
    ]
    lib.block_scatter_launch.argtypes = [
        ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_int, ctypes.c_void_p,
    ]
    for fn in (lib.r2_kernel_dissect_launch, lib.r2_window_dissect_launch,
               lib.r2_window_ranges_launch, lib.r3_iter_floor_launch, lib.r9_dot_orient_launch,
               lib.r9_step_parts_launch, lib.r9_block_pipeline_launch,
               lib.gather_probe_dissect_launch, lib.finalize_dissect_launch,
               lib.block_histogram_launch,
               lib.block_scatter_launch):
        fn.restype = ctypes.c_int
    lib.kmt_error_string.argtypes = [ctypes.c_int]
    lib.kmt_error_string.restype = ctypes.c_char_p
    return lib


def error_string(code: int) -> str:
    return library().kmt_error_string(code).decode()
