"""ctypes bindings of the native host loader (``native/kmer_host.cpp``).

The torch counterpart of ``kmer_mapper_tpu/io/native.py``. One pass of C++
frames FASTA/FASTQ records and packs them 2-bit into the device buffer, in
the continuous or the stride-padded layout, bit-identical to the numpy
framer and packer of ``io/readers.py`` (tests hold them equal).

The library is built at first use with ``g++ -O3 -march=native`` into
``kmer_mapper_tpu_torch/_build/``, named by a hash of the source and flags
and by the host's CPU model, so a library built on one host never loads on
another. It is bound with ``ctypes.CDLL``, which releases the interpreter
lock during each call: parallel framing workers (``io/parallel_reader.py``)
scale across cores. Where the build fails, a WARNING names the compiler's
error and the numpy framer takes over. ``KMT_NO_NATIVE=1`` forces the numpy
framer.
"""
from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import platform
import subprocess
import threading
from pathlib import Path
from typing import Iterator

import numpy as np

from ..ops.hashing import read_stride
from .readers import strided_rows

logger = logging.getLogger(__name__)

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG / "native" / "kmer_host.cpp"
BUILD_DIR = _PKG / "_build"
CXX_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC")

#: buffers the native loader emitted (read by chip_smoke.py to show that a
#: run framed through it); updated under ``_lock``
frame_counts = {"buffers": 0}

_lock = threading.Lock()
_lib = None
_tried = False

_ERRORS = {
    1: "FASTA input does not start with a record header",
    2: "malformed FASTQ: record header does not start with '@'",
    3: "malformed FASTQ: separator line does not start with '+'",
    4: "truncated FASTQ record at end of file",
    5: "trailing unframed data at end of file",
}


class _Out(ctypes.Structure):
    _fields_ = [
        ("consumed", ctypes.c_int64),
        ("n_bases", ctypes.c_int64),
        ("n_reads", ctypes.c_int64),
        ("n_invalid", ctypes.c_int64),
        ("next_resume", ctypes.c_int64),
        ("error", ctypes.c_int32),
        ("stopped_capacity", ctypes.c_int32),
        ("strided", ctypes.c_int32),
    ]


def _cpu_tag() -> str:
    """The platform and a hash of the CPU model: ``-march=native`` code is
    specific to the microarchitecture it was built on."""
    tag = f"{platform.system()}-{platform.machine()}".lower()
    try:
        info = Path("/proc/cpuinfo").read_text()
    except OSError:
        return tag
    model = next(
        (line.split(":", 1)[1].strip() for line in info.splitlines() if "model name" in line),
        "",
    )
    return tag + "-" + hashlib.sha1(model.encode()).hexdigest()[:8] if model else tag


def library_path() -> Path:
    """Path of the library for the current source, flags and CPU model."""
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_DIR / f"kmer_host-{h.hexdigest()[:16]}-{_cpu_tag()}.so"


def _build(out: Path) -> bool:
    """Compile into a temporary file and rename it into place (concurrent
    builds never load a partial library). False where the build fails."""
    BUILD_DIR.mkdir(exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = ["g++", *CXX_FLAGS, str(SOURCE), "-o", str(tmp)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    except (OSError, subprocess.TimeoutExpired) as exc:
        error = str(exc)
    else:
        if proc.returncode == 0:
            os.replace(tmp, out)
            return True
        error = f"exit code {proc.returncode}: {proc.stderr.strip()}"
    tmp.unlink(missing_ok=True)
    logger.warning(
        "native loader build failed (%s): %s; the numpy framer of io/readers.py "
        "frames and packs instead", " ".join(cmd), error,
    )
    return False


def get_lib():
    """The loaded library, or None where it is disabled or cannot be built."""
    global _lib, _tried
    if os.environ.get("KMT_NO_NATIVE"):
        return None
    with _lock:
        if _tried:
            return _lib
        _tried = True
        path = library_path()
        if not path.exists() and not _build(path):
            return None
        try:
            lib = ctypes.CDLL(str(path))
        except OSError as exc:
            logger.warning("native loader %s does not load (%s); the numpy framer "
                           "of io/readers.py frames and packs instead", path, exc)
            return None
        for fn in (lib.kmh_pack_fastq, lib.kmh_pack_fasta):
            fn.restype = None
            fn.argtypes = [
                ctypes.POINTER(ctypes.c_char), ctypes.c_int64, ctypes.c_int32,
                ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
                ctypes.c_int64,
                ctypes.POINTER(ctypes.c_uint32), ctypes.POINTER(ctypes.c_uint16),
                ctypes.POINTER(_Out),
            ]
        lib.kmh_restride.restype = None
        lib.kmh_restride.argtypes = [
            ctypes.POINTER(ctypes.c_uint32), ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int64, ctypes.POINTER(ctypes.c_uint32),
        ]
        _lib = lib
        return _lib


def available() -> bool:
    return get_lib() is not None


def restride_native(
    packed: np.ndarray, n_reads: int, read_len: int, rows: int
) -> np.ndarray | None:
    """C++ ``kmh_restride`` (continuous -> strided layout), or None where the
    library is unavailable. Bit-identical to ``readers.restride_packed``."""
    lib = get_lib()
    if lib is None:
        return None
    npr = read_stride(read_len) // 16
    packed = np.ascontiguousarray(packed, dtype=np.uint32)
    n_reads = int(n_reads)
    # the C++ pass reads one word past each read's last word
    if n_reads > rows or (n_reads and (2 * read_len * (n_reads - 1)) // 32 + npr
                          >= packed.shape[0]):
        raise ValueError("restride_native: packed buffer too short for the reads")
    out = np.empty(rows * npr, dtype=np.uint32)
    lib.kmh_restride(
        packed.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
        int(n_reads), int(read_len), int(rows),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
    )
    return out


def pack_stream_native(
    stream,
    fmt: str,
    max_bases: int,
    max_reads: int,
    k: int,
    block_bytes: int = 2_500_000,
    read_len: int = 0,
) -> Iterator[tuple]:
    """The native counterpart of ``readers.read_chunks`` +
    ``readers.pack_for_device``: a stream of decompressed bytes -> packed
    device buffers (packed uint32[max_bases/16+2], lengths
    uint16[max_reads], n_bases, n_reads, n_invalid). Closes ``stream``.

    ``read_len > 0`` mirrors ``pack_for_device(read_len=...)``: buffers whose
    reads are all exactly ``read_len`` long come out in the stride-padded
    layout straight from the C++ pass, others continuous; a sixth element
    carries the ``strided`` flag."""
    lib = get_lib()
    if lib is None:
        raise RuntimeError("the native loader is unavailable (see the log)")
    fn = lib.kmh_pack_fastq if fmt == "fastq" else lib.kmh_pack_fasta
    if read_len and not (k <= read_len <= min(65535, max_bases)):
        read_len = 0  # the strided layout is impossible: every record would abort
    try:
        yield from _pack_stream(stream, fn, max_bases, max_reads, k, block_bytes, read_len)
    finally:
        stream.close()


def _pack_stream(stream, fn, max_bases, max_reads, k, block_bytes, read_len):
    # A buffer is emitted only at a capacity stop (or at eof), so chunk
    # boundaries are the numpy packer's greedy ones. Until then the byte
    # window grows and is framed again from its start.
    #
    # The window is a numpy byte array, grown only when a record needs more
    # room: blocks land in it through readinto (the file read runs without
    # the interpreter lock), the native call takes a pointer into it, and
    # after each buffer the unconsumed tail moves to its front by a numpy
    # copy (also without the lock). Appending blocks to a bytearray and
    # deleting its head held the lock for over half of a framing worker's
    # time, so -t workers barely scaled.
    target = max(block_bytes, 3 * max_bases)
    out_words = max_bases // 16 + 2
    strided_words = (
        strided_rows(max_bases, read_len) * (read_stride(read_len) // 16) if read_len else 0
    )
    window = np.empty(target + block_bytes, dtype=np.uint8)
    end = 0  # bytes of the window that hold input
    eof = False
    resume = 0
    into = True  # the stream takes readinto

    def read_block():
        nonlocal window, end, eof, into
        if end + block_bytes > len(window):
            grown = np.empty(max(2 * len(window), end + block_bytes), dtype=np.uint8)
            grown[:end] = window[:end]
            window = grown
        n = None
        if into:
            try:
                n = stream.readinto(memoryview(window)[end : end + block_bytes])
            except NotImplementedError:  # a RawIOBase that only reads
                into = False
        if n is None:
            block = stream.read(block_bytes)
            n = len(block)
            window[end : end + n] = np.frombuffer(block, dtype=np.uint8)
        end += n
        eof = n == 0

    def call(rl: int):
        packed = np.zeros(strided_words if rl else out_words, dtype=np.uint32)
        lengths = np.zeros(max_reads, dtype=np.uint16)
        out = _Out()
        fn(
            window.ctypes.data_as(ctypes.POINTER(ctypes.c_char)), end, 1 if eof else 0, k,
            rl, resume, max_bases, max_reads,
            packed.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
            lengths.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)),
            ctypes.byref(out),
        )
        return packed, lengths, out

    while True:
        while not eof and end < target:
            read_block()
        # strided first: a nonconforming record makes the C++ pass return
        # strided=0 with nothing consumed, and the same window is framed
        # again continuously, at the numpy packer's greedy boundaries
        rl = read_len if resume == 0 else 0
        packed, lengths, out = call(rl)
        if rl and not out.strided:
            packed, lengths, out = call(0)
        if out.error:
            raise ValueError(_ERRORS.get(out.error, f"native framer error {out.error}"))
        if not out.stopped_capacity and not eof:
            # the buffer is not full and more input may follow: grow the
            # window and frame it again (at stream end once more with eof=1)
            read_block()
            continue
        if out.n_reads:
            with _lock:
                frame_counts["buffers"] += 1
            tup = (packed, lengths, int(out.n_bases), int(out.n_reads), int(out.n_invalid))
            yield tup + ((bool(out.strided),) if read_len else ())
        consumed = int(out.consumed)
        window[: end - consumed] = window[consumed:end]
        end -= consumed
        resume = int(out.next_resume)
        if eof:
            if window[:end].tobytes().strip():
                if out.n_reads or consumed:
                    continue  # more records remain in the window
                raise ValueError("trailing unframed data at end of file")
            return
        if resume and not out.n_reads and not consumed:
            raise RuntimeError("native framer made no progress")
