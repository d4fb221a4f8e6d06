"""Gzip input: parallel BGZF decode through libdeflate, else isal, else zlib.

The torch counterpart of ``kmer_mapper_tpu/io/gzio.py``.

* **BGZF** files (bgzip/htslib output, the common container of compressed
  FASTQ) are runs of independent gzip members of at most 64 KiB whose
  compressed size sits in a header field, so member boundaries are known
  without decoding. Batches of members go to a thread pool that decodes them
  with **libdeflate**, found through ctypes (the call releases the
  interpreter lock): decoding runs on several cores.
* Plain gzip, and BGZF where libdeflate is missing: ``isal.igzip`` where it
  imports (the reference's fast path, ``kmer_mapper/util.py:97-98``), else
  zlib. A single gzip stream decodes serially.

Each is a readable binary stream for the framer; :func:`decoder_name` says
which one :func:`open_gzip` picks for a file.
"""
from __future__ import annotations

import ctypes
import ctypes.util
import gzip
import io
import logging
import struct
import threading
import zlib
from concurrent.futures import ThreadPoolExecutor

logger = logging.getLogger(__name__)

BGZF_MAX_OUT = 1 << 16  # a BGZF member decodes to at most 64 KiB

_libdeflate_lock = threading.Lock()
_libdeflate = None
_libdeflate_tried = False


def _load_libdeflate():
    for name in ("libdeflate.so", "libdeflate.so.0", ctypes.util.find_library("deflate")):
        if not name:
            continue
        try:
            lib = ctypes.CDLL(name)
        except OSError:
            continue
        lib.libdeflate_alloc_decompressor.restype = ctypes.c_void_p
        lib.libdeflate_alloc_decompressor.argtypes = []
        lib.libdeflate_free_decompressor.restype = None
        lib.libdeflate_free_decompressor.argtypes = [ctypes.c_void_p]
        lib.libdeflate_gzip_decompress.restype = ctypes.c_int
        lib.libdeflate_gzip_decompress.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_size_t,
            ctypes.c_void_p, ctypes.c_size_t, ctypes.POINTER(ctypes.c_size_t),
        ]
        return lib
    return None


def libdeflate():
    """The loaded libdeflate, or None where the host has none."""
    global _libdeflate, _libdeflate_tried
    with _libdeflate_lock:
        if not _libdeflate_tried:
            _libdeflate_tried = True
            _libdeflate = _load_libdeflate()
    return _libdeflate


def bgzf_block_size(header: bytes) -> int | None:
    """Compressed size of the BGZF member that starts at ``header``, or None
    if it is not one (gzip FEXTRA subfield BC holding a u16 BSIZE)."""
    if len(header) < 18 or header[:4] != b"\x1f\x8b\x08\x04":
        return None
    xlen = struct.unpack_from("<H", header, 10)[0]
    extra = header[12 : 12 + xlen]
    pos = 0
    while pos + 4 <= len(extra):
        si1, si2, slen = extra[pos], extra[pos + 1], struct.unpack_from("<H", extra, pos + 2)[0]
        if si1 == 66 and si2 == 67 and slen == 2:
            return struct.unpack_from("<H", extra, pos + 4)[0] + 1
        pos += 4 + slen
    return None


def is_bgzf(path: str) -> bool:
    try:
        with open(path, "rb") as f:
            return bgzf_block_size(f.read(64)) is not None
    except OSError:
        return False


class _Decompressor:
    """One thread's libdeflate decompressor."""

    def __init__(self, lib):
        self.lib = lib
        self.handle = lib.libdeflate_alloc_decompressor()
        if not self.handle:
            raise MemoryError("libdeflate_alloc_decompressor failed")

    def gzip_decompress(self, block: bytes, out_size: int) -> bytes:
        out = ctypes.create_string_buffer(out_size)
        actual = ctypes.c_size_t(0)
        rc = self.lib.libdeflate_gzip_decompress(
            self.handle, block, len(block), out, out_size, ctypes.byref(actual)
        )
        if rc != 0:
            raise OSError(f"libdeflate gzip decode failed (rc={rc})")
        return out.raw[: actual.value]

    def __del__(self):
        if getattr(self, "handle", None):
            self.lib.libdeflate_free_decompressor(self.handle)


class BgzfReader(io.RawIOBase):
    """Parallel BGZF decoder: the reading thread splits the file into members
    by their BSIZE field, a pool decodes batches of them with libdeflate, and
    the decoded bytes come out in file order. A member that is not BGZF
    (plain gzip appended after the BGZF part) and everything after it decode
    serially with zlib, once every parallel batch has been delivered."""

    READ_AHEAD = 4 << 20  # compressed bytes fetched per file read
    BATCH = 64  # members decoded per pool task

    def __init__(self, path: str, n_threads: int = 4):
        lib = libdeflate()
        if lib is None:
            raise RuntimeError("BgzfReader needs libdeflate")
        self._file = open(path, "rb")
        self._pool = ThreadPoolExecutor(max_workers=n_threads)
        self._local = threading.local()
        self._lib = lib
        self._pending: list = []  # futures, in file order
        self._comp = bytearray()  # compressed bytes not yet split
        self._eof_file = False
        self._serial_tail = False  # met a non-BGZF member: finish serially
        self._buf = bytearray()
        self._max_pending = max(2, 2 * n_threads)

    def _decomp(self) -> _Decompressor:
        d = getattr(self._local, "d", None)
        if d is None:
            d = self._local.d = _Decompressor(self._lib)
        return d

    def _decode_batch(self, blocks: list[bytes]) -> bytes:
        d = self._decomp()
        return b"".join(d.gzip_decompress(b, BGZF_MAX_OUT) for b in blocks)

    def _split_and_submit(self) -> bool:
        """Carve whole members off the compressed bytes and submit them as
        one batch, with one head deletion per batch."""
        blocks = []
        pos = 0
        comp = self._comp
        while len(blocks) < self.BATCH:
            size = bgzf_block_size(bytes(comp[pos : pos + 64]))
            if size is None or len(comp) - pos < size:
                break
            blocks.append(bytes(comp[pos : pos + size]))
            pos += size
        if pos:
            del comp[:pos]
        if blocks:
            self._pending.append(self._pool.submit(self._decode_batch, blocks))
            return True
        return False

    def _fill_pipeline(self):
        while len(self._pending) < self._max_pending:
            if self._split_and_submit():
                continue
            if self._comp and bgzf_block_size(bytes(self._comp[:64])) is None:
                self._serial_tail = True  # decoded by _drain_tail, in order
                return
            if self._eof_file:
                return
            chunk = self._file.read(self.READ_AHEAD)
            if not chunk:
                self._eof_file = True
            else:
                self._comp += chunk

    def _drain_tail(self):
        """Serial zlib decode of the non-BGZF rest, member after member
        (a one-shot zlib.decompress would drop all but the first)."""
        while True:
            while not self._comp and not self._eof_file:
                chunk = self._file.read(self.READ_AHEAD)
                if chunk:
                    self._comp += chunk
                else:
                    self._eof_file = True
            if not self._comp:
                return
            d = zlib.decompressobj(wbits=31)
            while not d.eof:
                if not self._comp:
                    if self._eof_file:
                        raise OSError("truncated gzip member at end of file")
                    chunk = self._file.read(self.READ_AHEAD)
                    if chunk:
                        self._comp += chunk
                    else:
                        self._eof_file = True
                    continue
                self._buf += d.decompress(bytes(self._comp))
                self._comp.clear()
            self._comp += d.unused_data

    def read(self, n=-1):
        if n is None or n < 0:  # io contract: read() / read(-1) reads all
            out = bytearray()
            while True:
                block = self.read(1 << 24)
                if not block:
                    return bytes(out)
                out += block
        while len(self._buf) < n:
            self._fill_pipeline()
            if self._pending:
                self._buf += self._pending.pop(0).result()
                continue
            if self._serial_tail or (self._eof_file and self._comp):
                self._drain_tail()
            break
        out = bytes(self._buf[:n])
        del self._buf[:n]
        return out

    def readable(self):
        return True

    def close(self):
        try:
            self._pool.shutdown(wait=False, cancel_futures=True)
            self._file.close()
        finally:
            super().close()


def _isal_igzip():
    try:
        from isal import igzip  # type: ignore
    except ImportError:
        return None
    return igzip


def decoder_name(path: str) -> str:
    """The decoder :func:`open_gzip` picks for ``path``: "libdeflate-bgzf",
    "isal" or "zlib"."""
    if libdeflate() is not None and is_bgzf(path):
        return "libdeflate-bgzf"
    return "isal" if _isal_igzip() is not None else "zlib"


def open_gzip(path: str, n_threads: int = 4):
    """A stream of the decompressed bytes of a .gz file, through the best
    decoder the host has (see the module docstring)."""
    name = decoder_name(path)
    if name == "libdeflate-bgzf":
        logger.info("BGZF input: parallel libdeflate decode (%d threads)", n_threads)
        return BgzfReader(path, n_threads=n_threads)
    if name == "isal":
        return _isal_igzip().open(path, "rb")
    return gzip.open(path, "rb")
