"""ctypes binding for the native (C++) sequence reader, with transparent
build-on-first-use and graceful fallback to the pure-Python reader.

The native path reads records in blocks (one ctypes round trip per block),
which is the batch-engine-friendly shape: packed bytes + offsets feed
``ops.pack.pad_batch`` without per-record Python overhead.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys
from typing import Iterator, Optional, Tuple

import numpy as np

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SRC = os.path.join(_PKG, "native", "seqio.cpp")
_BUILD_DIR = os.path.join(_PKG, "_build")
_SO = os.path.join(_BUILD_DIR, "libseqio.so")

_lib = None
_lib_tried = False


def _build() -> bool:
    """Compile the library into ``_build/`` under a temporary name and
    rename it, so a half-written library is never loaded."""
    cxx = os.environ.get("CXX", "g++")
    tmp = f"{_SO}.{os.getpid()}.tmp"
    cmd = [cxx, "-O2", "-shared", "-fPIC", "-std=c++17", _SRC, "-o", tmp,
           "-lz"]
    try:
        os.makedirs(_BUILD_DIR, exist_ok=True)
        r = subprocess.run(cmd, capture_output=True, timeout=120)
        if r.returncode != 0:
            return False
        os.replace(tmp, _SO)
        return True
    except (OSError, subprocess.TimeoutExpired):
        return False
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def get_lib():
    """Load (building if needed) the native library, or None."""
    global _lib, _lib_tried
    if _lib_tried:
        return _lib
    _lib_tried = True
    if not os.path.exists(_SO) or (
        os.path.exists(_SRC)
        and os.path.getmtime(_SRC) > os.path.getmtime(_SO)
    ):
        if not _build():
            return None
    try:
        lib = ctypes.CDLL(_SO)
    except OSError:
        return None
    lib.seqio_open.restype = ctypes.c_void_p
    lib.seqio_open.argtypes = [ctypes.c_char_p]
    lib.seqio_close.argtypes = [ctypes.c_void_p]
    lib.seqio_read_block.restype = ctypes.c_int64
    lib.seqio_read_block.argtypes = [ctypes.c_void_p, ctypes.c_int64]
    for fn, ty in (
        ("seqio_seq_bytes", ctypes.POINTER(ctypes.c_char)),
        ("seqio_name_bytes", ctypes.POINTER(ctypes.c_char)),
        ("seqio_seq_offsets", ctypes.POINTER(ctypes.c_int64)),
        ("seqio_name_offsets", ctypes.POINTER(ctypes.c_int64)),
        ("seqio_has_name", ctypes.POINTER(ctypes.c_int8)),
    ):
        getattr(lib, fn).restype = ty
        getattr(lib, fn).argtypes = [ctypes.c_void_p]
    _lib = lib
    return _lib


def available() -> bool:
    return get_lib() is not None


def read_blocks(path: str, block_records: int = 4096):
    """Yield (names, seqs) lists per block via the native reader.

    names[i] is None for plain-line records (no FASTA/FASTQ header).
    Raises OSError if the file can't be opened; raises RuntimeError if the
    native library is unavailable (callers should check ``available()``).
    """
    lib = get_lib()
    if lib is None:
        raise RuntimeError("native seqio unavailable")
    h = lib.seqio_open(path.encode())
    if not h:
        raise OSError(f"couldn't open {path}")
    try:
        while True:
            n = lib.seqio_read_block(h, block_records)
            if n == 0:
                return
            soff = np.ctypeslib.as_array(lib.seqio_seq_offsets(h), (n + 1,))
            noff = np.ctypeslib.as_array(lib.seqio_name_offsets(h), (n + 1,))
            has = np.ctypeslib.as_array(lib.seqio_has_name(h), (n,))
            sbytes = ctypes.string_at(lib.seqio_seq_bytes(h), int(soff[n]))
            nbytes = ctypes.string_at(lib.seqio_name_bytes(h), int(noff[n]))
            names = [
                nbytes[noff[i]:noff[i + 1]].decode("latin-1")
                if has[i] else None
                for i in range(n)
            ]
            seqs = [
                sbytes[soff[i]:soff[i + 1]].decode("latin-1")
                for i in range(n)
            ]
            yield names, seqs
    finally:
        lib.seqio_close(h)


def read_seqs_native(path: str) -> Iterator[Tuple[Optional[str], str]]:
    """Record-at-a-time view over ``read_blocks`` (drop-in for
    seqio.read_seqs on real files)."""
    for names, seqs in read_blocks(path):
        yield from zip(names, seqs)
