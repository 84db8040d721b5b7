"""Native batch packer: list-of-sequences -> padded uint8 matrix (+ lens),
with the scoring fold LUT optionally applied in the same pass.

Host packing is the per-host serial cost that bounds how many chips one
host can feed (SCALING.json extrapolation; the reference streams pairs
serially from one thread, the reference's src/alignment_cmdline.c:611-622 —
batched packing replaces that loop).  The native path (_seqpack C
extension, built on first use into ``_build/``) does one translate-copy
per row with the GIL released and row-ranges threaded; the numpy fallback
reproduces the exact same output.
"""

from __future__ import annotations

import importlib.util
import os
import subprocess
import sysconfig
from typing import Optional, Sequence

import numpy as np

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SRC = os.path.join(_PKG, "native", "seqpack.cpp")
_BUILD_DIR = os.path.join(_PKG, "_build")
_SO = os.path.join(_BUILD_DIR, "_seqpack.so")

_mod = None
_mod_tried = False


def _build() -> bool:
    """Compile the extension into ``_build/`` under a temporary name and
    rename it, so a half-written library is never loaded."""
    cxx = os.environ.get("CXX", "g++")
    inc = sysconfig.get_paths()["include"]
    tmp = f"{_SO}.{os.getpid()}.tmp"
    cmd = [cxx, "-O3", "-shared", "-fPIC", "-std=c++17", f"-I{inc}",
           _SRC, "-o", tmp]
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


def get_mod():
    """Load (building if needed) the _seqpack extension, or None."""
    global _mod, _mod_tried
    if _mod_tried:
        return _mod
    _mod_tried = True
    if os.environ.get("SEQALIGN_NATIVE_PACK") == "0":
        return None
    if not os.path.exists(_SO) or (
        os.path.exists(_SRC)
        and os.path.getmtime(_SRC) > os.path.getmtime(_SO)
    ):
        if not _build():
            return None
    try:
        spec = importlib.util.spec_from_file_location("_seqpack", _SO)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
    except (ImportError, OSError):
        return None
    _mod = mod
    return _mod


def available() -> bool:
    return get_mod() is not None


def _pack_numpy(seqs: Sequence, L: int, fold: Optional[np.ndarray]):
    """Reference numpy implementation (also the fallback): one blob join +
    masked scatter (+ fold gather)."""
    n = len(seqs)
    if isinstance(seqs[0], str):
        blob = "".join(seqs).encode("latin-1")
    elif isinstance(seqs[0], (bytes, bytearray)):
        blob = b"".join(bytes(s) for s in seqs)
    else:  # arbitrary containers: caller handles via ops.dp.encode
        raise TypeError("unsupported sequence container")
    lens = np.fromiter((len(s) for s in seqs), np.int32, count=n)
    out = np.zeros((n, L), dtype=np.uint8)
    mask = np.arange(L, dtype=np.int32)[None, :] < lens[:, None]
    out[mask] = np.frombuffer(blob, np.uint8)
    if fold is not None:
        out = fold[out]
    return out, lens


def pack(seqs: Sequence, L: int, fold: Optional[np.ndarray] = None):
    """Pack ``seqs`` (str/bytes/bytearray) into a zero-padded (B, L) uint8
    matrix plus int32 lengths; every byte runs through ``fold`` (a 256-entry
    uint8 LUT) when given.  Native when available, numpy otherwise —
    bit-identical either way (tests/test_packer.py)."""
    n = len(seqs)
    if n == 0:
        return np.zeros((0, max(1, L)), np.uint8), np.zeros(0, np.int32)
    mod = get_mod()
    if mod is not None and isinstance(seqs, list) and isinstance(
            seqs[0], (str, bytes, bytearray)):
        out = np.empty((n, L), np.uint8)
        lens = np.empty(n, np.int32)
        if fold is not None:
            fold = np.ascontiguousarray(fold, np.uint8)
        try:
            mod.pack_into(
                seqs, out.ctypes.data, L,
                0 if fold is None else fold.ctypes.data, lens.ctypes.data)
            return out, lens
        except ValueError:
            pass  # non-latin-1 / mixed types: numpy path below
    return _pack_numpy(seqs, L, fold)


def seq_lens(seqs) -> np.ndarray:
    """int32 lengths of a sequence list (native list walk when available,
    ~10ns/element vs fromiter's ~80ns)."""
    n = len(seqs)
    mod = get_mod()
    if (mod is not None and isinstance(seqs, list) and n
            and isinstance(seqs[0], (str, bytes, bytearray))):
        lens = np.empty(n, np.int32)
        try:
            mod.lens_into(seqs, lens.ctypes.data)
            return lens
        except ValueError:
            pass
    return np.fromiter((len(s) for s in seqs), np.int32, count=n)


def fold_bytes(arr: np.ndarray, fold: np.ndarray) -> np.ndarray:
    """Translate a uint8 array through a 256-entry LUT (native when
    available; equals ``fold[arr]``)."""
    mod = get_mod()
    if mod is None or not arr.flags["C_CONTIGUOUS"] or arr.dtype != np.uint8:
        return fold[arr]
    fold = np.ascontiguousarray(fold, np.uint8)
    out = np.empty_like(arr)
    mod.fold_into(arr.ctypes.data, out.ctypes.data, arr.size,
                  fold.ctypes.data)
    return out
