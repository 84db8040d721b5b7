"""Build and load the port's CUDA kernels.

``nvcc`` compiles each ``csrc/*.cu`` to an object, all sources at once in
parallel processes, and links them into one shared library with a plain C
interface, loaded with ``ctypes`` (seconds to build; no PyTorch headers).
The library lands in ``seqalign_tpu_torch/_build/`` under a name keyed by a
hash of every file of ``csrc/`` (the headers ``fill_common.cuh``,
``tile_fill.cuh``, ``tile_carry.cuh``, ``slab.cuh`` and ``walk_band.cuh``
too) and the flags,
is written to a temporary name first and then renamed, so a stale or
half-written library is never loaded; the
objects live in a temporary directory that is removed.  The build runs at
first use; a failed build raises with nvcc's output.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC")

_P = ctypes.c_void_p
_I = ctypes.c_int
# ac, bc, na, nb, scal, sub, im, modes, Kb, sub_n, table_smem, B, LA, LB,
# scores, corner, dirs, mout, m16, scratch, stream (csrc/fill_common.cuh)
_COMMON = (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P, _P,
           _P, _P, _I, _P, _P)
# then the schedule: order, wrap, off
_FILL = _COMMON + (_P, _P, _P)
# then bin, bout, x_off, CA, code and M pair strides, warps a block
_CARRY = _COMMON + (_P, _P, _I, _I, ctypes.c_longlong, ctypes.c_longlong,
                    _I)
# then the edge rows in and out and the slice's rounds r_lo, r_hi
_SLICE = _CARRY + (_P, _P, _I, _I)
_SIGNATURES = {
    "nw_scores_launch": _FILL,
    "nw_dirs_launch": _FILL,
    "sw_scores_launch": _FILL,
    "sw_dirs_launch": _FILL,
    "nw_dirs_gab_launch": _FILL,
    "sw_dirs_gab_launch": _FILL,
    "nw_dirs_carry_launch": _CARRY,
    "sw_dirs_carry_launch": _CARRY,
    "nw_scores_slice_launch": _SLICE,
    "sw_scores_slice_launch": _SLICE,
    "nw_dirs_slice_launch": _SLICE,
    # dirs, corner, na, nb, B, nch, Dc, LB+1, cap, ops, score, off, stream
    "nw_walk_launch": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _P, _P, _P, _P),
    # dirs, ac, bc, scal, sub, Kb, sub_n, na, nb, neg, jw, x0, y0, s0, W,
    # B, LA, LB, nch, Dc, cap, ops, stream, off
    "sw_walk_launch": (_P, _P, _P, _P, _P, _I, _I, _P, _P, _I, _P, _P, _P,
                       _P, _I, _I, _I, _I, _I, _I, _I, _P, _P, _P),
    # dirs, ac, bc, scal, sub, Kb, na, nb, neg, cand_flat, cand_score, lo,
    # hi, B, LA, LB, nch, Dc, k, MW, gmask, use_smem, hit_flat, hit_score,
    # nhits, flat64, stream, off, moff
    "sw_hits_launch": (_P, _P, _P, _P, _P, _I, _P, _P, _I, _P, _P, _P, _P,
                       _I, _I, _I, _I, _I, _I, _I, _P, _I, _P, _P, _P, _I,
                       _P, _P, _P),
    # x, o, R, L, S, op, i16, stream
    "vpu_chain_launch": (_P, _P, _I, _I, _I, _I, _I, _P),
}

_lib = None


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = os.path.join(home, "bin", "nvcc")
    found = cand if os.path.exists(cand) else shutil.which("nvcc")
    if not found:
        raise RuntimeError("nvcc not found (set CUDA_HOME)")
    return found


def build() -> Path:
    """Compile the kernels unless a library of these sources exists;
    returns its path."""
    sources = sorted(CSRC.glob("*.cu"))
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.iterdir()):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    out = BUILD_DIR / f"libseqalign_{h.hexdigest()[:16]}.so"
    if out.exists():
        return out
    nvcc = _nvcc()
    BUILD_DIR.mkdir(exist_ok=True)
    work = Path(tempfile.mkdtemp(prefix=".objs-", dir=BUILD_DIR))
    try:
        objs = [work / f"{src.stem}.o" for src in sources]
        procs = [subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
            for src, obj in zip(sources, objs)]
        logs, failed = [], []
        for src, p in zip(sources, procs):
            so, se = p.communicate()
            logs.append(f"{src.name}:\n{so}{se}")
            if p.returncode != 0:
                failed.append(f"{src.name}: code {p.returncode}")
        if failed:
            raise RuntimeError(f"nvcc failed ({', '.join(failed)}):\n"
                               + "".join(logs))
        tmp = work / out.name
        r = subprocess.run([nvcc, "-shared", "-o", str(tmp),
                            *map(str, objs)], capture_output=True, text=True)
        if r.returncode != 0:
            raise RuntimeError(f"nvcc link failed with code {r.returncode}:"
                               f"\n{r.stdout}{r.stderr}")
        os.replace(tmp, out)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return out


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, args in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = args
            fn.restype = ctypes.c_int
        lib.nw_error_string.argtypes = (ctypes.c_int,)
        lib.nw_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib
