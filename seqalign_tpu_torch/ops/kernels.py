"""Wrappers of the port's CUDA kernels: the fills ``nw_scores``,
``nw_fill_dirs``, ``sw_scores`` and ``sw_fill_dirs`` (equality or
substitution-table scoring, the latter when ``params.sub`` is set; the
scoring flags of ``params.modes``; each also as one launch across widths
under a :class:`FillSchedule`, ``nw_fill_dirs`` and ``sw_fill_dirs`` then
writing each pair's codes, and SW M, at its own widths), the matrix-dump
fills ``nw_fill_gab`` and ``sw_fill_gab``, the long-pair chunk fills
``nw_fill_dirs_carry`` and ``sw_fill_dirs_carry``, the walks ``nw_walk`` and
``sw_walk``, the SW hit loop ``sw_hits`` (the walks and the hit loop over a
code plane, a long pair's chunk slabs, or the planes of one launch across
widths), the ALU probe ``vpu_chain``, and the slices of the carry that
the sequence-parallel fills launch (``nw_scores_slice``,
``sw_scores_slice``, ``nw_fill_dirs_slice``: a run of a pair's rounds of
lanes, the edge rows between slices in and out).

The four fills and the matrix dump's run the register tiles of
csrc/tile_fill.cuh (a warp a strip of 32 * ``TILE_R`` lanes; the dump as
its ``GAB`` instantiations), the long pairs' chunks the same tiles from
csrc/tile_carry.cuh (a round of a pair's lanes a block,
:func:`carry_warps` warps), under any scoring flags (``params.modes``).
The walks run a
warp a walk over the band of codes it can reach, staged in shared memory
a block of rows at a time (csrc/walk_band.cuh).  The probe's moves run a
row's words in a warp's registers (:func:`vpu_layout`).

Each wrapper checks device, dtype, shape and contiguity and raises on what
its kernel does not take.  A tensor on the CPU goes to the kernel's plain
PyTorch version; a tensor on a CUDA device goes to the kernel, and a
failed build or launch raises — nothing falls back.  Kernels launch on the
current stream and neither synchronise nor allocate: outputs and scratch
come from ``torch.empty`` here (the ragged SW M from ``torch.zeros``).
Every launch adds one to its kernel's count in
:func:`kernel_launch_counts` (the port's counterpart of
``seqalign_tpu.aligners.pallas_dispatch_counts``); the table mode counts
under its kernel's name, a launch across widths (a fill under a schedule,
``sw_hits`` over its planes) under ``<kernel>[ragged]``.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional

import numpy as np
import torch

from .build import library
from .dp import (nw_fill_dirs_carry_plain, nw_fill_dirs_plain,
                 nw_fill_dirs_slice_plain, nw_fill_gab_plain,
                 nw_scores_plain, nw_scores_slice_plain,
                 sw_fill_dirs_carry_plain, sw_fill_dirs_plain,
                 sw_fill_gab_plain, sw_scores_plain, sw_scores_slice_plain)
from .pack import NEG, NMM, KernelParams, ragged_planes
from .traceback import (nw_walk_plain, slab_geometry, sw_hits_plain,
                        sw_walk_plain, walk_cap)

# dynamic shared memory a block may use on sm_90
SMEM_MAX = 227 * 1024
# What the sizing of the fills' register tiles needs of
# csrc/tile_fill.cuh (RING, LANES, THREAD_LANES there): an edge ring of
# TILE_RING entries a warp, TILE_LANES lanes of b a block covers in one
# round (a pair with more takes a round row of 3 * (LA+1) int32 in global
# scratch), TILE_R lanes a thread.
TILE_RING, TILE_LANES, TILE_R = 128, 2048, 4
# The lanes a thread of the matrix dump's fills (GAB_LANES there), a block
# of at most TILE_LANES / (32 * TILE_R) warps whatever its lanes a thread.
GAB_R = 2
# The carry (csrc/tile_carry.cuh, WORD and MODES_LANES there): int32
# between two progress words of its round rows; the lanes a thread of the
# flags' carry (``params.modes``; at ``TILE_R`` its instantiations spilled);
# and the fewest warps a block that carry_warps picks.
CARRY_WORD = 32
CARRY_MODES_R = 2
CARRY_MIN_WARPS = 4


def carry_rounds(LB: int, warps: int, r: int = TILE_R) -> int:
    """Rounds of ``warps`` strips of 32 * ``r`` lanes that a pair of ``LB``
    lanes of b takes in a carry launch at ``r`` lanes a thread."""
    strips = -(-max(LB, 1) // (32 * r))
    return -(-strips // warps)


def carry_warps(B: int, LB: int, sms: int, r: int = TILE_R) -> int:
    """The warps a block of a carry launch over ``B`` pairs of ``LB`` lanes
    of b on a card of ``sms`` SMs, at ``r`` lanes a thread: the most,
    ``TILE_LANES`` / (32 * ``TILE_R``), halved while B x rounds stays below
    ``sms`` and the warps above ``CARRY_MIN_WARPS``, and no more than a
    pair's strips.  Each round is a block of its own, so fewer warps put a
    pair on more SMs (PERF.md, section 6, gives the measurement)."""
    strips = -(-max(LB, 1) // (32 * r))
    w = TILE_LANES // (32 * TILE_R)
    while w > CARRY_MIN_WARPS and B * carry_rounds(LB, w, r) < sms:
        w //= 2
    return max(1, min(w, strips))


def carry_scratch_ints(B: int, LB: int, ca: int, warps: int,
                       r: int = TILE_R, rounds: Optional[int] = None) -> int:
    """int32 of a carry launch's scratch (csrc/tile_carry.cuh,
    Rounds): a progress word each ``CARRY_WORD`` int32 for each of the
    B x (rounds - 1) round boundaries and one for the ticket counter, then
    a row of 3 * (ca + 1) int32 for each boundary, at ``r`` lanes a
    thread; ``rounds`` those of a slice launch, else every round of a pair
    of ``LB`` lanes."""
    if rounds is None:
        rounds = carry_rounds(LB, warps, r)
    rows = B * (rounds - 1)
    return (rows + 1) * CARRY_WORD + rows * 3 * (ca + 1)


def slice_granule(warps: int) -> int:
    """Lanes of one round of a slice launch (csrc/tile_carry.cuh, SLICE)
    at ``warps`` warps a block: a slice's lanes start at a multiple of it."""
    return 32 * TILE_R * warps


def slice_lanes(LB: int, n: int, granule: int):
    """The lanes of ``LB`` cut into at most ``n`` slices, each a run of
    whole units of ``granule`` lanes and the last cut at ``LB``, as even as
    the units allow: ``[(y_lo, y_hi), ...]``, slice k holding the lanes
    y_lo+1 .. y_hi.  Fewer than ``n`` when ``LB`` has fewer units; a slice
    with no lanes is left out."""
    units = -(-max(LB, 1) // granule)
    cut = [k * units // n for k in range(n + 1)]
    return [(lo * granule, min(hi * granule, max(LB, 1)))
            for lo, hi in zip(cut, cut[1:]) if hi > lo]


@functools.lru_cache(maxsize=None)
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


class FillSchedule(NamedTuple):
    """How one fill launch across widths runs (csrc/fill_common.cuh,
    Sched; csrc/tile_fill.cuh): built on the host by
    :func:`fill_schedule`.

    order: (B,) int32 on the device, block i fills pair order[i]: the pairs
      by cells, largest first, so that the longest start first.
    wrap: (B,) int32, the pair's round row in scratch, -1 when its nb fits
      one round, ``TILE_LANES``.
    nwrap: round rows the launch allocates.
    off: with planes, (B+1,) int64 on the device, ``pack.ragged_planes``:
      ``nw_fill_dirs`` and ``sw_fill_dirs`` write pair j's codes (and M)
      at its own widths from ``off[j]`` into 1-d tensors of ``total``
      elements.
    """

    order: torch.Tensor
    wrap: torch.Tensor
    nwrap: int
    off: Optional[torch.Tensor] = None
    total: int = 0


def fill_schedule(na, nb, device, planes: bool = False) -> FillSchedule:
    """The schedule of one fill launch over pairs of lengths ``na``,
    ``nb`` (host arrays), on ``device``; with ``planes`` the ragged planes
    of ``nw_fill_dirs`` / ``sw_fill_dirs``."""
    na = np.asarray(na, np.int64)
    nb = np.asarray(nb, np.int64)
    order = np.argsort(-(na * nb), kind="stable")
    rounds = nb > TILE_LANES
    wrap = np.where(rounds, np.cumsum(rounds) - 1, -1)

    def dev(v, dtype):
        return torch.from_numpy(np.ascontiguousarray(v, dtype)).to(device)

    off = ragged_planes(na, nb) if planes else None
    return FillSchedule(dev(order, np.int32), dev(wrap, np.int32),
                        int(rounds.sum()),
                        None if off is None else dev(off, np.int64),
                        0 if off is None else int(off[-1]))


# a launch across widths (a fill under a schedule, sw_hits over its
# planes) counts under "<kernel>[ragged]", every other under "<kernel>"
_COUNTS = {"nw_scores": 0, "nw_scores[ragged]": 0, "nw_fill_dirs": 0,
           "nw_fill_dirs[ragged]": 0, "nw_fill_gab": 0,
           "nw_fill_dirs_carry": 0, "nw_walk": 0, "sw_scores": 0,
           "sw_scores[ragged]": 0, "sw_fill_dirs": 0,
           "sw_fill_dirs[ragged]": 0, "sw_fill_gab": 0,
           "sw_fill_dirs_carry": 0, "sw_walk": 0, "sw_hits": 0,
           "sw_hits[ragged]": 0, "vpu_chain": 0, "nw_scores_slice": 0,
           "sw_scores_slice": 0, "nw_fill_dirs_slice": 0}


def kernel_launch_counts() -> dict:
    """Snapshot of kernel launches by wrapper name."""
    return dict(_COUNTS)


def reset_kernel_launch_counts() -> None:
    for k in _COUNTS:
        _COUNTS[k] = 0


def _expect(t, name, dtype, ndim, device):
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name} must be a tensor")
    if t.dtype != dtype or t.dim() != ndim:
        raise ValueError(f"{name} must be a {ndim}-d {dtype} tensor, got "
                         f"{t.dim()}-d {t.dtype}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_params(params: KernelParams, dev):
    _expect(params.scal, "params.scal", torch.int32, 1, dev)
    if params.scal.shape[0] != 6:
        raise ValueError("params.scal must be of size 6")
    if params.sub is not None:
        _expect(params.sub, "params.sub", torch.int32, 2, dev)
        if min(params.sub.shape) < 1:
            raise ValueError("params.sub must be a non-empty table")
        if params.modes & NMM:
            if params.im is None:
                raise ValueError("no_mismatches with a table needs "
                                 "params.im")
            _expect(params.im, "params.im", torch.int32, 2, dev)
            if params.im.shape != params.sub.shape:
                raise ValueError("params.im must have the shape of "
                                 "params.sub")
    if not 0 <= params.modes < 32:
        raise ValueError(f"params.modes {params.modes} is not a flag word")


def _check_fill(ac, bc, na, nb, params: KernelParams):
    dev = ac.device
    _expect(ac, "ac", torch.uint8, 2, dev)
    _expect(bc, "bc", torch.uint8, 2, dev)
    _expect(na, "na", torch.int32, 1, dev)
    _expect(nb, "nb", torch.int32, 1, dev)
    _check_params(params, dev)
    B, LA = ac.shape
    LB = bc.shape[1]
    if bc.shape[0] != B or na.shape[0] != B or nb.shape[0] != B:
        raise ValueError("ac, bc, na and nb must hold the same pair count")
    if LA < 1 or LB < 1:
        raise ValueError("widths must be >= 1")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    return B, LA, LB


def _ptr(t):
    return None if t is None else ctypes.c_void_p(t.data_ptr())


def _stream(dev):
    return ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)


def _launched(name, lib, rc):
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc} "
                           f"({lib.nw_error_string(rc).decode()})")
    _COUNTS[name] += 1


def _check_sched(sched, B):
    if sched is not None and not (sched.order.shape[0] == sched.wrap.shape[0]
                                  == B):
        raise ValueError("the schedule must hold one entry per pair")


def _fill(name, entry, ac, bc, na, nb, params, scores, corner=None,
          dirs=None, mout=None, m16=False, sched=None, carry=None,
          part=None):
    """Launch one of the fill kernels.  The four fills and the matrix
    dump's run the register tiles of csrc/tile_fill.cuh under any scoring
    flags: ``TILE_R`` lanes a thread (the dump's ``GAB_R``),
    a warp's edge ring (12 * ``TILE_RING`` bytes) in shared memory, and a
    round row of 3 * (LA+1) int32 in scratch for each pair past a block's
    round of lanes, ``TILE_LANES`` at ``TILE_R`` (slice j without a
    schedule, the schedule's ``wrap`` slot with one).  A carry (``carry``:
    the extra arguments of a carry entry, which takes no schedule) runs
    csrc/tile_carry.cuh, at ``CARRY_MODES_R`` lanes a thread under flags: a
    block of :func:`carry_warps` warps for each round of each pair, their
    rings in shared memory, and a scratch of :func:`carry_scratch_ints`
    int32 for the round rows, their progress words and the ticket counter.
    A slice of a carry (``part``: the edge rows in and out, the rounds
    r_lo, r_hi and the warps a block) runs those rounds alone.
    The table (4 bytes per entry, twice that with the is-match table of
    no_mismatches) takes the shared memory left, else the read-only global
    path."""
    B, LA = ac.shape
    LB = bc.shape[1]
    if B == 0:
        return
    dev = ac.device
    warps = 0  # a carry's warps a block
    if carry is not None:
        r = CARRY_MODES_R if params.modes else TILE_R
        if part is None:
            warps, rounds = carry_warps(
                B, LB, _sms(torch.cuda.current_device() if dev.index is None
                            else dev.index), r), None
        else:
            warps, rounds = part[4], part[3] - part[2]
        smem = 12 * TILE_RING * warps
        scratch = torch.empty(
            carry_scratch_ints(B, LB, carry[3], warps, r, rounds),
            dtype=torch.int32, device=dev)
    else:
        r = GAB_R if entry.endswith("_gab_launch") else TILE_R
        wmax = TILE_LANES // (32 * TILE_R)  # a block's warps at any r
        smem = 12 * TILE_RING * min(-(-LB // (32 * r)), wmax)
        if sched is None:
            nscratch = B if LB > 32 * r * wmax else 0
        else:
            nscratch = sched.nwrap
        scratch = (torch.empty((nscratch, 3, LA + 1), dtype=torch.int32,
                               device=dev) if nscratch else None)
    sub = params.sub
    im = params.im if sub is not None and params.modes & NMM else None
    kb = sub_n = table_smem = 0
    if sub is not None:
        kb, sub_n = sub.shape[1], sub.numel()
        tables = 4 * sub_n * (1 if im is None else 2)
        table_smem = int(smem + tables <= SMEM_MAX)
    lib = library()
    if carry is None:
        tail = ((None, None, None) if sched is None else
                (_ptr(sched.order), _ptr(sched.wrap), _ptr(sched.off)))
    else:
        tail = (*carry, warps)
        if part is not None:
            tail += (_ptr(part[0]), _ptr(part[1]), part[2], part[3])
    rc = getattr(lib, entry)(
        _ptr(ac), _ptr(bc), _ptr(na), _ptr(nb), _ptr(params.scal), _ptr(sub),
        _ptr(im), params.modes, kb, sub_n, table_smem, B, LA, LB,
        _ptr(scores), _ptr(corner),
        _ptr(dirs), _ptr(mout), int(m16), _ptr(scratch), _stream(dev),
        *tail)
    _launched(name if sched is None else f"{name}[ragged]", lib, rc)


def nw_scores(ac, bc, na, nb, params: KernelParams,
              sched: Optional[FillSchedule] = None):
    """NW scores and corners of a padded batch (see ``nw_scores_plain``):
    returns ``(scores (B,) int32, corner (B, 3) int32)``.  ``sched``: one
    launch across widths (:func:`fill_schedule`)."""
    B, LA, LB = _check_fill(ac, bc, na, nb, params)
    _check_sched(sched, B)
    if ac.device.type == "cpu":
        return nw_scores_plain(ac, bc, na, nb, params)
    scores = torch.empty(B, dtype=torch.int32, device=ac.device)
    corner = torch.empty((B, 3), dtype=torch.int32, device=ac.device)
    _fill("nw_scores", "nw_scores_launch", ac, bc, na, nb, params, scores,
          corner, sched=sched)
    return scores, corner


def nw_fill_dirs(ac, bc, na, nb, params: KernelParams,
                 sched: Optional[FillSchedule] = None):
    """The NW fill with direction codes (see ``nw_fill_dirs_plain``):
    returns ``(dirs (B, LA+LB-1, LB+1) uint8, corner (B, 3) int32)``; only
    cells 1 <= y <= nb, 1 <= x <= na of dirs are defined.  Under a
    schedule with planes (:func:`fill_schedule`), one launch across
    widths: dirs is 1-d, ``sched.total`` bytes, pair j's plane at its own
    widths from ``sched.off[j]`` (``pack.ragged_planes``)."""
    B, LA, LB = _check_fill(ac, bc, na, nb, params)
    _check_sched(sched, B)
    off = None if sched is None else sched.off
    if ac.device.type == "cpu":
        return nw_fill_dirs_plain(ac, bc, na, nb, params, off)
    dev = ac.device
    dirs = torch.empty((B, LA + LB - 1, LB + 1) if off is None
                       else (sched.total,), dtype=torch.uint8, device=dev)
    scores = torch.empty(B, dtype=torch.int32, device=dev)
    corner = torch.empty((B, 3), dtype=torch.int32, device=dev)
    _fill("nw_fill_dirs", "nw_dirs_launch", ac, bc, na, nb, params, scores,
          corner, dirs, sched=sched)
    return dirs, corner


def sw_scores(ac, bc, na, nb, params: KernelParams,
              sched: Optional[FillSchedule] = None):
    """SW best scores of a padded batch (see ``sw_scores_plain``): (B,)
    int32.  ``sched``: one launch across widths (:func:`fill_schedule`;
    its planes, if any, are not used)."""
    B, LA, LB = _check_fill(ac, bc, na, nb, params)
    _check_sched(sched, B)
    if ac.device.type == "cpu":
        return sw_scores_plain(ac, bc, na, nb, params)
    scores = torch.empty(B, dtype=torch.int32, device=ac.device)
    _fill("sw_scores", "sw_scores_launch", ac, bc, na, nb, params, scores,
          sched=sched)
    return scores


def sw_fill_dirs(ac, bc, na, nb, params: KernelParams, m16: bool = False,
                 sched: Optional[FillSchedule] = None):
    """The SW fill with direction codes and M (see ``sw_fill_dirs_plain``):
    returns ``(dirs uint8, M int16 if m16 else int32)``, both
    (B, LA+LB-1, LB+1); only cells 1 <= y <= nb, 1 <= x <= na are
    defined.  ``m16``: the caller's ``pack.m16_safe`` for the launch's
    widest pair.  Under a schedule with planes (:func:`fill_schedule`), one
    launch across widths: dirs and M are 1-d, ``sched.total`` elements
    each, pair j's planes at its own widths from ``sched.off[j]``
    (``pack.ragged_planes``); M is zeroed before the launch, so that its
    cells the fill does not write (the planes' skew pad, lane 0, a pair
    with an empty side) hold 0, below every harvest threshold."""
    B, LA, LB = _check_fill(ac, bc, na, nb, params)
    _check_sched(sched, B)
    off = None if sched is None else sched.off
    if ac.device.type == "cpu":
        return sw_fill_dirs_plain(ac, bc, na, nb, params, m16, off)
    dev = ac.device
    shape = (B, LA + LB - 1, LB + 1) if off is None else (sched.total,)
    dirs = torch.empty(shape, dtype=torch.uint8, device=dev)
    mout = (torch.empty if off is None else torch.zeros)(
        shape, dtype=torch.int16 if m16 else torch.int32, device=dev)
    scores = torch.empty(B, dtype=torch.int32, device=dev)
    _fill("sw_fill_dirs", "sw_dirs_launch", ac, bc, na, nb, params, scores,
          dirs=dirs, mout=mout, m16=m16, sched=sched)
    return dirs, mout


def nw_fill_gab(ac, bc, na, nb, params: KernelParams):
    """The NW fill with direction codes and the M, Ga and Gb planes for the
    matrix dump (see ``nw_fill_gab_plain``): returns ``(dirs (B, LA+LB-1,
    LB+1) uint8, corner (B, 3) int32, gab (3, B, LA+LB-1, LB+1) int32)``;
    only cells 1 <= y <= nb, 1 <= x <= na are defined."""
    B, LA, LB = _check_fill(ac, bc, na, nb, params)
    if ac.device.type == "cpu":
        return nw_fill_gab_plain(ac, bc, na, nb, params)
    dev = ac.device
    shape = (B, LA + LB - 1, LB + 1)
    dirs = torch.empty(shape, dtype=torch.uint8, device=dev)
    gab = torch.empty((3,) + shape, dtype=torch.int32, device=dev)
    scores = torch.empty(B, dtype=torch.int32, device=dev)
    corner = torch.empty((B, 3), dtype=torch.int32, device=dev)
    _fill("nw_fill_gab", "nw_dirs_gab_launch", ac, bc, na, nb, params,
          scores, corner, dirs, gab)
    return dirs, corner, gab


def sw_fill_gab(ac, bc, na, nb, params: KernelParams):
    """The SW fill with direction codes and the M, Ga and Gb planes (see
    ``sw_fill_gab_plain``): returns ``(dirs uint8, gab (3, B, LA+LB-1,
    LB+1) int32)``, ``gab[0]`` the M plane; only cells 1 <= y <= nb,
    1 <= x <= na are defined."""
    B, LA, LB = _check_fill(ac, bc, na, nb, params)
    if ac.device.type == "cpu":
        return sw_fill_gab_plain(ac, bc, na, nb, params)
    dev = ac.device
    shape = (B, LA + LB - 1, LB + 1)
    dirs = torch.empty(shape, dtype=torch.uint8, device=dev)
    gab = torch.empty((3,) + shape, dtype=torch.int32, device=dev)
    scores = torch.empty(B, dtype=torch.int32, device=dev)
    _fill("sw_fill_gab", "sw_dirs_gab_launch", ac, bc, na, nb, params,
          scores, dirs=dirs, mout=gab)
    return dirs, gab


def _check_carry(ac, bc, na, nb, params, x_off, bin, bout, dirs):
    """The checks of a carry launch: the fill's, then ``bin``/``bout``
    (B, 3, LB+1) int32, ``dirs`` a (B, D_c, LB+1) uint8 slab whose rows and
    lanes are contiguous (it may be one chunk of a (B, nch, D_c, LB+1)
    tensor), and 0 <= x_off < LA.  Returns (B, LA, LB, CA)."""
    B, LA, LB = _check_fill(ac, bc, na, nb, params)
    dev = ac.device
    _expect(bin, "bin", torch.int32, 3, dev)
    _expect(bout, "bout", torch.int32, 3, dev)
    if bin.shape != (B, 3, LB + 1) or bout.shape != bin.shape:
        raise ValueError(f"bin and bout must be of shape {(B, 3, LB + 1)}")
    if bin.data_ptr() == bout.data_ptr():
        raise ValueError("bin and bout must be separate tensors")
    if not isinstance(dirs, torch.Tensor) or dirs.dtype != torch.uint8 or \
            dirs.dim() != 3 or dirs.device != dev:
        raise ValueError(f"dirs must be a 3-d uint8 tensor on {dev}")
    D, LBp = dirs.shape[1:]
    if dirs.shape[0] != B or LBp != LB + 1 or D < LB + 1 or \
            dirs.stride()[1:] != (LBp, 1):
        raise ValueError("dirs must be a (B, CA+LB-1, LB+1) slab with "
                         "contiguous rows")
    if not 0 <= int(x_off) < LA:
        raise ValueError(f"x_off {x_off} is outside [0, {LA})")
    return B, LA, LB, D - LB + 1


def _carry_args(x_off, bin, bout, dirs, ca, mstride):
    return (_ptr(bin), _ptr(bout), int(x_off), ca,
            ctypes.c_longlong(0 if dirs is None else dirs.stride(0)),
            ctypes.c_longlong(mstride))


def nw_fill_dirs_carry(ac, bc, na, nb, params: KernelParams, x_off: int,
                       bin, bout, dirs, corner):
    """One chunk of a long NW pair's fill, in place (see
    ``nw_fill_dirs_carry_plain``): the columns x_off+1 .. x_off+CA, CA from
    the ``dirs`` slab; ``bin`` the column x = x_off, ``bout`` gets the
    column x_off+CA, ``corner`` (B, 3) int32 the corner of the pairs that
    end in this chunk.  The scores the kernel also writes go to a scratch
    tensor."""
    B, LA, LB, ca = _check_carry(ac, bc, na, nb, params, x_off, bin, bout,
                                 dirs)
    _expect(corner, "corner", torch.int32, 2, ac.device)
    if corner.shape != (B, 3):
        raise ValueError("corner must be (B, 3)")
    if ac.device.type == "cpu":
        return nw_fill_dirs_carry_plain(ac, bc, na, nb, params, x_off, bin,
                                        bout, dirs, corner)
    scores = torch.empty(B, dtype=torch.int32, device=ac.device)
    _fill("nw_fill_dirs_carry", "nw_dirs_carry_launch", ac, bc, na, nb,
          params, scores, corner, dirs,
          carry=_carry_args(x_off, bin, bout, dirs, ca, 0))


def sw_fill_dirs_carry(ac, bc, na, nb, params: KernelParams, x_off: int,
                       bin, bout, dirs, best, m16: bool = False):
    """One chunk of a long SW pair's fill, in place (see
    ``sw_fill_dirs_carry_plain``): codes into the ``dirs`` slab, the
    column x_off+CA into ``bout``, ``best`` (B,) int32 raised to the
    chunk's best M.  Returns the chunk's M, (B, CA+LB-1, LB+1), int16 if
    ``m16`` else int32."""
    B, LA, LB, ca = _check_carry(ac, bc, na, nb, params, x_off, bin, bout,
                                 dirs)
    _expect(best, "best", torch.int32, 1, ac.device)
    if best.shape[0] != B:
        raise ValueError("best must hold one entry per pair")
    if ac.device.type == "cpu":
        return sw_fill_dirs_carry_plain(ac, bc, na, nb, params, x_off, bin,
                                        bout, dirs, best, m16)
    mout = torch.empty(dirs.shape, dtype=torch.int16 if m16 else torch.int32,
                       device=ac.device)
    _fill("sw_fill_dirs_carry", "sw_dirs_carry_launch", ac, bc, na, nb,
          params, best, dirs=dirs, mout=mout, m16=m16,
          carry=_carry_args(x_off, bin, bout, dirs, ca, mout.stride(0)))
    return mout


def _check_slice(ac, bc, na, nb, params, x_off, ca, lanes, warps, bin,
                 bout, edge_in, edge_out):
    """The checks of a slice launch: the fill's at the default flags,
    ``bin``/``bout`` as a carry's, 0 <= x_off < LA, ``lanes`` = (y_lo,
    y_hi) with 0 <= y_lo < min(y_hi, LB), the edge rows (B, 3, ca+1) int32
    (``edge_in`` needed when y_lo > 0, ``edge_out`` optional: without it no
    row goes out), and on the card y_lo and y_hi (unless it passes LB) at
    multiples of :func:`slice_granule` for 1 .. ``TILE_LANES`` / (32 *
    ``TILE_R``) ``warps``.  Returns (B, LB, the kernel's rounds r_lo,
    r_hi)."""
    B, LA, LB = _check_fill(ac, bc, na, nb, params)
    dev = ac.device
    if params.modes:
        raise ValueError("a slice fill takes the default flags (params.modes "
                         "0)")
    _expect(bin, "bin", torch.int32, 3, dev)
    _expect(bout, "bout", torch.int32, 3, dev)
    if bin.shape != (B, 3, LB + 1) or bout.shape != bin.shape:
        raise ValueError(f"bin and bout must be of shape {(B, 3, LB + 1)}")
    if bin.data_ptr() == bout.data_ptr():
        raise ValueError("bin and bout must be separate tensors")
    if not 0 <= int(x_off) < LA:
        raise ValueError(f"x_off {x_off} is outside [0, {LA})")
    if ca < 1:
        raise ValueError(f"ca {ca} must be >= 1")
    y_lo, y_hi = (int(v) for v in lanes)
    if not 0 <= y_lo < min(y_hi, LB):
        raise ValueError(f"lanes {lanes} hold no lane of [0, {LB})")
    if y_lo and edge_in is None:
        raise ValueError("a slice past lane 0 needs edge_in")
    for e, name in ((edge_in, "edge_in"), (edge_out, "edge_out")):
        if e is not None:
            _expect(e, name, torch.int32, 3, dev)
            if e.shape != (B, 3, ca + 1):
                raise ValueError(f"{name} must be of shape {(B, 3, ca + 1)}")
    if edge_in is not None and edge_out is not None and \
            edge_in.data_ptr() == edge_out.data_ptr():
        raise ValueError("edge_in and edge_out must be separate tensors")
    g = slice_granule(warps)
    if dev.type == "cuda" and (
            not 1 <= warps <= TILE_LANES // (32 * TILE_R)
            or y_lo % g or (y_hi < LB and y_hi % g)):
        raise ValueError(f"lanes {lanes} are not whole rounds of {warps} "
                         f"warps ({g} lanes)")
    return B, LB, y_lo // g, -(-min(y_hi, LB) // g)


def nw_fill_dirs_slice(ac, bc, na, nb, params: KernelParams, x_off: int,
                       lanes, warps: int, bin, bout, dirs, corner,
                       edge_in=None, edge_out=None):
    """One chunk of one slice of a long NW pair's lanes, in place (S2; see
    ``nw_fill_dirs_slice_plain``): the lanes ``lanes`` = (y_lo, y_hi) of
    the columns x_off+1 .. x_off+CA, CA from the ``dirs`` slab, whose
    valid cells of those lanes get their codes; ``edge_in`` the lane y_lo
    by local column, ``edge_out`` gets the lane y_hi; a block of ``warps``
    warps a round.  The scores the kernel also writes go to a scratch
    tensor."""
    B, LA, LB, ca = _check_carry(ac, bc, na, nb, params, x_off, bin, bout,
                                 dirs)
    _, _, r_lo, r_hi = _check_slice(ac, bc, na, nb, params, x_off, ca, lanes,
                                    warps, bin, bout, edge_in, edge_out)
    _expect(corner, "corner", torch.int32, 2, ac.device)
    if corner.shape != (B, 3):
        raise ValueError("corner must be (B, 3)")
    if ac.device.type == "cpu":
        return nw_fill_dirs_slice_plain(ac, bc, na, nb, params, x_off, lanes,
                                        bin, bout, dirs, corner, edge_in,
                                        edge_out)
    scores = torch.empty(B, dtype=torch.int32, device=ac.device)
    _fill("nw_fill_dirs_slice", "nw_dirs_slice_launch", ac, bc, na, nb,
          params, scores, corner, dirs,
          carry=_carry_args(x_off, bin, bout, dirs, ca, 0),
          part=(edge_in, edge_out, r_lo, r_hi, warps))


def nw_scores_slice(ac, bc, na, nb, params: KernelParams, x_off: int,
                    ca: int, lanes, warps: int, bin, bout, corner,
                    edge_in=None, edge_out=None):
    """One chunk of ``ca`` columns of one slice of a batch's lanes, NW
    scores only, in place (S1; see ``nw_scores_slice_plain``): ``corner``
    (B, 3) int32 gets the corners the slice and chunk hold."""
    B, LB, r_lo, r_hi = _check_slice(ac, bc, na, nb, params, x_off, ca,
                                     lanes, warps, bin, bout, edge_in,
                                     edge_out)
    _expect(corner, "corner", torch.int32, 2, ac.device)
    if corner.shape != (B, 3):
        raise ValueError("corner must be (B, 3)")
    if ac.device.type == "cpu":
        return nw_scores_slice_plain(ac, bc, na, nb, params, x_off, ca, lanes,
                                     bin, bout, corner, edge_in, edge_out)
    scores = torch.empty(B, dtype=torch.int32, device=ac.device)
    _fill("nw_scores_slice", "nw_scores_slice_launch", ac, bc, na, nb,
          params, scores, corner,
          carry=_carry_args(x_off, bin, bout, None, ca, 0),
          part=(edge_in, edge_out, r_lo, r_hi, warps))


def sw_scores_slice(ac, bc, na, nb, params: KernelParams, x_off: int,
                    ca: int, lanes, warps: int, bin, bout, best,
                    edge_in=None, edge_out=None):
    """One chunk of ``ca`` columns of one slice of a batch's lanes, SW
    scores only, in place (S1; see ``sw_scores_slice_plain``): ``best``
    (B,) int32 raised to the slice's best M in the chunk."""
    B, LB, r_lo, r_hi = _check_slice(ac, bc, na, nb, params, x_off, ca,
                                     lanes, warps, bin, bout, edge_in,
                                     edge_out)
    _expect(best, "best", torch.int32, 1, ac.device)
    if best.shape[0] != B:
        raise ValueError("best must hold one entry per pair")
    if ac.device.type == "cpu":
        return sw_scores_slice_plain(ac, bc, na, nb, params, x_off, ca, lanes,
                                     bin, bout, best, edge_in, edge_out)
    _fill("sw_scores_slice", "sw_scores_slice_launch", ac, bc, na, nb,
          params, best, carry=_carry_args(x_off, bin, bout, None, ca, 0),
          part=(edge_in, edge_out, r_lo, r_hi, warps))


def _check_codes(dirs, ac, bc, na, nb, off=None):
    """A walk's codes: a (B, LA+LB-1, LB+1) plane or (B, nch, D_c, LB+1)
    chunk slabs of CA = D_c - LB + 1 columns that cover the LA columns of
    ``ac`` (nch = ceil(LA / CA)), or with ``off`` ((B+1,) int64, a
    schedule's) the 1-d planes at each pair's own widths of one launch
    across widths, each at least as large as ``na``, ``nb`` make it.
    Returns (B, nch, D_c)."""
    dev = dirs.device
    if off is not None:
        _expect(dirs, "dirs", torch.uint8, 1, dev)
        _expect(off, "off", torch.int64, 1, dev)
        B = off.shape[0] - 1
        if B < 0 or ac.shape[0] != B or bc.shape[0] != B or \
                na.shape[0] != B or nb.shape[0] != B:
            raise ValueError("dirs, off, ac and bc must come from one fill")
        wa, wb = na.long().clamp(min=1), nb.long().clamp(min=1)
        if B and (int(off[0]) < 0 or int(off[-1]) > dirs.shape[0] or not bool(
                (off[1:] - off[:-1] >= (wa + wb - 1) * (wb + 1)).all())):
            raise ValueError("off must hold each pair's plane within dirs")
        return B, 1, 1  # each pair's widths are its own
    if dirs.dim() not in (3, 4):
        raise ValueError("dirs must be a code plane or chunk slabs")
    _expect(dirs, "dirs", torch.uint8, dirs.dim(), dev)
    nch, dc, LBp, ca = slab_geometry(dirs)
    B = dirs.shape[0]
    LA, LB = ac.shape[1], bc.shape[1]
    if ac.shape[0] != B or bc.shape[0] != B or LB + 1 != LBp or ca < 1 or \
            not (nch - 1) * ca < LA <= nch * ca or \
            (dirs.dim() == 3 and ca != LA):
        raise ValueError("dirs, ac and bc must come from one fill")
    return B, nch, dc


def nw_walk(dirs, corner, na, nb, cap: int, off=None):
    """Device traceback walk (see ``nw_walk_plain``) over a code plane or
    chunk slabs, or with ``off`` ((B+1,) int64, a schedule's) over the 1-d
    planes at each pair's own widths of one launch across widths: returns
    the op trace (B, walk_cap(cap)) int8 and the start scores (B,)
    int32."""
    dev = dirs.device
    if dirs.dim() not in ((1,) if off is not None else (3, 4)):
        raise ValueError("dirs must be a code plane or chunk slabs, or 1-d "
                         "planes with their offsets")
    _expect(dirs, "dirs", torch.uint8, dirs.dim(), dev)
    _expect(corner, "corner", torch.int32, 2, dev)
    _expect(na, "na", torch.int32, 1, dev)
    _expect(nb, "nb", torch.int32, 1, dev)
    B = corner.shape[0]
    if off is None:
        nch, dc, LBp, _ = slab_geometry(dirs)
    else:
        _expect(off, "off", torch.int64, 1, dev)
        nch, dc, LBp = 1, 1, 1  # unused: each pair's widths are its own
        if off.shape[0] != B + 1:
            raise ValueError("off must hold B+1 offsets")
    if corner.shape != (B, 3) or na.shape[0] != B or nb.shape[0] != B or \
            (off is None and dirs.shape[0] != B):
        raise ValueError("dirs, corner, na and nb must hold the same pair "
                         "count")
    if dev.type == "cpu":
        return nw_walk_plain(dirs, corner, na, nb, cap, off)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    lib = library()
    capr = walk_cap(cap)
    ops = torch.empty((B, capr), dtype=torch.int8, device=dev)
    score = torch.empty(B, dtype=torch.int32, device=dev)
    if B == 0:
        return ops, score
    rc = lib.nw_walk_launch(_ptr(dirs), _ptr(corner), _ptr(na), _ptr(nb), B,
                            nch, dc, LBp, capr, _ptr(ops), _ptr(score),
                            _ptr(off), _stream(dev))
    _launched("nw_walk", lib, rc)
    return ops, score


def sw_walk(dirs, ac, bc, na, nb, jw, x0, y0, s0, params: KernelParams,
            cap: int, off=None):
    """Device SW candidate walks (see ``sw_walk_plain``) over one fill's
    ``dirs`` (a plane or chunk slabs, or with ``off`` the 1-d planes of
    one launch across widths), codes and lengths: returns the op traces
    (W, walk_cap(cap)) int8."""
    dev = dirs.device
    _expect(ac, "ac", torch.uint8, 2, dev)
    _expect(bc, "bc", torch.uint8, 2, dev)
    for t, n in ((na, "na"), (nb, "nb"), (jw, "jw"), (x0, "x0"), (y0, "y0"),
                 (s0, "s0")):
        _expect(t, n, torch.int32, 1, dev)
    _check_params(params, dev)
    B, nch, dc = _check_codes(dirs, ac, bc, na, nb, off)
    LA, LB = ac.shape[1], bc.shape[1]
    W = jw.shape[0]
    if not na.shape[0] == nb.shape[0] == B:
        raise ValueError("na and nb must hold one entry per pair")
    if not x0.shape[0] == y0.shape[0] == s0.shape[0] == W:
        raise ValueError("jw, x0, y0 and s0 must hold the same walk count")
    if dev.type == "cpu":
        return sw_walk_plain(dirs, ac, bc, na, nb, jw, x0, y0, s0, params,
                             cap, off)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    capr = walk_cap(cap)
    ops = torch.empty((W, capr), dtype=torch.int8, device=dev)
    if W == 0:
        return ops
    lib = library()
    sub = params.sub
    rc = lib.sw_walk_launch(
        _ptr(dirs), _ptr(ac), _ptr(bc), _ptr(params.scal), _ptr(sub),
        0 if sub is None else sub.shape[1],
        0 if sub is None else sub.numel(), _ptr(na), _ptr(nb),
        int(bool(params.modes & NEG)), _ptr(jw), _ptr(x0), _ptr(y0),
        _ptr(s0), W, B, LA, LB, nch, dc, capr, _ptr(ops), _stream(dev),
        _ptr(off))
    _launched("sw_walk", lib, rc)
    return ops


def hits_masks(na, nb, smem: int):
    """Where the masks of a ``sw_hits`` launch across widths live: pair j
    has (nb+1)(na+1) bits, ``words[j]`` 32-bit words; the launch gives
    each block the words of the largest mask that fits ``smem`` bytes, and
    a pair whose mask passes them takes words ``moff[j] ..`` of a global
    buffer of ``moff[-1]`` words.  ``na``, ``nb`` (B,) int32 tensors.
    Returns ``(shared words a block, moff (B+1,) int64)``."""
    words = ((na.long() + 1) * (nb.long() + 1) + 31) // 32
    fits = words * 4 <= smem
    block = int(words[fits].max()) if bool(fits.any()) else 0
    moff = torch.zeros(len(words) + 1, dtype=torch.int64, device=na.device)
    moff[1:] = torch.where(words <= block, 0, words).cumsum(0)
    return block, moff


def sw_hits(dirs, ac, bc, na, nb, cand_flat, cand_score, lo, hi,
            params: KernelParams, k: int, off=None):
    """The first ``k`` hits of every pair of one SW fill (a code plane, a
    long pair's chunk slabs, or with ``off`` the 1-d planes of one launch
    across widths), found on the device with the reference's overlap mask
    (see ``sw_hits_plain``): returns ``(hit_flat (B, k), hit_score (B, k)
    int32, nhits (B,) int32)``.  Flats are int32, or int64 where a pair
    has 2^31 cells or more (``sw_sorted_candidates`` picks); ``hit_flat``
    takes ``cand_flat``'s type.  The mask takes ``(LB+1) * (LA+1)`` bits a
    pair, LA the pairs' global width (with ``off``, the pair's own
    ``(nb+1) * (na+1)``, :func:`hits_masks`): shared memory when that
    fits, else a zeroed global buffer."""
    dev = dirs.device
    _expect(ac, "ac", torch.uint8, 2, dev)
    _expect(bc, "bc", torch.uint8, 2, dev)
    _expect(na, "na", torch.int32, 1, dev)
    _expect(nb, "nb", torch.int32, 1, dev)
    flat64 = getattr(cand_flat, "dtype", None) == torch.int64
    _expect(cand_flat, "cand_flat", torch.int64 if flat64 else torch.int32,
            1, dev)
    _expect(cand_score, "cand_score", torch.int32, 1, dev)
    _expect(lo, "lo", torch.int64, 1, dev)
    _expect(hi, "hi", torch.int64, 1, dev)
    _check_params(params, dev)
    B, nch, dc = _check_codes(dirs, ac, bc, na, nb, off)
    LA, LB = ac.shape[1], bc.shape[1]
    LBp = LB + 1
    if not na.shape[0] == nb.shape[0] == lo.shape[0] == hi.shape[0] == B:
        raise ValueError("na, nb, lo and hi must hold one entry per pair")
    if cand_flat.shape != cand_score.shape:
        raise ValueError("cand_flat and cand_score must be of one size")
    if k < 1:
        raise ValueError("k must be >= 1")
    if dev.type == "cpu":
        return sw_hits_plain(dirs, ac, bc, na, nb, cand_flat, cand_score, lo,
                             hi, params, k, off)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    hit_flat = torch.zeros((B, k), dtype=cand_flat.dtype, device=dev)
    hit_score = torch.zeros((B, k), dtype=torch.int32, device=dev)
    nhits = torch.zeros(B, dtype=torch.int32, device=dev)
    if B == 0:
        return hit_flat, hit_score, nhits
    moff = None
    if off is None:
        MW = -(-LBp * (LA + 1) // 32)
        smem = 4 * MW <= SMEM_MAX
        gwords = 0 if smem else B * MW
    else:
        MW, moff = hits_masks(na, nb, SMEM_MAX)
        smem = MW > 0
        gwords = int(moff[-1])
    gmask = (torch.zeros(gwords, dtype=torch.int32, device=dev) if gwords
             else None)
    lib = library()
    sub = params.sub
    rc = lib.sw_hits_launch(
        _ptr(dirs), _ptr(ac), _ptr(bc), _ptr(params.scal), _ptr(sub),
        0 if sub is None else sub.shape[1], _ptr(na), _ptr(nb),
        int(bool(params.modes & NEG)), _ptr(cand_flat), _ptr(cand_score),
        _ptr(lo), _ptr(hi), B, LA, LB, nch, dc, k, MW, _ptr(gmask),
        int(smem), _ptr(hit_flat), _ptr(hit_score), _ptr(nhits),
        int(flat64), _stream(dev), _ptr(off), _ptr(moff))
    _launched("sw_hits" if off is None else "sw_hits[ragged]", lib, rc)
    return hit_flat, hit_score, nhits


VPU_OPS = ("addmax", "add", "roll", "shift")
def vpu_layout(op: str, words: int, i16: bool = False):
    """The registers csrc/exp_vpu.cu gives a row of ``words`` 32-bit words
    (int32 lanes, or with ``i16`` int16 lanes in pairs): ``(T, K)``, T
    threads of one warp a row and K consecutive words a thread.  A move
    (``roll``, ``shift``) of a row of more than 32 words takes a warp, K
    the least power of two >= words / 32 (2 to 32); of up to 32 words a
    sub-warp group of T = 1, 2, 4 or 8 threads of K = 4 words, 32 / T rows
    a warp.  ``addmax`` and ``add`` move nothing: two lanes a thread (K =
    2 int32 words or 1 int16 word) over the whole block, a row's words on
    as many threads as they fill (T = None)."""
    if not 1 <= words <= 1024:
        raise ValueError(f"a row of {words} words does not fit a warp")
    if op in ("addmax", "add"):
        return None, 1 if i16 else 2
    if words <= 32:
        return max(1, 1 << (-(-words // 4) - 1).bit_length()), 4
    return 32, 1 << (-(-words // 32) - 1).bit_length()


def vpu_chain_plain(x, steps: int, op: str):
    """``steps`` dependent steps of one elementwise op on ``x`` (R, L),
    int32 or int16, as the Pallas kernel of tools/exp_vpu.py:42-56 computes
    them, with v = x and w starting at x: ``addmax`` w = max(w + v, w);
    ``add`` w = w + v; ``roll`` w[:, j] = w[:, j-1] + v (lane 0 takes lane
    L-1); ``shift`` the same with 1 entering at lane 0.  Sums wrap in the
    tensor's type."""
    v = w = x
    for _ in range(steps):
        if op == "addmax":
            w = torch.maximum(w + v, w)
        elif op == "add":
            w = w + v
        elif op == "roll":
            w = torch.roll(w, 1, 1) + v
        else:
            w = torch.cat([torch.ones_like(w[:, :1]), w[:, :-1]], 1) + v
    return w


def vpu_chain(x, steps: int, op: str):
    """The ALU probe (see ``vpu_chain_plain``; csrc/exp_vpu.cu): returns
    the (R, L) result, ``addmax`` by the Hopper DPX add-max.  A row's
    words in registers (:func:`vpu_layout`), a move's row in one warp: L
    <= 1024 lanes of int32, or an even L <= 2048 of int16."""
    if not isinstance(x, torch.Tensor) or x.dtype not in (torch.int32,
                                                           torch.int16):
        raise ValueError("x must be an int32 or int16 tensor")
    _expect(x, "x", x.dtype, 2, x.device)
    if op not in VPU_OPS:
        raise ValueError(f"op must be one of {VPU_OPS}, not {op!r}")
    if steps < 0:
        raise ValueError("steps must be >= 0")
    if x.device.type == "cpu":
        return vpu_chain_plain(x, steps, op)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    R, L = x.shape
    i16 = x.dtype == torch.int16
    if (i16 and L % 2) or not 1 <= (L // 2 if i16 else L) <= 1024:
        raise ValueError(f"a row of {L} {x.dtype} lanes does not fit a "
                         f"block")
    o = torch.empty_like(x)
    if R == 0:
        return o
    lib = library()
    rc = lib.vpu_chain_launch(_ptr(x), _ptr(o), R, L, int(steps),
                              VPU_OPS.index(op), int(i16), _stream(x.device))
    _launched("vpu_chain", lib, rc)
    return o
