"""Sequence parallelism: the lanes (the b positions) of one pair, or of a
batch, split over the devices of a mesh; the port's counterpart of
``seqalign_tpu/parallel/wavefront_sp.py``.

The JAX package passes one lane to the right neighbour each anti-diagonal
(``ppermute``) and ``pmax``es the NW corner or SW best.  Here a slice is a
run of whole rounds of the carry's lanes (``csrc/tile_carry.cuh``,
SLICE): slice k holds the lanes y_lo+1 .. y_hi of every pair, y_lo a
multiple of a round's lanes on the card, and fills seq_a in chunks of
columns with the boundary column carried from chunk to chunk.  Its first
round reads the edge row of the slice before it (the lane y_lo by column,
one row a chunk) and its last round writes its own.  Slice k fills chunk c
once slice k-1 has filled chunk c, so the devices run as a wavefront over
(slice, chunk) in n_slices + n_chunks - 1 steps; each slice runs on its
device's own stream, and an edge row moves by ``Tensor.copy_`` behind a
CUDA event (a device-local copy where the mesh repeats a device).  The NW
corner comes from the slice that holds lane nb, the SW best is the max of
the slices' bests, taken on the host where the JAX package takes a pmax.

Both entries take default flags and ``gap_open <= 0``, and ``sp_align_nw``
equality scoring, as in the JAX package; another config goes to the port's
``_scores_auto`` / ``align_long`` on the mesh's first device, the JAX
package's routing.  On the CPU the kernels' plain versions run the same
slices, one after another in the wavefront's order.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import aligners
from ..ops import dp, kernels
from ..ops.dp import boundary_column
from ..ops.pack import (check_valid_pairs, kernel_params, mm_eligible,
                        pack_batch)
from ..ops.traceback import nw_strings_from_ops
from ..scoring.config import ScoringConfig, from_reference
from .engine import Mesh, on_stream

INT_MIN = np.iinfo(np.int32).min


def _default_flags(sc: ScoringConfig) -> bool:
    return not (sc.no_start_gap_penalty or sc.no_end_gap_penalty
                or sc.no_gaps_in_a or sc.no_gaps_in_b or sc.no_mismatches)


def slice_plan(mesh: Mesh, axis: str, B: int, LB: int):
    """How a sequence-parallel fill of ``B`` pairs of ``LB`` lanes cuts
    over ``mesh[axis]``: (the slices' devices, their lanes ``[(y_lo,
    y_hi), ...]``, at most one slice a mesh position, and the warps of a
    block).  On the card the slices' lanes are whole rounds of
    :func:`kernels.carry_warps` warps a block; on the CPU any lane cuts
    them."""
    dev0 = mesh.devices[0]
    if dev0.type == "cuda":
        sms = torch.cuda.get_device_properties(dev0).multi_processor_count
        warps = kernels.carry_warps(B, LB, sms)
        granule = kernels.slice_granule(warps)
    else:
        warps, granule = 1, 1
    lanes = kernels.slice_lanes(LB, mesh.shape[axis], granule)
    return mesh.devices[:len(lanes)], lanes, warps


class _Slices:
    """The streams of one sequence-parallel fill's slices, one a slice on
    its device, and the edge rows of ``B`` pairs by chunk of ``ca``
    columns between neighbours."""

    def __init__(self, devices, B: int, ca: int):
        self.devices = list(devices)
        self.streams = [torch.cuda.Stream(d) if d.type == "cuda" else None
                        for d in self.devices]
        for d, st in zip(self.devices, self.streams):
            if st is not None:  # after what the caller queued on the device
                st.wait_stream(torch.cuda.current_stream(d))
        self.B, self.ca = B, ca

    def on(self, k: int):
        return on_stream(self.devices[k], self.streams[k])

    def run(self, nch: int, launch) -> dict:
        """``launch(k, c, edge_in, edge_out)`` for every slice k and chunk
        c, in the wavefront's order, each on slice k's stream: ``edge_in``
        the edge row slice k-1 wrote for chunk c (None for slice 0), copied
        to slice k's device after its event, ``edge_out`` a zeroed row for
        slice k+1 (None for the last slice).  Returns the rows written,
        ``{(k, c): row}``; the copies stay referenced until
        :meth:`join`."""
        n = len(self.devices)
        shape = (self.B, 3, self.ca + 1)
        rows, done = {}, {}
        self._keep = []
        for t in range(n + nch - 1):
            for k in range(max(0, t - nch + 1), min(n, t + 1)):
                c = t - k
                with self.on(k):
                    ein = None
                    if k:
                        if done[k - 1, c] is not None:
                            self.streams[k].wait_event(done[k - 1, c])
                        ein = torch.empty(shape, dtype=torch.int32,
                                          device=self.devices[k])
                        ein.copy_(rows[k - 1, c], non_blocking=True)
                        self._keep.append(ein)
                    eout = (torch.zeros(shape, dtype=torch.int32,
                                        device=self.devices[k])
                            if k < n - 1 else None)
                    launch(k, c, ein, eout)
                    ev = None
                    if self.streams[k] is not None:
                        ev = torch.cuda.Event()
                        ev.record(self.streams[k])
                    done[k, c] = ev
                    if eout is not None:
                        rows[k, c] = eout
        return rows

    def join(self):
        """Make each device's current stream wait for the slices on it."""
        for d, st in zip(self.devices, self.streams):
            if st is not None:
                torch.cuda.current_stream(d).wait_stream(st)
        self._keep = []


def _state(sl: _Slices, k: int, sc, bp, host, is_sw: bool):
    """Slice k's inputs on its device (the packed batch ``host``, the
    batch's params ``bp``), and its boundary columns in and out."""
    dev = sl.devices[k]
    with sl.on(k):
        p = kernel_params(sc, dev)
        if bp.sub is not None:
            p = p._replace(sub=bp.sub.to(dev))
        t = [torch.from_numpy(v).to(dev) for v in host]
        bin = boundary_column(p, sl.B, host[1].shape[1], is_sw=is_sw,
                              device=dev)
        return [*t, p], [bin, torch.empty_like(bin)]


def slice_fill(sc: ScoringConfig, host, bp, devices, lanes, warps: int,
               ca: int, *, is_sw: bool = False, dirs: bool = False,
               plain: bool = False):
    """Every chunk of ``ca`` columns of the packed batch ``host`` (ac, bc,
    na, nb as ``pack_batch`` makes them, ``bp`` its params) through one
    slice fill: ``nw_fill_dirs_slice`` with ``dirs``, else
    ``sw_scores_slice`` or ``nw_scores_slice``, slice k holding the lanes
    ``lanes[k]`` on ``devices[k]``, at ``warps`` warps a block; ``plain``
    runs the kernels' plain versions in their place (to check them).
    Slice k fills chunk c after slice k-1 has, each slice carries its
    boundary column from chunk to chunk, and slices on one device share
    its slab.  Returns (the NW corners (B, 3) or SW bests (B,), the max
    over the slices, as numpy; the slab (B, nch, ca+LB-1, LB+1) on the
    first device with the other devices' lanes copied in, or None; the
    edge rows ``{(k, c): row}``)."""
    ac, bc = host[0], host[1]
    B, nch, LB = ac.shape[0], -(-ac.shape[1] // ca), bc.shape[1]
    slabs = {d: torch.zeros((B, nch, ca + LB - 1, LB + 1), dtype=torch.uint8,
                            device=d) for d in dict.fromkeys(devices)
             } if dirs else {}
    sl = _Slices(devices, B, ca)
    names = ("nw_fill_dirs_slice" if dirs else "sw_scores_slice" if is_sw
             else "nw_scores_slice")
    fill = getattr(dp, names + "_plain") if plain else getattr(kernels,
                                                               names)
    state, accs = [], []
    for k in range(len(sl.devices)):
        state.append(_state(sl, k, sc, bp, host, is_sw))
        with sl.on(k):
            accs.append(torch.zeros(B, dtype=torch.int32, device=sl.devices[k])
                        if is_sw else
                        torch.full((B, 3), INT_MIN, dtype=torch.int32,
                                   device=sl.devices[k]))
    at = () if plain else (warps,)

    def launch(k, c, ein, eout):
        args, cols = state[k]
        if dirs:
            fill(*args, c * ca, lanes[k], *at, *cols,
                 slabs[sl.devices[k]][:, c], accs[k], ein, eout)
        else:
            fill(*args, c * ca, ca, lanes[k], *at, *cols, accs[k], ein, eout)
        cols.reverse()  # this chunk's column out is the next one's in

    rows = sl.run(nch, launch)
    sl.join()
    slab = slabs.get(sl.devices[0])
    for (y_lo, y_hi), d in zip(lanes, sl.devices):
        if d != sl.devices[0]:  # the slice's lanes, every row, into slab
            part = slice(y_lo + 1, y_hi + 1)
            slab[..., part].copy_(slabs[d][..., part])
    return np.max([v.cpu().numpy() for v in accs], axis=0), slab, rows


def sp_scores(sc: ScoringConfig, seqs_a, seqs_b, mesh: Mesh,
              axis: str = "seq", *, is_sw: bool = False) -> np.ndarray:
    """Optimal scores (NW, or the SW best) with the lanes split over
    ``mesh[axis]``: (B,) int32, equal to ``score_batch`` /
    ``best_score_batch``.  Default flags with gap_open <= 0 (as the JAX
    package's); any other config goes to ``_scores_auto`` on the mesh's
    first device."""
    sc = from_reference(sc)
    dev0 = mesh.devices[0]
    if sc.gap_open > 0 or not _default_flags(sc) or (
            not is_sw and sc.sentinel_wrap_risk()):
        return np.asarray(aligners._scores_auto(
            sc, kernel_params(sc, dev0), seqs_a, seqs_b, is_sw=is_sw))
    B = len(seqs_a)
    if not B:
        return np.zeros(0, np.int32)
    for a, b in zip(seqs_a, seqs_b):
        check_valid_pairs(sc, a, b)
    la = max(1, max(map(len, seqs_a)))
    lb = max(1, max(map(len, seqs_b)))
    ac, bc, na, nb, bp = pack_batch(sc, kernel_params(sc), seqs_a, seqs_b,
                                    la, lb)
    acc, _, _ = slice_fill(sc, (ac, bc, na, nb), bp,
                           *slice_plan(mesh, axis, B, lb),
                           aligners._long_chunk(la), is_sw=is_sw)
    return acc if is_sw else acc.max(axis=1).astype(np.int32)


def _sp_nw_fill(sc: ScoringConfig, seq_a: str, seq_b: str, mesh: Mesh,
                axis: str, chunk: int):
    """The codes of one NW pair with its lanes split over ``mesh[axis]``,
    in chunks of CA = min(``chunk``, |a| rounded up to 8) columns
    (:func:`slice_fill`).  Returns (slab, corner (1, 3) int32, na, nb) on
    the mesh's first device, and CA."""
    check_valid_pairs(sc, seq_a, seq_b)
    na_i, nb_i = len(seq_a), len(seq_b)
    ac, bc, na, nb, bp = pack_batch(sc, kernel_params(sc), [seq_a], [seq_b],
                                    na_i, nb_i)
    ca = min(int(chunk), -(-na_i // 8) * 8)
    corner, slab, _ = slice_fill(sc, (ac, bc, na, nb), bp,
                                 *slice_plan(mesh, axis, 1, nb_i), ca,
                                 dirs=True)
    return (slab, torch.from_numpy(corner).to(slab.device), na, nb), ca


def sp_align_nw(sc: ScoringConfig, seq_a: str, seq_b: str, mesh: Mesh,
                axis: str = "seq", chunk: int = 2048):
    """Global alignment of one long pair with its lanes split over
    ``mesh[axis]``: each slice fills its lanes' codes chunk by chunk, the
    slices' parts are gathered into one slab on the mesh's first device
    and ``nw_walk`` traces it there.  Equal to ``NeedlemanWunsch.
    align_long``.  Equality scoring with default flags and gap_open <= 0;
    another config, or an empty side, goes to ``align_long`` on the mesh's
    first device."""
    sc = from_reference(sc)
    dev0 = mesh.devices[0]
    if (not mm_eligible(sc) or sc.gap_open > 0 or not _default_flags(sc)
            or sc.sentinel_wrap_risk() or not seq_a or not seq_b):
        return aligners.NeedlemanWunsch(sc, device=dev0).align_long(
            seq_a, seq_b, chunk=chunk)
    (slab, corner, na, nb), _ = _sp_nw_fill(sc, seq_a, seq_b, mesh, axis,
                                            chunk)
    na_t, nb_t = (torch.from_numpy(v).to(dev0) for v in (na, nb))
    ops, score = kernels.nw_walk(slab, corner, na_t, nb_t, int(na[0] + nb[0]))
    return nw_strings_from_ops([seq_a], [seq_b], na, nb, ops.cpu().numpy(),
                               score.cpu().numpy())[0]
