"""Plain PyTorch versions of the fill kernels, global (NW) and local (SW).

A transcription of the JAX package's ``dp.dp_fill`` (seqalign_tpu/ops/
dp.py:126-429), unchunked and chunked, every recurrence mode: a Python loop
over anti-diagonals ``d = x + y`` whose per-step work is one (3, B, LB+1)
update of M, GAP_A and GAP_B, lane = y, in some 14-25 tensor operations
(the scores and flag masks of a block of diagonals taken at once), since
on a GPU each operation costs its launch.  Arithmetic is native int32 and
wraps exactly like the reference's fill.  Two scoring modes: equality on
folded codes (``params.sub`` is None) and substitution-table lookup
``sub[a, b]`` on compact codes.  NW floors at the sentinel
``params.scal[4]`` and fills its boundary with gap runs; SW floors at
``params.scal[5]`` (0), has an all-zero boundary and reduces the best M
over the valid cells.  The bit
word ``params.modes`` carries the scoring flags (``pack.NSG`` .. ``NMM``):
free start gaps zero the boundary runs, free end gaps take the last
column's GAP_A and the last row's GAP_B without penalty or floor, the
no-gaps flags pin GAP_A / GAP_B to the floor off the last column / row and
guard their direction codes, and no-mismatches pins M to the floor where
the pair is not an is-match.  ``sw_sorted_candidates`` harvests SW hit
candidates from an M plane (one chunk's, or the ragged planes of one launch
across widths) where it lies and puts them in the hit order, and
``merge_candidates`` joins the chunks' harvests.
``nw_fill_gab_plain`` / ``sw_fill_gab_plain`` add the M, Ga and Gb planes
of the matrix dump (``dp_fill(emit_gab=True)``), and ``deskew`` turns one
pair's plane into the row-major matrix the CLI prints.
``nw_fill_dirs_plain`` and ``sw_fill_dirs_plain`` also write the codes
(and SW M) as planes at each pair's own widths (``pack.ragged_planes``), as
one fill launch across widths does.

The chunked fill (``bin`` given) is one chunk of a long pair: the columns
x_off+1 .. x_off+CA, with the column x = x_off carried in and the column
x = x_off+CA carried out, codes and M in the chunk-local skew (cell (y, x)
at row x - x_off + y - 2).  ``nw_fill_dirs_carry_plain`` /
``sw_fill_dirs_carry_plain`` are the plain versions of the carry kernels,
and ``fill_chunked`` drives them over a whole pair as the JAX package's
``dp.fill_chunked`` drives ``dp_fill``.

These are the reference the CUDA kernels are held against: the wrappers in
``ops/kernels.py`` call them for CPU tensors, and the tests and
``chip_smoke.py`` compare them with the kernels.  They run on any device.
"""

from __future__ import annotations

import numpy as np
import torch

from .pack import (DIR_FAIL, GAP_A, GAP_B, MATCH, NEG, NGA, NGB, NMM, NSG,
                   KernelParams)


def _fill(ac, bc, na, nb, params: KernelParams, **kw):
    """The fill (``_diagonals``), on the CPU in one thread: its stacked and
    block-wide tensor operations pass PyTorch's grain for intra-op
    threads, and when processes share the cores (the tests' workers) each
    such operation's threads wait for the scheduler, far longer than the
    threads save alone."""
    threads = torch.get_num_threads()
    if ac.device.type != "cpu" or threads == 1:
        return _diagonals(ac, bc, na, nb, params, **kw)
    torch.set_num_threads(1)
    try:
        return _diagonals(ac, bc, na, nb, params, **kw)
    finally:
        torch.set_num_threads(threads)


def _diagonals(ac, bc, na, nb, params: KernelParams, *, is_sw: bool = False,
               emit_dirs: bool = False, m_dtype=None, emit_gab: bool = False,
               x_off: int = 0, bin=None, top=None, edge=None):
    """Returns (dirs, corner, best, mout, bout); dirs/mout are None unless
    asked for (``m_dtype`` set emits M), bout unless chunked.  With
    ``emit_gab`` (unchunked) ``mout`` is instead the (3, B, D, LB+1) int32
    planes of M, Ga and Gb in the skewed layout, the values of
    ``dp_fill(emit_gab=True)`` on the cells 1 <= y <= nb, 1 <= x <= na.

    Chunked (``bin`` a (B, 3, LB+1) int32 column M/Ga/Gb at x = x_off):
    ``ac`` holds the columns x_off+1 .. x_off+LA, column 0 of the chunk is
    ``bin`` (lanes y >= 1) and row 0 the global row-0 cells, computed, not
    carried; ``bout`` is the column x = x_off+LA after the fill (lanes
    y >= 1; lane 0 stays 0), the corner is taken only by the chunk that
    holds x = na (an empty seq_a's by the chunk at x_off = 0), and the
    last-column rules and the no-gaps guards see global x.

    A slice (chunked, ``top`` a (B, 3, LA+1) int32 row): lane 0 is not row
    0 but the lane above the slice, whose M/Ga/Gb by local column 0 .. LA
    ``top`` holds; ``edge`` = (lane, (B, 3, LA+1) int32 tensor) takes that
    lane's values by local column 0 .. LA, in place."""
    B, LA = ac.shape
    chunked = bin is not None
    LB = bc.shape[1]
    LBp = LB + 1
    dev = ac.device
    i32 = torch.int32
    match, mismatch, gap_open, gap_extend, nw_mn, sw_mn = params.scal.unbind()
    mn = sw_mn if is_sw else nw_mn
    gop = gap_open + gap_extend  # gap_open_penalty (alignment.c:38)
    nsg, neg, nga, ngb, nmm = (bool(params.modes & f)
                               for f in (NSG, NEG, NGA, NGB, NMM))
    na = na.to(i32)
    nb = nb.to(i32)
    nax, nbx = na[:, None], nb[:, None]
    zero = torch.zeros_like(mn)
    ylong = torch.arange(LBp, device=dev)[None, :]
    yv = ylong.to(i32)
    a = ac.long()
    b_lane = torch.cat([torch.full((B, 1), -1, dtype=torch.long, device=dev),
                        bc.long()], 1)  # lane y holds b[y-1]
    sub = params.sub
    if sub is not None:
        sub_flat = sub.reshape(-1)
        b_row = b_lane.clamp(min=0)  # lane 0 is overwritten by inject
        kb = sub.shape[1]
        im_flat = params.im.reshape(-1) if nmm else None
    mncol = mn.expand(B, 1)
    mnvec = mn.expand(B, LBp)

    def inject(d, Mv, Gav, Gbv):
        # boundary cells (0, x_off + d) and (d, 0) (alignment.c:51-81): all
        # zero for SW, gap runs beside the sentinel for NW; a chunk's
        # column 0 is the carried one
        at0 = yv == 0
        atd = yv == d
        if chunked:
            Mv, Gav, Gbv = (torch.where(atd, bin[:, k], v)
                            for k, v in enumerate((Mv, Gav, Gbv)))
        if top is not None:  # lane 0 is the slice's edge row in
            if d > LA:  # a column past the chunk: no valid cell reads it
                return Mv, Gav, Gbv
            return tuple(torch.where(at0, top[:, k, d:d + 1], v)
                         for k, v in enumerate((Mv, Gav, Gbv)))
        if is_sw:
            edge = at0 if chunked else at0 | atd
            return tuple(torch.where(edge, mn, v) for v in (Mv, Gav, Gbv))
        # free start gaps: the runs cost nothing (alignment.c:60-63)
        run0 = zero if nsg else gap_open + (x_off + d) * gap_extend
        Mv = torch.where(at0, mn, Mv)
        Gav = torch.where(at0, mn, Gav)
        Gbv = torch.where(at0, run0, Gbv)
        if not chunked:
            run = zero if nsg else gap_open + d * gap_extend
            Mv = torch.where(atd, mn, Mv)
            Gav = torch.where(atd, run, Gav)
            Gbv = torch.where(atd, mn, Gbv)
        return Mv, Gav, Gbv

    nb_idx = nb.long()[:, None]
    # the chunk that takes the corner
    owns = (((na > x_off) & (na <= x_off + LA)) | ((na == 0) & (x_off == 0))
            if chunked else torch.ones_like(na, dtype=torch.bool))

    def corner_at(d, Mv, Gav, Gbv, corner):
        hit = (((na + nb) == d + x_off) & owns)[:, None]
        vals = torch.cat([v.gather(1, nb_idx) for v in (Mv, Gav, Gbv)], 1)
        return torch.where(hit, vals, corner)

    if top is not None:  # diagonal 0 is the edge row's column 0
        pm2, pga2, pgb2 = (torch.where(yv == 0, top[:, k, :1], mn)
                           for k in range(3))
    elif chunked and x_off > 0:  # diagonal 0 is the row-0 cell (0, x_off)
        run0 = zero if (is_sw or nsg) else gap_open + x_off * gap_extend
        pm2, pga2, pgb2 = (torch.where(yv == 0, v, mn).expand(B, LBp)
                           for v in (mn, mn, run0))
    else:
        pm2 = pga2 = pgb2 = torch.where(yv == 0, zero, mn).expand(B, LBp)
    pm1, pga1, pgb1 = inject(1, mnvec, mnvec, mnvec)
    corner = torch.zeros((B, 3), dtype=i32, device=dev)
    best = torch.zeros(B, dtype=i32, device=dev)
    if not is_sw:
        corner = corner_at(0, pm2, pga2, pgb2, corner)
        corner = corner_at(1, pm1, pga1, pgb1, corner)
    if edge is not None and edge[0] == 1:  # the edge lane's column 0
        edge[1][:, :, 0] = torch.stack((pm1, pga1, pgb1), 1)[:, :, 1]
    shape = (B, LA + LB - 1, LBp)
    dirs = (torch.empty(shape, dtype=torch.uint8, device=dev)
            if emit_dirs else None)
    if emit_gab:
        mout = torch.empty((3,) + shape, dtype=i32, device=dev)
    else:
        mout = (torch.empty(shape, dtype=m_dtype, device=dev)
                if m_dtype is not None else None)
    bout = torch.full((B, 3, LBp), 0, dtype=i32, device=dev) \
        if chunked else None

    # The diagonals d = 2 .. LA+LB in blocks of K: a block's scores (and
    # flag masks) at once, then per diagonal M, GAP_A and GAP_B as one
    # (3, B, LB+1) stack, the same sums and maxima as cell by cell
    # (alignment.c:89-155), in the same order, so that int32 wraps alike:
    # M the max3 of the shifted diagonal d-2, then plus the score; GAP_A the
    # max of the shifted diagonal d-1 plus (open, extend, open), GAP_B of
    # the unshifted one plus (open, open, extend); each floored.  The
    # stacks live in a ring of K + 2 slots of LB+2 lanes whose lane 0 holds
    # the floor: a slot's lanes 1.. are the diagonal, its lanes ..LB its
    # shift (lane y taking y-1).  The codes test the three predecessors of
    # each matrix (9 bits) and look the byte up (``_code_lut``); the SW
    # best comes from a block's slots at once.  K keeps a ring near 128 MB.
    ends = LA + LB + 1
    K = max(2, min(64, (1 << 27) // (12 * B * LBp + 1)))
    ring = torch.empty((K + 2, 3, B, LBp + 1), dtype=i32, device=dev)
    ring[:, :, :, 0] = mn
    cur = ring[..., 1:]  # the diagonals; ring[..., :-1] their shifts
    slot = [(cur[j], ring[j, ..., :-1], cur[j, 0], cur[j, 1], cur[j, 2])
            for j in range(K + 2)]
    cur[0] = torch.stack((pm2, pga2, pgb2))
    cur[1] = torch.stack((pm1, pga1, pgb1))
    ta, tb = (torch.empty((3, B, LBp), dtype=i32, device=dev)
              for _ in range(2))
    ca = torch.stack((gop, gap_extend, gop)).view(3, 1, 1)
    cb = torch.stack((gop, gop, gap_extend)).view(3, 1, 1)
    lastrow = yv == nbx  # y == nb
    if neg:  # free end gaps: a gap step on the last column / row is free
        cb = torch.where(lastrow, zero, cb)
        lowest = torch.full_like(mn, torch.iinfo(torch.int32).min)
        floor_b = torch.where(lastrow, lowest, mn)
    if ngb:
        off_row = ~lastrow
        diag_b = (yv == 1) | (yv - 1 == nbx)
        left_b = (yv == 0) | lastrow
    if emit_dirs:
        tm = torch.empty_like(ta)
        e9 = torch.empty((9, B, LBp), dtype=torch.bool, device=dev)
        e9u = e9.view(torch.uint8)
        e_m, e_a, e_b = e9[0:3], e9[3:6], e9[6:9]
        w9 = (1 << torch.arange(9, dtype=i32, device=dev)).view(9, 1, 1)
        lut = _code_lut(dev)
    if not is_sw and top is None:  # the boundary lanes by diagonal
        dr = torch.arange(ends, dtype=i32, device=dev)
        mne = mn.expand(ends)
        run0 = zero.expand(ends) if nsg else \
            gap_open + (x_off + dr) * gap_extend
        run = zero.expand(ends) if nsg else gap_open + dr * gap_extend
        lane0 = torch.stack((mne, mne, run0), 1)[:, :, None].unbind(0)
        lane_d = torch.stack((mne, run, mne), 1)[:, :, None].unbind(0)
    if chunked:
        bin_t = bin.permute(1, 0, 2)
        bout_t = bout.permute(1, 0, 2)
    if top is not None:
        top_t = top.permute(1, 0, 2)
    nb_idx3 = nb_idx[None].expand(3, B, 1)
    corner_t = corner.t().contiguous()
    # the diagonals that hold a corner (x = na, y = nb)
    at_corner = set((na + nb - x_off).tolist()) if not is_sw else ()
    for d0 in range(2, ends, K):
        n = min(K, ends - d0)
        if d0 > 2:  # the block's two diagonals before, into slots 0, 1
            cur[0:2] = cur[K:K + 2].clone()
        dv = torch.arange(d0, d0 + n, device=dev)[:, None]  # (n, 1)
        x_idx = (dv - 1 - ylong).clamp(0, LA - 1)  # a[x-1], (n, LBp)
        a_lane = a.gather(1, x_idx.reshape(1, -1).expand(B, -1)).view(
            B, n, LBp)
        b_blk = b_lane[:, None]
        if sub is None:
            ss_k = torch.where(a_lane == b_blk, match, mismatch).unbind(1)
        else:
            ss_k = sub_flat[a_lane * kb + b_row[:, None]].unbind(1)
        if nmm:  # no mismatches: M only where the pair is an is-match
            if sub is None:
                off_m = (a_lane != b_blk).unbind(1)
            else:
                off_m = (im_flat[a_lane * kb + b_row[:, None]] == 0).unbind(1)
        del a_lane
        if neg or nga:
            gx = (dv - ylong + x_off).to(i32)[:, None]  # global x
            lastcol = gx == nax  # x == na, (n, B, LBp)
        if neg:
            ca_k = torch.where(lastcol[:, None], zero, ca).unbind(0)
            floor_a = torch.where(lastcol, lowest, mn).unbind(0)
        if nga:
            off_col = (~lastcol).unbind(0)
            diag_a = ((gx == 1) | (gx - 1 == nax)).unbind(0)
            up_a = ((gx == 0) | lastcol).unbind(0)
        for k in range(n):
            d = d0 + k
            p1, sh1 = slot[k + 1][:2]
            sh2 = slot[k][1]
            h, _, hm, ha, hb = slot[k + 2]
            ss = ss_k[k]
            torch.amax(sh2, 0, out=hm)
            hm += ss
            torch.add(sh1, ca_k[k] if neg else ca, out=ta)
            torch.amax(ta, 0, out=ha)
            torch.add(p1, cb, out=tb)
            torch.amax(tb, 0, out=hb)
            if neg:
                torch.maximum(hm, mn, out=hm)
                torch.maximum(ha, floor_a[k], out=ha)
                torch.maximum(hb, floor_b, out=hb)
            else:
                torch.maximum(h, mn, out=h)
            if nmm:
                hm.masked_fill_(off_m[k], mn)
            if nga:  # GAP_A only on the last column (alignment.c:131)
                ha.masked_fill_(off_col[k], mn)
            if ngb:
                hb.masked_fill_(off_row, mn)
            if emit_dirs:
                torch.add(sh2, ss, out=tm)
                torch.eq(tm, hm, out=e_m)
                torch.eq(ta, ha, out=e_a)
                torch.eq(tb, hb, out=e_b)
                # a no-gaps matrix is a predecessor only at its boundary
                # coordinates (alignment.c:312-314, 319-321)
                if nga:
                    e9[1::6] &= diag_a[k]
                    e9[4] &= up_a[k]
                if ngb:
                    e9[2:6:3] &= diag_b
                    e9[8] &= left_b
                dirs[:, d - 2] = lut[(e9u * w9).sum(0)]
            if emit_gab:
                mout[:, :, d - 2] = h
            elif mout is not None:
                mout[:, d - 2] = hm
            # boundary cells (0, x_off + d) and (d, 0) (alignment.c:51-81)
            if chunked and d < LBp:
                h[:, :, d] = bin_t[:, :, d]
            if top is not None:
                if d <= LA:
                    h[:, :, 0] = top_t[:, :, d]
            elif is_sw:
                h[:, :, 0] = mn
                if not chunked and d < LBp:
                    h[:, :, d] = mn
            else:
                h[:, :, 0] = lane0[d]
                if not chunked and d < LBp:
                    h[:, :, d] = lane_d[d]
            if d in at_corner:
                hit = ((na + nb) == d + x_off) & owns
                torch.where(hit, h.gather(2, nb_idx3)[..., 0], corner_t,
                            out=corner_t)
            if chunked and 1 <= d - LA < LBp:  # the chunk's last column
                bout_t[:, :, d - LA] = h[:, :, d - LA]
            if edge is not None and 0 <= d - edge[0] <= LA:
                edge[1][:, :, d - edge[0]] = h[:, :, edge[0]].t()
        if is_sw:  # the best M over the block's valid cells
            xv = dv - ylong  # (n, LBp)
            valid = ((ylong >= 1) & (xv >= 1) & (xv <= LA))[:, None] \
                & (yv <= nbx) & ((xv + x_off)[:, None] <= nax)
            best = torch.maximum(best, torch.where(
                valid, cur[2:n + 2, 0], mn).amax((0, 2)))
    if not is_sw:
        corner = corner_t.t().contiguous()
    return dirs, corner, best, mout, bout


def _code_lut(dev):
    """The code byte ``dm | dga << 2 | dgb << 4`` of each 9-bit set of
    predecessor tests, bits 0-2 M's, 3-5 GAP_A's, 6-8 GAP_B's, each three
    the tests of the (M, GAP_A, GAP_B) predecessor: a matrix's code is
    GAP_A, then GAP_B, then MATCH, by priority (alignment.c:311-327), and
    DIR_FAIL when no test holds."""
    def pick(bits):
        return (GAP_A if bits & 2 else GAP_B if bits & 4
                else MATCH if bits & 1 else DIR_FAIL)

    return torch.tensor([pick(i & 7) | pick(i >> 3 & 7) << 2
                         | pick(i >> 6) << 4 for i in range(512)],
                        dtype=torch.uint8, device=dev)


def nw_scores_plain(ac, bc, na, nb, params: KernelParams):
    """NW scores of a padded batch: ``ac`` (B, LA) and ``bc`` (B, LB) uint8
    codes (folded bytes, or compact codes when ``params.sub`` is set),
    ``na``/``nb`` (B,) int32 true lengths.  Returns ``(scores (B,) int32,
    corner (B, 3) int32)``, corner = M/Ga/Gb at (nb, na)."""
    corner = _fill(ac, bc, na, nb, params)[1]
    return corner.max(dim=1).values, corner


def nw_fill_dirs_plain(ac, bc, na, nb, params: KernelParams, off=None):
    """The NW fill with direction codes: returns ``(dirs, corner)``, dirs
    (B, LA+LB-1, LB+1) uint8 with cell (y, x) at ``[x+y-2, y]`` and code
    ``dm | dga << 2 | dgb << 4``.  Only cells 1 <= y <= nb, 1 <= x <= na
    are defined.  With ``off`` ((B+1,) int64, ``pack.ragged_planes``)
    dirs is instead 1-d, each pair's plane at its own widths from
    ``off[j]``: the padded fill's planes cut to those widths."""
    dirs, corner = _fill(ac, bc, na, nb, params, emit_dirs=True)[:2]
    return _planes(dirs, na, nb, off), corner


def _planes(t, na, nb, off):
    """The uniform (B, LA+LB-1, LB+1) planes ``t`` cut to each pair's own
    widths and laid end to end from ``off[j]`` (``pack.ragged_planes``), a
    1-d tensor; ``t`` itself when ``off`` is None.  Pad cells are copied
    as they are: only the valid cells are defined."""
    if off is None:
        return t
    off = off.tolist()
    flat = torch.empty(off[-1], dtype=t.dtype, device=t.device)
    for j, (n_a, n_b) in enumerate(zip(na.tolist(), nb.tolist())):
        wa, wb = max(n_a, 1), max(n_b, 1)
        flat[off[j]:off[j + 1]] = t[j, :wa + wb - 1, :wb + 1].reshape(-1)
    return flat


def sw_scores_plain(ac, bc, na, nb, params: KernelParams):
    """SW best scores of a padded batch (inputs as ``nw_scores_plain``):
    the max of M over the valid cells, (B,) int32, 0 for an empty side."""
    return _fill(ac, bc, na, nb, params, is_sw=True)[2]


def sw_fill_dirs_plain(ac, bc, na, nb, params: KernelParams,
                       m16: bool = False, off=None):
    """The SW fill with direction codes and the M matrix: returns
    ``(dirs, M)``, both (B, LA+LB-1, LB+1) in the skewed layout of
    ``nw_fill_dirs_plain``; M is int16 when ``m16`` (callers check
    ``pack.m16_safe``), else int32.  Only cells 1 <= y <= nb,
    1 <= x <= na are defined.  With ``off`` both are 1-d, each pair's
    planes at its own widths from ``off[j]``, as ``nw_fill_dirs_plain``
    lays out the codes, and every other cell of M holds 0, as the
    kernel's zeroed M does."""
    dirs, _, _, mout, _ = _fill(ac, bc, na, nb, params, is_sw=True,
                                emit_dirs=True,
                                m_dtype=torch.int16 if m16 else torch.int32)
    if off is not None:
        B, D, LBp = mout.shape
        r = torch.arange(D, device=mout.device)[None, :, None]
        y = torch.arange(LBp, device=mout.device)[None, None, :]
        na_c, nb_c = (v.long()[:, None, None] for v in (na, nb))
        mout = mout.masked_fill(~((y >= 1) & (y <= nb_c) & (r >= y - 1)
                                  & (r <= y - 2 + na_c)), 0)
    return _planes(dirs, na, nb, off), _planes(mout, na, nb, off)


def nw_fill_gab_plain(ac, bc, na, nb, params: KernelParams):
    """The NW fill with direction codes and the three matrices, for the
    matrix dump: returns ``(dirs, corner, gab)``, dirs and corner as
    ``nw_fill_dirs_plain``, gab (3, B, LA+LB-1, LB+1) int32 the M, Ga and
    Gb planes in the same skewed layout (:func:`deskew` reads them).  Only
    cells 1 <= y <= nb, 1 <= x <= na are defined."""
    dirs, corner, _, gab, _ = _fill(ac, bc, na, nb, params, emit_dirs=True,
                                    emit_gab=True)
    return dirs, corner, gab


def sw_fill_gab_plain(ac, bc, na, nb, params: KernelParams):
    """The SW fill with direction codes and the three matrices: returns
    ``(dirs, gab)`` in the layouts of ``nw_fill_gab_plain``; ``gab[0]`` is
    the int32 M plane the hit harvest reads."""
    dirs, _, _, gab, _ = _fill(ac, bc, na, nb, params, is_sw=True,
                               emit_dirs=True, emit_gab=True)
    return dirs, gab


def deskew(skewed, na: int, nb: int, fill=0):
    """One pair's skewed (D, LB+1) plane back to row-major (nb+1, na+1)
    [y][x] (seqalign_tpu/ops/dp.py:850-859), on the plane's device: cell
    (y, x) is ``skewed[x + y - 2, y]``.  Row 0 and column 0 hold ``fill``;
    the caller writes the closed-form boundary."""
    out = torch.full((nb + 1, na + 1), fill, dtype=skewed.dtype,
                     device=skewed.device)
    if na and nb:
        y = torch.arange(1, nb + 1, device=skewed.device)[:, None]
        x = torch.arange(1, na + 1, device=skewed.device)[None, :]
        out[1:, 1:] = skewed[x + y - 2, y]
    return out


def _chunk_columns(ac, x_off: int, ca: int):
    """The columns x_off+1 .. x_off+ca of ``ac``, zero-padded to ``ca``."""
    cols = ac[:, x_off:x_off + ca]
    if cols.shape[1] < ca:
        cols = torch.nn.functional.pad(cols, (0, ca - cols.shape[1]))
    return cols


def _carry(ac, bc, na, nb, params, x_off, bin, bout, dirs, *, is_sw,
           m_dtype=None):
    """One chunk by the plain fill, its outputs written where the carry
    kernel writes them: the codes of the pairs that reach the chunk into
    ``dirs`` (B, CA+LB-1, LB+1), ``bout`` for the pairs that reach its
    last column.  Returns the fill's (corner, best, mout)."""
    ca = dirs.shape[1] - dirs.shape[2] + 2
    d, corner, best, mout, bo = _fill(
        _chunk_columns(ac, x_off, ca), bc, na, nb, params, is_sw=is_sw,
        emit_dirs=True, m_dtype=m_dtype, x_off=x_off, bin=bin)
    na = na.long()
    reach = na > x_off
    dirs[reach] = d[reach]
    full = na >= x_off + ca
    bout[full, :, 1:] = bo[full, :, 1:]
    return corner, best, mout


def nw_fill_dirs_carry_plain(ac, bc, na, nb, params: KernelParams,
                             x_off: int, bin, bout, dirs, corner):
    """One chunk of a long NW pair, in place (the carry kernel's
    contract): ``ac`` (B, LA) and ``bc`` (B, LB) the whole pairs' codes,
    ``bin`` (B, 3, LB+1) int32 the column x = x_off (M, Ga, Gb by lane);
    fills the columns x_off+1 .. x_off+CA, with CA = D_c - LB + 1 from
    ``dirs`` (B, D_c, LB+1) uint8, which gets the chunk's codes (cell
    (y, x) at row x - x_off + y - 2).  ``bout`` gets the column x_off+CA
    (lanes 1 .. nb) of the pairs that reach it, ``corner`` (B, 3) the
    corner of the pairs whose x = na is in the chunk.  A pair with
    na <= x_off is left as it was."""
    c, _, _ = _carry(ac, bc, na, nb, params, x_off, bin, bout, dirs,
                     is_sw=False)
    ca = dirs.shape[1] - dirs.shape[2] + 2
    na = na.long()
    owns = ((na > x_off) & (na <= x_off + ca)) | ((na == 0) & (x_off == 0))
    corner[owns] = c[owns]


def sw_fill_dirs_carry_plain(ac, bc, na, nb, params: KernelParams,
                             x_off: int, bin, bout, dirs, best,
                             m16: bool = False):
    """One chunk of a long SW pair, in place (inputs and ``dirs``/``bout``
    as ``nw_fill_dirs_carry_plain``): ``best`` (B,) int32 is raised to the
    chunk's best M.  Returns the chunk's M (B, D_c, LB+1), int16 when
    ``m16``, else int32, in the layout of ``dirs``."""
    _, b, mout = _carry(ac, bc, na, nb, params, x_off, bin, bout, dirs,
                        is_sw=True,
                        m_dtype=torch.int16 if m16 else torch.int32)
    torch.maximum(best, b, out=best)
    return mout


def _slice(ac, bc, na, nb, params, x_off, ca, lanes, bin, bout, edge_in,
           edge_out, *, is_sw, dirs=None):
    """One chunk of one slice of the pairs' lanes by the plain fill, its
    outputs written where the slice kernels write them: the fill of lanes
    y_lo .. y_hi (``lanes``, y_hi cut to LB) as a chunk whose lane 0 is the
    lane y_lo, row 0 for the first slice (y_lo = 0), else the edge row
    ``edge_in`` (B, 3, ca+1).  Writes the valid cells' codes into ``dirs``
    (B, ca+LB-1, LB+1) at their global lanes and rows (when given), the
    column x_off+ca of the slice's lanes into ``bout`` for the pairs that
    reach it, and the lane y_hi by local column 0 .. min(ca, na - x_off)
    into ``edge_out`` for the pairs with lanes past the slice.  Returns the
    fill's (corner, best): the corner at the slice's local lane nb - y_lo,
    defined for the pairs whose lane nb and column na the chunk and slice
    hold."""
    LB = bc.shape[1]
    y_lo, y_hi = int(lanes[0]), min(int(lanes[1]), LB)
    n = y_hi - y_lo
    nb_loc = (nb.long() - y_lo).clamp(0, n).to(torch.int32)
    e = None
    if edge_out is not None:
        e = torch.empty_like(edge_out)
    d, corner, best, _, bo = _fill(
        _chunk_columns(ac, x_off, ca), bc[:, y_lo:y_hi], na, nb_loc, params,
        is_sw=is_sw, emit_dirs=dirs is not None, x_off=x_off,
        bin=bin[:, :, y_lo:y_hi + 1], top=edge_in if y_lo else None,
        edge=None if e is None else (n, e))
    na = na.long()
    wa = (na - x_off).clamp(0, ca)
    if dirs is not None:  # the valid cells, at their global row and lane
        r = torch.arange(d.shape[1], device=d.device)[None, :, None]
        yl = torch.arange(n + 1, device=d.device)[None, None, :]
        x = r + 2 - yl
        valid = ((yl >= 1) & (yl <= nb_loc.long()[:, None, None]) & (x >= 1)
                 & (x <= wa[:, None, None]))
        j, r, yl = valid.nonzero(as_tuple=True)
        dirs[j, r + y_lo, yl + y_lo] = d[j, r, yl]
    full = na >= x_off + ca
    bout[full, :, y_lo + 1:y_hi + 1] = bo[full, :, 1:n + 1]
    if e is not None:
        past = (nb.long() > y_hi) & (wa > 0)
        col = torch.arange(ca + 1, device=e.device)[None, None, :]
        keep = past[:, None, None] & (col <= wa[:, None, None])
        edge_out.copy_(torch.where(keep, e, edge_out))
    return corner, best


def _slice_corner(params, na, nb, x_off, ca, lanes, bin, c, corner):
    """The NW corners a slice's chunk writes into ``corner``: ``c`` (the
    fill's, :func:`_slice`) for the pairs whose column na the chunk holds
    and lane nb the slice holds; the first slice (y_lo = 0) also writes the
    corners of empty sides, as the carry's round 0 does: an empty seq_a's
    from ``bin`` at lane nb in the chunk at x_off = 0, an empty seq_b's as
    the row-0 cell (0, na)."""
    y_lo, y_hi = int(lanes[0]), int(lanes[1])
    na, nb = na.long(), nb.long()
    col = (na > x_off) & (na <= x_off + ca)
    own = col & (nb > y_lo) & (nb <= y_hi)
    corner[own] = c[own]
    if y_lo == 0:
        _, _, go, ge, mn, _ = params.scal.tolist()
        empty_b = col & (nb == 0)
        if empty_b.any():
            run = (go + na[empty_b] * ge).to(torch.int32)  # wraps as int32
            corner[empty_b] = torch.stack(
                (torch.full_like(run, mn), torch.full_like(run, mn), run), 1)
        if x_off == 0:
            empty_a = na == 0
            idx = nb[empty_a].clamp(max=bin.shape[2] - 1)
            corner[empty_a] = bin[empty_a, :, :].gather(
                2, idx[:, None, None].expand(-1, 3, 1))[:, :, 0]


def nw_fill_dirs_slice_plain(ac, bc, na, nb, params: KernelParams,
                             x_off: int, lanes, bin, bout, dirs, corner,
                             edge_in=None, edge_out=None):
    """One chunk of one slice of a long NW pair's lanes, in place (the
    slice kernel's contract, S2): as ``nw_fill_dirs_carry_plain`` on the
    lanes y_lo+1 .. y_hi of ``lanes`` alone, their valid cells' codes into
    the ``dirs`` slab (B, D_c, LB+1) at slab.cuh's rule, ``bout`` at those
    lanes; the lane above the slice from ``edge_in`` (B, 3, CA+1) when
    y_lo > 0, the lane y_hi into ``edge_out`` (B, 3, CA+1) for the pairs
    with lanes past it (columns 0 .. min(CA, na - x_off)); ``corner`` (B,
    3) of the pairs whose corner the slice and chunk hold."""
    ca = dirs.shape[1] - dirs.shape[2] + 2
    c, _ = _slice(ac, bc, na, nb, params, x_off, ca, lanes, bin, bout,
                  edge_in, edge_out, is_sw=False, dirs=dirs)
    _slice_corner(params, na, nb, x_off, ca, lanes, bin, c, corner)


def nw_scores_slice_plain(ac, bc, na, nb, params: KernelParams, x_off: int,
                          ca: int, lanes, bin, bout, corner, edge_in=None,
                          edge_out=None):
    """One chunk of ``ca`` columns of one slice of a batch's lanes, NW
    scores only (S1): ``nw_fill_dirs_slice_plain`` without the codes."""
    c, _ = _slice(ac, bc, na, nb, params, x_off, ca, lanes, bin, bout,
                  edge_in, edge_out, is_sw=False)
    _slice_corner(params, na, nb, x_off, ca, lanes, bin, c, corner)


def sw_scores_slice_plain(ac, bc, na, nb, params: KernelParams, x_off: int,
                          ca: int, lanes, bin, bout, best, edge_in=None,
                          edge_out=None):
    """One chunk of one slice of a batch's lanes, SW scores only (S1):
    ``best`` (B,) int32 raised to the best M of the slice's valid cells in
    the chunk."""
    _, b = _slice(ac, bc, na, nb, params, x_off, ca, lanes, bin, bout,
                  edge_in, edge_out, is_sw=True)
    torch.maximum(best, b, out=best)


def boundary_column(params: KernelParams, B: int, LB: int, *, is_sw: bool,
                    device=None):
    """The column x = 0 that enters a long pair's first chunk, (B, 3,
    LB+1) int32 (alignment.c:51-81): all zero for SW; for NW (0, 0, 0) at
    y = 0 (a lane no chunk reads), then M = Gb = the floor and Ga =
    gap_open + y * gap_extend (0 under free start gaps)."""
    dev = params.scal.device if device is None else device
    col = torch.zeros((B, 3, LB + 1), dtype=torch.int32, device=dev)
    if is_sw:
        return col
    go, ge, mn = (int(v) for v in params.scal[[2, 3, 4]].tolist())
    y = torch.arange(1, LB + 1, dtype=torch.int64, device=dev)
    run = torch.zeros_like(y) if params.modes & NSG else go + y * ge
    col[:, 0, 1:] = mn
    col[:, 1, 1:] = run.to(torch.int32)
    col[:, 2, 1:] = mn
    return col


def fill_chunked(ac, bc, na, nb, params: KernelParams, *, is_sw: bool,
                 chunk: int, m16: bool = False, extract_min=None):
    """A whole long-pair fill by the plain carry, chunk by chunk: the
    port's counterpart of the JAX package's ``dp.fill_chunked``
    (seqalign_tpu/ops/dp.py:665-766), with the same returns, on packed
    tensors.  ``ac`` (B, LA), ``bc`` (B, LB), ``na``/``nb`` (B,) int32.
    Returns ``(corner (B, 3), best (B,), dirs_chunks, m_chunks, na, nb)``:
    ``dirs_chunks`` / ``m_chunks`` the chunks' (B, chunk+LB-1, LB+1) slabs
    (M only for SW; int16 when ``m16``).  With ``extract_min`` the M slabs
    are harvested chunk by chunk (``sw_sorted_candidates``) and
    ``m_chunks`` is instead each pair's ``(flats int64, scores int32)``
    host arrays, in the hit order."""
    B, LA = ac.shape
    LB = bc.shape[1]
    nch = max(1, -(-LA // chunk))
    dev = ac.device
    bin = boundary_column(params, B, LB, is_sw=is_sw, device=dev)
    bout = torch.empty_like(bin)
    corner = torch.zeros((B, 3), dtype=torch.int32, device=dev)
    best = torch.zeros(B, dtype=torch.int32, device=dev)
    na_h, nb_h = na.cpu().numpy(), nb.cpu().numpy()
    dirs_chunks, m_chunks, parts = [], [], []
    for c in range(nch):
        dirs = torch.zeros((B, chunk + LB - 1, LB + 1), dtype=torch.uint8,
                           device=dev)
        if is_sw:
            m = sw_fill_dirs_carry_plain(ac, bc, na, nb, params, c * chunk,
                                         bin, bout, dirs, best, m16)
            if extract_min is None:
                m_chunks.append(m)
            else:
                parts.append(sw_sorted_candidates(m, na_h, nb_h, extract_min,
                                                  x_off=c * chunk))
        else:
            nw_fill_dirs_carry_plain(ac, bc, na, nb, params, c * chunk, bin,
                                     bout, dirs, corner)
        dirs_chunks.append(dirs)
        bin, bout = bout, bin
    if extract_min is not None:
        flat, score, off = merge_candidates(parts, B)
        flat, score, off = (flat.cpu().numpy().astype(np.int64),
                            score.cpu().numpy(), off.tolist())
        m_chunks = [(flat[s:e], score[s:e])
                    for s, e in zip(off[:-1], off[1:])]
    return corner, best, dirs_chunks, m_chunks, na, nb


def sw_sorted_candidates(mmat, na, nb, min_scores, x_off: int = 0,
                         off=None):
    """SW hit candidates of a skewed M batch (B, D, LB+1), harvested and
    ordered where M lies (dp.sw_extract_candidates plus the hit iterator's
    sort): the cells 1 <= y <= nb, 1 <= x <= na with M >= max(min_score,
    1), each pair's in the reference's order, score descending, then x,
    then flat ascending (smith_waterman.c:71-86).  Plain tensor ops: a
    mask, ``nonzero`` and two stable sorts, within the pairs and then by
    pair.  ``na``, ``nb`` and ``min_scores`` are (B,) host arrays;
    ``min_scores`` may be a scalar.  A chunk's M slab takes its ``x_off``:
    its width is CA = D - LB + 1, its cell (y, x) sits at row
    x - x_off + y - 2, and only its own columns x_off+1 .. x_off+CA pass
    (the skew pad past them holds no cell of the chunk).  With ``off``
    ((B+1,) int64 tensor, ``pack.ragged_planes``) M is instead the 1-d
    planes of one launch across widths, every cell but the valid ones 0
    (:func:`_sorted_ragged`).  Returns, on M's
    device, ``(flat (N,), score int32 (N,), offsets int64 (B+1,))``: pair
    j's candidates are ``[offsets[j], offsets[j+1])``, flat = y * (na+1) + x
    with global x, int32 when every pair has (na+1)(nb+1) < 2^31 cells, else
    int64 so that a long pair's flats do not wrap."""
    if off is not None:
        return _sorted_ragged(mmat, na, nb, min_scores, off)
    B, D, LBp = mmat.shape
    ca = D - LBp + 2
    dev = mmat.device
    thr = np.maximum(np.broadcast_to(np.asarray(min_scores, np.int64), (B,)),
                     1)

    def col(v):
        return torch.from_numpy(np.ascontiguousarray(v, np.int32)).to(dev)

    na_t, nb_t = col(na), col(nb)
    r = torch.arange(D, dtype=torch.int32, device=dev)[None, :, None]
    y = torch.arange(LBp, dtype=torch.int32, device=dev)[None, None, :]
    m = mmat >= col(np.minimum(thr, np.iinfo(np.int32).max))[:, None, None]
    m &= (y >= 1) & (y <= nb_t[:, None, None])
    m &= r >= y - 1  # x >= 1
    # x <= min(CA, na - x_off), local
    wa = (na_t - x_off).clamp(max=ca)
    m &= r <= y - 2 + wa[:, None, None]
    idx = m.view(-1).nonzero()[:, 0]
    del m
    score = mmat.view(-1)[idx].to(torch.int32)
    pair, pos = idx.div(D * LBp, rounding_mode="floor"), idx % (D * LBp)
    del idx
    yy = pos % LBp
    xx = pos.div(LBp, rounding_mode="floor") + 2 - yy  # local x
    del pos
    # (-score, x, y) within a pair is (-score, x, flat): one int64 key
    return _in_hit_order(-score.long() * ((D + 2) * LBp) + xx * LBp + yy,
                         pair, xx + x_off, yy, score, na_t, na, nb)


def _in_hit_order(key, pair, xx, yy, score, na_t, na, nb):
    """The harvested candidates (their pair, global x, y and score) in the
    hit order: by ``key``, (-score, x, y) within a pair, then by pair, both
    sorts stable.  ``na_t``: the pairs' lengths on the candidates' device.
    Returns ``(flat, score, offsets)`` as :func:`sw_sorted_candidates`."""
    order = torch.sort(key, stable=True).indices
    del key
    order = order[torch.sort(pair[order], stable=True).indices]
    pair, xx, yy, score = pair[order], xx[order], yy[order], score[order]
    flat = yy * (na_t.long()[pair] + 1) + xx
    if _flats_fit_int32(na, nb):
        flat = flat.int()
    offsets = torch.zeros(len(na) + 1, dtype=torch.int64,
                          device=score.device)
    offsets[1:] = torch.bincount(pair, minlength=len(na)).cumsum(0)
    return flat, score, offsets


def _sorted_ragged(mflat, na, nb, min_scores, off):
    """:func:`sw_sorted_candidates` on the 1-d M planes of one launch
    across widths, whose cells that are no valid cell of their pair hold 0
    (``sw_fill_dirs`` and its plain version under a schedule leave them
    so): one ``ge`` for each run of pairs that share a threshold (>= 1, so
    that no such cell passes), one ``nonzero``, each index's pair by its
    plane's offsets, then the two stable sorts."""
    dev = mflat.device
    na = np.asarray(na, np.int64)
    nb = np.asarray(nb, np.int64)
    B = len(na)
    offs = off.tolist()
    thr = np.minimum(np.maximum(np.broadcast_to(
        np.asarray(min_scores, np.int64), (B,)), 1),
        torch.iinfo(mflat.dtype).max)
    mask = torch.empty(mflat.shape[0], dtype=torch.bool, device=dev)
    starts = np.flatnonzero(np.diff(thr, prepend=0)).tolist()
    for s, e in zip(starts, starts[1:] + [B]):
        torch.ge(mflat[offs[s]:offs[e]], int(thr[s]),
                 out=mask[offs[s]:offs[e]])
    idx = mask.nonzero()[:, 0]
    del mask
    score = mflat[idx].to(torch.int32)
    off_t = off.to(dev)
    pair = torch.searchsorted(off_t, idx, right=True) - 1
    pos = idx - off_t[pair]
    del idx
    na_t = torch.from_numpy(na).to(dev)
    lanes = torch.from_numpy(np.maximum(nb, 1) + 1).to(dev)[pair]
    yy = pos % lanes
    xx = pos.div(lanes, rounding_mode="floor") + 2 - yy
    del pos
    # (-score, x, y) within a pair is (-score, x, flat): one int64 key of
    # the pair's own span
    return _in_hit_order(-score.long() * ((na_t[pair] + 1) * lanes)
                         + xx * lanes + yy, pair, xx, yy, score, na_t, na,
                         nb)


def _flats_fit_int32(na, nb) -> bool:
    """True when every pair's flats y * (na+1) + x fit in int32: (na+1) *
    (nb+1) < 2^31 for each (host arrays)."""
    na = np.asarray(na, np.int64)
    nb = np.asarray(nb, np.int64)
    return not len(na) or int(((na + 1) * (nb + 1)).max()) <= 2 ** 31 - 1


def merge_candidates(parts, B: int):
    """The candidates of a long pair's chunks, each ``(flat, score,
    offsets)`` of :func:`sw_sorted_candidates` in chunk order, in one hit
    order: every pair's by score descending, then x, then flat.  A chunk
    holds smaller x than the chunks after it and is itself in that order,
    so one stable sort on (pair, -score) of the chunks laid end to end
    does it, on int32 keys when they fit.  The list ``parts`` is emptied
    as the chunks are joined, so that each chunk's tensors go as soon as
    they are copied.  Returns ``(flat int64, score int32, offsets int64
    (B+1,))`` as :func:`sw_sorted_candidates` does."""
    if len(parts) == 1:
        return parts.pop()
    dev = parts[0][0].device
    counts = sum(off[1:] - off[:-1] for _, _, off in parts)
    top = max(int(s.max()) if len(s) else 0 for _, s, _ in parts)
    span = top + 1  # scores are 1 .. top
    pair_ids = torch.arange(B, device=dev)
    key = torch.cat([torch.repeat_interleave(pair_ids, off[1:] - off[:-1])
                     * span + (top - s.long()) for _, s, off in parts])
    if B * span < 2 ** 31:
        key = key.int()
    order = torch.sort(key, stable=True).indices
    del key
    flats, scores = [p[0] for p in parts], [p[1] for p in parts]
    parts.clear()
    flat = torch.cat(flats)
    del flats
    flat = flat[order]
    score = torch.cat(scores)[order]
    del scores, order
    offsets = torch.zeros(B + 1, dtype=torch.int64, device=dev)
    offsets[1:] = counts.cumsum(0)
    return flat, score, offsets


def sw_extract_candidates(mmat, na, nb, min_scores):
    """:func:`sw_sorted_candidates` on the host, as the JAX package's
    ``dp.sw_extract_candidates`` returns them: a list of per-pair ``(flats
    int64, scores int32)`` numpy arrays (here already in the hit
    iterator's order)."""
    flat, score, offsets = sw_sorted_candidates(mmat, na, nb, min_scores)
    flat = flat.cpu().numpy().astype(np.int64)
    score = score.cpu().numpy()
    off = offsets.tolist()
    return [(flat[s:e], score[s:e]) for s, e in zip(off[:-1], off[1:])]
