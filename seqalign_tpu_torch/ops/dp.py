"""Plain PyTorch versions of the fill kernels, global (NW) and local (SW).

A transcription of the JAX package's ``dp.dp_fill`` (seqalign_tpu/ops/
dp.py:126-429) in its unchunked case, every recurrence mode: a Python loop
over anti-diagonals ``d = x + y`` whose per-step work is a (B, LB+1)
vector update, lane = y.  Arithmetic is native int32 and wraps exactly
like the reference's fill.  Two scoring modes: equality on folded codes
(``params.sub`` is None) and substitution-table lookup ``sub[a, b]`` on
compact codes.  NW floors at the sentinel ``params.scal[4]`` and fills its
boundary with gap runs; SW floors at ``params.scal[5]`` (0), has an
all-zero boundary and reduces the best M over the valid cells.  The bit
word ``params.modes`` carries the scoring flags (``pack.NSG`` .. ``NMM``):
free start gaps zero the boundary runs, free end gaps take the last
column's GAP_A and the last row's GAP_B without penalty or floor, the
no-gaps flags pin GAP_A / GAP_B to the floor off the last column / row and
guard their direction codes, and no-mismatches pins M to the floor where
the pair is not an is-match.  ``sw_sorted_candidates`` harvests SW hit
candidates from an M plane where it lies and puts them in the hit order.

These are the reference the CUDA kernels are held against: the wrappers in
``ops/kernels.py`` call them for CPU tensors, and the tests and
``chip_smoke.py`` compare them with the kernels.  They run on any device.
"""

from __future__ import annotations

import numpy as np
import torch

from .pack import (DIR_FAIL, GAP_A, GAP_B, MATCH, NEG, NGA, NGB, NMM, NSG,
                   KernelParams)


def _fill(ac, bc, na, nb, params: KernelParams, *, is_sw: bool = False,
          emit_dirs: bool = False, m_dtype=None):
    """Returns (dirs, corner, best, mout); dirs/mout are None unless asked
    for (``m_dtype`` set emits M)."""
    B, LA = ac.shape
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
        # boundary cells (0, d) and (d, 0) (alignment.c:51-81): all zero
        # for SW, gap runs beside the sentinel for NW
        at0 = yv == 0
        atd = yv == d
        if is_sw:
            edge = at0 | atd
            return tuple(torch.where(edge, mn, v) for v in (Mv, Gav, Gbv))
        # free start gaps: the runs cost nothing (alignment.c:60-63)
        run = zero if nsg else gap_open + d * gap_extend
        Mv = torch.where(at0 | atd, mn, Mv)
        Gav = torch.where(at0, mn, torch.where(atd, run, Gav))
        Gbv = torch.where(at0, run, torch.where(atd, mn, Gbv))
        return Mv, Gav, Gbv

    nb_idx = nb.long()[:, None]

    def corner_at(d, Mv, Gav, Gbv, corner):
        hit = ((na + nb) == d)[:, None]
        vals = torch.cat([v.gather(1, nb_idx) for v in (Mv, Gav, Gbv)], 1)
        return torch.where(hit, vals, corner)

    m0 = torch.where(yv == 0, zero, mn).expand(B, LBp)
    pm2 = pga2 = pgb2 = m0
    pm1, pga1, pgb1 = inject(1, mnvec, mnvec, mnvec)
    corner = torch.zeros((B, 3), dtype=i32, device=dev)
    best = torch.zeros(B, dtype=i32, device=dev)
    if not is_sw:
        corner = corner_at(0, pm2, pga2, pgb2, corner)
        corner = corner_at(1, pm1, pga1, pgb1, corner)
    shape = (B, LA + LB - 1, LBp)
    dirs = (torch.empty(shape, dtype=torch.uint8, device=dev)
            if emit_dirs else None)
    mout = (torch.empty(shape, dtype=m_dtype, device=dev)
            if m_dtype is not None else None)

    def sh(v):  # the value at lane y-1
        return torch.cat([mncol, v[:, :-1]], 1)

    def max3(p, q, r):
        return torch.maximum(p, torch.maximum(q, r))

    def pick(ga_ok, gb_ok, m_ok):
        # guard -> equality -> priority GAP_A, GAP_B, MATCH
        # (alignment.c:311-327)
        return torch.where(ga_ok, GAP_A, torch.where(
            gb_ok, GAP_B, torch.where(m_ok, MATCH, DIR_FAIL)))

    for d in range(2, LA + LB + 1):
        x_idx = (d - 1 - ylong).clamp(0, LA - 1).expand(B, LBp)  # a[x-1]
        a_lane = a.gather(1, x_idx)
        if sub is None:
            ss = torch.where(a_lane == b_lane, match, mismatch)
        else:
            ss = sub_flat[a_lane * kb + b_row]
        m2s, ga2s, gb2s = sh(pm2), sh(pga2), sh(pgb2)
        m1s, ga1s, gb1s = sh(pm1), sh(pga1), sh(pgb1)
        xv = d - yv
        lastcol = xv == nax  # x == na
        lastrow = yv == nbx  # y == nb
        # MATCH (alignment.c:89-119)
        Mv = torch.maximum(max3(m2s, ga2s, gb2s) + ss, mn)
        if nmm:  # alignment.c:101-104
            if sub is None:
                im = a_lane == b_lane
            else:
                im = im_flat[a_lane * kb + b_row] != 0
            Mv = torch.where(im, Mv, mn)
        # GAP_A: reads (y-1, x) (alignment.c:121-137)
        ga_v = torch.maximum(max3(m1s + gop, ga1s + gap_extend, gb1s + gop),
                             mn)
        if neg:
            ga_v = torch.where(lastcol, max3(m1s, ga1s, gb1s), ga_v)
        if nga:
            ga_v = torch.where(lastcol, ga_v, mn)
        # GAP_B: reads (y, x-1) (alignment.c:139-155)
        gb_v = torch.maximum(max3(pm1 + gop, pga1 + gop, pgb1 + gap_extend),
                             mn)
        if neg:
            gb_v = torch.where(lastrow, max3(pm1, pga1, pgb1), gb_v)
        if ngb:
            gb_v = torch.where(lastrow, gb_v, mn)
        if emit_dirs:
            # a no-gaps matrix is a predecessor only at its boundary
            # coordinates (alignment.c:312-314, 319-321); the guards take
            # the predecessor's cell
            diag_a = ((xv == 1) | (xv - 1 == nax)) if nga else True
            diag_b = ((yv == 1) | (yv - 1 == nbx)) if ngb else True
            dm = pick(diag_a & (ga2s + ss == Mv), diag_b & (gb2s + ss == Mv),
                      m2s + ss == Mv)
            # free end gaps: a GAP_A step on the last column, a GAP_B step
            # on the last row, costs nothing (alignment.c:265-268, 287-290)
            a_open = torch.where(lastcol, zero, gop) if neg else gop
            a_ext = (torch.where(lastcol, zero, gap_extend) if neg
                     else gap_extend)
            up_a = ((xv == 0) | lastcol) if nga else True
            dga = pick(up_a & (ga1s + a_ext == ga_v),
                       diag_b & (gb1s + a_open == ga_v),
                       m1s + a_open == ga_v)
            b_open = torch.where(lastrow, zero, gop) if neg else gop
            b_ext = (torch.where(lastrow, zero, gap_extend) if neg
                     else gap_extend)
            left_b = ((yv == 0) | lastrow) if ngb else True
            dgb = pick(diag_a & (pga1 + b_open == gb_v),
                       left_b & (pgb1 + b_ext == gb_v),
                       pm1 + b_open == gb_v)
            dirs[:, d - 2] = (dm | (dga << 2) | (dgb << 4)).to(torch.uint8)
        if mout is not None:
            mout[:, d - 2] = Mv.to(m_dtype)
        Mv, ga_v, gb_v = inject(d, Mv, ga_v, gb_v)
        if is_sw:
            valid = (yv >= 1) & (yv <= nbx) & (xv >= 1) & (xv <= nax)
            best = torch.maximum(best, torch.where(valid, Mv, mn).amax(1))
        else:
            corner = corner_at(d, Mv, ga_v, gb_v, corner)
        pm2, pga2, pgb2 = pm1, pga1, pgb1
        pm1, pga1, pgb1 = Mv, ga_v, gb_v
    return dirs, corner, best, mout


def nw_scores_plain(ac, bc, na, nb, params: KernelParams):
    """NW scores of a padded batch: ``ac`` (B, LA) and ``bc`` (B, LB) uint8
    codes (folded bytes, or compact codes when ``params.sub`` is set),
    ``na``/``nb`` (B,) int32 true lengths.  Returns ``(scores (B,) int32,
    corner (B, 3) int32)``, corner = M/Ga/Gb at (nb, na)."""
    _, corner, _, _ = _fill(ac, bc, na, nb, params)
    return corner.max(dim=1).values, corner


def nw_fill_dirs_plain(ac, bc, na, nb, params: KernelParams):
    """The NW fill with direction codes: returns ``(dirs, corner)``, dirs
    (B, LA+LB-1, LB+1) uint8 with cell (y, x) at ``[x+y-2, y]`` and code
    ``dm | dga << 2 | dgb << 4``.  Only cells 1 <= y <= nb, 1 <= x <= na
    are defined."""
    dirs, corner, _, _ = _fill(ac, bc, na, nb, params, emit_dirs=True)
    return dirs, corner


def sw_scores_plain(ac, bc, na, nb, params: KernelParams):
    """SW best scores of a padded batch (inputs as ``nw_scores_plain``):
    the max of M over the valid cells, (B,) int32, 0 for an empty side."""
    return _fill(ac, bc, na, nb, params, is_sw=True)[2]


def sw_fill_dirs_plain(ac, bc, na, nb, params: KernelParams,
                       m16: bool = False):
    """The SW fill with direction codes and the M matrix: returns
    ``(dirs, M)``, both (B, LA+LB-1, LB+1) in the skewed layout of
    ``nw_fill_dirs_plain``; M is int16 when ``m16`` (callers check
    ``pack.m16_safe``), else int32.  Only cells 1 <= y <= nb,
    1 <= x <= na are defined."""
    dirs, _, _, mout = _fill(ac, bc, na, nb, params, is_sw=True,
                             emit_dirs=True,
                             m_dtype=torch.int16 if m16 else torch.int32)
    return dirs, mout


def sw_sorted_candidates(mmat, na, nb, min_scores):
    """SW hit candidates of a skewed M batch (B, D, LB+1), harvested and
    ordered where M lies (dp.sw_extract_candidates plus the hit iterator's
    sort): the cells 1 <= y <= nb, 1 <= x <= na with M >= max(min_score,
    1), each pair's in the reference's order, score descending, then x,
    then flat ascending (smith_waterman.c:71-86).  Plain tensor ops: a
    mask, ``nonzero`` and two stable sorts, within the pairs and then by
    pair.  ``na``, ``nb`` and ``min_scores`` are (B,) host arrays;
    ``min_scores`` may be a scalar.  Returns, on M's device, ``(flat int32
    (N,), score int32 (N,), offsets int64 (B+1,))``: pair j's candidates
    are ``[offsets[j], offsets[j+1])``, flat = y * (na+1) + x."""
    B, D, LBp = mmat.shape
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
    m &= r <= y - 2 + na_t[:, None, None]  # x <= na
    idx = m.view(-1).nonzero()[:, 0]
    del m
    score = mmat.view(-1)[idx].to(torch.int32)
    pair, pos = idx.div(D * LBp, rounding_mode="floor"), idx % (D * LBp)
    del idx
    yy = pos % LBp
    xx = pos.div(LBp, rounding_mode="floor") + 2 - yy
    del pos
    # (-score, x, y) within a pair is (-score, x, flat): one int64 key
    key = -score.long() * ((D + 2) * LBp) + xx * LBp + yy
    order = torch.sort(key, stable=True).indices
    del key
    order = order[torch.sort(pair[order], stable=True).indices]
    pair, xx, yy, score = pair[order], xx[order], yy[order], score[order]
    flat = (yy * (na_t.long()[pair] + 1) + xx).to(torch.int32)
    offsets = torch.zeros(B + 1, dtype=torch.int64, device=dev)
    offsets[1:] = torch.bincount(pair, minlength=B).cumsum(0)
    return flat, score, offsets


def sw_extract_candidates(mmat, na, nb, min_scores):
    """:func:`sw_sorted_candidates` on the host, as the JAX package's
    ``dp.sw_extract_candidates`` returns them: a list of per-pair ``(flats
    int64, scores int32)`` numpy arrays, flats composed in int64 (here
    already in the hit iterator's order)."""
    flat, score, offsets = sw_sorted_candidates(mmat, na, nb, min_scores)
    flat = flat.cpu().numpy().astype(np.int64)
    score = score.cpu().numpy()
    off = offsets.tolist()
    return [(flat[s:e], score[s:e]) for s, e in zip(off[:-1], off[1:])]
