"""Traceback from direction codes: the plain walks, the NW strings and the
SW hit streams.

``nw_walk_plain`` and ``sw_walk_plain`` transcribe the JAX package's
on-device walks ``traceback._walk_jit`` and ``sw_walk_jit``
(seqalign_tpu/ops/traceback.py:515-558, 607-654); ``nw_strings_from_ops``,
``SwRefMaskHistory`` and ``SwHitIterator`` are its numpy host code
(:127-399, :561-600), written again here.  Unlike ``sw_walk_jit``, the SW
walks here know the free-end-gap rule of the reverse move (a GAP_A step on
the last column and a GAP_B step on the last row cost nothing,
alignment.c:264-307, ``SwHitIterator._penalty`` there): the port walks
every pair's hits on the device, constrained modes included.
``sw_hits_plain`` is the plain version of the ``sw_hits`` kernel, the
iterator's hit loop run for a whole batch, and :class:`SwDeviceHits` the
stream of the hits it finds.  ``ChunkedDirs`` / ``ChunkedM`` and the host
``nw_traceback`` serve a long pair walked on the host.

Skewed addressing: cell (y, x) of pair j lives at ``dirs[j, x+y-2, y]``.
A long pair's codes are chunk slabs instead, ``dirs`` (B, nch, D_c, LB+1)
with D_c = CA + LB - 1: cell (y, x) is in slab c = (x-1) // CA at row
(x - c*CA) + y - 2 (:func:`slab_index`, the rule of ``csrc/slab.cuh``).
A (B, D, LB+1) plane is the one-slab case, CA = D - LB + 1.  The planes of
one fill launch across widths are 1-d with their offsets ``off`` (B+1,)
(``pack.ragged_planes``): pair j's is one slab of its own widths, CA =
max(na, 1), rows of max(nb, 1) + 1 lanes, from ``off[j]``.
"""

from __future__ import annotations

from collections import deque
from typing import Callable, Iterator, Optional

import numpy as np
import torch

from ..scoring.config import ScoringConfig, encode
from .host_dp import Alignment

from .pack import DIR_FAIL, GAP_A, GAP_B, MATCH, NEG, KernelParams


def slab_geometry(dirs):
    """``(nch, D_c, LB+1, CA)`` of a (B, D, LB+1) code plane (one slab)
    or of (B, nch, D_c, LB+1) chunk slabs."""
    if dirs.dim() == 3:
        B, dc, lbp = dirs.shape
        nch = 1
    else:
        B, nch, dc, lbp = dirs.shape
    return nch, dc, lbp, dc - lbp + 2


def slab_index(x, y, ca: int, dc: int, lbp: int):
    """Offset of the code of cell (y, x), x >= 1 and y >= 1, in a pair's
    slabs: slab (x-1) // ca, row (x - c*ca) + y - 2, lane y.  Takes ints
    or tensors."""
    c = (x - 1) // ca
    return (c * dc + x - c * ca + y - 2) * lbp + y


def walk_cap(cap: int) -> int:
    """Step bound of a walk: rounded up to a multiple of 256, as in the
    JAX package (traceback.py:504), so the op trace widths agree."""
    return -(-int(cap) // 256) * 256


def nw_walk_plain(dirs, corner, na, nb, cap: int, off=None):
    """Walk every pair from (nb, na) to the first zero coordinate, over a
    code plane or chunk slabs (:func:`slab_geometry`), or with ``off``
    ((B+1,) int64, ``pack.ragged_planes``) over the 1-d planes at each
    pair's own widths that one fill launch across widths writes.

    The start matrix is picked from ``corner`` (B, 3) with preference
    GAP_A >= GAP_B >= MATCH (needleman_wunsch.c:53-66).  Returns the op
    trace (B, walk_cap(cap)) int8 — the matrix walked at each step, -1 once
    done; a DIR_FAIL shows as a 3 in the step after it — and the start
    scores (B,) int32."""
    B = corner.shape[0]
    dev = dirs.device
    if off is None:
        _, dc, LBp, ca = slab_geometry(dirs)
        flat = dirs.reshape(B, -1)

        def code_at(X, Y):
            idx = slab_index(X, Y, ca, dc, LBp)
            return flat.gather(1, idx[:, None])[:, 0].long()
    else:
        base = off[:B].long()
        lanes = nb.long().clamp(min=1) + 1

        def code_at(X, Y):
            return dirs[base + (X + Y - 2) * lanes + Y].long()
    cap = walk_cap(cap)
    m, ga, gb = corner.long().unbind(1)
    curr = torch.where(gb >= m, GAP_B, MATCH)
    score = torch.maximum(m, gb)
    curr = torch.where(ga >= score, GAP_A, curr)
    score = torch.maximum(score, ga)
    X = na.long()
    Y = nb.long()
    ops = torch.full((B, cap), -1, dtype=torch.int8, device=dev)
    for s in range(cap):
        active = (X > 0) & (Y > 0)
        code = code_at(X.clamp(min=1), Y.clamp(min=1))
        nxt = (code >> (2 * curr)) & 3
        ops[:, s] = torch.where(active, curr, -1).to(torch.int8)
        X = torch.where(active & (curr != GAP_A), X - 1, X)
        Y = torch.where(active & (curr != GAP_B), Y - 1, Y)
        curr = torch.where(active, nxt, curr)
    return ops, score.to(torch.int32)


class ChunkedDirs:
    """Host accessor over one pair's chunk slabs (the JAX package's
    ``traceback.ChunkedDirs``, traceback.py:31-42): ``chunks`` is a
    (nch, D_c, LB+1) array or a list of (D_c, LB+1) arrays of ``CA``
    columns each; cell (y, x) is in slab (x-1) // CA at row (x - c*CA) +
    y - 2, lane y.  An array is used in place."""

    def __init__(self, chunks, CA: int):
        slabs = chunks if isinstance(chunks, np.ndarray) else np.stack(chunks)
        self.slabs = np.ascontiguousarray(slabs)
        self.CA = int(CA)
        _, self.dc, self.lbp = self.slabs.shape
        self.flat = self.slabs.reshape(-1)

    def at(self, y: int, x: int) -> int:
        return int(self.flat[slab_index(x, y, self.CA, self.dc, self.lbp)])

    code = at


class ChunkedM(ChunkedDirs):
    """The same accessor over one pair's chunked SW M slabs, read with
    ``at(y, x)`` (traceback.py:45-54 of the JAX package)."""


def nw_start(corner):
    """Start matrix and score from the corner (M, Ga, Gb) at (nb, na),
    preference GAP_A >= GAP_B >= MATCH (needleman_wunsch.c:53-66)."""
    m, ga, gb = (int(v) for v in corner)
    curr, score = MATCH, m
    if gb >= score:
        curr, score = GAP_B, gb
    if ga >= score:
        curr, score = GAP_A, ga
    return curr, score


def nw_traceback(seq_a, seq_b, na: int, nb: int, dirs, corner) -> Alignment:
    """The global alignment walked on the host (needleman_wunsch.c:34-146;
    the JAX package's ``traceback.nw_traceback``): ``dirs`` is one pair's
    code plane (D, LB+1) or a :class:`ChunkedDirs`, ``corner`` its
    (M, Ga, Gb) at (nb, na).  Raises on a DIR_FAIL step."""
    a, b = encode(seq_a), encode(seq_b)
    if isinstance(dirs, np.ndarray):
        dirs = ChunkedDirs(dirs[None], dirs.shape[0] - dirs.shape[1] + 2)
    curr, score = nw_start(corner)
    out_a, out_b = [], []
    x, y = int(na), int(nb)
    while x > 0 and y > 0:
        nxt = (dirs.code(y, x) >> (2 * curr)) & 3
        if curr == MATCH:
            out_a.append(chr(a[x - 1]))
            out_b.append(chr(b[y - 1]))
            x, y = x - 1, y - 1
        elif curr == GAP_A:
            out_a.append("-")
            out_b.append(chr(b[y - 1]))
            y -= 1
        else:
            out_a.append(chr(a[x - 1]))
            out_b.append("-")
            x -= 1
        if nxt == DIR_FAIL:
            raise RuntimeError("traceback fail: no predecessor matches "
                               "(alignment.c:329-349)")
        curr = nxt
    # leading unaligned prefix as gap runs (needleman_wunsch.c:117-132)
    ra = "".join(reversed(out_a))
    rb = "".join(reversed(out_b))
    pre_a = a[:x].tobytes().decode("latin-1") + "-" * y
    pre_b = "-" * x + b[:y].tobytes().decode("latin-1")
    return Alignment(pre_a + ra, pre_b + rb, score, 0, 0, len(a), len(b))


def _spell(a: np.ndarray, b: np.ndarray, ops: np.ndarray, xv, yv):
    """The characters of a walked op trace in alignment order: ``xv``,
    ``yv`` are the coordinates before each step, a gap shows as '-'."""
    op, xv, yv = ops[::-1], xv[::-1], yv[::-1]
    ca = np.where(op == GAP_A, ord("-"),
                  a[np.maximum(xv - 1, 0)] if len(a) else ord("-"))
    cb = np.where(op == GAP_B, ord("-"),
                  b[np.maximum(yv - 1, 0)] if len(b) else ord("-"))
    return (ca.astype(np.uint8).tobytes().decode(),
            cb.astype(np.uint8).tobytes().decode())


def nw_strings_from_ops(seqs_a, seqs_b, na, nb, ops, score):
    """Alignment strings from a walked op trace (numpy ``ops`` (B, cap),
    ``score`` (B,)).  The (X, Y) coordinates at every step come from
    cumsums and the characters from vectorized gathers.  Raises on a
    DIR_FAIL step, as the reference aborts (alignment.c:329-349)."""
    na = np.asarray(na, np.int64)
    nb = np.asarray(nb, np.int64)
    out = []
    for j in range(len(seqs_a)):
        a = encode(seqs_a[j])
        b = encode(seqs_b[j])
        oj = ops[j]
        op = oj[: int(np.count_nonzero(oj >= 0))].astype(np.int64)
        if (op == DIR_FAIL).any():
            raise RuntimeError(
                "traceback fail: no predecessor matches "
                "(alignment.c:329-349)")
        # X/Y before each step: X falls on MATCH/GAP_B, Y on MATCH/GAP_A
        dx = (op != GAP_A).astype(np.int64)
        dy = (op != GAP_B).astype(np.int64)
        xv = na[j] - np.concatenate([[0], np.cumsum(dx)[:-1]])
        yv = nb[j] - np.concatenate([[0], np.cumsum(dy)[:-1]])
        px = int(na[j] - dx.sum())
        py = int(nb[j] - dy.sum())
        ra, rb = _spell(a, b, op, xv, yv)
        # leading unaligned prefixes as gap runs (needleman_wunsch.c:117-132)
        pre_a = np.concatenate([a[:px], np.full(py, ord("-"), np.uint8)])
        pre_b = np.concatenate([np.full(px, ord("-"), np.uint8), b[:py]])
        out.append(Alignment(pre_a.tobytes().decode() + ra,
                             pre_b.tobytes().decode() + rb, int(score[j]), 0,
                             0, len(a), len(b)))
    return out


def _pair_slabs(dirs, na, nb, off):
    """Each pair's codes as (base, CA, D_c, LB+1) of :func:`slab_index`:
    (B,) int64 tensors for the 1-d planes of one launch across widths
    (``off``), else one shared slab geometry with base j * plane."""
    if off is None:
        nch, dc, lbp, ca = slab_geometry(dirs)
        base = torch.arange(dirs.shape[0], device=dirs.device) * (nch * dc
                                                                  * lbp)
        return base, ca, dc, lbp
    wa, wb = na.long().clamp(min=1), nb.long().clamp(min=1)
    return off[:-1].long(), wa, wa + wb - 1, wb + 1


def sw_walk_plain(dirs, ac, bc, na, nb, jw, x0, y0, s0,
                  params: KernelParams, cap: int, off=None):
    """Walk SW candidates back from their end cells, without the overlap
    mask (paths depend only on the codes and the per-step penalties).

    ``dirs`` (B, D, LB+1) uint8 codes (or chunk slabs,
    :func:`slab_geometry`, or with ``off`` the 1-d planes of one launch
    across widths) and ``ac``/``bc`` (B, LA)/(B, LB) uint8 codes
    of the fill, ``na``/``nb`` (B,) int32 its true lengths; walk ``w``
    starts in pair ``jw[w]`` at cell
    (``y0[w]``, ``x0[w]``) with score ``s0[w]`` and stops once its score
    reaches 0.  The penalty of a MATCH step is the equality score or
    ``params.sub[a, b]``; of a gap step ``gap_extend`` when the gap goes
    on, else ``gap_open + gap_extend``, and 0 under free end gaps
    (``params.modes & NEG``) for a GAP_A step at x == na or a GAP_B step at
    y == nb.  Returns the op trace
    (W, walk_cap(cap)) int8: the matrix walked at each step, -1 once
    done; a DIR_FAIL shows as a 3 in the step after it."""
    cap = walk_cap(cap)
    W = jw.shape[0]
    dev = dirs.device
    match, mismatch, gap_open, gap_extend = params.scal[:4].unbind()
    gop = gap_open + gap_extend
    neg = bool(params.modes & NEG)
    flat = dirs.reshape(-1)
    j = jw.long()
    base, ca, dc, LBp = _pair_slabs(dirs, na, nb, off)
    base = base[j]
    if off is not None:
        ca, dc, LBp = ca[j], dc[j], LBp[j]
    na_w, nb_w = na.long()[j], nb.long()[j]
    X = x0.long()
    Y = y0.long()
    cs = s0.to(torch.int32)
    curr = torch.full((W,), MATCH, dtype=torch.long, device=dev)
    ops = torch.full((W, cap), -1, dtype=torch.int8, device=dev)
    for s in range(cap):
        active = cs > 0
        if not bool(active.any()):
            break
        Xc = X.clamp(min=1)
        Yc = Y.clamp(min=1)
        code = flat[base + slab_index(Xc, Yc, ca, dc, LBp)].long()
        nxt = (code >> (2 * curr)) & 3
        ai = ac[j, Xc - 1].long()
        bi = bc[j, Yc - 1].long()
        if params.sub is None:
            sub = torch.where(ai == bi, match, mismatch)
        else:
            sub = params.sub.reshape(-1)[ai * params.sub.shape[1] + bi]
        pen = torch.where(curr == MATCH, sub,
                          torch.where(nxt == curr, gap_extend, gop))
        if neg:
            free = (((curr == GAP_A) & (X == na_w))
                    | ((curr == GAP_B) & (Y == nb_w)))
            pen = torch.where(free, torch.zeros_like(pen), pen)
        ops[:, s] = torch.where(active, curr, -1).to(torch.int8)
        cs = torch.where(active, cs - pen, cs)
        X = torch.where(active & (curr != GAP_A), X - 1, X)
        Y = torch.where(active & (curr != GAP_B), Y - 1, Y)
        curr = torch.where(active, nxt, curr)
    return ops


def sw_hits_plain(dirs, ac, bc, na, nb, cand_flat, cand_score, lo, hi,
                  params: KernelParams, k: int, off=None):
    """The first ``k`` hits of every pair of one SW fill, found with the
    reference's overlap mask and abort (smith_waterman.c:165-258; the
    loop of :meth:`SwHitIterator.fetch`).

    ``dirs``, ``ac``, ``bc``, ``na``, ``nb``, ``off`` and the step
    penalties as in :func:`sw_walk_plain`; pair j's candidates are
    ``cand_flat`` (int32
    or int64) / ``cand_score`` (int32) ``[lo[j], hi[j])`` (int64), in the
    hit order of ``dp.sw_sorted_candidates``.  Returns ``hit_flat`` (B, k)
    of ``cand_flat``'s type and
    ``hit_score`` (B, k) int32, the start cell and score of each hit in
    stream order, and
    ``nhits`` (B,) int32, fewer than ``k`` once a pair's candidates ran
    out and -1 after a DIR_FAIL.  A Python loop over host copies of the
    inputs; the outputs go to ``dirs``' device."""
    B = ac.shape[0]
    LA = ac.shape[1]
    geo = [v.tolist() if isinstance(v, torch.Tensor) else [v] * B
           for v in _pair_slabs(dirs, na, nb, off)]
    codes = memoryview(dirs.cpu().numpy().reshape(-1))
    av = ac.cpu().numpy()
    bv = bc.cpu().numpy()
    match, mismatch, gap_open, ge = params.scal[:4].tolist()
    gop = gap_open + ge
    neg = bool(params.modes & NEG)
    if params.sub is None:
        subv, kb = None, 0
    else:
        subv = memoryview(params.sub.cpu().numpy().reshape(-1))
        kb = params.sub.shape[1]
    flats_h = cand_flat.cpu().numpy()
    flats = memoryview(flats_h)
    scores = memoryview(cand_score.cpu().numpy())
    hit_flat = np.zeros((B, k), flats_h.dtype)
    hit_score = np.zeros((B, k), np.int32)
    nhits = np.zeros(B, np.int32)

    def pair(j, lo_j, hi_j, n_a, n_b):
        w = n_a + 1
        base, ca, dc, LBp = (v[j] for v in geo)
        mask = bytearray((n_b + 1) * w if off is not None
                         else LBp * (LA + 1))
        aj, bj = memoryview(av[j]), memoryview(bv[j])
        n = 0
        for c in range(lo_j, hi_j):
            if n == k:
                break
            flat = flats[c]
            if mask[flat]:
                continue
            if mask[flat - w - 1]:
                mask[flat] = 1
                continue
            x, y = flat % w, flat // w
            curr, cs = MATCH, scores[c]
            while True:
                f = y * w + x
                if mask[f]:
                    break
                mask[f] = 1
                if cs == 0:
                    hit_flat[j, n] = flat
                    hit_score[j, n] = scores[c]
                    n += 1
                    break
                if x < 1 or y < 1:
                    return -1
                nxt = (codes[base + slab_index(x, y, ca, dc, LBp)]
                       >> (2 * curr)) & 3
                if nxt == DIR_FAIL:
                    return -1
                if curr == MATCH:
                    ai, bi = aj[x - 1], bj[y - 1]
                    if subv is None:
                        cs -= match if ai == bi else mismatch
                    else:
                        cs -= subv[ai * kb + bi]
                    x, y = x - 1, y - 1
                else:
                    if not (neg and (x == n_a if curr == GAP_A
                                     else y == n_b)):
                        cs -= ge if nxt == curr else gop
                    if curr == GAP_A:
                        y -= 1
                    else:
                        x -= 1
                curr = nxt
        return n

    for j, args in enumerate(zip(lo.tolist(), hi.tolist(), na.tolist(),
                                 nb.tolist())):
        nhits[j] = pair(j, *args)
    dev = dirs.device
    return tuple(torch.from_numpy(v).to(dev)
                 for v in (hit_flat, hit_score, nhits))


def sw_hit_from_ops(a: np.ndarray, b: np.ndarray, w: int, flat: int,
                    score: int, ops: np.ndarray) -> Alignment:
    """A hit's alignment from its walked op trace (``sw_walk``): the walk
    starts at cell ``flat`` = y * w + x and its steps, -1 once done, lead
    back to the cell where the score reaches 0."""
    n = int(np.count_nonzero(ops >= 0))
    op = ops[:n].astype(np.int64)
    if (op == DIR_FAIL).any():
        raise RuntimeError("sw traceback fail")
    x0, y0 = flat % w, flat // w
    xs = x0 - np.concatenate([[0], np.cumsum(op != GAP_A)])
    ys = y0 - np.concatenate([[0], np.cumsum(op != GAP_B)])
    ra, rb = _spell(a, b, op, xs[:n], ys[:n])
    x, y = int(xs[-1]), int(ys[-1])
    return Alignment(ra, rb, int(score), pos_a=x, pos_b=y, len_a=x0 - x,
                     len_b=y0 - y)


class SwDeviceHits:
    """A pair's best-first hit stream as the card finds it: ``sw_hits``
    runs the reference's hit loop with the overlap mask on the device and
    ``sw_walk`` traces the hits; ``fetch()`` spells the next hit from its
    trace.

    ``hits`` holds the (flat, score, ops) of the first round's hits and
    ``nhits`` their count; a round asked for ``k`` hits, so fewer means the
    stream ended.  A consumer that goes past them calls ``more(k, skip)``,
    which returns the records of the pair's hits ``skip .. k-1`` and the
    count of hits found: the aligner fills the pair again and reruns both
    kernels, with four times the hits each round, so no fill stays on the
    device between rounds.  ``n_candidates`` is the pair's harvested
    candidate count."""

    def __init__(self, seq_a, seq_b, na: int, hits, nhits: int, k: int,
                 n_candidates: int, more: Callable):
        self.a, self.b = encode(seq_a), encode(seq_b)
        self.w = int(na) + 1
        self.n_candidates = int(n_candidates)
        self._hits = deque(hits)
        self._k = k
        self._done = nhits < k
        self._more = more

    def fetch(self) -> Optional[Alignment]:
        """The next hit, or None once the stream has ended."""
        if not self._hits and not self._done:
            k = 4 * self._k
            hits, nhits = self._more(k, self._k)
            self._hits.extend(hits)
            self._k = k
            self._done = nhits < k
        if not self._hits:
            self._more = None
            return None
        flat, score, ops = self._hits.popleft()
        return sw_hit_from_ops(self.a, self.b, self.w, flat, score, ops)

    def __iter__(self) -> Iterator[Alignment]:
        while True:
            h = self.fetch()
            if h is None:
                return
            yield h


def _roundup2pow(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


class SwRefMaskHistory:
    """Opt-in bug-compatible emulation of the reference's shared
    ``sw_history_t`` overlap mask (smith_waterman.c:20-59,95-108,149).

    The reference keeps ONE bitset per sw aligner across every pair it
    aligns: it grows to ``roundup2pow(arr_size)`` bits (realloc zeroes only
    the new words, smith_waterman.c:37-45), and between pairs
    ``memset(b, 0, (l+31)/32)`` clears (l+31)/32 *bytes* of the uint32-word
    buffer, one quarter of the mask, so stale marks from earlier pairs can
    suppress later hits.  The default resets the mask fully per pair
    (README "Known deviations"); ``SmithWaterman(ref_mask_compat=True)``
    or ``SEQALIGN_SW_REF_MASK=1`` selects this class, which reproduces the
    reference on multi-pair runs.  Iterators sharing one history must be
    consumed in pair order, as the reference's align/fetch loop does.
    """

    def __init__(self):
        self.capacity = 256  # _init_history, smith_waterman.c:88-94
        self.bits = np.zeros(256, dtype=bool)

    def begin_pair(self, arr_size: int) -> np.ndarray:
        """smith_waterman_align2's mask lifecycle for one pair
        (smith_waterman.c:95-108,149); returns the shared mask array."""
        if arr_size > self.capacity:
            cap = _roundup2pow(arr_size)
            grown = np.zeros(cap, dtype=bool)
            grown[: self.capacity] = self.bits  # realloc keeps old bits
            self.bits, self.capacity = grown, cap
        # memset((l+31)/32 bytes) clears bits [0, 8*((l+31)/32)) only
        cleared = min(8 * ((self.capacity + 31) // 32), self.capacity)
        self.bits[:cleared] = False
        return self.bits


class SwHitIterator:
    """Stateful best-first local-hit enumerator (smith_waterman.c:131-277)
    over one pair's codes, walked on the host.

    ``fetch()`` mirrors smith_waterman_fetch, with overlap masking and
    partial-walk abort; the device path's counterpart is
    :class:`SwDeviceHits`.  ``candidates`` are the pair's ``(flats, scores)``
    with flat = y * (na+1) + x, the interior cells with M >= max(min_score,
    1); they are taken in (score desc, x asc, flat asc) order, the
    reference's stable qsort (smith_waterman.c:71-86,153-161).  ``dirs`` is
    the pair's skewed code plane (numpy) or a :class:`ChunkedDirs` over a
    long pair's slabs, dropped once the stream is exhausted.  With
    ``history`` (a shared :class:`SwRefMaskHistory`) the
    overlap mask is the reference's shared bitset, bound at the first
    fetch so sequential consumption reproduces the reference.
    """

    def __init__(
        self,
        sc: ScoringConfig,
        seq_a,
        seq_b,
        na: int,
        nb: int,
        dirs: np.ndarray,
        candidates: tuple,
        history: Optional[SwRefMaskHistory] = None,
    ):
        self.sc = sc
        self.a, self.b = encode(seq_a), encode(seq_b)
        self.na, self.nb = int(na), int(nb)
        self.dirs = dirs
        _, self.sub_lut, _, _ = sc.luts()
        self._views = (
            memoryview(np.ascontiguousarray(self.sub_lut, np.int32)
                       .reshape(-1)),
            memoryview(self.a), memoryview(self.b))
        self._code_view = None
        w = self.na + 1
        self.w = w
        flat = candidates[0].astype(np.int64)
        sc_ = candidates[1].astype(np.int64)
        if len(flat):
            order = np.lexsort((flat, flat % w, -sc_))
            self.cand = flat[order]
            self.cand_scores = sc_[order]
        else:
            self.cand = np.zeros(0, dtype=np.int64)
            self.cand_scores = np.zeros(0, dtype=np.int64)
        self.n_candidates = len(self.cand)
        self._history = history
        if history is None:
            self.mask: Optional[np.ndarray] = np.zeros(
                (self.nb + 1) * w, dtype=bool
            )
        else:
            self.mask = None  # bound at first fetch via begin_pair
        self.next_hit = 0

    def _codes(self):
        """The pair's codes as a flat byte view and their slab geometry
        (lanes, columns and rows per slab; one slab for a plane)."""
        if self._code_view is None:
            cd = self.dirs
            if not isinstance(cd, ChunkedDirs):
                cd = np.ascontiguousarray(cd, np.uint8)
                cd = ChunkedDirs(cd[None], cd.shape[0] - cd.shape[1] + 2)
            self._code_view = (memoryview(cd.flat), cd.lbp, cd.CA, cd.dc)
        return self._code_view

    def _gap_penalty(self, curr: int, nxt: int, x: int, y: int) -> int:
        """Score drop of one reverse gap move from (y, x): gap_extend when
        the gap goes on, gap_open + gap_extend when it opens, and 0 under
        free end gaps for a GAP_A move on the last column or a GAP_B move
        on the last row (alignment.c:264-307)."""
        sc = self.sc
        if sc.no_end_gap_penalty and (x == self.na if curr == GAP_A
                                      else y == self.nb):
            return 0
        return sc.gap_extend if nxt == curr else sc.gap_open + sc.gap_extend

    def _spell(self, flat: int, end_score: int) -> Alignment:
        """The alignment of a hit whose walk from ``flat`` reached score 0
        unmasked, walked again over the codes: the score drops by the
        substitution score on a MATCH step and by :meth:`_gap_penalty` on
        a gap step (alignment.c:264-307)."""
        w = self.w
        codes, lbp, ca, dc = self._codes()
        sub, av, bv = self._views
        x, y = flat % w, flat // w
        end_x, end_y = x, y
        curr, cs = MATCH, end_score
        out_a, out_b = [], []
        while cs != 0:
            nxt = (codes[slab_index(x, y, ca, dc, lbp)] >> (2 * curr)) & 3
            if curr == MATCH:
                out_a.append(chr(av[x - 1]))
                out_b.append(chr(bv[y - 1]))
                cs -= sub[(av[x - 1] << 8) | bv[y - 1]]
                x, y = x - 1, y - 1
            else:
                cs -= self._gap_penalty(curr, nxt, x, y)
                if curr == GAP_A:
                    out_a.append("-")
                    out_b.append(chr(bv[y - 1]))
                    y -= 1
                else:
                    out_a.append(chr(av[x - 1]))
                    out_b.append("-")
                    x -= 1
            curr = nxt
        return Alignment(
            "".join(reversed(out_a)),
            "".join(reversed(out_b)),
            end_score,
            pos_a=x,
            pos_b=y,
            len_a=end_x - x,
            len_b=end_y - y,
        )

    def fetch(self) -> Optional[Alignment]:
        """The next hit, or None once the candidates run out.  A candidate
        not yet masked is walked back, marking cells as it goes, until its
        score reaches 0 (a hit) or it meets a marked cell (an abort whose
        marks stay, smith_waterman.c:165-258).  The walk runs in Python
        ints over element views, since most walks abort after a step or
        two and a pair may walk 10^5 of them; a hit is then spelled by
        :meth:`_spell`.  A walk's first step is a MATCH step to (y-1, x-1)
        (a candidate has M >= 1, so its MATCH code is never DIR_FAIL):
        when that cell is marked, the walk marks its start and aborts
        without reading a code."""
        if self.mask is None:
            self.mask = self._history.begin_pair((self.nb + 1) * self.w)
        mask = memoryview(self.mask)
        cand = memoryview(self.cand)
        n = len(cand)
        w = self.w
        sub, av, bv = self._views
        codes = None
        pos = self.next_hit
        while pos < n:
            flat = cand[pos]
            pos += 1
            if mask[flat]:
                continue
            if mask[flat - w - 1]:
                mask[flat] = True
                continue
            self.next_hit = pos
            score = int(self.cand_scores[pos - 1])
            if codes is None:
                codes, lbp, ca, dc = self._codes()
            x, y = flat % w, flat // w
            curr, cs = MATCH, score
            while True:
                f = y * w + x
                if mask[f]:
                    break
                mask[f] = True
                if cs == 0:
                    return self._spell(flat, score)
                c = (x - 1) // ca  # slab_index, inline
                nxt = (codes[(c * dc + x - c * ca + y - 2) * lbp + y]
                       >> (2 * curr)) & 3
                if nxt == DIR_FAIL:
                    raise RuntimeError("sw traceback fail")
                if curr == MATCH:
                    cs -= sub[(av[x - 1] << 8) | bv[y - 1]]
                    x, y = x - 1, y - 1
                else:
                    cs -= self._gap_penalty(curr, nxt, x, y)
                    if curr == GAP_A:
                        y -= 1
                    else:
                        x -= 1
                curr = nxt
        self.next_hit = pos
        # exhausted: let go of the codes
        self.dirs = self._code_view = None
        return None

    def __iter__(self) -> Iterator[Alignment]:
        while True:
            h = self.fetch()
            if h is None:
                return
            yield h
