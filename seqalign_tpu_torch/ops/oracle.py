"""NumPy oracle: a literal, cell-by-cell executable spec of the reference DP.

This module exists for TESTING: it transcribes the reference *semantics*
(not its code) at Python speed so the vectorized JAX/Pallas kernels can be
fuzz-checked for bit-identical int32 behavior. Reference anchors:

  * fill:       alignment_fill_matrices   (alignment.c:28-168)
  * traceback:  alignment_reverse_move    (alignment.c:244-350)
  * NW entry:   needleman_wunsch_align2   (needleman_wunsch.c:34-146)
  * SW multi-hit: smith_waterman.c:131-277

All arithmetic is int64 internally but every stored value is the int32 the
reference computes (the reference's sentinel design keeps interior values in
range; we assert that instead of wrapping).

``wrap32=True`` switches every addition to C two's-complement int32 wrap —
the reference's ACTUAL behavior in the sentinel-overflow regime (constrained
modes with per-step penalties beyond the frozen |min_penalty| headroom,
README known deviations), where it computes deterministic wrapped garbage
and aborts in the traceback.  This powers the opt-in SEQALIGN_REF_WRAP=1
bug-compat mode; the default mode asserts in-range instead.
"""

from __future__ import annotations

import numpy as np

from ..scoring.config import (GAP_A, GAP_B, MATCH, ScoringConfig,
                              UnknownCharPair, encode)

_MATRIX_NAME = {MATCH: "MATCH", GAP_A: "GAP_A", GAP_B: "GAP_B"}


def _w32(v) -> int:
    """C int32 two's-complement wrap (deterministic on every supported
    platform, though formally UB in the reference)."""
    return ((int(v) + (1 << 31)) & 0xFFFFFFFF) - (1 << 31)


class TracebackFail(RuntimeError):
    """alignment.c:329-349 'Program error: traceback fail' — carries the
    exact values the reference dumps to stdout/stderr before
    exit(EXIT_FAILURE), so the CLI can reproduce the abort byte-for-byte
    under SEQALIGN_REF_WRAP=1."""

    def __init__(self, matrix_name, x, y, score, is_match, ca, cb,
                 pm, pga, pgb, em, ega, egb):
        super().__init__("traceback fail (get_reverse_move)")
        self.matrix_name = matrix_name
        self.x, self.y, self.score = x, y, score
        self.is_match = is_match
        self.ca, self.cb = ca, cb
        self.pm, self.pga, self.pgb = pm, pga, pgb
        self.em, self.ega, self.egb = em, ega, egb


def _max4_ref(w, x, y, mn):
    """The reference BINARY's MAX4 under signed overflow (gcc -O2 x86-64,
    tools/build_reference.sh; formally UB): the MAX3 head comparison
    ``w >= x && w >= y`` is evaluated on the TRUE sums (gcc promotes to
    64-bit), its else-branch ``MAX2(x, y)`` compares the int32-WRAPPED
    sums, and the final ``MAX2(.., min)`` + store happen in int32.
    Verified cell-for-cell against the binary's own --printmatrices dump
    in the overflow regime (tests/test_ref_wrap_compat.py)."""
    if w >= x and w >= y:
        r = _w32(w)
    else:
        xw, yw = _w32(x), _w32(y)
        r = xw if xw >= yw else yw
    return r if r >= mn else mn


def fill_matrices(sc: ScoringConfig, seq_a, seq_b, is_sw: bool,
                  wrap32: bool = False):
    """Return (M, Ga, Gb) int32 arrays of shape (len_b+1, len_a+1), laid out
    [y][x] like the reference's row-major ARR_2D_INDEX(width=len_a+1, x, y)."""
    a = encode(seq_a)
    b = encode(seq_b)
    n, m = len(a), len(b)
    w, h = n + 1, m + 1
    _, sub_lut, is_match_lut, valid_lut = sc.luts()

    gop = sc.gap_extend + sc.gap_open  # gap_open_penalty (alignment.c:38)
    gep = sc.gap_extend
    mn = sc.dp_floor(is_sw)

    M = np.zeros((h, w), dtype=np.int64)
    Ga = np.zeros((h, w), dtype=np.int64)
    Gb = np.zeros((h, w), dtype=np.int64)

    wr = _w32 if wrap32 else (lambda v: v)
    # wrap semantics: _max4_ref replicates the reference binary's exact
    # MAX4 codegen under overflow (argument order matches
    # alignment.c:111-155); identical to plain max when nothing wraps
    mx4 = _max4_ref if wrap32 else (
        lambda w_, x_, y_, mn_: max(w_, x_, y_, mn_))

    if is_sw:
        # alignment.c:51-57 (min == 0 for SW so everything is 0)
        M[0, 1:] = Ga[0, 1:] = Gb[0, 1:] = 0
        M[1:, 0] = Ga[1:, 0] = Gb[1:, 0] = mn
    else:
        # alignment.c:59-81
        for x in range(1, w):
            M[0, x] = mn
            Ga[0, x] = mn
            Gb[0, x] = 0 if sc.no_start_gap_penalty else \
                wr(sc.gap_open + x * sc.gap_extend)
        for y in range(1, h):
            M[y, 0] = mn
            Ga[y, 0] = 0 if sc.no_start_gap_penalty else \
                wr(sc.gap_open + y * sc.gap_extend)
            Gb[y, 0] = mn

    for y in range(1, h):
        for x in range(1, w):
            ca, cb = a[x - 1], b[y - 1]
            if not valid_lut[ca, cb]:
                fold = sc.luts()[0]
                raise UnknownCharPair(
                    "Unknown character pair (%c,%c) and match/mismatch have"
                    " not been set" % (chr(fold[ca]), chr(fold[cb])))
            sub = int(sub_lut[ca, cb])
            is_match = bool(is_match_lut[ca, cb])

            if sc.no_mismatches and not is_match:
                M[y, x] = mn  # alignment.c:101-104
            else:
                M[y, x] = mx4(
                    M[y - 1, x - 1] + sub,
                    Ga[y - 1, x - 1] + sub,
                    Gb[y - 1, x - 1] + sub,
                    mn,
                )

            # gap_a from [x][y-1] (alignment.c:121-137)
            if x == n and sc.no_end_gap_penalty:
                Ga[y, x] = max(M[y - 1, x], Ga[y - 1, x], Gb[y - 1, x])
            elif (not sc.no_gaps_in_a) or x == n:
                Ga[y, x] = mx4(
                    M[y - 1, x] + gop, Ga[y - 1, x] + gep,
                    Gb[y - 1, x] + gop, mn
                )
            else:
                Ga[y, x] = mn

            # gap_b from [x-1][y] (alignment.c:139-155)
            if y == m and sc.no_end_gap_penalty:
                Gb[y, x] = max(M[y, x - 1], Ga[y, x - 1], Gb[y, x - 1])
            elif (not sc.no_gaps_in_b) or y == m:
                Gb[y, x] = mx4(
                    M[y, x - 1] + gop, Ga[y, x - 1] + gop,
                    Gb[y, x - 1] + gep, mn
                )
            else:
                Gb[y, x] = mn

    for arr in (M, Ga, Gb):
        assert arr.min() >= np.iinfo(np.int32).min and arr.max() <= np.iinfo(np.int32).max
    return M.astype(np.int32), Ga.astype(np.int32), Gb.astype(np.int32)


def reverse_move(sc: ScoringConfig, a, b, M, Ga, Gb, curr_matrix, curr_score,
                 x, y):
    """alignment_reverse_move (alignment.c:244-350). Returns
    (new_matrix, new_score, new_x, new_y). Raises on traceback failure —
    :class:`TracebackFail` carrying the reference's exact dump values.

    No wrap32 variant: the reference build evaluates the equality sums in
    64-bit (signed-overflow UB lets gcc -O2 promote), so only STORED fill
    values ever truncate — the traceback arithmetic itself never wraps,
    which is exactly why it FAILS on wrapped cells."""
    n = len(a)
    m = len(b)
    sub, is_match = sc.lookup(int(a[x - 1]), int(b[y - 1]))

    ga_open = gb_open = sc.gap_extend + sc.gap_open
    ga_ext = gb_ext = sc.gap_extend
    if sc.no_end_gap_penalty:  # alignment.c:265-268
        if x == n:
            ga_open = ga_ext = 0
        if y == m:
            gb_open = gb_ext = 0

    if curr_matrix == MATCH:
        pm = pga = pgb = sub
        nx, ny = x - 1, y - 1
    elif curr_matrix == GAP_A:
        pm, pga, pgb = ga_open, ga_ext, ga_open
        nx, ny = x, y - 1
    else:  # GAP_B
        pm, pga, pgb = gb_open, gb_open, gb_ext
        nx, ny = x - 1, y

    # alignment.c:311-327 — priority GAP_A, GAP_B, MATCH with no_gaps
    # guards
    if (not sc.no_gaps_in_a or nx == 0 or nx == n) \
            and int(Ga[ny, nx]) + pga == curr_score:
        return GAP_A, int(Ga[ny, nx]), nx, ny
    if (not sc.no_gaps_in_b or ny == 0 or ny == m) \
            and int(Gb[ny, nx]) + pgb == curr_score:
        return GAP_B, int(Gb[ny, nx]), nx, ny
    if int(M[ny, nx]) + pm == curr_score:
        return MATCH, int(M[ny, nx]), nx, ny
    # alignment.c:329-349
    raise TracebackFail(_MATRIX_NAME[curr_matrix], nx, ny, curr_score,
                        int(bool(is_match)), chr(a[x - 1]), chr(b[y - 1]),
                        pm, pga, pgb,
                        int(M[ny, nx]), int(Ga[ny, nx]), int(Gb[ny, nx]))


def nw_align(sc: ScoringConfig, seq_a: str, seq_b: str, matrices=None,
             wrap32: bool = False):
    """needleman_wunsch_align2 -> (aligned_a, aligned_b, score).

    ``matrices`` lets the production host path (ops/host_dp.py) inject its
    vectorized fill; default is this module's per-cell spec fill."""
    a, b = encode(seq_a), encode(seq_b)
    n, m = len(a), len(b)
    M, Ga, Gb = (fill_matrices(sc, seq_a, seq_b, is_sw=False,
                               wrap32=wrap32)
                 if matrices is None else matrices)

    # start matrix preference GAP_A >= GAP_B >= MATCH (needleman_wunsch.c:53-66)
    curr, score = MATCH, int(M[m, n])
    if int(Gb[m, n]) >= score:
        curr, score = GAP_B, int(Gb[m, n])
    if int(Ga[m, n]) >= score:
        curr, score = GAP_A, int(Ga[m, n])
    final_score = score

    out_a, out_b = [], []
    x, y = n, m
    cs = score
    while x > 0 and y > 0:
        if curr == MATCH:
            out_a.append(chr(a[x - 1]))
            out_b.append(chr(b[y - 1]))
        elif curr == GAP_A:
            out_a.append("-")
            out_b.append(chr(b[y - 1]))
        else:
            out_a.append(chr(a[x - 1]))
            out_b.append("-")
        curr, cs, x, y = reverse_move(sc, a, b, M, Ga, Gb, curr, cs, x, y)

    while y > 0:  # leading gap in A (needleman_wunsch.c:117-123)
        out_a.append("-")
        out_b.append(chr(b[y - 1]))
        y -= 1
    while x > 0:  # leading gap in B (needleman_wunsch.c:126-132)
        out_a.append(chr(a[x - 1]))
        out_b.append("-")
        x -= 1

    return "".join(reversed(out_a)), "".join(reversed(out_b)), final_score


class SwOracle:
    """smith_waterman_align + fetch (smith_waterman.c:131-277)."""

    def __init__(self, sc: ScoringConfig, seq_a: str, seq_b: str,
                 matrices=None, history=None):
        self.sc = sc
        self.a, self.b = encode(seq_a), encode(seq_b)
        self.M, self.Ga, self.Gb = (
            fill_matrices(sc, seq_a, seq_b, is_sw=True)
            if matrices is None else matrices)
        w = len(self.a) + 1
        flat = self.M.ravel()  # row-major [y][x] == reference flat layout
        idx = np.nonzero(flat > 0)[0]
        # sort: score desc, then x asc; glibc qsort is a stable merge sort so
        # equal keys keep enumeration (pos asc) order (smith_waterman.c:71-86)
        order = np.lexsort((idx % w, -flat[idx].astype(np.int64)))
        self.sorted_indices = idx[order]
        # optional shared buggy-reset mask (traceback.SwRefMaskHistory)
        self._history = history
        self.mask = (np.zeros(flat.shape[0], dtype=bool)
                     if history is None else None)
        self.next_hit = 0

    def _follow_hit(self, arr_index: int):
        w = len(self.a) + 1
        x, y = int(arr_index % w), int(arr_index // w)
        end_x, end_y, end_score = x, y, int(self.M[y, x])
        curr, cs = MATCH, end_score
        path = []  # cells with score>0 emit one char each
        while True:
            if self.mask[y * w + x]:
                return None
            self.mask[y * w + x] = True
            if cs == 0:
                break
            path.append((curr, x, y))
            curr, cs, x, y = reverse_move(
                self.sc, self.a, self.b, self.M, self.Ga, self.Gb, curr, cs, x, y
            )
        out_a, out_b = [], []
        for q, px, py in path:  # path is end->start; reversed once at join
            if q == MATCH:
                out_a.append(chr(self.a[px - 1]))
                out_b.append(chr(self.b[py - 1]))
            elif q == GAP_A:
                out_a.append("-")
                out_b.append(chr(self.b[py - 1]))
            else:
                out_a.append(chr(self.a[px - 1]))
                out_b.append("-")
        return {
            "result_a": "".join(reversed(out_a)),
            "result_b": "".join(reversed(out_b)),
            "score": end_score,
            "pos_a": x,
            "pos_b": y,
            "len_a": end_x - x,
            "len_b": end_y - y,
        }

    def fetch(self):
        if self.mask is None:
            self.mask = self._history.begin_pair(self.M.size)
        while self.next_hit < len(self.sorted_indices):
            arr_index = int(self.sorted_indices[self.next_hit])
            self.next_hit += 1
            if not self.mask[arr_index]:
                hit = self._follow_hit(arr_index)
                if hit is not None:
                    return hit
        return None

    def hits(self, min_score=None, max_hits=None):
        out = []
        while max_hits is None or len(out) < max_hits:
            h = self.fetch()
            if h is None or (min_score is not None and h["score"] < min_score):
                break
            out.append(h)
        return out
