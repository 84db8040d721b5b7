"""The order of work of the fills' register tiles (csrc/tile_fill.cuh),
checked on the CPU at the default flags (tests/test_torch_tile_modes.py
runs the same models under the scoring flags).  :func:`tile_fill_model` is
that order in numpy: a pair's lanes cut into strips of 32*R lanes, a warp
a strip and R lanes a thread, one anti-diagonal a step; the a codes
shifting one lane a step, thread 0 taking its up neighbour and a code from
thread 31's prefetch; the strips of one pair side by side, each K
diagonals behind the one before within a round, their edge through a ring
of RING entries a warp, and between rounds through a row in scratch;
step blocks of R steps run unchecked where every cell is valid, with
their stores split into naturally aligned pieces at unaligned row starts
(:func:`store_pieces`), checked elsewhere.  Registers the kernel never
sets start as random garbage, the warps of one macro step run in a random
order, and every edge read checks that it sees the column it wants,
written in an earlier macro step: so the model also proves the schedule.
It is held with tolerance 0 to the JAX package's ``dp.dp_fill`` (through
``dp.fill_batch``), NW and SW, equality and BLOSUM62, at R of 1, 4 and 8,
b sides one lane short of a strip, a strip, one lane over, three and five
strips, empty sides, the uniform layout and ragged planes at their own
row strides, one round and several.  :func:`tile_carry_model` is the
long pairs' carry on the same tiles (csrc/tile_carry.cuh): one chunk of
columns with the boundary column in and out, each round of a pair's lanes
a block that takes its (pair, round) by ticket, blocks running in a random
order with 1 to 5 resident, and every read of a round row checked against
what its producer has published; it is held chunk by chunk to the JAX
package's ``dp.fill_chunked``.  The kernels themselves are held to the
plain versions on the card by ``tests/test_torch_cuda.py``."""

import functools
import re
from pathlib import Path
from typing import NamedTuple, Optional

import numpy as np
import pytest
import torch

pytest.importorskip("jax.numpy")

from seqalign_tpu.ops import dp  # noqa: E402
from seqalign_tpu.scoring.presets import (  # noqa: E402
    scoring_system_BLOSUM62, scoring_system_default,
    scoring_system_sw_default,
)
from seqalign_tpu_torch import kernel_params  # noqa: E402
from seqalign_tpu_torch.ops import kernels  # noqa: E402
from seqalign_tpu_torch.ops.pack import (  # noqa: E402
    NEG, NGA, NGB, NMM, NSG, pack_batch, ragged_planes,
)

HEADER = (Path(kernels.__file__).parent.parent / "csrc" /
          "tile_fill.cuh").read_text()
K = int(re.search(r"constexpr int K = (\d+);", HEADER).group(1))
RING, LANES = kernels.TILE_RING, kernels.TILE_LANES
MATCH, GAP_A, GAP_B, DIR_FAIL = 0, 1, 2, 3
DNA = "acgtACGT"
PROTEIN = "ARNDCQEGHILKMFPSTWYV"
SCORINGS = {  # (kind, scoring) -> (config, alphabet)
    ("nw", "equality"): (scoring_system_default, DNA),
    ("sw", "equality"): (scoring_system_sw_default, DNA),
    ("nw", "blosum62"): (scoring_system_BLOSUM62, PROTEIN),
    ("sw", "blosum62"): (scoring_system_BLOSUM62, PROTEIN),
}


def w32(x):
    """int64 values wrapped to int32, as the kernel's add()."""
    return (np.asarray(x, np.int64) + 2 ** 31) % 2 ** 32 - 2 ** 31


def store_pieces(e, n, esize):
    """The kernel's ``store_run``: n elements of esize bytes from element
    index e as [(start, count)], greedy, the largest naturally aligned
    power-of-two piece of at most 16 bytes first."""
    c = min(n, 16 // esize)
    out, p = [], 0
    while p < n:
        a, s = (e + p) % c, 1
        while 2 * s <= min(n - p, c) and a % (2 * s) == 0:
            s *= 2
        out.append((p, s))
        p += s
    return out


def pick(ga_ok, gb_ok, m_ok):
    return np.where(ga_ok, GAP_A, np.where(gb_ok, GAP_B,
                                           np.where(m_ok, MATCH, DIR_FAIL)))


class Rec:
    """The stores of one launch: values, how often each cell was written,
    and the pieces of every unchecked store.  ``gab``: the matrix dump's
    M, Ga and Gb planes, ``total`` elements apart in ``m`` (the kernel's
    mout + B*plane, mout + 2*B*plane), their writes in ``mwrites``."""

    def __init__(self, total, mdtype, gab=False):
        self.total = total
        self.codes = np.zeros(total, np.uint8)
        self.m = np.zeros(3 * total if gab else total, mdtype)
        self.writes = np.zeros(total, np.int64)
        self.mwrites = np.zeros(3 * total if gab else 0, np.int64)
        self.pieces = []


class Flags(NamedTuple):
    """The scoring flags of a launch of the MODES instantiations (the
    kernels' ``modes`` word, never 0: the default flags run without one),
    and under NMM with a table the flat is-match table, as ``tab``."""

    modes: int
    im: Optional[np.ndarray] = None


def flags_of(bp):
    """:class:`Flags` of a packed batch's params, or None at the default
    flags."""
    if not bp.modes:
        return None
    im = (bp.im.numpy().ravel().astype(np.int64) if bp.im is not None
          else None)
    return Flags(bp.modes, im)


def cells(h, bcd, up, dg, p1, tab, scal, sw, fl=None, at=None):
    """One step's cells of a warp, (32, R) lanes, as the kernel's cell():
    h the lanes' a codes (times kb under a table), bcd their b codes, up
    the (M, Ga, Gb) at (y-1, x), dg at (y-1, x-1), p1 at (y, x-1); with
    the flags ``fl`` where ``at`` (:func:`where_flags`) says they act.
    Returns (ss, M, Ga, Gb) before the boundary column."""
    match, mismatch, go, ge = (int(v) for v in scal[:4])
    mn = int(scal[5] if sw else scal[4])
    gop = int(w32(go + ge))
    ss = (tab[h + bcd] if tab is not None
          else np.where(h == bcd, match, mismatch))
    M = np.maximum(w32(dg.max(0) + ss), mn)
    Ga = np.maximum.reduce([w32(up[0] + gop), w32(up[1] + ge),
                            w32(up[2] + gop), np.full_like(M, mn)])
    Gb = np.maximum.reduce([w32(p1[0] + gop), w32(p1[1] + gop),
                            w32(p1[2] + ge), np.full_like(M, mn)])
    if fl is not None:
        if fl.modes & NMM:
            ism = fl.im[h + bcd] != 0 if tab is not None else h == bcd
            M = np.where(ism, M, mn)
        if fl.modes & NEG:  # no penalty, no floor
            Ga = np.where(at["lcol"], up.max(0), Ga)
            Gb = np.where(at["lrow"], p1.max(0), Gb)
        if fl.modes & NGA:
            Ga = np.where(at["lcol"], Ga, mn)
        if fl.modes & NGB:
            Gb = np.where(at["lrow"], Gb, mn)
    return ss, M, Ga, Gb


def cell_codes(ss, M, Ga, Gb, up, dg, p1, scal, fl=None, at=None):
    """The direction codes of :func:`cells`' lanes, as the kernel compares
    them (p == v - c for add(p, c) == v); with the flags, their guards
    and the end gaps' penalty 0."""
    ge = int(scal[3])
    gop = int(w32(int(scal[2]) + ge))
    tm = w32(M - ss)
    if fl is None:
        return (pick(dg[1] == tm, dg[2] == tm, dg[0] == tm)
                | pick(up[1] == w32(Ga - ge), up[2] == w32(Ga - gop),
                       up[0] == w32(Ga - gop)) << 2
                | pick(p1[1] == w32(Gb - gop), p1[2] == w32(Gb - ge),
                       p1[0] == w32(Gb - gop)) << 4)
    neg, nga, ngb = (bool(fl.modes & f) for f in (NEG, NGA, NGB))
    ea, eb = neg & at["lcol"], neg & at["lrow"]
    tae, tao = np.where(ea, Ga, w32(Ga - ge)), np.where(ea, Ga, w32(Ga - gop))
    tbo, tbe = np.where(eb, Gb, w32(Gb - gop)), np.where(eb, Gb, w32(Gb - ge))
    diag_a, diag_b = (not nga) | at["xone"], (not ngb) | at["yone"]
    up_a, left_b = (not nga) | at["lcol"], (not ngb) | at["lrow"]
    return (pick(diag_a & (dg[1] == tm), diag_b & (dg[2] == tm), dg[0] == tm)
            | pick(up_a & (up[1] == tae), diag_b & (up[2] == tao),
                   up[0] == tao) << 2
            | pick(diag_a & (p1[1] == tbo), left_b & (p1[2] == tbe),
                   p1[0] == tbo) << 4)


def where_flags(fl, x, y, lc, x1, nb, checked):
    """Where the flags act on one step's (32, R) lanes at local columns x
    and rows y, as the kernel's cell() tests them: the pair's last column
    (local lc) and the column x1 of global x == 1 in checked step blocks
    only (an unchecked block holds neither: asserted, the widened test of
    the kernel's step blocks), the rows y == nb and y == 1 in every
    block.  None without flags."""
    if fl is None:
        return None
    if not checked:
        assert not ((x == lc) | (x == x1)).any(), "a flag's column unchecked"
    return {"lcol": checked & (x == lc), "xone": checked & (x == x1),
            "lrow": y == nb, "yone": y == 1}


def tile_fill_model(a, b, na, nb, scal, tab, kb, sw, dirs, mbytes, R, W,
                    at, LBp, LA, rec, rng, fl=None, gab=False):
    """One pair's block of the tile fill: a, b its codes (the kernel's
    inputs), ``tab`` the flat substitution table or None (equality),
    ``kb`` its row length; codes (``dirs``) and M (``mbytes`` 2 or 4) go
    to ``rec`` at element ``at`` with rows of ``LBp`` lanes, and with
    ``gab`` (the GAB instantiations, M int32) Ga and Gb to the planes
    behind M's (:class:`Rec`).  W: warps of the block; ``fl``: the scoring
    flags (:class:`Flags`) of a MODES instantiation, or None.  Returns
    (corner or None, score)."""
    go, ge = int(scal[2]), int(scal[3])
    mn = int(scal[5] if sw else scal[4])
    nsg = fl is not None and bool(fl.modes & NSG)

    def run(k):
        return (np.zeros_like(k) if sw or nsg
                else w32(go + np.asarray(k) * ge))

    if na == 0 or nb == 0:
        if sw:
            return None, 0
        c = (0, 0, 0) if na == nb == 0 else (
            (mn, int(run(nb)), mn) if na == 0 else (mn, mn, int(run(na))))
        return c, max(c)
    S = 32 * R
    nstrips = -(-nb // S)
    Wj = min(nstrips, W)
    steps = -(-(na + S) // R) * R
    ndur = -(-steps // K)
    P = max(ndur + R + 1, Wj * (R + 1))
    last = nstrips - 1
    ttot = last // Wj * P + last % Wj * (R + 1) + ndur
    # the step blocks that run unchecked: under flags none holds a cell of
    # the columns x == 1 or x == na
    ulo, uhi = (S, na) if fl is None else (S + R, na - 1)
    garbage = functools.partial(rng.integers, -2 ** 31, 2 ** 31,
                                dtype=np.int64)

    def agarbage(shape):
        """a codes the kernel never reads from a: under a table any row of
        it (the kernel keeps them in range, 0 where it has none)."""
        if tab is None:
            return garbage(shape)
        return rng.integers(0, len(tab) // kb, shape, dtype=np.int64) * kb
    ring = garbage((Wj, 3, RING))
    ring_at = np.full((Wj, RING, 2), -1, np.int64)  # (column, macro step)
    rows = garbage((3, LA + 1)) if nstrips > Wj else None
    rows_at = np.full((LA + 1, 2), -1, np.int64)
    lanes = np.arange(32)[:, None]
    rr = np.arange(R)[None, :]
    state = [None] * Wj
    out = {"corner": None, "best": 0}

    def fetch(st, w, s, x, t):
        """Thread 31: thread 0's up neighbour at column x, and its a
        code, as the kernel fetches them in macro step t."""
        if s == 0:
            st["p"] = (np.array([0, 0, 0]) if x == 0 else
                       np.array([mn, mn, int(run(x))]))
        elif w > 0:
            if x <= na:
                col, when = ring_at[w - 1, x % RING]
                assert col == x and when < t, (w, x, col, when, t)
            st["p"] = ring[w - 1, :, x % RING].copy()
        elif x <= na:
            col, when = rows_at[x]
            assert col == x and when < t, (x, col, when, t)
            st["p"] = rows[:, x].copy()
        st["ph"] = (int(a[x - 1]) * (kb if tab is not None else 1)
                    if 1 <= x <= na else int(agarbage(())))

    def begin(w, s, t):
        ys = s * S + 1
        y = ys + lanes * R + rr
        st = {"s": s, "ys": ys, "y": y, "full": ys + S - 1 <= nb,
              "bcd": np.where(y <= nb, b[np.minimum(y, nb) - 1], 0),
              "h": agarbage((32, R)), "p1": garbage((3, 32, R)),
              "p2": garbage((3, 32, R)), "u2": garbage((3, 32))}
        fetch(st, w, s, 0, t)
        state[w] = st

    def step(w, i, checked, t):
        st = state[w]
        s, ys, y = st["s"], st["ys"], st["y"]
        p1, p2 = st["p1"], st["p2"]
        send = p1[:, :, R - 1].copy()
        send[:, 31] = st["p"]
        u1 = np.roll(send, 1, axis=1)
        sendh = st["h"][:, R - 1].copy()
        sendh[31] = st["ph"]
        h = np.concatenate([np.roll(sendh, 1)[:, None], st["h"][:, :-1]], 1)
        fetch(st, w, s, i + 1, t)
        up = np.concatenate([u1[:, :, None], p1[:, :, :-1]], 2)
        dg = np.concatenate([st["u2"][:, :, None], p2[:, :, :-1]], 2)
        x = i - lanes * R - rr
        fa = where_flags(fl, x, y, na, 1, nb, checked)
        ss, M, Ga, Gb = cells(h, st["bcd"], up, dg, p1, tab, scal, sw, fl,
                              fa)
        valid = (x >= 1) & (x <= na) & (y <= nb)
        if checked:
            b0 = x == 0
            M, Ga, Gb = (np.where(b0, mn, M), np.where(b0, run(y), Ga),
                         np.where(b0, mn, Gb))
        else:
            assert valid.all()
        code = cell_codes(ss, M, Ga, Gb, up, dg, p1, scal, fl, fa)
        if sw and valid.any():
            out["best"] = max(out["best"], int(M[valid].max()))
        base = at + (ys + i - 2) * LBp  # the row of diagonal d = ys + i
        if checked:
            tt, r_ = np.nonzero(valid)
            idx = base + y[tt, r_]
            write(idx, code[tt, r_], M[tt, r_], Ga[tt, r_], Gb[tt, r_])
        else:  # a thread's R lanes are R elements of one row
            for tt in range(32):
                e0 = base + int(y[tt, 0])
                for es in ([1] if dirs else []) + ([mbytes] if mbytes else []):
                    rec.pieces.append((e0, es, store_pieces(e0, R, es)))
                for k in (1, 2) if gab else ():  # Ga, Gb: store_run too
                    e = e0 + k * rec.total
                    rec.pieces.append((e, 4, store_pieces(e, R, 4)))
            write((base + y).ravel(), code.ravel(), M.ravel(), Ga.ravel(),
                  Gb.ravel())
        if not sw and s == last and i == na + nb - ys:
            assert checked
            tc, rc = divmod(nb - ys, R)
            out["corner"] = (int(M[tc, rc]), int(Ga[tc, rc]), int(Gb[tc, rc]))
        st["p2"] = p1
        st["p1"] = np.stack([M, Ga, Gb])
        st["u2"], st["h"] = u1, h
        xo = i - S + 1  # thread 31's last lane, for the next strip
        val = st["p1"][:, 31, R - 1]
        if s < last and w < Wj - 1:
            ring[w, :, xo % RING] = val
            ring_at[w, xo % RING] = (xo, t)
        elif s < last and 0 <= xo <= na:
            rows[:, xo] = val
            rows_at[xo] = (xo, t)

    def write(idx, codes, m, ga, gb):
        if dirs:
            rec.codes[idx] = codes
        if mbytes:
            rec.m[idx] = m
        if gab:
            rec.m[idx + rec.total] = ga
            rec.m[idx + 2 * rec.total] = gb
            for k in range(3):
                rec.mwrites[idx + k * rec.total] += 1
        rec.writes[idx] += 1

    for t in range(ttot):
        for w in rng.permutation(Wj):
            rel = t - w * (R + 1)
            if rel < 0:
                continue
            q, s = rel % P, rel // P * Wj + w
            if s >= nstrips or q >= ndur:
                continue
            if q == 0:
                begin(w, s, t)
            for i0 in range(q * K, min(q * K + K, steps), R):
                st = state[w]
                unchecked = st["full"] and i0 >= ulo and i0 + R - 1 <= uhi
                for u in range(R):
                    step(w, i0 + u, not unchecked, t)
    if sw:
        return None, out["best"]
    return out["corner"], max(out["corner"])


def pairs_for(R, alpha, seed):
    """Pairs at the strip edges of R: b one lane short of a strip, a
    strip, one over, three strips and a bit (its a side long enough for
    unchecked blocks), short ones, and empty sides."""
    S = 32 * R
    rng = np.random.default_rng(seed)
    letters = np.array(list(alpha))
    # the last pair: five strips, so that a warp's second strip writes its
    # ring while the next warp still reads its first strip's edge, with
    # ndur = ceil((na + S) / K) = 1 mod RING / K, where the ring's columns
    # of the two meet
    ndur = next(n for n in range(1, 99) if n % 4 == 1 and n > 2 * (R + 1))
    lens = [(37, S - 1), (29, S), (41, S + 1), (S + 3 * R + 5, 2 * S + 3),
            (S + 2 * R, S), (1, 5), (0, 9), (12, 0), (0, 0), (3, 1),
            (ndur * K - S - R, 4 * S + 5)]

    def text(n):
        return "".join(letters[rng.integers(0, len(letters), n)])

    return [text(n) for n, _ in lens], [text(m) for _, m in lens]


@functools.lru_cache(maxsize=None)
def reference(kind, scoring, R):
    """The JAX package's fill of :func:`pairs_for`'s pairs."""
    make, alpha = SCORINGS[kind, scoring]
    sc = make()
    A, B = pairs_for(R, alpha, 100 * R + len(kind) + len(scoring))
    LA, LB = max(map(len, A)), max(map(len, B))
    out, na, nb = dp.fill_batch(sc, A, B, is_sw=kind == "sw",
                                emit_dirs=True, emit_m=kind == "sw",
                                pad_a=LA, pad_b=LB, validate=False)
    return sc, A, B, out, na, nb


def model_launch(sc, A, B, sw, R, W, ragged, seed, gab=False):
    """The model over every pair of one launch, as the wrapper lays it
    out (``gab``: the matrix dump's, uniform, M int32 for NW too):
    returns (corners, scores, rec, off, na, nb, LB, mbytes)."""
    p = kernel_params(sc, "cpu")
    LA, LB = max(1, max(map(len, A))), max(1, max(map(len, B)))
    ac, bc, na, nb, bp = pack_batch(sc, p, A, B, LA, LB)
    tab = None if bp.sub is None else bp.sub.numpy().ravel().astype(np.int64)
    kb = 0 if bp.sub is None else bp.sub.shape[1]
    fl = flags_of(bp)
    if ragged:
        off = ragged_planes(na, nb)
    else:
        off = np.arange(len(A) + 1) * (LA + LB - 1) * (LB + 1)
    mbytes = 4 if gab else (2 if ragged else 4) if sw else 0  # M's bytes
    rec = Rec(int(off[-1]), np.int16 if mbytes == 2 else np.int32, gab)
    rng = np.random.default_rng(seed)
    corners, scores = [], []
    for j in range(len(A)):
        LBp = max(int(nb[j]), 1) + 1 if ragged else LB + 1
        c, s = tile_fill_model(ac[j], bc[j], int(na[j]), int(nb[j]),
                               p.scal.numpy(), tab, kb, sw, True, mbytes, R,
                               W, int(off[j]), LBp, LA, rec, rng, fl, gab)
        corners.append(c)
        scores.append(s)
    return corners, scores, rec, off, na, nb, LB, mbytes


class Part(NamedTuple):
    """A slice of a carry launch (csrc/tile_carry.cuh, SLICE): the rounds
    r_lo .. r_hi-1, the edge row in (``ein`` (B, 3, ca+1) values and
    ``ein_at`` (B, ca+1), the column its producer wrote at each slot, -1
    where it wrote none) for r_lo > 0, and the edge row out with its record
    (``eout``, ``eout_at``, filled in place) or None."""

    r_lo: int
    r_hi: int
    ein: Optional[np.ndarray] = None
    ein_at: Optional[np.ndarray] = None
    eout: Optional[np.ndarray] = None
    eout_at: Optional[np.ndarray] = None


def tile_carry_model(ac, bc, na, nb, scal, tab, kb, sw, R, W, x_off, ca,
                     bin, bout, rec, bw, corner, best, resident, rng,
                     fl=None, part=None):
    """One carry launch (csrc/tile_carry.cuh) over a packed
    batch, ``ac`` (B, LA) and ``bc`` (B, LB) its codes: the chunk of ``ca``
    columns from ``x_off``, ``bin`` (B, 3, LB+1) the column x_off in,
    ``bout`` the column x_off+ca out (``bw`` counts its writes); codes and
    M go to ``rec`` (a :class:`Rec` of the (B, ca+LB-1, LB+1) slab),
    ``corner`` (B, 3) and ``best`` (B,) change in place.  A block of W
    warps fills one round of one pair; blocks take tickets in order,
    ticket t being pair t mod B and round t // B, and at most ``resident``
    blocks are alive.  One alive block at a time, picked at random, runs
    its next macro step, its warps in a random order, unless warp 0 waits
    for columns its round row has not published; when every alive block
    waits, the launch has deadlocked and the model fails.  Every read of a
    round row checks that the column was written and published, every
    ring read that it was written in an earlier macro step; registers the
    kernel never sets start as garbage.  ``fl``: the scoring flags
    (:class:`Flags`) of a MODES instantiation, or None; their last column
    and x == 1 at global x (local na - x_off and 1 - x_off).  ``part``: a
    slice (:class:`Part`) of the launch, its rounds alone; its first round
    reads the edge row in, which must hold every column it reads as its
    producer wrote it, with no word to wait on, and its last round writes
    the edge row out and publishes nothing."""
    B, LA = ac.shape
    LB = bc.shape[1]
    LBp, D, S = LB + 1, ca + LB - 1, 32 * R
    go, ge = int(scal[2]), int(scal[3])
    mn = int(scal[5] if sw else scal[4])
    kmul = kb if tab is not None else 1
    rounds = -(-(-(-max(LB, 1) // S)) // W)
    r0 = 0
    if part is not None:
        assert 0 <= part.r_lo < part.r_hi <= rounds
        r0, rounds = part.r_lo, part.r_hi - part.r_lo
    nrows = B * (rounds - 1)
    garbage = functools.partial(rng.integers, -2 ** 31, 2 ** 31,
                                dtype=np.int64)

    def agarbage(shape):  # as in tile_fill_model
        if tab is None:
            return garbage(shape)
        return rng.integers(0, len(tab) // kb, shape, dtype=np.int64) * kb

    words = np.zeros(nrows, np.int64)
    rows = garbage((nrows, 3, ca + 1))
    rows_at = np.full((nrows, ca + 1), -1, np.int64)
    lanes = np.arange(32)[:, None]
    rr = np.arange(R)[None, :]

    nsg = fl is not None and bool(fl.modes & NSG)

    def run(k):
        return (np.zeros_like(k) if sw or nsg
                else w32(go + np.asarray(k) * ge))

    def block(t):
        j, rl = t % B, t // B
        r = r0 + rl
        ein = part is not None and rl == 0 and r > 0
        eout = part is not None and rl == rounds - 1
        naj, nbj = min(max(int(na[j]), 0), LA), min(max(int(nb[j]), 0), LB)
        wa = max(0, min(ca, naj - x_off))
        if not sw and r == 0:
            if wa == 0 and naj == 0 and x_off == 0:  # the cell (nb, 0)
                corner[j] = bin[j, :, nbj]
            elif wa > 0 and nbj == 0 and naj <= x_off + ca:  # (0, na)
                corner[j] = (mn, mn, int(run(naj)))
        if wa == 0 or nbj == 0:
            return
        nstrips = -(-nbj // S)
        Wj = min(W, nstrips - r * W)
        if Wj <= 0:
            return
        a = ac[j, x_off:x_off + wa]
        steps = -(-(wa + S) // R) * R
        ndur = -(-steps // K)
        last = nstrips - 1
        none = -(1 << 40)  # a column no lane reaches
        bcol = ca if wa == ca else none
        cx = wa if naj <= x_off + ca else none
        # the unchecked step blocks: left of the column out, and under
        # flags off the columns of global x == 1 and x == na
        ulo, ulim = (S, wa - 1 if wa == ca else wa) if fl is None else (
            S + R, wa - 1)
        rin, rout = (rl - 1) * B + j, rl * B + j
        ring = garbage((Wj, 3, RING))
        ring_at = np.full((Wj, RING, 2), -1, np.int64)
        state = [None] * Wj
        blk = {"seen": 0, "best": 0}

        def fetch(st, w, s, x, tt):
            if s == 0:  # the global row-0 cell (0, x_off + x)
                xg = x_off + x
                st["p"] = (np.array([0, 0, 0]) if xg == 0 else
                           np.array([mn, mn, int(run(xg))]))
            elif w > 0:
                if x <= wa:
                    col, when = ring_at[w - 1, x % RING]
                    assert col == x and when < tt, (w, x, col, when, tt)
                st["p"] = ring[w - 1, :, x % RING].copy()
            elif x <= wa and ein:  # the edge row in, complete
                assert part.ein_at[j, x] == x, (j, x, part.ein_at[j, x])
                st["p"] = part.ein[j, :, x].copy()
            elif x <= wa:  # the round row, published up to "seen"
                assert x < blk["seen"] and rows_at[rin, x] == x, (
                    x, blk["seen"], rows_at[rin, x])
                st["p"] = rows[rin, :, x].copy()
            st["ph"] = (int(a[x - 1]) * kmul if 1 <= x <= wa
                        else int(agarbage(())))

        def begin(w, s, tt):
            ys = s * S + 1
            y = ys + lanes * R + rr
            st = {"ys": ys, "y": y, "full": ys + S - 1 <= nbj,
                  "bcd": np.where(y <= nbj, bc[j][np.minimum(y, nbj) - 1],
                                  0),
                  "h": agarbage((32, R)), "p1": garbage((3, 32, R)),
                  "p2": garbage((3, 32, R)), "u2": garbage((3, 32))}
            fetch(st, w, s, 0, tt)
            state[w] = st

        def step(w, s, i, checked, tt):
            st = state[w]
            ys, y, p1, p2 = st["ys"], st["y"], st["p1"], st["p2"]
            send = p1[:, :, R - 1].copy()
            send[:, 31] = st["p"]
            u1 = np.roll(send, 1, axis=1)
            sendh = st["h"][:, R - 1].copy()
            sendh[31] = st["ph"]
            h = np.concatenate([np.roll(sendh, 1)[:, None], st["h"][:, :-1]],
                               1)
            fetch(st, w, s, i + 1, tt)
            up = np.concatenate([u1[:, :, None], p1[:, :, :-1]], 2)
            dg = np.concatenate([st["u2"][:, :, None], p2[:, :, :-1]], 2)
            x = i - lanes * R - rr
            fa = where_flags(fl, x, y, naj - x_off, 1 - x_off, nbj, checked)
            ss, M, Ga, Gb = cells(h, st["bcd"], up, dg, p1, tab, scal, sw, fl,
                                  fa)
            valid = (x >= 1) & (x <= wa) & (y <= nbj)
            if checked:  # lane x == 0 takes the carried column
                b0 = (x == 0) & (y <= nbj)
                yb = np.minimum(y, nbj)
                M, Ga, Gb = (np.where(b0, bin[j, k, yb], v)
                             for k, v in enumerate((M, Ga, Gb)))
            else:
                assert valid.all() and not (x == bcol).any()
            code = cell_codes(ss, M, Ga, Gb, up, dg, p1, scal, fl, fa)
            if sw and valid.any():
                blk["best"] = max(blk["best"], int(M[valid].max()))
            base = j * D * LBp + (ys + i - 2) * LBp
            if checked:
                tt_, r_ = np.nonzero(valid)
                idx = base + y[tt_, r_]
                write(idx, code[tt_, r_], M[tt_, r_])
                out = valid & (x == bcol)
                for k, v in enumerate((M, Ga, Gb)):
                    bout[j, k, y[out]] = v[out]
                bw[j, y[out]] += 1
                hit = valid & (x == cx) & (y == nbj)
                if not sw and hit.any():
                    corner[j] = (int(M[hit][0]), int(Ga[hit][0]),
                                 int(Gb[hit][0]))
            else:
                for tq in range(32):
                    e0 = base + int(y[tq, 0])
                    rec.pieces.append((e0, 1, store_pieces(e0, R, 1)))
                write((base + y).ravel(), code.ravel(), M.ravel())
            st["p2"] = p1
            st["p1"] = np.stack([M, Ga, Gb])
            st["u2"], st["h"] = u1, h
            xo = i - S + 1  # thread 31's last lane, for the next strip
            val = st["p1"][:, 31, R - 1]
            if s < last and w < Wj - 1:
                ring[w, :, xo % RING] = val
                ring_at[w, xo % RING] = (xo, tt)
            elif s < last and 0 <= xo <= wa and eout:
                if part.eout is not None:
                    part.eout[j, :, xo] = val
                    part.eout_at[j, xo] = xo
            elif s < last and 0 <= xo <= wa:
                rows[rout, :, xo] = val
                rows_at[rout, xo] = xo

        for tt in range((Wj - 1) * (R + 1) + ndur):
            for w in rng.permutation(Wj):
                q = tt - w * (R + 1)
                if not 0 <= q < ndur:
                    continue
                if w == 0 and rl > 0:  # columns up to (q + 1) K
                    need = min((q + 1) * K, wa) + 1
                    while blk["seen"] < need:
                        if words[rin] >= need:
                            blk["seen"] = int(words[rin])
                        else:
                            yield False
                s = r * W + w
                if q == 0:
                    begin(w, s, tt)
                for i0 in range(q * K, min(q * K + K, steps), R):
                    unchecked = (state[w]["full"] and i0 >= ulo
                                 and i0 + R - 1 <= ulim)
                    for u in range(R):
                        step(w, s, i0 + u, not unchecked, tt)
                if s < last and w == Wj - 1 and not eout:  # publish them
                    done = min((q + 1) * K - S + 1, wa + 1)
                    if done > 0:
                        words[rout] = done
            yield True  # the block's barrier
        if sw and blk["best"] > 0:
            best[j] = max(int(best[j]), blk["best"])

    def write(idx, codes, m):
        rec.codes[idx] = codes
        rec.m[idx] = m
        rec.writes[idx] += 1

    alive, nxt = [], 0
    while True:
        while len(alive) < resident and nxt < B * rounds:
            alive.append(block(nxt))
            nxt += 1
        if not alive:
            return
        for k in rng.permutation(len(alive)):
            try:
                if next(alive[k]):
                    break
            except StopIteration:
                alive.pop(k)
                break
        else:
            raise AssertionError("every resident block waits: deadlock")


@pytest.mark.parametrize("layout", ["uniform", "ragged"])
@pytest.mark.parametrize("rounds", ["one", "several"])
@pytest.mark.parametrize("scoring", ["equality", "blosum62"])
@pytest.mark.parametrize("kind", ["nw", "sw"])
@pytest.mark.parametrize("R", [1, 4, 8])
def test_tile_model_equals_dp_fill(R, kind, scoring, rounds, layout):
    sc, A, B, out, jna, jnb = reference(kind, scoring, R)
    # one round: the kernel's block (LANES lanes); several: 2 warps, so
    # that the three-strip pair hands its edge over through the row
    W = LANES // (32 * R) if rounds == "one" else 2
    assert_model_launch(sc, A, B, out, kind == "sw", R, W, layout == "ragged",
                        R + len(kind))


def assert_model_launch(sc, A, B, out, sw, R, W, ragged, seed, gab=False):
    """:func:`model_launch` of the pairs A, B under ``sc`` against the JAX
    package's fill ``out`` of them (``dp.fill_batch``), tolerance 0: every
    valid cell written once and nothing else, its code and SW M (with
    ``gab`` M, Ga and Gb, NW too, against ``emit_gab``'s planes), the SW
    best and the NW corner; unchecked step blocks ran where a pair has
    room for them."""
    layout = "ragged" if ragged else "uniform"
    corners, scores, rec, off, na, nb, LB, mbytes = model_launch(
        sc, A, B, sw, R, W, ragged, seed, gab)
    dirs = np.asarray(out.dirs)
    mm = np.asarray(out.mmat) if sw or gab else None
    planes = ([mm, np.asarray(out.gamat), np.asarray(out.gbmat)] if gab
              else [mm])
    def equal(got, want):  # assert_array_equal, at np.array_equal's cost
        if not np.array_equal(got, want):
            np.testing.assert_array_equal(got, want)

    for j in range(len(A)):
        lanes = max(int(nb[j]), 1) + 1 if layout == "ragged" else LB + 1
        plane = slice(int(off[j]), int(off[j + 1]))
        shape = (-1, lanes)
        codes = rec.codes[plane].reshape(shape)
        writes = rec.writes[plane].reshape(shape)
        rows = codes.shape[0]
        d = np.arange(rows)[:, None]
        y = np.arange(lanes)[None, :]
        x = d + 2 - y
        v = (y >= 1) & (y <= nb[j]) & (x >= 1) & (x <= na[j])
        # every valid cell written once, nothing else
        equal(writes, v.astype(np.int64))
        # the reference's cells (d, y) of this plane's rows and lanes
        equal(codes[v], dirs[j][:rows, :lanes][v])
        for k, want_k in enumerate(planes if sw or gab else []):
            at_k = slice(plane.start + k * rec.total,
                         plane.stop + k * rec.total)
            m = rec.m[at_k].reshape(shape)
            equal(m[v], want_k[j][:rows, :lanes][v])
            if gab:
                equal(rec.mwrites[at_k].reshape(shape), v.astype(np.int64))
        if sw:
            assert scores[j] == int(np.asarray(out.best)[j])
        else:
            assert corners[j] == tuple(int(c) for c in
                                       np.asarray(out.corner)[j])
            assert scores[j] == max(corners[j])
    if R > 1 and any(len(a) >= 32 * R + R for a in A):
        assert rec.pieces, "no unchecked block ran"


@pytest.mark.parametrize("esize", [1, 2, 4])
@pytest.mark.parametrize("R", [1, 4, 8])
def test_store_pieces_are_aligned_and_cover_the_run(R, esize):
    c = min(R, 16 // esize)
    for e in range(64):
        ps = store_pieces(e, R, esize)
        assert sum(n for _, n in ps) == R
        assert [p for p, _ in ps] == list(np.cumsum([0] + [n for _, n in
                                                           ps])[:-1])
        for p, n in ps:
            assert (e + p) % n == 0 and n * esize <= 16 and n & (n - 1) == 0
        if e % c == 0:
            assert len(ps) == R // c  # an aligned row start: whole stores
    assert store_pieces(1, 8, 1) == [(0, 1), (1, 2), (3, 4), (7, 1)]
    assert store_pieces(3, 8, 4) == [(0, 1), (1, 4), (5, 2), (7, 1)]


def test_header_constants_match_the_wrapper():
    for name, v in (("RING", RING), ("LANES", LANES),
                    ("THREAD_LANES", kernels.TILE_R),
                    ("GAB_LANES", kernels.GAB_R)):
        assert re.search(rf"constexpr int {name} = {v};", HEADER), name
    assert RING >= 2 * K + 2 and LANES % (32 * kernels.TILE_R) == 0


def test_fill_schedule_marks_the_pairs_past_one_round():
    na = np.array([10, 3000, 5, 9000, 7])
    nb = np.array([LANES, LANES + 1, 0, 9000, 2])
    s = kernels.fill_schedule(na, nb, "cpu")
    assert s.wrap.tolist() == [-1, 0, -1, 1, -1] and s.nwrap == 2


def carry_pairs(regime, alpha, seed):
    """The chunk width and pairs of a carry model case, for 512 lanes of b
    a round (R = 1 at 16 warps, R = 4 at 4): ``narrow`` chunks of 48
    columns, narrower than the lanes, over b of 1, 3 and 5 rounds (the last
    pair ends on the last column of chunk 1), a pair that ends inside
    chunk 1, one that ends before chunk 2, one on the first column of
    chunk 1, and empty sides; ``wide`` chunks
    of 700 columns, wider than the b of 1 round, over b of 1 and 3 rounds,
    a pair that ends on the last column of chunk 0 and one inside chunk
    1; ``flags`` chunks of 200 columns, wider than a strip of R = 4, over
    b of 1, 2 and 3 rounds of R = 4 at 4 warps, pairs that end on the last
    column of chunk 1, on its first, inside chunk 0 and on its last, and
    empty sides."""
    L = 512
    if regime == "flags":  # the flagged carry's: chunks of 200 columns
        ca = 200
        lens = [(2 * ca, L + 3), (ca + 1, 2 * L + 37), (130, L - 7),
                (ca, 300), (70, 40), (0, 50), (40, 0), (0, 0)]
    elif regime == "narrow":
        ca = 48
        lens = [(130, L - 7), (100, 2 * L + 37), (2 * ca, 4 * L + 5),
                (70, 40), (30, L + 3), (0, 50), (40, 0), (0, 0),
                (ca + 1, 300)]
    else:
        ca = 700
        lens = [(900, L - 7), (650, 2 * L + 37), (ca, 300), (760, 130)]
    rng = np.random.default_rng(seed)
    letters = np.array(list(alpha))

    def text(n):
        return "".join(letters[rng.integers(0, len(letters), n)])

    return ca, [text(n) for n, _ in lens], [text(m) for _, m in lens]


@functools.lru_cache(maxsize=None)
def carry_reference(kind, scoring, regime, make=None):
    """The JAX package's ``dp.fill_chunked`` of :func:`carry_pairs`' pairs,
    and ``dp.fill_batch``'s corners of the pairs with an empty seq_a (whose
    corner fill_chunked leaves at 0); under ``make()``'s config when given,
    else the default of ``kind`` and ``scoring``."""
    default, alpha = SCORINGS[kind, scoring]
    sc = (make or default)()
    sw = kind == "sw"
    ca, A, B = carry_pairs(regime, alpha, len(kind) + 3 * len(scoring)
                           + len(regime))
    ref = dp.fill_chunked(sc, A, B, is_sw=sw, chunk=ca, emit_dirs=True,
                          emit_m=sw, validate=False)
    empty = [i for i, a in enumerate(A) if not a]
    corners = {}
    if empty and not sw:
        out, _, _ = dp.fill_batch(sc, [A[i] for i in empty],
                                  [B[i] for i in empty], is_sw=False,
                                  emit_dirs=False, pad_a=1,
                                  pad_b=max(1, max(len(B[i]) for i in empty)),
                                  validate=False)
        corners = dict(zip(empty, np.asarray(out.corner).tolist()))
    return sc, ca, A, B, ref, corners


@pytest.mark.parametrize("scoring", ["equality", "blosum62"])
@pytest.mark.parametrize("kind", ["nw", "sw"])
@pytest.mark.parametrize("R,W,regime", [(1, 16, "narrow"), (4, 4, "narrow"),
                                        (4, 4, "wide")],
                         ids=["R1W16-narrow", "R4W4-narrow", "R4W4-wide"])
def test_tile_carry_model_equals_fill_chunked(R, W, regime, kind, scoring):
    """The carry model (:func:`tile_carry_model`), chunk by chunk with the
    boundary column carried as the aligners carry it, against the JAX
    package's ``dp.fill_chunked`` with tolerance 0: every valid cell of
    every slab written once and nothing else, codes and SW M (int16 at
    R = 1, int32 at R = 4) on them, bout on lanes 1 .. nb of the pairs that
    reach a chunk's last column and nowhere else, the SW best and the NW
    corner; rounds on blocks in a random order, 1 to 5 of them resident.
    Chunks wider than a strip run unchecked step blocks (R = 4, wide)."""
    assert_carry_model(carry_reference(kind, scoring, regime), kind == "sw",
                       R, W, regime, R * 7 + W + len(kind + scoring + regime))


def assert_carry_model(reference, sw, R, W, regime, seed):
    """The checks of :func:`test_tile_carry_model_equals_fill_chunked` on
    one :func:`carry_reference`."""
    from seqalign_tpu_torch.ops import dp as port_dp
    from seqalign_tpu_torch.ops.pack import m16_safe

    sc, ca, A, B, ref, empty_corners = reference
    corner_ref, best_ref, dch, mch, _, _ = ref
    p = kernel_params(sc, "cpu")
    LA, LB = max(1, max(map(len, A))), max(1, max(map(len, B)))
    ac, bc, na, nb, bp = pack_batch(sc, p, A, B, LA, LB)
    tab = None if bp.sub is None else bp.sub.numpy().ravel().astype(np.int64)
    kb = 0 if bp.sub is None else bp.sub.shape[1]
    fl = flags_of(bp)
    m16 = sw and R == 1 and m16_safe(sc, LA, LB)
    nB, D, LBp = len(A), ca + LB - 1, LB + 1
    rng = np.random.default_rng(seed)
    bin = port_dp.boundary_column(bp, nB, LB, is_sw=sw).numpy().astype(
        np.int64)
    corner = np.zeros((nB, 3), np.int64)
    best = np.zeros(nB, np.int64)
    y = np.arange(LBp)[None, None, :]
    xl = np.arange(D)[None, :, None] + 2 - y
    unchecked = 0
    assert len(dch) == -(-LA // ca)
    for c in range(len(dch)):
        rec = Rec(nB * D * LBp, np.int16 if m16 else np.int32)
        bw = np.zeros((nB, LBp), np.int64)
        bout = rng.integers(-2 ** 31, 2 ** 31, (nB, 3, LBp))
        before = bout.copy()
        tile_carry_model(ac, bc, na, nb, p.scal.numpy(), tab, kb, sw, R, W,
                         c * ca, ca, bin, bout, rec, bw, corner, best,
                         int(rng.choice([1, 2, 3, 5])), rng, fl)
        unchecked += len(rec.pieces)
        v = ((y >= 1) & (y <= nb[:, None, None]) & (xl >= 1) & (xl <= ca)
             & (xl + c * ca <= na[:, None, None]))
        writes = rec.writes.reshape(nB, D, LBp)
        np.testing.assert_array_equal(writes, v.astype(np.int64))
        codes = rec.codes.reshape(nB, D, LBp)
        np.testing.assert_array_equal(codes[v], np.asarray(dch[c])[v])
        if sw:
            m = rec.m.reshape(nB, D, LBp)
            np.testing.assert_array_equal(m[v], np.asarray(mch[c])[v])
        reach = (na >= (c + 1) * ca)[:, None] & (y[0] >= 1) & (
            y[0] <= nb[:, None])
        np.testing.assert_array_equal(bw, reach.astype(np.int64))
        keep = np.broadcast_to(~reach[:, None, :], bout.shape)
        np.testing.assert_array_equal(bout[keep], before[keep])
        bin = bout
    if sw:
        np.testing.assert_array_equal(best, np.asarray(best_ref))
    else:
        for j in range(nB):
            want = (empty_corners[j] if j in empty_corners
                    else np.asarray(corner_ref)[j].tolist())
            assert corner[j].tolist() == want, j
    if regime in ("wide", "flags"):  # chunks wider than a strip
        assert unchecked, "no unchecked block ran"


def test_carry_warps_and_scratch():
    """The host's pick of a carry launch's warps a block (halved from 16
    while B x rounds stays below the SMs, not below CARRY_MIN_WARPS, not
    above a pair's strips), and the scratch it sizes, against the header's
    progress-word stride."""
    carry = (Path(kernels.__file__).parent.parent / "csrc" /
             "tile_carry.cuh").read_text()
    assert re.search(rf"constexpr int WORD = {kernels.CARRY_WORD};", carry)
    assert re.search(rf"constexpr int MODES_LANES = {kernels.CARRY_MODES_R};",
                     carry)
    # the flags' carry, 2 lanes a thread: the same 16 warps at most, a
    # pair's strips of 64 lanes
    assert kernels.carry_warps(16, 10000, 132, 2) == 16  # 160 blocks
    assert kernels.carry_warps(4, 2048, 132, 2) == 4  # 8 rounds of 4 pairs
    assert kernels.carry_rounds(10000, 16, 2) == 10
    assert kernels.carry_scratch_ints(4, 5 * 4 * 64, 100, 4, 2) == (
        17 * kernels.CARRY_WORD + 16 * 3 * 101)
    S = 32 * kernels.TILE_R
    assert kernels.carry_warps(4, 2048, 132) == 4  # 16 rounds of 4 pairs
    assert kernels.carry_warps(64, 10000, 132) == 16  # 320 blocks
    assert kernels.carry_warps(16, 10000, 132) == 8  # 160 blocks
    assert kernels.carry_warps(1, 48000, 132) == kernels.CARRY_MIN_WARPS
    assert kernels.carry_warps(300, 3 * S, 132) == 3  # a pair's strips
    assert kernels.carry_warps(2, 1, 132) == 1
    assert kernels.carry_rounds(10000, 8) == 10
    assert kernels.carry_rounds(1, 16) == 1
    # 4 pairs of 5 rounds: 16 boundaries, a word each and the counter,
    # then 16 rows of 3 * (CA + 1)
    assert kernels.carry_scratch_ints(4, 5 * 4 * S, 100, 4) == (
        17 * kernels.CARRY_WORD + 16 * 3 * 101)
    assert kernels.carry_scratch_ints(4, S, 100, 4) == kernels.CARRY_WORD
