"""The order of work of the default-flag fill's register tiles
(csrc/tile_fill.cuh), checked on the CPU.  :func:`tile_fill_model` is
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
row strides, one round and several.  The kernel itself is held to the
plain versions on the card by ``tests/test_torch_cuda.py``."""

import functools
import re
from pathlib import Path

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
from seqalign_tpu_torch.ops.pack import pack_batch, ragged_planes  # noqa

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
    and the pieces of every unchecked store."""

    def __init__(self, total, mdtype):
        self.codes = np.zeros(total, np.uint8)
        self.m = np.zeros(total, mdtype)
        self.writes = np.zeros(total, np.int64)
        self.pieces = []


def tile_fill_model(a, b, na, nb, scal, tab, kb, sw, dirs, mbytes, R, W,
                    at, LBp, LA, rec, rng):
    """One pair's block of the tile fill: a, b its codes (the kernel's
    inputs), ``tab`` the flat substitution table or None (equality),
    ``kb`` its row length; codes (``dirs``) and M (``mbytes`` 2 or 4) go
    to ``rec`` at element ``at`` with rows of ``LBp`` lanes.  W: warps of
    the block.  Returns (corner or None, score)."""
    match, mismatch, go, ge = (int(v) for v in scal[:4])
    mn = int(scal[5] if sw else scal[4])
    gop = int(w32(go + ge))

    def run(k):
        return np.zeros_like(k) if sw else w32(go + np.asarray(k) * ge)

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
        bc = st["bcd"]
        ss = (tab[h + bc] if tab is not None
              else np.where(h == bc, match, mismatch))
        M = np.maximum(w32(dg.max(0) + ss), mn)
        Ga = np.maximum.reduce([w32(up[0] + gop), w32(up[1] + ge),
                                w32(up[2] + gop), np.full_like(M, mn)])
        Gb = np.maximum.reduce([w32(p1[0] + gop), w32(p1[1] + gop),
                                w32(p1[2] + ge), np.full_like(M, mn)])
        x = i - lanes * R - rr
        valid = (x >= 1) & (x <= na) & (y <= nb)
        if checked:
            b0 = x == 0
            M, Ga, Gb = (np.where(b0, mn, M), np.where(b0, run(y), Ga),
                         np.where(b0, mn, Gb))
        else:
            assert valid.all()
        tm = w32(M - ss)
        code = (pick(dg[1] == tm, dg[2] == tm, dg[0] == tm)
                | pick(up[1] == w32(Ga - ge), up[2] == w32(Ga - gop),
                       up[0] == w32(Ga - gop)) << 2
                | pick(p1[1] == w32(Gb - gop), p1[2] == w32(Gb - ge),
                       p1[0] == w32(Gb - gop)) << 4)
        if sw and valid.any():
            out["best"] = max(out["best"], int(M[valid].max()))
        base = at + (ys + i - 2) * LBp  # the row of diagonal d = ys + i
        if checked:
            tt, r_ = np.nonzero(valid)
            idx = base + y[tt, r_]
            write(idx, code[tt, r_], M[tt, r_])
        else:  # a thread's R lanes are R elements of one row
            for tt in range(32):
                e0 = base + int(y[tt, 0])
                for es in ([1] if dirs else []) + ([mbytes] if mbytes else []):
                    rec.pieces.append((e0, es, store_pieces(e0, R, es)))
            write((base + y).ravel(), code.ravel(), M.ravel())
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

    def write(idx, codes, m):
        if dirs:
            rec.codes[idx] = codes
        if mbytes:
            rec.m[idx] = m
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
                unchecked = st["full"] and i0 >= S and i0 + R - 1 <= na
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


def model_launch(sc, A, B, sw, R, W, ragged, seed):
    """The model over every pair of one launch, as the wrapper lays it
    out: returns (corners, scores, rec, off, LA, LB)."""
    p = kernel_params(sc, "cpu")
    LA, LB = max(1, max(map(len, A))), max(1, max(map(len, B)))
    ac, bc, na, nb, bp = pack_batch(sc, p, A, B, LA, LB)
    tab = None if bp.sub is None else bp.sub.numpy().ravel().astype(np.int64)
    kb = 0 if bp.sub is None else bp.sub.shape[1]
    if ragged:
        off = ragged_planes(na, nb)
    else:
        off = np.arange(len(A) + 1) * (LA + LB - 1) * (LB + 1)
    mbytes = (2 if ragged else 4) if sw else 0  # M as int16 or int32
    rec = Rec(int(off[-1]), np.int16 if mbytes == 2 else np.int32)
    rng = np.random.default_rng(seed)
    corners, scores = [], []
    for j in range(len(A)):
        LBp = max(int(nb[j]), 1) + 1 if ragged else LB + 1
        c, s = tile_fill_model(ac[j], bc[j], int(na[j]), int(nb[j]),
                               p.scal.numpy(), tab, kb, sw, True, mbytes, R,
                               W, int(off[j]), LBp, LA, rec, rng)
        corners.append(c)
        scores.append(s)
    return corners, scores, rec, off, na, nb, LB, mbytes


@pytest.mark.parametrize("layout", ["uniform", "ragged"])
@pytest.mark.parametrize("rounds", ["one", "several"])
@pytest.mark.parametrize("scoring", ["equality", "blosum62"])
@pytest.mark.parametrize("kind", ["nw", "sw"])
@pytest.mark.parametrize("R", [1, 4, 8])
def test_tile_model_equals_dp_fill(R, kind, scoring, rounds, layout):
    sc, A, B, out, jna, jnb = reference(kind, scoring, R)
    sw = kind == "sw"
    # one round: the kernel's block (LANES lanes); several: 2 warps, so
    # that the three-strip pair hands its edge over through the row
    W = LANES // (32 * R) if rounds == "one" else 2
    corners, scores, rec, off, na, nb, LB, mbytes = model_launch(
        sc, A, B, sw, R, W, layout == "ragged", R + len(kind))
    dirs = np.asarray(out.dirs)
    mm = np.asarray(out.mmat) if sw else None
    for j in range(len(A)):
        lanes = max(int(nb[j]), 1) + 1 if layout == "ragged" else LB + 1
        plane = slice(int(off[j]), int(off[j + 1]))
        shape = (-1, lanes)
        codes = rec.codes[plane].reshape(shape)
        writes = rec.writes[plane].reshape(shape)
        d = np.arange(codes.shape[0])[:, None]
        y = np.arange(lanes)[None, :]
        x = d + 2 - y
        v = (y >= 1) & (y <= nb[j]) & (x >= 1) & (x <= na[j])
        # every valid cell written once, nothing else
        np.testing.assert_array_equal(writes, v.astype(np.int64))
        want = dirs[j][d, y] if codes.shape[0] else codes
        np.testing.assert_array_equal(codes[v], want[v])
        if sw:
            m = rec.m[plane].reshape(shape)
            np.testing.assert_array_equal(m[v], mm[j][d, y][v])
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
                    ("THREAD_LANES", kernels.TILE_R)):
        assert re.search(rf"constexpr int {name} = {v};", HEADER), name
    assert RING >= 2 * K + 2 and LANES % (32 * kernels.TILE_R) == 0


def test_fill_schedule_marks_the_pairs_past_one_round():
    na = np.array([10, 3000, 5, 9000, 7])
    nb = np.array([LANES, LANES + 1, 0, 9000, 2])
    s = kernels.fill_schedule(na, nb, "cpu")
    assert s.wrap.tolist() == [-1, 0, -1, 1, -1] and s.nwrap == 2
