"""The band walks of the traceback kernels (csrc/nw_walk.cu, csrc/sw_walk.cu
on csrc/walk_band.cuh), checked on the CPU.

:class:`BandModel` is the header's staging in numpy: a walk's rows cut
into blocks of K; on entering a block the part of the next block its entry
cell can reach is copied, as 16-byte chunks that must be aligned on both
sides and lie inside the tensor's 512-byte allocation, into the other of
two buffers, readable only once waited for; the first block of a walk, and
the first after a slab edge, staged at the cell itself; the codes at
``(x + y) * S + y + off`` with S the stride of the header's rule, and for
SW the letters beside them.  Every staged byte remembers the address it
came from, and every read of a code, a letter or a table entry asserts
that its byte came from the cell, letter or entry the walk wants: a read
outside the band, a clobbered byte or a read of a buffer still in flight
fails.  :func:`nw_walk_model` and :func:`sw_walk_model` are the kernels'
loops over it.  They read one step ahead: a fast step picks the next
cell's code (SW: its letters) from the three predecessors' already read,
and runs of the header's RUN fast steps take no test between them (SW
keeps its score there without one, and drops the steps taken after it ran
out); a slow step reads its cell, moves to the next block or stages
afresh.

The models run at the kernel's K and RUN (read from the header) and at
K = 4 with runs of one step, on
ragged planes at odd byte offsets and widths, chunk slabs whose walks
cross a slab edge inside a block, long runs of GAP_A (y falls, a lane a
row: the band's widest case) and GAP_B (x falls, the lane fixed), walks
that reach row 0, lane 1 or, in SW, the clamps x, y >= 1, truncation at
the step bound, free end gaps, the LCS recipe and BLOSUM62 scoring; each
is held with tolerance 0 to ``nw_walk_plain`` / ``sw_walk_plain``, and
the uniform cases through them to the JAX package's walks
(``traceback.nw_walk_device``, its ``_walk_jit``, and ``sw_walk_jit``).
The kernels are held to the plain walks on the card by
``tests/test_torch_cuda.py``."""

import re
from pathlib import Path
from typing import NamedTuple

import numpy as np
import pytest
import torch

jnp = pytest.importorskip("jax.numpy")

from seqalign_tpu import aligners as jax_aligners  # noqa: E402
from seqalign_tpu.ops import dp as jax_dp  # noqa: E402
from seqalign_tpu.ops import traceback as jax_tb  # noqa: E402
from seqalign_tpu.scoring.config import ScoringConfig  # noqa: E402
from seqalign_tpu.scoring.presets import (  # noqa: E402
    scoring_system_BLOSUM62, scoring_system_default,
    scoring_system_sw_default,
)
from seqalign_tpu_torch import kernel_params  # noqa: E402
from seqalign_tpu_torch.ops import kernels  # noqa: E402
from seqalign_tpu_torch.ops.dp import (  # noqa: E402
    fill_chunked, nw_fill_dirs_plain, sw_fill_dirs_plain,
)
from seqalign_tpu_torch.ops.pack import (  # noqa: E402
    NEG, pack_batch, ragged_planes,
)
from seqalign_tpu_torch.ops.traceback import (  # noqa: E402
    nw_walk_plain, slab_geometry, sw_walk_plain, walk_cap,
)

HEADER = (Path(kernels.__file__).parent.parent / "csrc" /
          "walk_band.cuh").read_text()
K_KERNEL = int(re.search(r"constexpr int K = (\d+);", HEADER).group(1))
RUN = int(re.search(r"constexpr int RUN = (\d+);", HEADER).group(1))
MATCH, GAP_A, GAP_B = 0, 1, 2
ALLOC = 512  # the CUDA caching allocator's alignment and size granule
DNA = "acgtACGT"
PROTEIN = "ARNDCQEGHILKMFPSTWYV"


def up16(n):
    return -(-n // 16) * 16


class Mem:
    """A tensor's bytes at a simulated address: element 0 at ``shift``
    within an allocation [0, end) of whole ``ALLOC`` granules, junk
    around it."""

    def __init__(self, data, shift, rng):
        data = np.ascontiguousarray(data, np.uint8).reshape(-1)
        self.base = int(shift)
        self.end = -(-(self.base + len(data)) // ALLOC) * ALLOC
        self.bytes = rng.integers(0, 256, self.end).astype(np.uint8)
        self.bytes[self.base:self.base + len(data)] = data

    def chunk(self, addr):
        assert addr % 16 == 0 and 0 <= addr and addr + 16 <= self.end, \
            f"chunk at {addr} leaves the allocation [0, {self.end})"
        return self.bytes[addr:addr + 16]


class Block(NamedTuple):
    w: int  # buffer
    S: int
    off: int
    lo: int
    xf: int
    bot: int
    aoff: int
    boff: int


# tags that keep the letters' addresses apart from the codes'
TAG_A, TAG_B = 1 << 40, 1 << 41


class BandModel:
    """One walk's two buffers (walk_band.cuh, ``Band``) over a pair's codes
    in ``mem``: nch slabs of ``slab`` bytes from address ``d``, rows of
    ``lanes`` bytes, ``ca`` columns a slab; with ``a``, ``b`` (Mem, and the
    address of the pair's first letter) the letters too."""

    def __init__(self, K, mem, d, slab, lanes, ca, nch, a=None, b=None):
        self.K = K
        self.codes_bytes = up16(K * (2 * K + 48))
        self.letters = up16(2 * K + 32)
        self.mem, self.d, self.slab, self.lanes = mem, d, slab, lanes
        self.ca, self.nch, self.a, self.b = ca, nch, a, b
        size = self.codes_bytes + 2 * self.letters
        self.val = [np.zeros(size, np.uint8) for _ in range(2)]
        self.src = [np.full(size, -1, np.int64) for _ in range(2)]
        self.busy = [False, False]
        self.which, self.pending = 0, False

    def _copy(self, w, dst, mem, addr, tag, lo, hi):
        assert dst % 16 == 0 and lo <= dst and dst + 16 <= hi, \
            f"chunk to {dst} leaves [{lo}, {hi})"
        self.val[w][dst:dst + 16] = mem.chunk(addr)
        self.src[w][dst:dst + 16] = tag + addr + np.arange(16)

    def _run(self, w, dst, mem, lo, hi, tag, region):
        q = lo & ~15
        while q <= hi:
            self._copy(w, dst, mem, q, tag, region, region + self.letters)
            q += 16
            dst += 16

    def stage(self, w, xf, bot, top, xe, ye):
        K, lanes = self.K, self.lanes
        re_ = xe - xf + ye - 2
        depth = re_ - bot
        assert 0 <= bot <= top and top - bot < K and depth < 2 * K
        ylo = max(1, ye - depth)
        S = 2 * K + 30 + ((lanes - 2 * K - 30) & 15)
        assert S % 16 == lanes % 16 and S <= 2 * K + 45
        c = (self.src_slab + bot * lanes + ylo) & 15
        aoff = boff = 0
        self.busy[w] = True
        for r in range(top, bot - 1, -1):
            y0 = max(1, ye - (re_ - r))
            row = self.src_slab + r * lanes
            at = (r - bot) * S + (y0 - ylo) + c - ((row + y0) & 15)
            q = (row + y0) & ~15
            while q <= row + ye:
                self._copy(w, at, self.mem, q, 0, 0, self.codes_bytes)
                q += 16
                at += 16
        if self.a is not None:
            (ma, a0), (mb, b0) = self.a, self.b
            xlo = max(1, xe - depth)
            ga, gb = a0 + xlo - 1, b0 + ylo - 1
            aoff, boff = (ga & 15) - xlo, (gb & 15) - ylo
            self._run(w, self.codes_bytes, ma, ga, a0 + xe - 1, TAG_A,
                      self.codes_bytes)
            self._run(w, self.codes_bytes + self.letters, mb, gb,
                      b0 + ye - 1, TAG_B, self.codes_bytes + self.letters)
        return Block(w, S, c - ylo - (xf + 2 + bot) * S, xf + 2 + bot, xf,
                     bot, aoff, boff)

    def wait(self):
        self.busy = [False, False]

    def prefetch(self, xe, ye):
        self.pending = self.cur.bot > 0
        if self.pending:
            self.nxt = self.stage(self.which ^ 1, self.cur.xf,
                                  max(0, self.cur.bot - self.K),
                                  self.cur.bot - 1, xe, ye)

    def fresh(self, x, y):
        c = 0 if self.nch == 1 else (x - 1) // self.ca
        xf = c * self.ca
        self.src_slab = self.d + c * self.slab
        re_ = x - xf + y - 2
        self.cur = self.stage(self.which, xf, max(0, re_ - self.K + 1), re_,
                              x, y)
        self.wait()
        self.prefetch(x, y)

    def start(self, x, y):
        self.which, self.pending = 0, False
        self.fresh(x, y)

    def holds(self, x, y):
        return x + y >= self.cur.lo and x > self.cur.xf

    def enter(self, x, y):
        if x <= self.cur.xf or not self.pending:
            self.fresh(x, y)
            return
        self.wait()
        self.cur = self.nxt
        self.which ^= 1
        self.prefetch(x, y)

    def _read(self, idx, lo, hi, want):
        k = self.cur
        assert not self.busy[k.w], "read of a buffer still being copied"
        assert lo <= idx < hi, f"index {idx} outside [{lo}, {hi})"
        assert self.src[k.w][idx] == want, \
            f"byte {idx} holds address {self.src[k.w][idx]}, not {want}"
        return int(self.val[k.w][idx])

    def index(self, x, y):
        return (x + y) * self.cur.S + y + self.cur.off

    def fast(self, x, y, idx):
        """The cell's MATCH, GAP_A and GAP_B predecessors lie in cur."""
        return x >= self.cur.xf + 2 and y >= 2 and idx >= 2 * self.cur.S + 1

    def delta(self, op):
        """How far a step of ``op`` lowers the index."""
        S = self.cur.S
        return S + 1 if op == GAP_A else S if op == GAP_B else 2 * S + 1

    def at(self, idx, x, y):
        """The code at ``idx``, which must hold cell (y, x)'s."""
        c = 0 if self.nch == 1 else (x - 1) // self.ca
        want = (self.d + c * self.slab + (x - c * self.ca + y - 2)
                * self.lanes + y)
        return self._read(idx, 0, self.codes_bytes, want)

    def kids(self, idx, x, y):
        """The codes of the MATCH, GAP_A and GAP_B predecessors of the cell
        (y, x) at ``idx``."""
        S = self.cur.S
        return (self.at(idx - 2 * S - 1, x - 1, y - 1),
                self.at(idx - S - 1, x, y - 1), self.at(idx - S, x - 1, y))

    def letter_a(self, x):
        k = self.cur
        return self._read(self.codes_bytes + x + k.aoff, self.codes_bytes,
                          self.codes_bytes + self.letters,
                          TAG_A + self.a[1] + x - 1)

    def letter_b(self, y):
        k = self.cur
        lo = self.codes_bytes + self.letters
        return self._read(lo + y + k.boff, lo, lo + self.letters,
                          TAG_B + self.b[1] + y - 1)


class Pairs(NamedTuple):
    """Where each pair's codes lie in one Mem: (d, slab, lanes, ca, nch)
    per pair, as the kernels set ``band::Codes``."""
    mem: Mem
    geo: list


def pairs_of(dirs, na, nb, off, shift, rng):
    """The kernels' view of a plane, chunk slabs or ragged planes."""
    flat = dirs.reshape(-1).numpy()
    mem = Mem(flat, shift, rng)
    if off is None:
        nch, dc, lbp, ca = slab_geometry(dirs)
        per = nch * dc * lbp
        return Pairs(mem, [(mem.base + j * per, dc * lbp, lbp, ca, nch)
                           for j in range(dirs.shape[0])])
    return Pairs(mem, [(mem.base + int(off[j]), 0, max(int(nb[j]), 1) + 1,
                        max(int(na[j]), 1), 1) for j in range(len(na))])


def nw_walk_model(K, pairs, corner, na, nb, cap, clamp=None, run=None):
    """nw_walk.cu's loop over :class:`BandModel`: returns the op trace
    (B, walk_cap(cap)) and the start scores.  ``clamp`` (nch * CA,
    LB) bounds the start on a uniform plane or slabs, as the kernel's;
    ``run`` fast steps a run (the header's RUN by default)."""
    run = RUN if run is None else run
    capr = walk_cap(cap)
    B = len(na)
    ops = np.full((B, capr), -1, np.int8)
    score = np.zeros(B, np.int32)
    for j in range(B):
        m, ga, gb = (int(v) for v in corner[j])
        curr, s = MATCH, m
        if gb >= s:
            curr, s = GAP_B, gb
        if ga >= s:
            curr, s = GAP_A, ga
        score[j] = s
        X, Y = int(na[j]), int(nb[j])
        if clamp is not None:
            X, Y = min(X, clamp[0]), min(Y, clamp[1])
        if not (capr > 0 and X > 0 and Y > 0):
            continue
        bd = BandModel(K, pairs.mem, *pairs.geo[j])
        bd.start(X, Y)
        idx = bd.index(X, Y)
        code = bd.at(idx, X, Y)
        ahead = bd.fast(X, Y, idx)
        kids = bd.kids(idx, X, Y) if ahead else (0, 0, 0)
        step = held = 0  # held: trace bytes in shared memory
        while True:
            assert held <= up16(2 * K + 2) - run, "the trace overflows"
            k = bd.cur
            if (ahead and idx >= (run + 1) * (2 * k.S + 1)
                    and X >= k.xf + run + 2 and Y >= run + 2
                    and step + run < capr):
                for _ in range(run):  # no test inside a run
                    ops[j, step] = curr
                    step += 1
                    held += 1
                    X, Y = X - (curr != GAP_A), Y - (curr != GAP_B)
                    idx -= bd.delta(curr)
                    nxt_code = kids[0] if curr in (MATCH, 3) else kids[curr]
                    kids = bd.kids(idx, X, Y)
                    curr = (code >> (2 * curr)) & 3
                    code = nxt_code
                continue
            ops[j, step] = curr
            step += 1
            held += 1
            X, Y = X - (curr != GAP_A), Y - (curr != GAP_B)
            idx -= bd.delta(curr)
            picked = kids[0] if curr in (MATCH, 3) else kids[curr]
            if ahead and step < capr and bd.fast(X, Y, idx):
                nxt_code = picked
                kids = bd.kids(idx, X, Y)
            else:
                if step >= capr or X <= 0 or Y <= 0:
                    break
                if ahead:
                    nxt_code = picked
                else:
                    if not bd.holds(X, Y):
                        bd.enter(X, Y)
                    idx = bd.index(X, Y)
                    nxt_code = bd.at(idx, X, Y)
                ahead = bd.fast(X, Y, idx)
                kids = bd.kids(idx, X, Y) if ahead else (0, 0, 0)
                if held >= K:  # written out
                    held = 0
            curr = (code >> (2 * curr)) & 3
            code = nxt_code
        bd.wait()
    return ops, score


def _wrap32(v):
    return (v + (1 << 31)) % (1 << 32) - (1 << 31)


def sw_walk_model(K, pairs, ac, bc, na, nb, jw, x0, y0, s0, scal, sub, neg,
                  cap, rng, run=None):
    """sw_walk.cu's loop over :class:`BandModel`, the letters staged
    beside the codes and the table read from a block's copy of it: NW's
    read-ahead and runs, and in a run the score kept without a test, a
    step counting while the score it starts from is positive."""
    run = RUN if run is None else run
    capr = walk_cap(cap)
    B, LA = ac.shape
    LB = bc.shape[1]
    W = len(jw)
    ops = np.full((W, capr), -1, np.int8)
    ma, mb = Mem(ac, 3, rng), Mem(bc, 9, rng)
    match, mismatch, gap_open, ge = (int(v) for v in scal[:4])
    gop = _wrap32(gap_open + ge)
    tab = None if sub is None else sub.reshape(-1).copy()
    kb = 0 if sub is None else sub.shape[1]

    def score(ai, bi):
        if tab is None:
            return match if ai == bi else mismatch
        assert 0 <= ai * kb + bi < len(tab)
        return int(tab[ai * kb + bi])

    for w in range(W):
        j = int(jw[w])
        if not 0 <= j < B:
            continue
        X, Y, cs = min(int(x0[w]), LA), min(int(y0[w]), LB), int(s0[w])
        curr = MATCH
        if not (capr > 0 and cs > 0):
            continue
        bd = BandModel(K, pairs.mem, *pairs.geo[j],
                       a=(ma, ma.base + j * LA), b=(mb, mb.base + j * LB))
        Xc, Yc = max(X, 1), max(Y, 1)
        bd.start(Xc, Yc)
        idx = bd.index(Xc, Yc)
        code = bd.at(idx, Xc, Yc)
        ai, bi = bd.letter_a(Xc), bd.letter_b(Yc)
        mp = score(ai, bi)

        def read_ahead():
            if not bd.fast(X, Y, idx):
                return False, (0, 0, 0), 0, 0
            return (True, bd.kids(idx, X, Y), bd.letter_a(X - 1),
                    bd.letter_b(Y - 1))

        ahead, kids, ap, bp = read_ahead()
        step = 0

        def penalty():
            nxt = (code >> (2 * curr)) & 3
            if curr == MATCH:
                return nxt, mp
            if neg and (X == int(na[j]) if curr == GAP_A
                        else Y == int(nb[j])):
                return nxt, 0
            return nxt, ge if nxt == curr else gop

        while True:
            k = bd.cur
            if (ahead and idx >= (run + 1) * (2 * k.S + 1)
                    and X >= k.xf + run + 2 and Y >= run + 2
                    and step + run < capr):
                alive = True
                for _ in range(run):  # no test inside a run
                    ops[w, step] = curr
                    step += alive
                    nxt, pen = penalty()
                    dx, dy = int(curr != GAP_A), int(curr != GAP_B)
                    X, Y = X - dx, Y - dy
                    idx -= bd.delta(curr)
                    code = kids[0] if curr in (MATCH, 3) else kids[curr]
                    ai, bi = (ap if dx else ai), (bp if dy else bi)
                    mp = score(ai, bi)
                    ahead, kids, ap, bp = read_ahead()
                    assert ahead  # the run's cells keep theirs in cur
                    cs = _wrap32(cs - pen)
                    alive = alive and cs > 0
                    curr = nxt
                if not alive:
                    ops[w, step:] = -1
                    break
                continue
            ops[w, step] = curr
            step += 1
            nxt, pen = penalty()
            dx, dy = int(curr != GAP_A), int(curr != GAP_B)
            X, Y = X - dx, Y - dy
            idx -= bd.delta(curr)
            if ahead:
                code = kids[0] if curr in (MATCH, 3) else kids[curr]
                ai, bi = (ap if dx else ai), (bp if dy else bi)
            else:
                Xc, Yc = max(X, 1), max(Y, 1)
                if not bd.holds(Xc, Yc):
                    bd.enter(Xc, Yc)
                idx = bd.index(Xc, Yc)
                code = bd.at(idx, Xc, Yc)
                ai, bi = bd.letter_a(Xc), bd.letter_b(Yc)
            mp = score(ai, bi)
            ahead, kids, ap, bp = read_ahead()
            cs = _wrap32(cs - pen)
            curr = nxt
            if cs <= 0 or step >= capr:
                break
        bd.wait()
    return ops


def _text(rng, alpha, n, lo, hi):
    letters = np.array(list(alpha))
    return ["".join(letters[rng.integers(0, len(letters), int(k))])
            for k in rng.integers(lo, hi + 1, n)]


def _mutated(rng, A, alpha):
    """Each of ``A`` with 10% of its letters changed and 1-3 indels of 1-3
    letters."""
    out = []
    for a in A:
        s = [alpha[rng.integers(len(alpha))] if rng.random() < 0.1 else ch
             for ch in a]
        for _ in range(int(rng.integers(1, 4))):
            p, k = int(rng.integers(0, len(s))), int(rng.integers(1, 4))
            if rng.random() < 0.5:
                del s[p:p + k]
            else:
                s[p:p] = list(_text(rng, alpha, 1, k, k)[0])
        out.append("".join(s))
    return out


def _packed(sc, A, B, la=None, lb=None):
    ac, bc, na, nb, bp = pack_batch(sc, kernel_params(sc, "cpu"), A, B,
                                    la or max(1, max(map(len, A))),
                                    lb or max(1, max(map(len, B))))
    return tuple(torch.from_numpy(v) for v in (ac, bc, na, nb)), bp


def _best_starts(m, na, nb, per_pair, off=None):
    """The ``per_pair`` highest cells of each pair's M (uniform planes, or
    with ``off`` the ragged ones): (jw, x0, y0, s0) int32 tensors."""
    jw, xs, ys, ss = [], [], [], []
    for j in range(len(na)):
        wa, wb = max(int(na[j]), 1), max(int(nb[j]), 1)
        if off is None:
            plane = m[j].numpy()
        else:
            plane = m[int(off[j]):int(off[j + 1])].numpy().reshape(
                wa + wb - 1, wb + 1)
        r = np.arange(plane.shape[0])[:, None]
        y = np.arange(plane.shape[1])[None, :]
        x = r - y + 2
        ok = (y >= 1) & (y <= nb[j]) & (x >= 1) & (x <= na[j])
        vals = np.where(ok, plane, -1).astype(np.int64).reshape(-1)
        for k in np.argsort(-vals, kind="stable")[:per_pair]:
            if vals[k] <= 0:
                break
            rr, yy = divmod(int(k), plane.shape[1])
            jw.append(j)
            xs.append(rr - yy + 2)
            ys.append(yy)
            ss.append(int(vals[k]))
    return [torch.tensor(v, dtype=torch.int32) for v in (jw, xs, ys, ss)]


def _lcs():
    return ScoringConfig(1, -1, -4, -1, no_gaps_in_a=True,
                         no_gaps_in_b=True, no_mismatches=True)


def _neg():
    return ScoringConfig(2, -2, -2, -1, no_end_gap_penalty=True)


def case_inputs(case, rng):
    """The inputs of one case: ``kind`` "nw" or "sw", the walk's
    arguments as the wrappers take them, the memory shift of the codes,
    and for the uniform cases the JAX package's walk of the same
    inputs."""
    jax_walk = None
    if case in ("uniform_nw", "cap_nw", "gap_a_run", "gap_b_run"):
        sc = scoring_system_default()
        if case == "gap_a_run":  # a short, b long: GAP_A runs
            A, B = _text(rng, DNA, 4, 2, 9), _text(rng, DNA, 4, 280, 400)
        elif case == "gap_b_run":
            A, B = _text(rng, DNA, 4, 280, 400), _text(rng, DNA, 4, 2, 9)
        elif case == "cap_nw":  # walks past their 256-step bound
            A, B = _text(rng, DNA, 3, 280, 300), _text(rng, DNA, 3, 280, 300)
        else:  # a pair of one letter each, one ending on row 0 and lane 1
            A, B = _text(rng, DNA, 6, 1, 200), _text(rng, DNA, 6, 1, 200)
            A[0], B[0] = "a", "c"
            A[1], B[1] = "ac" * 60, "a" * 3
        L = max(max(map(len, A)), max(map(len, B)))
        out, na, nb = jax_dp.fill_batch(sc, A, B, is_sw=False,
                                        emit_dirs=True, pad_a=L, pad_b=L)
        dirs = torch.from_numpy(np.array(out.dirs))
        corner = torch.from_numpy(np.array(out.corner))
        na_t = torch.from_numpy(np.asarray(na, np.int32))
        nb_t = torch.from_numpy(np.asarray(nb, np.int32))
        cap = 256 if case == "cap_nw" else int((na + nb).max())

        def jax_walk():
            ops, score = jax_tb.nw_walk_device(
                out.dirs, jax_aligners._xla_gather(dirs.shape[0]),
                np.asarray(out.corner), na, nb, cap)
            return np.asarray(ops), np.asarray(score)
        return dict(kind="nw", dirs=dirs, corner=corner, na=na_t, nb=nb_t,
                    cap=cap, off=None, shift=0, jax=jax_walk)
    if case == "ragged_nw":
        sc = scoring_system_default()
        A, B = _text(rng, DNA, 7, 0, 230), _text(rng, DNA, 7, 1, 230)
        A[2], B[3] = "", "g"
        (ac, bc, na, nb), bp = _packed(sc, A, B)
        off = torch.from_numpy(ragged_planes(na.numpy(), nb.numpy()))
        dirs, corner = nw_fill_dirs_plain(ac, bc, na, nb, bp, off)
        return dict(kind="nw", dirs=dirs, corner=corner, na=na, nb=nb,
                    cap=int((na + nb).max()), off=off, shift=5, jax=None)
    if case == "slabs_nw":
        sc = scoring_system_default()
        A, B = _text(rng, DNA, 3, 150, 260), _text(rng, DNA, 3, 90, 200)
        (ac, bc, na, nb), bp = _packed(sc, A, B)
        corner, _, chunks, _, _, _ = fill_chunked(ac, bc, na, nb, bp,
                                                  is_sw=False, chunk=37)
        dirs = torch.stack(chunks, 1)
        return dict(kind="nw", dirs=dirs, corner=corner, na=na, nb=nb,
                    cap=int((na + nb).max()), off=None, shift=13, jax=None)
    # SW
    sc = {"blosum62": scoring_system_BLOSUM62, "neg": _neg, "lcs": _lcs}.get(
        case, scoring_system_sw_default)()
    alpha = PROTEIN if case == "blosum62" else DNA
    # b a copy of a with changes, so that the best hits' walks are long
    A = _text(rng, alpha, 4, 140, 220)
    B = list(A) if case == "lcs" else _mutated(rng, A, alpha)
    if case == "lcs":  # sequences against themselves, and a repeat
        A[0] = B[0] = A[0][:40] * 4
    if case == "ragged_sw":  # odd widths, one pair of a single cell
        A[2], B[2] = "a", "a"
    (ac, bc, na, nb), bp = _packed(sc, A, B)
    off, shift = None, 0
    if case == "ragged_sw":
        off = torch.from_numpy(ragged_planes(na.numpy(), nb.numpy()))
        shift = 11
    dirs, m = sw_fill_dirs_plain(ac, bc, na, nb, bp, False, off)
    jw, x0, y0, s0 = _best_starts(m, na.numpy(), nb.numpy(), 4, off)
    cap = int((na + nb).max())
    if case == "slabs_sw":
        _, _, chunks, _, _, _ = fill_chunked(ac, bc, na, nb, bp, is_sw=True,
                                             chunk=29)
        dirs, shift = torch.stack(chunks, 1), 7
    if case == "clamps_cap_sw":
        # scores that never run out: every walk reaches x or y = 0 and
        # goes on at the clamped cell to its bound, from cells at the
        # edges too
        k = len(jw)
        jw = torch.cat([jw, torch.tensor([0, 1, 2], dtype=torch.int32)])
        x0 = torch.cat([x0, torch.tensor([1, int(na[1]), 5],
                                         dtype=torch.int32)])
        y0 = torch.cat([y0, torch.tensor([int(nb[0]), 1, 3],
                                         dtype=torch.int32)])
        s0 = torch.full((k + 3,), 1 << 20, dtype=torch.int32)
        cap = 300
    if case in ("uniform_sw", "blosum62", "clamps_cap_sw"):
        L = ac.shape[1], bc.shape[1]

        def jax_walk():
            out, _, _ = jax_dp.fill_batch(sc, A, B, is_sw=True,
                                          emit_dirs=True, emit_m=True,
                                          pad_a=L[0], pad_b=L[1])
            a, _ = jax_dp.pad_batch(A, pad_to=L[0])
            b, _ = jax_dp.pad_batch(B, pad_to=L[1])
            lut = not jax_dp.mm_eligible(sc)
            if lut:
                acd, bcd, subK, _ = jax_dp.compact_inputs(sc, a, b)
            else:
                acd, bcd = jax_dp.compact_inputs_mm(sc, a, b)
                subK = np.zeros((8, 8), np.int32)

            def gather_w(d, jw_, X, Y):  # the (B, D, LB+1) layout
                return d[jw_, X + Y - 2, Y]

            walk = jax_tb.sw_walk_jit(gather_w, walk_cap(cap), lut)
            return np.asarray(walk(
                out.dirs, jnp.asarray(acd), jnp.asarray(bcd),
                jnp.asarray(subK), jnp.asarray(jw.numpy()),
                jnp.asarray(x0.numpy()), jnp.asarray(y0.numpy()),
                jnp.asarray(s0.numpy()), np.int32(sc.match),
                np.int32(sc.mismatch), np.int32(sc.gap_open + sc.gap_extend),
                np.int32(sc.gap_extend)))
        jax_walk_fn = jax_walk
    else:
        jax_walk_fn = None
    return dict(kind="sw", dirs=dirs, ac=ac, bc=bc, na=na, nb=nb, jw=jw,
                x0=x0, y0=y0, s0=s0, bp=bp, cap=cap, off=off, shift=shift,
                jax=jax_walk_fn)


CASES = ("uniform_nw", "ragged_nw", "slabs_nw", "gap_a_run", "gap_b_run",
         "cap_nw", "uniform_sw", "ragged_sw", "slabs_sw", "clamps_cap_sw",
         "neg", "lcs", "blosum62")


def run_model(K, c, rng):
    """The band model's walk of one case, and the plain walk's."""
    pairs = pairs_of(c["dirs"], c["na"], c["nb"], c["off"], c["shift"], rng)
    if c["kind"] == "nw":
        clamp = None
        if c["off"] is None:
            nch, _, lbp, ca = slab_geometry(c["dirs"])
            clamp = (nch * ca, lbp - 1)
        got = nw_walk_model(K, pairs, c["corner"].numpy(), c["na"].numpy(),
                            c["nb"].numpy(), c["cap"], clamp,
                            RUN if K == K_KERNEL else 1)
        want = nw_walk_plain(c["dirs"], c["corner"], c["na"], c["nb"],
                             c["cap"], c["off"])
        return got, tuple(t.numpy() for t in want)
    bp = c["bp"]
    got = sw_walk_model(
        K, pairs, c["ac"].numpy(), c["bc"].numpy(), c["na"].numpy(),
        c["nb"].numpy(), c["jw"].numpy(), c["x0"].numpy(), c["y0"].numpy(),
        c["s0"].numpy(), bp.scal.numpy(),
        None if bp.sub is None else bp.sub.numpy(), bool(bp.modes & NEG),
        c["cap"], rng, RUN if K == K_KERNEL else 1)
    want = sw_walk_plain(c["dirs"], c["ac"], c["bc"], c["na"], c["nb"],
                         c["jw"], c["x0"], c["y0"], c["s0"], bp, c["cap"],
                         c["off"])
    return (got,), (want.numpy(),)


@pytest.mark.parametrize("K", [K_KERNEL, 4])
@pytest.mark.parametrize("case", CASES)
def test_band_model_equals_plain_walks(case, K):
    rng = np.random.default_rng(CASES.index(case) + 101)
    c = case_inputs(case, rng)
    got, want = run_model(K, c, rng)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    ops = got[0]
    steps = (ops >= 0).sum(1)
    assert steps.max() > 2 * K  # the walks cross blocks
    if case in ("cap_nw", "clamps_cap_sw"):
        assert (steps == ops.shape[1]).any()  # truncated at the bound
    if case in ("gap_a_run", "gap_b_run"):
        op = GAP_A if case == "gap_a_run" else GAP_B
        assert (ops == op).sum(1).max() > 2 * K
    if c["jax"] is not None:
        jax_out = c["jax"]()
        jax_out = jax_out if isinstance(jax_out, tuple) else (jax_out,)
        for w, j in zip(want, jax_out):
            np.testing.assert_array_equal(w, j)


def test_band_model_catches_a_read_outside_the_band():
    """A walk that takes the row below its block for part of the block
    fails the model's checks: the model reads nothing it did not stage."""
    rng = np.random.default_rng(7)
    c = case_inputs("gap_a_run", rng)
    real = BandModel.holds

    def one_row_low(self, x, y):
        return x + y >= self.cur.lo - 1 and x > self.cur.xf

    BandModel.holds = one_row_low
    try:
        with pytest.raises(AssertionError, match="index|holds address"):
            run_model(4, c, rng)
    finally:
        BandModel.holds = real


def test_header_sizes_hold_the_widest_block():
    """The header's buffer sizes against the model's worst case: K rows
    of 2K lanes at a stride of up to 2K + 45, letters of 2K at a chunk's
    offset, a trace of 2K + 2 steps, and the walks of a block and the
    largest table it stages within the card's shared memory."""
    assert "constexpr int ROW = 2 * K + 48;" in HEADER
    assert "constexpr int CODES = up16(K * ROW);" in HEADER
    assert "constexpr int LETTERS = up16(2 * K + 32);" in HEADER
    assert "WARPS = K >= 128 ? 2 : 4;" in HEADER
    assert "constexpr int TRACE = up16(2 * K + 2);" in HEADER
    warps = 2 if K_KERNEL >= 128 else 4
    codes = up16(K_KERNEL * (2 * K_KERNEL + 48))
    walk = 2 * (codes + 2 * up16(2 * K_KERNEL + 32)) + up16(2 * K_KERNEL + 2)
    assert warps * walk + 64 * 1024 <= kernels.SMEM_MAX
    for lanes in range(1, 64):
        S = 2 * K_KERNEL + 30 + ((lanes - 2 * K_KERNEL - 30) & 15)
        assert S % 16 == lanes % 16 and 2 * K_KERNEL + 30 <= S
        # the last row's last chunk ends inside the block
        assert (K_KERNEL - 1) * S + 15 + 2 * K_KERNEL + 15 <= codes
