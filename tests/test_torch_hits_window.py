"""The order of work of the ``sw_hits`` kernel (csrc/sw_hits.cu), checked
on the CPU: a window of 32 candidates, each pre-walked along the codes to
a fixed depth without the mask, then settled in candidate order against
the mask, gives exactly the serial hit loop's hits (``sw_hits_plain``,
the loop of ``SwHitIterator.fetch``).  :func:`window_hits` is that order
of work in Python; it is held to ``sw_hits_plain`` on real fills (DNA,
BLOSUM62, free end gaps, the LCS recipe), on fills with DIR_FAIL codes
planted in them, and on a crafted cascade, where one lane's mark makes
the next lane's MATCH predecessor marked inside one window.  The hit
streams of the port's aligner on the cascade equal the JAX package's.
The kernel itself is held to ``sw_hits_plain`` on the card, on these
cases, by ``tests/test_torch_cuda.py``.  Tolerance 0: the hits are
integers.

This module imports no JAX at import time (``test_torch_cuda.py`` takes
its cases from here on a machine without JAX).
"""

import dataclasses

import numpy as np
import pytest
import torch

from seqalign_tpu_torch import (ScoringConfig, SmithWaterman, kernel_params,
                                scoring_system_BLOSUM62,
                                scoring_system_sw_default)
from seqalign_tpu_torch.ops import kernels
from seqalign_tpu_torch.ops.dp import sw_sorted_candidates
from seqalign_tpu_torch.ops.pack import (DIR_FAIL, GAP_A, MATCH, NEG,
                                         pack_batch)
from seqalign_tpu_torch.ops.traceback import (slab_geometry, slab_index,
                                              sw_hits_plain)

# name -> (scoring, alphabet)
SCORINGS = {
    "dna": (scoring_system_sw_default, "acgtACGT"),
    "blosum62": (scoring_system_BLOSUM62, "ARNDCQEGHILKMFPSTWYV"),
    "neg": (lambda: ScoringConfig(2, -2, -2, -1, no_end_gap_penalty=True),
            "acgt"),
    "lcs": (lambda: ScoringConfig(1, -1, -4, -1, no_gaps_in_a=True,
                                  no_gaps_in_b=True, no_mismatches=True),
            "acgt"),
}
# the cascade: a match, then a run of mismatches scored 0, so that the
# diagonal cells (i, i) all score 1 and are the only candidates
CASCADE_RUN = 40


def text(rng, alpha, n, lo, hi):
    letters = np.array(list(alpha))
    return ["".join(letters[rng.integers(0, len(letters), int(k))])
            for k in rng.integers(lo, hi + 1, n)]


def cascade_case():
    """(scoring, seqs_a, seqs_b) of the cascade: 'a' then CASCADE_RUN t's
    against 'a' then CASCADE_RUN g's, match 1, mismatch 0.  The walk from
    (1, 1) is the one hit; the candidate (2, 2) finds its predecessor
    marked and marks its cell, which marks the predecessor of (3, 3), and
    so on down the diagonal, across a window's border."""
    sc = ScoringConfig(1, 0, -5, -5)
    return (sc, ["a" + "t" * CASCADE_RUN, "atg" + "t" * CASCADE_RUN],
            ["a" + "g" * CASCADE_RUN, "atg" + "g" * CASCADE_RUN])


def hit_args(sc, A, B, device="cpu", k=16, min_score=1):
    """The arguments of ``sw_hits`` for one SW fill of the pairs (A, B) on
    ``device`` (the fill kernel there, its plain version on the CPU), its
    candidates harvested at ``min_score``."""
    p = kernel_params(sc, device)
    ac, bc, na, nb, bp = pack_batch(sc, p, A, B, max(1, max(map(len, A))),
                                    max(1, max(map(len, B))))
    t = [torch.from_numpy(v).to(device) for v in (ac, bc, na, nb)]
    d, m = kernels.sw_fill_dirs(*t, bp)
    flat, score, off = sw_sorted_candidates(m, na, nb, min_score)
    return (d, *t, flat, score, off[:-1], off[1:], bp, k)


def with_k(args, k):
    return (*args[:-1], k)


def plant_dir_fails(args, seed, count):
    """A copy of ``args`` whose codes hold ``count`` DIR_FAIL fields, each
    at a random valid cell of a random pair, in a random matrix's field."""
    rng = np.random.default_rng(seed)
    d = args[0].clone()
    na, nb = args[3].tolist(), args[4].tolist()
    for _ in range(count):
        j = int(rng.integers(len(na)))
        if not (na[j] and nb[j]):
            continue
        x = int(rng.integers(1, na[j] + 1))
        y = int(rng.integers(1, nb[j] + 1))
        f = int(rng.integers(3))
        d[j, x + y - 2, y] |= DIR_FAIL << (2 * f)
    return (d, *args[1:])


def fail_cascade(args):
    """A copy of the cascade's ``args`` whose first pair's diagonal cells
    (i, i), i >= 2, hold a DIR_FAIL MATCH code: only the shortcut of a
    candidate with a marked MATCH predecessor, which reads no code, keeps
    its stream from failing."""
    d = args[0].clone()
    for i in range(2, int(args[3][0]) + 1):
        d[0, 2 * i - 2, i] |= DIR_FAIL
    return (d, *args[1:])


def window_hits(dirs, ac, bc, na, nb, cand_flat, cand_score, lo, hi,
                params, k, depth=4, width=32):
    """The kernel's order of work, in Python: returns what
    ``sw_hits_plain`` returns.  Per pair, windows of ``width`` candidates:
    every candidate whose cell and MATCH predecessor are unmarked at the
    window's start is walked along the codes, unmasked, for at most
    ``depth`` cells (its path, and whether it ended in a hit or a fail);
    then the window's candidates still unmarked at its start are settled
    in order: a marked cell is skipped, a marked predecessor marks the
    cell, else the path's cells are entered until the first marked one,
    each marked, and the path's end applies, a path past ``depth`` going
    on serially."""
    B = dirs.shape[0]
    nch, dc, LBp, ca = slab_geometry(dirs)
    LA = ac.shape[1]
    codes = dirs.cpu().numpy().reshape(B, -1)
    av, bv = ac.cpu().numpy(), bc.cpu().numpy()
    match, mismatch, gap_open, ge = params.scal[:4].tolist()
    gop = gap_open + ge
    neg = bool(params.modes & NEG)
    sub = None if params.sub is None else params.sub.cpu().numpy()
    flats_h = cand_flat.cpu().numpy()
    scores_h = cand_score.cpu().numpy()
    hit_flat = np.zeros((B, k), flats_h.dtype)
    hit_score = np.zeros((B, k), np.int32)
    nhits = np.zeros(B, np.int32)

    def back(j, x, y, curr, cs, n_a, n_b):
        """One step back: (x, y, curr, cs), or None on a DIR_FAIL code."""
        nxt = (int(codes[j, slab_index(x, y, ca, dc, LBp)])
               >> (2 * curr)) & 3
        if nxt == DIR_FAIL:
            return None
        if curr == MATCH:
            ai, bi = int(av[j, x - 1]), int(bv[j, y - 1])
            pen = (int(sub[ai, bi]) if sub is not None
                   else match if ai == bi else mismatch)
            x, y = x - 1, y - 1
        else:
            free = neg and (x == n_a if curr == GAP_A else y == n_b)
            pen = 0 if free else (ge if nxt == curr else gop)
            if curr == GAP_A:
                y -= 1
            else:
                x -= 1
        return x, y, nxt, cs - pen

    def prewalk(j, f0, s0, w, n_a, n_b):
        x, y, curr, cs = f0 % w, f0 // w, MATCH, s0
        path = []
        for _ in range(depth):
            path.append(y * w + x)
            if cs == 0:
                return path, "hit", None
            if x < 1 or y < 1:
                return path, "fail", None
            st = back(j, x, y, curr, cs, n_a, n_b)
            if st is None:
                return path, "fail", None
            x, y, curr, cs = st
        return path, "more", (x, y, curr, cs)

    def settle(j, mask, f0, pre, w, n_a, n_b):
        if mask[f0]:
            return None
        if mask[f0 - w - 1]:
            mask[f0] = 1
            return None
        path, end, state = pre
        for f in path:
            if mask[f]:
                return None  # abort: the marks so far stay
            mask[f] = 1
        while end == "more":
            x, y, curr, cs = state
            f = y * w + x
            if mask[f]:
                return None
            mask[f] = 1
            if cs == 0:
                return "hit"
            if x < 1 or y < 1:
                return "fail"
            state = back(j, x, y, curr, cs, n_a, n_b)
            if state is None:
                return "fail"
        return end

    for j in range(B):
        n_a, n_b = int(na[j]), int(nb[j])
        w = n_a + 1
        lo_j, hi_j = int(lo[j]), int(hi[j])
        mask = bytearray(LBp * (LA + 1))
        n = 0
        fail = flats_h.dtype == np.int32 and w * (n_b + 1) > 2 ** 31 - 1
        c = lo_j
        while c < hi_j and n < k and not fail:
            window = range(c, min(c + width, hi_j))
            live = [ci for ci in window if not mask[int(flats_h[ci])]]
            pre = {ci: prewalk(j, int(flats_h[ci]), int(scores_h[ci]), w,
                               n_a, n_b)
                   for ci in live if not mask[int(flats_h[ci]) - w - 1]}
            for ci in live:
                f0 = int(flats_h[ci])
                res = settle(j, mask, f0,
                             pre.get(ci, ([], "more",
                                          (f0 % w, f0 // w, MATCH,
                                           int(scores_h[ci])))),
                             w, n_a, n_b)
                if res == "hit":
                    hit_flat[j, n] = f0
                    hit_score[j, n] = scores_h[ci]
                    n += 1
                    if n == k:
                        break
                elif res == "fail":
                    fail = True
                    break
            c += width
        nhits[j] = -1 if fail else n
    return tuple(torch.from_numpy(v) for v in (hit_flat, hit_score, nhits))


def equal(got, want):
    return all(torch.equal(g.cpu(), w.cpu()) for g, w in zip(got, want))


def fill_cases(device="cpu"):
    """Real hint-less fills on ``device``: (name, args) for each scoring
    of SCORINGS on 4 ragged pairs."""
    out = []
    for seed, (name, (make, alpha)) in enumerate(SCORINGS.items()):
        rng = np.random.default_rng(100 + seed)
        A, B = text(rng, alpha, 4, 0, 90), text(rng, alpha, 4, 1, 70)
        if name == "lcs":
            B = A = [a + a[: len(a) // 2] for a in A]
        out.append((name, hit_args(make(), A, B, device)))
    return out


@pytest.mark.parametrize("depth", [1, 4, 8])
def test_window_order_equals_serial_loop_on_fills(depth):
    for name, args in fill_cases():
        for k in (1, 16, 10_000):
            want = sw_hits_plain(*with_k(args, k))
            assert equal(window_hits(*with_k(args, k), depth=depth), want), \
                (name, k)
    # the deep round found streams shorter than k: the candidates ran out
    assert (want[2] >= 0).all() and (want[2] < 10_000).all()


@pytest.mark.parametrize("seed", range(6))
def test_window_order_equals_serial_loop_with_dir_fails(seed):
    """DIR_FAIL codes planted in real fills: a stream fails only where the
    serial order reaches one, never in a lane it does not reach."""
    make, alpha = SCORINGS["dna"]
    rng = np.random.default_rng(seed)
    args = hit_args(make(), text(rng, alpha, 3, 20, 80),
                    text(rng, alpha, 3, 20, 80))
    args = plant_dir_fails(args, seed, 6)
    for k in (1, 4, 16, 10_000):
        for depth in (1, 4):
            assert equal(window_hits(*with_k(args, k), depth=depth),
                         sw_hits_plain(*with_k(args, k))), (k, depth)


def test_dir_fail_past_the_kth_hit_is_not_raised():
    """A stream with a DIR_FAIL past its k-th hit: cut at k it has k hits,
    run on it fails; the window order gives both."""
    args = dir_fail_past_k_case()
    ok = sw_hits_plain(*with_k(args, 2))
    assert ok[2].tolist() == [2]
    assert sw_hits_plain(*with_k(args, 10_000))[2].tolist() == [-1]
    for k in (2, 10_000):
        assert equal(window_hits(*with_k(args, k)),
                     sw_hits_plain(*with_k(args, k)))


def dir_fail_past_k_case(device="cpu"):
    """One DNA pair whose stream reaches a planted DIR_FAIL after its
    second hit (found by search over seeded plantings; checked by
    ``test_dir_fail_past_the_kth_hit_is_not_raised``)."""
    make, alpha = SCORINGS["dna"]
    rng = np.random.default_rng(7)
    A, B = text(rng, alpha, 1, 60, 60), text(rng, alpha, 1, 60, 60)
    base = hit_args(make(), A, B, device)
    for seed in range(200):
        args = plant_dir_fails(base, seed, 3)
        if sw_hits_plain(*with_k(args, 2))[2].tolist() == [2] and \
                sw_hits_plain(*with_k(args, 10_000))[2].tolist() == [-1]:
            return args
    raise AssertionError("no planting fails past the second hit")


def test_cascade_inside_a_window():
    """The cascade: one hit, every later diagonal candidate marked by its
    predecessor's mark, across the border of the first window; with the
    diagonal's MATCH codes made DIR_FAIL the stream still has its one hit,
    since the shortcut reads no code."""
    sc, A, B = cascade_case()
    args = hit_args(sc, A, B, k=10_000)
    counts = (args[8] - args[7]).tolist()
    assert counts[0] == CASCADE_RUN + 1 > 32
    want = sw_hits_plain(*args)
    assert want[2][0] == 1 and want[0][0, 0] == 1 * (len(A[0]) + 1) + 1
    failing = fail_cascade(args)
    want_f = sw_hits_plain(*failing)
    assert want_f[2][0] == 1 and want_f[0][0, 0] == want[0][0, 0]
    for depth in (1, 4, 8):
        assert equal(window_hits(*args, depth=depth), want)
        assert equal(window_hits(*failing, depth=depth), want_f)


def test_cascade_hit_stream_vs_jax(monkeypatch):
    """The port's hit stream on the cascade (``sw_hits`` then ``sw_walk``
    on its device path) equals the JAX package's iterator."""
    seqalign_tpu = pytest.importorskip("seqalign_tpu")
    monkeypatch.setenv("SEQALIGN_FORCE", "device")
    monkeypatch.setenv("SEQALIGN_PALLAS", "interpret")
    monkeypatch.setenv("SEQALIGN_PALLAS_FLOOR", "16")
    sc, A, B = cascade_case()
    jsc = seqalign_tpu.ScoringConfig(1, 0, -5, -5)
    want = [[dataclasses.astuple(h) for h in it]
            for it in seqalign_tpu.SmithWaterman(jsc).align_batch(A, B)]
    got = [[dataclasses.astuple(h) for h in it]
           for it in SmithWaterman(sc, device="cpu").align_batch(A, B)]
    assert got == want and len(got[0]) == 1


def test_hits_count_tool_adds_up():
    """The counting tool behind the kernel's depth (tools/hits_count.py):
    every visited candidate is skipped, shortcut or walked; its hits are
    ``sw_hits_plain``'s; the loads at each depth follow its cell counts."""
    from seqalign_tpu_torch.tools import hits_count

    rng = np.random.default_rng(5)
    A, B = hits_count.dna(rng, 2, 120), hits_count.dna(rng, 2, 120)
    counts = hits_count.count(A, B, 4)
    want = sw_hits_plain(*with_k(hit_args(scoring_system_sw_default(), A, B),
                                 4))[2].tolist()
    for c, n in zip(counts, want):
        assert c["visited"] == c["marked"] + c["pred_marked"] + c["walks"]
        assert c["hits"] == n and c["walks"] == sum(c["walks_by_cells"])
        assert c["windows"] == -(-c["visited"] // 32)
        assert c["loads_by_depth"][2] >= c["windows"] * 2
    assert hits_count.main(["--pairs", "1", "--length", "40", "--k", "2"]) == 0
