"""The port's CUDA kernels against their plain PyTorch versions, on the
card.  Every test here is marked ``cuda`` and skips without a GPU; this
file imports only the port, so it runs where only PyTorch is installed:

    python -m pytest --noconftest -q tests/test_torch_cuda.py
"""

import dataclasses

import numpy as np
import pytest
import torch

from seqalign_tpu_torch import (NeedlemanWunsch, ScoringConfig, SmithWaterman,
                                kernel_launch_counts, kernel_params,
                                lcs_aligner)
from seqalign_tpu_torch import aligners
from seqalign_tpu_torch.ops import host_dp, kernels
from seqalign_tpu_torch.ops.dp import boundary_column as dp_boundary
from seqalign_tpu_torch.ops.dp import (merge_candidates,
                                       nw_fill_dirs_carry_plain,
                                       nw_fill_dirs_plain, nw_scores_plain,
                                       sw_extract_candidates,
                                       sw_fill_dirs_carry_plain,
                                       sw_fill_dirs_plain, sw_scores_plain,
                                       sw_sorted_candidates)
from seqalign_tpu_torch.ops.pack import m16_safe, pack_batch, pack_inputs_mm
from seqalign_tpu_torch.ops.traceback import (SwDeviceHits, nw_walk_plain,
                                              sw_hits_plain, sw_walk_plain)
from seqalign_tpu_torch.scoring.presets import (scoring_system_BLOSUM62,
                                                scoring_system_default,
                                                scoring_system_sw_default)

pytestmark = pytest.mark.cuda
NW_KERNELS = ("nw_scores", "nw_fill_dirs", "nw_walk")


def _launches(counts, k):
    """Launches of kernel ``k`` in ``counts``, across widths or not."""
    return counts[k] + counts.get(f"{k}[ragged]", 0)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def _seqs(rng, n, lo, hi):
    alpha = np.frombuffer(b"acgtACGT", np.uint8)
    return [bytes(alpha[rng.integers(0, 8, int(k))]).decode()
            for k in rng.integers(lo, hi + 1, n)]


# (B, lo, hi, LA, LB): ragged short; 36*(LB+1) > 48 KB (opt-in shared
# memory); LB > 6455 (diagonals in global scratch)
SHAPES = [(16, 0, 300, 512, 512), (4, 1, 2000, 2048, 2048),
          (2, 6500, 7000, 7168, 7168)]


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"LB{s[4]}")
@pytest.mark.parametrize("cs", [False, True], ids=["fold", "case_sens"])
def test_kernels_equal_plain_versions(dev, shape, cs):
    B, lo, hi, LA, LB = shape
    sc = ScoringConfig(1, -2, -4, -1, case_sensitive=cs)
    rng = np.random.default_rng(LB + cs)
    p = kernel_params(sc, dev)
    ac, bc, na, nb = (torch.from_numpy(v).to(dev) for v in pack_inputs_mm(
        p, _seqs(rng, B, lo, hi), _seqs(rng, B, lo, hi), LA, LB))
    before = kernel_launch_counts()
    s, c = kernels.nw_scores(ac, bc, na, nb, p)
    sp, cp = nw_scores_plain(ac, bc, na, nb, p)
    assert torch.equal(s, sp) and torch.equal(c, cp)
    d, dc = kernels.nw_fill_dirs(ac, bc, na, nb, p)
    dpl, dcp = nw_fill_dirs_plain(ac, bc, na, nb, p)
    assert torch.equal(dc, dcp)
    y = torch.arange(LB + 1, device=dev)[None, None, :]
    x = torch.arange(LA + LB - 1, device=dev)[None, :, None] + 2 - y
    v = ((y >= 1) & (y <= nb[:, None, None]) & (x >= 1)
         & (x <= na[:, None, None]))
    assert torch.equal(d[v], dpl[v])
    cap = int((na + nb).max())
    o, osc = kernels.nw_walk(d, dc, na, nb, cap)
    op, oscp = nw_walk_plain(dpl, dcp, na, nb, cap)
    assert torch.equal(o, op) and torch.equal(osc, oscp)
    after = kernel_launch_counts()
    assert all(after[k] == before[k] + 1 for k in NW_KERNELS)


def test_wrapper_rejects_bad_cuda_input(dev):
    p = kernel_params(scoring_system_default(), dev)
    ac = torch.zeros((2, 8), dtype=torch.uint8, device=dev)
    n = torch.ones(2, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError):
        kernels.nw_scores(ac.int(), ac, n, n, p)
    with pytest.raises(ValueError):
        kernels.nw_scores(ac, ac, n, n, kernel_params(
            scoring_system_default(), "cpu"))


def test_aligner_on_cuda_matches_host(dev, monkeypatch):
    monkeypatch.setenv("SEQALIGN_FORCE", "device")
    sc = scoring_system_default()
    rng = np.random.default_rng(3)
    A, B = _seqs(rng, 24, 1, 700), _seqs(rng, 24, 1, 700)
    nw = NeedlemanWunsch(sc, device="cuda")
    before = kernel_launch_counts()
    alns = nw.align_batch(A, B)
    scores = nw.score_batch(A, B)
    after = kernel_launch_counts()
    assert all(_launches(after, k) > _launches(before, k)
               for k in NW_KERNELS)
    for a, b, got, s in zip(A, B, alns, scores):
        want = host_dp.nw_align(sc, a, b)
        assert (got.result_a, got.result_b, got.score) == (
            want.result_a, want.result_b, want.score)
        assert s == want.score


PROTEIN = "ARNDCQEGHILKMFPSTWYVBZX"


def _wide_alphabet_config():
    """Equality scoring plus a wildcard, over sequences of 255 distinct
    bytes: a 256 x 256 table, too large for shared memory beside the
    diagonals, so the kernels read it through the global path."""
    sc = ScoringConfig(2, -1, -3, -1, case_sensitive=True)
    sc.add_wildcard("N", 0)
    return sc, "".join(map(chr, range(1, 256)))


TABLE_CASES = {
    "sw_default_dna": (scoring_system_sw_default, "acgtACGT"),
    "blosum62": (scoring_system_BLOSUM62, PROTEIN),
    "wide_table": (_wide_alphabet_config, None),
}


def _text(rng, alpha, n, lo, hi):
    letters = np.array(list(alpha))
    return ["".join(letters[rng.integers(0, len(letters), int(k))])
            for k in rng.integers(lo, hi + 1, n)]


def _valid(dev, na, nb, LA, LB):
    y = torch.arange(LB + 1, device=dev)[None, None, :]
    x = torch.arange(LA + LB - 1, device=dev)[None, :, None] + 2 - y
    return ((y >= 1) & (y <= nb[:, None, None]) & (x >= 1)
            & (x <= na[:, None, None]))


@pytest.mark.parametrize("shape", SHAPES[:2], ids=lambda s: f"LB{s[4]}")
@pytest.mark.parametrize("case", list(TABLE_CASES))
def test_sw_and_table_kernels_equal_plain_versions(dev, shape, case):
    """sw_scores, sw_fill_dirs (int16 and int32 M), sw_walk and sw_hits
    (mask in shared memory at 512 lanes, in global memory at 2,048) on the
    harvested candidates, and the table mode of nw_scores/nw_fill_dirs,
    each against its plain version on the same CUDA tensors."""
    B, lo, hi, LA, LB = shape
    make, alpha = TABLE_CASES[case]
    out = make()
    sc, alpha = out if isinstance(out, tuple) else (out, alpha)
    rng = np.random.default_rng(LB + len(case))
    p = kernel_params(sc, dev)
    ac, bc, na, nb, bp = pack_batch(sc, p, _text(rng, alpha, B, lo, hi),
                                    _text(rng, alpha, B, lo, hi), LA, LB)
    if case != "sw_default_dna":
        assert bp.sub is not None
    ac, bc, na_t, nb_t = (torch.from_numpy(v).to(dev)
                          for v in (ac, bc, na, nb))
    before = kernel_launch_counts()
    s = kernels.sw_scores(ac, bc, na_t, nb_t, bp)
    assert torch.equal(s, sw_scores_plain(ac, bc, na_t, nb_t, bp))
    v = _valid(dev, na_t, nb_t, LA, LB)
    dpl, mpl = sw_fill_dirs_plain(ac, bc, na_t, nb_t, bp)
    for m16 in (False, True):
        d, m = kernels.sw_fill_dirs(ac, bc, na_t, nb_t, bp, m16)
        assert m.dtype == (torch.int16 if m16 else torch.int32)
        assert torch.equal(d[v], dpl[v])
        assert torch.equal(m[v].int(), mpl[v])
    cands = sw_extract_candidates(m, na, nb, 1)
    jw = np.concatenate([np.full(min(len(c[0]), 40), j)
                         for j, c in enumerate(cands)])
    flats = np.concatenate([c[0][:40] for c in cands])
    sc0 = np.concatenate([c[1][:40] for c in cands])
    w = (na[jw] + 1).astype(np.int64)
    args = [torch.from_numpy(np.asarray(a, np.int32)).to(dev)
            for a in (jw, flats % w, flats // w, sc0)]
    cap = int(na.max() + nb.max())
    ops = kernels.sw_walk(d, ac, bc, na_t, nb_t, *args, bp, cap)
    assert torch.equal(ops, sw_walk_plain(d, ac, bc, na_t, nb_t, *args, bp,
                                          cap))
    assert (ops[:, 0] == 0).all()  # every walk starts in MATCH
    flat, score, off = sw_sorted_candidates(m, na, nb, 1)
    hargs = (d, ac, bc, na_t, nb_t, flat, score, off[:-1], off[1:], bp, 16)
    hits = kernels.sw_hits(*hargs)
    want = sw_hits_plain(*hargs)
    assert all(torch.equal(g, w) for g, w in zip(hits, want))
    assert (hits[2] == 16).sum() > 0
    # the int64 instantiation (flats of pairs past 2^31 cells) finds the
    # same hits from the same candidates
    assert flat.dtype == torch.int32
    hits64 = kernels.sw_hits(d, ac, bc, na_t, nb_t, flat.long(), score,
                             off[:-1], off[1:], bp, 16)
    assert hits64[0].dtype == torch.int64
    assert torch.equal(hits64[0], hits[0].long())
    assert all(torch.equal(g, w) for g, w in zip(hits64[1:], hits[1:]))
    sn, cn = kernels.nw_scores(ac, bc, na_t, nb_t, bp)
    spn, cpn = nw_scores_plain(ac, bc, na_t, nb_t, bp)
    assert torch.equal(sn, spn) and torch.equal(cn, cpn)
    dn, cdn = kernels.nw_fill_dirs(ac, bc, na_t, nb_t, bp)
    dnp, cdnp = nw_fill_dirs_plain(ac, bc, na_t, nb_t, bp)
    assert torch.equal(dn[v], dnp[v]) and torch.equal(cdn, cdnp)
    after = kernel_launch_counts()
    assert {k: after[k] - before[k] for k in after} == {
        "nw_scores": 1, "nw_fill_dirs": 1, "nw_fill_dirs_carry": 0,
        "nw_walk": 0, "sw_scores": 1, "sw_fill_dirs": 2,
        "sw_fill_dirs_carry": 0, "sw_walk": 1, "sw_hits": 2,
        "nw_fill_gab": 0, "sw_fill_gab": 0, "vpu_chain": 0,
        "nw_scores[ragged]": 0, "nw_fill_dirs[ragged]": 0,
        "sw_scores[ragged]": 0, "sw_fill_dirs[ragged]": 0,
        "sw_hits[ragged]": 0, "nw_scores_slice": 0, "sw_scores_slice": 0,
        "nw_fill_dirs_slice": 0}


def test_sw_scores_in_global_scratch(dev):
    """Pairs past 6,455 lanes keep the diagonals in global scratch."""
    sc = scoring_system_sw_default()
    rng = np.random.default_rng(7)
    p = kernel_params(sc, dev)
    ac, bc, na, nb = (torch.from_numpy(v).to(dev) for v in pack_inputs_mm(
        p, _seqs(rng, 2, 6500, 7000), _seqs(rng, 2, 6500, 7000), 7168,
        7168))
    assert torch.equal(kernels.sw_scores(ac, bc, na, nb, p),
                       sw_scores_plain(ac, bc, na, nb, p))


def test_smith_waterman_on_cuda_matches_host(dev, monkeypatch):
    """Hit streams on the card equal the shared host DP's, with every
    pair's hits found on the card and then every pair on the host walk."""
    monkeypatch.setenv("SEQALIGN_FORCE", "device")
    sc = scoring_system_BLOSUM62()
    rng = np.random.default_rng(11)
    A, B = _text(rng, PROTEIN, 12, 1, 300), _text(rng, PROTEIN, 12, 1, 300)
    sw = SmithWaterman(sc, device="cuda")
    # 40 hits: past the first device round of 16
    want = [[h for _, h in zip(range(40), host_dp.HostSwHits(sc, a, b))]
            for a, b in zip(A, B)]
    for cut, walks in ((1 << 62, True), (-1, False)):
        monkeypatch.setattr(aligners, "_SW_DEVWALK_CANDS", cut)
        before = kernel_launch_counts()
        its = sw.align_batch(A, B)
        best = sw.best_score_batch(A, B)
        got = [[h for _, h in zip(range(40), it)] for it in its]
        after = kernel_launch_counts()
        for k in ("sw_scores", "sw_fill_dirs"):
            assert _launches(after, k) > _launches(before, k), k
        for k in ("sw_walk", "sw_hits"):
            assert (_launches(after, k) > _launches(before, k)) == walks, k
        assert all(isinstance(it, SwDeviceHits) == walks for it in its)
        assert [[dataclasses.astuple(h) for h in g] for g in got] == \
            [[dataclasses.astuple(h) for h in w] for w in want]
        assert list(best) == [w[0].score if w else 0 for w in want]


MODES = {
    "nsg": dict(no_start_gap_penalty=True),
    "neg": dict(no_end_gap_penalty=True),
    "nsg_neg": dict(no_start_gap_penalty=True, no_end_gap_penalty=True),
    "nga": dict(no_gaps_in_a=True),
    "ngb": dict(no_gaps_in_b=True),
    "nga_ngb": dict(no_gaps_in_a=True, no_gaps_in_b=True),
    "nmm": dict(no_mismatches=True),
    "neg_nga": dict(no_end_gap_penalty=True, no_gaps_in_a=True),
    "nga_ngb_nmm": dict(no_gaps_in_a=True, no_gaps_in_b=True,
                        no_mismatches=True),
    "gap_open_pos": dict(),
}


def _mode_config(mode, table):
    if table:
        sc = scoring_system_BLOSUM62()
        for k, v in MODES[mode].items():
            setattr(sc, k, v)
        if mode == "gap_open_pos":
            sc.gap_open = 1
        sc._luts = None
        return sc, PROTEIN
    if mode == "gap_open_pos":
        return ScoringConfig(2, -3, 1, -1), "acgtACGT"
    return ScoringConfig(1, -2, -4, -1, **MODES[mode]), "acgtACGT"


@pytest.mark.parametrize("table", [False, True], ids=["equality", "table"])
@pytest.mark.parametrize("mode", list(MODES))
def test_mode_kernels_equal_plain_versions(dev, mode, table):
    """Every recurrence mode of the four fills, and the SW hit loop and
    walks on the harvested candidates, against the plain versions on the
    same CUDA tensors; the batch holds empty sides."""
    sc, alpha = _mode_config(mode, table)
    B, LA, LB = 16, 256, 128
    rng = np.random.default_rng(len(mode) + table)
    A, Bs = _text(rng, alpha, B, 0, LA), _text(rng, alpha, B, 0, LB)
    A[0], Bs[1] = "", ""
    ac, bc, na, nb, bp = pack_batch(sc, kernel_params(sc, dev), A, Bs, LA, LB)
    assert bp.modes == kernel_params(sc, "cpu").modes
    assert (bp.sub is not None) == table
    ac, bc, na_t, nb_t = (torch.from_numpy(v).to(dev)
                          for v in (ac, bc, na, nb))
    v = _valid(dev, na_t, nb_t, LA, LB)
    s, c = kernels.nw_scores(ac, bc, na_t, nb_t, bp)
    sp, cp = nw_scores_plain(ac, bc, na_t, nb_t, bp)
    assert torch.equal(s, sp) and torch.equal(c, cp)
    d, dc = kernels.nw_fill_dirs(ac, bc, na_t, nb_t, bp)
    dpl, dcp = nw_fill_dirs_plain(ac, bc, na_t, nb_t, bp)
    assert torch.equal(d[v], dpl[v]) and torch.equal(dc, dcp)
    cap = int((na_t + nb_t).max())
    assert all(torch.equal(g, w) for g, w in zip(
        kernels.nw_walk(d, dc, na_t, nb_t, cap),
        nw_walk_plain(dpl, dcp, na_t, nb_t, cap)))
    assert torch.equal(kernels.sw_scores(ac, bc, na_t, nb_t, bp),
                       sw_scores_plain(ac, bc, na_t, nb_t, bp))
    m16 = m16_safe(sc, LA, LB)
    d, m = kernels.sw_fill_dirs(ac, bc, na_t, nb_t, bp, m16)
    dpl, mpl = sw_fill_dirs_plain(ac, bc, na_t, nb_t, bp, m16)
    assert torch.equal(d[v], dpl[v]) and torch.equal(m[v], mpl[v])
    flat, score, off = sw_sorted_candidates(m, na, nb, 1)
    hargs = (d, ac, bc, na_t, nb_t, flat, score, off[:-1], off[1:], bp, 16)
    hits = kernels.sw_hits(*hargs)
    assert all(torch.equal(g, w) for g, w in zip(hits, sw_hits_plain(*hargs)))
    keep = torch.arange(16, device=dev)[None, :] < hits[2][:, None]
    jw, slot = keep.nonzero(as_tuple=True)
    w = na_t[jw] + 1
    starts = [t.to(torch.int32).contiguous()
              for t in (jw, hits[0][jw, slot] % w, hits[0][jw, slot] // w,
                        hits[1][jw, slot])]
    assert torch.equal(
        kernels.sw_walk(d, ac, bc, na_t, nb_t, *starts, bp, cap),
        sw_walk_plain(d, ac, bc, na_t, nb_t, *starts, bp, cap))


def test_table_nmm_tables_past_shared_memory(dev):
    """no_mismatches over 255 distinct bytes: the substitution and
    is-match tables (2 x 256 KB) do not fit beside the diagonals and are
    read through the global path."""
    sc, alpha = _wide_alphabet_config()
    sc.no_mismatches = True
    sc._luts = None
    rng = np.random.default_rng(5)
    A, B = _text(rng, alpha, 4, 100, 500), _text(rng, alpha, 4, 100, 500)
    ac, bc, na, nb, bp = pack_batch(sc, kernel_params(sc, dev), A, B, 512,
                                    512)
    assert 8 * bp.sub.numel() > kernels.SMEM_MAX
    t = [torch.from_numpy(v).to(dev) for v in (ac, bc, na, nb)]
    assert torch.equal(kernels.sw_scores(*t, bp), sw_scores_plain(*t, bp))
    assert torch.equal(kernels.nw_scores(*t, bp)[1],
                       nw_scores_plain(*t, bp)[1])


def test_modes_on_cuda_match_host(dev, monkeypatch):
    """Free end gaps (NW) and the LCS recipe (SW) through the aligners on
    the card equal the int64 host path."""
    monkeypatch.setenv("SEQALIGN_FORCE", "device")
    rng = np.random.default_rng(13)
    sc = ScoringConfig(1, -2, -4, -1, no_start_gap_penalty=True,
                       no_end_gap_penalty=True)
    A, B = _seqs(rng, 16, 200, 600), _seqs(rng, 16, 20, 100)
    nw = NeedlemanWunsch(sc, device="cuda")
    before = kernel_launch_counts()
    got = nw.align_batch(A, B)
    scores = nw.score_batch(A, B)
    after = kernel_launch_counts()
    assert all(_launches(after, k) > _launches(before, k)
               for k in NW_KERNELS)
    want = [host_dp.nw_align(sc, a, b) for a, b in zip(A, B)]
    assert [dataclasses.astuple(g) for g in got] == \
        [dataclasses.astuple(w) for w in want]
    assert list(scores) == [w.score for w in want]
    sw = lcs_aligner()
    assert sw.device.type == "cuda"
    S = _seqs(rng, 8, 100, 300)
    its = sw.align_batch(S, S)
    for s, it in zip(S, its):
        got = [dataclasses.astuple(h) for _, h in zip(range(20), it)]
        want = [dataclasses.astuple(h) for _, h in zip(
            range(20), host_dp.HostSwHits(sw.scoring, s, s))]
        assert got == want


def _slab_valid(dev, D, LB, c, ca, na, nb):
    """Cells of slab ``c`` (chunk columns c*ca+1 .. c*ca+ca) that lie in
    the pairs: 1 <= y <= nb, 1 <= x <= na."""
    y = torch.arange(LB + 1, device=dev)[None, None, :]
    xl = torch.arange(D, device=dev)[None, :, None] + 2 - y
    x = xl + c * ca
    return ((y >= 1) & (y <= nb[:, None, None]) & (xl >= 1) & (xl <= ca)
            & (x <= na[:, None, None]))


def _carry_run(fill, args, nch, ca, LB, B, dev, sw, m16):
    """Every chunk of a batch through one carry fill (kernel or plain):
    the slabs, each chunk's bout and M, the corner and the best."""
    bin = dp_boundary(args[4], B, LB, is_sw=sw, device=dev)
    bout = torch.zeros_like(bin)
    dirs = torch.zeros((B, nch, ca + LB - 1, LB + 1), dtype=torch.uint8,
                       device=dev)
    acc = torch.zeros((B, 3), dtype=torch.int32, device=dev) if not sw \
        else torch.zeros(B, dtype=torch.int32, device=dev)
    bouts, ms = [], []
    for c in range(nch):
        m = fill(*args, c * ca, bin, bout, dirs[:, c], acc,
                 *((m16,) if sw else ()))
        bouts.append(bout.clone())
        ms.append(m)
        bin, bout = bout, bin
    return dirs, bouts, ms, acc


# (mode, (CA, LA, LB)): ragged widths in opt-in shared memory under each
# mode, and the diagonals in global scratch (LB > 6,455) by default
CARRY_CASES = [(m, (64, 600, 300)) for m in ("default", "nsg_neg",
                                             "nga_ngb_nmm", "table")]
CARRY_CASES.append(("default", (1024, 2600, 6600)))


@pytest.mark.parametrize("sw", [False, True], ids=["nw", "sw"])
@pytest.mark.parametrize("mode,width", CARRY_CASES,
                         ids=lambda v: v if isinstance(v, str)
                         else f"LB{v[2]}")
def test_carry_kernels_equal_plain_versions(dev, mode, sw, width):
    """Each carry kernel against its plain version chunk by chunk, on
    ragged pairs that end in different chunks (one of them on a chunk's
    last column): codes of every slab on the valid cells, bout on the
    lanes 1 .. nb of the pairs that reach it (row 0 is not carried), the
    corner (an empty seq_b's among them) or the best, and M; past 6,455
    lanes the diagonals live in global scratch."""
    ca, la, lb = width
    if mode == "table":
        sc, alpha = _mode_config("nga_ngb_nmm", True)
    elif mode == "default":
        sc, alpha = (scoring_system_sw_default() if sw else
                     scoring_system_default()), "acgtACGT"
    else:
        sc, alpha = _mode_config(mode, False)
    rng = np.random.default_rng(len(mode) + 7 * sw + ca)
    B = 4
    A, Bs = _text(rng, alpha, B, la // 2, la), _text(rng, alpha, B, 1, lb)
    A[0] = A[0][:2 * ca]  # ends on the last column of chunk 1
    Bs[3] = ""  # the corner is a boundary cell
    ac, bc, na, nb, bp = pack_batch(sc, kernel_params(sc, dev), A, Bs, la,
                                    lb)
    t = [torch.from_numpy(v).to(dev) for v in (ac, bc, na, nb)]
    nch = -(-la // ca)
    m16 = m16_safe(sc, la, lb)
    kfill = kernels.sw_fill_dirs_carry if sw else kernels.nw_fill_dirs_carry
    pfill = sw_fill_dirs_carry_plain if sw else nw_fill_dirs_carry_plain
    before = kernel_launch_counts()
    got = _carry_run(kfill, (*t, bp), nch, ca, lb, B, dev, sw, m16)
    name = "sw_fill_dirs_carry" if sw else "nw_fill_dirs_carry"
    assert kernel_launch_counts()[name] == before[name] + nch
    want = _carry_run(pfill, (*t, bp), nch, ca, lb, B, dev, sw, m16)
    D = ca + lb - 1
    na_t, nb_t = t[2], t[3]
    for c in range(nch):
        v = _slab_valid(dev, D, lb, c, ca, na_t, nb_t)
        assert torch.equal(got[0][:, c][v], want[0][:, c][v])
        if sw:
            assert torch.equal(got[2][c][v], want[2][c][v])
        reach = na_t >= (c + 1) * ca
        y = torch.arange(lb + 1, device=dev)[None, None, :]
        lanes = (y >= 1) & (y <= nb_t[:, None, None])
        keep = (reach[:, None, None] & lanes).expand(-1, 3, -1)
        assert torch.equal(got[1][c][keep], want[1][c][keep])
    assert torch.equal(got[3], want[3])


def test_slab_walks_equal_plain_versions(dev):
    """nw_walk, sw_hits and sw_walk over chunk slabs against their plain
    versions, and against the same walks over the unchunked plane."""
    sc = scoring_system_sw_default()
    rng = np.random.default_rng(29)
    B, la, lb, ca = 4, 700, 300, 128
    A, Bs = _seqs(rng, B, 400, la), _seqs(rng, B, 100, lb)
    for is_sw in (False, True):
        nsc = sc if is_sw else scoring_system_default()
        ac, bc, na, nb, bp = pack_batch(nsc, kernel_params(nsc, dev), A, Bs,
                                        la, lb)
        t = [torch.from_numpy(v).to(dev) for v in (ac, bc, na, nb)]
        nch = -(-la // ca)
        fill = kernels.sw_fill_dirs_carry if is_sw else \
            kernels.nw_fill_dirs_carry
        slabs, _, ms, acc = _carry_run(fill, (*t, bp), nch, ca, lb, B, dev,
                                       is_sw, True)
        cap = int((t[2] + t[3]).max())
        if not is_sw:
            d, corner = kernels.nw_fill_dirs(*t, bp)
            assert torch.equal(acc, corner)
            got = kernels.nw_walk(slabs, acc, t[2], t[3], cap)
            assert all(torch.equal(g, w) for g, w in zip(
                got, nw_walk_plain(slabs, acc, t[2], t[3], cap)))
            assert all(torch.equal(g, w) for g, w in zip(
                got, kernels.nw_walk(d, corner, t[2], t[3], cap)))
            continue
        parts = [sw_sorted_candidates(m, na, nb, 1, x_off=c * ca)
                 for c, m in enumerate(ms)]
        flat, score, off = merge_candidates(parts, B)
        d, m = kernels.sw_fill_dirs(*t, bp, True)
        f1, s1, o1 = sw_sorted_candidates(m, na, nb, 1)
        assert torch.equal(flat, f1) and torch.equal(score, s1)
        args = (slabs, *t, flat, score, off[:-1], off[1:], bp, 16)
        hits = kernels.sw_hits(*args)
        assert all(torch.equal(g, w) for g, w in zip(hits,
                                                     sw_hits_plain(*args)))
        assert all(torch.equal(g, w) for g, w in zip(hits, kernels.sw_hits(
            d, *t, f1, s1, o1[:-1], o1[1:], bp, 16)))
        keep = torch.arange(16, device=dev)[None, :] < hits[2][:, None]
        jw, slot = keep.nonzero(as_tuple=True)
        w = t[2][jw].long() + 1
        starts = [v.to(torch.int32).contiguous()
                  for v in (jw, hits[0][jw, slot] % w, hits[0][jw, slot] // w,
                            hits[1][jw, slot])]
        o = kernels.sw_walk(slabs, *t, *starts, bp, cap)
        assert torch.equal(o, sw_walk_plain(slabs, *t, *starts, bp, cap))
        assert torch.equal(o, kernels.sw_walk(d, *t, *starts, bp, cap))


def test_long_path_on_cuda_matches_host(dev, monkeypatch):
    """Pairs over LONG_PAIR_CELLS through both aligners on the card: the
    carry kernels and the walks over slabs are launched, and the answers
    equal the int64 host path."""
    monkeypatch.setenv("SEQALIGN_FORCE", "device")
    monkeypatch.setattr(aligners, "LONG_PAIR_CELLS", 20_000)
    monkeypatch.setattr(aligners, "LONG_CHUNK", 96)
    rng = np.random.default_rng(31)
    A, B = _seqs(rng, 6, 150, 400), _seqs(rng, 6, 100, 200)
    nw = NeedlemanWunsch(device="cuda")
    before = kernel_launch_counts()
    got = nw.align_batch(A, B)
    after = kernel_launch_counts()
    assert after["nw_fill_dirs_carry"] > before["nw_fill_dirs_carry"]
    assert after["nw_walk"] > before["nw_walk"]
    want = [host_dp.nw_align(nw.scoring, a, b) for a, b in zip(A, B)]
    assert [dataclasses.astuple(g) for g in got] == \
        [dataclasses.astuple(w) for w in want]
    sw = SmithWaterman(device="cuda")
    its = sw.align_batch(A, B)
    after = kernel_launch_counts()
    for k in ("sw_fill_dirs_carry", "sw_hits", "sw_walk"):
        assert after[k] > before[k]
    for a, b, it in zip(A, B, its):
        g = [dataclasses.astuple(h) for _, h in zip(range(40), it)]
        w = [dataclasses.astuple(h) for _, h in zip(
            range(40), host_dp.HostSwHits(sw.scoring, a, b))]
        assert g == w


@pytest.mark.parametrize("table", [False, True], ids=["equality", "table"])
@pytest.mark.parametrize("mode", ["default"] + list(MODES))
def test_gab_kernels_equal_plain_versions(dev, mode, table):
    """The matrix-dump fills (codes, corner, M, Ga and Gb planes) under
    every recurrence mode against their plain versions on the same CUDA
    tensors, with empty sides; beside them the dirs fills' codes and M."""
    from seqalign_tpu_torch.ops.dp import nw_fill_gab_plain, sw_fill_gab_plain

    sc, alpha = ((ScoringConfig(1, -2, -4, -1), "acgtACGT")
                 if mode == "default" else _mode_config(mode, table))
    if mode == "default" and table:
        sc, alpha = scoring_system_BLOSUM62(), "ARNDCQEGHILKMFPSTWYV"
    B, LA, LB = 12, 300, 200
    rng = np.random.default_rng(len(mode) + 2 * table)
    A, Bs = _text(rng, alpha, B, 0, LA), _text(rng, alpha, B, 0, LB)
    A[0], Bs[1] = "", ""
    ac, bc, na, nb, bp = pack_batch(sc, kernel_params(sc, dev), A, Bs, LA, LB)
    t = [torch.from_numpy(v).to(dev) for v in (ac, bc, na, nb)]
    v = _valid(dev, t[2], t[3], LA, LB)
    before = kernel_launch_counts()
    d, c, g = kernels.nw_fill_gab(*t, bp)
    dp_, cp, gp = nw_fill_gab_plain(*t, bp)
    assert torch.equal(d[v], dp_[v]) and torch.equal(c, cp)
    assert all(torch.equal(g[k][v], gp[k][v]) for k in range(3))
    assert torch.equal(d[v], kernels.nw_fill_dirs(*t, bp)[0][v])
    d, g = kernels.sw_fill_gab(*t, bp)
    dp_, gp = sw_fill_gab_plain(*t, bp)
    assert torch.equal(d[v], dp_[v])
    assert all(torch.equal(g[k][v], gp[k][v]) for k in range(3))
    _, m = kernels.sw_fill_dirs(*t, bp, False)
    assert torch.equal(m[v], g[0][v])
    after = kernel_launch_counts()
    assert after["nw_fill_gab"] == before["nw_fill_gab"] + 1
    assert after["sw_fill_gab"] == before["sw_fill_gab"] + 1


# one pair as the matrix dump fills it: CLI job 5's 300 x 200, and one
# past a round of the tiles' lanes (kernels.TILE_LANES), whose strips hand
# their edge on through the round row in scratch
GAB_PAIRS = {"dump": (300, 200), "wide": (3000, 2500)}


@pytest.mark.parametrize("mode", ["default", "nsg_neg", "nga_ngb_nmm"])
@pytest.mark.parametrize("table", [False, True], ids=["equality", "table"])
@pytest.mark.parametrize("pair", list(GAB_PAIRS))
def test_gab_kernels_on_one_pair_equal_plain_versions(dev, pair, table,
                                                      mode):
    """The matrix-dump fills on one pair of :data:`GAB_PAIRS` (codes,
    corner, M, Ga and Gb planes) against their plain versions on the same
    CUDA tensors, default flags and two flag sets, equality and BLOSUM62."""
    from seqalign_tpu_torch.ops.dp import nw_fill_gab_plain, sw_fill_gab_plain

    sc, alpha = ((ScoringConfig(1, -2, -4, -1), "acgtACGT")
                 if mode == "default" else _mode_config(mode, table))
    if mode == "default" and table:
        sc, alpha = scoring_system_BLOSUM62(), PROTEIN
    LA, LB = GAB_PAIRS[pair]
    assert (LB > kernels.TILE_LANES) == (pair == "wide")
    rng = np.random.default_rng(LA + 2 * table + len(mode))
    A, Bs = _text(rng, alpha, 1, LA, LA), _text(rng, alpha, 1, LB, LB)
    ac, bc, na, nb, bp = pack_batch(sc, kernel_params(sc, dev), A, Bs, LA, LB)
    t = [torch.from_numpy(v).to(dev) for v in (ac, bc, na, nb)]
    v = _valid(dev, t[2], t[3], LA, LB)
    before = kernel_launch_counts()
    d, c, g = kernels.nw_fill_gab(*t, bp)
    dp_, cp, gp = nw_fill_gab_plain(*t, bp)
    assert torch.equal(d[v], dp_[v]) and torch.equal(c, cp)
    assert all(torch.equal(g[k][v], gp[k][v]) for k in range(3))
    d, g = kernels.sw_fill_gab(*t, bp)
    dp_, gp = sw_fill_gab_plain(*t, bp)
    assert torch.equal(d[v], dp_[v])
    assert all(torch.equal(g[k][v], gp[k][v]) for k in range(3))
    after = kernel_launch_counts()
    assert after["nw_fill_gab"] == before["nw_fill_gab"] + 1
    assert after["sw_fill_gab"] == before["sw_fill_gab"] + 1


def test_matrix_dump_on_cuda_matches_host(dev, monkeypatch):
    """``align_with_matrices`` on the card (the GAB fills) equals the int64
    host route: alignment, hit stream and all three matrices."""
    monkeypatch.setenv("SEQALIGN_FORCE", "device")
    rng = np.random.default_rng(41)
    a, b = _seqs(rng, 1, 300, 300)[0], _seqs(rng, 1, 200, 200)[0]
    nw = NeedlemanWunsch(device="cuda")
    aln, mats = nw.align_with_matrices(a, b)
    want, wmats = host_dp.nw_align_with_matrices(nw.scoring, a, b)
    assert dataclasses.astuple(aln) == dataclasses.astuple(want)
    for m, w in zip(mats, wmats):
        assert np.array_equal(m, w)
    sw = SmithWaterman(device="cuda")
    hits, mats = sw.align_with_matrices(a, b)
    wmats = host_dp.fill_matrices(sw.scoring, a, b, True)
    for m, w in zip(mats, wmats):
        assert np.array_equal(m, w)
    got = [dataclasses.astuple(h) for _, h in zip(range(40), hits)]
    assert got == [dataclasses.astuple(h) for _, h in zip(
        range(40), host_dp.HostSwHits(sw.scoring, a, b))]


@pytest.mark.parametrize("shape", [(64, 300), (37, 300), (37, 0)],
                         ids=["R64-S300", "R37-S300", "R37-S0"])
@pytest.mark.parametrize("lanes", [512, 32, 64, 1000, 1024, 2048])
@pytest.mark.parametrize("dtype", [torch.int32, torch.int16],
                         ids=["int32", "int16"])
def test_vpu_chain_equals_plain_version(dev, dtype, lanes, shape):
    """The ALU probe, every op, against its plain version: int16 sums wrap
    as int16 (the DPX add-max included).  The moves take the layout of
    ``kernels.vpu_layout``: a warp a row of K words a thread past 32 words
    (int32 at 512 lanes K = 16, at 1,000 K = 32 not K-aligned, at 1,024 K
    = 32; int16 at 512 lanes K = 8, at 1,000 K = 16 not K-aligned, at
    1,024 K = 16, at 2,048 K = 32); a sub-warp group of 4-word threads up
    to 32 words (int32 at 32 lanes 8 threads, 4 rows a warp; at 64 lanes a
    warp of K = 2; int16 at 32 lanes 4 threads, 8 rows a warp, at 64 lanes
    8 threads).  addmax and add take two lanes a thread over the whole
    block (2 int32 words, 1 int16 word).
    R = 37 leaves dead rows in a sub-warp layout's last warp; S = 0 returns
    x.  int32 at 2,048 lanes is past a row's 1,024 words: the wrapper
    raises."""
    R, S = shape
    rng = np.random.default_rng(lanes + R + S)
    x = torch.from_numpy(rng.integers(-3000, 8000, (R, lanes))).to(
        dtype).to(dev)
    if dtype == torch.int32 and lanes == 2048:
        with pytest.raises(ValueError):
            kernels.vpu_chain(x, S, "roll")
        return
    for op in kernels.VPU_OPS:
        assert torch.equal(kernels.vpu_chain(x, S, op),
                           kernels.vpu_chain_plain(x, S, op)), op
    with pytest.raises(ValueError):
        kernels.vpu_chain(x[:, :-1] if dtype == torch.int16 else
                          torch.zeros((2, 1025), dtype=dtype, device=dev),
                          4, "add")


def _sched_fills(fill, t, bp, planes=False):
    """``fill`` over the batch ``t`` under a schedule (its planes with
    ``planes``)."""
    na, nb = (v.cpu().numpy() for v in t[2:4])
    return fill(*t, bp, kernels.fill_schedule(na, nb, t[0].device, planes))


@pytest.mark.parametrize("case", ["default", "nsg_neg", "table"])
def test_ragged_fill_equals_bucket_kernels_and_plain(dev, case):
    """One fill launch across widths (ragged code planes, blocks largest
    first, on the register tiles under every flag; a pair of 6,600 lanes
    takes round rows of scratch) against the uniform launch of each width
    bucket, kernel against kernel; against the plain ragged fill; and
    nw_walk over the planes against the walk over the bucket planes.  The
    scores fills under the same schedule equal their uniform launches."""
    from seqalign_tpu_torch.ops.pack import pad_width

    if case == "table":
        sc, alpha = scoring_system_BLOSUM62(), PROTEIN
    else:
        flags = case != "default"
        sc = ScoringConfig(1, -2, -4, -1, no_start_gap_penalty=flags,
                           no_end_gap_penalty=flags)
        alpha = "acgtACGT"
    rng = np.random.default_rng(len(case))
    A, Bs = _text(rng, alpha, 23, 1, 2000), _text(rng, alpha, 23, 1, 1500)
    A[2], Bs[5] = "", ""
    A.append(_text(rng, alpha, 1, 3000, 3000)[0])
    Bs.append(_text(rng, alpha, 1, 6600, 6600)[0])
    p = kernel_params(sc, dev)
    la, lb = max(map(len, A)), max(map(len, Bs))
    ac, bc, na, nb, bp = pack_batch(sc, p, A, Bs, la, lb)
    t = [torch.from_numpy(v).to(dev) for v in (ac, bc, na, nb)]
    cap = int((na + nb).max())
    before = kernel_launch_counts()
    flat, corner = _sched_fills(kernels.nw_fill_dirs, t, bp, True)
    s_nw, c_nw = kernels.nw_scores(*t, bp)
    s_sw = kernels.sw_scores(*t, bp)
    s, c = _sched_fills(kernels.nw_scores, t, bp)
    assert torch.equal(s, s_nw) and torch.equal(c, c_nw)
    assert torch.equal(_sched_fills(kernels.sw_scores, t, bp), s_sw)
    off = kernels.fill_schedule(na, nb, dev, planes=True).off
    walk = kernels.nw_walk(flat, corner, t[2], t[3], cap, off)
    after = kernel_launch_counts()
    assert after["nw_fill_dirs[ragged]"] == \
        before["nw_fill_dirs[ragged]"] + 1
    assert after["nw_walk"] == before["nw_walk"] + 1
    offs = off.tolist()
    buckets = {}
    for j, (a, b) in enumerate(zip(A, Bs)):
        buckets.setdefault((pad_width(max(1, len(a))),
                            pad_width(max(1, len(b)))), []).append(j)
    for (wa, wb), idx in buckets.items():
        g = pack_batch(sc, p, [A[j] for j in idx], [Bs[j] for j in idx], wa,
                       wb)
        tb = [torch.from_numpy(v).to(dev) for v in g[:4]]
        d, c = kernels.nw_fill_dirs(*tb, g[4])
        ops, score = kernels.nw_walk(d, c, tb[2], tb[3], cap)
        for i, j in enumerate(idx):
            lanes = max(int(nb[j]), 1) + 1
            plane = flat[offs[j]:offs[j + 1]].view(-1, lanes)
            assert torch.equal(corner[j], c[i])
            v = _valid(dev, tb[2][i:i + 1], tb[3][i:i + 1], wa,
                       wb)[0][:, :lanes]
            rows = plane.shape[0]
            assert torch.equal(plane[v[:rows]], d[i, :rows, :lanes][
                v[:rows]])
            assert torch.equal(walk[0][j], ops[i])
            assert walk[1][j] == score[i]
    # the plain ragged fill, on 8 pairs of up to 300 bp
    As, Bss = _text(rng, alpha, 8, 0, 300), _text(rng, alpha, 8, 0, 300)
    As[1] = ""
    g = pack_batch(sc, p, As, Bss, 300, 300)
    ts = [torch.from_numpy(v).to(dev) for v in g[:4]]
    flat, corner = _sched_fills(kernels.nw_fill_dirs, ts, g[4], True)
    offs = kernels.fill_schedule(g[2], g[3], dev, planes=True).off
    fp, cp = nw_fill_dirs_plain(*ts, g[4], offs)
    assert torch.equal(corner, cp)
    v = torch.zeros_like(fp, dtype=torch.bool)
    for i in range(len(As)):
        lanes = max(int(g[3][i]), 1) + 1
        rows = (int(offs[i + 1]) - int(offs[i])) // lanes
        y = torch.arange(lanes, device=dev)[None, :]
        x = torch.arange(rows, device=dev)[:, None] + 2 - y
        v[offs[i]:offs[i + 1]] = ((y >= 1) & (y <= int(g[3][i])) & (x >= 1)
                                  & (x <= int(g[2][i]))).reshape(-1)
    assert torch.equal(flat[v], fp[v])
    capp = int((g[2] + g[3]).max())
    assert all(torch.equal(a, b) for a, b in zip(
        kernels.nw_walk(flat, corner, ts[2], ts[3], capp, offs),
        nw_walk_plain(fp, cp, ts[2], ts[3], capp, offs)))


def test_aligners_across_widths_on_cuda_match_host(dev, monkeypatch):
    """NW align_batch and score_batch and SW best_score_batch on a batch
    of mixed widths: one fill launch each, equal to the int64 host path."""
    monkeypatch.setenv("SEQALIGN_FORCE", "device")
    rng = np.random.default_rng(43)
    A, B = _seqs(rng, 40, 1, 1500), _seqs(rng, 40, 1, 1500)
    nw, sw = NeedlemanWunsch(device=dev), SmithWaterman(device=dev)
    before = kernel_launch_counts()
    alns = nw.align_batch(A, B)
    scores = nw.score_batch(A, B)
    best = sw.best_score_batch(A, B)
    after = kernel_launch_counts()
    assert {k: after[k] - before[k] for k in
            ("nw_fill_dirs[ragged]", "nw_walk", "nw_scores[ragged]",
             "sw_scores[ragged]")} == {
        "nw_fill_dirs[ragged]": 1, "nw_walk": 1, "nw_scores[ragged]": 1,
        "sw_scores[ragged]": 1}
    for a, b, got, s, bs in zip(A, B, alns, scores, best):
        want = host_dp.nw_align(nw.scoring, a, b)
        assert dataclasses.astuple(got) == dataclasses.astuple(want)
        assert s == want.score
        M = host_dp.fill_matrices(sw.scoring, a, b, True)[0]
        assert bs == M.max(initial=0)


def _hits_and_int64(args):
    """``sw_hits`` on ``args`` against its plain version, and the int64
    instantiation on the same candidates against the int32 one."""
    got = kernels.sw_hits(*args)
    want = sw_hits_plain(*args)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    a64 = (*args[:5], args[5].long(), *args[6:])
    got64 = kernels.sw_hits(*a64)
    assert got64[0].dtype == torch.int64
    assert torch.equal(got64[0], got[0].long())
    assert all(torch.equal(g, w) for g, w in zip(got64[1:], got[1:]))
    return got


@pytest.mark.parametrize("mask", ["shared", "global"])
def test_sw_hits_window_cases_equal_plain(dev, monkeypatch, mask):
    """The warp pre-walk of sw_hits against the serial plain loop, with
    the mask in shared or (no shared memory allowed) global memory, int32
    and int64 flats: real hint-less fills under four scorings (k from 1
    to past every candidate), fills with DIR_FAIL codes planted, the
    window cascade with and without DIR_FAIL MATCH codes on its diagonal,
    and a DIR_FAIL past the k-th hit."""
    from test_torch_hits_window import (cascade_case, dir_fail_past_k_case,
                                        fail_cascade, fill_cases, hit_args,
                                        plant_dir_fails, with_k)

    cases = [args for _, args in fill_cases(dev)]
    cases += [plant_dir_fails(cases[0], s, 6) for s in range(4)]
    sc, A, B = cascade_case()
    cascade = hit_args(sc, A, B, dev)
    cases += [cascade, fail_cascade(cascade), dir_fail_past_k_case(dev)]
    if mask == "global":
        monkeypatch.setattr(kernels, "SMEM_MAX", 0)
    before = kernel_launch_counts()["sw_hits"]
    fails = []
    for args in cases:
        for k in (1, 2, 16, 10_000):
            fails.append(_hits_and_int64(with_k(args, k))[2].min() < 0)
    assert kernel_launch_counts()["sw_hits"] == before + 2 * len(fails)
    assert any(fails) and not all(fails)
    past = dir_fail_past_k_case(dev)
    assert kernels.sw_hits(*with_k(past, 2))[2].tolist() == [2]
    assert kernels.sw_hits(*with_k(past, 10_000))[2].tolist() == [-1]
    one = kernels.sw_hits(*with_k(fail_cascade(cascade), 10_000))
    assert one[2][0] == 1


def test_sw_hits_on_slabs_int64_and_deep(dev):
    """sw_hits over chunk slabs (the long path's codes), hint-less and
    deep, int32 and int64 flats, against its plain version and against
    the same candidates over the unchunked plane."""
    sc = scoring_system_sw_default()
    rng = np.random.default_rng(47)
    B, la, lb, ca = 3, 500, 260, 96
    A, Bs = _seqs(rng, B, 300, la), _seqs(rng, B, 100, lb)
    ac, bc, na, nb, bp = pack_batch(sc, kernel_params(sc, dev), A, Bs, la,
                                    lb)
    t = [torch.from_numpy(v).to(dev) for v in (ac, bc, na, nb)]
    nch = -(-la // ca)
    slabs, _, ms, _ = _carry_run(kernels.sw_fill_dirs_carry, (*t, bp), nch,
                                 ca, lb, B, dev, True, True)
    parts = [sw_sorted_candidates(m, na, nb, 1, x_off=c * ca)
             for c, m in enumerate(ms)]
    flat, score, off = merge_candidates(parts, B)
    d, _ = kernels.sw_fill_dirs(*t, bp, True)
    for k in (16, 10_000):
        args = (slabs, *t, flat, score, off[:-1], off[1:], bp, k)
        got = _hits_and_int64(args)
        plane = kernels.sw_hits(d, *args[1:])
        assert all(torch.equal(g, w) for g, w in zip(got, plane))


def _plane_valid(off, na, nb, dev):
    """The valid cells of the 1-d planes of a launch across widths."""
    offs = off.tolist()
    v = torch.zeros(offs[-1], dtype=torch.bool, device=dev)
    for j, (n_a, n_b) in enumerate(zip(na.tolist(), nb.tolist())):
        lanes = max(n_b, 1) + 1
        rows = (offs[j + 1] - offs[j]) // lanes
        y = torch.arange(lanes, device=dev)[None, :]
        x = torch.arange(rows, device=dev)[:, None] + 2 - y
        v[offs[j]:offs[j + 1]] = ((y >= 1) & (y <= n_b) & (x >= 1)
                                  & (x <= n_a)).reshape(-1)
    return v


@pytest.mark.parametrize("m16", [True, False], ids=["int16", "int32"])
@pytest.mark.parametrize("case", ["default", "lcs", "nsg_neg", "table"])
def test_ragged_sw_fill_equals_bucket_kernels_and_plain(dev, case, m16):
    """The SW codes-and-M fill as one launch across widths (the SCHED
    instantiations with MBYTES 2 and 4, with and without MODES and TABLE)
    against the uniform launch of each width bucket, kernel against
    kernel, codes and M on every pair's valid cells (a pair of 6,600
    lanes takes scratch), and against the plain ragged fill on 8 pairs of
    up to 300 bp with an empty side, M's cells off the valid ones at 0
    there; the best scores equal sw_scores'."""
    from seqalign_tpu_torch.ops.pack import pad_width

    if case == "table":
        sc, alpha = scoring_system_BLOSUM62(), PROTEIN
    elif case == "lcs":
        sc, alpha = lcs_aligner(device=dev).scoring, "acgtACGT"
    else:
        sc = ScoringConfig(2, -2, -2, -1, no_start_gap_penalty=True,
                           no_end_gap_penalty=case == "nsg_neg")
        alpha = "acgtACGT"
    rng = np.random.default_rng(len(case) + m16)
    A, Bs = _text(rng, alpha, 23, 1, 2000), _text(rng, alpha, 23, 1, 1500)
    A[2], Bs[5] = "", ""
    A.append(_text(rng, alpha, 1, 3000, 3000)[0])
    Bs.append(_text(rng, alpha, 1, 6600, 6600)[0])
    p = kernel_params(sc, dev)
    ac, bc, na, nb, bp = pack_batch(sc, p, A, Bs, max(map(len, A)),
                                    max(map(len, Bs)))
    t = [torch.from_numpy(v).to(dev) for v in (ac, bc, na, nb)]
    sched = kernels.fill_schedule(na, nb, dev, planes=True)
    before = kernel_launch_counts()
    flat, mflat = kernels.sw_fill_dirs(*t, bp, m16, sched)
    after = kernel_launch_counts()
    assert {k: after[k] - before[k] for k in after if after[k] != before[k]
            } == {"sw_fill_dirs[ragged]": 1}
    assert flat.shape == mflat.shape == (sched.total,)
    assert mflat.dtype == (torch.int16 if m16 else torch.int32)
    offs = sched.off.tolist()
    buckets = {}
    for j, (a, b) in enumerate(zip(A, Bs)):
        buckets.setdefault((pad_width(max(1, len(a))),
                            pad_width(max(1, len(b)))), []).append(j)
    for (wa, wb), idx in buckets.items():
        g = pack_batch(sc, p, [A[j] for j in idx], [Bs[j] for j in idx], wa,
                       wb)
        tb = [torch.from_numpy(v).to(dev) for v in g[:4]]
        d, m = kernels.sw_fill_dirs(*tb, g[4], m16)
        for i, j in enumerate(idx):
            lanes = max(int(nb[j]), 1) + 1
            v = _valid(dev, tb[2][i:i + 1], tb[3][i:i + 1], wa,
                       wb)[0][:, :lanes]
            for got, want in ((flat, d), (mflat, m)):
                plane = got[offs[j]:offs[j + 1]].view(-1, lanes)
                rows = plane.shape[0]
                assert torch.equal(plane[v[:rows]],
                                   want[i, :rows, :lanes][v[:rows]])
    # the plain ragged fill, on 8 pairs of up to 300 bp
    As, Bss = _text(rng, alpha, 8, 0, 300), _text(rng, alpha, 8, 0, 300)
    As[1], Bss[4] = "", ""
    g = pack_batch(sc, p, As, Bss, 300, 300)
    ts = [torch.from_numpy(v).to(dev) for v in g[:4]]
    small = kernels.fill_schedule(g[2], g[3], dev, planes=True)
    fk, mk = kernels.sw_fill_dirs(*ts, g[4], m16, small)
    fp, mp = sw_fill_dirs_plain(*ts, g[4], m16, small.off)
    v = _plane_valid(small.off, g[2], g[3], dev)
    assert torch.equal(fk[v], fp[v]) and torch.equal(mk[v], mp[v])
    # M's every other cell holds 0, as the harvest needs
    assert torch.equal(mk, mp) and not mk[~v].any()


def _ragged_hits_case(dev, seed):
    """A launch across widths of SW pairs whose hit masks fit shared memory
    (up to 600 bp) and of two that do not (2,000 x 1,000 bp): the fill,
    and its candidates hint-less and within 15 of each pair's best."""
    sc = scoring_system_sw_default()
    rng = np.random.default_rng(seed)
    A, Bs = _seqs(rng, 14, 0, 600), _seqs(rng, 14, 0, 600)
    A[3] = ""
    A += _seqs(rng, 2, 2000, 2000)
    Bs += _seqs(rng, 2, 1000, 1000)
    p = kernel_params(sc, dev)
    ac, bc, na, nb, bp = pack_batch(sc, p, A, Bs, max(map(len, A)),
                                    max(map(len, Bs)))
    t = [torch.from_numpy(v).to(dev) for v in (ac, bc, na, nb)]
    sched = kernels.fill_schedule(na, nb, dev, planes=True)
    d, m = kernels.sw_fill_dirs(*t, bp, True, sched)
    best = kernels.sw_scores(*t, bp).cpu().numpy()
    cands = [sw_sorted_candidates(m, na, nb, thr, off=sched.off)
             for thr in (1, np.maximum(best.astype(np.int64) - 15, 1))]
    return d, t, bp, sched.off, cands


@pytest.mark.parametrize("mask", ["mixed", "global"])
def test_sw_hits_and_walk_on_ragged_planes_equal_plain(dev, monkeypatch,
                                                       mask):
    """sw_hits over the planes of one launch across widths against its
    plain version, each pair's mask in shared memory when it fits the
    launch's, else in the global buffer ("global": no shared memory), int32
    and int64 flats, hint-less (k = 16) and near the best (k past every
    candidate); sw_walk over the planes against its plain version on the
    hits found."""
    d, t, bp, off, cands = _ragged_hits_case(dev, 5)
    if mask == "global":
        monkeypatch.setattr(kernels, "SMEM_MAX", 0)
    else:
        block, moff = kernels.hits_masks(t[2], t[3], kernels.SMEM_MAX)
        assert block > 0 and 0 < int(moff[-1])
    before = kernel_launch_counts()
    for (flat, score, o), k in zip(cands, (16, 10_000)):
        args = (d, *t, flat, score, o[:-1], o[1:], bp, k, off)
        got = _hits_and_int64(args)
        assert (got[2] > 0).sum() >= 14
    hit_flat, hit_score, nhits = got
    keep = np.arange(hit_flat.shape[1])[None, :] < nhits.cpu().numpy()[:,
                                                                      None]
    jw, slot = np.nonzero(keep)
    flats = hit_flat.cpu().numpy()[jw, slot].astype(np.int64)
    w = t[2].cpu().numpy()[jw].astype(np.int64) + 1
    starts = [torch.from_numpy(v.astype(np.int32)).to(dev) for v in
              (jw, flats % w, flats // w, hit_score.cpu().numpy()[jw, slot])]
    cap = int((t[2] + t[3]).max())
    ops = kernels.sw_walk(d, *t, *starts, bp, cap, off)
    assert torch.equal(ops, sw_walk_plain(d, *t, *starts, bp, cap, off))
    after = kernel_launch_counts()
    assert {k: after[k] - before[k] for k in after if after[k] != before[k]
            } == {"sw_hits[ragged]": 4, "sw_walk": 1}


def test_sw_align_batch_across_widths_on_cuda_matches_host(dev,
                                                           monkeypatch):
    """SW align_batch and the LCS recipe on batches of mixed widths: one
    sw_fill_dirs, one sw_hits and one sw_walk launch a budget sub-batch
    (three or four sub-batches under a budget cut to a third), the streams
    equal to the int64 host path's, past the first round of 16 hits."""
    monkeypatch.setenv("SEQALIGN_FORCE", "device")
    rng = np.random.default_rng(53)
    A, B = _seqs(rng, 40, 1, 1500), _seqs(rng, 40, 1, 1500)
    sw = SmithWaterman(device=dev)
    want = [[dataclasses.astuple(h) for _, h in
             zip(range(24), host_dp.HostSwHits(sw.scoring, a, b))]
            for a, b in zip(A, B)]
    held = [aligners._sw_pair_bytes(len(a), len(b), 2, True)
            for a, b in zip(A, B)]
    cut = sum(held) // 3 + 1
    for budget, fills in ((None, 1), (cut, len(aligners._plane_subbatches(
            range(40), cut, held.__getitem__)))):
        if budget is not None:
            monkeypatch.setattr(aligners, "_align_budget",
                                lambda device: budget)
        before = kernel_launch_counts()
        its = sw.align_batch(A, B)
        after = kernel_launch_counts()
        assert {k: after[k] - before[k] for k in
                ("sw_fill_dirs[ragged]", "sw_hits[ragged]", "sw_walk")} == {
            "sw_fill_dirs[ragged]": fills, "sw_hits[ragged]": fills,
            "sw_walk": fills}
        got = [[dataclasses.astuple(h) for _, h in zip(range(24), it)]
               for it in its]
        assert got == want
    lcs = lcs_aligner(device=dev)
    seqs = _seqs(rng, 12, 0, 800)
    before = kernel_launch_counts()["sw_fill_dirs[ragged]"]
    its = lcs.align_batch(seqs, seqs)
    assert kernel_launch_counts()["sw_fill_dirs[ragged]"] == before + 1
    for s, it in zip(seqs, its):
        assert [dataclasses.astuple(h) for _, h in zip(range(12), it)] == \
            [dataclasses.astuple(h) for _, h in zip(
                range(12), host_dp.HostSwHits(lcs.scoring, s, s))]



def _tile_batch(alpha, R, seed, wide=False):
    """Pairs at the strip edges of R lanes a thread (csrc/tile_fill.cuh):
    b one lane short of a strip, a strip, one over, two strips and a bit
    (its a side long enough for unchecked step blocks), empty sides; with
    ``wide``, b sides of 6,000 to 10,240 lanes, past one round (at 1,040
    lanes of a, a strip's ndur is 1 mod 4 at R = 4: the columns of a
    warp's next strip meet, in its ring, the ones the next warp still
    reads, unless the schedule waits for it)."""
    S = 32 * R
    rng = np.random.default_rng(seed)
    lens = ([(1040, 6144), (300, 10240), (0, 6000)] if wide else
            [(37, 31), (300, S - 1), (41, S), (S + 3 * R, S + 1),
             (S + 2 * R + 7, 2 * S + 3), (0, 9), (12, 0), (0, 0), (1, 1)])
    letters = np.array(list(alpha))
    A = ["".join(letters[rng.integers(0, len(letters), n)]) for n, _ in lens]
    B = ["".join(letters[rng.integers(0, len(letters), m)]) for _, m in lens]
    return A, B


NSG_NEG = dict(no_start_gap_penalty=True, no_end_gap_penalty=True)
NGA_NGB_NMM = dict(no_gaps_in_a=True, no_gaps_in_b=True, no_mismatches=True)
ALL_FLAGS = dict(NSG_NEG, **NGA_NGB_NMM)


def _flagged(flags, sw=False, table=False):
    """NW 1/-2/-4/-1, SW 2/-2/-2/-1 or BLOSUM62 under the scoring flags."""
    if table:
        sc = scoring_system_BLOSUM62()
        for k, v in flags.items():
            setattr(sc, k, v)
        sc._luts = None
        return sc
    return ScoringConfig(*((2, -2, -2, -1) if sw else (1, -2, -4, -1)),
                         **flags)


def _makers(flags, table=False):
    """(NW config maker, SW config maker) under ``flags``."""
    return (lambda: _flagged(flags, False, table),
            lambda: _flagged(flags, True, table))


# name -> (NW config maker, SW config maker, alphabet): the default flags,
# and the flags' instantiations (MODES) of the same tiles
TILE_CASES = {"equality": (scoring_system_default, scoring_system_sw_default,
                           "acgtACGT"),
              "blosum62": (scoring_system_BLOSUM62, scoring_system_BLOSUM62,
                           PROTEIN),
              "nsg_neg": (*_makers(NSG_NEG), "acgtACGT"),
              "nga_ngb_nmm": (*_makers(NGA_NGB_NMM), "acgtACGT"),
              "all_flags": (*_makers(ALL_FLAGS), "acgtACGT"),
              "blosum62_all_flags": (*_makers(ALL_FLAGS, True), PROTEIN)}
_TILE_PLAIN: dict = {}  # the plain fills of the wide batches


@pytest.mark.parametrize("wide", [False, True], ids=["edges", "rounds"])
@pytest.mark.parametrize("case", list(TILE_CASES))
def test_tile_fills_equal_plain_versions(dev, case, wide):
    """The fills on the register tiles (nw_scores, nw_fill_dirs,
    sw_scores, sw_fill_dirs with int16 and int32 M) at the default flags
    and under flags (nsg+neg, nga+ngb+nmm, all five; under BLOSUM62 with
    its is-match table), uniform and under a schedule with planes, against
    their plain versions: pairs
    at the strip edges of R = kernels.TILE_R lanes a thread (b of 31 and
    32R-1, 32R, 32R+1 and 2*32R+3 lanes), empty sides, and b sides of 6,000
    to 10,240 lanes whose strips take several rounds.  Codes and M on the
    valid cells (the ragged M whole), scores and corners exactly; the
    launch counters show each entry ran under its name."""
    R = kernels.TILE_R
    make_nw, make_sw, alpha = TILE_CASES[case]
    for sw in (False, True):
        sc = (make_sw if sw else make_nw)()
        A, B = _tile_batch(alpha, R, len(case) + sw, wide)
        p = kernel_params(sc, dev)
        la, lb = max(map(len, A)), max(map(len, B))
        ac, bc, na, nb, bp = pack_batch(sc, p, A, B, la, lb)
        t = [torch.from_numpy(v).to(dev) for v in (ac, bc, na, nb)]
        sched = kernels.fill_schedule(na, nb, dev, planes=True)
        v = _valid(dev, t[2], t[3], la, lb)
        pv = _plane_valid(sched.off, t[2], t[3], dev)
        key = (case, sw) if wide else None  # the edge batches are cheap
        if key not in _TILE_PLAIN or key is None:
            if not sw:
                _TILE_PLAIN[key] = (nw_scores_plain(*t, bp),
                                    nw_fill_dirs_plain(*t, bp),
                                    nw_fill_dirs_plain(*t, bp, sched.off))
            else:
                _TILE_PLAIN[key] = (sw_scores_plain(*t, bp), {
                    m16: (sw_fill_dirs_plain(*t, bp, m16),
                          sw_fill_dirs_plain(*t, bp, m16, sched.off))
                    for m16 in (True, False)})
        plain = _TILE_PLAIN[key]
        before = kernel_launch_counts()
        if not sw:
            (sp, cp), (dp_, dcp), (fp, fcp) = plain
            for s in (None, sched):
                got = kernels.nw_scores(*t, bp, s)
                assert torch.equal(got[0], sp) and torch.equal(got[1], cp)
            d, dc = kernels.nw_fill_dirs(*t, bp)
            assert torch.equal(d[v], dp_[v]) and torch.equal(dc, dcp)
            f, fc = kernels.nw_fill_dirs(*t, bp, sched)
            assert torch.equal(f[pv], fp[pv]) and torch.equal(fc, fcp)
            names = ("nw_scores", "nw_fill_dirs")
        else:
            best, fills = plain
            for s in (None, sched):
                assert torch.equal(kernels.sw_scores(*t, bp, s), best)
            for m16, ((dp_, mp), (fp, fmp)) in fills.items():
                d, m = kernels.sw_fill_dirs(*t, bp, m16)
                assert torch.equal(d[v], dp_[v]) and torch.equal(m[v], mp[v])
                f, fm = kernels.sw_fill_dirs(*t, bp, m16, sched)
                assert torch.equal(f[pv], fp[pv]) and torch.equal(fm, fmp)
            names = ("sw_scores", "sw_fill_dirs")
        after = kernel_launch_counts()
        for k in names:
            want = 2 if k == "sw_fill_dirs" else 1
            assert after[k] - before[k] == want
            assert after[f"{k}[ragged]"] - before[f"{k}[ragged]"] == want
        del plain, v, pv


# The carry on the register tiles (csrc/tile_carry.cuh), a round of a
# pair's lanes a block: name -> (scoring, pairs, (CA, LA, LB), warps a
# block or None for kernels.carry_warps).  Chunks narrower and wider than
# the lanes; b of 3 and more rounds at 4 warps; 10,240 lanes; 16 warps;
# one warp; BLOSUM62 with an empty seq_a and an empty seq_b (the corners
# of empty sides); 300 pairs at 2 warps, 1,800 blocks, more than the card
# holds at once, so that rounds wait on producers that took their tickets
# earlier; and the flags (MODES): nsg+neg, nga+ngb+nmm and all five
# (BLOSUM62 too, its is-match table beside the table), with a pair that
# ends on the first column of chunk 1.
TILE_CARRY_CASES = {
    "narrow_chunk": ("equality", 4, (64, 700, 1500), None),
    "wide_chunk": ("equality", 4, (2048, 3000, 600), None),
    "lanes_10240": ("equality", 4, (1024, 2600, 10240), None),
    "warps_16": ("equality", 4, (512, 1400, 6600), 16),
    "warps_1": ("equality", 3, (256, 700, 900), 1),
    "blosum62_empty": ("blosum62", 4, (256, 700, 1200), None),
    "past_residency": ("equality", 300, (256, 520, 1500), 2),
    "nsg_neg": ("nsg_neg", 5, (256, 700, 1500), None),
    # the flags' carry at long job 2's launch shape: 16 warps of 2 lanes
    # a thread, b of 6,600 lanes in 4 rounds
    "nsg_neg_warps_16": ("nsg_neg", 5, (512, 1400, 6600), 16),
    "nga_ngb_nmm_wide_chunk": ("nga_ngb_nmm", 5, (2048, 3000, 600), None),
    "all_flags": ("all_flags", 5, (512, 1400, 2600), None),
    "blosum62_all_flags_empty": ("blosum62_all_flags", 5, (256, 700, 1200),
                                 None),
}
CARRY_FLAGS = {"nsg_neg": NSG_NEG, "nga_ngb_nmm": NGA_NGB_NMM,
               "all_flags": ALL_FLAGS, "blosum62_all_flags": ALL_FLAGS}


@pytest.mark.parametrize("fill", ["nw", "sw_m16", "sw_m32"])
@pytest.mark.parametrize("case", list(TILE_CARRY_CASES))
def test_tile_carry_equals_plain_versions(dev, monkeypatch, case, fill):
    """The carry kernels (csrc/tile_carry.cuh) against their plain
    versions chunk by chunk at TILE_CARRY_CASES' shapes: codes of every
    slab and SW M on the valid cells, bout on the lanes 1 .. nb of the
    pairs that reach it, the NW corner or the SW best; one pair ends on
    the last column of chunk 1, one in the middle of a chunk (under flags
    a fifth on the first column of chunk 1), and the launch counters
    count one launch a chunk under the carry's name."""
    sw, m16 = fill != "nw", fill == "sw_m16"
    scoring, B, (ca, la, lb), warps = TILE_CARRY_CASES[case]
    if warps is not None:
        monkeypatch.setattr(kernels, "carry_warps", lambda *a: warps)
    table = scoring.startswith("blosum62")
    if scoring in CARRY_FLAGS:
        sc = _flagged(CARRY_FLAGS[scoring], sw, table)
    elif table:
        sc = scoring_system_BLOSUM62()
    else:
        sc = scoring_system_sw_default() if sw else scoring_system_default()
    alpha = PROTEIN if table else "acgtACGT"
    rng = np.random.default_rng(len(case) + 7 * sw + ca)
    A, Bs = _text(rng, alpha, B, la // 2, la), _text(rng, alpha, B,
                                                     lb // 2, lb)
    A[0] = A[0][:2 * ca]  # ends on the last column of chunk 1
    A[1] = A[1][:ca + ca // 2]  # ends inside chunk 1
    if table:
        A[2], Bs[3] = "", ""
    if scoring in CARRY_FLAGS:  # ends on the first column of chunk 1
        A[4] = _text(rng, alpha, 1, ca + 1, ca + 1)[0]
    ac, bc, na, nb, bp = pack_batch(sc, kernel_params(sc, dev), A, Bs, la,
                                    lb)
    assert (bp.modes != 0) == (scoring in CARRY_FLAGS)
    assert (bp.sub is not None) == table
    t = [torch.from_numpy(v).to(dev) for v in (ac, bc, na, nb)]
    nch = -(-la // ca)
    m16 = m16 and m16_safe(sc, la, lb)
    kfill = kernels.sw_fill_dirs_carry if sw else kernels.nw_fill_dirs_carry
    pfill = sw_fill_dirs_carry_plain if sw else nw_fill_dirs_carry_plain
    name = "sw_fill_dirs_carry" if sw else "nw_fill_dirs_carry"
    before = kernel_launch_counts()[name]
    got = _carry_run(kfill, (*t, bp), nch, ca, lb, B, dev, sw, m16)
    torch.cuda.synchronize()
    assert kernel_launch_counts()[name] == before + nch
    want = _carry_run(pfill, (*t, bp), nch, ca, lb, B, dev, sw, m16)
    na_t, nb_t = t[2], t[3]
    y = torch.arange(lb + 1, device=dev)[None, None, :]
    lanes = (y >= 1) & (y <= nb_t[:, None, None])
    for c in range(nch):
        v = _slab_valid(dev, ca + lb - 1, lb, c, ca, na_t, nb_t)
        assert torch.equal(got[0][:, c][v], want[0][:, c][v]), c
        if sw:
            assert torch.equal(got[2][c][v], want[2][c][v]), c
        keep = ((na_t >= (c + 1) * ca)[:, None, None] & lanes).expand(
            -1, 3, -1)
        assert torch.equal(got[1][c][keep], want[1][c][keep]), c
    assert torch.equal(got[3], want[3])


# The walks as a warp a walk over bands of codes staged in shared memory
# (csrc/walk_band.cuh), at real sizes: the cases of the CPU band model
# (tests/test_torch_walk_band.py) and a walk of over 10,000 steps.
WALK_BAND_CASES = ("ragged_nw", "ragged_sw", "slabs_nw", "slabs_sw",
                   "gap_a_run", "gap_b_run", "cap_nw", "clamps_cap_sw",
                   "neg", "lcs", "blosum62", "wide_table")
WALK_BAND_K = 64  # csrc/walk_band.cuh, K


def _mutated(rng, A, alpha):
    """Each of ``A`` with 10% of its letters changed and 1-3 indels of 1-3
    letters, so that its best local alignments run long."""
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


def _odd_view(t, shift=5):
    """``t``'s bytes in a tensor of their own that starts at an odd byte
    of its allocation."""
    buf = torch.empty(t.numel() + shift, dtype=t.dtype, device=t.device)
    buf[shift:] = t.reshape(-1)
    return buf[shift:].view(t.shape)


def _slabs_of(plane, ca):
    """A uniform code plane (B, LA+LB-1, LB+1) cut into the chunk slabs of
    ``ca`` columns the long-pair fill writes (B, nch, ca+LB-1, LB+1), the
    rule of csrc/slab.cuh; cells past a's width hold 0."""
    B, D, LBp = plane.shape
    LA = D - LBp + 2
    nch = -(-LA // ca)
    dev = plane.device
    r = torch.arange(ca + LBp - 2, device=dev)[:, None]
    y = torch.arange(LBp, device=dev)[None, :].expand(len(r), -1)
    slabs = torch.zeros((B, nch, len(r), LBp), dtype=plane.dtype,
                        device=dev)
    for c in range(nch):
        xl = r - y + 2
        ok = (xl >= 1) & (xl <= ca) & (c * ca + xl <= LA) & (y >= 1)
        rows = (c * ca + xl + y - 2).clamp(0, D - 1)
        slabs[:, c] = torch.where(ok, plane[:, rows, y], 0)
    return slabs


def _walk_band_case(case, dev):
    """One case's walk: ("nw" | "sw", the arguments of the wrapper)."""
    rng = np.random.default_rng(WALK_BAND_CASES.index(case) + 51)
    if case.endswith("_nw") or case.startswith("gap_"):
        sc = scoring_system_default()
        if case == "ragged_nw":  # and a pair of ~10 kb x 10 kb
            A, Bs = _seqs(rng, 12, 0, 3000), _seqs(rng, 12, 1, 3000)
            A[0], Bs[0] = _seqs(rng, 2, 9800, 10000)
            A[3] = ""
        elif case == "slabs_nw":
            A, Bs = _seqs(rng, 4, 2000, 3000), _seqs(rng, 4, 500, 1500)
        elif case == "gap_a_run":  # a short, b long: y falls a lane a row
            A, Bs = _seqs(rng, 4, 20, 60), _seqs(rng, 4, 6000, 9000)
        elif case == "gap_b_run":  # a long, b short: the lane fixed
            A, Bs = _seqs(rng, 4, 6000, 9000), _seqs(rng, 4, 20, 60)
        else:  # walks past their bound
            A, Bs = _seqs(rng, 8, 800, 1000), _seqs(rng, 8, 800, 1000)
        ac, bc, na, nb, bp = pack_batch(sc, kernel_params(sc, dev), A, Bs,
                                        max(1, max(map(len, A))),
                                        max(1, max(map(len, Bs))))
        t = [torch.from_numpy(v).to(dev) for v in (ac, bc, na, nb)]
        off = None
        if case == "ragged_nw":
            sched = kernels.fill_schedule(na, nb, dev, planes=True)
            d, corner = kernels.nw_fill_dirs(*t, bp, sched)
            d, off = _odd_view(d), sched.off
        else:
            d, corner = kernels.nw_fill_dirs(*t, bp)
        if case == "slabs_nw":
            d = _slabs_of(d, 700)
        cap = 256 if case == "cap_nw" else int((na + nb).max())
        return "nw", (d, corner, t[2], t[3], cap, off)
    alpha = {"blosum62": PROTEIN}.get(case, "acgtACGT")
    if case == "neg":
        sc = ScoringConfig(2, -2, -2, -1, no_end_gap_penalty=True)
    elif case == "lcs":
        sc = ScoringConfig(1, -1, -4, -1, no_gaps_in_a=True,
                           no_gaps_in_b=True, no_mismatches=True)
    elif case == "blosum62":
        sc = scoring_system_BLOSUM62()
    elif case == "wide_table":  # a table too large for shared memory
        sc, alpha = _wide_alphabet_config()
    else:
        sc = scoring_system_sw_default()
    A = _text(rng, alpha, 8, 1000, 3000)
    Bs = list(A) if case == "lcs" else _mutated(rng, A, alpha)
    ac, bc, na, nb, bp = pack_batch(sc, kernel_params(sc, dev), A, Bs,
                                    max(map(len, A)), max(map(len, Bs)))
    t = [torch.from_numpy(v).to(dev) for v in (ac, bc, na, nb)]
    sched = off = None
    if case == "ragged_sw":
        sched = kernels.fill_schedule(na, nb, dev, planes=True)
        off = sched.off
    d, m = kernels.sw_fill_dirs(*t, bp, False, sched)
    best = kernels.sw_scores(*t, bp).cpu().numpy().astype(np.int64)
    flat, score, o = sw_sorted_candidates(m, na, nb,
                                          np.maximum(best - 10, 1), off=off)
    del m
    hit_flat, hit_score, nhits = kernels.sw_hits(
        d, *t, flat, score, o[:-1], o[1:], bp, 8, off)
    keep = torch.arange(8, device=dev)[None, :] < nhits[:, None]
    jw, slot = keep.nonzero(as_tuple=True)
    w = t[2][jw].long() + 1
    starts = [v.to(torch.int32).contiguous()
              for v in (jw, hit_flat[jw, slot] % w, hit_flat[jw, slot] // w,
                        hit_score[jw, slot])]
    cap = int((t[2] + t[3]).max())
    if case == "ragged_sw":
        d = _odd_view(d)
    if case == "slabs_sw":
        d = _slabs_of(d, 700)
    if case == "clamps_cap_sw":
        # scores that never run out: the walks reach x or y = 0 and go on
        # at the clamped cell to their bound, from cells at the edges too
        edge = [[0, 1, 2], [1, int(na[1]), 5], [int(nb[0]), 1, 3]]
        starts = [torch.cat([s, torch.tensor(e, dtype=torch.int32,
                                              device=dev)])
                  for s, e in zip(starts[:3], edge)]
        starts.append(torch.full_like(starts[0], 1 << 20))
        cap = 3000
    return "sw", (d, *t, *starts, bp, cap, off)


@pytest.mark.parametrize("case", WALK_BAND_CASES)
def test_walk_band_edges_equal_plain(dev, case):
    """nw_walk and sw_walk against their plain versions at the band's
    edges: ragged planes at an odd byte address and odd widths (one NW
    walk past 10,000 steps), chunk slabs of 700 columns whose walks cross
    slab edges inside a block, long GAP_A and GAP_B runs, truncation at
    the step bound, SW's clamps, free end gaps, the LCS recipe, BLOSUM62
    (its table in shared memory) and a 256 x 256 table (read where it
    lies); one launch each, under the kernel's count."""
    kind, args = _walk_band_case(case, dev)
    name = f"{kind}_walk"
    before = kernel_launch_counts()[name]
    if kind == "nw":
        got = kernels.nw_walk(*args)
        want = nw_walk_plain(*args)
        assert all(torch.equal(g, w) for g, w in zip(got, want))
        ops = got[0]
    else:
        ops = kernels.sw_walk(*args)
        assert torch.equal(ops, sw_walk_plain(*args))
    assert kernel_launch_counts()[name] == before + 1
    steps = (ops >= 0).sum(1)
    assert int(steps.max()) > 2 * WALK_BAND_K  # the walks cross blocks
    if case == "ragged_nw":
        assert int(steps.max()) > 10_000
    if case in ("cap_nw", "clamps_cap_sw"):
        assert bool((steps == ops.shape[1]).any())


# the slices of the carry (csrc/tile_carry.cuh, SLICE): (scoring, slices,
# warps a block); pairs of 1,200-1,500 x 1,000-2,600 with an empty seq_a
# and seq_b, a b of exactly one round's lanes and one of a round and a lane,
# and an a that ends on the last column of chunk 1; at 8 warps (the
# sequence-parallel entries' on long pairs) the 3 slices are a round each
SLICE_CASES = [("equality", 2, 4), ("equality", 3, 4), ("equality", 4, 1),
               ("equality", 3, 8), ("blosum62", 2, 4), ("blosum62", 3, 2)]
SLICE_KERNELS = ("nw_scores_slice", "sw_scores_slice", "nw_fill_dirs_slice")


@pytest.mark.parametrize("case", SLICE_CASES, ids=lambda c: "-".join(map(
    str, c)))
def test_slice_kernels_equal_plain_versions(dev, case):
    """nw_scores_slice, sw_scores_slice and nw_fill_dirs_slice against their
    plain versions, both through the sequence-parallel driver
    (``wavefront_sp.slice_fill``: the slices and chunks in the wavefront's
    order, a stream a slice, the edge rows between them): the NW corners and
    SW bests (the max over the slices), every edge row, the slabs; the
    slab, put together from the slices, equals the unsplit carry kernel's
    byte for byte (both zeroed first), and each fill launches its kernel
    once a slice and chunk."""
    from seqalign_tpu_torch.parallel.wavefront_sp import slice_fill

    scoring, nsl, warps = case
    table = scoring == "blosum62"
    alpha = PROTEIN[:11] if table else "acgt"
    rng = np.random.default_rng(nsl * 13 + warps + table)
    g = kernels.slice_granule(warps)
    A, Bs = _text(rng, alpha, 6, 1200, 1500), _text(rng, alpha, 6, 1000, 2600)
    A[1], Bs[2] = "", ""
    Bs[3], Bs[4], A[5] = Bs[3][:g], Bs[4][:g + 1], A[5][:1024]
    ca = 512
    for sw in (False, True):
        sc = (scoring_system_BLOSUM62() if table else
              scoring_system_sw_default() if sw else scoring_system_default())
        la, lb = max(map(len, A)), max(map(len, Bs))
        ac, bc, na, nb, bp = pack_batch(sc, kernel_params(sc, dev), A, Bs, la,
                                        lb)
        lanes = kernels.slice_lanes(lb, nsl, g)
        assert len(lanes) == nsl
        nch = -(-la // ca)
        res = {}
        for dirs in (False,) if sw else (False, True):
            name = ("nw_fill_dirs_slice" if dirs else "sw_scores_slice" if sw
                    else "nw_scores_slice")
            before = kernel_launch_counts()
            got = slice_fill(sc, (ac, bc, na, nb), bp, [dev] * nsl, lanes,
                             warps, ca, is_sw=sw, dirs=dirs)
            after = kernel_launch_counts()
            assert {k: after[k] - before[k] for k in SLICE_KERNELS} == {
                k: nsl * nch if k == name else 0 for k in SLICE_KERNELS}
            want = slice_fill(sc, (ac, bc, na, nb), bp, [dev] * nsl, lanes,
                              warps, ca, is_sw=sw, dirs=dirs, plain=True)
            assert kernel_launch_counts() == after
            np.testing.assert_array_equal(got[0], want[0])
            assert got[2].keys() == want[2].keys()
            assert len(got[2]) == (nsl - 1) * nch
            assert all(torch.equal(got[2][k], want[2][k]) for k in got[2])
            if dirs:
                assert torch.equal(got[1], want[1])
            res[name] = got
        t = [torch.from_numpy(v).to(dev) for v in (ac, bc, na, nb)]
        if sw:
            np.testing.assert_array_equal(
                res["sw_scores_slice"][0], kernels.sw_scores(*t, bp).cpu())
            continue
        # the unsplit carry kernel, chunk by chunk, into zeroed slabs
        bin = dp_boundary(bp, 6, lb, is_sw=False)
        bout = torch.zeros_like(bin)
        slab = res["nw_fill_dirs_slice"][1]
        full = torch.zeros_like(slab)
        corner = torch.zeros((6, 3), dtype=torch.int32, device=dev)
        for c in range(nch):
            kernels.nw_fill_dirs_carry(*t, bp, c * ca, bin, bout, full[:, c],
                                       corner)
            bin, bout = bout, bin
        assert torch.equal(full, slab)
        for name in ("nw_scores_slice", "nw_fill_dirs_slice"):
            np.testing.assert_array_equal(corner.cpu().numpy(),
                                          res[name][0])


def test_sequence_parallel_entries_on_the_card(dev):
    """sp_scores and sp_align_nw on two positions of one card (each slice
    on a stream of its own) equal score_batch / best_score_batch and
    align_long, and launch only the slice kernels for their fills."""
    from seqalign_tpu_torch.parallel.engine import Mesh
    from seqalign_tpu_torch.parallel.wavefront_sp import (sp_align_nw,
                                                          sp_scores)

    rng = np.random.default_rng(41)
    A, Bs = _text(rng, "acgt", 3, 3000, 5000), _text(rng, "acgt", 3, 3000,
                                                     5000)
    mesh = Mesh([dev, dev], "seq")
    for sw in (False, True):
        sc = scoring_system_sw_default() if sw else scoring_system_default()
        before = kernel_launch_counts()
        got = sp_scores(sc, A, Bs, mesh, is_sw=sw)
        after = kernel_launch_counts()
        name = "sw_scores_slice" if sw else "nw_scores_slice"
        assert after[name] > before[name]
        assert after["nw_scores"] == before["nw_scores"]
        al = SmithWaterman(sc, device=dev) if sw else NeedlemanWunsch(
            sc, device=dev)
        want = al.best_score_batch(A, Bs) if sw else al.score_batch(A, Bs)
        np.testing.assert_array_equal(got, want)
    sc = scoring_system_default()
    before = kernel_launch_counts()["nw_fill_dirs_slice"]
    got = sp_align_nw(sc, A[0], Bs[0], mesh, chunk=1024)
    assert kernel_launch_counts()["nw_fill_dirs_slice"] > before
    want = NeedlemanWunsch(sc, device=dev).align_long(A[0], Bs[0],
                                                      chunk=1024)
    assert (got.result_a, got.result_b, got.score) == (
        want.result_a, want.result_b, want.score)
