"""The port's CUDA kernels against their plain PyTorch versions, on the
card.  Every test here is marked ``cuda`` and skips without a GPU; this
file imports no JAX so it runs where only PyTorch is installed:

    python -m pytest --noconftest -q tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from seqalign_tpu.ops import host_dp
from seqalign_tpu.scoring.config import ScoringConfig
from seqalign_tpu.scoring.presets import (scoring_system_BLOSUM62,
                                          scoring_system_default,
                                          scoring_system_sw_default)
from seqalign_tpu_torch import (NeedlemanWunsch, SmithWaterman,
                                kernel_launch_counts, kernel_params)
from seqalign_tpu_torch import aligners
from seqalign_tpu_torch.ops import kernels
from seqalign_tpu_torch.ops.dp import (nw_fill_dirs_plain, nw_scores_plain,
                                       sw_extract_candidates,
                                       sw_fill_dirs_plain, sw_scores_plain,
                                       sw_sorted_candidates)
from seqalign_tpu_torch.ops.pack import pack_batch, pack_inputs_mm
from seqalign_tpu_torch.ops.traceback import (SwDeviceHits, nw_walk_plain,
                                              sw_hits_plain, sw_walk_plain)

pytestmark = pytest.mark.cuda
NW_KERNELS = ("nw_scores", "nw_fill_dirs", "nw_walk")


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
    assert all(after[k] > before[k] for k in NW_KERNELS)
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
    ops = kernels.sw_walk(d, ac, bc, *args, bp, cap)
    assert torch.equal(ops, sw_walk_plain(d, ac, bc, *args, bp, cap))
    assert (ops[:, 0] == 0).all()  # every walk starts in MATCH
    flat, score, off = sw_sorted_candidates(m, na, nb, 1)
    hargs = (d, ac, bc, na_t, flat, score, off[:-1], off[1:], bp, 16)
    hits = kernels.sw_hits(*hargs)
    want = sw_hits_plain(*hargs)
    assert all(torch.equal(g, w) for g, w in zip(hits, want))
    assert (hits[2] == 16).sum() > 0
    sn, cn = kernels.nw_scores(ac, bc, na_t, nb_t, bp)
    spn, cpn = nw_scores_plain(ac, bc, na_t, nb_t, bp)
    assert torch.equal(sn, spn) and torch.equal(cn, cpn)
    dn, cdn = kernels.nw_fill_dirs(ac, bc, na_t, nb_t, bp)
    dnp, cdnp = nw_fill_dirs_plain(ac, bc, na_t, nb_t, bp)
    assert torch.equal(dn[v], dnp[v]) and torch.equal(cdn, cdnp)
    after = kernel_launch_counts()
    assert {k: after[k] - before[k] for k in after} == {
        "nw_scores": 1, "nw_fill_dirs": 1, "nw_walk": 0, "sw_scores": 1,
        "sw_fill_dirs": 2, "sw_walk": 1, "sw_hits": 1}


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
            assert after[k] > before[k], k
        for k in ("sw_walk", "sw_hits"):
            assert (after[k] > before[k]) == walks, k
        assert all(isinstance(it, SwDeviceHits) == walks for it in its)
        assert got == want
        assert list(best) == [w[0].score if w else 0 for w in want]
