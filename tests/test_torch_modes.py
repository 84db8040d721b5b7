"""The recurrence modes of the port (free start / end gaps, no gaps in a /
b, no mismatches, gap_open > 0) and its LCS entry points against the JAX
package, on the CPU.  The plain fill is held against ``dp.dp_fill`` cell by
cell, the aligners against ``seqalign_tpu``'s on their device paths (the
Pallas kernels interpreted where the JAX package takes them, its XLA fill
elsewhere), ``lcs_hits`` against ``seqalign_tpu.aligners.lcs_hits``.  The DP
is integer: every compare is exact (tolerance 0)."""

import dataclasses

import numpy as np
import pytest
import torch

jnp = pytest.importorskip("jax.numpy")

import seqalign_tpu  # noqa: E402
from seqalign_tpu import aligners as jax_aligners  # noqa: E402
from seqalign_tpu.ops import dp, host_dp  # noqa: E402
from seqalign_tpu.ops import traceback as jax_tb  # noqa: E402
from seqalign_tpu.ops.pallas_dp2 import m16_safe as jax_m16_safe  # noqa: E402
from seqalign_tpu.scoring.config import ScoringConfig  # noqa: E402
from seqalign_tpu.scoring.presets import scoring_system_BLOSUM62  # noqa: E402
from seqalign_tpu_torch import (  # noqa: E402
    NeedlemanWunsch, SmithWaterman, kernel_params, lcs_aligner, lcs_hits,
)
from seqalign_tpu_torch import aligners as port_aligners  # noqa: E402
from seqalign_tpu_torch.ops import kernels  # noqa: E402
from seqalign_tpu_torch.ops import pack as tpack  # noqa: E402
from seqalign_tpu_torch.ops.dp import (  # noqa: E402
    nw_fill_dirs_plain, nw_scores_plain, sw_fill_dirs_plain, sw_scores_plain,
    sw_sorted_candidates,
)
from seqalign_tpu_torch.ops.traceback import (  # noqa: E402
    SwDeviceHits, SwHitIterator, nw_walk_plain,
)

DNA = "acgtACGT"
PROTEIN = "ARNDCQEGHILKMFPSTWYVBZX"

# name -> flags of the mode (gap_open > 0 is a mode of the penalties)
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


def _equality(mode):
    if mode == "gap_open_pos":
        return ScoringConfig(2, -3, 1, -1)
    return ScoringConfig(1, -2, -4, -1, **MODES[mode])


def _table(mode):
    sc = scoring_system_BLOSUM62()
    for k, v in MODES[mode].items():
        setattr(sc, k, v)
    if mode == "gap_open_pos":
        sc.gap_open = 1
    sc._luts = None
    return sc


def _wildcard(mode):
    """Equality letters plus a wildcard: table mode with is-match entries
    that are not the diagonal (a wildcard matches everything)."""
    sc = _equality(mode)
    sc.add_wildcard("n", 1)
    return sc


SCORINGS = {"equality": (_equality, DNA), "table": (_table, PROTEIN),
            "wildcard": (_wildcard, DNA + "nN")}


def _text(seed, alpha, n, lo, hi):
    rng = np.random.default_rng(seed)
    letters = np.array(list(alpha))
    return ["".join(letters[rng.integers(0, len(letters), int(k))])
            for k in rng.integers(lo, hi + 1, n)]


def _valid(D, LBp, na, nb):
    y = np.arange(LBp)[None, None, :]
    x = np.arange(D)[None, :, None] + 2 - y
    return ((y >= 1) & (y <= nb[:, None, None]) & (x >= 1)
            & (x <= na[:, None, None]))


def _port_batch(sc, sa, sb, LA, LB):
    ac, bc, na, nb, bp = tpack.pack_batch(sc, kernel_params(sc, "cpu"), sa,
                                          sb, LA, LB)
    return tuple(torch.from_numpy(v) for v in (ac, bc, na, nb)), bp


def _tuples(alns):
    return [dataclasses.astuple(a) for a in alns]


def _streams(its):
    return [_tuples(it) for it in its]


def test_mode_bits_and_params():
    sc = _table("nga_ngb_nmm")
    p = kernel_params(sc, "cpu")
    assert p.modes == tpack.NGA | tpack.NGB | tpack.NMM
    assert kernel_params(_equality("nsg_neg"), "cpu").modes == \
        tpack.NSG | tpack.NEG
    assert kernel_params(_equality("gap_open_pos"), "cpu").modes == 0
    (ac, bc, na, nb), bp = _port_batch(sc, ["ARND"], ["ARN"], 8, 8)
    assert bp.sub is not None and bp.im is not None
    assert bp.im.shape == bp.sub.shape and bp.im.dtype == torch.int32
    _, _, _, imK = dp.compact_inputs(sc, tpack.pad_batch(["ARND"], 8)[0],
                                     tpack.pad_batch(["ARN"], 8)[0])
    np.testing.assert_array_equal(bp.im.numpy(), imK)
    # without no_mismatches the is-match table is not carried
    assert _port_batch(_table("neg"), ["ARND"], ["ARN"], 8, 8)[1].im is None
    # equality scoring under no_mismatches scores a mismatching pair 0, as
    # the LUT the JAX package fills from
    eq = _equality("nmm")
    assert kernel_params(eq, "cpu").scal[1].item() == 0
    assert eq.luts()[1][ord("a"), ord("c")] == 0


@pytest.mark.parametrize("scoring", list(SCORINGS))
@pytest.mark.parametrize("mode", list(MODES))
def test_nw_plain_fill_vs_dp_fill(mode, scoring):
    """Corner and codes on the valid cells, every mode, against dp_fill;
    the batch holds empty sides."""
    make, alpha = SCORINGS[scoring]
    sc = make(mode)
    B, L = 8, 24
    sa, sb = _text(41, alpha, B, 0, L), _text(42, alpha, B, 0, L)
    sa[0], sb[1] = "", ""
    out, jna, jnb = dp.fill_batch(sc, sa, sb, is_sw=False, emit_dirs=True,
                                  pad_a=L, pad_b=L)
    (ac, bc, na, nb), bp = _port_batch(sc, sa, sb, L, L)
    assert (bp.sub is None) == (scoring == "equality")
    scores, corner = nw_scores_plain(ac, bc, na, nb, bp)
    np.testing.assert_array_equal(corner.numpy(), np.asarray(out.corner))
    np.testing.assert_array_equal(scores.numpy(),
                                  np.asarray(out.corner).max(1))
    dirs, corner2 = nw_fill_dirs_plain(ac, bc, na, nb, bp)
    v = _valid(2 * L - 1, L + 1, jna, jnb)
    np.testing.assert_array_equal(dirs.numpy()[v], np.asarray(out.dirs)[v])
    assert torch.equal(corner, corner2)


@pytest.mark.parametrize("scoring", list(SCORINGS))
@pytest.mark.parametrize("mode", list(MODES))
def test_sw_plain_fill_vs_dp_fill(mode, scoring):
    """Best score, codes and M on the valid cells, every mode, against
    dp_fill: the free-end-gap branches are not gated on SW."""
    make, alpha = SCORINGS[scoring]
    sc = make(mode)
    B, L = 8, 24
    sa, sb = _text(43, alpha, B, 0, L), _text(44, alpha, B, 0, L)
    sa[0], sb[1] = "", ""
    out, jna, jnb = dp.fill_batch(sc, sa, sb, is_sw=True, emit_dirs=True,
                                  emit_m=True, pad_a=L, pad_b=L)
    (ac, bc, na, nb), bp = _port_batch(sc, sa, sb, L, L)
    v = _valid(2 * L - 1, L + 1, jna, jnb)
    dirs, m = sw_fill_dirs_plain(ac, bc, na, nb, bp)
    np.testing.assert_array_equal(dirs.numpy()[v], np.asarray(out.dirs)[v])
    np.testing.assert_array_equal(m.numpy()[v], np.asarray(out.mmat)[v])
    np.testing.assert_array_equal(
        sw_scores_plain(ac, bc, na, nb, bp).numpy(), np.asarray(out.best))
    if tpack.m16_safe(sc, L, L):
        _, m16 = sw_fill_dirs_plain(ac, bc, na, nb, bp, m16=True)
        np.testing.assert_array_equal(m16.numpy()[v],
                                      np.asarray(out.mmat)[v])


@pytest.mark.parametrize("mode", ["neg", "nga", "ngb", "nga_ngb", "neg_nga",
                                  "nsg_neg", "nga_ngb_nmm"])
def test_empty_side_corner_equals_host_fill(mode):
    """The corner of a pair with an empty side is a boundary cell: under
    every mode it is what ``host_dp.fill_matrices`` holds there."""
    sc = _equality(mode)
    sa, sb = ["", "acgt", ""], ["acg", "", ""]
    (ac, bc, na, nb), bp = _port_batch(sc, sa, sb, 8, 8)
    _, corner = nw_scores_plain(ac, bc, na, nb, bp)
    for j, (a, b) in enumerate(zip(sa, sb)):
        M, Ga, Gb = host_dp.fill_matrices(sc, a, b, False)
        assert corner[j].tolist() == [M[-1, -1], Ga[-1, -1], Gb[-1, -1]]


@pytest.mark.parametrize("mode", list(MODES))
def test_nw_walk_needs_no_mode(mode):
    """``nw_walk`` follows codes only: on a constrained fill's codes the
    plain walk gives the JAX walk's trace and strings, with no flag."""
    sc = _equality(mode)
    B, L = 6, 32
    sa, sb = _text(45, DNA, B, 1, L), _text(46, DNA, B, 1, L)
    out, jna, jnb = dp.fill_batch(sc, sa, sb, is_sw=False, emit_dirs=True,
                                  pad_a=L, pad_b=L)
    cap = int(np.max(jna + jnb))
    jcorner = np.asarray(out.corner)
    jops, jscore = jax_tb.nw_walk_device(
        out.dirs, jax_aligners._xla_gather(B), jcorner, jna, jnb, cap)
    (ac, bc, na, nb), bp = _port_batch(sc, sa, sb, L, L)
    dirs, corner = nw_fill_dirs_plain(ac, bc, na, nb, bp)
    ops, score = nw_walk_plain(dirs, corner, na, nb, cap)
    np.testing.assert_array_equal(ops.numpy(), jops)
    np.testing.assert_array_equal(score.numpy(), jscore)


@pytest.fixture
def device_path(monkeypatch):
    """Both packages on their device paths; the JAX kernels interpreted
    at a small pad floor (as test_pallas2)."""
    monkeypatch.setenv("SEQALIGN_FORCE", "device")
    monkeypatch.setenv("SEQALIGN_PALLAS", "interpret")
    monkeypatch.setenv("SEQALIGN_PALLAS_FLOOR", "16")


@pytest.mark.parametrize("scoring", ["equality", "table"])
@pytest.mark.parametrize("mode", list(MODES))
def test_nw_aligner_vs_jax(device_path, mode, scoring):
    make, alpha = SCORINGS[scoring]
    sc = make(mode)
    A, B = _text(47, alpha, 6, 0, 40), _text(48, alpha, 6, 0, 40)
    A[0], B[1] = "", ""
    port = NeedlemanWunsch(sc, device="cpu")
    ref = seqalign_tpu.NeedlemanWunsch(sc)
    np.testing.assert_array_equal(port.score_batch(A, B),
                                  ref.score_batch(A, B))
    assert _tuples(port.align_batch(A, B)) == _tuples(ref.align_batch(A, B))
    pairs = list(zip(range(6), A, B))
    got = np.zeros(6, np.int64)
    for idx, out in port.score_pairs_stream(iter(pairs), flush_pairs=4):
        got[idx] = out
    np.testing.assert_array_equal(got, ref.score_batch(A, B))


@pytest.mark.parametrize("scoring", ["equality", "table"])
@pytest.mark.parametrize("mode", list(MODES))
def test_sw_aligner_vs_jax(device_path, monkeypatch, mode, scoring):
    """Best scores and whole hit streams, on both of the port's walk
    branches: hits found on the device (``sw_hits`` / ``sw_walk`` with the
    free-end-gap rule), then the host walk over the codes."""
    make, alpha = SCORINGS[scoring]
    sc = make(mode)
    A, B = _text(49, alpha, 5, 0, 36), _text(50, alpha, 5, 0, 36)
    A[0], B[1] = "", ""
    ref = seqalign_tpu.SmithWaterman(sc)
    np.testing.assert_array_equal(
        SmithWaterman(sc, device="cpu").best_score_batch(A, B),
        ref.best_score_batch(A, B))
    want = _streams(ref.align_batch(A, B))
    assert sum(map(len, want)) > 4
    for cut, branch in ((1 << 62, SwDeviceHits), (-1, SwHitIterator)):
        monkeypatch.setattr(port_aligners, "_SW_DEVWALK_CANDS", cut)
        its = SmithWaterman(sc, device="cpu").align_batch(A, B)
        assert all(isinstance(it, branch) for it in its)
        assert _streams(its) == want


def test_sw_free_end_gap_rule_is_not_reached_from_m_starts():
    """Under free end gaps the hit loop gives the host's stream.  The rule
    itself (a GAP_A step at x == na, a GAP_B step at y == nb, costs 0)
    never fires on a walk that starts in M: its first step is a MATCH
    step to (y-1, x-1) and coordinates only fall, so no later step is on
    the last column or row; the loop without the rule gives the same
    stream on the same codes."""
    sc = ScoringConfig(2, -2, -2, -1, no_end_gap_penalty=True)
    a, b = "ttttacgtacgt", "acgtacgtcccccc"
    want = _tuples(host_dp.HostSwHits(sc, a, b))
    (ac, bc, na, nb), bp = _port_batch(sc, [a], [b], 16, 16)
    dirs, m = sw_fill_dirs_plain(ac, bc, na, nb, bp)
    flat, score, off = sw_sorted_candidates(m, na.numpy(), nb.numpy(), 1)
    hf, hs, nh = kernels.sw_hits(dirs, ac, bc, na, nb, flat, score, off[:-1],
                                 off[1:], bp, 64)
    assert int(nh[0]) == len(want)
    assert hs[0, :len(want)].tolist() == [w[2] for w in want]
    plain = bp._replace(modes=0)
    hf0, hs0, nh0 = kernels.sw_hits(dirs, ac, bc, na, nb, flat, score,
                                    off[:-1], off[1:], plain, 64)
    assert torch.equal(hf0, hf) and torch.equal(hs0, hs)
    assert torch.equal(nh0, nh)


def test_sw_sentinel_wrap_config_runs_on_the_device_path(device_path):
    """SW passes no config to ``_route``: a both-no-gaps config with
    ``sentinel_wrap_risk()`` runs on the int32 fill, whose wrap is the
    JAX package's."""
    sc = ScoringConfig(1, -2, -4, -1, no_gaps_in_a=True, no_gaps_in_b=True)
    assert sc.sentinel_wrap_risk()
    A, B = _text(51, DNA, 4, 5, 30), _text(52, DNA, 4, 5, 30)
    calls = []
    real = port_aligners.kernels.sw_fill_dirs
    port_aligners.kernels.sw_fill_dirs = \
        lambda *a: calls.append(1) or real(*a)
    try:
        got = _streams(SmithWaterman(sc, device="cpu").align_batch(A, B))
    finally:
        port_aligners.kernels.sw_fill_dirs = real
    assert calls
    assert got == _streams(seqalign_tpu.SmithWaterman(sc).align_batch(A, B))


def test_check_slice_is_the_dispatch_point():
    assert port_aligners._check_slice("scores") is kernels.nw_scores
    assert port_aligners._check_slice("scores", True) is kernels.sw_scores
    assert port_aligners._check_slice("dirs") is kernels.nw_fill_dirs
    assert port_aligners._check_slice("dirs", True) is kernels.sw_fill_dirs
    # the long-pair path (ROADMAP.md Queue 1 item 7) is ported
    assert port_aligners._check_slice("long") is kernels.nw_fill_dirs_carry
    assert port_aligners._check_slice("long", True) is \
        kernels.sw_fill_dirs_carry
    # the matrix dump (ROADMAP.md Queue 1 item 4) is ported
    assert port_aligners._check_slice("gab") is kernels.nw_fill_gab
    assert port_aligners._check_slice("gab", True) is kernels.sw_fill_gab
    assert not hasattr(port_aligners, "_UNPORTED")


def test_swap_symmetric_equals_the_jax_rule():
    for mode in MODES:
        for make, _ in SCORINGS.values():
            sc = make(mode)
            assert port_aligners._swap_symmetric(
                port_aligners.from_reference(sc)) == \
                jax_aligners._swap_symmetric(sc)


def test_m16_safe_under_the_modes():
    """Free end gaps add nothing to M's range: the gate equals the JAX
    package's while no gap step gains; with a gaining gap step (gap_open >
    0 can make one) it counts la + lb steps."""
    for mode in MODES:
        if mode == "gap_open_pos":
            continue
        for la, lb in ((512, 512), (4096, 4096), (1024, 8192)):
            for make in (_equality, _table):
                sc = make(mode)
                assert tpack.m16_safe(sc, la, lb) == jax_m16_safe(sc, la, lb)
    gain = ScoringConfig(2, -2, 3, -1)  # a gap's first step scores +2
    assert jax_m16_safe(gain, 9000, 9000)
    assert not tpack.m16_safe(gain, 9000, 9000)
    assert tpack.m16_safe(gain, 4096, 4096)


def test_hintless_sw_sub_batches_count_the_harvest(monkeypatch):
    """Without a hint a sub-batch is sized by the harvest's bytes too."""
    monkeypatch.setenv("SEQALIGN_FORCE", "device")
    sc = lcs_aligner(device="cpu").scoring
    A = _text(53, DNA, 5, 40, 60)
    # at each pair's own widths: codes, int16 M and the harvest's mask,
    # the hit mask
    fill = [(2 * n - 1) * (n + 1) * 4 + (n + 1) * (n + 1) // 8
            for n in map(len, A)]
    harvest = [int(port_aligners._HARVEST_BYTES
                   * port_aligners._HARVEST_SHARE * n * n)
               for n in map(len, A)]
    assert all(h > f for f, h in zip(fill, harvest))  # it dominates
    budget = 2 * max(f + h for f, h in zip(fill, harvest))
    monkeypatch.setattr(port_aligners, "ALIGN_DIRS_BUDGET", budget)
    want, cur = [], budget
    for f, h in zip(fill, harvest):  # the greedy cut, in pair order
        if cur + f + h > budget:
            want.append(0)
            cur = 0
        want[-1] += 1
        cur += f + h
    assert len(want) > 1 and sum(fill) <= budget
    sizes = []
    real = port_aligners.kernels.sw_fill_dirs

    def spy(ac, *args):
        sizes.append(ac.shape[0])
        return real(ac, *args)

    monkeypatch.setattr(port_aligners.kernels, "sw_fill_dirs", spy)
    sw = SmithWaterman(sc, device="cpu")
    sw.align_batch(A, A)
    assert sizes == want
    sizes.clear()
    sw.align_batch(A, A, [3] * 5)  # hinted: the fill's bytes only
    assert sizes == [5]


@pytest.mark.parametrize("case_sensitive", [True, False])
def test_lcs_hits_vs_jax(device_path, monkeypatch, case_sensitive):
    seqs = _text(54, DNA, 3, 30, 60) + ["acgtacgtTTacgta", "a", ""]
    sw = lcs_aligner(case_sensitive, device="cpu")
    s = sw.scoring
    assert (s.match, s.mismatch, s.gap_open, s.gap_extend) == (1, -1, -4, -1)
    assert s.no_gaps_in_a and s.no_gaps_in_b and s.no_mismatches
    assert s.case_sensitive == case_sensitive
    for seq in seqs:
        want = _tuples(jax_aligners.lcs_hits(seq, case_sensitive))
        got = _tuples(lcs_hits(seq, case_sensitive, sw=sw))
        assert got == want
        assert all(h[3] < h[4] and (h[0] == h[1] if case_sensitive
                                    else h[0].lower() == h[1].lower())
                   for h in got)
    assert len(want) == 0 and _tuples(lcs_hits(seqs[3], sw=lcs_aligner(
        device="cpu")))[0][:3] == ("acgta", "acgta", 5)
    # the host path gives the same stream
    monkeypatch.setenv("SEQALIGN_FORCE", "host")
    assert _tuples(lcs_hits(seqs[0], case_sensitive, sw=sw)) == \
        _tuples(jax_aligners.lcs_hits(seqs[0], case_sensitive))


def test_lcs_aligner_default_device_is_cuda():
    if not torch.cuda.is_available():
        with pytest.raises((AssertionError, RuntimeError)):
            lcs_aligner()
