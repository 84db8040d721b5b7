"""The port's Smith-Waterman path and substitution-table scoring against
the JAX package, on the CPU: the plain fills against ``dp.fill_batch`` and
the Pallas v2 kernels in interpret mode, the plain SW walk against
``traceback.sw_walk_jit``, the compaction and the candidate harvest, and
``seqalign_tpu_torch.SmithWaterman(device="cpu")`` against
``seqalign_tpu.SmithWaterman`` on its device path.  Also the SW routing and
what the slice leaves out.  The DP is integer: every compare is exact
(tolerance 0)."""

import dataclasses
import gc
import weakref

import numpy as np
import pytest
import torch

jnp = pytest.importorskip("jax.numpy")

import seqalign_tpu  # noqa: E402
from seqalign_tpu import aligners as jax_aligners  # noqa: E402
from seqalign_tpu.ops import dp, host_dp  # noqa: E402
from seqalign_tpu.ops import traceback as jax_tb  # noqa: E402
from seqalign_tpu.ops.pallas_dp2 import (  # noqa: E402
    chain_geometry, pallas_fill_dirs2, pallas_scores2, unpack_pair_plane2,
)
from seqalign_tpu.scoring.config import ScoringConfig  # noqa: E402
from seqalign_tpu.scoring.presets import (  # noqa: E402
    scoring_system_BLOSUM62, scoring_system_sw_default,
)
from seqalign_tpu_torch import SmithWaterman, kernel_params  # noqa: E402
from seqalign_tpu_torch import aligners as port_aligners  # noqa: E402
from seqalign_tpu_torch.ops import host_dp as port_host_dp  # noqa: E402
from seqalign_tpu_torch.ops import kernels  # noqa: E402
from seqalign_tpu_torch.ops import pack as tpack  # noqa: E402
from seqalign_tpu_torch.ops.dp import (  # noqa: E402
    nw_fill_dirs_plain, nw_scores_plain, sw_extract_candidates,
    sw_fill_dirs_plain, sw_scores_plain, sw_sorted_candidates,
)
from seqalign_tpu_torch.ops.traceback import (  # noqa: E402
    SwDeviceHits, SwHitIterator, sw_walk_plain,
)

DNA = "acgtACGT"
PROTEIN = "ARNDCQEGHILKMFPSTWYVBZX"
WIDE = "".join(chr(c) for c in range(ord("A"), ord("A") + 40))  # Ka > 32


def _wildcard():
    sc = ScoringConfig(2, -2, -3, -1)
    sc.add_wildcard("n", 1)
    return sc


def _wide():
    sc = ScoringConfig(3, -2, -4, -1, case_sensitive=True)
    sc.add_wildcard("Z", 0)
    return sc


# name -> (config, alphabet); "case_insensitive" folds mixed-case DNA
CONFIGS = {
    "sw_default": (scoring_system_sw_default, DNA),
    "blosum62": (scoring_system_BLOSUM62, PROTEIN),
    "case_insensitive": (lambda: ScoringConfig(2, -1, -3, -2), DNA),
    "wildcard": (_wildcard, DNA + "nN"),
    "ka_over_32": (_wide, WIDE),
}


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


@pytest.mark.parametrize("name", list(CONFIGS))
def test_sw_plain_fills_vs_dp_fill(name):
    make, alpha = CONFIGS[name]
    sc = make()
    B, L = 6, 32
    sa, sb = _text(1, alpha, B, 1, L), _text(2, alpha, B, 1, L)
    out, jna, jnb = dp.fill_batch(sc, sa, sb, is_sw=True, emit_dirs=True,
                                  emit_m=True, pad_a=L, pad_b=L)
    (ac, bc, na, nb), bp = _port_batch(sc, sa, sb, L, L)
    assert (bp.sub is None) == tpack.mm_eligible(sc)
    if name == "ka_over_32":
        assert bp.sub.shape[0] > 32
    v = _valid(2 * L - 1, L + 1, jna, jnb)
    dirs, m = sw_fill_dirs_plain(ac, bc, na, nb, bp)
    np.testing.assert_array_equal(dirs.numpy()[v], np.asarray(out.dirs)[v])
    np.testing.assert_array_equal(m.numpy()[v], np.asarray(out.mmat)[v])
    _, m16 = sw_fill_dirs_plain(ac, bc, na, nb, bp, m16=True)
    assert m16.dtype == torch.int16
    np.testing.assert_array_equal(m16.numpy()[v], np.asarray(out.mmat)[v])
    best = sw_scores_plain(ac, bc, na, nb, bp)
    np.testing.assert_array_equal(best.numpy(), np.asarray(out.best))


@pytest.mark.parametrize("name", ["blosum62", "wildcard", "ka_over_32"])
def test_nw_table_plain_fills_vs_dp_fill(name):
    make, alpha = CONFIGS[name]
    sc = make()
    B, L = 6, 32
    sa, sb = _text(3, alpha, B, 1, L), _text(4, alpha, B, 1, L)
    out, jna, jnb = dp.fill_batch(sc, sa, sb, is_sw=False, emit_dirs=True,
                                  pad_a=L, pad_b=L)
    (ac, bc, na, nb), bp = _port_batch(sc, sa, sb, L, L)
    scores, corner = nw_scores_plain(ac, bc, na, nb, bp)
    np.testing.assert_array_equal(corner.numpy(), np.asarray(out.corner))
    dirs, corner2 = nw_fill_dirs_plain(ac, bc, na, nb, bp)
    v = _valid(2 * L - 1, L + 1, jna, jnb)
    np.testing.assert_array_equal(dirs.numpy()[v], np.asarray(out.dirs)[v])
    assert torch.equal(corner, corner2)


def test_sw_empty_sides_score_zero():
    sc = scoring_system_sw_default()
    (ac, bc, na, nb), bp = _port_batch(sc, ["", "acgt", ""], ["ac", "", ""],
                                       8, 8)
    assert sw_scores_plain(ac, bc, na, nb, bp).tolist() == [0, 0, 0]
    out, _, _ = dp.fill_batch(sc, ["", "acgt", ""], ["ac", "", ""],
                              is_sw=True, emit_dirs=False)
    assert np.asarray(out.best).tolist() == [0, 0, 0]


@pytest.mark.parametrize("name", ["sw_default", "blosum62"])
def test_sw_plain_vs_pallas_v2(name):
    """Scores, codes and M of the SW fill against the chained v2 kernels
    (equality and packed-LUT modes) in interpret mode."""
    make, alpha = CONFIGS[name]
    sc = make()
    B, LA, LB, chain = 5, 32, 24, 2
    sa, sb = _text(5, alpha, B, 1, LA), _text(6, alpha, B, 1, LB)
    a, jna = dp.pad_batch(sa, pad_to=LA)
    b, jnb = dp.pad_batch(sb, pad_to=LB)
    if dp.mm_eligible(sc):
        jac, jbc = dp.compact_inputs_mm(sc, a, b)
        subK, lut = None, 0
    else:
        jac, jbc, subK, _ = dp.compact_inputs(sc, a, b)
        lut = jax_aligners._v2_scores_eligible(sc, False, subK, LA, LB,
                                               is_sw=True)
        assert lut > 0
    kw = dict(is_sw=True, match=np.int32(sc.match),
              mismatch=np.int32(sc.mismatch),
              subK=None if subK is None else jnp.asarray(subK),
              interpret=True, chain=chain, bs=8, lut_np=lut)
    args = (jnp.asarray(jac), jnp.asarray(jbc), jnp.asarray(jna),
            jnp.asarray(jnb), np.int32(sc.gap_open), np.int32(sc.gap_extend))
    want = np.asarray(pallas_scores2(*args, **kw))
    (ac, bc, na, nb), bp = _port_batch(sc, sa, sb, LA, LB)
    np.testing.assert_array_equal(sw_scores_plain(ac, bc, na, nb, bp),
                                  want)
    jd, jm, _ = pallas_fill_dirs2(*args, emit_m=True, m_i16=True, **kw)
    geo = chain_geometry(B, LA, LB, chain=chain, bs=8, state_bytes=140,
                         lut_np=lut)
    jd, jm = np.asarray(jd), np.asarray(jm)
    wd = np.stack([unpack_pair_plane2(jd, j, geo, LA, LB) for j in range(B)])
    wm = np.stack([unpack_pair_plane2(jm, j, geo, LA, LB) for j in range(B)])
    dirs, m = sw_fill_dirs_plain(ac, bc, na, nb, bp, m16=True)
    v = _valid(LA + LB - 1, LB + 1, jna, jnb)
    np.testing.assert_array_equal(dirs.numpy()[v], wd[v])
    np.testing.assert_array_equal(m.numpy()[v], wm[v])


def test_compact_inputs_match_dp():
    rng = np.random.default_rng(9)
    a = rng.integers(60, 100, (5, 30)).astype(np.uint8)
    b = rng.integers(65, 75, (5, 20)).astype(np.uint8)
    for sc in (scoring_system_BLOSUM62(), _wildcard(), _wide()):
        for got, want in zip(tpack.compact_inputs(sc, a, b),
                             dp.compact_inputs(sc, a, b)):
            np.testing.assert_array_equal(got, want)
    empty = np.zeros((1, 0), np.uint8)
    np.testing.assert_array_equal(tpack._present_bytes(empty),
                                  dp._present_bytes(empty))
    for la, lb in ((512, 512), (4096, 4096), (1024, 8192)):
        for sc in (scoring_system_sw_default(), scoring_system_BLOSUM62()):
            from seqalign_tpu.ops.pallas_dp2 import m16_safe
            assert tpack.m16_safe(sc, la, lb) == m16_safe(sc, la, lb)


def _jax_sw_fill(sc, sa, sb, L):
    out, na, nb = dp.fill_batch(sc, sa, sb, is_sw=True, emit_dirs=True,
                                emit_m=True, pad_a=L, pad_b=L)
    return out, na, nb


@pytest.mark.parametrize("name", ["sw_default", "blosum62"])
def test_sw_extract_candidates_vs_jax(name):
    make, alpha = CONFIGS[name]
    sc = make()
    sa, sb = _text(7, alpha, 5, 1, 30), _text(8, alpha, 5, 0, 30)
    out, na, nb = _jax_sw_fill(sc, sa, sb, 32)
    mins = np.array([1, 4, 6, 1, 200], np.int32)
    want = dp.sw_extract_candidates(out.mmat, na, nb, mins)
    got = sw_extract_candidates(torch.from_numpy(np.array(out.mmat)), na,
                                nb, mins)
    assert len(got) == len(want) == 5
    for (gf, gs), (wf, ws) in zip(got, want):
        assert gf.dtype == np.int64
        np.testing.assert_array_equal(np.sort(gf), np.sort(wf))
        np.testing.assert_array_equal(gs[np.argsort(gf)], ws[np.argsort(wf)])
    assert len(got[4][0]) == 0


@pytest.mark.parametrize("name", ["sw_default", "blosum62"])
def test_sw_walk_plain_vs_sw_walk_jit(name):
    make, alpha = CONFIGS[name]
    sc = make()
    L = 32
    sa, sb = _text(10, alpha, 6, 1, L), _text(11, alpha, 6, 1, L)
    out, na, nb = _jax_sw_fill(sc, sa, sb, L)
    a, _ = dp.pad_batch(sa, pad_to=L)
    b, _ = dp.pad_batch(sb, pad_to=L)
    lut = not dp.mm_eligible(sc)
    if lut:
        acd, bcd, subK, _ = dp.compact_inputs(sc, a, b)
    else:
        acd, bcd = dp.compact_inputs_mm(sc, a, b)
        subK = np.zeros((8, 8), np.int32)
    cands = dp.sw_extract_candidates(out.mmat, na, nb, 1)
    jw = np.concatenate([np.full(len(f), j) for j, (f, _) in
                         enumerate(cands)]).astype(np.int32)
    flats = np.concatenate([f for f, _ in cands])
    s0 = np.concatenate([s for _, s in cands]).astype(np.int32)
    w = (na[jw] + 1).astype(np.int64)
    x0, y0 = (flats % w).astype(np.int32), (flats // w).astype(np.int32)
    cap = 256

    def gather_w(dirs, jw, X, Y):  # the (B, D, LB+1) layout of dp_fill
        return dirs[jw, X + Y - 2, Y]

    walk = jax_tb.sw_walk_jit(gather_w, cap, lut)
    want = np.asarray(walk(
        out.dirs, jnp.asarray(acd), jnp.asarray(bcd), jnp.asarray(subK),
        jnp.asarray(jw), jnp.asarray(x0), jnp.asarray(y0), jnp.asarray(s0),
        np.int32(sc.match), np.int32(sc.mismatch),
        np.int32(sc.gap_open + sc.gap_extend), np.int32(sc.gap_extend)))
    p = kernel_params(sc, "cpu")
    if lut:
        p = p._replace(sub=torch.from_numpy(subK))
    t = torch.from_numpy
    dirs = t(np.array(out.dirs))
    lens = (t(np.asarray(na, np.int32)), t(np.asarray(nb, np.int32)))
    got = sw_walk_plain(dirs, t(acd.astype(np.uint8)),
                        t(bcd.astype(np.uint8)), *lens, t(jw), t(x0), t(y0),
                        t(s0), p, cap)
    assert got.shape == (len(jw), 256)
    np.testing.assert_array_equal(got.numpy(), want)
    # the wrapper takes CPU tensors to the plain walk
    again = kernels.sw_walk(dirs, t(acd.astype(np.uint8)),
                            t(bcd.astype(np.uint8)), *lens, t(jw), t(x0),
                            t(y0), t(s0), p, 7)
    assert torch.equal(again, got)


def test_hit_iterator_mmat_and_candidates_agree():
    """The port's SwHitIterator, on the candidates the port harvests, gives
    the JAX one's stream from the M matrix."""
    sc = scoring_system_sw_default()
    sa, sb = _text(12, DNA, 3, 10, 30), _text(13, DNA, 3, 10, 30)
    out, na, nb = _jax_sw_fill(sc, sa, sb, 32)
    dirs, mmat = np.asarray(out.dirs), np.asarray(out.mmat)
    cands = sw_extract_candidates(torch.from_numpy(mmat.copy()), na, nb, 1)
    for j in range(3):
        want = list(jax_tb.SwHitIterator(sc, sa[j], sb[j], na[j], nb[j],
                                         dirs[j], mmat[j]))
        assert want
        assert _streams([SwHitIterator(sc, sa[j], sb[j], na[j], nb[j],
                                       dirs[j], cands[j])]) == \
            _streams([want])


@pytest.mark.parametrize("name", ["sw_default", "blosum62"])
def test_sorted_candidates_follow_the_hit_order(name):
    """The device harvest's order is the JAX iterator's stable lexsort on
    (-score, x, flat), pair by pair."""
    make, alpha = CONFIGS[name]
    sc = make()
    sa, sb = _text(30, alpha, 5, 0, 30), _text(31, alpha, 5, 1, 30)
    out, na, nb = _jax_sw_fill(sc, sa, sb, 32)
    mins = np.array([1, 3, 1, 5, 1], np.int32)
    want = dp.sw_extract_candidates(out.mmat, na, nb, mins)
    flat, score, off = sw_sorted_candidates(
        torch.from_numpy(np.array(out.mmat)), na, nb, mins)
    assert flat.dtype == score.dtype == torch.int32
    assert off[0] == 0 and off[-1] == len(flat)
    for j, (wf, ws) in enumerate(want):
        order = np.lexsort((wf, wf % (na[j] + 1), -ws.astype(np.int64)))
        s, e = int(off[j]), int(off[j + 1])
        np.testing.assert_array_equal(flat[s:e].numpy(), wf[order])
        np.testing.assert_array_equal(score[s:e].numpy(), ws[order])


@pytest.mark.parametrize("name", ["sw_default", "blosum62"])
def test_sw_hits_plain_vs_jax_hit_iterator(name):
    """The plain hit loop finds the JAX iterator's hits, in its order,
    cut at k; the wrapper takes CPU tensors to it."""
    make, alpha = CONFIGS[name]
    sc = make()
    L = 48
    sa, sb = _text(32, alpha, 4, 20, L), _text(33, alpha, 4, 20, L)
    out, na, nb = _jax_sw_fill(sc, sa, sb, L)
    jd, jm = np.asarray(out.dirs), np.asarray(out.mmat)
    want = [[(h.pos_b + h.len_b) * (na[j] + 1) + h.pos_a + h.len_a, h.score]
            for j in range(4)
            for h in jax_tb.SwHitIterator(sc, sa[j], sb[j], na[j], nb[j],
                                          jd[j], jm[j])]
    (ac, bc, na_t, nb_t), bp = _port_batch(sc, sa, sb, L, L)
    dirs, m = sw_fill_dirs_plain(ac, bc, na_t, nb_t, bp)
    flat, score, off = sw_sorted_candidates(m, na, nb, 1)
    for k in (1, 5, 10_000):
        hf, hs, nh = kernels.sw_hits(dirs, ac, bc, na_t, nb_t, flat, score,
                                     off[:-1], off[1:], bp, k)
        assert hf.shape == (4, k) and nh.dtype == torch.int32
        got = [[int(hf[j, i]), int(hs[j, i])] for j in range(4)
               for i in range(int(nh[j]))]
        per_pair = [sum(1 for h in jax_tb.SwHitIterator(
            sc, sa[j], sb[j], na[j], nb[j], jd[j], jm[j])) for j in range(4)]
        assert nh.tolist() == [min(k, n) for n in per_pair]
        starts = np.cumsum([0] + per_pair)
        assert got == [want[starts[j] + i] for j in range(4)
                       for i in range(min(k, per_pair[j]))]


@pytest.fixture
def device_path(monkeypatch):
    """Both packages on their device paths; the JAX kernels interpreted
    at a small pad floor (as test_pallas2)."""
    monkeypatch.setenv("SEQALIGN_FORCE", "device")
    monkeypatch.setenv("SEQALIGN_PALLAS", "interpret")
    monkeypatch.setenv("SEQALIGN_PALLAS_FLOOR", "16")


def _streams(its):
    return [[dataclasses.astuple(h) for h in it] for it in its]


@pytest.mark.parametrize("name", ["sw_default", "blosum62"])
def test_best_score_batch_vs_jax(device_path, name):
    make, alpha = CONFIGS[name]
    sc = make()
    A, B = _text(14, alpha, 6, 1, 50), _text(15, alpha, 6, 1, 50)
    before = jax_aligners.pallas_dispatch_counts().get("scores2", 0)
    want = seqalign_tpu.SmithWaterman(sc).best_score_batch(A, B)
    assert jax_aligners.pallas_dispatch_counts().get("scores2", 0) > before
    got = SmithWaterman(sc, device="cpu").best_score_batch(A, B)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    assert SmithWaterman(sc, device="cpu").best_score(A[0], B[0]) == want[0]


def test_score_pairs_stream_sw_vs_jax(device_path):
    sc = scoring_system_BLOSUM62()
    A, B = _text(16, PROTEIN, 7, 1, 70), _text(17, PROTEIN, 7, 1, 70)
    pairs = list(zip(range(7), A, B))
    sw = SmithWaterman(sc, device="cpu")
    got = np.zeros(7, np.int64)
    for idx, out in port_aligners.score_pairs_stream(
            sc, iter(pairs), is_sw=True, params=sw.params, flush_pairs=3):
        got[idx] = out
    want = np.zeros(7, np.int64)
    for idx, out in jax_aligners.score_pairs_stream(
            sc, iter(pairs), is_sw=True, flush_pairs=3):
        want[idx] = out
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("hint", [None, 6], ids=["hintless", "min6"])
@pytest.mark.parametrize("name", ["sw_default", "blosum62"])
def test_align_batch_hit_streams_vs_jax(device_path, monkeypatch, name,
                                        hint):
    """Full hit streams, on both of the port's walk branches: every pair's
    hits found on the device (``sw_hits``), then every pair on the host
    walk over its copy of the codes."""
    make, alpha = CONFIGS[name]
    sc = make()
    A, B = _text(18, alpha, 4, 1, 32), _text(19, alpha, 4, 1, 32)
    mins = None if hint is None else [hint] * 4
    before = jax_aligners.pallas_dispatch_counts().get("dirs2", 0)
    want = _streams(seqalign_tpu.SmithWaterman(sc).align_batch(A, B, mins))
    assert jax_aligners.pallas_dispatch_counts().get("dirs2", 0) > before
    assert sum(map(len, want)) > 4
    for cut, branch in ((1 << 62, SwDeviceHits), (-1, SwHitIterator)):
        monkeypatch.setattr(port_aligners, "_SW_DEVWALK_CANDS", cut)
        its = SmithWaterman(sc, device="cpu").align_batch(A, B, mins)
        assert all(isinstance(it, branch) for it in its)
        assert _streams(its) == want


def test_ref_mask_compat_across_pairs_vs_jax(device_path):
    """The shared reference mask carries stale marks from pair to pair;
    the port's iterators, consumed in pair order, reproduce the JAX
    package's (which reproduces the reference)."""
    sc = scoring_system_sw_default()
    A = _text(20, DNA, 6, 20, 40)
    B = [a[::-1] + a[: len(a) // 2] for a in A]
    want = _streams(seqalign_tpu.SmithWaterman(
        sc, ref_mask_compat=True).align_batch(A, B))
    got = _streams(SmithWaterman(sc, device="cpu",
                                 ref_mask_compat=True).align_batch(A, B))
    assert got == want
    fresh = _streams(SmithWaterman(sc, device="cpu").align_batch(A, B))
    assert fresh != got  # the stale marks did suppress hits here


def test_small_sw_batches_take_host_sw_hits(monkeypatch):
    monkeypatch.delenv("SEQALIGN_FORCE", raising=False)
    sc = scoring_system_sw_default()
    sw = SmithWaterman(sc, device="cpu")
    its = sw.align_batch(["acgtacgt", "ggatc"], ["acgaacgt", "gatc"])
    assert all(isinstance(it, port_host_dp.HostSwHits) for it in its)
    assert _streams(its[:1]) == _streams([host_dp.HostSwHits(
        sc, "acgtacgt", "acgaacgt")])
    # SW routes without the config: a sentinel-wrap SW config still goes
    # by size (aligners.py:1231)
    assert port_aligners._route(10 ** 9, 10 ** 6) == "device"


def test_default_sw_scoring_and_device():
    sw = SmithWaterman(device="cpu")
    s = sw.scoring
    assert (s.match, s.mismatch, s.gap_open, s.gap_extend) == (2, -2, -2, -1)
    if not torch.cuda.is_available():
        with pytest.raises((AssertionError, RuntimeError)):
            SmithWaterman()


@pytest.mark.parametrize("flag", ["no_start_gap_penalty", "no_end_gap_penalty",
                                  "no_gaps_in_a", "no_mismatches"])
def test_constrained_sw_raises_item_6(monkeypatch, flag):
    """The constrained SW configs that the device path used to refuse
    (ROADMAP.md Queue 1 item 6) now run on it: streams and best scores
    equal the host DP's."""
    monkeypatch.setenv("SEQALIGN_FORCE", "device")
    sc = ScoringConfig(1, -2, -4, -1, **{flag: True})
    sw = SmithWaterman(sc, device="cpu")
    A, B = ["acgt", "ac", "ttacgtacc"], ["acg", "cg", "acgtta"]
    want = [host_dp.HostSwHits(sc, a, b) for a, b in zip(A, B)]
    assert _streams(sw.align_batch(A, B)) == _streams(want)
    np.testing.assert_array_equal(
        sw.best_score_batch(A, B),
        [host_dp.fill_matrices(sc, a, b, True)[0].max() for a, b in
         zip(A, B)])


def test_sw_long_pairs_and_other_entry_points_raise(monkeypatch):
    """Long pairs and ``align_long`` (ROADMAP.md Queue 1 item 7) now run
    and equal the JAX package's streams; so does the matrix dump (item 4),
    its matrices cell for cell."""
    monkeypatch.setenv("SEQALIGN_FORCE", "device")
    monkeypatch.setattr(port_aligners, "LONG_PAIR_CELLS", 100)
    monkeypatch.setattr(jax_aligners, "LONG_PAIR_CELLS", 100)
    sw = SmithWaterman(device="cpu")
    jsw = jax_aligners.SmithWaterman()
    A, B = ["a" * 20, "acgtta" * 5], ["c" * 20, "acgt" * 4]
    assert _streams(sw.align_batch(A, B)) == _streams(jsw.align_batch(A, B))
    assert _streams([sw.align_long("acgtacgt", "tacgta", chunk=3)]) == \
        _streams([jsw.align_long("acgtacgt", "tacgta", chunk=3)])
    hits, mats = sw.align_with_matrices("acgt", "acgt")
    jhits, jmats = jsw.align_with_matrices("acgt", "acgt")
    assert _streams([hits]) == _streams([jhits])
    for got, want in zip(mats + sw.matrices("acgt", "acgt"), jmats * 2):
        np.testing.assert_array_equal(got, want)


def test_sw_sub_batches_follow_codes_and_m_bytes(monkeypatch):
    """SW sub-batches are sized by each pair's own planes, (na+nb-1)*(nb+1)
    cells of codes, int16 M and the harvest's one-byte mask, beside its
    hit mask of (na+1)(nb+1) bits; each sub-batch is one fill launch
    across widths, and its fill is freed before the next one fills: the
    live iterators hold no device tensor, however deep they go."""
    monkeypatch.setenv("SEQALIGN_FORCE", "device")
    sc = scoring_system_sw_default()
    assert tpack.m16_safe(sc, 64, 64)
    A, B = _text(21, DNA, 5, 10, 40), _text(22, DNA, 5, 10, 40)
    held = [(len(a) + len(b) - 1) * (len(b) + 1) * (1 + 2 + 1)
            + (len(a) + 1) * (len(b) + 1) // 8 for a, b in zip(A, B)]
    budget = held[0] + held[1]
    monkeypatch.setattr(port_aligners, "ALIGN_DIRS_BUDGET", budget)
    want, cur = [], 0
    for h in held:  # the greedy cut, in pair order
        if want and cur + h > budget:
            want.append(0)
            cur = 0
        if not want:
            want.append(0)
        want[-1] += 1
        cur += h
    assert len(want) > 1
    sizes, fills = [], []
    real = port_aligners.kernels.sw_fill_dirs

    def spy(ac, bc, na, nb, params, m16, sched=None):
        # the fills before this one are gone
        assert all(r() is None for f in fills for r in f)
        sizes.append((ac.shape[0], m16, sched is not None))
        d, m = real(ac, bc, na, nb, params, m16, sched)
        fills.append((weakref.ref(d), weakref.ref(m)))
        return d, m

    monkeypatch.setattr(port_aligners.kernels, "sw_fill_dirs", spy)
    its = SmithWaterman(sc, device="cpu").align_batch(A, B, [4] * 5)
    assert sizes == [(n, True, True) for n in want]
    gc.collect()
    assert all(r() is None for f in fills for r in f)
    assert not [v for it in its for v in vars(it).values()
                if isinstance(v, torch.Tensor)]
    for a, b, it in zip(A, B, its):
        want = [h for h in host_dp.HostSwHits(sc, a, b) if h.score >= 4]
        assert _streams([[h for h in it if h.score >= 4]]) == \
            _streams([want])
    assert len(sizes) > 3  # deeper rounds filled single pairs again


def test_m16_gate_picks_int32_for_large_scores(monkeypatch):
    monkeypatch.setenv("SEQALIGN_FORCE", "device")
    sc = ScoringConfig(400, -400, -10, -1)
    assert not tpack.m16_safe(sc, 128, 128)
    seen = []
    real = port_aligners.kernels.sw_fill_dirs

    def spy(ac, bc, na, nb, params, m16, sched=None):
        d, m = real(ac, bc, na, nb, params, m16, sched)
        seen.append(m.dtype)
        return d, m

    monkeypatch.setattr(port_aligners.kernels, "sw_fill_dirs", spy)
    a = _text(23, DNA, 1, 100, 100)[0]
    its = SmithWaterman(sc, device="cpu").align_batch([a], [a])
    assert seen == [torch.int32]
    assert next(iter(its[0])).score == 400 * len(a)


def test_nw_table_scoring_on_device_path(device_path):
    """NW scores under BLOSUM62 on the port's device path equal the JAX
    package's (its packed-LUT v2 scores kernel, interpreted), and its
    alignments the host DP's."""
    from seqalign_tpu_torch import NeedlemanWunsch

    sc = scoring_system_BLOSUM62()
    A, B = _text(24, PROTEIN, 5, 1, 40), _text(25, PROTEIN, 5, 1, 40)
    got = NeedlemanWunsch(sc, device="cpu")
    np.testing.assert_array_equal(
        got.score_batch(A, B), seqalign_tpu.NeedlemanWunsch(sc).score_batch(
            A, B))
    assert _streams([got.align_batch(A, B)]) == _streams(
        [[host_dp.nw_align(sc, a, b) for a, b in zip(A, B)]])


@pytest.mark.parametrize("name", ["sw_default", "blosum62"])
def test_deep_streams_on_both_walk_branches_match_host_sw_hits(monkeypatch,
                                                               name):
    """Whole hint-less streams of pairs with thousands of candidates: the
    device branch goes through several rounds of fill, ``sw_hits`` and
    ``sw_walk``, the host branch takes the first-step abort; both equal
    the shared host ``HostSwHits``."""
    monkeypatch.setenv("SEQALIGN_FORCE", "device")
    make, alpha = CONFIGS[name]
    sc = make()
    A, B = _text(26, alpha, 2, 90, 120), _text(27, alpha, 2, 90, 120)
    want = [[dataclasses.astuple(h) for h in host_dp.HostSwHits(sc, a, b)]
            for a, b in zip(A, B)]
    assert min(map(len, want)) > 100
    rounds = []
    real = port_aligners.kernels.sw_hits
    # k, the eleventh argument
    monkeypatch.setattr(port_aligners.kernels, "sw_hits",
                        lambda *a: rounds.append(a[10]) or real(*a))
    for cut, branch in ((1 << 62, SwDeviceHits), (-1, SwHitIterator)):
        monkeypatch.setattr(port_aligners, "_SW_DEVWALK_CANDS", cut)
        rounds.clear()
        its = SmithWaterman(sc, device="cpu").align_batch(A, B)
        assert all(isinstance(it, branch) for it in its)
        assert max(it.n_candidates for it in its) > 1000
        assert _streams(its) == want
        if branch is SwDeviceHits:  # k = 16, then 64, 256, ... per pair
            assert rounds[:3] == [16, 64, 256]
        else:
            assert rounds == []
