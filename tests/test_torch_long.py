"""The port's long-pair path (seqalign_tpu_torch: the carry fill, the walks
over chunk slabs, ``align_long`` and the long bucket of ``align_batch``)
against the JAX package's, on the CPU, where the port runs the plain
PyTorch versions of its kernels.  Inputs come from numpy seeds; tolerance
0 everywhere: the DP is integer."""

import dataclasses
import itertools

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

import seqalign_tpu.aligners as jax_aligners  # noqa: E402
from chip_smoke import MODES  # noqa: E402
from seqalign_tpu.ops import dp as jax_dp  # noqa: E402
from seqalign_tpu.ops import host_dp as jax_host  # noqa: E402
from seqalign_tpu.scoring.config import ScoringConfig  # noqa: E402
from seqalign_tpu.scoring.presets import (  # noqa: E402
    scoring_system_BLOSUM62, scoring_system_default,
    scoring_system_sw_default,
)
from seqalign_tpu_torch import NeedlemanWunsch, SmithWaterman  # noqa: E402
from seqalign_tpu_torch import aligners as port_aligners  # noqa: E402
from seqalign_tpu_torch import kernel_params  # noqa: E402
from seqalign_tpu_torch.ops import dp, kernels  # noqa: E402
from seqalign_tpu_torch.ops.pack import pack_batch  # noqa: E402
from seqalign_tpu_torch.ops.traceback import (  # noqa: E402
    ChunkedDirs, ChunkedM, nw_traceback, nw_walk_plain, sw_hits_plain,
    sw_walk_plain,
)
from seqalign_tpu_torch.scoring.config import from_reference  # noqa: E402

# the shapes of tests/test_chunked.py, as (|a|, |b|)
SHAPES = [(120, 40), (37, 90), (100, 100), (70, 45)]
DNA = "acgt"
PROTEIN = "ARNDCQEGHILKMFPSTWYV"


def _seq(rng, n, alpha=DNA):
    return "".join(rng.choice(list(alpha), n))


def _config(mode, sw, table=False):
    """A JAX-package config of one of chip_smoke.MODES (or "default"): the
    NW 1/-2/-4/-1 or SW 2/-2/-2/-1 scoring, or BLOSUM62, with the mode's
    flags; 2/-3/1/-1 for gap_open > 0; mismatch -5 for a both-no-gaps NW
    config, out of the sentinel-wrap regime."""
    flags = MODES.get(mode, {})
    if table:
        sc = scoring_system_BLOSUM62()
        for k, v in flags.items():
            setattr(sc, k, v)
        sc._luts = None
        return sc
    if mode == "gap_open>0":
        return ScoringConfig(2, -3, 1, -1)
    if sw:
        return ScoringConfig(2, -2, -2, -1, **flags)
    both = flags.get("no_gaps_in_a") and flags.get("no_gaps_in_b")
    return ScoringConfig(1, -5 if both else -2, -4, -1, **flags)


def _packed(sc, A, B):
    psc = from_reference(sc)
    ac, bc, na, nb, bp = pack_batch(psc, kernel_params(psc), A, B,
                                    max(map(len, A)), max(map(len, B)))
    return [torch.from_numpy(v) for v in (ac, bc, na, nb)], bp


def _slab_valid(D, LBp, c, chunk, na, nb):
    y = np.arange(LBp)[None, None, :]
    xl = np.arange(D)[None, :, None] + 2 - y
    x = xl + c * chunk
    return ((y >= 1) & (y <= nb[:, None, None]) & (xl >= 1)
            & (xl <= chunk) & (x <= na[:, None, None]))


def _fill_equals_jax(sc, A, B, is_sw, chunk):
    corner, best, dch, mch, na, nb = jax_dp.fill_chunked(
        sc, A, B, is_sw=is_sw, chunk=chunk, emit_dirs=True, emit_m=is_sw)
    t, bp = _packed(sc, A, B)
    pc, pbest, pd, pm, _, _ = dp.fill_chunked(*t, bp, is_sw=is_sw,
                                              chunk=chunk)
    assert len(pd) == len(dch) == -(-max(map(len, A)) // chunk)
    for c, (jd, d) in enumerate(zip(dch, pd)):
        assert jd.shape == d.shape
        v = _slab_valid(jd.shape[1], jd.shape[2], c, chunk, na, nb)
        np.testing.assert_array_equal(d.numpy()[v], jd[v])
        if is_sw:
            np.testing.assert_array_equal(pm[c].numpy()[v],
                                          np.asarray(mch[c])[v])
            # the accessors read the slabs cell by cell
            j = int(np.argmax(na))
            acc_m = ChunkedM([m[j].numpy() for m in pm], chunk)
            acc_d = ChunkedDirs(np.stack([s[j].numpy() for s in pd]), chunk)
            ys, xs = np.nonzero(v[j])
            for r, y in zip(ys[:50], xs[:50]):
                x = r + 2 - y + c * chunk
                assert acc_m.at(y, x) == np.asarray(mch[c])[j, r, y]
                assert acc_d.code(y, x) == jd[j, r, y]
    if is_sw:
        np.testing.assert_array_equal(pbest.numpy(), best)
    else:
        np.testing.assert_array_equal(pc.numpy(), corner)


@pytest.mark.parametrize("chunk", [16, 50])
@pytest.mark.parametrize("is_sw", [False, True], ids=["nw", "sw"])
def test_carry_fill_equals_jax_fill_chunked(is_sw, chunk):
    """(a) The plain carry fill slab by slab against the JAX package's
    ``dp.fill_chunked``: codes and M on the valid cells, the NW corner,
    the SW best, on the four shapes of test_chunked.py in one batch."""
    rng = np.random.default_rng(chunk + is_sw)
    A = [_seq(rng, a) for a, _ in SHAPES]
    B = [_seq(rng, b) for _, b in SHAPES]
    _fill_equals_jax(_config("default", is_sw), A, B, is_sw, chunk)


@pytest.mark.parametrize("is_sw", [False, True], ids=["nw", "sw"])
@pytest.mark.parametrize("mode", list(MODES) + ["blosum62"])
def test_carry_fill_modes_equal_jax(mode, is_sw):
    """(a) Under every flag combination of chip_smoke.MODES and with the
    BLOSUM62 table, chunks of 16: the borders fall inside the pairs, so the
    last-column rules and the no-gaps guards meet them."""
    rng = np.random.default_rng(len(mode) * 3 + is_sw)
    table = mode == "blosum62"
    alpha = PROTEIN if table else DNA
    A = [_seq(rng, a, alpha) for a, _ in SHAPES]
    B = [_seq(rng, b, alpha) for _, b in SHAPES]
    sc = _config("nsg+neg" if table else mode, is_sw, table)
    _fill_equals_jax(sc, A, B, is_sw, 16)


def _key(h):
    return (h.score, h.pos_a, h.pos_b, h.len_a, h.len_b, h.result_a,
            h.result_b)


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("chunk", [16, 50])
def test_nw_align_long_equals_jax(chunk, shape):
    """(b) NW ``align_long``: strings and score equal the JAX package's,
    for chunks that do and do not divide |a|."""
    rng = np.random.default_rng(shape[0] * 7 + shape[1] + chunk)
    a, b = _seq(rng, shape[0]), _seq(rng, shape[1])
    sc = scoring_system_default()
    got = NeedlemanWunsch(sc, device="cpu").align_long(a, b, chunk=chunk)
    want = jax_aligners.NeedlemanWunsch(sc).align_long(a, b, chunk=chunk)
    assert dataclasses.astuple(got) == dataclasses.astuple(want)


@pytest.mark.parametrize("mode", list(MODES))
def test_nw_align_long_modes_equal_jax(mode):
    """(b) NW ``align_long`` under each flag combination, |b| << |a| and
    chunks of 16, so that paths run along row 0 across chunk borders (the
    carried column's row-0 cell) and a border falls on x = na - 1."""
    rng = np.random.default_rng(len(mode))
    sc = _config(mode, False)
    nw = NeedlemanWunsch(sc, device="cpu")
    jnw = jax_aligners.NeedlemanWunsch(sc)
    for la, lb in ((70, 45), (65, 6), (33, 3)):
        a, b = _seq(rng, la), _seq(rng, lb)
        got = nw.align_long(a, b, chunk=16)
        want = jnw.align_long(a, b, chunk=16)
        assert dataclasses.astuple(got) == dataclasses.astuple(want), (la,
                                                                       lb)


@pytest.mark.parametrize("min_score", [None, 5, 6])
@pytest.mark.parametrize("chunk", [16, 48])
def test_sw_align_long_equals_jax(chunk, min_score):
    """(b) SW ``align_long`` hit streams equal the JAX package's, hint-less
    and with the hints of test_chunked.py and test_sw_streaming.py; the
    whole stream, past the first device round."""
    rng = np.random.default_rng(chunk * 3 + (min_score or 0))
    a, b = _seq(rng, 90), _seq(rng, 60)
    sc = scoring_system_sw_default()
    got = SmithWaterman(sc, device="cpu").align_long(a, b, chunk=chunk,
                                                     min_score=min_score)
    want = jax_aligners.SmithWaterman(sc).align_long(a, b, chunk=chunk,
                                                     min_score=min_score)
    g, w = [_key(h) for h in got], [_key(h) for h in want]
    assert len(g) > port_aligners._SW_PREWALK
    assert g == w


def test_align_long_equals_jax_fill_dirs_long(monkeypatch):
    """(b) Against the JAX package's own chunked Pallas kernel
    (``fill_dirs_long``, interpreted): NW strings and an SW stream."""
    monkeypatch.setenv("SEQALIGN_PALLAS", "interpret")
    monkeypatch.setenv("SEQALIGN_PALLAS_FLOOR", "16")
    rng = np.random.default_rng(24)
    a, b = _seq(rng, 70), _seq(rng, 40)
    before = jax_aligners.pallas_dispatch_counts().get("chunked", 0)
    want = jax_aligners.NeedlemanWunsch().align_long(a, b, chunk=24)
    hits = list(jax_aligners.SmithWaterman().align_long(a, b, chunk=24,
                                                        min_score=5))
    assert jax_aligners.pallas_dispatch_counts()["chunked"] == before + 2
    got = NeedlemanWunsch(device="cpu").align_long(a, b, chunk=24)
    assert dataclasses.astuple(got) == dataclasses.astuple(want)
    sw = SmithWaterman(device="cpu")
    assert [_key(h) for h in sw.align_long(a, b, chunk=24, min_score=5)] \
        == [_key(h) for h in hits]


def _mixed(seed):
    rng = np.random.default_rng(seed)
    A = [_seq(rng, int(n)) for n in rng.integers(25, 60, 4)] + \
        [_seq(rng, 20), _seq(rng, 90)]
    B = [_seq(rng, int(n)) for n in rng.integers(25, 60, 4)] + \
        [_seq(rng, 25), _seq(rng, 30)]
    return A, B


@pytest.mark.parametrize("cells", [600, 2000])
def test_long_bucket_nw_equals_jax(monkeypatch, cells):
    """(c) ``align_batch`` over long and short pairs, both packages with
    LONG_PAIR_CELLS small (test_auto_long_routing,
    test_pallas_long_bucket_batched): equal alignments, and the port ran
    its long path."""
    monkeypatch.setenv("SEQALIGN_FORCE", "device")
    monkeypatch.setattr(jax_aligners, "LONG_PAIR_CELLS", cells)
    monkeypatch.setattr(port_aligners, "LONG_PAIR_CELLS", cells)
    A, B = _mixed(cells)
    assert any(len(a) * len(b) > cells for a, b in zip(A, B))
    assert any(len(a) * len(b) <= cells for a, b in zip(A, B))
    before = port_aligners.long_branch_counts()["device"]
    got = NeedlemanWunsch(device="cpu").align_batch(A, B)
    assert port_aligners.long_branch_counts()["device"] > before
    want = jax_aligners.NeedlemanWunsch().align_batch(A, B)
    assert [dataclasses.astuple(g) for g in got] == \
        [dataclasses.astuple(w) for w in want]


@pytest.mark.parametrize("hint", [None, 4], ids=["hintless", "min4"])
@pytest.mark.parametrize("cells", [600, 2000])
def test_long_bucket_sw_equals_jax(monkeypatch, cells, hint):
    """(c) SW ``align_batch`` over long and short pairs: equal hit streams,
    hint-less and with min_score 4."""
    monkeypatch.setenv("SEQALIGN_FORCE", "device")
    monkeypatch.setattr(jax_aligners, "LONG_PAIR_CELLS", cells)
    monkeypatch.setattr(port_aligners, "LONG_PAIR_CELLS", cells)
    A, B = _mixed(cells + 1)
    mins = None if hint is None else [hint] * len(A)
    got = SmithWaterman(device="cpu").align_batch(A, B, mins)
    want = jax_aligners.SmithWaterman().align_batch(A, B, mins)
    assert [[_key(h) for h in it] for it in got] == \
        [[_key(h) for h in it] for it in want]


def test_chunk_harvest_exact_candidates():
    """(d) The per-chunk harvest (test_pallas.py:676-707 on the port):
    exactly the interior cells with M >= 1, each once with its score; the
    skew pad past each chunk's last column never passes the mask, even
    when it holds large values."""
    sc = scoring_system_sw_default()
    rng = np.random.default_rng(0)
    core = _seq(rng, 30)
    a = _seq(rng, 20) + core + _seq(rng, 20)
    b = _seq(rng, 35) + core + _seq(rng, 35)
    t, bp = _packed(sc, [a], [b])
    M = jax_host.fill_matrices(sc, a, b, True)[0]
    want = {y * (len(a) + 1) + x: int(M[y, x])
            for y in range(1, len(b) + 1) for x in range(1, len(a) + 1)
            if M[y, x] >= 1}
    _, _, _, cands, _, _ = dp.fill_chunked(*t, bp, is_sw=True, chunk=32,
                                           extract_min=1)
    flats, scores = cands[0]
    assert flats.dtype == np.int64
    assert len(flats) == len(set(flats.tolist())) == len(want)
    assert dict(zip(flats.tolist(), scores.tolist())) == want
    # the same harvest from slabs whose unwritten cells hold 999
    _, _, _, mch, na, nb = dp.fill_chunked(*t, bp, is_sw=True, chunk=32)
    parts = []
    for c, m in enumerate(mch):
        v = _slab_valid(m.shape[1], m.shape[2], c, 32, na.numpy(),
                        nb.numpy())
        m = m.clone()
        m[~torch.from_numpy(v)] = 999
        parts.append(dp.sw_sorted_candidates(m, na.numpy(), nb.numpy(), 1,
                                             x_off=c * 32))
    flat, score, _ = dp.merge_candidates(parts, 1)
    assert dict(zip(flat.tolist(), score.tolist())) == want
    order = sorted(want, key=lambda f: (-want[f], f % (len(a) + 1), f))
    assert flat.tolist() == order


@pytest.mark.parametrize("chunk", [None, 24], ids=["one_slab", "chunks"])
def test_slab_walks_equal_unchunked_walks(chunk):
    """(e) The plain walks over chunk slabs equal the walks over the
    unchunked plane, for one slab (CA = LA) and for chunks of 24."""
    sc = from_reference(scoring_system_sw_default())
    rng = np.random.default_rng(5)
    A, B = [_seq(rng, 100), _seq(rng, 61)], [_seq(rng, 50), _seq(rng, 70)]
    t, bp = _packed(sc, A, B)
    ac, bc, na, nb = t
    ca = chunk or ac.shape[1]
    for is_sw in (False, True):
        d, corner = dp.nw_fill_dirs_plain(*t, bp) if not is_sw else (
            dp.sw_fill_dirs_plain(*t, bp)[0], None)
        pc, _, slabs, mch, _, _ = dp.fill_chunked(*t, bp, is_sw=is_sw,
                                                  chunk=ca)
        slabs = torch.stack(slabs, 1)
        cap = int((na + nb).max())
        if not is_sw:
            assert torch.equal(pc, corner)
            for g, w in zip(nw_walk_plain(slabs, pc, na, nb, cap),
                            nw_walk_plain(d, corner, na, nb, cap)):
                assert torch.equal(g, w)
            for j in range(2):
                assert nw_traceback(A[j], B[j], int(na[j]), int(nb[j]),
                                    ChunkedDirs(slabs[j].numpy(), ca),
                                    pc[j].numpy()) == \
                    nw_traceback(A[j], B[j], int(na[j]), int(nb[j]),
                                 d[j].numpy(), corner[j].numpy())
            continue
        m = dp.sw_fill_dirs_plain(*t, bp)[1]
        f1, s1, o1 = dp.sw_sorted_candidates(m, na.numpy(), nb.numpy(), 1)
        f2, s2, o2 = dp.merge_candidates(
            [dp.sw_sorted_candidates(mc, na.numpy(), nb.numpy(), 1,
                                     x_off=c * ca)
             for c, mc in enumerate(mch)], 2)
        assert torch.equal(f1, f2) and torch.equal(s1, s2) and \
            torch.equal(o1, o2)
        for k in (1, 500):
            h1 = sw_hits_plain(d, ac, bc, na, nb, f1, s1, o1[:-1], o1[1:],
                               bp, k)
            h2 = sw_hits_plain(slabs, ac, bc, na, nb, f1, s1, o1[:-1],
                               o1[1:], bp, k)
            assert all(torch.equal(g, w) for g, w in zip(h1, h2))
        keep = torch.arange(500)[None, :] < h1[2][:, None]
        jw, slot = keep.nonzero(as_tuple=True)
        w = na[jw].long() + 1
        starts = [v.to(torch.int32) for v in (
            jw, h1[0][jw, slot] % w, h1[0][jw, slot] // w, h1[1][jw, slot])]
        assert torch.equal(sw_walk_plain(d, ac, bc, na, nb, *starts, bp, cap),
                           sw_walk_plain(slabs, ac, bc, na, nb, *starts, bp,
                                         cap))


def _sw_streams(its, k=None):
    return [[_key(h) for h in itertools.islice(it, k)] for it in its]


def test_host_branch_equals_device_branch(monkeypatch):
    """(f) The host branch, chosen by size (a device budget below one
    pair's slabs), walks the slabs on the host and gives the device
    branch's alignments and hit streams; the branch counts show both."""
    monkeypatch.setenv("SEQALIGN_FORCE", "device")
    monkeypatch.setattr(port_aligners, "LONG_PAIR_CELLS", 600)
    A, B = _mixed(7)
    nw, sw = NeedlemanWunsch(device="cpu"), SmithWaterman(device="cpu")
    dev0 = port_aligners.long_branch_counts()
    want_nw = nw.align_batch(A, B)
    want_sw = _sw_streams(sw.align_batch(A, B))
    dev1 = port_aligners.long_branch_counts()
    assert dev1["device"] > dev0["device"] and dev1["host"] == dev0["host"]
    monkeypatch.setattr(port_aligners, "LONG_DIRS_BUDGET", 1000)
    assert nw.align_batch(A, B) == want_nw
    its = sw.align_batch(A, B)
    assert _sw_streams(its) == want_sw
    dev2 = port_aligners.long_branch_counts()
    assert dev2["host"] > dev1["host"] and dev2["device"] == dev1["device"]
    long_its = [it for it, a, b in zip(its, A, B) if len(a) * len(b) > 600]
    assert long_its and all(
        isinstance(it, port_aligners.SwHitIterator) for it in long_its)


def test_ref_mask_compat_takes_the_host_branch(monkeypatch):
    """(f) Under ref_mask_compat the long pairs walk on the host with the
    shared mask: the streams equal the JAX package's under the same mode,
    and the first pair's (a fresh mask) the device branch's."""
    monkeypatch.setenv("SEQALIGN_FORCE", "device")
    monkeypatch.setattr(jax_aligners, "LONG_PAIR_CELLS", 600)
    monkeypatch.setattr(port_aligners, "LONG_PAIR_CELLS", 600)
    rng = np.random.default_rng(9)
    A = [_seq(rng, 60), _seq(rng, 45), _seq(rng, 70)]
    B = [_seq(rng, 40), _seq(rng, 50), _seq(rng, 30)]
    before = port_aligners.long_branch_counts()["host"]
    got = _sw_streams(SmithWaterman(device="cpu", ref_mask_compat=True)
                      .align_batch(A, B))
    assert port_aligners.long_branch_counts()["host"] == before + 3
    want = _sw_streams(jax_aligners.SmithWaterman(ref_mask_compat=True)
                       .align_batch(A, B))
    assert got == want
    fresh = _sw_streams(SmithWaterman(device="cpu").align_batch(A, B))
    assert got[0] == fresh[0]


def test_hintless_harvest_past_the_budget_takes_the_host_branch(
        monkeypatch):
    """(f) A hint-less SW pair whose slabs fit the device budget but whose
    harvest of every chunk does not takes the host branch, which moves
    each chunk's candidates to host memory: the stream equals the device
    branch's, and a hinted pair of that size stays on the device."""
    monkeypatch.setenv("SEQALIGN_FORCE", "device")
    monkeypatch.setattr(port_aligners, "LONG_PAIR_CELLS", 600)
    monkeypatch.setattr(port_aligners, "LONG_CHUNK", 16)
    rng = np.random.default_rng(11)
    core = _seq(rng, 24)
    A = [_seq(rng, 20) + core + _seq(rng, 20)]
    B = [_seq(rng, 6) + core + _seq(rng, 10)]
    sw = SmithWaterman(device="cpu")
    want = _sw_streams(sw.align_batch(A, B))
    hinted = _sw_streams(sw.align_batch(A, B, [10]))
    sc = from_reference(scoring_system_sw_default())
    ca = port_aligners._long_chunk(len(A[0]))
    slabs, dev, host = port_aligners._long_bytes(
        sc, len(A[0]), len(B[0]), ca, is_sw=True, hintless=True)
    budget = (slabs + dev) // 2
    assert slabs < budget < dev and host < dev
    monkeypatch.setattr(port_aligners, "LONG_DIRS_BUDGET", budget)
    before = port_aligners.long_branch_counts()
    its = sw.align_batch(A, B)
    mid = port_aligners.long_branch_counts()
    assert mid["host"] == before["host"] + 1
    assert mid["device"] == before["device"]
    assert isinstance(its[0], port_aligners.SwHitIterator)
    assert _sw_streams(its) == want
    assert _sw_streams(sw.align_batch(A, B, [10])) == hinted
    assert port_aligners.long_branch_counts()["device"] == \
        mid["device"] + 1


def test_long_sub_batches_follow_the_budget(monkeypatch):
    """Long sub-batches are sized by the device bytes of a pair (slabs,
    boundary columns) and grouped by (pow2 |a|, pow2 |b|); each fill runs
    one carry launch per chunk."""
    monkeypatch.setenv("SEQALIGN_FORCE", "device")
    monkeypatch.setattr(port_aligners, "LONG_PAIR_CELLS", 100)
    monkeypatch.setattr(port_aligners, "LONG_CHUNK", 16)
    sc = from_reference(scoring_system_default())
    rng = np.random.default_rng(2)
    A = [_seq(rng, n) for n in (40, 48, 50, 63, 100)]
    B = [_seq(rng, 30) for _ in A]
    assert port_aligners._long_chunk(63) == 16
    _, per_pair, _ = port_aligners._long_bytes(sc, 63, 30, 16, is_sw=False,
                                               hintless=False)
    monkeypatch.setattr(port_aligners, "LONG_DIRS_BUDGET", 2 * per_pair)
    launches = []
    real = kernels.nw_fill_dirs_carry

    def spy(ac, bc, na, nb, params, x_off, *rest):
        launches.append((ac.shape[0], x_off))
        return real(ac, bc, na, nb, params, x_off, *rest)

    monkeypatch.setattr(kernels, "nw_fill_dirs_carry", spy)
    got = NeedlemanWunsch(device="cpu").align_batch(A, B)
    # groups (64, 32): 4 pairs in sub-batches of 2, chunks of 16 over each
    # sub-batch's own |a| (48, then 63); (128, 32): 1 pair of 7 chunks of 15
    assert launches == [(2, 16 * c) for c in range(3)] + \
        [(2, 16 * c) for c in range(4)] + [(1, 15 * c) for c in range(7)]
    want = [jax_host.nw_align(scoring_system_default(), a, b)
            for a, b in zip(A, B)]
    assert [dataclasses.astuple(g) for g in got] == \
        [dataclasses.astuple(w) for w in want]


def test_default_chunks_are_balanced():
    """Without a chunk the long path takes the fewest chunks of at most
    LONG_CHUNK columns, of equal width."""
    L = port_aligners.LONG_CHUNK
    assert port_aligners._long_chunk(L) == L
    assert port_aligners._long_chunk(L + 1) == L // 2 + 1
    assert port_aligners._long_chunk(40_000) == 13_334
    assert port_aligners._long_chunk(40_000, 2048) == 2048
    with pytest.raises(ValueError):
        port_aligners._long_chunk(100, 0)


def test_flats_compose_in_int64_past_2_31():
    """(g) A chunk of a pair with na * nb > 2^31: the harvest composes
    flat = y * (na + 1) + x in int64, with global x, and the merge keeps
    the hit order; no fill needed (a made-up M slab)."""
    LB, ca = 40, 8
    na, nb = np.array([60_000_000]), np.array([LB])
    x_off = na[0] - ca
    m = torch.zeros((1, ca + LB - 1, LB + 1), dtype=torch.int32)
    cells = [(LB, ca, 7), (LB, 1, 7), (3, 5, 9), (LB - 1, ca, 2)]
    for y, xl, s in cells:
        m[0, xl + y - 2, y] = s
    flat, score, off = dp.sw_sorted_candidates(m, na, nb, 1, x_off=x_off)
    assert flat.dtype == torch.int64
    want = sorted(((y * (int(na[0]) + 1) + x_off + xl, s)
                   for y, xl, s in cells),
                  key=lambda fs: (-fs[1], fs[0] % (int(na[0]) + 1), fs[0]))
    assert list(zip(flat.tolist(), score.tolist())) == want
    assert max(flat.tolist()) > 2 ** 31 and off.tolist() == [0, 4]
    # an earlier chunk's candidates merge in front at equal score
    early = dp.sw_sorted_candidates(m, na, nb, 1, x_off=x_off - ca)
    f2, s2, o2 = dp.merge_candidates([early, (flat, score, off)], 1)
    w = int(na[0]) + 1
    keys = [(-s, f % w, f) for f, s in zip(f2.tolist(), s2.tolist())]
    assert keys == sorted(keys) and o2.tolist() == [0, 8]
    # and the hit records split them back into (x, y) without wrapping
    assert sorted((f % w, f // w) for f in flat.tolist()) == \
        sorted((x_off + xl, y) for y, xl, _ in cells)


@pytest.mark.parametrize("is_sw", [False, True], ids=["nw", "sw"])
def test_failed_carry_launch_raises(monkeypatch, is_sw):
    """(h) A carry launch that fails raises out of the aligner, once:
    no fallback path and no memo (test_pallas_long_fill_failure_memo
    without the memo)."""
    monkeypatch.setenv("SEQALIGN_FORCE", "device")
    monkeypatch.setattr(port_aligners, "LONG_PAIR_CELLS", 100)
    calls = []

    def boom(*a, **k):
        calls.append(1)
        raise RuntimeError("carry kernel launch failed")

    name = "sw_fill_dirs_carry" if is_sw else "nw_fill_dirs_carry"
    monkeypatch.setattr(kernels, name, boom)
    al = SmithWaterman(device="cpu") if is_sw else \
        NeedlemanWunsch(device="cpu")
    for attempt in range(2):
        with pytest.raises(RuntimeError, match="carry kernel"):
            al.align_batch(["acgt" * 10], ["ac" * 10])
        with pytest.raises(RuntimeError, match="carry kernel"):
            al.align_long("acgt", "ac", chunk=2)
        assert len(calls) == 2 * (attempt + 1)


def test_carry_wrappers_check_their_inputs():
    """The carry wrappers raise on what the kernel does not take."""
    sc = from_reference(scoring_system_default())
    t, bp = _packed(sc, ["acgtac"], ["acg"])
    bin = dp.boundary_column(bp, 1, 3, is_sw=False)
    bout = torch.empty_like(bin)
    dirs = torch.zeros((1, 4 + 3 - 1, 4), dtype=torch.uint8)
    corner = torch.zeros((1, 3), dtype=torch.int32)
    kernels.nw_fill_dirs_carry(*t, bp, 0, bin, bout, dirs, corner)
    with pytest.raises(ValueError, match="bin and bout"):
        kernels.nw_fill_dirs_carry(*t, bp, 0, bin[:, :, :3].contiguous(),
                                   bout, dirs, corner)
    with pytest.raises(ValueError, match="separate"):
        kernels.nw_fill_dirs_carry(*t, bp, 0, bin, bin, dirs, corner)
    with pytest.raises(ValueError, match="x_off"):
        kernels.nw_fill_dirs_carry(*t, bp, 6, bin, bout, dirs, corner)
    with pytest.raises(ValueError, match="slab"):
        kernels.nw_fill_dirs_carry(*t, bp, 0, bin, bout, dirs[:, :, :3],
                                   corner)
    with pytest.raises(ValueError, match="int32"):
        kernels.sw_fill_dirs_carry(*t, bp, 0, bin, bout, dirs,
                                   torch.zeros(1, dtype=torch.int64))
