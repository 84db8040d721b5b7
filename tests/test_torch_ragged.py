"""One fill launch across widths, on the CPU: the plain NW fill writing
each pair's codes in a plane at its own widths (``pack.ragged_planes``)
against the plain fill of each width bucket, plane by plane; ``nw_walk``
over those planes; the fill schedule; and NW ``align_batch`` /
``score_batch`` and SW ``best_score_batch`` on a batch of mixed widths,
each one launch, against the JAX package.  Tolerance 0: the DP is
integer."""

import dataclasses

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

import seqalign_tpu  # noqa: E402
from seqalign_tpu_torch import (NeedlemanWunsch, ScoringConfig,  # noqa: E402
                                SmithWaterman, kernel_params,
                                scoring_system_BLOSUM62,
                                scoring_system_default)
from seqalign_tpu_torch import aligners as port_aligners  # noqa: E402
from seqalign_tpu_torch.ops import kernels  # noqa: E402
from seqalign_tpu_torch.ops.dp import nw_fill_dirs_plain  # noqa: E402
from seqalign_tpu_torch.ops.pack import (pack_batch, pad_width,  # noqa: E402
                                         ragged_planes)
from seqalign_tpu_torch.ops.traceback import nw_walk_plain  # noqa: E402

DNA = "acgtACGT"
PROTEIN = "ARNDCQEGHILKMFPSTWYV"
# name -> (port config, JAX config, alphabet)
CONFIGS = {
    "default": (scoring_system_default,
                seqalign_tpu.scoring_system_default, DNA),
    "nsg+neg+nga": (
        lambda: ScoringConfig(1, -2, -4, -1, no_start_gap_penalty=True,
                              no_end_gap_penalty=True, no_gaps_in_a=True),
        lambda: seqalign_tpu.ScoringConfig(
            1, -2, -4, -1, no_start_gap_penalty=True,
            no_end_gap_penalty=True, no_gaps_in_a=True), DNA),
    "blosum62": (scoring_system_BLOSUM62,
                 seqalign_tpu.scoring_system_BLOSUM62, PROTEIN),
}


def _text(seed, alpha, n, lo, hi):
    rng = np.random.default_rng(seed)
    letters = np.array(list(alpha))
    return ["".join(letters[rng.integers(0, len(letters), int(k))])
            for k in rng.integers(lo, hi + 1, n)]


def _mixed(seed, alpha, n=12, hi=150):
    """A batch of mixed widths, an empty seq_a and an empty seq_b among
    them."""
    A, B = _text(seed, alpha, n, 1, hi), _text(seed + 1, alpha, n, 1, hi)
    A[3], B[7] = "", ""
    return A, B


def _packed(sc, A, B, la, lb):
    ac, bc, na, nb, bp = pack_batch(sc, kernel_params(sc, "cpu"), A, B, la,
                                    lb)
    return [torch.from_numpy(v) for v in (ac, bc, na, nb)], bp


def test_ragged_planes_layout():
    off = ragged_planes([3, 0, 5], [2, 4, 0])
    # (wa + wb - 1) * (wb + 1), sides floored at 1
    assert off.tolist() == [0, 4 * 3, 12 + 4 * 5, 32 + 5 * 2]
    assert ragged_planes([], []).tolist() == [0]
    LA, LB = 7, 5
    uni = ragged_planes([LA] * 3, [LB] * 3)
    assert uni.tolist() == [j * (LA + LB - 1) * (LB + 1) for j in range(4)]


@pytest.mark.parametrize("name", list(CONFIGS))
def test_ragged_plain_fill_equals_bucket_fills(name):
    """Each pair's plane of the one fill across widths holds, on its valid
    cells, the codes the plain fill of its own width bucket gives; the
    corners agree too."""
    make, _, alpha = CONFIGS[name]
    sc = make()
    A, B = _mixed(11, alpha)
    la, lb = max(map(len, A)), max(map(len, B))
    t, bp = _packed(sc, A, B, la, lb)
    na, nb = t[2].numpy(), t[3].numpy()
    off = torch.from_numpy(ragged_planes(na, nb))
    flat, corner = nw_fill_dirs_plain(*t, bp, off)
    assert flat.dim() == 1 and flat.shape[0] == int(off[-1])
    buckets = {}
    for j, (a, b) in enumerate(zip(A, B)):
        buckets.setdefault((pad_width(max(1, len(a))),
                            pad_width(max(1, len(b)))), []).append(j)
    assert len(buckets) >= 3
    for (wa, wb), idx in buckets.items():
        tb, bpb = _packed(sc, [A[j] for j in idx], [B[j] for j in idx], wa,
                          wb)
        d, c = nw_fill_dirs_plain(*tb, bpb)
        assert torch.equal(c, corner[idx])
        for i, j in enumerate(idx):
            n_a, n_b = int(na[j]), int(nb[j])
            lanes = max(n_b, 1) + 1
            plane = flat[off[j]:off[j + 1]].view(-1, lanes)
            for x in range(1, n_a + 1):
                y = torch.arange(1, n_b + 1)
                assert torch.equal(plane[x + y - 2, y], d[i, x + y - 2, y])


def test_nw_walk_plain_on_ragged_planes():
    """The walk over the planes at each pair's widths equals the walk over
    the uniform plane of the same fill."""
    sc = scoring_system_default()
    A, B = _mixed(21, DNA)
    t, bp = _packed(sc, A, B, max(map(len, A)), max(map(len, B)))
    off = torch.from_numpy(ragged_planes(t[2].numpy(), t[3].numpy()))
    flat, corner = nw_fill_dirs_plain(*t, bp, off)
    d, c = nw_fill_dirs_plain(*t, bp)
    cap = int((t[2] + t[3]).max())
    got = nw_walk_plain(flat, corner, t[2], t[3], cap, off)
    want = nw_walk_plain(d, c, t[2], t[3], cap)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert all(torch.equal(g, w) for g, w in zip(
        got, kernels.nw_walk(flat, corner, t[2], t[3], cap, off)))


def test_fill_schedule():
    """Blocks take the pairs by cells, largest first (ties in pair
    order); a pair whose b passes one round of the tiles
    (``kernels.TILE_LANES`` lanes) takes a round row of scratch, in pair
    order; the planes are ``ragged_planes``."""
    na, nb = np.array([10, 300, 0, 300, 50]), np.array([20, 100, 9, 100, 80])
    s = kernels.fill_schedule(na, nb, "cpu", planes=True)
    assert s.order.tolist() == [1, 3, 4, 0, 2]
    assert s.wrap.tolist() == [-1] * 5 and s.nwrap == 0
    assert s.off.tolist() == ragged_planes(na, nb).tolist()
    assert s.total == int(ragged_planes(na, nb)[-1])
    s = kernels.fill_schedule(na, nb + [0, kernels.TILE_LANES, 0,
                                        kernels.TILE_LANES, 0], "cpu")
    assert s.off is None and s.total == 0
    assert s.order.tolist() == [1, 3, 4, 0, 2]
    assert s.wrap.tolist() == [-1, 0, -1, 1, -1] and s.nwrap == 2


@pytest.fixture
def mixed_widths():
    """40 DNA pairs of 1-400 bp over at least four width buckets."""
    A, B = _text(31, DNA, 40, 1, 400), _text(32, DNA, 40, 1, 400)
    keys = {(max(64, pad_width(len(a))), max(64, pad_width(len(b))))
            for a, b in zip(A, B)}
    assert len(keys) >= 4
    return A, B


def _count_calls(monkeypatch, name):
    calls = []
    real = getattr(kernels, name)

    def spy(*args, **kw):
        calls.append(args[0].shape[0])
        return real(*args, **kw)

    monkeypatch.setattr(kernels, name, spy)
    return calls


def test_mixed_widths_nw_align_batch_vs_jax(monkeypatch, mixed_widths):
    A, B = mixed_widths
    monkeypatch.setenv("SEQALIGN_FORCE", "host")
    want = seqalign_tpu.NeedlemanWunsch().align_batch(A, B)
    monkeypatch.setenv("SEQALIGN_FORCE", "device")
    fills = _count_calls(monkeypatch, "nw_fill_dirs")
    walks = _count_calls(monkeypatch, "nw_walk")
    got = NeedlemanWunsch(device="cpu").align_batch(A, B)
    assert fills == [40] and len(walks) == 1
    assert [dataclasses.astuple(g) for g in got] == \
        [dataclasses.astuple(w) for w in want]


@pytest.mark.parametrize("is_sw", [False, True], ids=["nw", "sw"])
def test_mixed_widths_scores_vs_jax(monkeypatch, mixed_widths, is_sw):
    A, B = mixed_widths
    monkeypatch.setenv("SEQALIGN_FORCE", "host")
    if is_sw:
        want = seqalign_tpu.SmithWaterman().best_score_batch(A, B)
    else:
        want = seqalign_tpu.NeedlemanWunsch().score_batch(A, B)
    monkeypatch.setenv("SEQALIGN_FORCE", "device")
    calls = _count_calls(monkeypatch, "sw_scores" if is_sw else "nw_scores")
    if is_sw:
        got = SmithWaterman(device="cpu").best_score_batch(A, B)
    else:
        got = NeedlemanWunsch(device="cpu").score_batch(A, B)
    assert calls == [40]
    np.testing.assert_array_equal(got, want)


def test_mixed_widths_blosum62_align_vs_jax(monkeypatch):
    """The table mode across widths, with empty sides."""
    A, B = _mixed(41, PROTEIN, n=10, hi=120)
    monkeypatch.setenv("SEQALIGN_FORCE", "host")
    want = seqalign_tpu.NeedlemanWunsch(
        seqalign_tpu.scoring_system_BLOSUM62()).align_batch(A, B)
    monkeypatch.setenv("SEQALIGN_FORCE", "device")
    got = NeedlemanWunsch(scoring_system_BLOSUM62(),
                          device="cpu").align_batch(A, B)
    assert [dataclasses.astuple(g) for g in got] == \
        [dataclasses.astuple(w) for w in want]
