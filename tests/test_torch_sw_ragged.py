"""SW alignment as one fill launch across widths, on the CPU: the plain SW
fill writing each pair's codes and M in planes at its own widths
(``pack.ragged_planes``) against the plain fill of each width bucket; the
harvest of those planes (whose pad cells the fill leaves at 0) against the
bucket harvest, the bucket's pad cells set to large values included; ``sw_hits_plain`` and ``sw_walk_plain`` over them; the
sub-batch sizing; and SW ``align_batch`` and ``lcs_hits`` on batches of
mixed widths against the JAX package's hit streams.  Tolerance 0: the DP
is integer."""

import dataclasses
import itertools

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

import seqalign_tpu  # noqa: E402
from seqalign_tpu import aligners as jax_aligners  # noqa: E402
from seqalign_tpu_torch import (ScoringConfig, SmithWaterman,  # noqa: E402
                                kernel_params, lcs_aligner, lcs_hits,
                                scoring_system_BLOSUM62,
                                scoring_system_sw_default)
from seqalign_tpu_torch import aligners as port_aligners  # noqa: E402
from seqalign_tpu_torch.ops import kernels  # noqa: E402
from seqalign_tpu_torch.ops.dp import (sw_fill_dirs_plain,  # noqa: E402
                                       sw_sorted_candidates)
from seqalign_tpu_torch.ops.pack import (m16_safe, pack_batch,  # noqa: E402
                                         pad_width, ragged_planes)
from seqalign_tpu_torch.ops.traceback import (sw_hits_plain,  # noqa: E402
                                              sw_walk_plain)

DNA = "acgtACGT"
PROTEIN = "ARNDCQEGHILKMFPSTWYV"
# name -> (port config, JAX config, alphabet)
CONFIGS = {
    "sw_default": (scoring_system_sw_default,
                   seqalign_tpu.scoring_system_sw_default, DNA),
    "lcs": (lambda: lcs_aligner(device="cpu").scoring,
            lambda: jax_aligners.lcs_aligner().scoring, DNA),
    "blosum62": (scoring_system_BLOSUM62,
                 seqalign_tpu.scoring_system_BLOSUM62, PROTEIN),
}


def _text(seed, alpha, n, lo, hi):
    rng = np.random.default_rng(seed)
    letters = np.array(list(alpha))
    return ["".join(letters[rng.integers(0, len(letters), int(k))])
            for k in rng.integers(lo, hi + 1, n)]


def _mixed(seed, alpha, n=12, hi=150):
    """A batch of mixed widths with an empty seq_a and an empty seq_b, and
    a pair whose b is a's reverse and a copy of its first half, so that
    the LCS flags find repeats."""
    A, B = _text(seed, alpha, n, 1, hi), _text(seed + 1, alpha, n, 1, hi)
    A[3], B[7] = "", ""
    B[0] = A[0][::-1] + A[0][:len(A[0]) // 2]
    return A, B


def _packed(sc, A, B, la, lb):
    ac, bc, na, nb, bp = pack_batch(sc, kernel_params(sc, "cpu"), A, B, la,
                                    lb)
    return [torch.from_numpy(v) for v in (ac, bc, na, nb)], bp


def _buckets(A, B):
    groups = {}
    for j, (a, b) in enumerate(zip(A, B)):
        groups.setdefault((pad_width(max(1, len(a))),
                           pad_width(max(1, len(b)))), []).append(j)
    return groups


def _ragged(sc, A, B, m16):
    """The plain fill across widths: (tensors, params, off, dirs, M)."""
    t, bp = _packed(sc, A, B, max(1, max(map(len, A))),
                    max(1, max(map(len, B))))
    off = torch.from_numpy(ragged_planes(t[2].numpy(), t[3].numpy()))
    dirs, m = sw_fill_dirs_plain(*t, bp, m16, off)
    return t, bp, off, dirs, m


def _set_pads(flat, na, nb, off, value):
    """A copy of the 1-d planes with every cell that is not a valid cell
    of its pair set to ``value``."""
    out = flat.clone()
    for j, (n_a, n_b) in enumerate(zip(na.tolist(), nb.tolist())):
        lanes = max(n_b, 1) + 1
        plane = out[off[j]:off[j + 1]].view(-1, lanes)
        y = torch.arange(lanes)[None, :]
        x = torch.arange(plane.shape[0])[:, None] + 2 - y
        valid = (y >= 1) & (y <= n_b) & (x >= 1) & (x <= n_a)
        plane[~valid] = value
    return out


@pytest.mark.parametrize("m16", [True, False], ids=["int16", "int32"])
@pytest.mark.parametrize("name", list(CONFIGS))
def test_ragged_plain_sw_fill_equals_bucket_fills(name, m16):
    """Each pair's planes of the one SW fill across widths hold, on its
    valid cells, the codes and M the plain fill of its own width bucket
    gives, in int16 and in int32."""
    make, _, alpha = CONFIGS[name]
    sc = make()
    A, B = _mixed(11, alpha)
    assert m16_safe(sc, 150, 150)
    t, _, off, dirs, m = _ragged(sc, A, B, m16)
    assert dirs.dim() == m.dim() == 1
    assert dirs.shape[0] == m.shape[0] == int(off[-1])
    assert m.dtype == (torch.int16 if m16 else torch.int32)
    na, nb = t[2].numpy(), t[3].numpy()
    groups = _buckets(A, B)
    assert len(groups) >= 3
    for (wa, wb), idx in groups.items():
        tb, bpb = _packed(sc, [A[j] for j in idx], [B[j] for j in idx], wa,
                          wb)
        d, mb = sw_fill_dirs_plain(*tb, bpb, m16)
        for i, j in enumerate(idx):
            lanes = max(int(nb[j]), 1) + 1
            dp_, mp = (v[off[j]:off[j + 1]].view(-1, lanes)
                       for v in (dirs, m))
            y = torch.arange(1, int(nb[j]) + 1)
            for x in range(1, int(na[j]) + 1):
                assert torch.equal(dp_[x + y - 2, y], d[i, x + y - 2, y])
                assert torch.equal(mp[x + y - 2, y], mb[i, x + y - 2, y])


@pytest.mark.parametrize("pad", [0, "large"])
@pytest.mark.parametrize("name", list(CONFIGS))
def test_ragged_harvest_equals_bucket_harvest(name, pad):
    """The harvest of the planes across widths gives each pair the flats,
    scores and order the harvest of its width bucket gives, hint-less and
    at a per-pair hint.  The planes' cells that are no valid cell of their
    pair hold 0, below every threshold; with every pad cell of the bucket
    M set to the type's largest value none of them becomes a candidate."""
    make, _, alpha = CONFIGS[name]
    sc = make()
    A, B = _mixed(13, alpha, n=10, hi=120)
    for m16 in (True, False):
        t, _, off, _, m = _ragged(sc, A, B, m16)
        na, nb = t[2].numpy(), t[3].numpy()
        assert torch.equal(m, _set_pads(m, t[2], t[3], off.tolist(), 0))
        buckets = []
        for (wa, wb), idx in _buckets(A, B).items():
            tb, bpb = _packed(sc, [A[j] for j in idx], [B[j] for j in idx],
                              wa, wb)
            mb = sw_fill_dirs_plain(*tb, bpb, m16)[1]
            if pad:
                _, D, LBp = mb.shape
                r = torch.arange(D)[None, :, None]
                y = torch.arange(LBp)[None, None, :]
                na_b, nb_b = (v.long()[:, None, None] for v in tb[2:4])
                mb = mb.masked_fill(~((y >= 1) & (y <= nb_b) & (r >= y - 1)
                                      & (r <= y - 2 + na_b)),
                                    torch.iinfo(mb.dtype).max)
            buckets.append((idx, tb, mb))
        for mins in (1, [1 + (j % 4) for j in range(len(A))]):
            flat, score, offs = sw_sorted_candidates(m, na, nb, mins,
                                                     off=off)
            assert flat.dtype == torch.int32
            counts = (offs[1:] - offs[:-1]).tolist()
            assert counts[3] == counts[7] == 0  # the empty sides
            for idx, tb, mb in buckets:
                thr = mins if mins == 1 else [mins[j] for j in idx]
                fb, sb, ob = sw_sorted_candidates(mb, tb[2].numpy(),
                                                  tb[3].numpy(), thr)
                for i, j in enumerate(idx):
                    s, e = int(offs[j]), int(offs[j + 1])
                    bs, be = int(ob[i]), int(ob[i + 1])
                    assert torch.equal(flat[s:e], fb[bs:be])
                    assert torch.equal(score[s:e], sb[bs:be])


@pytest.mark.parametrize("name", list(CONFIGS))
def test_plain_hits_and_walks_on_ragged_planes(name):
    """``sw_hits_plain`` and ``sw_walk_plain`` over the planes across
    widths (pad codes set to DIR_FAIL bytes) equal them over the uniform
    planes of the same fill, and the wrappers take the planes with their
    offsets."""
    make, _, alpha = CONFIGS[name]
    sc = make()
    A, B = _mixed(17, alpha, n=10, hi=90)
    t, bp, off, dirs, m = _ragged(sc, A, B, True)
    dirs = _set_pads(dirs, t[2], t[3], off.tolist(), 0xff)
    na, nb = t[2].numpy(), t[3].numpy()
    d_u, m_u = sw_fill_dirs_plain(*t, bp, True)
    flat, score, offs = sw_sorted_candidates(m, na, nb, 1, off=off)
    for k in (1, 16, 10_000):
        args = (*t, flat, score, offs[:-1], offs[1:], bp, k)
        got = sw_hits_plain(dirs, *args, off)
        want = sw_hits_plain(d_u, *args)
        assert all(torch.equal(g, w) for g, w in zip(got, want))
        wrapped = kernels.sw_hits(dirs, *args, off)
        assert all(torch.equal(g, w) for g, w in zip(wrapped, want))
    hit_flat, hit_score, nhits = want
    jw, slot = np.nonzero(np.arange(hit_flat.shape[1])[None, :]
                          < nhits.numpy()[:, None])
    assert len(jw) > 10
    flats = hit_flat.numpy()[jw, slot].astype(np.int64)
    w = na[jw].astype(np.int64) + 1
    starts = [torch.from_numpy(v.astype(np.int32)) for v in
              (jw, flats % w, flats // w, hit_score.numpy()[jw, slot])]
    cap = int((na + nb).max())
    got = sw_walk_plain(dirs, t[0], t[1], t[2], t[3], *starts, bp, cap, off)
    want = sw_walk_plain(d_u, t[0], t[1], t[2], t[3], *starts, bp, cap)
    assert torch.equal(got, want)
    assert torch.equal(kernels.sw_walk(dirs, t[0], t[1], t[2], t[3],
                                       *starts, bp, cap, off), want)
    with pytest.raises(ValueError):
        kernels.sw_walk(dirs, t[0], t[1], t[2], t[3], *starts, bp, cap,
                        off[:-1])
    short = off.clone()
    short[2] = short[1]  # pair 1's plane cut to nothing
    with pytest.raises(ValueError):
        kernels.sw_hits(dirs, *args[:-1], 16, short)
    with pytest.raises(ValueError):
        kernels.sw_walk(dirs[:-1], t[0], t[1], t[2], t[3], *starts, bp, cap,
                        off)


def test_hits_masks_place_each_pair():
    """A pair's mask of (nb+1)(na+1) bits sits in shared memory when it
    fits the block's words, the largest mask that fits the bytes given;
    the others take their own words of the global buffer."""
    na = torch.tensor([10, 300, 0, 40], dtype=torch.int32)
    nb = torch.tensor([20, 100, 9, 50], dtype=torch.int32)
    words = [-(-(a + 1) * (b + 1) // 32) for a, b in zip(na.tolist(),
                                                         nb.tolist())]
    block, moff = kernels.hits_masks(na, nb, 4 * words[3])
    assert block == words[3]
    assert moff.tolist() == [0, 0, words[1], words[1], words[1]]
    block, moff = kernels.hits_masks(na, nb, 0)
    assert block == 0 and moff.tolist() == [0, *np.cumsum(words).tolist()]


def test_sw_sub_batch_sizing():
    """A pair's bytes at its own widths: codes, M and the harvest's mask a
    cell of its plane, the hit mask a bit a cell, and a hint-less
    harvest; the budget off the card is ALIGN_DIRS_BUDGET."""
    plane = (30 + 20 - 1) * (20 + 1)
    bits = 31 * 21 // 8
    assert port_aligners._sw_pair_bytes(30, 20, 2, False) == \
        plane * 4 + bits
    assert port_aligners._sw_pair_bytes(30, 20, 4, False) == \
        plane * 6 + bits
    harvest = int(port_aligners._HARVEST_BYTES
                  * port_aligners._HARVEST_SHARE * 30 * 20)
    assert port_aligners._sw_pair_bytes(30, 20, 2, True) == \
        plane * 4 + bits + harvest
    # an empty side keeps a plane of one column or one lane
    assert port_aligners._sw_pair_bytes(0, 5, 2, True) == \
        (1 + 5 - 1) * 6 * 4 + 6 // 8
    assert port_aligners._align_budget(torch.device("cpu")) == \
        port_aligners.ALIGN_DIRS_BUDGET
    subs = port_aligners._plane_subbatches(range(5), 10, lambda i: 4)
    assert subs == [[0, 1], [2, 3], [4]]
    assert port_aligners._plane_subbatches([7], 1, lambda i: 4) == [[7]]


def test_sw_align_takes_the_budget_from_align_budget(monkeypatch):
    """SW align_batch cuts its sub-batches by ``_align_budget`` of its
    device, one fill launch across widths each."""
    monkeypatch.setenv("SEQALIGN_FORCE", "device")
    sc = scoring_system_sw_default()
    A, B = _text(61, DNA, 6, 20, 60), _text(62, DNA, 6, 20, 60)
    held = [port_aligners._sw_pair_bytes(len(a), len(b), 2, False)
            for a, b in zip(A, B)]
    seen = []
    monkeypatch.setattr(port_aligners, "_align_budget",
                        lambda dev: seen.append(dev) or max(held))
    fills = []
    real = kernels.sw_fill_dirs

    def spy(ac, bc, na, nb, params, m16, sched=None):
        fills.append((ac.shape[0], sched is not None))
        return real(ac, bc, na, nb, params, m16, sched)

    monkeypatch.setattr(kernels, "sw_fill_dirs", spy)
    its = SmithWaterman(sc, device="cpu").align_batch(A, B, [5] * 6)
    assert seen == [torch.device("cpu")]
    assert [n for n, _ in fills] == [1] * 6 and all(s for _, s in fills)
    want = [[h for h in seqalign_tpu.SmithWaterman(
        seqalign_tpu.scoring_system_sw_default()).align(a, b, 5)]
        for a, b in zip(A, B)]
    assert _streams(its) == _streams(want)


def _streams(its, k=None):
    return [[dataclasses.astuple(h) for h in itertools.islice(it, k)]
            for it in its]


@pytest.fixture(scope="module")
def mixed_sw():
    """40 DNA pairs of 1-700 bp over at least four width buckets, an
    empty seq_a and seq_b among them, and a hint for each pair."""
    A, B = _text(71, DNA, 40, 1, 700), _text(72, DNA, 40, 1, 700)
    A[5], B[9] = "", ""
    assert len(_buckets(A, B)) >= 4
    return A, B, [1 + (j % 3) * 6 for j in range(40)]


def _jax_streams(A, B, mins, k, deep, **kw):
    """The JAX package's streams on its host route: the first ``k`` hits
    of every pair, and of the pairs ``deep`` the first ``DEEP``; with
    ``mins``, of the hits at or above the pair's hint (the hint may prune
    the hits below it, smith_waterman's candidates being taken best
    first, and leaves the others exact)."""
    sw = seqalign_tpu.SmithWaterman(seqalign_tpu.scoring_system_sw_default(),
                                    **kw)
    its = sw.align_batch(A, B, mins)
    return [_streams([(h for h in it
                       if mins is None or h.score >= mins[j])],
                     DEEP if j in deep else k)[0]
            for j, it in enumerate(its)]


DEEP = 40  # hits of a deep consumer: past the first round's 16


@pytest.mark.parametrize("hint", [False, True], ids=["hintless", "hint"])
def test_mixed_widths_sw_align_batch_vs_jax(monkeypatch, mixed_sw, hint):
    """SW align_batch over mixed widths is one fill launch, one ``sw_hits``
    and one ``sw_walk`` launch across widths for the first 16 hits of
    every pair; the streams, and a few pairs' streams past them (a deeper
    round), equal the JAX package's."""
    A, B, mins = mixed_sw
    mins = mins if hint else None
    deep = {0, 17, 33}
    monkeypatch.setenv("SEQALIGN_FORCE", "host")
    want = _jax_streams(A, B, mins, 16, deep)
    monkeypatch.setenv("SEQALIGN_FORCE", "device")
    calls = {}
    for name in ("sw_fill_dirs", "sw_hits", "sw_walk"):
        real = getattr(kernels, name)

        def spy(*args, _real=real, _name=name, **kw):
            calls.setdefault(_name, []).append(
                args[0].shape[0] if _name == "sw_fill_dirs" else
                args[-1] is not None)
            return _real(*args, **kw)

        monkeypatch.setattr(kernels, name, spy)
    its = SmithWaterman(device="cpu").align_batch(A, B, mins)
    assert calls == {"sw_fill_dirs": [40], "sw_hits": [True],
                     "sw_walk": [True]}
    got = [_streams([it], DEEP if j in deep else 16)[0]
           for j, it in enumerate(its)]
    assert got == want
    assert max(len(want[j]) for j in deep) > 16
    assert len(calls["sw_fill_dirs"]) > 1  # the deeper rounds refilled


def test_mixed_widths_ref_mask_compat_vs_jax(monkeypatch, mixed_sw):
    """Under ref_mask_compat every pair of the launch across widths walks
    on the host over its own plane, with the shared mask: the streams,
    consumed in pair order, equal the JAX package's."""
    A, B, mins = mixed_sw
    A, B, mins = A[:16], B[:16], mins[:16]
    monkeypatch.setenv("SEQALIGN_FORCE", "host")
    want = _jax_streams(A, B, mins, 8, (), ref_mask_compat=True)
    monkeypatch.setenv("SEQALIGN_FORCE", "device")
    fills = []
    real = kernels.sw_fill_dirs
    monkeypatch.setattr(kernels, "sw_fill_dirs", lambda *a: fills.append(
        a[0].shape[0]) or real(*a))
    got = _streams(SmithWaterman(device="cpu", ref_mask_compat=True)
                   .align_batch(A, B, mins), 8)
    assert fills == [16]
    assert got == want


def test_lcs_hits_on_mixed_widths_vs_jax(monkeypatch):
    """The LCS recipe (nga+ngb+nmm) on sequences of mixed lengths, each
    against itself, in one align_batch across widths and through
    ``lcs_hits``, against the JAX package's ``lcs_hits``."""
    monkeypatch.setenv("SEQALIGN_FORCE", "device")
    rng = np.random.default_rng(81)
    seqs = []
    for n in (40, 90, 150, 300, 7, 0):
        s = "".join(rng.choice(list("acgt"), n))
        if n > 20:  # plant a repeat
            s = s[: n // 2] + s[: n // 4] + s[n // 2 + n // 4:]
        seqs.append(s)
    monkeypatch.setenv("SEQALIGN_FORCE", "host")
    want = [[dataclasses.astuple(h) for h in jax_aligners.lcs_hits(s)]
            for s in seqs]
    monkeypatch.setenv("SEQALIGN_FORCE", "device")
    assert sum(map(len, want)) > 20
    sw = lcs_aligner(device="cpu")
    fills = []
    real = kernels.sw_fill_dirs
    monkeypatch.setattr(kernels, "sw_fill_dirs", lambda *a: fills.append(
        a[0].shape[0]) or real(*a))
    its = sw.align_batch(seqs, seqs)
    assert fills[0] == len(seqs)
    got = [[dataclasses.astuple(h) for h in it if h.pos_a < h.pos_b]
           for it in its]
    assert got == want
    assert [[dataclasses.astuple(h) for h in lcs_hits(s, sw=sw)]
            for s in seqs[:3]] == want[:3]


def test_blosum62_and_empty_sides_across_widths_vs_jax(monkeypatch):
    """The table mode across widths, and int32 M (scores past the int16
    gate), empty sides included."""
    sc = ScoringConfig(300, -200, -10, -1)
    jsc = seqalign_tpu.ScoringConfig(300, -200, -10, -1)
    A, B = _mixed(91, DNA, n=10, hi=120)
    assert not m16_safe(sc, 120, 120)
    for port_sc, jax_sc in ((scoring_system_BLOSUM62(),
                             seqalign_tpu.scoring_system_BLOSUM62()),
                            (sc, jsc)):
        if port_sc is not sc:
            A, B = _mixed(93, PROTEIN, n=10, hi=120)
        monkeypatch.setenv("SEQALIGN_FORCE", "host")
        want = _streams(seqalign_tpu.SmithWaterman(jax_sc).align_batch(A, B),
                        12)
        monkeypatch.setenv("SEQALIGN_FORCE", "device")
        got = _streams(SmithWaterman(port_sc, device="cpu").align_batch(A, B),
                       12)
        assert got == want
