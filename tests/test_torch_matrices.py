"""The matrix dump (``--printmatrices``): NW and SW ``align_with_matrices``
of the port against the JAX package's, cell by cell, on both packages'
device paths (``SEQALIGN_FORCE=device``: the port's plain GAB fills, the
JAX package's ``dp_fill(emit_gab=True)``), for every flag combination of
``tests/test_torch_modes.py``, equality and BLOSUM62 scoring, pairs up to
64 x 48 and pairs with an empty side; and the device route against the
port's own host route.  Integer DP: every compare is exact."""

import dataclasses

import numpy as np
import pytest
import torch

pytest.importorskip("jax.numpy")

import seqalign_tpu  # noqa: E402
from seqalign_tpu.ops import dp  # noqa: E402
from seqalign_tpu.scoring.config import ScoringConfig  # noqa: E402
from seqalign_tpu.scoring.presets import scoring_system_BLOSUM62  # noqa: E402
from seqalign_tpu_torch import (NeedlemanWunsch, SmithWaterman,  # noqa: E402
                                kernel_params)
from seqalign_tpu_torch.ops import kernels  # noqa: E402
from seqalign_tpu_torch.ops import pack as tpack  # noqa: E402
from seqalign_tpu_torch.ops.dp import deskew  # noqa: E402

DNA = "acgtACGT"
PROTEIN = "ARNDCQEGHILKMFPSTWYV"
MODES = {
    "default": dict(),
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


def _config(mode, scoring, sw):
    if scoring == "table":
        sc = scoring_system_BLOSUM62()
        for k, v in MODES[mode].items():
            setattr(sc, k, v)
        if mode == "gap_open_pos":
            sc.gap_open = 1
        sc._luts = None
        return sc
    if mode == "gap_open_pos":
        return ScoringConfig(2, -3, 1, -1)
    if sw:
        return ScoringConfig(2, -2, -3, -1, **MODES[mode])
    return ScoringConfig(1, -2, -4, -1, **MODES[mode])


def _pairs(mode, alpha):
    """A 64 x 48 pair with a shared stretch, and one with an empty side
    (seq_a or seq_b by mode)."""
    rng = np.random.default_rng(sum(map(ord, mode)))
    letters = np.array(list(alpha))
    a = "".join(letters[rng.integers(0, len(letters), 64)])
    b = "".join(letters[rng.integers(0, len(letters), 48)])
    b = b[:10] + a[20:40] + b[30:]
    short = "".join(letters[rng.integers(0, len(letters), 17)])
    empty = ("", short) if len(mode) % 2 else (short, "")
    return [(a, b), empty]


def _same(mats, want):
    assert len(mats) == 3
    for got, ref in zip(mats, want):
        assert got.shape == ref.shape
        np.testing.assert_array_equal(got, np.asarray(ref))


@pytest.fixture
def device_path(monkeypatch):
    monkeypatch.setenv("SEQALIGN_FORCE", "device")


@pytest.mark.parametrize("scoring", ["equality", "table"])
@pytest.mark.parametrize("mode", list(MODES))
def test_nw_matrices_vs_jax(device_path, mode, scoring):
    sc = _config(mode, scoring, False)
    port = NeedlemanWunsch(sc, device="cpu")
    ref = seqalign_tpu.NeedlemanWunsch(sc)
    for a, b in _pairs(mode, PROTEIN if scoring == "table" else DNA):
        aln, mats = port.align_with_matrices(a, b)
        jaln, jmats = ref.align_with_matrices(a, b)
        assert dataclasses.astuple(aln) == dataclasses.astuple(jaln)
        _same(mats, jmats)
        _same(port.matrices(a, b), jmats)


@pytest.mark.parametrize("scoring", ["equality", "table"])
@pytest.mark.parametrize("mode", list(MODES))
def test_sw_matrices_vs_jax(device_path, mode, scoring):
    sc = _config(mode, scoring, True)
    port = SmithWaterman(sc, device="cpu")
    ref = seqalign_tpu.SmithWaterman(sc)
    for a, b in _pairs(mode, PROTEIN if scoring == "table" else DNA):
        hits, mats = port.align_with_matrices(a, b)
        jhits, jmats = ref.align_with_matrices(a, b)
        assert [dataclasses.astuple(h) for h in hits] == \
            [dataclasses.astuple(h) for h in jhits]
        _same(mats, jmats)


@pytest.mark.parametrize("sw", [False, True], ids=["nw", "sw"])
@pytest.mark.parametrize("mode", list(MODES))
def test_device_route_equals_host_route(monkeypatch, mode, sw):
    """The port's device route (the GAB fill) against its host route
    (``host_dp``) on the same pairs: the same matrices and results (NW
    configs in the sentinel-wrap regime take the host route either
    way)."""
    sc = _config(mode, "equality", sw)
    cls = SmithWaterman if sw else NeedlemanWunsch
    for a, b in _pairs(mode, DNA):
        monkeypatch.setenv("SEQALIGN_FORCE", "device")
        got, gmats = cls(sc, device="cpu").align_with_matrices(a, b)
        monkeypatch.setenv("SEQALIGN_FORCE", "host")
        want, wmats = cls(sc, device="cpu").align_with_matrices(a, b)
        _same(gmats, wmats)
        if sw:
            got, want = list(got), list(want)
            assert [dataclasses.astuple(h) for h in got] == \
                [dataclasses.astuple(h) for h in want]
        else:
            assert dataclasses.astuple(got) == dataclasses.astuple(want)


@pytest.mark.parametrize("sw", [False, True], ids=["nw", "sw"])
@pytest.mark.parametrize("mode", list(MODES))
def test_gab_plain_planes_vs_dp_fill(mode, sw):
    """The plain GAB fill's planes on a ragged batch with empty sides
    against ``dp.fill_batch(emit_gab=True)`` on every valid cell, with the
    codes and (SW) M of the dirs fills beside them; the NW configs of the
    sentinel-wrap regime too, whose int32 sums wrap in both packages."""
    sc = _config(mode, "equality", sw)
    rng = np.random.default_rng(7 + sw)
    letters = np.array(list(DNA))
    A = ["".join(letters[rng.integers(0, 8, int(k))])
         for k in rng.integers(0, 40, 6)]
    B = ["".join(letters[rng.integers(0, 8, int(k))])
         for k in rng.integers(0, 30, 6)]
    A[1], B[2] = "", ""
    out, na, nb = dp.fill_batch(sc, A, B, is_sw=sw, emit_dirs=True,
                                emit_m=True, emit_gab=True, pad_a=40,
                                pad_b=32)
    ac, bc, tna, tnb, bp = tpack.pack_batch(sc, kernel_params(sc, "cpu"), A,
                                            B, 40, 32)
    args = [torch.from_numpy(v) for v in (ac, bc, tna, tnb)]
    if sw:
        dirs, gab = kernels.sw_fill_gab(*args, bp)
        _, m = kernels.sw_fill_dirs(*args, bp)
    else:
        dirs, corner, gab = kernels.nw_fill_gab(*args, bp)
        _, c2 = kernels.nw_fill_dirs(*args, bp)
        assert torch.equal(corner, c2)
        np.testing.assert_array_equal(corner.numpy(), np.asarray(out.corner))
    y = np.arange(33)[None, None, :]
    x = np.arange(71)[None, :, None] + 2 - y
    v = (y >= 1) & (y <= nb[:, None, None]) & (x >= 1) & \
        (x <= na[:, None, None])
    for got, want in ((dirs, out.dirs), (gab[0], out.mmat),
                      (gab[1], out.gamat), (gab[2], out.gbmat)):
        np.testing.assert_array_equal(got.numpy()[v], np.asarray(want)[v])
    if sw:
        np.testing.assert_array_equal(m.numpy()[v], gab[0].numpy()[v])


def test_deskew_equals_the_jax_deskew():
    rng = np.random.default_rng(3)
    sk = rng.integers(-99, 99, (9 + 6 - 1, 7)).astype(np.int32)
    for na, nb in ((9, 6), (4, 6), (9, 2), (0, 3), (5, 0)):
        got = deskew(torch.from_numpy(sk), na, nb, fill=-7).numpy()
        np.testing.assert_array_equal(got, dp.deskew(sk, na, nb, fill=-7))
