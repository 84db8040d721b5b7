"""The matrix dump's fill on the register tiles (the GAB instantiations of
csrc/tile_fill.cuh), checked on the CPU.  The numpy model of
``tests/test_torch_tile.py`` (:func:`tile_fill_model`) runs with the GAB
stores: the codes, and M, Ga and Gb as int32 into three planes of the
uniform layout, B planes apart (the kernel's mout, mout + B*plane, mout +
2*B*plane), lane by lane in checked step blocks and as aligned pieces
(``store_pieces``) in unchecked ones.  It is held with tolerance 0 to the
JAX package's ``dp.fill_batch(..., emit_gab=True)`` (``dp.dp_fill``): every
valid cell of each plane written once, codes, M, Ga, Gb, the NW corner
and the SW best, NW and SW, equality and BLOSUM62, at the default flags
(R of 2, the kernel's ``kernels.GAB_R``, and 4; one round of a block and
several, b past ``kernels.TILE_LANES`` lanes) and under each flag set of
``tests/test_torch_matrices.py``'s ``MODES`` and all five flags (at the
kernel's R, one round and several), with empty sides.  The kernels themselves are
held to the plain versions on the card by ``tests/test_torch_cuda.py``."""

import functools

import numpy as np
import pytest

pytest.importorskip("jax.numpy")

from seqalign_tpu.ops import dp  # noqa: E402
from seqalign_tpu.scoring.config import ScoringConfig  # noqa: E402
from seqalign_tpu.scoring.presets import scoring_system_BLOSUM62  # noqa

from seqalign_tpu_torch.ops import kernels  # noqa: E402

from test_torch_tile import (  # noqa: E402
    DNA, PROTEIN, SCORINGS, assert_model_launch, pairs_for,
)
from test_torch_tile_modes import FLAGSETS, flagged, mode_pairs  # noqa

# a block's warps, whatever its R (csrc/tile_fill.cuh, BLOCK_WARPS)
WARPS = kernels.TILE_LANES // (32 * kernels.TILE_R)
# a pair whose b runs past one round of a block at R = 2 and at R = 4 (one
# round: WARPS * 32 * R lanes)
WIDE = (37, kernels.TILE_LANES + 52)


def _text(rng, alpha, n):
    letters = np.array(list(alpha))
    return "".join(letters[rng.integers(0, len(letters), n)])


def gab_fill(sc, A, B, sw):
    """The JAX package's fill of the pairs A, B with the dump's planes."""
    out, _, _ = dp.fill_batch(sc, A, B, is_sw=sw, emit_dirs=True,
                              emit_m=True, emit_gab=True,
                              pad_a=max(1, max(map(len, A))),
                              pad_b=max(1, max(map(len, B))),
                              validate=False)
    return out


@functools.lru_cache(maxsize=None)
def default_reference(kind, scoring, R, rounds):
    """:func:`pairs_for`'s pairs at the strip edges of R (and with
    ``rounds`` "several" :data:`WIDE`) at the default flags."""
    make, alpha = SCORINGS[kind, scoring]
    sc = make()
    A, B = pairs_for(R, alpha, 10 * R + len(kind + scoring))
    if rounds == "several":
        rng = np.random.default_rng(R)
        A.append(_text(rng, alpha, WIDE[0]))
        B.append(_text(rng, alpha, WIDE[1]))
    return sc, A, B, gab_fill(sc, A, B, kind == "sw")


@pytest.mark.parametrize("rounds", ["one", "several"])
@pytest.mark.parametrize("scoring", ["equality", "blosum62"])
@pytest.mark.parametrize("kind", ["nw", "sw"])
@pytest.mark.parametrize("R", [2, 4])
def test_gab_tile_model_equals_dp_fill(R, kind, scoring, rounds):
    """The GAB tile fill's model at the default flags, a block of the
    kernel's warps, against ``dp.fill_batch(emit_gab=True)``, tolerance 0;
    "several": a pair of b past one round, its strips handing their edge
    on through the round row."""
    sc, A, B, out = default_reference(kind, scoring, R, rounds)
    assert_model_launch(sc, A, B, out, kind == "sw", R, WARPS, False,
                        R + len(kind), gab=True)


# tests/test_torch_matrices.py's MODES (gap_open > 0 a mode of the
# penalties, run by the default instantiations) and all five flags
GAB_FLAGSETS = {"nsg": "nsg", "neg": "neg", "nsg_neg": "nsg+neg",
                "nga": "nga", "ngb": "ngb", "nga_ngb": "nga+ngb",
                "nmm": "nmm", "neg_nga": "neg+nga",
                "nga_ngb_nmm": "nga+ngb+nmm", "gap_open_pos": None,
                "all": "all"}


def gab_config(kind, scoring, mode):
    """The config of a flag set, as tests/test_torch_matrices.py's."""
    if GAB_FLAGSETS[mode] is not None:
        return flagged(kind, scoring, GAB_FLAGSETS[mode])
    if scoring == "equality":
        return ScoringConfig(2, -3, 1, -1)
    sc = scoring_system_BLOSUM62()
    sc.gap_open = 1
    sc._luts = None
    return sc


@functools.lru_cache(maxsize=None)
def mode_reference(kind, scoring, mode):
    """Two launches under a flag set: :func:`mode_pairs`, and
    :data:`WIDE` alone (its planes at its own widths, so that the checks
    of every cell stay cheap): [(A, B, out), ...] and the config."""
    sc = gab_config(kind, scoring, mode)
    alpha = DNA if scoring == "equality" else PROTEIN
    A, B = mode_pairs(alpha, len(mode) + 5 * len(kind + scoring))
    rng = np.random.default_rng(len(mode))
    Aw, Bw = [_text(rng, alpha, WIDE[0])], [_text(rng, alpha, WIDE[1])]
    return sc, [(X, Y, gab_fill(sc, X, Y, kind == "sw"))
                for X, Y in ((A, B), (Aw, Bw))]


@pytest.mark.parametrize("scoring", ["equality", "blosum62"])
@pytest.mark.parametrize("kind", ["nw", "sw"])
@pytest.mark.parametrize("mode", list(GAB_FLAGSETS))
def test_flagged_gab_tile_model_equals_dp_fill(mode, kind, scoring):
    """The GAB tile fill's model under a flag set at the kernel's R
    (``kernels.GAB_R``) and warps, on pairs at the strip edges and empty
    sides (one round) and on a pair of b past one round, against
    ``dp.fill_batch(emit_gab=True)``, tolerance 0."""
    sc, launches = mode_reference(kind, scoring, mode)
    for A, B, out in launches:
        assert_model_launch(sc, A, B, out, kind == "sw", kernels.GAB_R,
                            WARPS, False, len(mode + kind), gab=True)


def test_gab_flagsets_are_the_matrix_dumps():
    """Every flag set of tests/test_torch_matrices.py's MODES is a case
    here."""
    from test_torch_matrices import MODES

    assert set(MODES) - {"default"} <= set(GAB_FLAGSETS)
    assert all(FLAGSETS[v] for v in GAB_FLAGSETS.values() if v)
