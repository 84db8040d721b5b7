"""The register tiles under the scoring flags (the MODES instantiations of
csrc/tile_fill.cuh and csrc/tile_carry.cuh), checked on the CPU.  The
numpy models of ``tests/test_torch_tile.py`` (:func:`tile_fill_model`,
:func:`tile_carry_model`) run with the flags of a launch as the kernels
apply them: NSG on the boundary, NMM on every lane, NEG, NGA and NGB on
the pair's last column and row and their guards on x == 1 and y == 1, the
columns tested in checked step blocks only (the models assert that no
unchecked block holds one).  They are held with tolerance 0 to the JAX
package: the fill to ``dp.fill_batch`` under each flag combination of
chip_smoke.py's ``MODES`` and all five flags, NW and SW, equality and
BLOSUM62, R of 1 and 4, on b sides of 32R - 1, 32R and 32R + 1 lanes (the
last row on a strip's edge), pairs whose strips take two and more rounds
of 2 warps, and empty sides; the carry to ``dp.fill_chunked``, chunk by
chunk, under nsg+neg, nga+ngb+nmm and all five flags, with pairs that end
on a chunk's first and last column.  The kernels themselves are held to
the plain versions on the card by ``tests/test_torch_cuda.py``."""

import functools

import numpy as np
import pytest

pytest.importorskip("jax.numpy")

from seqalign_tpu.ops import dp  # noqa: E402
from seqalign_tpu.scoring.config import ScoringConfig  # noqa: E402
from seqalign_tpu.scoring.presets import scoring_system_BLOSUM62  # noqa

from seqalign_tpu_torch.ops import kernels  # noqa: E402

from test_torch_tile import (  # noqa: E402
    DNA, PROTEIN, assert_carry_model, assert_model_launch, carry_reference,
)

# chip_smoke.py's MODES (but gap_open > 0, a mode of the penalties, which
# the default instantiations run) and all five flags
FLAGSETS = {
    "nsg": dict(no_start_gap_penalty=True),
    "neg": dict(no_end_gap_penalty=True),
    "nsg+neg": dict(no_start_gap_penalty=True, no_end_gap_penalty=True),
    "nga": dict(no_gaps_in_a=True),
    "ngb": dict(no_gaps_in_b=True),
    "nga+ngb": dict(no_gaps_in_a=True, no_gaps_in_b=True),
    "nmm": dict(no_mismatches=True),
    "neg+nga": dict(no_end_gap_penalty=True, no_gaps_in_a=True),
    "nga+ngb+nmm": dict(no_gaps_in_a=True, no_gaps_in_b=True,
                        no_mismatches=True),
    "all": dict(no_start_gap_penalty=True, no_end_gap_penalty=True,
                no_gaps_in_a=True, no_gaps_in_b=True, no_mismatches=True),
}


def flagged(kind, scoring, flagset):
    """The config of a flag set: NW 1/-2/-4/-1 or SW 2/-2/-2/-1 with the
    flags, or BLOSUM62 with them."""
    flags = FLAGSETS[flagset]
    if scoring == "equality":
        pen = (2, -2, -2, -1) if kind == "sw" else (1, -2, -4, -1)
        return ScoringConfig(*pen, **flags)
    sc = scoring_system_BLOSUM62()
    for k, v in flags.items():
        setattr(sc, k, v)
    sc._luts = None
    return sc


def mode_pairs(alpha, seed):
    """The strip edges of R = 1 and R = 4 (b of 31, 32, 33 and 127, 128,
    129 lanes, a sides long enough for unchecked step blocks), three strips
    of R = 4 (two rounds of 2 warps; five of R = 1), and empty sides."""
    lens = [(37, 31), (45, 32), (41, 33), (140, 127), (136, 128), (150, 129),
            (140, 260), (0, 9), (12, 0), (0, 0), (1, 1), (3, 1)]
    rng = np.random.default_rng(seed)
    letters = np.array(list(alpha))

    def text(n):
        return "".join(letters[rng.integers(0, len(letters), n)])

    return [text(n) for n, _ in lens], [text(m) for _, m in lens]


@functools.lru_cache(maxsize=None)
def mode_reference(kind, scoring, flagset):
    """The JAX package's fill of :func:`mode_pairs` under a flag set."""
    sc = flagged(kind, scoring, flagset)
    A, B = mode_pairs(DNA if scoring == "equality" else PROTEIN,
                      len(flagset) + 3 * len(kind + scoring))
    out, _, _ = dp.fill_batch(sc, A, B, is_sw=kind == "sw", emit_dirs=True,
                              emit_m=kind == "sw",
                              pad_a=max(map(len, A)), pad_b=max(map(len, B)),
                              validate=False)
    return sc, A, B, out


@pytest.mark.parametrize("R", [1, 4])
@pytest.mark.parametrize("scoring", ["equality", "blosum62"])
@pytest.mark.parametrize("kind", ["nw", "sw"])
@pytest.mark.parametrize("flagset", list(FLAGSETS))
def test_flagged_tile_model_equals_dp_fill(flagset, kind, scoring, R):
    """The tile fill's model under the flags (2 warps a block, so that
    pairs of several strips hand their edge over through the round row;
    ragged planes and int16 M at R = 4, the uniform layout and int32 M at
    R = 1) against ``dp.fill_batch``, tolerance 0."""
    sc, A, B, out = mode_reference(kind, scoring, flagset)
    assert_model_launch(sc, A, B, out, kind == "sw", R, 2, R == 4,
                        R + len(flagset))


CARRY_FLAGSETS = ("nsg+neg", "nga+ngb+nmm", "all")


@pytest.mark.parametrize("scoring", ["equality", "blosum62"])
@pytest.mark.parametrize("kind", ["nw", "sw"])
@pytest.mark.parametrize("flagset", CARRY_FLAGSETS)
def test_flagged_tile_carry_model_equals_fill_chunked(flagset, kind,
                                                      scoring):
    """The carry's model under the flags, chunk by chunk, against
    ``dp.fill_chunked`` with tolerance 0 (the checks of
    ``test_tile_carry_model_equals_fill_chunked``), at the flags' carry's R
    (``kernels.CARRY_MODES_R``) and 8 warps a block, 512 lanes a round:
    chunks of 200 columns (unchecked step blocks inside them) over b of
    one to three rounds, pairs that end on the last column of chunk 0, on
    the first and on the last column of chunk 1, and empty sides."""
    R = kernels.CARRY_MODES_R
    ref = _carry_reference(kind, scoring, "flags", flagset)
    assert_carry_model(ref, kind == "sw", R, 512 // (32 * R), "flags",
                       len(kind + scoring + flagset))


@functools.lru_cache(maxsize=None)
def _carry_reference(kind, scoring, regime, flagset):
    return carry_reference(kind, scoring, regime,
                           functools.partial(flagged, kind, scoring, flagset))
