"""Preset scoring systems mirroring ``scoring_system_*``
(alignment_scoring.c:307-392).

The protein matrices (PAM30/PAM70/BLOSUM80/BLOSUM62) are loaded from the NCBI
data files shipped in ``seqalign_tpu_torch/data/scoring`` — verified numerically
identical to the reference's embedded tables over the alphabet
``ARNDCQEGHILKMFPSTWYVBZX*`` (alignment_scoring.c:188).
"""

from __future__ import annotations

import functools
import os

import numpy as np

from .config import ScoringConfig

DATA_DIR = os.path.join(os.path.dirname(os.path.dirname(__file__)), "data", "scoring")

AMINO_ACIDS = "ARNDCQEGHILKMFPSTWYVBZX*"

# DNA hybridization 8x8 over "AaCcGgTt" (alignment_scoring.c:294-304), from
# "Optimization of the BLASTN substitution matrix for prediction of
# non-specific DNA microarray hybridization" (2009).
DNA_HYBRID_BASES = "AaCcGgTt"
_DNA_HYBRID_DIAG = [2, 2, 5, 5, 5, 5, 2, 2]  # per-base self/pair score
DNA_HYBRID_MATRIX = np.full((8, 8), -4, dtype=np.int64)
for _i in range(0, 8, 2):
    DNA_HYBRID_MATRIX[_i : _i + 2, _i : _i + 2] = _DNA_HYBRID_DIAG[_i]


@functools.lru_cache(maxsize=None)
def _load_ncbi(name: str) -> tuple[str, bytes]:
    """Parse an NCBI-format matrix file -> (alphabet, flattened scores)."""
    cols = None
    rows: dict[str, list[int]] = {}
    with open(os.path.join(DATA_DIR, name)) as fh:
        for line in fh:
            if line.startswith("#") or not line.strip():
                continue
            if cols is None:
                cols = line.split()
                continue
            parts = line.split()
            rows[parts[0]] = [int(x) for x in parts[1:]]
    assert cols is not None
    mat = np.array([[rows[a][cols.index(b)] for b in cols] for a in cols], np.int64)
    return "".join(cols), mat.tobytes()


def _apply_file_matrix(sc: ScoringConfig, name: str) -> ScoringConfig:
    alphabet, raw = _load_ncbi(name)
    mat = np.frombuffer(raw, np.int64).reshape(len(alphabet), len(alphabet))
    sc.add_mutations(alphabet, mat, use_match_mismatch=True)
    return sc


def scoring_system_PAM30() -> ScoringConfig:
    """Protein comparisons <35bp (alignment_scoring.c:307-318)."""
    return _apply_file_matrix(ScoringConfig(1, -17, -9, -1), "PAM30.txt")


def scoring_system_PAM70() -> ScoringConfig:
    """Protein comparisons 35-50 (alignment_scoring.c:321-332)."""
    return _apply_file_matrix(ScoringConfig(1, -11, -10, -1), "PAM70.txt")


def scoring_system_BLOSUM80() -> ScoringConfig:
    """Protein comparisons 50-85 (alignment_scoring.c:335-346)."""
    return _apply_file_matrix(ScoringConfig(1, -8, -10, -1), "BLOSUM80.txt")


def scoring_system_BLOSUM62() -> ScoringConfig:
    """Protein comparisons >85 (alignment_scoring.c:349-360)."""
    return _apply_file_matrix(ScoringConfig(1, -4, -10, -1), "BLOSUM62.txt")


def scoring_system_DNA_hybridization() -> ScoringConfig:
    """DNA hybridization prediction (alignment_scoring.c:366-377)."""
    sc = ScoringConfig(0, 0, -10, -10)
    sc.add_mutations(DNA_HYBRID_BASES, DNA_HYBRID_MATRIX, use_match_mismatch=False)
    return sc


def scoring_system_default() -> ScoringConfig:
    """DNA/RNA default: 1/-2/-4/-1 (alignment_scoring.c:380-392)."""
    return ScoringConfig(1, -2, -4, -1)


def scoring_system_sw_default() -> ScoringConfig:
    """smith_waterman CLI default: 2/-2/-2/-1 (tools/sw_cmdline.c:37-46)."""
    return ScoringConfig(2, -2, -2, -1)


PRESETS = {
    "PAM30": scoring_system_PAM30,
    "PAM70": scoring_system_PAM70,
    "BLOSUM80": scoring_system_BLOSUM80,
    "BLOSUM62": scoring_system_BLOSUM62,
    "DNA_HYBRIDIZATION": scoring_system_DNA_hybridization,
}
