"""The golden corpus on the port's device path for this slice: the SW
default-flag cases (equality and substitution-matrix scoring, including
one-side-empty pairs) as hit streams, with the case's ``min_score`` as the
align hint and its ``max_hits`` cut, and the NW default-flag
substitution-matrix cases.  The port runs its plain PyTorch kernels
(``device="cpu"``) under ``SEQALIGN_FORCE=device``; the fixtures are the
reference C library's outputs.  Exact equality."""

import pytest

pytest.importorskip("jax")

from golden_util import load_golden  # noqa: E402
from seqalign_tpu_torch import NeedlemanWunsch, SmithWaterman  # noqa: E402


def _default_flags(sc):
    return not (sc.no_start_gap_penalty or sc.no_end_gap_penalty
                or sc.no_gaps_in_a or sc.no_gaps_in_b or sc.no_mismatches)


def _equality(sc):
    return (sc.use_match_mismatch and not sc._swap_set.any()
            and not sc._wild_set.any())


CASES = load_golden()
SW = [c for c in CASES if c.mode == "sw" and _default_flags(c.scoring)
      and c.scoring.gap_open <= 0]
NW_MATRIX = [c for c in CASES if c.mode == "nw" and _default_flags(c.scoring)
             and not _equality(c.scoring) and c.scoring.gap_open <= 0]


def test_golden_slice_sizes():
    assert len(SW) == 126
    assert sum(_equality(c.scoring) and bool(c.seq_a and c.seq_b)
               for c in SW) == 61
    assert sum(not _equality(c.scoring) for c in SW) == 63
    assert sum(not (c.seq_a and c.seq_b) for c in SW) == 2
    assert len(NW_MATRIX) == 69


@pytest.mark.parametrize("k", range(len(SW)))
def test_golden_sw_on_device_path(monkeypatch, k):
    monkeypatch.setenv("SEQALIGN_FORCE", "device")
    case = SW[k]
    sw = SmithWaterman(case.scoring, device="cpu")
    got = []
    for h in sw.align(case.seq_a, case.seq_b, min_score=case.min_score):
        if case.min_score is not None and h.score < case.min_score:
            break
        got.append((h.score, h.pos_a, h.pos_b, h.len_a, h.len_b,
                    h.result_a, h.result_b))
        if case.max_hits is not None and len(got) >= case.max_hits:
            break
    want = [(h["score"], h["pos_a"], h["pos_b"], h["len_a"], h["len_b"],
             h["result_a"], h["result_b"]) for h in case.sw_hits]
    assert got == want
    best = sw.best_score(case.seq_a, case.seq_b)
    if case.min_score is None and want:
        assert best == want[0][0]


@pytest.mark.parametrize("k", range(len(NW_MATRIX)))
def test_golden_nw_matrix_on_device_path(monkeypatch, k):
    monkeypatch.setenv("SEQALIGN_FORCE", "device")
    case = NW_MATRIX[k]
    nw = NeedlemanWunsch(case.scoring, device="cpu")
    aln = nw.align(case.seq_a, case.seq_b)
    assert (aln.result_a, aln.result_b, aln.score) == case.nw
    assert nw.score(case.seq_a, case.seq_b) == case.nw[2]
