"""The golden corpus on the port's device path for the constrained modes:
every NW and SW case that sets one of the five scoring flags (free start /
end gaps, no gaps in a / b, no mismatches, and the LCS recipe among them),
equality and substitution-matrix scoring, as alignments and hit streams.
The port runs its plain PyTorch kernels (``device="cpu"``) under
``SEQALIGN_FORCE=device``; an NW config in the sentinel-wrap regime takes
the int64 host path first, as in the JAX package, and SW never does.  The
fixtures are the reference C library's outputs.  Exact equality."""

import pytest

pytest.importorskip("jax")

from golden_util import load_golden  # noqa: E402
from seqalign_tpu_torch import NeedlemanWunsch, SmithWaterman  # noqa: E402
from seqalign_tpu_torch import aligners as port_aligners  # noqa: E402

FLAGS = ("no_start_gap_penalty", "no_end_gap_penalty", "no_gaps_in_a",
         "no_gaps_in_b", "no_mismatches")


def _flags(sc):
    return tuple(f for f in FLAGS if getattr(sc, f))


CASES = load_golden()
NW = [c for c in CASES if c.mode == "nw" and _flags(c.scoring)]
SW = [c for c in CASES if c.mode == "sw" and _flags(c.scoring)]


def test_golden_slice_sizes():
    assert len(NW) == 154
    assert len(SW) == 115
    both = ("no_gaps_in_a", "no_gaps_in_b")
    lcs = both + ("no_mismatches",)
    assert sum(_flags(c.scoring) == lcs for c in SW) == 8
    assert sum(_flags(c.scoring) == both for c in NW + SW) == 20
    # the SW both-no-gaps cases in the sentinel-wrap regime stay on the
    # device path: byte parity there rests on the int32 wrap
    assert sum(c.scoring.sentinel_wrap_risk() for c in SW) == 16
    assert not any(c.scoring.sentinel_wrap_risk() for c in NW)
    for flag in FLAGS:
        assert any(flag in _flags(c.scoring) for c in NW)
        assert any(flag in _flags(c.scoring) for c in SW)


@pytest.mark.parametrize("k", range(len(NW)))
def test_golden_constrained_nw_on_device_path(monkeypatch, k):
    monkeypatch.setenv("SEQALIGN_FORCE", "device")
    case = NW[k]
    nw = NeedlemanWunsch(case.scoring, device="cpu")
    assert port_aligners._route(1, 1, nw.scoring) == "device"
    aln = nw.align(case.seq_a, case.seq_b)
    assert (aln.result_a, aln.result_b, aln.score) == case.nw
    assert nw.score(case.seq_a, case.seq_b) == case.nw[2]


@pytest.mark.parametrize("k", range(len(SW)))
def test_golden_constrained_sw_on_device_path(monkeypatch, k):
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
