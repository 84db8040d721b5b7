"""The port's aligner (seqalign_tpu_torch.NeedlemanWunsch on the CPU)
against the JAX package's, on its device path: the JAX side runs the
Pallas v2 kernels in interpret mode, the port its plain PyTorch versions.
Also the in-slice golden NW corpus and the port's routing.  Tolerance 0
everywhere: the DP is integer."""

import dataclasses

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

import seqalign_tpu  # noqa: E402
from golden_util import load_golden  # noqa: E402
from seqalign_tpu import aligners as jax_aligners  # noqa: E402
from seqalign_tpu.ops import host_dp  # noqa: E402
from seqalign_tpu.scoring.config import ScoringConfig  # noqa: E402
from seqalign_tpu.scoring.presets import (  # noqa: E402
    scoring_system_BLOSUM62, scoring_system_default,
)
from seqalign_tpu_torch import NeedlemanWunsch  # noqa: E402
from seqalign_tpu_torch import aligners as port_aligners  # noqa: E402


def _pairs(seed, n, lo, hi):
    rng = np.random.default_rng(seed)
    alpha = np.frombuffer(b"acgtACGT", np.uint8)
    return [bytes(alpha[rng.integers(0, 8, int(k))]).decode()
            for k in rng.integers(lo, hi + 1, n)]


@pytest.fixture
def device_path(monkeypatch):
    """Both packages on their device paths; the JAX kernels interpreted
    at a small pad floor (as test_pallas2.test_v2_via_aligners_dispatch)."""
    monkeypatch.setenv("SEQALIGN_FORCE", "device")
    monkeypatch.setenv("SEQALIGN_PALLAS", "interpret")
    monkeypatch.setenv("SEQALIGN_PALLAS_FLOOR", "16")


CONFIGS = {
    "default": scoring_system_default,
    "case_sensitive": lambda: ScoringConfig(2, -1, -3, -2,
                                            case_sensitive=True),
}


@pytest.mark.parametrize("name", list(CONFIGS))
def test_score_batch_vs_jax(device_path, name):
    sc = CONFIGS[name]()
    A, B = _pairs(1, 7, 1, 60), _pairs(2, 7, 1, 60)
    got = NeedlemanWunsch(sc, device="cpu").score_batch(A, B)
    want = seqalign_tpu.NeedlemanWunsch(sc).score_batch(A, B)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    counts = jax_aligners.pallas_dispatch_counts()
    assert counts.get("scores2", 0) > 0  # the JAX side ran its kernel


def test_score_pairs_stream_vs_jax(device_path):
    sc = scoring_system_default()
    A, B = _pairs(3, 8, 1, 64), _pairs(4, 8, 1, 64)
    pairs = list(zip(range(8), A, B))
    nw = NeedlemanWunsch(sc, device="cpu")
    got = np.zeros(8, np.int64)
    for idx, out in nw.score_pairs_stream(iter(pairs), flush_pairs=3):
        got[idx] = out
    want = np.zeros(8, np.int64)
    for idx, out in jax_aligners.score_pairs_stream(sc, iter(pairs),
                                                    is_sw=False,
                                                    flush_pairs=3):
        want[idx] = out
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_align_batch_vs_jax(device_path, name):
    sc = CONFIGS[name]()
    A, B = _pairs(5, 6, 1, 48), _pairs(6, 6, 1, 48)
    got = NeedlemanWunsch(sc, device="cpu").align_batch(A, B)
    want = seqalign_tpu.NeedlemanWunsch(sc).align_batch(A, B)
    assert [dataclasses.astuple(g) for g in got] == \
        [dataclasses.astuple(w) for w in want]


def test_align_batch_empty_sides(device_path):
    """Empty sides run on the port's kernels (the JAX package takes the
    XLA fill for them)."""
    sc = scoring_system_default()
    A, B = ["", "acgt", "", "GATTACA"], ["", "", "tgc", "gatc"]
    nw = NeedlemanWunsch(sc, device="cpu")
    got = nw.align_batch(A, B)
    want = seqalign_tpu.NeedlemanWunsch(sc).align_batch(A, B)
    assert [dataclasses.astuple(g) for g in got] == \
        [dataclasses.astuple(w) for w in want]
    np.testing.assert_array_equal(nw.score_batch(A, B),
                                  [w.score for w in want])


def test_score_batch_fillers_do_not_leak(device_path):
    """No result past n comes back: the port launches the n pairs without
    the JAX package's pow2 pair-count fillers, and the n scores equal the
    host DP's."""
    sc = scoring_system_default()
    A, B = _pairs(7, 5, 1, 30), _pairs(8, 5, 1, 30)
    nw = NeedlemanWunsch(sc, device="cpu")
    got = port_aligners._scores_auto(sc, nw.params, A, B, is_sw=False)
    assert got.shape == (5,)
    want = [host_dp.nw_align(sc, a, b).score for a, b in zip(A, B)]
    np.testing.assert_array_equal(got, want)
    dev = port_aligners._scores_auto(sc, nw.params, A, B, is_sw=False,
                                     defer=True)
    assert isinstance(dev, torch.Tensor) and dev.shape == (5,)


def _in_slice(case):
    sc = case.scoring
    return (case.mode == "nw" and case.seq_a and case.seq_b
            and sc.use_match_mismatch and not sc._swap_set.any()
            and not sc._wild_set.any() and sc.gap_open <= 0
            and not (sc.no_start_gap_penalty or sc.no_end_gap_penalty
                     or sc.no_gaps_in_a or sc.no_gaps_in_b
                     or sc.no_mismatches))


GOLDEN = [c for c in load_golden() if _in_slice(c)]


def test_golden_slice_size():
    assert len(GOLDEN) == 77


@pytest.mark.parametrize("k", range(len(GOLDEN)))
def test_golden_nw_on_device_path(monkeypatch, k):
    monkeypatch.setenv("SEQALIGN_FORCE", "device")
    case = GOLDEN[k]
    nw = NeedlemanWunsch(case.scoring, device="cpu")
    aln = nw.align(case.seq_a, case.seq_b)
    assert (aln.result_a, aln.result_b, aln.score) == case.nw
    assert nw.score(case.seq_a, case.seq_b) == case.nw[2]


def test_sentinel_wrap_config_goes_to_host(monkeypatch):
    monkeypatch.setenv("SEQALIGN_FORCE", "device")
    sc = ScoringConfig(1, -2, -4, -1, no_gaps_in_a=True, no_gaps_in_b=True)
    assert sc.sentinel_wrap_risk()
    assert port_aligners._route(10 ** 9, 10 ** 6, sc) == "host"
    nw = NeedlemanWunsch(sc, device="cpu")
    got = nw.align_batch(["acgtt", "gat"], ["acgt", "gaat"])
    want = [host_dp.nw_align(sc, a, b)
            for a, b in (("acgtt", "acgt"), ("gat", "gaat"))]
    assert [dataclasses.astuple(g) for g in got] == \
        [dataclasses.astuple(w) for w in want]


def test_small_batches_route_to_host(monkeypatch):
    monkeypatch.delenv("SEQALIGN_FORCE", raising=False)
    assert port_aligners._route(100, 2, scoring_system_default()) == "host"
    assert port_aligners._route(10 ** 8, 2, scoring_system_default()) == \
        "device"


OUT_OF_SLICE = {
    "free_end_gaps": lambda: ScoringConfig(1, -2, -4, -1,
                                           no_end_gap_penalty=True),
    "free_start_gaps": lambda: ScoringConfig(1, -2, -4, -1,
                                             no_start_gap_penalty=True),
    "positive_gap_open": lambda: ScoringConfig(2, -3, 1, -1),
    # substitution-matrix scoring under a constrained flag
    "blosum62": lambda: _with(scoring_system_BLOSUM62(), no_gaps_in_b=True),
}


def _with(sc, **flags):
    for k, v in flags.items():
        setattr(sc, k, v)
    sc._luts = None
    return sc


@pytest.mark.parametrize("name", list(OUT_OF_SLICE))
def test_out_of_slice_device_batch_raises(monkeypatch, name):
    """The configs that the device path used to refuse (ROADMAP.md Queue 1
    item 6) now run on it and equal the host DP's answers."""
    monkeypatch.setenv("SEQALIGN_FORCE", "device")
    sc = OUT_OF_SLICE[name]()
    nw = NeedlemanWunsch(sc, device="cpu")
    A, B = ["ARND", "AR", "NDRRA"], ["ARN", "ND", "RA"]
    want = [host_dp.nw_align(sc, a, b) for a, b in zip(A, B)]
    np.testing.assert_array_equal(nw.score_batch(A, B),
                                  [w.score for w in want])
    assert [dataclasses.astuple(g) for g in nw.align_batch(A, B)] == \
        [dataclasses.astuple(w) for w in want]
    # and so does the host path
    monkeypatch.setenv("SEQALIGN_FORCE", "host")
    assert nw.score("ARND", "ARN") == want[0].score


def test_long_pair_bucket_raises(monkeypatch):
    """The long bucket, which raised until the long-pair path was ported
    (ROADMAP.md Queue 1 item 7), now runs it and equals the JAX package's
    long path and the host DP."""
    monkeypatch.setenv("SEQALIGN_FORCE", "device")
    monkeypatch.setattr(port_aligners, "LONG_PAIR_CELLS", 100)
    monkeypatch.setattr(jax_aligners, "LONG_PAIR_CELLS", 100)
    nw = NeedlemanWunsch(device="cpu")
    A, B = ["a" * 20, "acgtta" * 5], ["c" * 20, "acgt" * 4]
    got = nw.align_batch(A, B)
    want = seqalign_tpu.NeedlemanWunsch().align_batch(A, B)
    assert [dataclasses.astuple(g) for g in got] == \
        [dataclasses.astuple(w) for w in want]
    assert [dataclasses.astuple(g) for g in got] == [
        dataclasses.astuple(host_dp.nw_align(scoring_system_default(), a, b))
        for a, b in zip(A, B)]


def test_align_sub_batches_follow_the_dirs_bytes(monkeypatch):
    """Sub-batches are sized by the bytes each pair's code plane holds at
    its own widths, (na+nb-1)*(nb+1): each sub-batch's planes fit the
    budget, and the next pair would not have fit beside them."""
    monkeypatch.setenv("SEQALIGN_FORCE", "device")
    A, B = _pairs(9, 5, 10, 40), _pairs(10, 5, 10, 40)
    plane = [(len(a) + len(b) - 1) * (len(b) + 1) for a, b in zip(A, B)]
    budget = plane[0] + plane[1]
    monkeypatch.setattr(port_aligners, "ALIGN_DIRS_BUDGET", budget)
    sizes = []
    real = port_aligners.kernels.nw_fill_dirs

    def spy(ac, *args):
        sizes.append(ac.shape[0])
        return real(ac, *args)

    monkeypatch.setattr(port_aligners.kernels, "nw_fill_dirs", spy)
    got = NeedlemanWunsch(device="cpu").align_batch(A, B)
    assert sum(sizes) == 5 and len(sizes) > 1 and sizes[0] == 2
    start = 0
    for n in sizes:
        held = sum(plane[start:start + n])
        assert n == 1 or held <= budget
        if start + n < 5:
            assert held + plane[start + n] > budget
        start += n
    sc = scoring_system_default()
    assert [g.score for g in got] == [host_dp.nw_align(sc, a, b).score
                                      for a, b in zip(A, B)]


def test_default_device_is_cuda():
    """The port never picks the CPU on its own: without a GPU the default
    aligner cannot be built."""
    if torch.cuda.is_available():
        assert NeedlemanWunsch().device.type == "cuda"
    else:
        with pytest.raises((AssertionError, RuntimeError)):
            NeedlemanWunsch()
