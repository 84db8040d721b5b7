"""The port's library surface against the JAX package's: every public
name of ``seqalign_tpu`` is exported by ``seqalign_tpu_torch``, and the
aligners and ``score_pairs_stream`` take the JAX package's parameters in
its order, the port's own only as keywords.  And without a GPU the
aligners built for the default device raise a clear error instead of
falling back to the CPU."""

import inspect

import pytest
import torch

pytest.importorskip("jax")

import seqalign_tpu  # noqa: E402
import seqalign_tpu_torch as port  # noqa: E402
from seqalign_tpu import aligners as jax_aligners  # noqa: E402
from seqalign_tpu_torch import aligners as port_aligners  # noqa: E402


def test_all_is_a_superset_of_the_jax_package():
    assert set(seqalign_tpu.__all__) <= set(port.__all__)
    for name in port.__all__:
        assert hasattr(port, name), name
    assert port.__version__ == seqalign_tpu.__version__
    from seqalign_tpu_torch import (Alignment, __version__,  # noqa: F401
                                    scoring_system_BLOSUM62)
    assert (port.GAP_A, port.GAP_B, port.MATCH) == \
        (seqalign_tpu.GAP_A, seqalign_tpu.GAP_B, seqalign_tpu.MATCH)
    assert sorted(port.PRESETS) == sorted(seqalign_tpu.PRESETS)
    assert port.encode("ACgt").tolist() == seqalign_tpu.encode("ACgt").tolist()
    for name in [n for n in seqalign_tpu.__all__
                 if n.startswith("scoring_system_")]:
        got, want = getattr(port, name)(), getattr(seqalign_tpu, name)()
        for field in ("match", "mismatch", "gap_open", "gap_extend"):
            assert getattr(got, field) == getattr(want, field), name
        assert (got.luts()[1] == want.luts()[1]).all(), name


def _check_signature(port_fn, jax_fn):
    """The JAX parameters, the positional ones first and in order, of the
    same kind and default; anything else of the port's keyword-only."""
    got = inspect.signature(port_fn).parameters
    want = inspect.signature(jax_fn).parameters
    pos = [n for n, p in want.items() if p.kind != p.KEYWORD_ONLY]
    assert list(got)[:len(pos)] == pos
    for n, p in want.items():
        assert n in got and got[n].kind == p.kind, n
        assert got[n].default == p.default, n
    for n in set(got) - set(want):
        assert got[n].kind == got[n].KEYWORD_ONLY, n


@pytest.mark.parametrize("name", ["NeedlemanWunsch", "SmithWaterman",
                                  "score_pairs_stream", "lcs_aligner"])
def test_signatures_follow_the_jax_package(name):
    _check_signature(getattr(port_aligners, name),
                     getattr(jax_aligners, name))


def test_second_positional_of_smith_waterman_is_ref_mask_compat():
    sc = port.scoring_system_sw_default()
    bound = inspect.signature(port.SmithWaterman).bind(sc, True)
    assert bound.arguments["ref_mask_compat"] is True
    assert port.SmithWaterman(sc, True, device="cpu").history is not None
    assert port.SmithWaterman(sc, False, device="cpu").history is None


def test_module_score_pairs_stream_derives_params(monkeypatch):
    """``params`` is optional: given, the stream runs on its device."""
    monkeypatch.setenv("SEQALIGN_FORCE", "device")
    sc = port.scoring_system_default()
    pairs = [(0, "ACGT", "AGT"), (1, "GGA", "GA")]
    got = dict()
    for idx, out in port_aligners.score_pairs_stream(
            sc, iter(pairs), is_sw=False,
            params=port.kernel_params(sc, "cpu")):
        got.update(zip(idx.tolist(), out.tolist()))
    want = seqalign_tpu.NeedlemanWunsch().score_batch(["ACGT", "GGA"],
                                                      ["AGT", "GA"])
    assert [got[0], got[1]] == want.tolist()


def test_default_device_without_gpu_raises(monkeypatch):
    """No CUDA: the default device is an error that names the way out, in
    the constructor; ``device="cpu"`` builds and runs the plain
    versions."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for build in (port.NeedlemanWunsch, port.SmithWaterman,
                  port.lcs_aligner):
        with pytest.raises(RuntimeError, match="GPU") as err:
            build()
        assert "device='cpu'" in str(err.value)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        next(port_aligners.score_pairs_stream(
            port.scoring_system_default(), iter([(0, "A", "A")]),
            is_sw=False))
    nw = port.NeedlemanWunsch(device="cpu")
    assert nw.align("CAGACGT", "CGATA").score == -11
    assert port.lcs_aligner(device="cpu").device.type == "cpu"
