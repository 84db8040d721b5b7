"""The port's own copies of the scoring layer, the batch packer and the
int64 host path against the originals in ``seqalign_tpu``, and the state
carried across by ``from_reference``.  Exact equality throughout."""

import dataclasses
import inspect
import os

import numpy as np
import pytest

from seqalign_tpu.io import packer as jax_packer
from seqalign_tpu.ops import host_dp as jax_host_dp
from seqalign_tpu.scoring import config as jax_config
from seqalign_tpu.scoring import loader as jax_loader
from seqalign_tpu.scoring import presets as jax_presets
from seqalign_tpu_torch.io import packer
from seqalign_tpu_torch.ops import host_dp
from seqalign_tpu_torch.scoring import config, loader, presets
from seqalign_tpu_torch.scoring.config import ScoringConfig, from_reference

PRESETS = sorted(n for n, f in vars(jax_presets).items()
                 if n.startswith("scoring_system_") and callable(f))
MATRIX_FILES = ("PAM250.txt", "NUC.4.4.txt", "BLOSUM45.txt")


def _same_luts(a, b):
    for x, y in zip(a.luts(), b.luts()):
        np.testing.assert_array_equal(x, y)
    assert (a.min_penalty, a.max_penalty) == (b.min_penalty, b.max_penalty)
    assert a.neg_inf == b.neg_inf
    assert a.true_penalty_bounds() == b.true_penalty_bounds()
    assert a.sentinel_wrap_risk() == b.sentinel_wrap_risk()


def test_data_dir_is_the_ports_own():
    pkg = os.path.dirname(os.path.dirname(os.path.abspath(presets.__file__)))
    assert os.path.basename(pkg) == "seqalign_tpu_torch"
    assert presets.DATA_DIR == os.path.join(pkg, "data", "scoring")
    ours = sorted(os.listdir(presets.DATA_DIR))
    assert ours == sorted(os.listdir(jax_presets.DATA_DIR))
    assert len(ours) == 78
    for name in ours:
        with open(os.path.join(presets.DATA_DIR, name), "rb") as f, \
                open(os.path.join(jax_presets.DATA_DIR, name), "rb") as g:
            assert f.read() == g.read(), name


@pytest.mark.parametrize("name", PRESETS)
def test_preset_luts_equal(name):
    assert len(PRESETS) >= 7
    ours, theirs = getattr(presets, name)(), getattr(jax_presets, name)()
    assert type(ours) is ScoringConfig
    assert type(theirs) is jax_config.ScoringConfig
    _same_luts(ours, theirs)


@pytest.mark.parametrize("name", MATRIX_FILES)
def test_loaded_matrix_luts_equal(name):
    path = os.path.join(presets.DATA_DIR, name)
    ours = loader.load_matrix(path, ScoringConfig(1, -2, -4, -1))
    theirs = jax_loader.load_matrix(path,
                                    jax_config.ScoringConfig(1, -2, -4, -1))
    _same_luts(ours, theirs)


def _ragged(seed, n, hi):
    rng = np.random.default_rng(seed)
    alpha = np.frombuffer(b"acgtNACGT-", np.uint8)
    return [bytes(alpha[rng.integers(0, len(alpha), int(k))]).decode()
            for k in rng.integers(0, hi + 1, n)]


@pytest.mark.parametrize("native", ["1", "0"], ids=["native", "numpy"])
@pytest.mark.parametrize("folded", [False, True], ids=["raw", "fold"])
def test_packer_equals_original(monkeypatch, folded, native):
    """Ragged input, with and without the fold LUT, through the native
    extension (built into the port's ``_build/``) and the numpy path."""
    monkeypatch.setenv("SEQALIGN_NATIVE_PACK", native)
    monkeypatch.setattr(packer, "_mod_tried", False)
    monkeypatch.setattr(packer, "_mod", None)
    seqs = _ragged(61, 33, 70) + [""]
    fold = ScoringConfig().luts()[0] if folded else None
    got, glen = packer.pack(seqs, 72, fold)
    want, wlen = jax_packer._pack_numpy(seqs, 72, fold)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(glen, wlen)
    np.testing.assert_array_equal(packer.seq_lens(seqs), wlen)
    np.testing.assert_array_equal(packer.fold_bytes(want, ScoringConfig(
    ).luts()[0]), jax_packer.fold_bytes(want, ScoringConfig().luts()[0]))
    if native == "0":
        assert packer.get_mod() is None
    elif packer.available():
        assert os.path.dirname(packer._SO) == packer._BUILD_DIR
        assert os.path.basename(packer._BUILD_DIR) == "_build"
        assert os.path.exists(packer._SO)


def _pairs():
    a, b = _ragged(62, 12, 40), _ragged(63, 12, 40)
    a[0], b[1] = "", ""
    return list(zip(a, b))


HOST_CONFIGS = {
    "default": dict(),
    "free_ends": dict(no_start_gap_penalty=True, no_end_gap_penalty=True),
    "lcs": dict(no_gaps_in_a=True, no_gaps_in_b=True, no_mismatches=True),
}


@pytest.mark.parametrize("name", list(HOST_CONFIGS))
def test_host_dp_equals_original(name):
    ours = ScoringConfig(1, -1, -4, -1, **HOST_CONFIGS[name])
    theirs = jax_config.ScoringConfig(1, -1, -4, -1, **HOST_CONFIGS[name])
    for a, b in _pairs():
        assert dataclasses.astuple(host_dp.nw_align(ours, a, b)) == \
            dataclasses.astuple(jax_host_dp.nw_align(theirs, a, b))
        got = [dataclasses.astuple(h) for h in host_dp.HostSwHits(ours, a, b)]
        want = [dataclasses.astuple(h)
                for h in jax_host_dp.HostSwHits(theirs, a, b)]
        assert got == want
        for m, w in zip(host_dp.fill_matrices(ours, a, b, False),
                        jax_host_dp.fill_matrices(theirs, a, b, False)):
            np.testing.assert_array_equal(m, w)


def test_copies_differ_from_originals_only_where_stated():
    """The copied sources are the originals but for import paths, the data
    path, the build directory and the comments that name them."""
    import seqalign_tpu.ops.oracle as jax_oracle
    import seqalign_tpu_torch.ops.oracle as oracle

    for ours, theirs, most in ((config, jax_config, 40),
                               (loader, jax_loader, 0),
                               (presets, jax_presets, 2),
                               (host_dp, jax_host_dp, 0),
                               (oracle, jax_oracle, 2),
                               (packer, jax_packer, 40)):
        a = inspect.getsource(ours).splitlines()
        b = set(inspect.getsource(theirs).splitlines())
        extra = [ln for ln in a if ln not in b]
        assert len(extra) <= most, (ours.__name__, extra)


def test_from_reference_round_trip():
    ref = jax_presets.scoring_system_BLOSUM62()
    ref.add_wildcard("x", -1)
    ref.no_end_gap_penalty = True
    ref.no_mismatches = True
    ref._luts = None
    sc = from_reference(ref)
    assert type(sc) is ScoringConfig
    _same_luts(sc, ref)
    for f in dataclasses.fields(ScoringConfig):
        assert getattr(sc, f.name) == getattr(ref, f.name), f.name
    # a snapshot, not a view: the tables are the port's own arrays
    assert sc._swap_scores is not ref._swap_scores
    # back across, by attribute again: the reference's class need not be
    # imported by the port, nor the port's by the reference
    back = jax_config.ScoringConfig.copy(sc)
    _same_luts(back, ref)
    # the port's own config passes through unchanged
    assert from_reference(sc) is sc
    # a plain object with the fields will do
    class Bag:
        pass
    bag = Bag()
    for k, v in vars(jax_config.ScoringConfig(3, -1, -2, -2,
                                              case_sensitive=True)).items():
        setattr(bag, k, v)
    got = from_reference(bag)
    assert (got.match, got.gap_extend, got.case_sensitive) == (3, -2, True)
    _same_luts(got, jax_config.ScoringConfig(3, -1, -2, -2,
                                             case_sensitive=True))


def test_aligners_take_either_config():
    from seqalign_tpu_torch import NeedlemanWunsch, SmithWaterman, \
        kernel_params

    ref = jax_config.ScoringConfig(2, -1, -3, -1, no_end_gap_penalty=True)
    own = ScoringConfig(2, -1, -3, -1, no_end_gap_penalty=True)
    nw = NeedlemanWunsch(ref, device="cpu")
    assert type(nw.scoring) is ScoringConfig
    assert NeedlemanWunsch(own, device="cpu").scoring is own
    assert type(SmithWaterman(ref, device="cpu").scoring) is ScoringConfig
    assert kernel_params(ref).scal.tolist() == kernel_params(own).scal.tolist()
    assert kernel_params(ref).modes == kernel_params(own).modes == 2
    assert dataclasses.astuple(nw.align("acgtt", "cgt")) == \
        dataclasses.astuple(jax_host_dp.nw_align(ref, "acgtt", "cgt"))


# the CLI layer's copies: (path under both packages, most lines added, most
# lines dropped).  They change only import paths, the build directory (the
# native reader builds into the port's _build/), the device selector (the
# JAX platform pinning of cli/_common.py gives way to SEQALIGN_DEVICE) and
# the profiler (torch.profiler for jax.profiler).
CLI_COPIES = (("io/seqio.py", 0, 0), ("io/native.py", 16, 7),
              ("native/seqio.cpp", 3, 3), ("cli/_common.py", 19, 24),
              ("cli/needleman_wunsch.py", 2, 1),
              ("cli/smith_waterman.py", 2, 1), ("cli/lcs.py", 5, 3),
              ("utils/metrics.py", 15, 6))


@pytest.mark.parametrize("path,most_added,most_dropped", CLI_COPIES,
                         ids=[c[0] for c in CLI_COPIES])
def test_cli_layer_copies_differ_only_where_stated(path, most_added,
                                                   most_dropped):
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(root, "seqalign_tpu_torch", path)) as f:
        ours = f.read().splitlines()
    with open(os.path.join(root, "seqalign_tpu", path)) as f:
        theirs = f.read().splitlines()
    added = [ln for ln in ours if ln not in set(theirs)]
    dropped = [ln for ln in theirs if ln not in set(ours)]
    assert len(added) <= most_added, added
    assert len(dropped) <= most_dropped, dropped
    assert not any("jax" in ln for ln in added)
    if path.startswith("cli/") and path != "cli/_common.py":
        # the mains differ in the device they build their aligner on
        assert all("cli_device" in ln or "lcs_aligner" in ln or
                   "stats_timer" in ln or "sw=sw" in ln for ln in added)


def test_native_reader_builds_into_the_ports_build_dir():
    from seqalign_tpu.io import native as jax_native
    from seqalign_tpu_torch.io import native, seqio

    assert os.path.basename(native._BUILD_DIR) == "_build"
    assert os.path.dirname(native._SO) == native._BUILD_DIR
    assert os.path.dirname(native._BUILD_DIR) == os.path.dirname(
        os.path.dirname(os.path.abspath(native.__file__)))
    assert native._SRC.endswith(os.path.join("seqalign_tpu_torch", "native",
                                             "seqio.cpp"))
    assert native._SO != jax_native._SO
    if native.available():
        assert os.path.exists(native._SO)
    # the pure-Python reader of the copy reads what the original reads
    from seqalign_tpu.io import seqio as jax_seqio

    golden = os.path.join(root_dir(), "tests", "golden", "cli", "inputs")
    for name in sorted(os.listdir(golden)):
        path = os.path.join(golden, name)
        assert list(seqio.read_seqs(path)) == \
            list(jax_seqio.read_seqs(path)), name


def root_dir():
    return os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
