"""The port's device layers (seqalign_tpu_torch.ops) against the JAX
package, on the CPU: the plain fills against the Pallas v2 kernels in
interpret mode and the XLA ``dp_fill``, the plain walk against
``traceback.nw_walk_device``, plus the wrappers' input checks and the
kernel build's failure path.  Everything is integer DP, so every compare
is exact (tolerance 0)."""

import dataclasses
import os
import stat

import numpy as np
import pytest
import torch

jnp = pytest.importorskip("jax.numpy")

from seqalign_tpu import aligners as jax_aligners  # noqa: E402
from seqalign_tpu.ops import dp  # noqa: E402
from seqalign_tpu.ops import traceback as jax_tb  # noqa: E402
from seqalign_tpu.ops.pallas_dp2 import (  # noqa: E402
    chain_geometry, pallas_fill_dirs2, pallas_scores2, unpack_pair_plane2,
)
from seqalign_tpu.scoring.config import ScoringConfig  # noqa: E402
from seqalign_tpu.scoring.presets import scoring_system_default  # noqa: E402
from seqalign_tpu_torch import (  # noqa: E402
    kernel_launch_counts, kernel_params,
)
from seqalign_tpu_torch.ops import build, kernels  # noqa: E402
from seqalign_tpu_torch.ops import pack as tpack  # noqa: E402
from seqalign_tpu_torch.ops.dp import (  # noqa: E402
    nw_fill_dirs_plain, nw_scores_plain,
)
from seqalign_tpu_torch.ops.traceback import (  # noqa: E402
    nw_strings_from_ops, nw_walk_plain,
)

CONFIGS = {
    "default": scoring_system_default,
    "1_-2_-4_-1": lambda: ScoringConfig(1, -2, -4, -1),
    "case_sensitive": lambda: ScoringConfig(2, -1, -3, -2,
                                            case_sensitive=True),
}


def _batch(seed, B, LA, LB, lo=1):
    """Seeded ragged mixed-case DNA pairs; pair 0 has a length-1 a side
    and pair 1 a length-1 b side."""
    rng = np.random.default_rng(seed)
    alpha = np.frombuffer(b"acgtACGT", np.uint8)
    sa, sb = [], []
    for i in range(B):
        na = 1 if i == 0 else int(rng.integers(lo, LA + 1))
        nb = 1 if i == 1 else int(rng.integers(lo, LB + 1))
        sa.append(bytes(alpha[rng.integers(0, 8, na)]).decode())
        sb.append(bytes(alpha[rng.integers(0, 8, nb)]).decode())
    return sa, sb


def _port_inputs(sc, sa, sb, LA, LB):
    ac, bc, na, nb = tpack.pack_inputs_mm(kernel_params(sc), sa, sb, LA,
                                          LB)
    return tuple(torch.from_numpy(v) for v in (ac, bc, na, nb))


def _jax_inputs(sc, sa, sb, LA, LB):
    a, na = dp.pad_batch(sa, pad_to=LA)
    b, nb = dp.pad_batch(sb, pad_to=LB)
    ac, bc = dp.compact_inputs_mm(sc, a, b)
    return ac, bc, na, nb


def _valid(D, LBp, na, nb):
    y = np.arange(LBp)[None, None, :]
    x = np.arange(D)[None, :, None] + 2 - y
    return ((y >= 1) & (y <= nb[:, None, None]) & (x >= 1)
            & (x <= na[:, None, None]))


@pytest.mark.parametrize("name", list(CONFIGS))
def test_scores_plain_vs_pallas_v2_and_dp_fill(name):
    sc = CONFIGS[name]()
    B, LA, LB = 8, 48, 40
    sa, sb = _batch(11, B, LA, LB)
    jac, jbc, jna, jnb = _jax_inputs(sc, sa, sb, LA, LB)
    ac, bc, na, nb = _port_inputs(sc, sa, sb, LA, LB)
    # the port's packer gives the JAX package's codes
    np.testing.assert_array_equal(ac.numpy(), jac)
    np.testing.assert_array_equal(bc.numpy(), jbc)
    scores, corner = nw_scores_plain(ac, bc, na, nb,
                                     kernel_params(sc, "cpu"))
    want = np.asarray(pallas_scores2(
        jnp.asarray(jac), jnp.asarray(jbc), jnp.asarray(jna),
        jnp.asarray(jnb), np.int32(sc.gap_open), np.int32(sc.gap_extend),
        is_sw=False, match=np.int32(sc.match),
        mismatch=np.int32(sc.mismatch), interpret=True, chain=2, bs=8))
    np.testing.assert_array_equal(scores.numpy(), want)
    out, _, _ = dp.fill_batch(sc, sa, sb, is_sw=False, emit_dirs=False,
                              pow2_pad=True, validate=False)
    np.testing.assert_array_equal(corner.numpy(),
                                  np.asarray(out.corner)[:B])


def test_scores_plain_empty_sides_vs_dp_fill():
    """The port's fill answers pairs with an empty side directly (the JAX
    package sends them to the XLA fill)."""
    sc = scoring_system_default()
    sa = ["", "acgt", "", "ggattc", "a"]
    sb = ["", "", "tgca", "gat", ""]
    ac, bc, na, nb = _port_inputs(sc, sa, sb, 8, 8)
    scores, corner = nw_scores_plain(ac, bc, na, nb,
                                     kernel_params(sc, "cpu"))
    out, _, _ = dp.fill_batch(sc, sa, sb, is_sw=False, emit_dirs=False,
                              validate=False)
    np.testing.assert_array_equal(corner.numpy(),
                                  np.asarray(out.corner)[:len(sa)])
    np.testing.assert_array_equal(scores.numpy(), corner.numpy().max(1))


@pytest.mark.parametrize("name", list(CONFIGS))
def test_fill_dirs_plain_vs_pallas_v2(name):
    sc = CONFIGS[name]()
    B, LA, LB, chain = 7, 48, 40, 2
    sa, sb = _batch(23, B, LA, LB)
    jac, jbc, jna, jnb = _jax_inputs(sc, sa, sb, LA, LB)
    ac, bc, na, nb = _port_inputs(sc, sa, sb, LA, LB)
    dirs, corner = nw_fill_dirs_plain(ac, bc, na, nb,
                                      kernel_params(sc, "cpu"))
    jd, _, jcorner = pallas_fill_dirs2(
        jnp.asarray(jac), jnp.asarray(jbc), jnp.asarray(jna),
        jnp.asarray(jnb), np.int32(sc.gap_open), np.int32(sc.gap_extend),
        is_sw=False, emit_m=False, match=np.int32(sc.match),
        mismatch=np.int32(sc.mismatch), interpret=True, chain=chain, bs=8)
    geo = chain_geometry(B, LA, LB, chain=chain, bs=8, state_bytes=140)
    jd = np.asarray(jd)
    want = np.stack([unpack_pair_plane2(jd, j, geo, LA, LB)
                     for j in range(B)])
    v = _valid(LA + LB - 1, LB + 1, jna, jnb)
    np.testing.assert_array_equal(dirs.numpy()[v], want[v])
    np.testing.assert_array_equal(corner.numpy(), np.asarray(jcorner))


@pytest.mark.parametrize("name", list(CONFIGS))
def test_walk_plain_vs_nw_walk_device(name):
    sc = CONFIGS[name]()
    B, LA, LB = 8, 40, 48
    sa, sb = _batch(37, B, LA, LB)
    out, jna, jnb = dp.fill_batch(sc, sa, sb, is_sw=False, emit_dirs=True)
    jdirs = np.asarray(out.dirs)
    jcorner = np.asarray(out.corner)
    cap = int(np.max(jna + jnb))
    jops, jscore = jax_tb.nw_walk_device(
        out.dirs, jax_aligners._xla_gather(jdirs.shape[0]), jcorner, jna,
        jnb, cap)
    ops, score = nw_walk_plain(torch.tensor(jdirs), torch.tensor(jcorner),
                               torch.from_numpy(np.asarray(jna, np.int32)),
                               torch.from_numpy(np.asarray(jnb, np.int32)),
                               cap)
    np.testing.assert_array_equal(ops.numpy(), jops)
    np.testing.assert_array_equal(score.numpy(), jscore)
    # the port's own fill gives the same codes on the valid cells, and the
    # strings equal the JAX package's
    la_w, lb_w = jdirs.shape[1] - jdirs.shape[2] + 2, jdirs.shape[2] - 1
    ac, bc, na, nb = _port_inputs(sc, sa, sb, la_w, lb_w)
    dirs, corner = nw_fill_dirs_plain(ac, bc, na, nb,
                                      kernel_params(sc, "cpu"))
    v = _valid(jdirs.shape[1], jdirs.shape[2], jna[:B], jnb[:B])
    np.testing.assert_array_equal(dirs.numpy()[v], jdirs[:B][v])
    np.testing.assert_array_equal(corner.numpy(), jcorner[:B])
    got = nw_strings_from_ops(sa, sb, jna, jnb, ops.numpy(), score.numpy())
    want = jax_tb.nw_strings_from_ops(sa, sb, jna, jnb, jops, jscore)
    assert [dataclasses.astuple(g) for g in got] == \
        [dataclasses.astuple(w) for w in want]


def test_walk_cap_rounds_to_256():
    sc = scoring_system_default()
    ac, bc, na, nb = _port_inputs(sc, ["acgt"], ["agt"], 4, 4)
    dirs, corner = nw_fill_dirs_plain(ac, bc, na, nb,
                                      kernel_params(sc, "cpu"))
    ops, _ = nw_walk_plain(dirs, corner, na, nb, 7)
    assert ops.shape == (1, 256)
    assert (ops[0, 4:] == -1).all()


def test_strings_from_ops_raises_on_dir_fail():
    ops = np.array([[0, 3, 0, -1]], np.int8)
    with pytest.raises(RuntimeError, match="traceback fail"):
        nw_strings_from_ops(["acg"], ["acg"], [3], [3], ops, [0])


def test_kernel_params_carries_the_config():
    sc = ScoringConfig(2, -3, -5, -2, case_sensitive=True)
    p = kernel_params(sc, "cpu")
    assert p.scal.dtype == torch.int32 and p.scal.device.type == "cpu"
    assert p.scal.tolist() == [2, -3, -5, -2, sc.dp_floor(False),
                               sc.dp_floor(True)]
    assert p.scal[4].item() == np.iinfo(np.int32).min + 7
    assert p.scal[5].item() == 0  # the SW floor
    assert p.sub is None  # set per batch by pack_batch for table scoring
    np.testing.assert_array_equal(p.fold.numpy(), sc.luts()[0])


def test_pack_helpers_match_dp():
    for n in (1, 3, 64, 100, 4096, 4097, 9000):
        assert tpack.pad_width(n) == dp.pad_width(n)
        assert tpack._next_pow2(n) == dp._next_pow2(n)
    sc = scoring_system_default()
    seqs = ["ACgt", "", "aaaaaaa"]
    for got, want in zip(tpack.pack_inputs_mm(kernel_params(sc), seqs,
                                              seqs[::-1], 8, 9),
                         dp.pack_inputs_mm(sc, seqs, seqs[::-1], 8, 9)):
        np.testing.assert_array_equal(got, want)
    assert tpack.mm_eligible(sc) == dp.mm_eligible(sc)
    strict = ScoringConfig(use_match_mismatch=False)
    strict.add_mutation("a", "c", 3)
    with pytest.raises(ValueError, match="Unknown character pair"):
        tpack.check_valid_pairs(strict, "ag", "c")
    with pytest.raises(ValueError, match="Unknown character pair"):
        dp.check_valid_pairs(strict, "ag", "c")


def test_wrappers_send_cpu_tensors_to_plain_versions():
    sc = scoring_system_default()
    p = kernel_params(sc, "cpu")
    sa, sb = _batch(5, 4, 20, 20)
    ac, bc, na, nb = _port_inputs(sc, sa, sb, 32, 32)
    before = kernel_launch_counts()
    s, c = kernels.nw_scores(ac, bc, na, nb, p)
    sp, cp = nw_scores_plain(ac, bc, na, nb, p)
    assert torch.equal(s, sp) and torch.equal(c, cp)
    d, dc = kernels.nw_fill_dirs(ac, bc, na, nb, p)
    assert torch.equal(dc, cp)
    o, osc = kernels.nw_walk(d, dc, na, nb, 64)
    op, ops_ = nw_walk_plain(d, dc, na, nb, 64)
    assert torch.equal(o, op) and torch.equal(osc, ops_)
    # a plain version is not a launch
    assert kernel_launch_counts() == before


def test_wrappers_reject_what_the_kernels_do_not_take():
    sc = scoring_system_default()
    p = kernel_params(sc, "cpu")
    ac, bc, na, nb = _port_inputs(sc, ["acgt"] * 2, ["acg"] * 2, 8, 8)
    with pytest.raises(ValueError, match="uint8"):
        kernels.nw_scores(ac.int(), bc, na, nb, p)
    with pytest.raises(ValueError, match="int32"):
        kernels.nw_scores(ac, bc, na.long(), nb, p)
    with pytest.raises(ValueError, match="contiguous"):
        kernels.nw_fill_dirs(ac.t().contiguous().t(), bc, na, nb, p)
    with pytest.raises(ValueError, match="same pair count"):
        kernels.nw_scores(ac, bc[:1], na, nb, p)
    with pytest.raises(ValueError, match="is on"):
        kernels.nw_scores(ac, bc.to("meta"), na, nb, p)
    with pytest.raises(ValueError, match="unsupported device"):
        kernels.nw_scores(*(t.to("meta") for t in (ac, bc, na, nb)),
                          p._replace(scal=p.scal.to("meta")))
    d, c = kernels.nw_fill_dirs(ac, bc, na, nb, p)
    with pytest.raises(ValueError, match="same pair count"):
        kernels.nw_walk(d, c[:1], na, nb, 8)


def _fake_nvcc(tmp_path, body):
    bindir = tmp_path / "cuda" / "bin"
    bindir.mkdir(parents=True)
    nvcc = bindir / "nvcc"
    nvcc.write_text("#!/bin/sh\n" + body)
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IEXEC)
    return str(tmp_path / "cuda")


def test_failed_build_raises_with_nvcc_output(tmp_path, monkeypatch):
    monkeypatch.setenv("CUDA_HOME", _fake_nvcc(
        tmp_path, "echo 'error: bad kernel' >&2\nexit 2\n"))
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "_build")
    with pytest.raises(RuntimeError, match="bad kernel"):
        build.build()
    assert not any((tmp_path / "_build").iterdir())


def test_build_is_keyed_by_sources_and_renamed_into_place(tmp_path,
                                                          monkeypatch):
    # a stand-in compiler that writes its output file, to check the
    # temp-name + rename protocol and the content key
    monkeypatch.setenv("CUDA_HOME", _fake_nvcc(
        tmp_path, 'while [ "$1" != "-o" ]; do shift; done\n'
                  'echo built > "$2"\n'))
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "_build")
    out = build.build()
    assert out.parent == tmp_path / "_build"
    assert out.name.startswith("libseqalign_") and out.suffix == ".so"
    assert [p.name for p in out.parent.iterdir()] == [out.name]
    assert build.build() == out  # the same sources reuse the library


def test_missing_nvcc_raises(tmp_path, monkeypatch):
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build._nvcc()
    assert os.environ["PATH"] == str(tmp_path)
