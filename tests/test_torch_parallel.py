"""The port's pair-batch sharding (seqalign_tpu_torch/parallel/engine.py) on
a mesh of 8 CPU positions, held exactly to the JAX package's on its
8-virtual-device mesh (tests/conftest.py), on the same seeded inputs: the
seven cases of tests/test_parallel.py, each on both packages."""

import numpy as np
import pytest

pytest.importorskip("jax.numpy")

from seqalign_tpu.aligners import NeedlemanWunsch as JaxNW  # noqa: E402
from seqalign_tpu.parallel import engine as jax_engine  # noqa: E402
from seqalign_tpu.scoring.config import (  # noqa: E402
    ScoringConfig as JaxConfig,
)
from seqalign_tpu.scoring.presets import (  # noqa: E402
    scoring_system_default, scoring_system_sw_default,
)
from seqalign_tpu_torch import from_reference  # noqa: E402
from seqalign_tpu_torch.ops import host_dp, oracle  # noqa: E402
from seqalign_tpu_torch.parallel import engine  # noqa: E402

MESH = engine.Mesh(["cpu"] * 8)


def _rand_pairs(n, rng, maxlen=40):
    pairs = []
    for _ in range(n):
        la, lb = rng.integers(1, maxlen, 2)
        pairs.append(("".join(rng.choice(list("acgt"), la)),
                      "".join(rng.choice(list("acgt"), lb))))
    return pairs


def _aln(a):
    return (a.result_a, a.result_b, int(a.score), int(a.pos_a),
            int(a.pos_b), int(a.len_a), int(a.len_b))


def _split(pairs):
    return [a for a, _ in pairs], [b for _, b in pairs]


def test_sharded_nw_scores_match():
    sa, sb = _split(_rand_pairs(13, np.random.default_rng(7)))  # not x8
    sc = scoring_system_default()
    got = engine.sharded_score_batch(sc, sa, sb, is_sw=False, mesh=MESH)
    want = jax_engine.sharded_score_batch(sc, sa, sb, is_sw=False,
                                          mesh=jax_engine.make_mesh(8))
    np.testing.assert_array_equal(got, want)
    assert got.dtype == np.int32 and got.shape == (13,)
    for a, b, s in zip(sa, sb, got):
        assert oracle.nw_align(from_reference(sc), a, b)[2] == s


def test_sharded_sw_best_scores_match():
    sa, sb = _split(_rand_pairs(8, np.random.default_rng(8)))
    sc = scoring_system_sw_default()
    got = engine.sharded_score_batch(sc, sa, sb, is_sw=True, mesh=MESH)
    want = jax_engine.sharded_score_batch(sc, sa, sb, is_sw=True,
                                          mesh=jax_engine.make_mesh(8))
    np.testing.assert_array_equal(got, want)


def test_sharded_align_batch_traceback_matches_host():
    """Ragged batch: NW alignments and SW hit streams equal the JAX
    package's sharded ones and the host path's."""
    sa, sb = _split(_rand_pairs(11, np.random.default_rng(9)))
    mesh = jax_engine.make_mesh(8)
    sc = scoring_system_default()
    got = [_aln(a) for a in engine.sharded_align_batch(sc, sa, sb,
                                                       is_sw=False,
                                                       mesh=MESH)]
    want = [_aln(a) for a in jax_engine.sharded_align_batch(
        sc, sa, sb, is_sw=False, mesh=mesh)]
    assert got == want
    psc = from_reference(sc)
    assert got == [_aln(host_dp.nw_align(psc, a, b)) for a, b in zip(sa, sb)]
    sw = scoring_system_sw_default()
    got_h = [[_aln(h) for h in it] for it in engine.sharded_align_batch(
        sw, sa, sb, is_sw=True, mesh=MESH)]
    want_h = [[_aln(h) for h in it] for it in jax_engine.sharded_align_batch(
        sw, sa, sb, is_sw=True, mesh=mesh)]
    assert got_h == want_h


def test_sharded_fill_runs_each_shard_on_the_device_path():
    """Every shard of sharded_align_batch runs the align_batch device path
    (the JAX package's check that the v2 kernel ran per shard: its
    "dirs2_sharded" dispatch note), and the alignments equal the JAX
    package's and the host path's."""
    rng = np.random.default_rng(9)
    lut = np.frombuffer(b"acgt", dtype=np.uint8)
    sa = [bytes(lut[rng.integers(0, 4, rng.integers(1, 120))]).decode()
          for _ in range(11)]
    sb = [bytes(lut[rng.integers(0, 4, rng.integers(1, 90))]).decode()
          for _ in range(11)]
    sc = scoring_system_default()
    before = engine.shard_dispatch_counts()["align"]
    res = engine.sharded_align_batch(sc, sa, sb, is_sw=False, mesh=MESH)
    assert engine.shard_dispatch_counts()["align"] - before == MESH.size
    want = jax_engine.sharded_align_batch(sc, sa, sb, is_sw=False,
                                          mesh=jax_engine.make_mesh())
    assert [_aln(r) for r in res] == [_aln(w) for w in want]
    psc = from_reference(sc)
    for j in range(len(sa)):
        w = host_dp.nw_align(psc, sa[j], sb[j])
        assert (res[j].result_a, res[j].result_b, res[j].score) == (
            w.result_a, w.result_b, w.score)


def test_sharded_scores_gap_open_positive_correct():
    """gap_open > 0, NW and SW: equal to the JAX package's sharded scores
    and to the host fill's."""
    sa, sb = _split(_rand_pairs(21, np.random.default_rng(11)))
    sc = JaxConfig(match=2, mismatch=-3, gap_open=1, gap_extend=-1)
    psc = from_reference(sc)
    for is_sw in (False, True):
        got = engine.sharded_score_batch(sc, sa, sb, is_sw=is_sw, mesh=MESH)
        want = jax_engine.sharded_score_batch(sc, sa, sb, is_sw=is_sw,
                                              mesh=jax_engine.make_mesh(8))
        np.testing.assert_array_equal(got, want)
        for i, (a, b) in enumerate(zip(sa, sb)):
            M, Ga, Gb = host_dp.fill_matrices(psc, a, b, is_sw)
            assert got[i] == (M.max(initial=0) if is_sw else max(
                M[-1, -1], Ga[-1, -1], Gb[-1, -1]))


def test_sharded_scores_ragged_batch_dispatches_every_shard():
    """A ragged batch (13 pairs on 8 positions) is padded with filler pairs
    of one letter: every shard is dispatched, and the scores equal the JAX
    package's and the single-device ones."""
    sa, sb = _split(_rand_pairs(13, np.random.default_rng(12)))
    sc = scoring_system_default()
    before = engine.shard_dispatch_counts()["scores"]
    got = engine.sharded_score_batch(sc, sa, sb, is_sw=False, mesh=MESH)
    assert engine.shard_dispatch_counts()["scores"] - before == MESH.size
    np.testing.assert_array_equal(got, jax_engine.sharded_score_batch(
        sc, sa, sb, is_sw=False, mesh=jax_engine.make_mesh(8)))
    np.testing.assert_array_equal(got, JaxNW(sc).score_batch(sa, sb))


def test_sharded_score_stream_double_buffered():
    """Per-batch results of the stream equal the JAX package's stream and
    sharded_score_batch, in order, with several batches in flight."""
    rng = np.random.default_rng(17)
    sc = scoring_system_default()
    batches = [_split(_rand_pairs(n, rng)) for n in (13, 8, 3, 16)]
    got = list(engine.sharded_score_stream(sc, iter(batches), is_sw=False,
                                           mesh=MESH, depth=3))
    want = list(jax_engine.sharded_score_stream(
        sc, iter(batches), is_sw=False, mesh=jax_engine.make_mesh(8),
        depth=3))
    assert len(got) == len(want) == len(batches)
    for (sa, sb), g, w in zip(batches, got, want):
        np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(g, engine.sharded_score_batch(
            sc, sa, sb, is_sw=False, mesh=MESH))


def test_mesh_and_packed_entry():
    """make_mesh never falls back to the CPU without a card; a mesh may
    repeat a device; the packed entry is memoised on the config's value
    and equals the JAX package's packed entry."""
    import torch

    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            engine.make_mesh()
        with pytest.raises(RuntimeError):
            engine.make_mesh(2)
    cpu = engine.make_mesh(3, axis="seq", device="cpu")
    assert cpu.devices == (torch.device("cpu"),) * 3 and cpu.shape == {
        "seq": 3}
    sc = scoring_system_default()
    fn = engine.make_sharded_score_fn(sc, MESH, is_sw=False)
    assert fn is engine.make_sharded_score_fn(scoring_system_default(), MESH,
                                              is_sw=False)
    from seqalign_tpu.ops import dp as jax_dp
    from seqalign_tpu_torch import kernel_params
    from seqalign_tpu_torch.ops.pack import pack_batch

    rng = np.random.default_rng(1)
    lut = np.frombuffer(b"acgt", dtype=np.uint8)
    a, b = (lut[rng.integers(0, 4, (16, 16))] for _ in range(2))
    sa = [bytes(r).decode() for r in a]
    sb = [bytes(r).decode() for r in b]
    ac, bc, na, nb, _ = pack_batch(from_reference(sc),
                                   kernel_params(sc), sa, sb, 16, 16)
    got = fn(ac, bc, na, nb)
    jac, jbc, subK, imK = jax_dp.compact_inputs(sc, a, b)
    want = np.asarray(jax_engine.make_sharded_score_fn(
        sc, jax_engine.make_mesh(8), is_sw=False)(
        jac, jbc, na, nb, subK, imK))
    np.testing.assert_array_equal(got, want)


def test_dryrun_on_cpu_positions_loads_no_jax():
    """The dry run (the port's dryrun_multichip) on 4 CPU positions, in a
    process of its own: it passes, and neither JAX nor the JAX package is
    loaded."""
    import os
    import subprocess
    import sys

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    code = ("import sys\n"
            "from seqalign_tpu_torch.parallel import dryrun\n"
            "dryrun.main(['4', '--cpu'])\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'seqalign_tpu'))\n"
            "assert not bad, bad\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=root,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    assert "dryrun_multichip(4): OK" in r.stdout
