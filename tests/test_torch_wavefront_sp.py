"""The port's sequence-parallel fills (seqalign_tpu_torch/parallel/
wavefront_sp.py) on a mesh of 8 CPU positions, held exactly to the JAX
package's on its 8-virtual-device mesh, on the same seeded inputs (the
five cases of tests/test_wavefront_sp.py), and a numpy model of the slice
launch (csrc/tile_carry.cuh, SLICE; :func:`test_torch_tile.
tile_carry_model` with a :class:`test_torch_tile.Part`): the pairs' lanes
cut into slices of whole rounds, each slice a launch of its rounds whose
first round reads the edge row of the slice before and whose last writes
its own, the slices and chunks run in the wavefront's order, every read of
an edge row checked against what its producer wrote; held chunk by chunk
to the JAX package's ``dp.fill_chunked`` at 2, 3 and 4 slices."""

import numpy as np
import pytest
import torch

pytest.importorskip("jax.numpy")

from seqalign_tpu.aligners import NeedlemanWunsch as JaxNW  # noqa: E402
from seqalign_tpu.aligners import SmithWaterman as JaxSW  # noqa: E402
from seqalign_tpu.ops import dp as jax_dp  # noqa: E402
from seqalign_tpu.parallel import engine as jax_engine  # noqa: E402
from seqalign_tpu.parallel import wavefront_sp as jax_sp  # noqa: E402
from seqalign_tpu.scoring.config import (  # noqa: E402
    ScoringConfig as JaxConfig,
)
from seqalign_tpu.scoring.presets import (  # noqa: E402
    scoring_system_default, scoring_system_sw_default,
)
from seqalign_tpu_torch import from_reference, kernel_params  # noqa: E402
from seqalign_tpu_torch.ops import dp as port_dp  # noqa: E402
from seqalign_tpu_torch.ops import kernels  # noqa: E402
from seqalign_tpu_torch.ops.pack import pack_batch  # noqa: E402
from seqalign_tpu_torch.parallel import wavefront_sp  # noqa: E402
from seqalign_tpu_torch.parallel.engine import Mesh  # noqa: E402
from test_torch_tile import Part, Rec, tile_carry_model  # noqa: E402

MESH = Mesh(["cpu"] * 8, axis="seq")


def _pairs(rng, n, lo=30, hi=200):
    out = []
    for _ in range(n):
        la, lb = rng.integers(lo, hi, 2)
        out.append(("".join(rng.choice(list("acgt"), la)),
                    "".join(rng.choice(list("acgt"), lb))))
    return out


def _aln(a):
    return (a.result_a, a.result_b, int(a.score))


def test_sp_nw_scores_match():
    pairs = _pairs(np.random.default_rng(21), 3)
    sa, sb = [a for a, _ in pairs], [b for _, b in pairs]
    sc = scoring_system_default()
    got = wavefront_sp.sp_scores(sc, sa, sb, MESH)
    want = jax_sp.sp_scores(sc, sa, sb, jax_engine.make_mesh(8, axis="seq"))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, JaxNW(sc).score_batch(sa, sb))


def test_sp_sw_best_match():
    pairs = _pairs(np.random.default_rng(22), 3)
    sa, sb = [a for a, _ in pairs], [b for _, b in pairs]
    sc = scoring_system_sw_default()
    got = wavefront_sp.sp_scores(sc, sa, sb, MESH, is_sw=True)
    want = jax_sp.sp_scores(sc, sa, sb, jax_engine.make_mesh(8, axis="seq"),
                            is_sw=True)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, JaxSW(sc).best_score_batch(sa, sb))


def test_sp_scores_unsupported_config_routes_to_engine():
    """A constrained config takes _scores_auto, as in the JAX package."""
    sc = JaxConfig(1, -2, -4, -1, no_gaps_in_a=True)
    seqs_a = ["acgtacgt", "ttgcagca"]
    seqs_b = ["acgtt", "tggca"]
    got = wavefront_sp.sp_scores(sc, seqs_a, seqs_b, MESH)
    want = jax_sp.sp_scores(sc, seqs_a, seqs_b,
                            jax_engine.make_mesh(axis="seq"))
    np.testing.assert_array_equal(got, np.asarray(want))
    np.testing.assert_array_equal(got, JaxNW(sc).score_batch(seqs_a, seqs_b))


def test_sp_align_nw_matches_align_long():
    """One pair's lanes split over the mesh, the codes of each slice
    written into one slab: the strings and score equal the JAX package's
    sp_align_nw and align_long, and the slab equals the plain carry's
    codes cell for cell."""
    rng = np.random.default_rng(31)
    lut = np.frombuffer(b"acgt", dtype=np.uint8)
    sc = scoring_system_default()
    jmesh = jax_engine.make_mesh(axis="seq")
    for la, lb, chunk in [(700, 640, 128), (65, 900, 256), (257, 63, 64)]:
        a = bytes(lut[rng.integers(0, 4, la)]).decode()
        b = bytes(lut[rng.integers(0, 4, lb)]).decode()
        got = wavefront_sp.sp_align_nw(sc, a, b, MESH, chunk=chunk)
        want = jax_sp.sp_align_nw(sc, a, b, jmesh, chunk=chunk)
        assert _aln(got) == _aln(want)
        assert _aln(got) == _aln(JaxNW(sc).align_long(a, b, chunk=chunk))
    (slab, corner, na, nb), ca = wavefront_sp._sp_nw_fill(
        from_reference(sc), a, b, MESH, "seq", 64)
    ref = jax_dp.fill_chunked(sc, [a], [b], is_sw=False, chunk=ca,
                              emit_dirs=True, validate=False)
    y = np.arange(lb + 1)[None, :]
    xl = np.arange(ca + lb - 1)[:, None] + 2 - y
    for c, d in enumerate(ref[2]):
        v = (y >= 1) & (xl >= 1) & (xl <= ca) & (xl + c * ca <= la)
        np.testing.assert_array_equal(slab[0, c].numpy()[v],
                                      np.asarray(d)[0][v])
        assert not slab[0, c].numpy()[~v].any()  # nothing else written
    assert corner.tolist()[0] == np.asarray(ref[0])[0].tolist()


def test_sp_align_nw_ineligible_falls_back():
    sc = JaxConfig(1, -2, -4, -1, no_mismatches=True)
    got = wavefront_sp.sp_align_nw(sc, "acgt", "agt", MESH)
    want = jax_sp.sp_align_nw(sc, "acgt", "agt",
                              jax_engine.make_mesh(axis="seq"))
    assert got.score is not None and _aln(got) == _aln(want)


# the slice model: R lanes a thread, W warps a round (a round of 64 lanes),
# chunks of CA columns; b over 1-5 rounds, ends on round edges, a pair
# shorter than a slice, empty sides, a pair that ends on the last column of
# chunk 1 and one on the first column of chunk 1
MODEL_R, MODEL_W, MODEL_CA = 1, 2, 48
MODEL_LENS = [(130, 317), (100, 135), (96, 64), (70, 40), (0, 50), (40, 0),
              (0, 0), (49, 257), (120, 128)]


@pytest.mark.parametrize("kind", ["nw", "sw"])
@pytest.mark.parametrize("nslices", [2, 3, 4])
def test_slice_model_equals_fill_chunked(nslices, kind):
    """The slices of every chunk, run by the model in the wavefront's order
    with 1-5 blocks resident in a random order, against the JAX package's
    ``dp.fill_chunked``: every valid cell of each slab written once, by the
    slice that holds its lane, codes (and SW M) equal; each slice's bout on
    its own lanes 1 .. nb of the pairs that reach the chunk's last column;
    the edge rows out only for the pairs with lanes past the slice, on the
    columns 0 .. min(CA, na - x_off); the NW corner written by exactly one
    slice, the SW best the max of the slices'."""
    sw = kind == "sw"
    sc = scoring_system_sw_default() if sw else scoring_system_default()
    rng = np.random.default_rng(nslices * 11 + len(kind))
    A = ["".join(rng.choice(list("acgt"), n)) for n, _ in MODEL_LENS]
    B = ["".join(rng.choice(list("acgt"), m)) for _, m in MODEL_LENS]
    ca = MODEL_CA
    corner_ref, best_ref, dch, mch, _, _ = jax_dp.fill_chunked(
        sc, A, B, is_sw=sw, chunk=ca, emit_dirs=True, emit_m=sw,
        validate=False)
    p = kernel_params(sc, "cpu")
    LA, LB = max(map(len, A)), max(map(len, B))
    ac, bc, na, nb, bp = pack_batch(from_reference(sc), p, A,
                                    B, LA, LB)
    g = 32 * MODEL_R * MODEL_W
    lanes = kernels.slice_lanes(LB, nslices, g)
    assert len(lanes) == nslices
    nB, D, LBp = len(A), ca + LB - 1, LB + 1
    nch = -(-LA // ca)
    assert len(dch) == nch
    bins = [port_dp.boundary_column(bp, nB, LB, is_sw=sw).numpy().astype(
        np.int64) for _ in lanes]
    unset = -(1 << 40)
    corners = [np.full((nB, 3), unset, np.int64) for _ in lanes]
    bests = [np.zeros(nB, np.int64) for _ in lanes]
    recs = [Rec(nB * D * LBp, np.int32) for _ in range(nch)]
    edges = {}
    y = np.arange(LBp)
    yb = np.arange(LBp)[None, None, :]
    xl = np.arange(D)[None, :, None] + 2 - yb
    for t in range(nslices + nch - 1):
        for k in range(max(0, t - nch + 1), min(nslices, t + 1)):
            c = t - k
            y_lo, y_hi = lanes[k]
            ein, ein_at = edges.pop((k - 1, c), (None, None))
            eout = eout_at = None
            if k < nslices - 1:
                eout = rng.integers(-2 ** 31, 2 ** 31, (nB, 3, ca + 1))
                eout_at = np.full((nB, ca + 1), -1, np.int64)
            part = Part(y_lo // g, -(-min(y_hi, LB) // g), ein, ein_at, eout,
                        eout_at)
            bout = rng.integers(-2 ** 31, 2 ** 31, (nB, 3, LBp))
            before = bout.copy()
            bw = np.zeros((nB, LBp), np.int64)
            tile_carry_model(ac, bc, na, nb, p.scal.numpy(), None, 0, sw,
                             MODEL_R, MODEL_W, c * ca, ca, bins[k], bout,
                             recs[c], bw, corners[k], bests[k],
                             int(rng.choice([1, 2, 3, 5])), rng, None, part)
            reach = ((na >= (c + 1) * ca)[:, None] & (y >= 1)
                     & (y <= nb[:, None]) & (y > y_lo) & (y <= y_hi))
            np.testing.assert_array_equal(bw, reach.astype(np.int64))
            keep = np.broadcast_to(~reach[:, None, :], bout.shape)
            np.testing.assert_array_equal(bout[keep], before[keep])
            bins[k] = bout
            if eout is not None:
                wa = np.clip(na.astype(np.int64) - c * ca, 0, ca)
                past = (nb > y_hi) & (wa > 0)
                want_at = np.where(past[:, None] & (np.arange(ca + 1)[None]
                                                    <= wa[:, None]),
                                   np.arange(ca + 1)[None], -1)
                np.testing.assert_array_equal(eout_at, want_at)
                edges[k, c] = (eout, eout_at)
        if t >= nslices - 1:  # every slice has filled chunk t - nslices + 1
            c = t - nslices + 1
            v = ((yb >= 1) & (yb <= nb[:, None, None]) & (xl >= 1)
                 & (xl <= ca) & (xl + c * ca <= na[:, None, None]))
            rec = recs[c]
            np.testing.assert_array_equal(rec.writes.reshape(nB, D, LBp),
                                          v.astype(np.int64))
            np.testing.assert_array_equal(rec.codes.reshape(nB, D, LBp)[v],
                                          np.asarray(dch[c])[v])
            if sw:
                np.testing.assert_array_equal(rec.m.reshape(nB, D, LBp)[v],
                                              np.asarray(mch[c])[v])
    if sw:
        np.testing.assert_array_equal(np.max(bests, axis=0),
                                      np.asarray(best_ref))
    else:
        written = sum((cn != unset).all(1) for cn in corners)
        np.testing.assert_array_equal(written, np.ones(nB, np.int64))
        got = np.max(corners, axis=0)
        want = np.asarray(corner_ref).copy()
        empty = [i for i, a in enumerate(A) if not a]
        if empty:  # fill_chunked leaves an empty seq_a's corner at 0
            out, _, _ = jax_dp.fill_batch(
                sc, [A[i] for i in empty], [B[i] for i in empty],
                is_sw=False, emit_dirs=False, pad_a=1,
                pad_b=max(1, max(len(B[i]) for i in empty)), validate=False)
            want[empty] = np.asarray(out.corner)
        np.testing.assert_array_equal(got, want)


def test_slice_lanes_are_whole_rounds():
    """The host's cut of a pair's lanes into slices: runs of whole rounds,
    as even as the rounds allow, the last cut at LB, none empty; and the
    slice wrappers refuse a slice past lane 0 without its edge row and a
    config with scoring flags."""
    assert kernels.slice_lanes(65536, 2, 1024) == [(0, 32768),
                                                   (32768, 65536)]
    assert kernels.slice_lanes(3000, 4, 512) == [(0, 512), (512, 1536),
                                                 (1536, 2048), (2048, 3000)]
    assert kernels.slice_lanes(700, 8, 512) == [(0, 512), (512, 700)]
    assert kernels.slice_lanes(200, 8, 1)[-1] == (175, 200)
    assert kernels.slice_granule(4) == 32 * kernels.TILE_R * 4
    sc = from_reference(scoring_system_default())
    ac, bc, na, nb, bp = pack_batch(sc, kernel_params(sc), ["acgt"] * 2,
                                    ["acg"] * 2, 4, 3)
    t = [torch.from_numpy(v) for v in (ac, bc, na, nb)]
    bin = port_dp.boundary_column(bp, 2, 3, is_sw=False)
    corner = torch.zeros((2, 3), dtype=torch.int32)
    with pytest.raises(ValueError, match="edge_in"):
        kernels.nw_scores_slice(*t, bp, 0, 4, (1, 3), 1, bin,
                                torch.empty_like(bin), corner)
    with pytest.raises(ValueError, match="default flags"):
        kernels.nw_scores_slice(*t, bp._replace(modes=1), 0, 4, (0, 3), 1,
                                bin, torch.empty_like(bin), corner)


def test_sp_align_nw_gathers_the_other_devices_parts():
    """Slices on distinct devices write their own slabs, which are gathered
    into the first device's before the walk: "cpu" and "cpu:0" are two
    devices to the mesh (two slabs, both in host memory), and the gathered
    slab, corner and alignment equal those of one device."""
    rng = np.random.default_rng(33)
    a = "".join(rng.choice(list("acgt"), 300))
    b = "".join(rng.choice(list("acgt"), 250))
    sc = from_reference(scoring_system_default())
    two = Mesh(["cpu", "cpu:0", "cpu", "cpu:0"], "seq")
    (slab, corner, _, _), _ = wavefront_sp._sp_nw_fill(sc, a, b, two, "seq",
                                                       64)
    (slab1, corner1, _, _), _ = wavefront_sp._sp_nw_fill(sc, a, b, MESH,
                                                         "seq", 64)
    assert torch.equal(slab, slab1) and torch.equal(corner, corner1)
    got = wavefront_sp.sp_align_nw(sc, a, b, two, chunk=64)
    want = JaxNW(scoring_system_default()).align_long(a, b, chunk=64)
    assert _aln(got) == _aln(want)
