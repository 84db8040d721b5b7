"""chip_smoke.py's host checks (``HostChecks``): the plain SW hit loop and
the numpy Gotoh optima run in ``spawn`` worker processes on the host's CPU
and give what they give in the calling process; a worker sees no CUDA
device and loads neither JAX nor the JAX package; a comparison that fails
and a worker that dies both raise when the checks settle."""

import os
import sys

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402
import seqalign_tpu_torch as port  # noqa: E402
from seqalign_tpu_torch import kernel_params  # noqa: E402
from seqalign_tpu_torch.ops.dp import sw_fill_dirs_plain  # noqa: E402
from seqalign_tpu_torch.ops.traceback import sw_hits_plain  # noqa: E402


@pytest.fixture(scope="module")
def host():
    h = cs.HostChecks(2)
    yield h
    h.close()


def test_workers_see_no_card_and_no_jax(host):
    got = {}
    host.submit(lambda v: got.update(cuda=v), os.getenv,
                "CUDA_VISIBLE_DEVICES")
    host.submit(lambda v: got.update(mods=v), eval,
                "sorted(__import__('sys').modules)")
    host.settle()
    assert got["cuda"] == ""
    assert not [m for m in got["mods"]
                if m.split(".")[0] in ("jax", "jaxlib", "seqalign_tpu")]


def test_hit_loop_and_optima_equal_the_callers(host):
    rng = np.random.default_rng(7)
    sc = port.presets.scoring_system_sw_default()
    A, B = cs.dna(rng, 6, 40, 90), cs.dna(rng, 6, 40, 90)
    (ac, bc, na, nb), bp, (na_h, nb_h) = cs.packed(
        sc, kernel_params(sc, "cpu"), A, B, "cpu")
    d, m = sw_fill_dirs_plain(ac, bc, na, nb, bp, True)
    args = cs.hit_args(d, ac, bc, na, nb, m, na_h, nb_h, 1, bp, 8)
    want = sw_hits_plain(*args)
    late, times = {}, {}
    cs.HOST = host
    try:
        cs.hits_on_host(late, times, "sw_hits[x]", args, want, 1.5)
        opts = {}
        for i in range(3):
            cs.check_optimum(lambda o, i=i: opts.__setitem__(i, o),
                             cs.eq_table(sc), sc.gap_open, sc.gap_extend,
                             A[i], B[i], local=True)
        host.settle()
    finally:
        cs.HOST = None
    assert late == {"sw_hits[x]": 0}
    assert times["sw_hits[x]"][0] == 1.5 and times["sw_hits[x]"][1] > 0
    assert host.rows == {"sw_hits[x]"}
    assert opts == {i: cs.gotoh(cs.eq_table(sc), sc.gap_open, sc.gap_extend,
                                A[i], B[i], local=True) for i in range(3)}
    # a kernel output that differs shows in the max |diff|
    bad = [want[0], want[1] + 1, want[2]]
    cs.HOST = host
    try:
        cs.hits_on_host(late, times, "sw_hits[y]", args, bad)
        host.settle()
    finally:
        cs.HOST = None
    assert late["sw_hits[y]"] == 1


def test_a_failed_check_and_a_dead_worker_raise():
    h = cs.HostChecks(1)
    try:
        def then(opt):
            raise AssertionError(f"optimum {opt}")

        h.submit(then, cs._host_gotoh, cs.eq_table(port.ScoringConfig(
            1, -2, -4, -1)), -4, -1, "acgt", "acgt")
        with pytest.raises(AssertionError, match="optimum 4"):
            h.settle()
        h.submit(lambda _: None, os._exit, 3)
        with pytest.raises(Exception):
            h.settle()
    finally:
        h.close()


def test_witnesses_defer_their_optima():
    sc = port.presets.scoring_system_default()
    table = cs.eq_table(sc)
    h = cs.HostChecks(1)
    cs.HOST = h
    try:
        cs.witness_scores(table, sc, ["acgtt"], ["acgt"], np.array([0]),
                          [0], "wrong score")
        with pytest.raises(AssertionError, match="not the numpy Gotoh"):
            h.settle()
        opt = cs.gotoh(table, sc.gap_open, sc.gap_extend, "acgtt", "acgt")
        cs.witness_scores(table, sc, ["acgtt"], ["acgt"], np.array([opt]),
                          [0], "right score")
        h.settle()
    finally:
        cs.HOST = None
        h.close()
