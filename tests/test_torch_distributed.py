"""The port's multi-process files (seqalign_tpu_torch/parallel/
distributed.py): two real processes over gloo on the CPU, each reading its
round-robin pair shard of one input file, filling on the CPU and
allgathering; both must print the complete, pair-ordered result, equal to
the JAX package's single-process one on the same file (the cases of
tests/test_distributed.py).  The worker, tests/_torch_dist_worker.py,
imports only the port; each process's output is awaited with its own
timeout, so that a hang fails the test instead of stalling the run."""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

pytest.importorskip("jax.numpy")

from seqalign_tpu.aligners import NeedlemanWunsch as JaxNW  # noqa: E402
from seqalign_tpu.aligners import SmithWaterman as JaxSW  # noqa: E402
from seqalign_tpu.scoring.presets import scoring_system_default  # noqa: E402
from seqalign_tpu_torch.parallel.distributed import (  # noqa: E402
    distributed_align_file, distributed_score_file, init_from_env,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "_torch_dist_worker.py")
TIMEOUT = 180  # seconds each process may take


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _write_pairs(tmp_path, n_pairs=11, seed=5):
    rng = np.random.default_rng(seed)
    seqs = []
    p = tmp_path / "pairs.fa"
    with open(p, "w") as fh:
        for i in range(2 * n_pairs):
            s = "".join(rng.choice(list("acgt"), rng.integers(2, 30)))
            seqs.append(s)
            fh.write(f">s{i}\n{s}\n")
    return str(p), seqs


def _two_processes(path, *flags):
    """Run two workers over gloo; returns their parsed outputs."""
    port = _free_port()
    procs = []
    for pid in range(2):
        env = dict(os.environ)
        env.update(SEQALIGN_COORDINATOR=f"127.0.0.1:{port}",
                   SEQALIGN_NUM_PROCS="2", SEQALIGN_PROC_ID=str(pid))
        procs.append(subprocess.Popen(
            [sys.executable, WORKER, path, "--device", "cpu", *flags],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, env=env,
            cwd=REPO))
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=TIMEOUT)
            assert p.returncode == 0, err.decode()[-2000:]
            outs.append(json.loads(out.decode().strip().splitlines()[-1]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return outs


@pytest.mark.parametrize("is_sw", [False, True])
def test_two_process_distributed_scores(tmp_path, is_sw):
    path, seqs = _write_pairs(tmp_path)
    outs = _two_processes(path, *(["--sw"] if is_sw else []))
    sa, sb = seqs[0::2], seqs[1::2]
    want = [int(s) for s in (JaxSW().best_score_batch(sa, sb) if is_sw
                             else JaxNW().score_batch(sa, sb))]
    for o in outs:
        assert o["multi"] is True
        assert o["scores"] == want


def test_single_process_distributed_score_file(tmp_path):
    """No coordinator: no process group, a plain local run."""
    path, seqs = _write_pairs(tmp_path, n_pairs=5, seed=9)
    assert init_from_env() is False
    got = distributed_score_file(scoring_system_default(), path, is_sw=False,
                                 device="cpu")
    want = JaxNW().score_batch(seqs[0::2], seqs[1::2])
    np.testing.assert_array_equal(got, np.asarray(want))
    alns = distributed_align_file(scoring_system_default(), path,
                                  is_sw=False, device="cpu")
    assert [(r.result_a, r.result_b, r.score) for r in alns] == [
        (r.result_a, r.result_b, r.score)
        for r in JaxNW().align_batch(seqs[0::2], seqs[1::2])]


@pytest.mark.parametrize("is_sw", [False, True])
def test_two_process_distributed_alignments(tmp_path, is_sw):
    """Full alignments across two processes: both assemble the identical,
    complete, pair-ordered records (scores and the gapped strings)."""
    path, seqs = _write_pairs(tmp_path, n_pairs=9, seed=13)
    outs = _two_processes(path, "--align", *(["--sw"] if is_sw else []))
    sa, sb = seqs[0::2], seqs[1::2]
    if is_sw:
        want = [[[h.result_a, h.result_b, h.score, h.pos_a, h.pos_b]
                 for h in hits]
                for hits in JaxSW().align_batch(sa, sb,
                                                min_scores=[1] * len(sa))]
        norm = lambda alns: [[list(h) for h in hits] for hits in alns]  # noqa: E731
    else:
        want = [[r.result_a, r.result_b, r.score]
                for r in JaxNW().align_batch(sa, sb)]
        norm = lambda alns: [list(r) for r in alns]  # noqa: E731
    for o in outs:
        assert o["multi"] is True
        assert norm(o["alns"]) == want
