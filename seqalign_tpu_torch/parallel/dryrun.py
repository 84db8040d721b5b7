"""The multi-device dry run: the port's counterpart of
``__graft_entry__.dryrun_multichip`` (``__graft_entry__.py:52-150``),
step by step on a mesh of the port's devices.

    python -m seqalign_tpu_torch.parallel.dryrun N [--cpu | --repeat]

runs it on the first N CUDA devices, on N positions of the CPU
(``--cpu``, the kernels' plain versions), or on N positions of ``cuda:0``
(``--repeat``, one card shared by the shards' streams).
"""

from __future__ import annotations

import argparse
import sys
from typing import Optional

import numpy as np

from ..ops import host_dp
from ..ops.kernels import kernel_launch_counts
from ..ops.pack import kernel_params, pack_batch
from ..scoring.config import ScoringConfig
from ..scoring.presets import scoring_system_default, scoring_system_sw_default
from .engine import (Mesh, make_mesh, make_sharded_score_fn,
                     shard_dispatch_counts, sharded_align_batch)
from .wavefront_sp import sp_scores


def _check(ok: bool, what: str):
    if not ok:
        raise AssertionError(f"dryrun_multichip: {what}")


def _launched(before: dict, names) -> dict:
    now = kernel_launch_counts()
    return {k: now[k] - before[k] for k in names}


def _sharded_align(sc, rag_a, rag_b, is_sw, mesh, what):
    """``sharded_align_batch`` with its shard dispatches counted and, on a
    CUDA mesh, its fill launched once per shard."""
    fill = "sw_fill_dirs[ragged]" if is_sw else "nw_fill_dirs[ragged]"
    before, d0 = kernel_launch_counts(), shard_dispatch_counts()["align"]
    out = sharded_align_batch(sc, rag_a, rag_b, is_sw=is_sw, mesh=mesh)
    if is_sw:
        out = [list(h) for h in out]
    _check(shard_dispatch_counts()["align"] - d0 == mesh.size,
           f"{what}: not one dispatch a shard")
    if mesh.devices[0].type == "cuda":
        n = _launched(before, (fill,))[fill]
        _check(n == mesh.size, f"{what}: {fill} launched {n} times on "
                               f"{mesh.size} shards")
    return out


def dryrun_multichip(n_devices: int, mesh: Optional[Mesh] = None) -> None:
    """Score a batch with its pairs sharded over an ``n_devices`` mesh (by
    default the first ``n_devices`` CUDA devices), then check, each against
    its single-device or host result: sequence-parallel scores, ragged NW
    alignments and SW hit streams, a constrained config with a wildcard
    table, and that each shard launched the fill kernels once (on a CUDA
    mesh; the engine's shard dispatches on any)."""
    mesh = mesh if mesh is not None else make_mesh(n_devices)
    if mesh.size != n_devices:
        raise ValueError(f"the mesh has {mesh.size} devices, not {n_devices}")
    sc = scoring_system_default()
    rng = np.random.default_rng(1)
    B, L = 2 * n_devices, 16
    lut = np.frombuffer(b"acgt", dtype=np.uint8)
    seqs_a = [bytes(r).decode() for r in lut[rng.integers(0, 4, (B, L))]]
    seqs_b = [bytes(r).decode() for r in lut[rng.integers(0, 4, (B, L))]]

    # data-parallel scores through the packed entry
    ac, bc, na, nb, _ = pack_batch(sc, kernel_params(sc), seqs_a, seqs_b, L,
                                   L)
    before = kernel_launch_counts()
    scores = make_sharded_score_fn(sc, mesh, is_sw=False)(ac, bc, na, nb)
    _check(scores.shape == (B,), f"scores of shape {scores.shape}")
    _check(bool((scores > -(10 ** 9)).all() and (scores <= L).all()),
           f"scores out of range: {scores}")
    if mesh.devices[0].type == "cuda":
        _check(_launched(before, ("nw_scores",))["nw_scores"] == n_devices,
               "nw_scores not launched once a shard")

    # sequence parallel: the lanes split over the mesh, the same scores
    sp = sp_scores(sc, seqs_a, seqs_b, Mesh(mesh.devices, "seq"))
    _check(np.array_equal(sp, scores), f"sp_scores {sp} != {scores}")

    # ragged full alignments: NW alignments and SW hit streams equal to the
    # host path's
    rag_a = [s[:3 + (i * 5) % 13] for i, s in enumerate(seqs_a)]
    rag_b = [s[:2 + (i * 7) % 11] for i, s in enumerate(seqs_b)]
    got = _sharded_align(sc, rag_a, rag_b, False, mesh, "NW")
    _check(got == [host_dp.nw_align(sc, x, y) for x, y in zip(rag_a, rag_b)],
           "sharded NW alignments differ from the host path's")
    sw = scoring_system_sw_default()
    got = _sharded_align(sw, rag_a, rag_b, True, mesh, "SW")
    _check(got == [list(host_dp.HostSwHits(sw, x, y))
                   for x, y in zip(rag_a, rag_b)],
           "sharded SW hit streams differ from the host path's")

    # a constrained config with a wildcard table (no_gaps_in_a, end-gap
    # exception): the host path's alignments too
    csc = ScoringConfig(2, -3, -5, -2, no_gaps_in_a=True)
    csc.add_wildcard("n", 1)
    got = _sharded_align(csc, rag_a, rag_b, False, mesh, "constrained NW")
    _check(got == [host_dp.nw_align(csc, x, y)
                   for x, y in zip(rag_a, rag_b)],
           "sharded constrained NW alignments differ from the host path's")
    print(f"dryrun_multichip({n_devices}): OK on {mesh} (dp scores + sp "
          f"scores + ragged NW/SW traceback + constrained table, each "
          f"shard's fill launched once), scores={scores[:4]}...")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("n_devices", type=int)
    where = ap.add_mutually_exclusive_group()
    where.add_argument("--cpu", action="store_true",
                       help="N positions of the CPU")
    where.add_argument("--repeat", action="store_true",
                       help="N positions of cuda:0")
    args = ap.parse_args(argv)
    mesh = None
    if args.cpu:
        mesh = make_mesh(args.n_devices, device="cpu")
    elif args.repeat:
        mesh = Mesh(make_mesh(1).devices * args.n_devices)
    dryrun_multichip(args.n_devices, mesh)
    return 0


if __name__ == "__main__":
    sys.exit(main())
