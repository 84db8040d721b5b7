"""Counts of the SW hit loop's work, on the CPU: the numbers behind the
``sw_hits`` kernel's window and pre-walk depth (csrc/sw_hits.cu).

For each pair of a hint-less DNA batch under the SW default (the shape of
``chip_smoke.py``'s ``sw_hits`` row, 512 x 512 bp, k = 16, sequences made
as its ``seqs`` makes them), the serial hit loop of ``sw_hits_plain`` is
run again with counters: the candidates harvested, those visited before
the k-th hit, those skipped as marked, those whose MATCH predecessor was
marked, the walks started, the hits, the cells the walks entered and how
many walks entered each number of cells.  Then the kernel's order of work:
its windows of 32 candidates, and for each pre-walk depth S the dependent
code loads it takes, S a window plus the cells past S of every walk.

    python -m seqalign_tpu_torch.tools.hits_count [--pairs 2]
        [--length 512] [--k 16] [--seed 1]

Plain PyTorch on the CPU; nothing is timed.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from ..ops.dp import sw_fill_dirs_plain, sw_sorted_candidates
from ..ops.pack import DIR_FAIL, GAP_A, MATCH, kernel_params, pack_batch
from ..scoring.presets import scoring_system_sw_default

DEPTHS = (2, 3, 4, 6, 8, 12, 16)
WINDOW = 32


def dna(rng, n, length):
    """``n`` DNA strings of ``length`` as chip_smoke.py's ``seqs`` draws
    them."""
    lens = rng.integers(length, length + 1, n)
    letters = np.frombuffer(b"acgtACGT", np.uint8)
    blob = letters[rng.integers(0, 8, int(lens.sum()), dtype=np.uint8)]
    blob = blob.tobytes().decode()
    return [blob[e - length:e] for e in np.cumsum(lens).tolist()]


def count(A, B, k):
    """Per pair, a dict of the counts (module docstring)."""
    sc = scoring_system_sw_default()
    p = kernel_params(sc, "cpu")
    ac, bc, na, nb, bp = pack_batch(sc, p, A, B, max(map(len, A)),
                                    max(map(len, B)))
    t = [torch.from_numpy(v) for v in (ac, bc, na, nb)]
    dirs, m = sw_fill_dirs_plain(*t, bp, True)
    flat, score, off = sw_sorted_candidates(m, na, nb, 1)
    LBp = dirs.shape[2]
    codes = dirs.numpy().reshape(len(A), -1)
    match, mismatch, gap_open, ge = bp.scal[:4].tolist()
    out = []
    for j in range(len(A)):
        w = int(na[j]) + 1
        fl = flat[off[j]:off[j + 1]].numpy().astype(np.int64)
        sco = score[off[j]:off[j + 1]].numpy()
        mask = bytearray((int(nb[j]) + 1) * w)
        c = dict(harvested=len(fl), visited=0, marked=0, pred_marked=0,
                 walks=0, hits=0)
        cells = []
        i = 0
        while i < len(fl) and c["hits"] < k:
            f = int(fl[i])
            i += 1
            if mask[f]:
                c["marked"] += 1
                continue
            if mask[f - w - 1]:
                mask[f] = 1
                c["pred_marked"] += 1
                continue
            c["walks"] += 1
            x, y, curr, cs = f % w, f // w, MATCH, int(sco[i - 1])
            entered = 0
            while True:
                g = y * w + x
                if mask[g]:
                    break
                mask[g] = 1
                entered += 1
                if cs == 0:
                    c["hits"] += 1
                    break
                code = int(codes[j, (x + y - 2) * LBp + y])
                nxt = (code >> (2 * curr)) & 3
                if x < 1 or y < 1 or nxt == DIR_FAIL:
                    raise RuntimeError("sw traceback fail")
                if curr == MATCH:
                    cs -= match if ac[j, x - 1] == bc[j, y - 1] else mismatch
                    x, y = x - 1, y - 1
                else:
                    cs -= ge if nxt == curr else gap_open + ge
                    if curr == GAP_A:
                        y -= 1
                    else:
                        x -= 1
                curr = nxt
            cells.append(entered)
        c["visited"] = i
        cells = np.asarray(cells)
        c["cells"] = int(cells.sum())
        c["walks_by_cells"] = np.bincount(np.minimum(cells, 20)).tolist()
        c["windows"] = -(-i // WINDOW)
        c["loads_by_depth"] = {
            s: c["windows"] * s + int(np.maximum(cells - s, 0).sum())
            for s in DEPTHS}
        out.append(c)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--pairs", type=int, default=2)
    ap.add_argument("--length", type=int, default=512)
    ap.add_argument("--k", type=int, default=16)
    ap.add_argument("--seed", type=int, default=1)
    args = ap.parse_args(argv)
    rng = np.random.default_rng(args.seed)
    A = dna(rng, args.pairs, args.length)
    B = dna(rng, args.pairs, args.length)
    for j, c in enumerate(count(A, B, args.k)):
        print(f"pair {j}: {c}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
