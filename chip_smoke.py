#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``seqalign_tpu_torch``) on one GPU.

Usage, from the repository root on a machine with an NVIDIA H100:

    python3 chip_smoke.py [--profile DIR] [--walk-ab] [--chunk-ab]
                          [--fills [--tree DIR]] [--walks [--tree DIR]]
                          [--gab [--tree DIR]]
                          [--harvest-ab [--tree DIR]]
                          [--walls [--tree DIR]] [--hits-long FILE
                          [--tree DIR]] [--sass [OLD_TREE]]

It builds the port's CUDA kernels from ``seqalign_tpu_torch/csrc`` and
drives the main paths through the user entry points, with inputs made by
numpy from a fixed seed:

1. each kernel and scoring mode against its plain PyTorch version on the
   same CUDA tensors (exact equality on the valid cells): ragged DNA and
   BLOSUM62 protein batches (B = 64), 1-10 kb pairs padded to the widths
   the main path gives the kernels (2,048 lanes in one round of the
   tiles, 6,144 and 10,240 in several), each batch's fills also as one
   launch across widths (at 6,144 and 10,240 lanes every pair takes
   round rows of the register tiles' scratch), and the SW hit loop and
   walks on the harvested candidates; then kernel and plain timed with CUDA events at
   B = 256, L = 512; the carry fills of long pairs (rows ``*[carry]``) chunk
   by chunk on 4 pairs of 5,000-6,144 x 1,500-2,048 (equality, BLOSUM62
   with an empty side, nsg+neg) and at 10,240 lanes (4 pairs, and 16 of
   path long's 6-10 kb of b at the default flags and under nsg+neg, rows
   ``nw_fill_dirs[carry,B16]`` and ``nw_fill_dirs[carry,nsg+neg,B16]``;
   the register tiles of csrc/tile_carry.cuh, a round of a pair's lanes a
   block, under nsg+neg too, row ``nw_fill_dirs[carry,nsg+neg]``), and the
   walks over their slabs (rows ``*[chunked]``); the four fills under each recurrence
   mode (the flag combinations of ``MODES`` and gap_open > 0; rows
   ``<kernel>[<mode>]``) at that shape and on ragged batches with empty
   sides, equality and BLOSUM62, and under flag combinations at 6,144 and
   10,240 lanes; the SW hit loop and walk under free end gaps and under the
   LCS recipe; the matrix-dump fills (``nw_fill_gab``, ``sw_fill_gab``:
   codes and the M, Ga and Gb planes) on the ragged batches, default flags
   and every flag combination of ``MODES``, timed at B = 256, L = 512, and
   on one pair each of ``GAB_PAIRS`` (rows ``[dump]``, CLI job 5's 300 x
   200, and ``[wide]``, 3,000 x 2,500, past a round of the tiles), exact
   and timed;
   and one fill launch across widths (rows ``nw_fill_dirs[ragged]``,
   ``nw_scores[ragged]``: a fill schedule, the codes in planes at each
   pair's widths) on CLI job 1's mix of 256 pairs of 1-10 kb, against the
   uniform launches of its width buckets on every pair, kernel against
   kernel, and against the plain versions on 8 ragged pairs of up to
   300 bp, timed beside the bucket launches; and the same for SW (rows ``sw_fill_dirs[ragged]``,
   ``sw_hits[ragged]``: codes and M in planes at each pair's widths, the
   hit loop over them) on the first sub-batch ``align_batch`` cuts of SW
   job 3's mix; the walks over those planes (rows ``nw_walk[ragged]``,
   ``sw_walk[ragged]``: CLI job 1's 256 pairs, the hits of SW job 3's
   sub-batch) against their plain versions on every walk, each walk row
   with its longest walk's steps and ns a step; and the fills' register
   tiles (csrc/tile_fill.cuh) on
   pairs at the strip edges (b of 31, 32R-1, 32R, 32R+1 and 2*32R+3 lanes
   for R lanes a thread, empty sides, one pair of 2,100 lanes whose
   strips take two rounds), NW and SW, equality, BLOSUM62, nsg+neg and
   the LCS recipe (the flags' instantiations), uniform and across widths,
   M int16 and int32; and the slices of the carry (rows
   ``nw_scores_slice``, ``nw_fill_dirs_slice``, ``sw_scores_slice``: the
   first carry case's 4 pairs split into 3 slices of whole rounds, from a
   generator of their own) against their plain versions, both through the
   port's sequence-parallel driver (``wavefront_sp.slice_fill``: every
   chunk in the wavefront's order, a stream a slice), the corners or
   bests, the edge rows and the slabs byte for byte, timed over the whole
   fill;
2. path ``nw``, NW on DNA: ``NeedlemanWunsch.score_batch`` on 4,096 x 512,
   ``score_pairs_stream`` on 16,384 pairs of 1-10 kb (a quarter of
   BASELINE.json configs[4]), ``align_batch`` on 512 x 256-512 and
   1,024 x 1-10 kb;
3. path ``nw_table``, NW with BLOSUM62 (the substitution-table mode):
   ``score_batch`` on 4,096 protein pairs of 100-1,000 aa and
   ``align_batch`` on 256 of them;
4. paths ``sw`` (DNA, SW default scoring) and ``sw_table`` (protein,
   BLOSUM62, BASELINE.json configs[2]): ``SmithWaterman.best_score_batch``
   on 4,096 DNA pairs x 512, 4,096 DNA pairs of 1-10 kb and 4,096 protein
   pairs of 100-1,000 aa; ``align_batch`` jobs consuming their first hits
   per pair: 512 DNA pairs of 256-512 bp without a hint (16 hits), 256 DNA
   pairs of 1-10 kb with a planted segment and min_score = best - 10
   (8 hits), and 1,024 protein pairs with a planted homologous segment and
   min_score 100, twice the random background (8 hits, --maxhits);
5. path ``modes``, every recurrence mode through the entry points, each
   mode under its own launch counts: on 256 DNA pairs of 512 bp NW
   ``score_batch`` and ``align_batch`` and SW ``best_score_batch`` (the
   mode rows of bench.py among them), and SW ``align_batch`` on 256 pairs
   of 256-512 bp, first 8 hits; NW ``align_batch`` with free start and end
   gaps on 1,024 reads of 256-512 bp against references of 1-10 kb; the
   LCS recipe on 256 DNA sequences of 512-2,048 bp against themselves,
   first 8 hits with pos_a < pos_b, and ``lcs_hits`` on 4 of 2,048 bp;
6. path ``long``, pairs over ``LONG_PAIR_CELLS`` (long reads against
   reference windows): NW ``align_batch`` on 64 DNA pairs of 20-40 kb x
   6-10 kb, and 16 of them under free start and end gaps; SW
   ``align_batch`` on 32 such pairs with a planted 2 kb segment (5%
   substitutions), min_score = best - 10, and on 4 of them without a hint,
   first 8 hits; ``align_long`` for NW and SW on one pair each; one SW
   pair of 48 kb x 48 kb whose flats pass 2^31; SW under
   ``ref_mask_compat`` on 2 pairs (the host branch).  Each job prints its
   GCUPS, wall, busy share, carry launches per chunk, chunks, slab bytes,
   harvested candidates, peak device memory and top device items;
7. path ``vpu``, the ALU probe (T1, ``python -m
   seqalign_tpu_torch.tools.exp_vpu``, its ``run``) once per row of
   ``VPU_ROWS``: each op and type at 256 x 512 lanes and 512 steps, roll
   at 32 lanes (a move's row in a warp's registers, ``kernels.vpu_layout``);
   it holds ``vpu_chain`` to its plain version and times it, and its T
   ops/s is printed;
8. path ``cli``, the three CLIs' ``main`` in-process, stdout to a file, on
   inputs written from the seed into a temporary directory: job 1
   (BASELINE.json configs[1]) ``needleman_wunsch --printscores --file`` on
   4,096 DNA pairs of 1-10 kb in gzip FASTA; job 2 (configs[2])
   ``smith_waterman --scoring BLOSUM62 --minscore 100 --maxhits 8 --file``
   on 1,024 protein pairs with a planted segment; job 3 (configs[3])
   ``needleman_wunsch --freestartgap --freeendgap --wildcard N 0
   --case_sensitive --printscores --file`` on 1,024 reads of 256-512 bp
   against references of 1-10 kb; job 4 ``lcs`` on 512 bp (every hit);
   job 5 ``--printmatrices`` for NW and SW on a 300 x 200 pair.  Each job
   runs once under ``torch.profiler`` with its launch counts (wall,
   pairs/s, GCUPS, busy share, output bytes), its output is parsed and
   checked (scores against ``score_batch``, alignments and hits spelled
   and rescored by the numpy Gotoh, repeats spelled, the dumps' corner or
   best equal to the score), and its first 32 pairs (jobs 4 and 5 whole)
   print the same bytes on the card and under ``SEQALIGN_FORCE=host``;
   then ``python -m seqalign_tpu_torch.cli.needleman_wunsch --printscores
   CAGACGT CGATA`` starts cold on the card and prints score -11;
9. path ``parallel``, the multi-device layer (``seqalign_tpu_torch/
   parallel/``) on meshes of positions of this card (and of every card
   where the machine has more), from a generator of its own:
   ``sharded_score_batch`` and ``sharded_align_batch`` on 1,024 DNA pairs
   of 1-10 kb (BASELINE.json configs[4]'s lengths), NW and SW scores and
   NW alignments, and SW alignments (hint-free, as the JAX signature has
   no hint: the first 8 hits of each stream) on 512 pairs of 256-512 bp
   (path sw's job 1), equal to the single-device ``score_batch``,
   ``best_score_batch`` and ``align_batch`` on a mesh of two positions of
   the card; ``sp_scores`` on 4 pairs of
   64 kb x 64 kb, NW and SW, on 2 and 4 slices, equal to ``score_batch`` /
   ``best_score_batch``; ``sp_align_nw`` on one pair of 48 kb x 48 kb on 2
   and 4 slices, equal to ``align_long``, its slab equal to the unsplit
   carry kernel's byte for byte; ``distributed_score_file`` and
   ``distributed_align_file`` (NW) on 256 pairs in two processes over gloo
   on this card (``tests/_torch_dist_worker.py``), equal to one process's;
   ``dryrun_multichip(2)`` on two positions of the card; and the two
   library examples (``seqalign_tpu_torch/examples/``) printing on the card
   what they print on the CPU.

Each path is held against the plain versions on the card (a sample) and
against numpy Gotoh recurrences written here, global and local, with
equality scoring or the BLOSUM62 table read from the repository's matrix
file: the optimum must equal the score, and every sampled NW alignment and
SW hit must spell its inputs and rescore to its score (on the long path
every alignment and hit, its optimum taken from the scores kernel).
Launch counts are zeroed just before each path and read just after it; a
kernel of the path that was not launched fails the run, and the plain
versions must see no CUDA tensor in the paths.  The checks whose plain
side is host work, the plain SW hit loop of phase 1's hint-less rows and
the numpy Gotoh optima, run in ``HOST_WORKERS`` processes (``spawn``, no
CUDA device visible) on the host's CPU beside the card's work; each is
compared as it settles, all before the ``kernels`` line, and a
disagreement or a dead worker fails the run.  Every other plain version
runs on the card (``ops/dp.py``'s fill a block of diagonals' scores at
once and some 14-25 operations a diagonal).  A ``split`` line gives each
block of phase 1 and each path its wall by part: the kernels' wrappers
(phase 1), the plain versions and the rest.
``--walk-ab`` instead times the first ``AB_PAIRS`` pairs of each SW align
job under each walk branch (every pair on the host walk, then every pair's
hits found on the card), host, device, device, host, and stops: the
measurement behind the walk cutover ``_SW_DEVWALK_CANDS``.  ``--chunk-ab`` instead times the
long path's NW and SW ``align_batch`` at several chunk widths (the
measurement behind ``LONG_CHUNK``) and stops.  ``--fills`` instead times
the four default fills at phase 1's B = 256, L = 512 and as one launch
across widths (phase 1's ragged rows), NW's and SW's codes fills under
BLOSUM62, ``sw_hits``, ``sw_fill_dirs`` under the LCS flags and the NW
fills under nsg+neg (``MODES``), ``nw_fill_gab`` (``GAB``) and one carry
chunk, at the default flags and under nsg+neg (on a tree with
``kernels.carry_warps`` also carry chunks at 1 to 16 warps a block), and
stops; it uses only the kernel wrappers' API, so with ``--tree DIR`` it
times the package of an older checkout in DIR in the same call.
``--walks [--tree DIR]`` instead times each walk row at its shape through
the wrappers' API (``walks_only``) and stops.  ``--gab [--tree DIR]``
instead times the matrix dump's fills at phase 1's shape and on one pair
of each of ``GAB_PAIRS``, and CLI job 5's walls (``gab_only``), and stops.
``--walls [--tree DIR]`` instead times the stream, NW ``align_batch`` on
1,024 pairs of 1-10 kb, CLI jobs 1-3, SW job 3, path modes' NW
``align_batch`` under nsg+neg and its LCS job, and path long's jobs 1, 2,
3, 5 and 6 (walls, and their fills and walks by CUDA events) and stops.
``--hits-long FILE [--tree DIR]`` instead runs path long's job 4 (SW, no
hint, 8 hits) from a generator of its own, prints its wall and launch
counts, writes its hit streams to FILE and stops: two trees' files
compare pair by pair.
``--harvest-ab [--tree DIR]`` instead times SW job 3's and CLI job 2's
alignments (walls; fills, harvests and hit loops by CUDA events) and
stops: the measurement behind the ragged harvest's design and the hit
masks' shared memory (``harvest_ab``).  ``--profile DIR`` runs
each main-path job once more under ``torch.profiler``, prints its device
time and busy share and writes the ``key_averages`` tables to DIR.
``--sass [OLD_TREE]`` instead compiles ``csrc/*.cu`` to SASS with the
build's nvcc flags and stops: it prints the instruction mix of each probe
kernel and of an add-then-max chain written here (both addmax forms give
``VIADDMNMX``), each tile fill's, tile carry's and walk's with its
registers, spills and local memory instructions (the flags' MODES ones
and the matrix dump's GAB ones among them), and with an older checkout of
the repository in OLD_TREE compares every tile instantiation the two trees
share, a tile fill matched by name without its trailing GAB = false,
instruction by instruction, and every other kernel (the check that a
template change left the other fills as they were).

The second-to-last line is a JSON summary of the kernels and modes (each
row with its launches on its path, its times, where its plain version ran
(``plain_on``: ``cuda``, or ``cpu`` for a host worker), and the least time
the card could take for the same work, from the bytes moved and the int32
instructions issued), the last line ``{"ok": true, "device": {...}}``.  Any
failure raises (exit code != 0); without a CUDA device it exits with code 1
and prints no result.  It imports no JAX.
"""

from __future__ import annotations

import argparse
import contextlib
import itertools
import json
import os
import subprocess
import sys
import time
import types

import numpy as np
import torch

SEED = 1729
_CSRC = "seqalign_tpu_torch/csrc/"
_B1 = "seqalign_tpu/ops/pallas_dp2.py:199"
_B2 = "seqalign_tpu/ops/pallas_dp2.py:780"
_SWW = "seqalign_tpu/ops/traceback.py:607"
# sw_hits takes over the host hit loop of SwHitIterator.fetch
_SWH = "seqalign_tpu/ops/traceback.py:376"
# row -> (launch counter, source, TPU kernel replaced); a "[table]" row is
# the substitution-table mode of its kernel, launched by the path
# "<kernel family>_table"
_B4C = "seqalign_tpu/ops/pallas_dp.py:1224"  # fill_dirs_long, B4 chunked
KERNELS = {
    "nw_scores": ("nw_scores", "nw_scores.cu", _B1),
    "nw_fill_dirs": ("nw_fill_dirs", "nw_dirs.cu", _B2),
    "nw_walk": ("nw_walk", "nw_walk.cu", "seqalign_tpu/ops/traceback.py:515"),
    "nw_scores[table]": ("nw_scores", "nw_scores.cu", _B1),
    "nw_fill_dirs[table]": ("nw_fill_dirs", "nw_dirs.cu", _B2),
    "sw_scores": ("sw_scores", "sw_scores.cu", _B1),
    "sw_fill_dirs": ("sw_fill_dirs", "sw_dirs.cu", _B2),
    "sw_walk": ("sw_walk", "sw_walk.cu", _SWW),
    "sw_hits": ("sw_hits", "sw_hits.cu", _SWH),
    "sw_scores[table]": ("sw_scores", "sw_scores.cu", _B1),
    "sw_fill_dirs[table]": ("sw_fill_dirs", "sw_dirs.cu", _B2),
    "sw_walk[table]": ("sw_walk", "sw_walk.cu", _SWW),
    "sw_hits[table]": ("sw_hits", "sw_hits.cu", _SWH),
    "nw_fill_dirs[carry]": ("nw_fill_dirs_carry", "nw_dirs.cu", _B4C),
    "sw_fill_dirs[carry]": ("sw_fill_dirs_carry", "sw_dirs.cu", _B4C),
    # the carry at path long's width: 16 pairs, b of 6-10 kb, many rounds
    "nw_fill_dirs[carry,B16]": ("nw_fill_dirs_carry", "nw_dirs.cu", _B4C),
    # the carry under flags (MODES): its launches are long job 2's, 4
    # pairs at their 2,048 lanes and 16 at path long's 10,240
    "nw_fill_dirs[carry,nsg+neg]": ("nw_fill_dirs_carry", "nw_dirs.cu",
                                    _B4C),
    "nw_fill_dirs[carry,nsg+neg,B16]": ("nw_fill_dirs_carry", "nw_dirs.cu",
                                        _B4C),
    "nw_walk[chunked]": ("nw_walk", "nw_walk.cu",
                         "seqalign_tpu/ops/traceback.py:515"),
    "sw_walk[chunked]": ("sw_walk", "sw_walk.cu", _SWW),
    "sw_hits[chunked]": ("sw_hits", "sw_hits.cu", _SWH),
    # the matrix dump: dp_fill's emit_gab planes (a lax.scan, not Pallas)
    "nw_fill_gab": ("nw_fill_gab", "nw_dirs.cu", "seqalign_tpu/ops/dp.py:621"),
    "sw_fill_gab": ("sw_fill_gab", "sw_dirs.cu", "seqalign_tpu/ops/dp.py:621"),
    # the same on one pair: CLI job 5's, and one of b past a round of the
    # tiles' lanes (GAB_PAIRS)
    "nw_fill_gab[dump]": ("nw_fill_gab", "nw_dirs.cu",
                          "seqalign_tpu/ops/dp.py:621"),
    "sw_fill_gab[dump]": ("sw_fill_gab", "sw_dirs.cu",
                          "seqalign_tpu/ops/dp.py:621"),
    "nw_fill_gab[wide]": ("nw_fill_gab", "nw_dirs.cu",
                          "seqalign_tpu/ops/dp.py:621"),
    "sw_fill_gab[wide]": ("sw_fill_gab", "sw_dirs.cu",
                          "seqalign_tpu/ops/dp.py:621"),
    # one launch across widths (a fill schedule; codes and SW M in ragged
    # planes, which sw_hits reads)
    "nw_fill_dirs[ragged]": ("nw_fill_dirs[ragged]", "nw_dirs.cu", _B2),
    "nw_scores[ragged]": ("nw_scores[ragged]", "nw_scores.cu", _B1),
    "sw_scores[ragged]": ("sw_scores[ragged]", "sw_scores.cu", _B1),
    "sw_fill_dirs[ragged]": ("sw_fill_dirs[ragged]", "sw_dirs.cu", _B2),
    "sw_hits[ragged]": ("sw_hits[ragged]", "sw_hits.cu", _SWH),
    # the walks over the planes of one launch across widths
    "nw_walk[ragged]": ("nw_walk", "nw_walk.cu",
                        "seqalign_tpu/ops/traceback.py:515"),
    "sw_walk[ragged]": ("sw_walk", "sw_walk.cu", _SWW),
    # the sequence-parallel fills: lane slices of the tile carry, phase 1's
    # 4-pair carry case in 3 slices; their launches are path parallel's
    "nw_scores_slice": ("nw_scores_slice", "nw_scores.cu",
                        "seqalign_tpu/parallel/wavefront_sp.py:36"),
    "sw_scores_slice": ("sw_scores_slice", "sw_scores.cu",
                        "seqalign_tpu/parallel/wavefront_sp.py:36"),
    "nw_fill_dirs_slice": ("nw_fill_dirs_slice", "nw_dirs.cu",
                           "seqalign_tpu/parallel/wavefront_sp.py:171"),
}
_NW = ("nw_scores", "nw_fill_dirs", "nw_walk")
_SW = ("sw_scores", "sw_fill_dirs", "sw_walk", "sw_hits")
PATHS = {"nw": _NW, "nw_table": _NW, "sw": _SW, "sw_table": _SW,
         "modes": _NW + _SW,
         "long": ("nw_fill_dirs_carry", "sw_fill_dirs_carry", "nw_walk",
                  "sw_walk", "sw_hits"),
         "cli": ("nw_fill_dirs", "nw_walk", "sw_fill_dirs", "sw_hits",
                 "sw_walk", "nw_fill_gab", "sw_fill_gab"),
         "vpu": ("vpu_chain",),
         "parallel": _NW + _SW + ("nw_fill_dirs_carry", "nw_scores_slice",
                                  "sw_scores_slice", "nw_fill_dirs_slice")}
# the recurrence modes: name -> ScoringConfig flags ("gap_open>0" is a mode
# of the penalties); every mode gets a row per fill kernel,
# "<kernel>[<mode>]", and the walks rows under neg and the LCS recipe
MODES = {
    "nsg": dict(no_start_gap_penalty=True),
    "neg": dict(no_end_gap_penalty=True),
    "nsg+neg": dict(no_start_gap_penalty=True, no_end_gap_penalty=True),
    "nga": dict(no_gaps_in_a=True),
    "ngb": dict(no_gaps_in_b=True),
    "nga+ngb": dict(no_gaps_in_a=True, no_gaps_in_b=True),
    "nmm": dict(no_mismatches=True),
    "neg+nga": dict(no_end_gap_penalty=True, no_gaps_in_a=True),
    "nga+ngb+nmm": dict(no_gaps_in_a=True, no_gaps_in_b=True,
                        no_mismatches=True),
    "gap_open>0": dict(),
}
ALL_FLAGS = dict(no_start_gap_penalty=True, no_end_gap_penalty=True,
                 no_gaps_in_a=True, no_gaps_in_b=True, no_mismatches=True)
_B3 = "seqalign_tpu/ops/pallas_dp.py:101"
_B4 = "seqalign_tpu/ops/pallas_dp.py:375"
for _m in MODES:
    _both = _m.startswith("nga+ngb")  # the TPU path serves these from v1
    KERNELS.update({
        f"nw_scores[{_m}]": ("nw_scores", "nw_scores.cu",
                             _B3 if _both else _B1),
        f"nw_fill_dirs[{_m}]": ("nw_fill_dirs", "nw_dirs.cu", _B2),
        f"sw_scores[{_m}]": ("sw_scores", "sw_scores.cu",
                             _B3 if _both else _B1),
        f"sw_fill_dirs[{_m}]": ("sw_fill_dirs", "sw_dirs.cu",
                                _B2 if _m == "gap_open>0" else _B4)})
for _m in ("neg", "lcs"):
    KERNELS.update({f"sw_walk[{_m}]": ("sw_walk", "sw_walk.cu", _SWW),
                    f"sw_hits[{_m}]": ("sw_hits", "sw_hits.cu", _SWH)})
# T1, the ALU probe (tools/exp_vpu.py:60): (op, dtype, lanes) at the JAX
# tool's 256 rows and 512 steps
VPU_ROWS = ([(op, dt, 512) for dt in ("int32", "int16")
             for op in ("addmax", "add", "roll", "shift")]
            + [("roll", "int32", 32)])
VPU_R, VPU_S = 256, 512


def vpu_row(op, dt, lanes) -> str:
    return f"vpu_chain[{op},{dt}{'' if lanes == 512 else f',L{lanes}'}]"


for _r in VPU_ROWS:
    KERNELS[vpu_row(*_r)] = ("vpu_chain", "exp_vpu.cu", "tools/exp_vpu.py:60")
MODE_WIDE = ((6144, 4097, 6144, 4, "nsg+neg"),
             (10240, 7169, 10000, 4, "all five flags"))
MODE_B, MODE_L = 256, 512  # the mode rows' shape (bench.py:268-286)
READ_REF_PAIRS = 1024  # reads against references of 1-10 kb
READ_LEN = (256, 512)
LCS_SEQS = 256  # DNA sequences of 512-2,048 bp against themselves
LCS_PLANT = 64  # length of the repeat planted in each of them
# Published peaks of one H100 SXM: 3.35 TB/s of HBM3; 67 TFLOP/s float32
# outside the tensor cores, which is 128 lanes x 2 (a fused multiply-add)
# per SM and clock.  An int32 instruction (add, max, compare, select, the
# DPX add-max) has 64 lanes an SM and clock: a quarter of that, 16.75 T
# lane instructions a second.  One instruction does at most two of the
# int32 operations the bounds count: an add and a max (the DPX VIADDMNMX,
# which nvcc also makes of max(a + b, c)), two adds (IADD3), two maxes (the
# three-input max).  The ALU probe (T1) runs its add-max, add and packed
# int16 chains at 14.0-15.1 T instructions a second on the card.
PEAK_BYTES = 3.35e12
PEAK_INT32 = 67e12 / 4
OPS_PER_INSTR = 2


def alu_s(ops):
    """The least seconds the card takes for ``ops`` int32 operations:
    ``OPS_PER_INSTR`` an instruction at ``PEAK_INT32``."""
    return ops / OPS_PER_INSTR / PEAK_INT32
# phase 1 at main-path widths (width, shortest, longest, pairs): a pair's
# strips take one round of the tiles at 2,048 lanes, several (their edge
# through round rows in global scratch) at 6,144 and 10,240
WIDE = ((2048, 1000, 2048, 4), (6144, 4097, 6144, 4), (10240, 7169, 10000, 4))
SHORT_BATCH = 4096
# the ragged rows: CLI job 1's chunk (256 pairs of 1-10 kb, one
# align_batch call of the CLI)
RAGGED_PAIRS = 256
STREAM_PAIRS = 16_384  # a quarter of BASELINE.json configs[4]'s 65,536
ALIGN_LONG_PAIRS = 1024
PROTEIN_PAIRS = 4096  # BASELINE.json configs[2]: 100-1,000 aa
NW_TABLE_ALIGN = 256
SW_LONG_PAIRS = 4096
# SW align jobs: (name, pairs, hits consumed per pair)
SW_JOB1 = ("job 1", 512, 16)
SW_JOB2 = ("job 2", 1024, 8)
SW_JOB3 = ("job 3", 256, 8)
AB_PAIRS = 64  # pairs of each SW align job in the walk-branch A/B
PROTEIN_MIN_SCORE = 100  # random 1,000 x 1,000 aa pairs score 42-57
# phase 1's carry rows: chunks of the JAX package's 2,048 columns; (label,
# |a| range, |b| range, lanes, pairs): 4 pairs of up to 2,048 lanes (the
# tiles in 4 rounds of 4 warps, under nsg+neg too: row
# nw_fill_dirs[carry,nsg+neg]), 4 at 10,240 lanes, and 16 pairs of path
# long's 6-10 kb of b at 10,240 lanes, NW only, at the default flags (10
# rounds of 8 warps, row nw_fill_dirs[carry,B16]) and under nsg+neg (long
# job 2's launch shape: 10 rounds of 16 warps at 2 lanes a thread, row
# nw_fill_dirs[carry,nsg+neg,B16]); the plain fill's diagonals are most of
# phase 1's time, and the 4 pairs hold SW at this width
CARRY_CA = 2048
CARRY_CASES = (("equality", (5000, 6144), (1500, 2048), None, 4),
               ("BLOSUM62", (5000, 6144), (1500, 2048), None, 4),
               ("nsg+neg", (5000, 6144), (1500, 2048), None, 4),
               ("equality", (2049, 4096), (7169, 10000), 10240, 4),
               ("equality", (2049, 4096), (6000, 10000), 10240, 16))
# path long: long reads against reference windows
LONG_A, LONG_B = (20_000, 40_000), (6_000, 10_000)
LONG_NW, LONG_NSG, LONG_SW, LONG_HINTLESS = 64, 16, 32, 4
LONG_SEG, LONG_SUB = 2000, 0.05  # the planted homologous segment
GIANT = 48_000  # one SW pair past 2^31 cells
DNA = np.frombuffer(b"acgtACGT", np.uint8)
AMINO = np.frombuffer(b"ARNDCQEGHILKMFPSTWYV", np.uint8)
GAP = ord("-")
BLOSUM62_FILE = "seqalign_tpu_torch/data/scoring/BLOSUM62.txt"


_T0 = time.perf_counter()


def log(*args):
    print(f"[{time.perf_counter() - _T0:7.1f} s]", *args, flush=True)


def gpu_name_power() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, check=True, timeout=60)
    return r.stdout.strip().splitlines()[0]


def seqs(rng, n, lo, hi, alpha=DNA):
    """``n`` strings over ``alpha``, lengths uniform in [lo, hi]."""
    lens = rng.integers(lo, hi + 1, n)
    blob = alpha[rng.integers(0, len(alpha), int(lens.sum()), dtype=np.uint8)]
    blob = blob.tobytes().decode()
    ends = np.cumsum(lens).tolist()
    return [blob[e - k:e] for e, k in zip(ends, lens.tolist())]


def dna(rng, n, lo, hi):
    return seqs(rng, n, lo, hi)


def planted(rng, alpha, n, lo, hi, frac, sub):
    """``n`` random pairs, lengths in [lo, hi], each with a segment of a
    (a ``frac`` range share of the shorter side) copied into b with
    substitutions at rate ``sub`` and 1-3 indels of 1-3 letters."""
    A, B = seqs(rng, n, lo, hi, alpha), seqs(rng, n, lo, hi, alpha)
    for i in range(n):
        a = np.frombuffer(A[i].encode(), np.uint8)
        b = np.frombuffer(B[i].encode(), np.uint8).copy()
        k = max(1, int(min(len(a), len(b)) * rng.uniform(*frac)))
        pa = int(rng.integers(0, len(a) - k + 1))
        seg = a[pa:pa + k].copy()
        hit = rng.random(k) < sub
        seg[hit] = alpha[rng.integers(0, len(alpha), int(hit.sum()))]
        for _ in range(int(rng.integers(1, 4))):
            p, m = int(rng.integers(0, len(seg))), int(rng.integers(1, 4))
            if rng.random() < 0.5:
                seg = np.delete(seg, slice(p, p + m))
            else:
                seg = np.insert(seg, p, alpha[rng.integers(0, len(alpha), m)])
        seg = seg[:len(b)]
        pb = int(rng.integers(0, len(b) - len(seg) + 1))
        b[pb:pb + len(seg)] = seg
        B[i] = b.tobytes().decode()
    return A, B


def packed(sc, params, seqs_a, seqs_b, dev, width=None):
    """Pack a batch on ``dev`` for its scoring mode: both sides to
    ``width``, or each to its pow2 / 1024-granular width.  Returns the
    (ac, bc, na, nb) tensors, the batch's params and the host lengths."""
    from seqalign_tpu_torch.ops.pack import pack_batch, pad_width

    la = width or pad_width(max(map(len, seqs_a)))
    lb = width or pad_width(max(map(len, seqs_b)))
    ac, bc, na, nb, bp = pack_batch(sc, params, seqs_a, seqs_b, la, lb)
    return (tuple(torch.from_numpy(v).to(dev) for v in (ac, bc, na, nb)),
            bp, (na, nb))


def valid_mask(D, LBp, na, nb):
    """Mask of the cells 1 <= y <= nb, 1 <= x <= na of skewed (B, D, LBp)
    planes."""
    y = torch.arange(LBp, device=na.device)[None, None, :]
    x = torch.arange(D, device=na.device)[None, :, None] + 2 - y
    return ((y >= 1) & (y <= nb[:, None, None]) & (x >= 1)
            & (x <= na[:, None, None]))


def valid_cells(dirs, na, nb):
    return valid_mask(dirs.shape[1], dirs.shape[2], na, nb)


def max_abs(*pairs) -> int:
    return max(int((a.long() - b.long()).abs().max()) if a.numel() else 0
               for a, b in pairs)


def cuda_ms(fn, reps, warm=True):
    """Mean milliseconds of ``fn()`` over ``reps`` runs, CUDA events, after
    one warm-up run unless ``warm`` is false."""
    if warm:
        fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def walk_starts(cands, na, per_pair, dev):
    """Walk starts (jw, x0, y0, s0) on the card for the ``per_pair``
    best-scoring harvested candidates of each pair."""
    jw, fl, sc0 = [], [], []
    for j, (f, s) in enumerate(cands):
        top = np.argsort(-s.astype(np.int64), kind="stable")[:per_pair]
        jw.append(np.full(len(top), j))
        fl.append(f[top])
        sc0.append(s[top])
    jw = np.concatenate(jw)
    fl = np.concatenate(fl)
    w = np.asarray(na, np.int64)[jw] + 1
    return [torch.from_numpy(np.asarray(v, np.int32)).to(dev)
            for v in (jw, fl % w, fl // w, np.concatenate(sc0))]


def hit_args(d, ac, bc, na, nb, m, na_h, nb_h, thr, bp, k):
    """The arguments of ``sw_hits`` for the candidates of M at ``thr``."""
    from seqalign_tpu_torch.ops.dp import sw_sorted_candidates

    flat, score, off = sw_sorted_candidates(m, na_h, nb_h, thr)
    return d, ac, bc, na, nb, flat, score, off[:-1], off[1:], bp, k


def near_best(scores):
    """Harvest thresholds 20 below each pair's best score: the walk checks
    start at the best cells without harvesting the whole plane."""
    return np.maximum(scores.cpu().numpy().astype(np.int64) - 20, 1)


def mode_scoring(mode, sw=False, table=False):
    """The config of one recurrence mode: the NW default 1/-2/-4/-1 or the
    SW default 2/-2/-2/-1 with the mode's flags, or BLOSUM62 with them;
    2/-3/1/-1 for gap_open > 0.  A both-no-gaps NW config takes mismatch -5
    so that it stays out of the sentinel-wrap regime, which the aligner
    routes to the host."""
    import seqalign_tpu_torch as port

    flags = ALL_FLAGS if mode == "all five flags" else MODES[mode]
    if table:
        sc = port.presets.scoring_system_BLOSUM62()
        for k, v in flags.items():
            setattr(sc, k, v)
        if mode == "gap_open>0":
            sc.gap_open = 1
        sc._luts = None
        return sc
    if mode == "gap_open>0":
        return port.ScoringConfig(2, -3, 1, -1)
    if sw:
        return port.ScoringConfig(2, -2, -2, -1, **flags)
    both = flags.get("no_gaps_in_a") and flags.get("no_gaps_in_b")
    return port.ScoringConfig(1, -5 if both else -2, -4, -1, **flags)


def fill_bound(na_h, nb_h, sw, dirs, mbytes=0, table=0, flags=(),
               extra_bytes=0):
    """The least milliseconds the card could take for one fill of these
    pairs, and what bounds it.  Operations: int32 adds, maxes, compares and
    selects of the recurrence per cell (the score 2; M 4, Ga 6, Gb 6; the
    SW best 1; the codes 9 + 6 + 6 and 4 to pack them; a flag's own
    compares and selects), two an instruction (``alu_s``).  Bytes: the letters, lengths,
    scalars and table read once, the scores (and NW corners) and, with
    codes, 1 + ``mbytes`` per valid cell written once, and ``extra_bytes``
    (a carry launch's boundary columns in and out), over
    ``PEAK_BYTES``."""
    n = len(na_h)
    cells = int((na_h.astype(np.int64) * nb_h).sum())
    per_cell = 18 + bool(sw) + (25 if dirs else 0)
    per_cell += sum({"nsg": 0, "neg": 8, "nga": 2, "ngb": 2, "nmm": 2}[k]
                    + (3 if dirs and k != "nsg" else 0) for k in flags)
    moved = (int(na_h.sum() + nb_h.sum()) + 8 * n + 24 + 4 * table
             + (4 if sw else 16) * n + cells * (bool(dirs) + mbytes)
             + extra_bytes)
    t_ops, t_bytes = alu_s(cells * per_cell), moved / PEAK_BYTES
    return (1e3 * max(t_ops, t_bytes),
            "operations" if t_ops >= t_bytes else "bytes")


# walk row -> the steps of its longest walk (``walk_bound``): a launch takes
# at least that walk's chain of dependent reads, whatever its bound
WALK_STEPS: dict = {}


def walk_bound(name, ops, per_step, fixed):
    """The bound of walk row ``name`` from the trace its kernel wrote: every
    step taken reads ``per_step`` bytes (a code, and for SW two letters)
    and does about 8 int32 operations (``alu_s``); the whole trace is
    written once, and ``fixed`` bytes of starts and corners are read.  The
    longest walk's steps go to ``WALK_STEPS``."""
    WALK_STEPS[name] = int((ops >= 0).sum(1).max()) if len(ops) else 0
    steps = int((ops >= 0).sum())
    t_ops = alu_s(8 * steps)
    t_bytes = (per_step * steps + ops.numel() + fixed) / PEAK_BYTES
    return (1e3 * max(t_ops, t_bytes),
            "operations" if t_ops >= t_bytes else "bytes")


def hits_bound(args, out):
    """The bound of one ``sw_hits`` launch: the candidates it has to visit
    (all of a pair's when they ran out, else up to the last hit found), 8
    bytes and about 6 int32 operations (``alu_s``) each, plus the hit records written.
    The cells its walks mark are left out: a lower bound."""
    flat, lo, hi, k = args[5], args[7], args[8], args[10]
    hit_flat, _, nhits = out
    n = hi - lo
    pair = torch.repeat_interleave(torch.arange(len(n), device=flat.device),
                                   n)
    full = nhits == k
    is_last = (flat == hit_flat[:, k - 1][pair]) & full[pair]
    pos = is_last.nonzero()[:, 0]
    visited = int(n[~full].sum() + (pos - lo[pair[pos]] + 1).sum())
    t_ops = alu_s(6 * visited)
    t_bytes = (8 * visited + 8 * hit_flat.numel()) / PEAK_BYTES
    return (1e3 * max(t_ops, t_bytes),
            "operations" if t_ops >= t_bytes else "bytes")


def modes_vs_plain(mode, dev, rng, times, bounds):
    """The four fills under one mode against the plain fill, max |diff| of
    each: on 256 DNA pairs of 512 bp, where kernel and plain are timed too
    (the plain runs are the reference), and on ragged batches of 256 pairs
    (empty sides among them), equality and BLOSUM62, where the matrix-dump
    fills (rows ``nw_fill_gab``, ``sw_fill_gab``) are held to the plain
    fill's M, Ga and Gb planes too."""
    from seqalign_tpu_torch import kernel_params
    from seqalign_tpu_torch.ops import kernels
    from seqalign_tpu_torch.ops.dp import (_fill, nw_fill_dirs_plain,
                                           nw_scores_plain,
                                           sw_fill_dirs_plain,
                                           sw_scores_plain)
    from seqalign_tpu_torch.ops.pack import m16_safe

    err = {}

    def note(kernel, *pairs):
        k = f"{kernel}[{mode}]"
        err[k] = max(err.get(k, 0), max_abs(*pairs))

    flags = flags_of(mode_scoring(mode))
    for sw in (False, True):
        sc = mode_scoring(mode, sw)
        (ac, bc, na, nb), bp, (na_h, nb_h) = packed(
            sc, kernel_params(sc, dev), dna(rng, MODE_B, MODE_L, MODE_L),
            dna(rng, MODE_B, MODE_L, MODE_L), dev)
        v = valid_mask(2 * MODE_L - 1, MODE_L + 1, na, nb)
        m16 = m16_safe(sc, MODE_L, MODE_L)
        if sw:
            t0 = cuda_ms(lambda: kernels.sw_scores(ac, bc, na, nb, bp), 10)
            want, t1 = timed_plain(lambda: sw_scores_plain(ac, bc, na, nb, bp))
            note("sw_scores", (kernels.sw_scores(ac, bc, na, nb, bp), want))
            times[f"sw_scores[{mode}]"] = (t0, t1)
            t0 = cuda_ms(lambda: kernels.sw_fill_dirs(ac, bc, na, nb, bp,
                                                      m16), 10)
            (dp_, mp), t1 = timed_plain(
                lambda: sw_fill_dirs_plain(ac, bc, na, nb, bp, m16))
            d, m = kernels.sw_fill_dirs(ac, bc, na, nb, bp, m16)
            note("sw_fill_dirs", (d[v], dp_[v]), (m[v], mp[v]))
            times[f"sw_fill_dirs[{mode}]"] = (t0, t1)
            mb = 2 if m16 else 4
        else:
            t0 = cuda_ms(lambda: kernels.nw_scores(ac, bc, na, nb, bp), 10)
            want, t1 = timed_plain(lambda: nw_scores_plain(ac, bc, na, nb, bp))
            note("nw_scores", *zip(kernels.nw_scores(ac, bc, na, nb, bp),
                                   want))
            times[f"nw_scores[{mode}]"] = (t0, t1)
            t0 = cuda_ms(lambda: kernels.nw_fill_dirs(ac, bc, na, nb, bp), 10)
            (dp_, cp), t1 = timed_plain(
                lambda: nw_fill_dirs_plain(ac, bc, na, nb, bp))
            d, c = kernels.nw_fill_dirs(ac, bc, na, nb, bp)
            note("nw_fill_dirs", (d[v], dp_[v]), (c, cp))
            times[f"nw_fill_dirs[{mode}]"] = (t0, t1)
            mb = 0
        fam = "sw" if sw else "nw"
        bounds[f"{fam}_scores[{mode}]"] = fill_bound(na_h, nb_h, sw, False,
                                                     flags=flags)
        bounds[f"{fam}_fill_dirs[{mode}]"] = fill_bound(na_h, nb_h, sw, True,
                                                        mb, flags=flags)
        del d, dp_, v
        for table, alpha in ((False, DNA), (True, AMINO)):
            sc = mode_scoring(mode, sw, table)
            A = seqs(rng, MODE_B, 0, MODE_L, alpha)
            B = seqs(rng, MODE_B, 0, MODE_L, alpha)
            A[0], B[1] = "", ""
            (ac, bc, na, nb), bp, _ = packed(sc, kernel_params(sc, dev), A, B,
                                             dev, MODE_L)
            v = valid_mask(2 * MODE_L - 1, MODE_L + 1, na, nb)
            m16 = m16_safe(sc, MODE_L, MODE_L)
            # one plain fill holds the three kernels of the family, its
            # M plane the SW M
            dp_, cp, bestp, gp, _ = _fill(ac, bc, na, nb, bp, is_sw=sw,
                                          emit_dirs=True, emit_gab=True)
            if sw:
                note("sw_scores", (kernels.sw_scores(ac, bc, na, nb, bp),
                                   bestp))
                d, m = kernels.sw_fill_dirs(ac, bc, na, nb, bp, m16)
                note("sw_fill_dirs", (d[v], dp_[v]), (m[v], gp[0][v]))
                del d, m
                d, g = kernels.sw_fill_gab(ac, bc, na, nb, bp)
                corner = []
            else:
                s, c = kernels.nw_scores(ac, bc, na, nb, bp)
                note("nw_scores", (s, cp.max(1).values), (c, cp))
                d, c = kernels.nw_fill_dirs(ac, bc, na, nb, bp)
                note("nw_fill_dirs", (d[v], dp_[v]), (c, cp))
                del d
                d, c, g = kernels.nw_fill_gab(ac, bc, na, nb, bp)
                corner = [(c, cp)]
            # the matrix dump's planes under the mode, in the family's row
            k = f"{'sw' if sw else 'nw'}_fill_gab"
            err[k] = max(err.get(k, 0), max_abs(
                (d[v], dp_[v]), *corner,
                *((g[i][v], gp[i][v]) for i in range(3))))
            del d, dp_, v, g, gp
    torch.cuda.synchronize()
    return err


def gab_pairs_vs_plain(scs, dev, times, bounds):
    """The matrix-dump fills on one DNA pair of each of ``GAB_PAIRS``, at
    its own widths as ``align_with_matrices`` packs it (NW under NW's
    default scoring, SW under SW's), against one plain run each: exact on
    codes, the NW corner and the M, Ga and Gb planes; the kernel timed as
    a mean of 10 launches, the plain version by that one run."""
    from seqalign_tpu_torch import kernel_params
    from seqalign_tpu_torch.ops import kernels
    from seqalign_tpu_torch.ops.dp import nw_fill_gab_plain, sw_fill_gab_plain
    from seqalign_tpu_torch.ops.pack import pack_batch

    rng = np.random.default_rng(SEED + 13)
    err = {}
    for shape, (la, lb) in GAB_PAIRS.items():
        A, B = dna(rng, 1, la, la), dna(rng, 1, lb, lb)
        for fam, sw, fill, plain in (
                ("nw", False, kernels.nw_fill_gab, nw_fill_gab_plain),
                ("sw", True, kernels.sw_fill_gab, sw_fill_gab_plain)):
            sc = scs[fam]
            ac, bc, na, nb, bp = pack_batch(sc, kernel_params(sc, dev), A, B,
                                            la, lb)
            na_h, nb_h = na, nb
            ac, bc, na, nb = (torch.from_numpy(v).to(dev)
                              for v in (ac, bc, na, nb))
            row = f"{fam}_fill_gab[{shape}]"
            t = cuda_ms(lambda: fill(ac, bc, na, nb, bp), 10)
            want, tp = timed_plain(lambda: plain(ac, bc, na, nb, bp))
            got = fill(ac, bc, na, nb, bp)
            v = valid_cells(got[0], na, nb)
            err[row] = max_abs((got[0][v], want[0][v]),
                               *([] if sw else [(got[1], want[1])]),
                               *((got[-1][i][v], want[-1][i][v])
                                 for i in range(3)))
            times[row] = (t, tp)
            bounds[row] = fill_bound(na_h, nb_h, sw, True, 12)
            del got, want, v
    torch.cuda.synchronize()
    log(f"phase 1: matrix-dump fills on one pair, "
        f"{', '.join(f'{k} {a} x {b}' for k, (a, b) in GAB_PAIRS.items())}, "
        f"vs plain: max |diff| {err}")
    return err


class Split:
    """Wall seconds of a block of checks by part: inside the kernels'
    wrappers and CUDA-event timing loops (``cuda_ms``) of kernels, inside
    the plain versions (``ops/dp.py``, ``ops/traceback.py``, and a timing
    loop of one), and the rest (inputs, packing, harvests, comparisons,
    host work).  While it is on, those functions are wrapped by module
    attribute (a caller that imports one by name has to do so after
    ``on``), the card synchronised around the outermost call only, so a
    timing loop's launches run back to back as without the split; a
    nested call counts in its outermost call's part.  ``start`` and
    ``end``, or ``block`` around a statement, log one line a block."""

    KERNELS = ("nw_scores", "nw_fill_dirs", "sw_scores", "sw_fill_dirs",
               "nw_fill_gab", "sw_fill_gab", "nw_fill_dirs_carry",
               "sw_fill_dirs_carry", "nw_scores_slice", "sw_scores_slice",
               "nw_fill_dirs_slice", "nw_walk", "sw_walk", "sw_hits",
               "vpu_chain")

    def __init__(self, parts=("kernel", "plain")):
        self.parts = parts
        self.secs = dict.fromkeys(parts, 0.0)
        self.depth = 0
        self.saw_plain = False
        self.saved = []

    def _wrap(self, mod, name, part):
        """``part``: "kernel", "plain", or None for a timing loop, whose
        part is that of what it times."""
        fn = getattr(mod, name)

        def wrapped(*args, **kw):
            if self.depth:
                self.saw_plain |= part == "plain"
                return fn(*args, **kw)
            self.depth += 1
            self.saw_plain = part == "plain"
            try:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = fn(*args, **kw)
                torch.cuda.synchronize()
                k = "plain" if self.saw_plain else "kernel"
                self.secs[k] = self.secs.get(k, 0.0) + (time.perf_counter()
                                                        - t0)
                return out
            finally:
                self.depth -= 1

        self.saved.append((mod, name, fn))
        setattr(mod, name, wrapped)

    def on(self):
        from seqalign_tpu_torch.ops import dp, kernels, traceback

        for mod in (kernels, dp, traceback):
            for name in list(vars(mod)):
                if name.endswith("_plain") or (mod is dp and name == "_fill"):
                    if "plain" in self.parts:
                        self._wrap(mod, name, "plain")
                elif (mod is kernels and name in self.KERNELS
                      and "kernel" in self.parts):
                    self._wrap(mod, name, "kernel")
        if "kernel" in self.parts:
            self._wrap(sys.modules[__name__], "cuda_ms", None)
        return self

    def off(self):
        for mod, name, fn in reversed(self.saved):
            setattr(mod, name, fn)
        self.saved = []

    def start(self, label):
        self.label = label
        self.secs = dict.fromkeys(self.parts, 0.0)
        torch.cuda.synchronize()
        self.t0 = time.perf_counter()

    def end(self):
        torch.cuda.synchronize()
        wall = time.perf_counter() - self.t0
        rest = wall - sum(self.secs.values())
        log(f"split {self.label}: wall {wall:.1f} s = " + ", ".join(
            f"{k} {v:.1f}" for k, v in self.secs.items())
            + f", rest {rest:.1f} s")

    @contextlib.contextmanager
    def block(self, label):
        self.start(label)
        yield
        self.end()


HOST_WORKERS = 4  # processes for the checks whose plain side is host work


def _host_start():
    """A check worker: the host's CPU alone (no CUDA device visible to it),
    one thread."""
    os.environ["CUDA_VISIBLE_DEVICES"] = ""
    torch.set_num_threads(1)


def _to_host(obj):
    """``obj`` with each tensor in it (also in tuples, lists and
    NamedTuples) as a numpy array, which pickles by value: a worker gets
    copies, not shared memory."""
    if isinstance(obj, torch.Tensor):
        return obj.cpu().numpy()
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):
        return type(obj)(*map(_to_host, obj))
    if isinstance(obj, (tuple, list)):
        return type(obj)(map(_to_host, obj))
    return obj


def _to_torch(obj):
    """The inverse of ``_to_host``: each numpy array a CPU tensor."""
    if isinstance(obj, np.ndarray):
        return torch.from_numpy(obj)
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):
        return type(obj)(*map(_to_torch, obj))
    if isinstance(obj, (tuple, list)):
        return type(obj)(map(_to_torch, obj))
    return obj


def _host_hits(args):
    """In a worker: ``sw_hits_plain`` on host copies of ``args``; its
    outputs as numpy arrays and its milliseconds."""
    from seqalign_tpu_torch.ops.traceback import sw_hits_plain

    t0 = time.perf_counter()
    out = sw_hits_plain(*_to_torch(args))
    return [o.numpy() for o in out], 1e3 * (time.perf_counter() - t0)


def _host_gotoh(*args, **kw):
    """In a worker: the numpy Gotoh optimum (``gotoh``)."""
    return gotoh(*args, **kw)


class HostChecks:
    """The checks whose plain side is host work, run in a pool of
    ``spawn`` worker processes on the host's CPU beside the card's work:
    the plain version of the SW hit loop (``sw_hits_plain``, a Python loop
    over host copies) and the numpy Gotoh optima of the witnesses.  A
    worker sees no CUDA device and gets numpy copies of its inputs.
    ``submit`` sends a task with the comparison to make on its result;
    ``settle`` waits for every task in turn and makes its comparison, which
    raises on a disagreement, as a worker that died does.  The run settles
    them all before its ``kernels`` line.  ``rows``: the kernel rows whose
    plain version ran here."""

    def __init__(self, workers=HOST_WORKERS):
        import concurrent.futures
        import multiprocessing

        self.pool = concurrent.futures.ProcessPoolExecutor(
            workers, mp_context=multiprocessing.get_context("spawn"),
            initializer=_host_start)
        self.pending = []
        self.rows = set()

    def submit(self, then, fn, *args, **kw):
        """Run ``fn(*args, **kw)`` in a worker; ``settle`` calls ``then``
        with its result."""
        self.pending.append((self.pool.submit(fn, *args, **kw), then))

    def hits(self, then, args):
        """``sw_hits_plain(*args)`` in a worker; ``then(out, ms)`` with its
        outputs as CPU tensors and its milliseconds."""
        self.submit(lambda r: then([torch.from_numpy(o) for o in r[0]],
                                   r[1]), _host_hits, _to_host(args))

    def settle(self):
        t0 = time.perf_counter()
        n = len(self.pending)
        while self.pending:
            fut, then = self.pending.pop(0)
            then(fut.result())
        log(f"host checks: {n} settled after a wait of "
            f"{time.perf_counter() - t0:.1f} s")

    def close(self):
        self.pool.shutdown(cancel_futures=True)


# the run's host checks, made by ``main``
HOST = None


def check_optimum(then, table, go, ge, a, b, local=False,
                  flags=frozenset()):
    """``then(opt)`` with the numpy Gotoh optimum of ``a``, ``b``, found in
    a worker of ``HOST``."""
    HOST.submit(then, _host_gotoh, table, go, ge, a, b, local, flags)


def timed_plain(fn):
    """One run of a plain version: its result and its milliseconds."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, 1e3 * (time.perf_counter() - t0)


def wide_modes_vs_plain(dev, rng, split):
    """Flag combinations at the wide widths (free start and end gaps at
    6,144 lanes, all five flags at 10,240: several rounds of the tiles):
    the four fills against one plain fill per family."""
    from seqalign_tpu_torch import kernel_params
    from seqalign_tpu_torch.ops import kernels
    from seqalign_tpu_torch.ops.dp import _fill

    worst = 0
    for width, lo, hi, n, mode in MODE_WIDE:
        t0 = time.perf_counter()
        e = 0
        split.start(f"phase 1 {mode} at width {width}")
        for sw in (False, True):
            sc = mode_scoring(mode, sw)
            (ac, bc, na, nb), bp, _ = packed(
                sc, kernel_params(sc, dev), dna(rng, n, lo, hi),
                dna(rng, n, lo, hi), dev, width)
            dp_, cp, bestp, mp, _ = _fill(ac, bc, na, nb, bp, is_sw=sw,
                                          emit_dirs=True,
                                          m_dtype=torch.int32 if sw
                                          else None)
            v = valid_cells(dp_, na, nb)
            if sw:
                d, m = kernels.sw_fill_dirs(ac, bc, na, nb, bp, False)
                e = max(e, max_abs(
                    (kernels.sw_scores(ac, bc, na, nb, bp), bestp),
                    (d[v], dp_[v]), (m[v], mp[v])))
            else:
                s, c = kernels.nw_scores(ac, bc, na, nb, bp)
                d, c2 = kernels.nw_fill_dirs(ac, bc, na, nb, bp)
                e = max(e, max_abs((s, cp.max(1).values), (c, cp), (c2, cp),
                                   (d[v], dp_[v])))
            del d, dp_, v
        split.end()
        log(f"phase 1: fills under {mode} at width {width} (B={n}, {lo}-{hi} "
            f"bp): max |diff| {e} ({time.perf_counter() - t0:.1f} s)")
        worst = max(worst, e)
    return worst


def walks_under_modes(dev, rng, times, bounds, late):
    """``sw_hits`` and ``sw_walk`` under free end gaps and under the LCS
    recipe (a sequence against itself) against their plain versions, on
    256 pairs of 512 bp, hint-less, k = 16; both timed.  The hit loop's
    plain version runs in a host worker, its max |diff| into ``late``."""
    import seqalign_tpu_torch as port
    from seqalign_tpu_torch import kernel_params
    from seqalign_tpu_torch.ops import kernels
    from seqalign_tpu_torch.ops.traceback import sw_walk_plain

    err = {}
    for tag, sc in (("neg", mode_scoring("neg", True)),
                    ("lcs", port.lcs_aligner().scoring)):
        A = dna(rng, MODE_B, MODE_L, MODE_L)
        B = A if tag == "lcs" else dna(rng, MODE_B, MODE_L, MODE_L)
        (ac, bc, na, nb), bp, (na_h, nb_h) = packed(
            sc, kernel_params(sc, dev), A, B, dev)
        d, m = kernels.sw_fill_dirs(ac, bc, na, nb, bp, True)
        args = hit_args(d, ac, bc, na, nb, m, na_h, nb_h, 1, bp, 16)
        del m
        out = kernels.sw_hits(*args)
        t0 = cuda_ms(lambda: kernels.sw_hits(*args), 10)
        hits_on_host(late, times, f"sw_hits[{tag}]", args, out, t0)
        bounds[f"sw_hits[{tag}]"] = hits_bound(args, out)
        hit_flat, hit_score, nhits = out
        keep = torch.arange(16, device=dev)[None, :] < nhits[:, None]
        jw, slot = keep.nonzero(as_tuple=True)
        w = na[jw] + 1
        fl = hit_flat[jw, slot]
        starts = [t.to(torch.int32).contiguous()
                  for t in (jw, fl % w, fl // w, hit_score[jw, slot])]
        o = kernels.sw_walk(d, ac, bc, na, nb, *starts, bp, 2 * MODE_L)
        t0 = cuda_ms(lambda: kernels.sw_walk(d, ac, bc, na, nb, *starts, bp,
                                             2 * MODE_L), 10)
        op, t1 = timed_plain(lambda: sw_walk_plain(d, ac, bc, na, nb,
                                                   *starts, bp, 2 * MODE_L))
        err[f"sw_walk[{tag}]"] = max_abs((o, op))
        times[f"sw_walk[{tag}]"] = (t0, t1)
        bounds[f"sw_walk[{tag}]"] = walk_bound(f"sw_walk[{tag}]", o, 3,
                                               16 * len(jw))
        log(f"phase 1: sw_hits / sw_walk under {tag}: {int(nhits.sum())} "
            f"hits of {len(args[5])} candidates traced")
    return err


def slab_valid(D, LB, c, ca, na, nb):
    """Cells of chunk slab ``c`` (columns c*ca+1 .. c*ca+ca) that lie in the
    pairs: 1 <= y <= nb, 1 <= x <= na."""
    y = torch.arange(LB + 1, device=na.device)[None, None, :]
    xl = torch.arange(D, device=na.device)[None, :, None] + 2 - y
    x = xl + c * ca
    return ((y >= 1) & (y <= nb[:, None, None]) & (xl >= 1) & (xl <= ca)
            & (x <= na[:, None, None]))


def carry_chunks(fill, args, ca, sw, m16):
    """Every chunk of a packed batch through one carry fill (the kernel's
    wrapper or its plain version): the slabs (B, nch, ca+LB-1, LB+1), each
    chunk's bout and M, the corners (NW) or best scores (SW), and each
    chunk's milliseconds (``timed_plain``)."""
    from seqalign_tpu_torch.ops.dp import boundary_column

    ac, bc = args[0], args[1]
    B, LA = ac.shape
    LB = bc.shape[1]
    nch = -(-LA // ca)
    bin = boundary_column(args[4], B, LB, is_sw=sw)
    bout = torch.zeros_like(bin)
    slabs = torch.zeros((B, nch, ca + LB - 1, LB + 1), dtype=torch.uint8,
                        device=ac.device)
    acc = torch.zeros(B if sw else (B, 3), dtype=torch.int32,
                      device=ac.device)
    bouts, ms, secs = [], [], []
    for c in range(nch):
        m, t = timed_plain(lambda: fill(*args, c * ca, bin, bout,
                                        slabs[:, c], acc,
                                        *((m16,) if sw else ())))
        bouts.append(bout.clone())
        ms.append(m)
        secs.append(t)
        bin, bout = bout, bin
    return slabs, bouts, ms, acc, secs


def carry_vs_plain(dev, rng, times, bounds, split):
    """The carry kernels against their plain versions chunk by chunk, NW
    and SW, on 4 pairs of 5,000-6,144 x 1,500-2,048 in chunks of CARRY_CA
    (equality, BLOSUM62 with an empty seq_a and an empty seq_b, nsg+neg)
    and at 10,240 lanes (4 pairs, and, NW only, 16 of path long's 6-10 kb
    of b at the default flags and under nsg+neg): the codes of every slab
    on the valid cells, each chunk's bout on the lanes 1 .. nb of the
    pairs that reach it, the corners or best scores, SW M; each case
    crosses rounds of the tiles (csrc/tile_carry.cuh: at the default flags
    4 rounds of 4 warps at 2,048 lanes, 20 of 4 and 10 of 8 at 10,240; under
    the flags, 2 lanes a thread, 8 rounds of 4 warps at 2,048 lanes and 10
    of 16 for the 16 pairs, long job 2's shape).  The middle chunk of the
    first equality pairs, of the 16 pairs (rows ``nw_fill_dirs[carry,B16]``,
    ``nw_fill_dirs[carry,nsg+neg,B16]``) and of the NW nsg+neg pairs (row
    ``nw_fill_dirs[carry,nsg+neg]``, the flags' instantiation) is timed:
    the kernel with CUDA events, the plain version in the check's run.
    Then the
    walks over the first equality pairs' slabs against their plain
    versions (rows ``*[chunked]``).  Returns the errors and, for the long
    path's sample check, the equality pairs with their plain NW
    alignments and SW hits."""
    import seqalign_tpu_torch as port
    from seqalign_tpu_torch import kernel_params
    from seqalign_tpu_torch.ops import kernels
    from seqalign_tpu_torch.ops.dp import (merge_candidates,
                                           nw_fill_dirs_carry_plain,
                                           sw_fill_dirs_carry_plain,
                                           sw_sorted_candidates)
    from seqalign_tpu_torch.ops.pack import m16_safe, pack_batch
    from seqalign_tpu_torch.ops.traceback import (ChunkedDirs, SwHitIterator,
                                                  nw_strings_from_ops,
                                                  nw_walk_plain,
                                                  sw_hits_plain,
                                                  sw_walk_plain)

    err = {}
    ref = {}
    ca = CARRY_CA
    for label, ra, rb, lanes, n in CARRY_CASES:
        t0 = time.perf_counter()
        worst = 0
        split.start(f"phase 1 carry {label}, {n} pairs at "
                    f"{lanes or 'their'} lanes")
        alpha = AMINO if label == "BLOSUM62" else DNA
        A, B = seqs(rng, n, *ra, alpha), seqs(rng, n, *rb, alpha)
        A[0] = A[0][:2 * ca]  # ends on the last column of chunk 1
        if label == "BLOSUM62":  # the corners of empty sides
            A[2], B[3] = "", ""
        # (SW, flags): the 16 pairs NW only, at the default flags and under
        # nsg+neg on the same pairs
        runs = (((False, label), (False, "nsg+neg")) if n == 16
                else ((False, label), (True, label)))
        for sw, flags in runs:
            if label == "BLOSUM62":
                sc = port.presets.scoring_system_BLOSUM62()
            elif flags == "nsg+neg":
                sc = mode_scoring(flags, sw)
            else:
                sc = (port.presets.scoring_system_sw_default() if sw
                      else port.presets.scoring_system_default())
            la, lb = max(map(len, A)), lanes or max(map(len, B))
            ac, bc, na, nb, bp = pack_batch(sc, kernel_params(sc, dev), A, B,
                                            la, lb)
            args = (*(torch.from_numpy(v).to(dev) for v in (ac, bc, na, nb)),
                    bp)
            m16 = sw and m16_safe(sc, la, lb)
            name = (f"{'sw' if sw else 'nw'}_fill_dirs[carry"
                    f"{',nsg+neg' if flags == 'nsg+neg' and not sw else ''}"
                    f"{',B16' if n == 16 else ''}]")
            kfill = (kernels.sw_fill_dirs_carry if sw
                     else kernels.nw_fill_dirs_carry)
            pfill = sw_fill_dirs_carry_plain if sw else \
                nw_fill_dirs_carry_plain
            got = carry_chunks(kfill, args, ca, sw, m16)
            want = carry_chunks(pfill, args, ca, sw, m16)
            na_t, nb_t = args[2], args[3]
            e = max_abs((got[3], want[3]))
            lane = torch.arange(lb + 1, device=dev)[None, None, :]
            for c in range(got[0].shape[1]):
                v = slab_valid(ca + lb - 1, lb, c, ca, na_t, nb_t)
                keep = ((na_t >= (c + 1) * ca)[:, None, None] & (lane >= 1)
                        & (lane <= nb_t[:, None, None])).expand(-1, 3, -1)
                e = max(e, max_abs((got[0][:, c][v], want[0][:, c][v]),
                                   (got[1][c][keep], want[1][c][keep])))
                if sw:
                    e = max(e, max_abs((got[2][c][v], want[2][c][v])))
            err[name] = max(err.get(name, 0), e)
            worst = max(worst, e)
            if (flags == "equality" and (not lanes or n == 16)
                    or flags == "nsg+neg" and not sw):
                # the middle chunk: the kernel launched again, the plain
                # version's run above
                bin = want[1][0]
                bout, slab = torch.empty_like(bin), torch.empty_like(
                    got[0][:, 1])
                acc = torch.zeros_like(got[3])
                extra = (m16,) if sw else ()
                t_k = cuda_ms(lambda: kfill(*args, ca, bin, bout, slab, acc,
                                            *extra), 5)
                times[name] = (t_k, want[4][1])
                wa = np.clip(na - ca, 0, ca)
                bounds[name] = fill_bound(
                    wa, nb, sw, True, (2 if m16 else 4) * sw,
                    flags=flags_of(sc),
                    extra_bytes=2 * 12 * (lb + 1) * len(na))
                if flags == "equality" and not lanes:
                    ref[sw] = (sc, A, B, args, got)
            del got, want
        split.end()
        log(f"phase 1: carry fills vs plain, "
            f"{' and '.join(dict.fromkeys(f for _, f in runs))}, {n} pairs of "
            f"{ra[0]}-{ra[1]} x {rb[0]}-{rb[1]} at {lanes or 'their'} lanes "
            f"in chunks of {ca}: max |diff| {worst} "
            f"({time.perf_counter() - t0:.1f} s)")

    # the walks over the equality pairs' slabs
    split.start("phase 1 walks over chunk slabs")
    sc, A, B, args, (slabs, _, _, corner, _) = ref[False]
    ac, bc, na, nb, _ = args
    cap = int((na + nb).max())
    o = kernels.nw_walk(slabs, corner, na, nb, cap)
    op, t_p = timed_plain(lambda: nw_walk_plain(slabs, corner, na, nb, cap))
    err["nw_walk[chunked]"] = max_abs(*zip(o, op))
    times["nw_walk[chunked]"] = (
        cuda_ms(lambda: kernels.nw_walk(slabs, corner, na, nb, cap), 5), t_p)
    bounds["nw_walk[chunked]"] = walk_bound("nw_walk[chunked]", o[0], 1,
                                            20 * len(na))
    na_h, nb_h = na.cpu().numpy(), nb.cpu().numpy()
    nw_plain = nw_strings_from_ops(A, B, na_h, nb_h, op[0].cpu().numpy(),
                                   op[1].cpu().numpy())
    sc, A, B, args, (slabs, _, ms, best, _) = ref[True]
    ac, bc, na, nb, bp = args
    thr = near_best(best)
    flat, score, off = merge_candidates(
        [sw_sorted_candidates(m, na_h, nb_h, thr, x_off=c * CARRY_CA)
         for c, m in enumerate(ms)], len(A))
    hargs = (slabs, ac, bc, na, nb, flat, score, off[:-1], off[1:], bp, 16)
    out = kernels.sw_hits(*hargs)
    err["sw_hits[chunked]"] = max_abs(*zip(out, sw_hits_plain(*hargs)))
    times["sw_hits[chunked]"] = (
        cuda_ms(lambda: kernels.sw_hits(*hargs), 5),
        timed_plain(lambda: sw_hits_plain(*hargs))[1])
    bounds["sw_hits[chunked]"] = hits_bound(hargs, out)
    hit_flat, hit_score, nhits = out
    keep = torch.arange(16, device=dev)[None, :] < nhits[:, None]
    jw, slot = keep.nonzero(as_tuple=True)
    w = na[jw].long() + 1
    fl = hit_flat[jw, slot]
    starts = [t.to(torch.int32).contiguous()
              for t in (jw, fl % w, fl // w, hit_score[jw, slot])]
    o = kernels.sw_walk(slabs, ac, bc, na, nb, *starts, bp, cap)
    op, t_p = timed_plain(lambda: sw_walk_plain(slabs, ac, bc, na, nb,
                                                *starts, bp, cap))
    err["sw_walk[chunked]"] = max_abs((o, op))
    times["sw_walk[chunked]"] = (
        cuda_ms(lambda: kernels.sw_walk(slabs, ac, bc, na, nb, *starts, bp,
                                        cap), 5), t_p)
    bounds["sw_walk[chunked]"] = walk_bound("sw_walk[chunked]", o, 3,
                                            16 * len(jw))
    cands = [(flat[s:e].cpu().numpy(), score[s:e].cpu().numpy())
             for s, e in zip(off[:-1].tolist(), off[1:].tolist())]
    sw_plain = [list(itertools.islice(SwHitIterator(
        sc, A[j], B[j], int(na_h[j]), int(nb_h[j]),
        ChunkedDirs(slabs[j].cpu().numpy(), CARRY_CA), cands[j]), 8))
        for j in range(len(A))]
    log(f"phase 1: walks over chunk slabs vs plain: {int(nhits.sum())} hits "
        f"of {len(flat)} candidates; max |diff| "
        + ", ".join(f"{k} {err[k]}" for k in ("nw_walk[chunked]",
                                               "sw_hits[chunked]",
                                               "sw_walk[chunked]")))
    split.end()
    return err, (A, B, nw_plain, thr.tolist(), sw_plain)


def kernels_vs_plain(sc, params, seqs_a, seqs_b, dev, late, width=None,
                     nw=True, sw=True):
    """Max |kernel - plain| of each kernel and mode on one batch; one
    plain fill with codes (and SW M) holds the fills of a family, its
    corner or best being the scores fill's, and on the ragged batches
    (``width`` None) its M, Ga and Gb planes the matrix-dump fill's.  The
    same plain fill holds the batch's fills as one launch across widths
    (rows ``[ragged]``, or ``[table]`` with a table): scores and corners,
    codes and M on the valid cells of each pair's plane, the ragged M's
    other cells 0.  At width 10,240 every pair is past 6,400 lanes of b
    and takes round rows of the tiles' scratch, at 6,144 every pair.  On
    the ragged batches the hit loop's plain version (hint-less) runs in a
    host worker, its max |diff| into ``late``."""
    from seqalign_tpu_torch.ops import kernels
    from seqalign_tpu_torch.ops.dp import _fill, sw_extract_candidates
    from seqalign_tpu_torch.ops.pack import m16_safe
    from seqalign_tpu_torch.ops.traceback import (nw_walk_plain,
                                                  sw_hits_plain,
                                                  sw_walk_plain)

    (ac, bc, na, nb), bp, (na_h, nb_h) = packed(sc, params, seqs_a, seqs_b,
                                                 dev, width)
    mode = "" if bp.sub is None else "[table]"
    rag = "[ragged]" if bp.sub is None else "[table]"
    sched = kernels.fill_schedule(na_h, nb_h, dev, planes=True)
    cap = int((na + nb).max())
    err = {}
    gab = width is None  # the dump's fills on the ragged batches
    if nw:
        dpl, dcp, _, gpl, _ = _fill(ac, bc, na, nb, bp, emit_dirs=True,
                                    emit_gab=gab)
        s, c = kernels.nw_scores(ac, bc, na, nb, bp)
        err["nw_scores" + mode] = max_abs((s, dcp.max(1).values), (c, dcp))
        d, dc = kernels.nw_fill_dirs(ac, bc, na, nb, bp)
        v = valid_cells(d, na, nb)
        err["nw_fill_dirs" + mode] = max_abs((d[v], dpl[v]), (dc, dcp))
        s, c = kernels.nw_scores(ac, bc, na, nb, bp, sched)
        f, fc = kernels.nw_fill_dirs(ac, bc, na, nb, bp, sched)
        merge(err, {"nw_scores" + rag: max_abs((s, dcp.max(1).values),
                                               (c, dcp)),
                    "nw_fill_dirs" + rag: max_abs(
                        *on_planes(f, sched.off, na, nb, dpl), (fc, dcp))})
        del f
        if gab:
            dg, cg, g = kernels.nw_fill_gab(ac, bc, na, nb, bp)
            err["nw_fill_gab"] = max_abs((dg[v], dpl[v]), (cg, dcp),
                                         *((g[i][v], gpl[i][v])
                                           for i in range(3)))
            del dg, g, gpl
        del v, dpl
        o, os_ = kernels.nw_walk(d, dc, na, nb, cap)
        op, osp = nw_walk_plain(d, dc, na, nb, cap)
        err["nw_walk"] = max_abs((o, op), (os_, osp))
        del d
    if sw:
        m16 = m16_safe(sc, ac.shape[1], bc.shape[1])
        dpl, _, bestp, mpl, _ = _fill(
            ac, bc, na, nb, bp, is_sw=True, emit_dirs=True, emit_gab=gab,
            m_dtype=torch.int16 if m16 else torch.int32)
        s = kernels.sw_scores(ac, bc, na, nb, bp)
        err["sw_scores" + mode] = max_abs((s, bestp))
        d, m = kernels.sw_fill_dirs(ac, bc, na, nb, bp, m16)
        v = valid_cells(d, na, nb)
        mp = mpl[0] if gab else mpl
        err["sw_fill_dirs" + mode] = max_abs((d[v], dpl[v]), (m[v], mp[v]))
        f, fm = kernels.sw_fill_dirs(ac, bc, na, nb, bp, m16, sched)
        pv = plane_valid(sched.off, na, nb)
        merge(err, {"sw_scores" + rag: max_abs(
                        (kernels.sw_scores(ac, bc, na, nb, bp, sched),
                         bestp)),
                    "sw_fill_dirs" + rag: max_abs(
                        *on_planes(f, sched.off, na, nb, dpl),
                        *on_planes(fm, sched.off, na, nb, mp),
                        (fm[~pv], torch.zeros_like(fm[~pv])))})
        del f, fm, pv, mp
        if gab:
            dg, g = kernels.sw_fill_gab(ac, bc, na, nb, bp)
            err["sw_fill_gab"] = max_abs((dg[v], dpl[v]),
                                         *((g[i][v], mpl[i][v])
                                           for i in range(3)))
            del dg, g
        del v, dpl, mpl
        # the hit loop hint-less on the ragged batches (the mask in shared
        # memory), near the best cells at the wide widths (global memory)
        args = hit_args(d, ac, bc, na, nb, m, na_h, nb_h,
                        1 if width is None else near_best(s), bp, 16)
        if width is None:
            hits_on_host(late, {}, "sw_hits" + mode, args,
                         kernels.sw_hits(*args))
        else:
            err["sw_hits" + mode] = max_abs(*zip(kernels.sw_hits(*args),
                                                 sw_hits_plain(*args)))
        del args
        starts = walk_starts(sw_extract_candidates(m, na_h, nb_h,
                                                   near_best(s)), na_h, 16,
                             dev)
        del m
        o = kernels.sw_walk(d, ac, bc, na, nb, *starts, bp, cap)
        err["sw_walk" + mode] = max_abs((o, sw_walk_plain(
            d, ac, bc, na, nb, *starts, bp, cap)))
    torch.cuda.synchronize()
    return err


def phase1(scs, rng, dev, split):
    """Each kernel and mode against its plain version at the main path's
    widths; then both timed.  ``split`` logs each block's wall by part."""
    from seqalign_tpu_torch import kernel_params
    from seqalign_tpu_torch.ops import kernels
    from seqalign_tpu_torch.ops.dp import (nw_fill_dirs_plain,
                                           nw_fill_gab_plain,
                                           nw_scores_plain,
                                           sw_extract_candidates,
                                           sw_fill_dirs_plain,
                                           sw_fill_gab_plain,
                                           sw_scores_plain)
    from seqalign_tpu_torch.ops.traceback import (nw_walk_plain,
                                                  sw_walk_plain)

    nw_sc, sw_sc, prot_sc = scs["nw"], scs["sw"], scs["table"]
    params = {k: kernel_params(v, dev) for k, v in scs.items()}
    err = dict.fromkeys(KERNELS, 0)
    batches = [("NW DNA B=64 ragged 1-512", "nw", 64, 1, 512, None, DNA,
                True, False),
               ("SW DNA B=64 ragged 1-512", "sw", 64, 1, 512, None, DNA,
                False, True),
               ("BLOSUM62 protein B=64 ragged 1-1000", "table", 64, 1, 1000,
                None, AMINO, True, True)]
    for w, lo, hi, n in WIDE:
        batches += [(f"NW DNA B={n} {lo}-{hi} bp at width {w}", "nw", n, lo,
                     hi, w, DNA, True, False),
                    (f"SW DNA B={n} {lo}-{hi} bp at width {w}", "sw", n, lo,
                     hi, w, DNA, False, True)]
    for label, k, n, lo, hi, width, alpha, nw, sw in batches:
        t0 = time.perf_counter()
        with split.block(f"phase 1 {label}"):
            e = kernels_vs_plain(scs[k], params[k],
                                 seqs(rng, n, lo, hi, alpha),
                                 seqs(rng, n, lo, hi, alpha), dev, err,
                                 width, nw, sw)
        log(f"phase 1: kernel vs plain on {label}: max |diff| {e} "
            f"({time.perf_counter() - t0:.1f} s)")
        err.update({r: max(err[r], v) for r, v in e.items()})
    if any(err.values()):
        raise AssertionError(f"kernel disagrees with its plain version: "
                             f"{err}")

    times, bounds = {}, {}
    split.start("phase 1 timing at B=256 L=512")
    for key, alpha in (("nw", DNA), ("sw", DNA), ("table", AMINO)):
        sc, p = scs[key], params[key]
        (ac, bc, na, nb), bp, (na_h, nb_h) = packed(
            sc, p, seqs(rng, 256, 512, 512, alpha),
            seqs(rng, 256, 512, 512, alpha), dev)
        mode = "" if bp.sub is None else "[table]"
        entries = 0 if bp.sub is None else bp.sub.numel()
        for fam, is_sw in (("nw", False), ("sw", True)):
            if key in (fam, "table"):
                bounds[f"{fam}_scores{mode}"] = fill_bound(
                    na_h, nb_h, is_sw, False, table=entries)
                bounds[f"{fam}_fill_dirs{mode}"] = fill_bound(
                    na_h, nb_h, is_sw, True, 2 * is_sw, table=entries)
        if key in ("nw", "table"):
            d, dc = kernels.nw_fill_dirs(ac, bc, na, nb, bp)
            times["nw_scores" + mode] = (
                cuda_ms(lambda: kernels.nw_scores(ac, bc, na, nb, bp), 10),
                cuda_ms(lambda: nw_scores_plain(ac, bc, na, nb, bp), 1,
                        warm=False))
            times["nw_fill_dirs" + mode] = (
                cuda_ms(lambda: kernels.nw_fill_dirs(ac, bc, na, nb, bp), 10),
                cuda_ms(lambda: nw_fill_dirs_plain(ac, bc, na, nb, bp), 1,
                        warm=False))
            if key == "nw":
                times["nw_fill_gab"] = (
                    cuda_ms(lambda: kernels.nw_fill_gab(ac, bc, na, nb, bp),
                            10),
                    cuda_ms(lambda: nw_fill_gab_plain(ac, bc, na, nb, bp), 1,
                            warm=False))
                bounds["nw_fill_gab"] = fill_bound(na_h, nb_h, False, True,
                                                   12)
                times["nw_walk"] = (
                    cuda_ms(lambda: kernels.nw_walk(d, dc, na, nb, 1024), 10),
                    cuda_ms(lambda: nw_walk_plain(d, dc, na, nb, 1024), 1,
                            warm=False))
                bounds["nw_walk"] = walk_bound(
                    "nw_walk", kernels.nw_walk(d, dc, na, nb, 1024)[0], 1,
                    20 * len(na))
            del d
        if key in ("sw", "table"):
            m16 = True  # 11 * 512 and 2 * 512 are below the int16 gate
            d, m = kernels.sw_fill_dirs(ac, bc, na, nb, bp, m16)
            # the hit loop on every candidate, as job 1 runs it
            args = hit_args(d, ac, bc, na, nb, m, na_h, nb_h, 1, bp, 16)
            starts = walk_starts(sw_extract_candidates(
                m, na_h, nb_h, near_best(kernels.sw_scores(ac, bc, na, nb,
                                                           bp))), na_h, 16,
                dev)
            del m
            times["sw_scores" + mode] = (
                cuda_ms(lambda: kernels.sw_scores(ac, bc, na, nb, bp), 10),
                cuda_ms(lambda: sw_scores_plain(ac, bc, na, nb, bp), 1,
                        warm=False))
            times["sw_fill_dirs" + mode] = (
                cuda_ms(lambda: kernels.sw_fill_dirs(ac, bc, na, nb, bp,
                                                     m16), 10),
                cuda_ms(lambda: sw_fill_dirs_plain(ac, bc, na, nb, bp, m16),
                        1, warm=False))
            if key == "sw":
                times["sw_fill_gab"] = (
                    cuda_ms(lambda: kernels.sw_fill_gab(ac, bc, na, nb, bp),
                            10),
                    cuda_ms(lambda: sw_fill_gab_plain(ac, bc, na, nb, bp), 1,
                            warm=False))
                bounds["sw_fill_gab"] = fill_bound(na_h, nb_h, True, True,
                                                   12)
            times["sw_walk" + mode] = (
                cuda_ms(lambda: kernels.sw_walk(d, ac, bc, na, nb, *starts,
                                                bp, 1024), 10),
                cuda_ms(lambda: sw_walk_plain(d, ac, bc, na, nb, *starts, bp,
                                              1024), 1, warm=False))
            bounds["sw_walk" + mode] = walk_bound(
                "sw_walk" + mode,
                kernels.sw_walk(d, ac, bc, na, nb, *starts, bp, 1024), 3,
                16 * len(starts[0]))
            out = kernels.sw_hits(*args)
            bounds["sw_hits" + mode] = hits_bound(args, out)
            # the plain version timed, and held to the kernel, in a host
            # worker
            hits_on_host(err, times, "sw_hits" + mode, args, out,
                         cuda_ms(lambda: kernels.sw_hits(*args), 10))
            del d, args
    split.end()

    for mode in MODES:
        t0 = time.perf_counter()
        with split.block(f"phase 1 modes {mode}"):
            e = modes_vs_plain(mode, dev, rng, times, bounds)
        log(f"phase 1: fills under {mode} vs plain, 256 x 512 and ragged, "
            f"equality and BLOSUM62: max |diff| {e} "
            f"({time.perf_counter() - t0:.1f} s)")
        merge(err, e)
    with split.block("phase 1 walks under modes"):
        merge(err, walks_under_modes(dev, rng, times, bounds, err))
    with split.block("phase 1 tile edges"):
        merge(err, tiles_vs_plain(scs, dev))
    wide = wide_modes_vs_plain(dev, rng, split)
    e, sample = carry_vs_plain(dev, rng, times, bounds, split)
    merge(err, e)
    with split.block("phase 1 slices"):
        merge(err, slices_vs_plain(dev, times, bounds))
    with split.block("phase 1 ragged rows"):
        merge(err, ragged_vs_buckets(nw_sc, params["nw"], rng, dev, times,
                                     bounds))
    with split.block("phase 1 SW ragged rows"):
        merge(err, sw_ragged_vs_buckets(sw_sc, params["sw"], dev, times,
                                        bounds))
    with split.block("phase 1 dump pairs"):
        merge(err, gab_pairs_vs_plain(scs, dev, times, bounds))
    if wide or any(err.values()):
        raise AssertionError(f"a mode disagrees with its plain version: wide "
                             f"{wide}, {err}")
    for k, (t, tp) in times.items():
        b, by = bounds[k]
        shape = ("4 pairs, one chunk of 2048" if k.endswith(
                    ("[carry]", "[carry,nsg+neg]")) else
                 "16 pairs, one chunk of 2048 at 10240 lanes"
                 if k.endswith(",B16]") else
                 "4 pairs' slabs" if "[chunked]" in k else
                 f"{RAGGED_PAIRS} pairs of 1-10 kb (plain: the same)"
                 if k == "nw_walk[ragged]" else
                 "the hits of SW job 3's first sub-batch (plain: the same)"
                 if k == "sw_walk[ragged]" else
                 f"SW job 3's first sub-batch (plain: 8 pairs of 0-300 bp)"
                 if k.startswith("sw") and "[ragged]" in k else
                 f"{RAGGED_PAIRS} pairs of 1-10 kb (plain: 8 pairs of "
                 f"0-300 bp)" if "[ragged]" in k else
                 "one pair of {} x {}".format(*GAB_PAIRS[k[-5:-1]])
                 if k.endswith(("[dump]", "[wide]")) else
                 f"4 pairs in chunks of {CARRY_CA}, {SLICE_SLICES} slices, "
                 f"every chunk" + (" (plain: the codes slices')" if k ==
                                   "nw_scores_slice" else "")
                 if k in SLICE_ROWS else "B=256 L=512")
        pace = (f"; longest walk {WALK_STEPS[k]} steps, "
                f"{1e6 * t / max(WALK_STEPS[k], 1):.1f} ns a step"
                if k in WALK_STEPS else "")
        log(f"phase 1: {k} at {shape}: kernel {t:.4f} ms, plain "
            f"{tp:.4f} ms, bound {b:.6f} ms ({by}){pace}")
    return err, times, bounds, sample


def tile_edges(rng, alpha, R):
    """Pairs at the strip edges of R lanes a thread (csrc/tile_fill.cuh):
    b of 31, 32R-1, 32R, 32R+1 and 2*32R+3 lanes (the last with an a side
    long enough for unchecked step blocks), empty sides, and one pair of
    2,100 lanes, whose strips take two rounds."""
    S = 32 * R
    lens = [(37, 31), (300, S - 1), (41, S), (S + 3 * R, S + 1),
            (S + 2 * R + 7, 2 * S + 3), (0, 9), (12, 0), (1, 1), (150, 2100)]
    A = [seqs(rng, 1, n, n, alpha)[0] if n else "" for n, _ in lens]
    B = [seqs(rng, 1, m, m, alpha)[0] if m else "" for _, m in lens]
    return A, B


def tiles_vs_plain(scs, dev):
    """The fills on the register tiles against their plain versions on
    :func:`tile_edges`' pairs: NW and SW, equality and BLOSUM62, and under
    the flags (NW and SW under nsg+neg, the LCS recipe: the MODES
    instantiations), uniform and under a schedule with planes, SW M int16
    and int32; codes and M on the valid cells (the ragged M's other cells
    0), scores, corners.  One plain fill with codes (and int32 M) holds
    both layouts and both M types (the plain int16 M is its int32 M cast).
    Returns the max |diff| by row: the uniform launches under their
    kernel's row (or ``[table]``, ``[<mode>]``), the equality launches
    across widths under ``[ragged]``, the others under the uniform's."""
    import seqalign_tpu_torch as port
    from seqalign_tpu_torch import kernel_params
    from seqalign_tpu_torch.ops import kernels
    from seqalign_tpu_torch.ops.dp import (nw_fill_dirs_plain,
                                           nw_scores_plain,
                                           sw_fill_dirs_plain,
                                           sw_scores_plain)
    from seqalign_tpu_torch.ops.pack import pack_batch

    t0 = time.perf_counter()
    rng = np.random.default_rng(SEED + 9)
    err = {}
    # (NW config, SW config, alphabet, row suffix, row suffix across widths)
    cases = ((scs["nw"], None, DNA, "", "[ragged]"),
             (None, scs["sw"], DNA, "", "[ragged]"),
             (scs["table"], scs["table"], AMINO, "[table]", "[table]"),
             (mode_scoring("nsg+neg"), mode_scoring("nsg+neg", True), DNA,
              "[nsg+neg]", "[nsg+neg]"),
             (None, port.lcs_aligner().scoring, DNA, "[nga+ngb+nmm]",
              "[nga+ngb+nmm]"))
    for nw_sc, sw_sc, alpha, mode, rag in cases:
        A, B = tile_edges(rng, alpha, kernels.TILE_R)
        for sc, sw in ((nw_sc, False), (sw_sc, True)):
            if sc is None:
                continue
            ac, bc, na, nb, bp = pack_batch(
                sc, kernel_params(sc, dev), A, B, max(map(len, A)),
                max(map(len, B)))
            t = [torch.from_numpy(v).to(dev) for v in (ac, bc, na, nb)]
            sched = kernels.fill_schedule(na, nb, dev, planes=True)
            pv = plane_valid(sched.off, t[2], t[3])
            if not sw:
                sp, cp = nw_scores_plain(*t, bp)
                dp_, dcp = nw_fill_dirs_plain(*t, bp)
                v = valid_cells(dp_, t[2], t[3])
                d, dc = kernels.nw_fill_dirs(*t, bp)
                f, fc = kernels.nw_fill_dirs(*t, bp, sched)
                merge(err, {
                    "nw_scores" + mode: max_abs(
                        *zip(kernels.nw_scores(*t, bp), (sp, cp))),
                    "nw_scores" + rag: max_abs(
                        *zip(kernels.nw_scores(*t, bp, sched), (sp, cp))),
                    "nw_fill_dirs" + mode: max_abs((d[v], dp_[v]),
                                                   (dc, dcp)),
                    "nw_fill_dirs" + rag: max_abs(
                        *on_planes(f, sched.off, t[2], t[3], dp_),
                        (fc, dcp))})
                del dp_, d, f, v
                continue
            bestp = sw_scores_plain(*t, bp)
            merge(err, {
                "sw_scores" + mode: max_abs(
                    (kernels.sw_scores(*t, bp), bestp)),
                "sw_scores" + rag: max_abs(
                    (kernels.sw_scores(*t, bp, sched), bestp))})
            dp_, mp32 = sw_fill_dirs_plain(*t, bp, False)
            v = valid_cells(dp_, t[2], t[3])
            for m16 in (True, False):
                mp = mp32.to(torch.int16) if m16 else mp32
                d, m = kernels.sw_fill_dirs(*t, bp, m16)
                f, fm = kernels.sw_fill_dirs(*t, bp, m16, sched)
                merge(err, {
                    "sw_fill_dirs" + mode: max_abs((d[v], dp_[v]),
                                                   (m[v], mp[v])),
                    "sw_fill_dirs" + rag: max_abs(
                        *on_planes(f, sched.off, t[2], t[3], dp_),
                        *on_planes(fm, sched.off, t[2], t[3], mp),
                        (fm[~pv], torch.zeros_like(fm[~pv])))})
                del mp, d, m, f, fm
            del dp_, mp32, v
    torch.cuda.synchronize()
    log(f"phase 1: tile fills at R = {kernels.TILE_R} on the strip edges, NW "
        f"and SW, equality, BLOSUM62, nsg+neg and the LCS recipe, uniform "
        f"and across widths, M int16 and int32, vs plain: max |diff| {err} "
        f"({time.perf_counter() - t0:.1f} s)")
    return err


def ragged_vs_buckets(sc, params, rng, dev, times, bounds):
    """Rows ``nw_fill_dirs[ragged]`` and ``nw_scores[ragged]``: one launch
    across widths (``kernels.fill_schedule``) on CLI job 1's mix,
    ``RAGGED_PAIRS`` DNA pairs of 1-10 kb, held to the uniform launches of
    its width buckets on every pair, kernel against kernel (codes on the
    valid cells of each pair's plane, corners, scores), and to the plain
    versions on 8 ragged pairs of up to 300 bp with an empty side (codes,
    corners, scores, and ``nw_walk`` over the planes; the plain versions
    hold such launches of 1-10 kb pairs in :func:`kernels_vs_plain`);
    timed with CUDA events beside the sum of the bucket launches.  Row
    ``nw_walk[ragged]``: ``nw_walk`` over the launch's planes of the 1-10
    kb pairs against its plain version on every pair, both timed.  Returns
    the max |diff| of each row."""
    from seqalign_tpu_torch.ops import kernels
    from seqalign_tpu_torch.ops.dp import nw_fill_dirs_plain, nw_scores_plain
    from seqalign_tpu_torch.ops.pack import pack_batch, pad_width
    from seqalign_tpu_torch.ops.traceback import nw_walk_plain

    t0 = time.perf_counter()
    A, B = dna(rng, RAGGED_PAIRS, *CLI_KB), dna(rng, RAGGED_PAIRS, *CLI_KB)
    ac, bc, na_h, nb_h, bp = pack_batch(sc, params, A, B, max(map(len, A)),
                                        max(map(len, B)))
    t = [torch.from_numpy(v).to(dev) for v in (ac, bc, na_h, nb_h)]
    sched = kernels.fill_schedule(na_h, nb_h, dev, planes=True)
    flat, corner = kernels.nw_fill_dirs(*t, bp, sched)
    s, c = kernels.nw_scores(*t, bp, sched)
    err = {"nw_fill_dirs[ragged]": 0, "nw_scores[ragged]": 0}
    off = sched.off.tolist()
    groups = {}
    for j, (a, b) in enumerate(zip(A, B)):
        groups.setdefault((pad_width(len(a)), pad_width(len(b))),
                          []).append(j)
    bucket_ms = {"nw_fill_dirs": 0.0, "nw_scores": 0.0}
    for (wa, wb), idx in groups.items():
        g = pack_batch(sc, params, [A[j] for j in idx], [B[j] for j in idx],
                       wa, wb)
        tb = [torch.from_numpy(v).to(dev) for v in g[:4]]
        d, dc = kernels.nw_fill_dirs(*tb, g[4])
        sb, cb = kernels.nw_scores(*tb, g[4])
        jj = torch.tensor(idx, device=dev)
        e = max_abs((corner[jj], dc))
        for i, j in enumerate(idx):
            lanes = int(nb_h[j]) + 1
            plane = flat[off[j]:off[j + 1]].view(-1, lanes)
            v = valid_mask(plane.shape[0], lanes, t[2][j:j + 1],
                           t[3][j:j + 1])[0]
            e = max(e, max_abs((plane[v],
                                d[i, :plane.shape[0], :lanes][v])))
        merge(err, {"nw_fill_dirs[ragged]": e,
                    "nw_scores[ragged]": max_abs((s[jj], sb), (c[jj], cb))})
        bucket_ms["nw_fill_dirs"] += cuda_ms(
            lambda: kernels.nw_fill_dirs(*tb, g[4]), 1)
        bucket_ms["nw_scores"] += cuda_ms(
            lambda: kernels.nw_scores(*tb, g[4]), 1)
        del d
    # row nw_walk[ragged]: the walks of these planes, as align_batch makes
    # them, against the plain walk on every pair
    cap = int((na_h + nb_h).max())

    def walk():
        return kernels.nw_walk(flat, corner, t[2], t[3], cap, sched.off)

    o = walk()
    op, t_p = timed_plain(lambda: nw_walk_plain(flat, corner, t[2], t[3],
                                                cap, sched.off))
    err["nw_walk[ragged]"] = max_abs(*zip(o, op))
    times["nw_walk[ragged]"] = (cuda_ms(walk, 3), t_p)
    bounds["nw_walk[ragged]"] = walk_bound("nw_walk[ragged]", o[0], 1,
                                           20 * RAGGED_PAIRS)
    del flat, o, op
    ms = (cuda_ms(lambda: kernels.nw_fill_dirs(*t, bp, sched), 3),
          cuda_ms(lambda: kernels.nw_scores(*t, bp, sched), 3))
    log(f"phase 1: ragged rows on {RAGGED_PAIRS} pairs of 1-10 kb in "
        f"{len(groups)} width buckets: one launch (nw_fill_dirs, "
        f"nw_scores) {ms[0]:.3f}, {ms[1]:.3f} ms; the {len(groups)} bucket "
        f"launches {bucket_ms['nw_fill_dirs']:.3f}, "
        f"{bucket_ms['nw_scores']:.3f} ms")
    # the plain versions on 8 ragged pairs of up to 300 bp
    As, Bs = dna(rng, 8, 1, 300), dna(rng, 8, 1, 300)
    As[1] = ""
    g = pack_batch(sc, params, As, Bs, 300, 300)
    ts = [torch.from_numpy(v).to(dev) for v in g[:4]]
    small = kernels.fill_schedule(g[2], g[3], dev, planes=True)
    fk, ck = kernels.nw_fill_dirs(*ts, g[4], small)
    t1 = time.perf_counter()
    fp, cp = nw_fill_dirs_plain(*ts, g[4], small.off)
    plain_fill = 1e3 * (time.perf_counter() - t1)
    t1 = time.perf_counter()
    sp, cps = nw_scores_plain(*ts, g[4])
    plain_scores = 1e3 * (time.perf_counter() - t1)
    sk, csk = kernels.nw_scores(*ts, g[4], small)
    offs = small.off.tolist()
    v = torch.zeros_like(fp, dtype=torch.bool)
    for i in range(len(As)):
        lanes = max(int(g[3][i]), 1) + 1
        v[offs[i]:offs[i + 1]] = valid_mask(
            (offs[i + 1] - offs[i]) // lanes, lanes, ts[2][i:i + 1],
            ts[3][i:i + 1]).reshape(-1)
    cap = int((g[2] + g[3]).max())
    merge(err, {"nw_fill_dirs[ragged]": max_abs(
        (fk[v], fp[v]), (ck, cp),
        *zip(kernels.nw_walk(fk, ck, ts[2], ts[3], cap, small.off),
             nw_walk_plain(fp, cp, ts[2], ts[3], cap, small.off))),
        "nw_scores[ragged]": max_abs((sk, sp), (csk, cps))})
    times["nw_fill_dirs[ragged]"] = (ms[0], plain_fill)
    times["nw_scores[ragged]"] = (ms[1], plain_scores)
    bounds["nw_fill_dirs[ragged]"] = fill_bound(na_h, nb_h, False, True)
    bounds["nw_scores[ragged]"] = fill_bound(na_h, nb_h, False, False)
    torch.cuda.synchronize()
    log(f"phase 1: ragged rows vs bucket kernels and plain: max |diff| "
        f"{err} ({time.perf_counter() - t0:.1f} s)")
    return err


def plane_valid(off, na, nb):
    """The valid cells of the 1-d planes of a launch across widths at the
    offsets ``off`` ((B+1,) int64), ``na``, ``nb`` (B,) on the card."""
    offs = off.tolist()
    v = torch.zeros(offs[-1], dtype=torch.bool, device=off.device)
    for i in range(len(offs) - 1):
        lanes = max(int(nb[i]), 1) + 1
        v[offs[i]:offs[i + 1]] = valid_mask(
            (offs[i + 1] - offs[i]) // lanes, lanes, na[i:i + 1],
            nb[i:i + 1]).reshape(-1)
    return v


def on_planes(flat, off, na, nb, full):
    """The valid cells of each pair's plane at the offsets ``off`` in the
    1-d ``flat`` of a launch across widths, beside the same cells of the
    uniform planes ``full`` (B, D, LB+1) of the same pairs: (got, want)
    pairs for :func:`max_abs`.  ``na``, ``nb`` (B,) on the card."""
    offs = off.tolist()
    pairs = []
    for i in range(len(offs) - 1):
        lanes = max(int(nb[i]), 1) + 1
        rows = (offs[i + 1] - offs[i]) // lanes
        v = valid_mask(rows, lanes, na[i:i + 1], nb[i:i + 1])[0]
        pairs.append((flat[offs[i]:offs[i + 1]].view(rows, lanes)[v],
                      full[i, :rows, :lanes][v]))
    return pairs


def sw_ragged_vs_plain(sc, params, A, B, m16, k, dev, plain=None):
    """The SW launches across widths of ``A``, ``B`` against their plain
    versions: ``sw_scores`` (against the max of the plain M of each pair),
    the codes on the valid cells, the whole M (every other cell 0), and
    ``sw_hits`` at each pair's best - 10 (``k`` hits).  With ``plain`` (a
    dict) ``sw_scores_plain`` is run too, held to ``sw_scores``, and the
    three plain versions' milliseconds go there.  Returns the max |diff| of
    each kernel and the launch's schedule."""
    from seqalign_tpu_torch.ops import kernels
    from seqalign_tpu_torch.ops.dp import (sw_fill_dirs_plain,
                                           sw_scores_plain,
                                           sw_sorted_candidates)
    from seqalign_tpu_torch.ops.pack import pack_batch
    from seqalign_tpu_torch.ops.traceback import sw_hits_plain

    g = pack_batch(sc, params, A, B, max(1, max(map(len, A))),
                   max(1, max(map(len, B))))
    t = [torch.from_numpy(v).to(dev) for v in g[:4]]
    sched = kernels.fill_schedule(g[2], g[3], dev, planes=True)
    fk, mk = kernels.sw_fill_dirs(*t, g[4], m16, sched)
    best = kernels.sw_scores(*t, g[4], sched)
    out = {}
    ms = cuda_ms(lambda: out.setdefault(
        "fill", sw_fill_dirs_plain(*t, g[4], m16, sched.off)), 1, warm=False)
    fp, mp = out["fill"]
    offs = sched.off.tolist()
    best_p = torch.stack([mp[offs[i]:offs[i + 1]].max().int()
                          for i in range(len(A))])
    v = plane_valid(sched.off, t[2], t[3])
    thr = np.maximum(best_p.cpu().numpy().astype(np.int64) - 10, 1)
    cand = sw_sorted_candidates(mk, g[2], g[3], thr, off=sched.off)
    args = (fk, *t, cand[0], cand[1], cand[2][:-1], cand[2][1:], g[4], k,
            sched.off)
    hits = kernels.sw_hits(*args)
    hms = cuda_ms(lambda: out.setdefault("hits", sw_hits_plain(*args)), 1,
                  warm=False)
    pairs = [(best, best_p)]
    if plain is not None:
        sms = cuda_ms(lambda: out.setdefault(
            "scores", sw_scores_plain(*t, g[4])), 1, warm=False)
        pairs.append((best, out["scores"]))
        plain.update(sw_fill_dirs=ms, sw_hits=hms, sw_scores=sms)
    return {"sw_scores[ragged]": max_abs(*pairs),
            "sw_fill_dirs[ragged]": max_abs((fk[v], fp[v]), (mk, mp)),
            "sw_hits[ragged]": max_abs(*zip(hits, out["hits"]))}, sched


def sw_ragged_vs_buckets(sc, params, dev, times, bounds):
    """Rows ``sw_scores[ragged]``, ``sw_fill_dirs[ragged]`` and
    ``sw_hits[ragged]``: the SW fills as one launch across widths and the
    hit loop over its planes, on SW job 3's mix (``SW_JOB3`` pairs of 1-10
    kb DNA with a planted segment, from a generator of its own so that the
    paths' inputs stay as they were), min_score = best - 10, k =
    ``_SW_PREWALK``: the first sub-batch the aligner cuts of them
    (``_align_budget``, ``_sw_pair_bytes``), as ``align_batch`` launches
    it.  Held to the uniform launches of its width buckets on every pair,
    kernel against kernel (the best scores; codes and M on the valid cells
    of each pair's planes; the hits of each pair from the bucket's
    harvest); to the plain versions on 4 of its pairs at their sizes (the
    widest side b, past one round of the tiles, the fewest cells, the
    most, and one more; hit masks in shared and in global memory) and on 8
    ragged pairs of up to 300 bp with an empty side
    (``sw_ragged_vs_plain``); timed beside the sum of the bucket launches.
    Row ``sw_walk[ragged]``: ``sw_walk`` over the launch's planes on the
    hits found there, as ``align_batch`` traces them, against its plain
    version on every walk, both timed.  Returns the max |diff| of each
    row."""
    from seqalign_tpu_torch import aligners
    from seqalign_tpu_torch.ops import kernels
    from seqalign_tpu_torch.ops.dp import sw_sorted_candidates
    from seqalign_tpu_torch.ops.pack import m16_safe, pack_batch, pad_width
    from seqalign_tpu_torch.ops.traceback import sw_walk_plain

    t0 = time.perf_counter()
    rng = np.random.default_rng(SEED + 3)
    A, B = planted(rng, DNA, SW_JOB3[1], 1000, 10000, (0.3, 0.5), 0.03)
    mbytes = 2 if m16_safe(sc, max(map(len, A)), max(map(len, B))) else 4
    budget = aligners._align_budget(dev)
    subs = aligners._plane_subbatches(
        range(len(A)), budget,
        lambda i: aligners._sw_pair_bytes(len(A[i]), len(B[i]), mbytes,
                                          False))
    A, B = [A[i] for i in subs[0]], [B[i] for i in subs[0]]
    ac, bc, na_h, nb_h, bp = pack_batch(sc, params, A, B, max(map(len, A)),
                                        max(map(len, B)))
    t = [torch.from_numpy(v).to(dev) for v in (ac, bc, na_h, nb_h)]
    sched = kernels.fill_schedule(na_h, nb_h, dev, planes=True)
    m16 = m16_safe(sc, int(na_h.max()), int(nb_h.max()))
    best = kernels.sw_scores(*t, bp, sched)
    mins = np.maximum(best.cpu().numpy().astype(np.int64) - 10, 1)
    k = aligners._SW_PREWALK
    flat, mflat = kernels.sw_fill_dirs(*t, bp, m16, sched)
    cand = sw_sorted_candidates(mflat, na_h, nb_h, mins, off=sched.off)
    hargs = (flat, *t, cand[0], cand[1], cand[2][:-1], cand[2][1:], bp, k,
             sched.off)
    hits = kernels.sw_hits(*hargs)
    offs = sched.off.tolist()
    groups = {}
    for j, (a, b) in enumerate(zip(A, B)):
        groups.setdefault((pad_width(len(a)), pad_width(len(b))),
                          []).append(j)
    rows = ("sw_scores[ragged]", "sw_fill_dirs[ragged]", "sw_hits[ragged]")
    err = dict.fromkeys(rows, 0)
    bucket_ms = dict.fromkeys(rows, 0.0)
    for (wa, wb), idx in groups.items():
        g = pack_batch(sc, params, [A[j] for j in idx], [B[j] for j in idx],
                       wa, wb)
        tb = [torch.from_numpy(v).to(dev) for v in g[:4]]
        d, m = kernels.sw_fill_dirs(*tb, g[4], m16)
        e = 0
        for i, j in enumerate(idx):
            lanes = max(int(nb_h[j]), 1) + 1
            rows_j = (offs[j + 1] - offs[j]) // lanes
            v = valid_mask(rows_j, lanes, t[2][j:j + 1], t[3][j:j + 1])[0]
            for got, want in ((flat, d), (mflat, m)):
                plane = got[offs[j]:offs[j + 1]].view(rows_j, lanes)
                e = max(e, max_abs((plane[v], want[i, :rows_j, :lanes][v])))
        bf, bs, bo = sw_sorted_candidates(m, g[2], g[3], mins[idx])
        bargs = (d, *tb, bf, bs, bo[:-1], bo[1:], g[4], k)
        jj = torch.tensor(idx, device=dev)
        merge(err, {"sw_scores[ragged]": max_abs(
                        (best[jj], kernels.sw_scores(*tb, g[4]))),
                    "sw_fill_dirs[ragged]": e,
                    "sw_hits[ragged]": max_abs(*zip(
                        (h[jj] for h in hits), kernels.sw_hits(*bargs)))})
        del m
        bucket_ms["sw_scores[ragged]"] += cuda_ms(
            lambda: kernels.sw_scores(*tb, g[4]), 1)
        bucket_ms["sw_fill_dirs[ragged]"] += cuda_ms(
            lambda: kernels.sw_fill_dirs(*tb, g[4], m16), 1)
        bucket_ms["sw_hits[ragged]"] += cuda_ms(
            lambda: kernels.sw_hits(*bargs), 1)
        del d, bargs
    del mflat
    ms = (cuda_ms(lambda: kernels.sw_scores(*t, bp, sched), 3),
          cuda_ms(lambda: kernels.sw_fill_dirs(*t, bp, m16, sched), 3),
          cuda_ms(lambda: kernels.sw_hits(*hargs), 3))
    cells = int((na_h.astype(np.int64) * nb_h).sum())
    bounds["sw_scores[ragged]"] = fill_bound(na_h, nb_h, True, False)
    bounds["sw_fill_dirs[ragged]"] = fill_bound(
        na_h, nb_h, True, True, 2 if m16 else 4,
        extra_bytes=(sched.total - cells) * (2 if m16 else 4))
    bounds["sw_hits[ragged]"] = hits_bound(hargs, hits)
    log(f"phase 1: SW ragged rows on job 3's first sub-batch: {len(A)} of "
        f"{SW_JOB3[1]} pairs of 1-10 kb ({len(subs)} sub-batches of at most "
        f"{budget} bytes, {'int16' if m16 else 'int32'} M) in "
        f"{len(groups)} width buckets: one launch (sw_scores, sw_fill_dirs, "
        f"sw_hits) " + ", ".join(f"{v:.3f}" for v in ms) + " ms; the "
        f"{len(groups)} bucket launches "
        + ", ".join(f"{bucket_ms[r]:.3f}" for r in rows) + " ms")
    # row sw_walk[ragged]: the hits' walks, as the aligner's hits() makes
    # them
    hit_flat, hit_score, nhits = hits
    keep = torch.arange(k, device=dev)[None, :] < nhits[:, None]
    jw, slot = keep.nonzero(as_tuple=True)
    w = t[2][jw].long() + 1
    fl = hit_flat[jw, slot].long()
    starts = [v.to(torch.int32).contiguous()
              for v in (jw, fl % w, fl // w, hit_score[jw, slot])]
    cap = int((starts[1] + starts[2]).max())

    def walk():
        return kernels.sw_walk(flat, *t, *starts, bp, cap, sched.off)

    o = walk()
    op, t_p = timed_plain(lambda: sw_walk_plain(flat, *t, *starts, bp, cap,
                                                sched.off))
    err["sw_walk[ragged]"] = max_abs((o, op))
    times["sw_walk[ragged]"] = (cuda_ms(walk, 3), t_p)
    bounds["sw_walk[ragged]"] = walk_bound("sw_walk[ragged]", o, 3,
                                           16 * len(jw))
    log(f"phase 1: sw_walk over SW job 3's first sub-batch: {len(jw)} walks "
        f"of its hits, max |diff| {err['sw_walk[ragged]']}")
    del flat, hargs, o, op
    # the plain versions at the main path's sizes, on 4 of these pairs
    cells_j = na_h.astype(np.int64) * nb_h
    pick = list(dict.fromkeys([int(np.argmax(nb_h)), int(np.argmin(cells_j)),
                               int(np.argmax(cells_j)), 0, 1, 2]))[:4]
    P = [A[j] for j in pick], [B[j] for j in pick]
    np4 = np.array([len(a) for a in P[0]], np.int32)
    nb4 = np.array([len(b) for b in P[1]], np.int32)
    _, moff = kernels.hits_masks(torch.from_numpy(np4).to(dev),
                                 torch.from_numpy(nb4).to(dev),
                                 kernels.SMEM_MAX)
    spans = (moff[1:] - moff[:-1]).tolist()
    if not (int(nb4.max()) > kernels.TILE_LANES and any(spans)):
        raise AssertionError(f"the 4 pairs {list(zip(np4, nb4))} miss a "
                             f"round row or a mask in global memory")
    e4, _ = sw_ragged_vs_plain(sc, params, *P, m16, k, dev)
    merge(err, e4)
    log(f"phase 1: SW ragged rows vs plain on 4 pairs of "
        f"{list(zip(np4.tolist(), nb4.tolist()))} (masks in shared memory "
        f"{spans.count(0)}, in global {len(spans) - spans.count(0)}), "
        f"best - 10: max |diff| {e4}")
    # and on 8 ragged pairs of up to 300 bp, an empty side among them
    As, Bs = dna(rng, 8, 1, 300), dna(rng, 8, 1, 300)
    As[1], Bs[4] = "", ""
    plain = {}
    merge(err, sw_ragged_vs_plain(sc, params, As, Bs, True, k, dev,
                                  plain)[0])
    for r, v in zip(rows, ms):
        times[r] = (v, plain[r.split("[")[0]])
    torch.cuda.synchronize()
    log(f"phase 1: SW ragged rows vs bucket kernels and plain: max |diff| "
        f"{err} ({time.perf_counter() - t0:.1f} s)")
    return err


def merge(err, e):
    """Max-merge the errors ``e`` of one check into ``err``."""
    for k, v in e.items():
        err[k] = max(err.get(k, 0), v)


def hits_on_host(late, times, row, args, out, t_kernel=None):
    """``sw_hits_plain(*args)`` in a host worker (``HOST``) against the
    kernel's outputs ``out``: ``late[row]`` takes the max |diff| when the
    run settles its host checks and, with ``t_kernel``, ``times[row]`` the
    kernel's and the worker's milliseconds."""
    out = [o.cpu() for o in out]

    def then(want, ms):
        e = max_abs(*zip(out, want))
        merge(late, {row: e})
        if t_kernel is not None:
            times[row] = (t_kernel, ms)
        log(f"host check {row}: {int(out[2].clamp(min=0).sum())} hits, "
            f"plain on a host worker {ms:.1f} ms, max |diff| {e}")

    HOST.hits(then, args)
    HOST.rows.add(row)


# lane instructions of T1's chain an element and step, the fewest its op
# needs: one VIADDMNMX an add-max, one IADD3 two chained adds; a move's add
# (its shuffle, one a thread's K words, left out, as the fills' count leaves
# out theirs); int16 packs two lanes in one instruction, a move adding a
# byte permute a word
VPU_INSTR = {("addmax", "int32"): 1, ("add", "int32"): 0.5,
             ("roll", "int32"): 1, ("shift", "int32"): 1,
             ("addmax", "int16"): 0.5, ("add", "int16"): 0.5,
             ("roll", "int16"): 1, ("shift", "int16"): 1}


def vpu_bound(op, dt, lanes):
    """The least time of one probe launch: its lane instructions
    (``VPU_INSTR``) at ``PEAK_INT32``, or its bytes, the block read and
    written once."""
    t_ops = VPU_R * lanes * VPU_S * VPU_INSTR[op, dt] / PEAK_INT32
    t_bytes = 2 * VPU_R * lanes * (2 if dt == "int16" else 4) / PEAK_BYTES
    return (1e3 * max(t_ops, t_bytes),
            "operations" if t_ops >= t_bytes else "bytes")


class PlainGuard:
    """Replaces the plain versions the wrappers call with versions that
    raise on a CUDA tensor, for the main-path phases."""

    NAMES = ("nw_scores_plain", "nw_fill_dirs_plain", "nw_walk_plain",
             "sw_scores_plain", "sw_fill_dirs_plain", "sw_walk_plain",
             "sw_hits_plain", "nw_fill_dirs_carry_plain",
             "sw_fill_dirs_carry_plain", "nw_fill_gab_plain",
             "sw_fill_gab_plain", "nw_scores_slice_plain",
             "sw_scores_slice_plain", "nw_fill_dirs_slice_plain")

    def __enter__(self):
        from seqalign_tpu_torch.ops import kernels

        self.saved = {n: getattr(kernels, n) for n in self.NAMES}

        def guard(name, fn):
            def wrapped(*args):
                if any(isinstance(a, torch.Tensor) and a.is_cuda
                       for a in args):
                    raise AssertionError(f"{name} saw a CUDA tensor")
                return fn(*args)
            return wrapped

        for n, fn in self.saved.items():
            setattr(kernels, n, guard(n, fn))
        return self

    def __exit__(self, *exc):
        from seqalign_tpu_torch.ops import kernels

        for n, fn in self.saved.items():
            setattr(kernels, n, fn)


def timed(fn):
    """``fn()`` under the plain-version guard, and its wall seconds."""
    with PlainGuard():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0


def plain_scores(sc, params, seqs_a, seqs_b, dev, local=False):
    from seqalign_tpu_torch.ops.dp import nw_scores_plain, sw_scores_plain

    t, bp, _ = packed(sc, params, seqs_a, seqs_b, dev)
    if local:
        return sw_scores_plain(*t, bp).cpu().numpy()
    return nw_scores_plain(*t, bp)[0].cpu().numpy()


def plain_hits(sc, params, a, b, min_score, k, dev):
    """The first ``k`` hits of one pair from the plain SW fill and harvest
    on the card, walked on the host."""
    from seqalign_tpu_torch.ops.dp import (sw_extract_candidates,
                                           sw_fill_dirs_plain)
    from seqalign_tpu_torch.ops.traceback import SwHitIterator

    (ac, bc, na, nb), bp, (na_h, nb_h) = packed(sc, params, [a], [b], dev)
    dirs, m = sw_fill_dirs_plain(ac, bc, na, nb, bp)
    cands = sw_extract_candidates(m, na_h, nb_h, min_score)
    it = SwHitIterator(sc, a, b, int(na_h[0]), int(nb_h[0]),
                       dirs[0].cpu().numpy(), cands[0])
    return list(itertools.islice(it, k))


def eq_table(sc) -> np.ndarray:
    """Equality scoring as a 256 x 256 table: match when the bytes are
    equal after case folding (unless case sensitive), else mismatch."""
    c = np.arange(256)
    f = c if sc.case_sensitive else np.where((c >= 65) & (c <= 90), c + 32, c)
    return np.where(f[:, None] == f[None, :], sc.match,
                    sc.mismatch).astype(np.int64)


def blosum62_table(sc) -> np.ndarray:
    """The BLOSUM62 file of the repository as a 256 x 256 table, letters
    of either case; other pairs score by equality."""
    t = eq_table(sc)
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        BLOSUM62_FILE)
    with open(path) as fh:
        rows = [ln.split() for ln in fh if ln.strip()
                and not ln.startswith("#")]
    cols = rows[0]
    for r in rows[1:]:
        for cb, v in zip(cols, r[1:]):
            for x in {r[0].upper(), r[0].lower()}:
                for y in {cb.upper(), cb.lower()}:
                    t[ord(x), ord(y)] = int(v)
    return t


def flags_of(sc) -> frozenset:
    """The scoring flags of ``sc`` by their short names."""
    names = (("nsg", "no_start_gap_penalty"), ("neg", "no_end_gap_penalty"),
             ("nga", "no_gaps_in_a"), ("ngb", "no_gaps_in_b"),
             ("nmm", "no_mismatches"))
    return frozenset(k for k, attr in names if getattr(sc, attr))


def gotoh(table, go, ge, a: str, b: str, local=False,
          flags=frozenset()) -> int:
    """Optimal global (NW) or local (SW, every cell floored at 0) score by
    Gotoh's recurrence, one row of b at a time in int64 numpy; the
    horizontal gap run is a running max.  ``flags``: nsg frees the gap
    runs on row and column 0; neg frees gap steps on the last column (gap
    in a) and the last row (gap in b); nga / ngb allow a gap in a / b only
    there and on the boundary; nmm forbids columns of unequal letters
    (case folded, as ``eq_table`` scores them)."""
    ca = np.frombuffer(a.encode("latin-1"), np.uint8)
    cb = np.frombuffer(b.encode("latin-1"), np.uint8)
    na, nb = len(a), len(b)
    nsg, neg, nga, ngb, nmm = (k in flags for k in
                               ("nsg", "neg", "nga", "ngb", "nmm"))
    gop = go + ge
    lo = 0 if local else -(1 << 40)
    x = np.arange(na + 1, dtype=np.int64)
    M = np.full(na + 1, lo, np.int64)
    M[0] = 0
    Ga = M.copy()  # gap in a: from the row above
    Gb = M.copy() if local else (0 * x if nsg else go + x * ge)
    Gb[0] = 0
    low = np.vectorize(lambda c: c + 32 if 65 <= c <= 90 else c)
    fa = low(ca) if na else ca
    best = 0
    for y in range(1, nb + 1):
        ss = table[ca, cb[y - 1]]
        M2 = np.empty_like(M)
        M2[0] = lo
        M2[1:] = np.maximum(M, np.maximum(Ga, Gb))[:-1] + ss
        if nmm:
            M2[1:] = np.where(fa == low(cb[y - 1]), M2[1:], lo)
        Ga2 = np.maximum(np.maximum(M, Gb) + gop, Ga + ge)
        if neg:
            Ga2[na] = max(M[na], Ga[na], Gb[na])
        if nga:
            Ga2[1:na] = lo
        Ga2[0] = 0 if (local or nsg) else go + y * ge
        if local:
            M2 = np.maximum(M2, 0)
            Ga2 = np.maximum(Ga2, 0)
        Gb2 = np.empty_like(M)
        Gb2[0] = lo
        if neg and y == nb:
            Gb2[1:] = np.maximum.accumulate(np.maximum(M2, Ga2))[:-1]
        elif ngb and y != nb:
            Gb2[1:] = lo
        else:
            run = np.maximum.accumulate(
                np.maximum(np.maximum(M2, Ga2) + gop, lo) - x * ge)
            Gb2[1:] = run[:-1] + (x[1:] - 1) * ge
        M, Ga, Gb = M2, Ga2, Gb2
        best = max(best, int(M.max()))
    return best if local else int(max(M[-1], Ga[-1], Gb[-1]))


def rescore(table, go, ge, ra: str, rb: str, flags=frozenset()) -> int:
    """Affine score of an alignment's columns; a gap column opens a gap
    unless the column before it is a gap in the same sequence.  Under nsg
    the leading gap run is free, under neg the trailing one; under nga /
    ngb any other gap in a / b, and under nmm a column of unequal letters,
    makes the alignment invalid (returns None)."""
    ca = np.frombuffer(ra.encode("latin-1"), np.uint8)
    cb = np.frombuffer(rb.encode("latin-1"), np.uint8)
    kind = np.where(ca == GAP, 1, np.where(cb == GAP, 2, 0))
    prev = np.concatenate([[0], kind[:-1]])
    gap = np.where(kind == prev, ge, go + ge)
    cost = np.where(kind == 0, table[ca, cb], gap)
    n = len(kind)
    lead = trail = 0
    if n and kind[0]:
        lead = int(np.argmax(kind != kind[0])) or n
    if n and kind[-1]:
        trail = int(np.argmax(kind[::-1] != kind[-1])) or n
    inner = kind[lead:n - trail] if lead + trail <= n else kind[:0]
    if ("nga" in flags and (inner == 1).any()) or \
            ("ngb" in flags and (inner == 2).any()):
        return None
    if "nmm" in flags and (ra.lower() != rb.lower()) and any(
            p != "-" and q != "-" and p.lower() != q.lower()
            for p, q in zip(ra, rb)):
        return None
    if "nsg" in flags:
        cost[:lead] = 0
    if "neg" in flags and lead < n:
        cost[n - trail:] = 0
    return int(cost.sum())


def witness_scores(table, sc, A, B, scores, idx, what, local=False):
    """Each score of the pairs ``idx`` is the numpy Gotoh optimum
    (``check_optimum``)."""
    for i in idx:
        def then(opt, i=i, got=int(scores[i])):
            if got != opt:
                raise AssertionError(f"{what} pair {i}: score {got} is not "
                                     f"the numpy Gotoh optimum {opt}")

        check_optimum(then, table, sc.gap_open, sc.gap_extend, A[i], B[i],
                      local, flags_of(sc))


def witness_alignment(table, sc, a, b, aln, what, opt=None):
    """An NW alignment spells its pair and rescores to its score, which is
    the optimum: ``opt``, or the numpy Gotoh's."""
    ra, rb = aln.result_a, aln.result_b
    if (len(ra) != len(rb) or ra.replace("-", "") != a
            or rb.replace("-", "") != b
            or any(p == q == "-" for p, q in zip(ra, rb))):
        raise AssertionError(f"{what}: the strings do not spell the pair")
    flags = flags_of(sc)
    got = rescore(table, sc.gap_open, sc.gap_extend, ra, rb, flags)

    def then(opt):
        if not aln.score == got == opt:
            raise AssertionError(f"{what}: score {aln.score}, columns "
                                 f"rescore to {got}, optimum {opt}")

    if opt is None:
        check_optimum(then, table, sc.gap_open, sc.gap_extend, a, b,
                      flags=flags)
    else:
        then(opt)


def witness_hits(table, sc, a, b, hits, min_score, what, opt=None,
                 spell_only=False):
    """SW hits: the first is the local optimum (``opt``, or the numpy
    Gotoh's) when that reaches the hint, each spells a substring of both
    inputs and rescores to its score (a hit starts and ends in a MATCH
    column, so no gap step of it is a free end gap).  ``spell_only`` skips
    the optimum."""
    flags = flags_of(sc) - {"nsg", "neg"}
    for h in hits:
        ra, rb = h.result_a, h.result_b
        if (len(ra) != len(rb)
                or ra.replace("-", "") != a[h.pos_a:h.pos_a + h.len_a]
                or rb.replace("-", "") != b[h.pos_b:h.pos_b + h.len_b]
                or any(p == q == "-" for p, q in zip(ra, rb))):
            raise AssertionError(f"{what}: a hit does not spell its inputs")
        got = rescore(table, sc.gap_open, sc.gap_extend, ra, rb, flags)
        if got != h.score:
            raise AssertionError(f"{what}: hit score {h.score}, columns "
                                 f"rescore to {got}")
    if spell_only:
        return
    first = hits[0].score if hits else None

    def then(opt):
        if (opt >= max(min_score, 1)) != (first is not None) or (
                first is not None and first != opt):
            raise AssertionError(f"{what}: first hit {first}, local optimum "
                                 f"{opt}")

    if opt is None:
        check_optimum(then, table, sc.gap_open, sc.gap_extend, a, b,
                      local=True, flags=flags_of(sc))
    else:
        then(opt)


def rate(label, n_pairs, cells, secs, gpu):
    log(f"{label}: {n_pairs} pairs in {secs:.4f} s = {n_pairs / secs:.1f} "
        f"pairs/s, {cells / secs / 1e9:.3f} GCUPS [{gpu}]")


def cells_of(A, B):
    return sum(len(a) * len(b) for a, b in zip(A, B))


def phase_nw(nw, rng, dev, gpu, jobs):
    """Path nw: scores (the headline shape and the stream) and
    alignments, short and 1-10 kb."""
    sc, params = nw.scoring, nw.params
    table = eq_table(sc)
    A, B = (dna(rng, SHORT_BATCH, 512, 512), dna(rng, SHORT_BATCH, 512, 512))
    label = f"nw score_batch {SHORT_BATCH} x 512"
    got, secs = timed(lambda: nw.score_batch(A, B))
    rate(label, len(A), cells_of(A, B), secs, gpu)
    jobs[label] = (lambda A=A, B=B: nw.score_batch(A, B), secs)
    if not np.array_equal(got, plain_scores(sc, params, A, B, dev)):
        raise AssertionError("score_batch disagrees with the plain version")
    witness_scores(table, sc, A, B, got,
                   rng.choice(len(A), 32, replace=False), "score_batch")

    t0 = time.perf_counter()
    LA = dna(rng, STREAM_PAIRS, 1000, 10000)
    LB = dna(rng, STREAM_PAIRS, 1000, 10000)
    log(f"nw: made {STREAM_PAIRS} pairs of 1-10 kb in "
        f"{time.perf_counter() - t0:.1f} s")

    def stream():
        out = np.full(len(LA), np.iinfo(np.int64).min, np.int64)
        for idx, s in nw.score_pairs_stream(
                (i, a, b) for i, (a, b) in enumerate(zip(LA, LB))):
            out[idx] = s
        return out

    label = f"nw score_pairs_stream {STREAM_PAIRS} x 1-10kb"
    got, secs = timed(stream)
    rate(label, len(LA), cells_of(LA, LB), secs, gpu)
    jobs[label] = (stream, secs)
    sample = rng.choice(len(LA), 64, replace=False)
    want = plain_scores(sc, params, [LA[i] for i in sample],
                        [LB[i] for i in sample], dev)
    if not np.array_equal(got[sample], want):
        raise AssertionError("score_pairs_stream disagrees with the plain "
                             "version")
    witness_scores(table, sc, LA, LB, got, sample[:2], "score_pairs_stream")

    for n, lo, hi, n_plain, n_check in ((512, 256, 512, 512, 32),
                                        (ALIGN_LONG_PAIRS, 1000, 10000, 32,
                                         2)):
        A, B = dna(rng, n, lo, hi), dna(rng, n, lo, hi)
        label = (f"nw align_batch {n} x "
                 + (f"{lo}-{hi}" if hi < 1000 else "1-10kb"))
        alns, secs = timed(lambda: nw.align_batch(A, B))
        rate(label, len(A), cells_of(A, B), secs, gpu)
        jobs[label] = (lambda A=A, B=B: nw.align_batch(A, B), secs)
        sample = (np.arange(n) if n_plain >= n
                  else rng.choice(n, n_plain, replace=False))
        want = plain_scores(sc, params, [A[i] for i in sample],
                            [B[i] for i in sample], dev)
        if [alns[i].score for i in sample] != want.tolist():
            raise AssertionError(f"{label}: scores disagree with the plain "
                                 f"version")
        for i in rng.choice(n, n_check, replace=False):
            witness_alignment(table, sc, A[i], B[i], alns[i],
                              f"{label} pair {i}")


def phase_nw_table(nwp, rng, dev, gpu, jobs):
    """Path nw_table: NW under BLOSUM62 on protein pairs."""
    sc, params = nwp.scoring, nwp.params
    table = blosum62_table(sc)
    A = seqs(rng, PROTEIN_PAIRS, 100, 1000, AMINO)
    B = seqs(rng, PROTEIN_PAIRS, 100, 1000, AMINO)
    label = f"nw_table score_batch {PROTEIN_PAIRS} x 100-1000 aa"
    got, secs = timed(lambda: nwp.score_batch(A, B))
    rate(label, len(A), cells_of(A, B), secs, gpu)
    jobs[label] = (lambda A=A, B=B: nwp.score_batch(A, B), secs)
    sample = rng.choice(len(A), 64, replace=False)
    if not np.array_equal(got[sample], plain_scores(
            sc, params, [A[i] for i in sample], [B[i] for i in sample],
            dev)):
        raise AssertionError(f"{label}: disagrees with the plain version")
    witness_scores(table, sc, A, B, got, sample[:4], label)
    A, B = A[:NW_TABLE_ALIGN], B[:NW_TABLE_ALIGN]
    label = f"nw_table align_batch {NW_TABLE_ALIGN} x 100-1000 aa"
    alns, secs = timed(lambda: nwp.align_batch(A, B))
    rate(label, len(A), cells_of(A, B), secs, gpu)
    jobs[label] = (lambda: nwp.align_batch(A, B), secs)
    if [a.score for a in alns] != got[:NW_TABLE_ALIGN].tolist():
        raise AssertionError(f"{label}: scores disagree with score_batch")
    for i in rng.choice(len(A), 4, replace=False):
        witness_alignment(table, sc, A[i], B[i], alns[i], f"{label} pair {i}")


def sw_scores_job(sw, table, rng, dev, gpu, jobs, label, A, B, n_plain,
                  n_check):
    got, secs = timed(lambda: sw.best_score_batch(A, B))
    rate(label, len(A), cells_of(A, B), secs, gpu)
    jobs[label] = (lambda: sw.best_score_batch(A, B), secs)
    sample = rng.choice(len(A), n_plain, replace=False)
    want = plain_scores(sw.scoring, sw.params, [A[i] for i in sample],
                        [B[i] for i in sample], dev, local=True)
    if not np.array_equal(got[sample], want):
        raise AssertionError(f"{label}: disagrees with the plain version")
    witness_scores(table, sw.scoring, A, B, got, sample[:n_check], label,
                   local=True)
    return got


def consume(sw, A, B, mins, k, stats=None):
    """``align_batch`` and the first ``k`` hits of every pair; ``stats``
    gets the candidate counts, the walk branch of each pair, the device
    bytes the live iterators hold and the iterators."""
    from seqalign_tpu_torch.ops.traceback import SwDeviceHits

    base = torch.cuda.memory_allocated()
    its = sw.align_batch(A, B, mins)
    if stats is not None:
        stats["held"] = torch.cuda.memory_allocated() - base
        stats["cands"] = np.array([it.n_candidates for it in its])
        stats["device_walk"] = sum(isinstance(it, SwDeviceHits) for it in its)
        stats["its"] = its
    return [list(itertools.islice(it, k)) for it in its]


def call_events(fn, *targets):
    """``fn()`` with each call of the functions ``targets`` ((object, name)
    pairs) between two CUDA events (recorded on the stream, no
    synchronisation): returns fn's result and, by name, the milliseconds
    of each call."""
    marks = {name: [] for _, name in targets}

    def wrap(real, name):
        def call(*args, **kw):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            out = real(*args, **kw)
            ev[1].record()
            marks[name].append(ev)
            return out
        return call

    saved = [(obj, name, getattr(obj, name)) for obj, name in targets]
    for obj, name, real in saved:
        setattr(obj, name, wrap(real, name))
    try:
        out = fn()
    finally:
        for obj, name, real in saved:
            setattr(obj, name, real)
    torch.cuda.synchronize()
    return out, {name: [a.elapsed_time(b) for a, b in ev]
                 for name, ev in marks.items()}


def fill_events(fn):
    """``fn()`` with each ``sw_fill_dirs`` launch between two CUDA events:
    returns fn's result and the milliseconds of each launch."""
    from seqalign_tpu_torch.ops import kernels

    out, ms = call_events(fn, (kernels, "sw_fill_dirs"))
    return out, ms["sw_fill_dirs"]


def sw_align_job(sw, table, rng, dev, gpu, jobs, job, A, B, mins, n_plain,
                 n_check):
    import seqalign_tpu_torch as port

    name, n, k = job
    label = f"sw align_batch {name}: {n} pairs, first {k} hits"
    stats = {}
    before = port.kernel_launch_counts()
    (hits, secs), fill_ms = fill_events(
        lambda: timed(lambda: consume(sw, A, B, mins, k, stats)))
    after = port.kernel_launch_counts()
    rate(label, n, cells_of(A, B), secs, gpu)
    c = stats["cands"]
    log(f"{label}: candidates per pair min {c.min()} median "
        f"{int(np.median(c))} max {c.max()} (total {c.sum()}); hits found "
        f"on the card for {stats['device_walk']} pairs, host walk "
        f"{n - stats['device_walk']} pairs; live iterators hold "
        f"{stats['held']} device bytes; {sum(map(len, hits))} hits; "
        f"launches " + ", ".join(f"{kn} {after[kn] - before[kn]}" for kn in
                                 ("sw_fill_dirs[ragged]", "sw_fill_dirs",
                                  "sw_hits[ragged]", "sw_hits", "sw_walk"))
        + f"; the fills {sum(fill_ms):.3f} ms (CUDA events: "
        + ", ".join(f"{t:.3f}" for t in fill_ms) + ")")
    jobs[label] = (lambda: consume(sw, A, B, mins, k), secs)
    m = [1] * n if mins is None else mins
    for i in rng.choice(n, n_plain, replace=False):
        # a deeper consumer: 3 k hits more, a second device round
        more = list(itertools.islice(stats["its"][i], 3 * k))
        want = plain_hits(sw.scoring, sw.params, A[i], B[i], m[i], 4 * k,
                          dev)
        if hits[i] + more != want:
            raise AssertionError(f"{label} pair {i}: hits disagree with the "
                                 f"plain versions")
    for i in rng.choice(n, n_check, replace=False):
        witness_hits(table, sw.scoring, A[i], B[i], hits[i], m[i],
                     f"{label} pair {i}")


def job1_inputs(rng, n):
    """Job 1: DNA pairs of 256-512 bp, no hint."""
    return dna(rng, n, 256, 512), dna(rng, n, 256, 512), None


def job3_inputs(sw, rng, n):
    """Job 3: DNA pairs of 1-10 kb with a planted segment, aligned in two
    passes: best scores first, then the hits within 10 of each pair's
    best (random DNA under the SW default is in the linear phase, so a
    fixed threshold would harvest most of a long pair, and best - 100
    still harvests ~180 k cells per pair)."""
    A, B = planted(rng, DNA, n, 1000, 10000, (0.3, 0.5), 0.03)
    best, _ = timed(lambda: sw.best_score_batch(A, B))
    return A, B, [max(1, int(s) - 10) for s in best]


def job2_inputs(rng, n):
    """Job 2 (BASELINE.json configs[2]): protein pairs of 100-1,000 aa
    with a planted homologous segment, min_score above the background."""
    A, B = planted(rng, AMINO, n, 100, 1000, (0.1, 0.3), 0.25)
    return A, B, [PROTEIN_MIN_SCORE] * n


def phase_sw(sw, rng, dev, gpu, jobs):
    """Path sw: SW default scoring on DNA."""
    table = eq_table(sw.scoring)
    A, B = dna(rng, SHORT_BATCH, 512, 512), dna(rng, SHORT_BATCH, 512, 512)
    sw_scores_job(sw, table, rng, dev, gpu, jobs,
                  f"sw best_score_batch {SHORT_BATCH} x 512", A, B, 256, 8)
    A = dna(rng, SW_LONG_PAIRS, 1000, 10000)
    B = dna(rng, SW_LONG_PAIRS, 1000, 10000)
    sw_scores_job(sw, table, rng, dev, gpu, jobs,
                  f"sw best_score_batch {SW_LONG_PAIRS} x 1-10kb", A, B, 8, 2)
    sw_align_job(sw, table, rng, dev, gpu, jobs, SW_JOB1,
                 *job1_inputs(rng, SW_JOB1[1]), 4, 4)
    sw_align_job(sw, table, rng, dev, gpu, jobs, SW_JOB3,
                 *job3_inputs(sw, rng, SW_JOB3[1]), 1, 2)


def phase_sw_table(swp, rng, dev, gpu, jobs):
    """Path sw_table: BLOSUM62 on protein (BASELINE.json configs[2])."""
    table = blosum62_table(swp.scoring)
    A = seqs(rng, PROTEIN_PAIRS, 100, 1000, AMINO)
    B = seqs(rng, PROTEIN_PAIRS, 100, 1000, AMINO)
    sw_scores_job(swp, table, rng, dev, gpu, jobs,
                  f"sw_table best_score_batch {PROTEIN_PAIRS} x 100-1000 aa",
                  A, B, 64, 4)
    sw_align_job(swp, table, rng, dev, gpu, jobs, SW_JOB2,
                 *job2_inputs(rng, SW_JOB2[1]), 4, 4)


def check_lcs_hit(seq, h, what):
    """An LCS hit by spelling: two substrings of ``seq`` at different
    offsets, equal but for case, scored by their length."""
    sub = seq[h.pos_a:h.pos_a + h.len_a]
    if not (h.result_a == sub and h.result_b == seq[h.pos_b:h.pos_b + h.len_b]
            and h.result_a.lower() == h.result_b.lower()
            and h.pos_a < h.pos_b
            and h.score == h.len_a == h.len_b > 0):
        raise AssertionError(f"{what}: not a repeated substring: {h}")


def phase_modes(rng, dev, gpu, jobs):
    """Path modes: every recurrence mode through the entry points, each
    under its own launch counts (set to 0 before the mode's jobs, read
    after them).  Per mode, on 256 DNA pairs: ``score_batch``,
    ``align_batch`` and ``best_score_batch`` at 512 bp (the mode rows of
    bench.py among them) and SW ``align_batch`` on 256-512 bp, first 8
    hits.  Then NW ``align_batch`` with free start and end gaps on reads
    against references (counted under nsg+neg), and the LCS recipe over
    sequences against themselves (counted under nga+ngb+nmm).  Returns
    mode -> launch counts."""
    import seqalign_tpu_torch as port

    counts = {}
    for mode in MODES:
        port.reset_kernel_launch_counts()
        nw = port.NeedlemanWunsch(mode_scoring(mode), device="cuda")
        sw = port.SmithWaterman(mode_scoring(mode, True), device="cuda")
        nt, st_ = eq_table(nw.scoring), eq_table(sw.scoring)
        A = dna(rng, MODE_B, MODE_L, MODE_L)
        B = dna(rng, MODE_B, MODE_L, MODE_L)
        label = f"modes[{mode}] nw score_batch 256 x 512"
        got, secs = timed(lambda: nw.score_batch(A, B))
        rate(label, len(A), cells_of(A, B), secs, gpu)
        jobs[label] = (lambda nw=nw, A=A, B=B: nw.score_batch(A, B), secs)
        if not np.array_equal(got, plain_scores(nw.scoring, nw.params, A, B,
                                                dev)):
            raise AssertionError(f"{label}: disagrees with the plain version")
        witness_scores(nt, nw.scoring, A, B, got, range(2), label)
        label = f"modes[{mode}] nw align_batch 256 x 512"
        alns, secs = timed(lambda: nw.align_batch(A, B))
        rate(label, len(A), cells_of(A, B), secs, gpu)
        jobs[label] = (lambda nw=nw, A=A, B=B: nw.align_batch(A, B), secs)
        if [a.score for a in alns] != got.tolist():
            raise AssertionError(f"{label}: scores disagree with score_batch")
        for i in range(2):
            witness_alignment(nt, nw.scoring, A[i], B[i], alns[i],
                              f"{label} pair {i}")
        label = f"modes[{mode}] sw best_score_batch 256 x 512"
        best, secs = timed(lambda: sw.best_score_batch(A, B))
        rate(label, len(A), cells_of(A, B), secs, gpu)
        jobs[label] = (lambda sw=sw, A=A, B=B: sw.best_score_batch(A, B),
                       secs)
        if not np.array_equal(best, plain_scores(sw.scoring, sw.params, A, B,
                                                 dev, local=True)):
            raise AssertionError(f"{label}: disagrees with the plain version")
        witness_scores(st_, sw.scoring, A, B, best, range(2), label,
                       local=True)
        A = dna(rng, MODE_B, MODE_L // 2, MODE_L)
        B = dna(rng, MODE_B, MODE_L // 2, MODE_L)
        label = f"modes[{mode}] sw align_batch 256 x 256-512, first 8 hits"
        stats = {}
        hits, secs = timed(lambda: consume(sw, A, B, None, 8, stats))
        rate(label, len(A), cells_of(A, B), secs, gpu)
        jobs[label] = (lambda sw=sw, A=A, B=B: consume(sw, A, B, None, 8),
                       secs)
        want = plain_hits(sw.scoring, sw.params, A[0], B[0], 1, 8, dev)
        if hits[0] != want:
            raise AssertionError(f"{label}: hits disagree with the plain "
                                 f"versions")
        for i in range(2):
            witness_hits(st_, sw.scoring, A[i], B[i], hits[i], 1,
                         f"{label} pair {i}")
        if mode == "nsg+neg":
            read_reference_job(nw, nt, rng, gpu, jobs)
        if mode == "nga+ngb+nmm":
            lcs_job(rng, gpu, jobs)
        counts[mode] = port.kernel_launch_counts()
        counted("modes", counts[mode], f"modes[{mode}]")
    return counts


def read_reference_job(nw, table, rng, gpu, jobs):
    """NW ``align_batch`` with free start and end gaps on reads of 256-512
    bp against references of 1-10 kb that hold them (3% substitutions): the
    overlap alignment free end gaps are for."""
    n = READ_REF_PAIRS
    refs = dna(rng, n, 1000, 10000)
    reads = []
    for r in refs:
        k = int(rng.integers(READ_LEN[0], READ_LEN[1] + 1))
        p = int(rng.integers(0, len(r) - k + 1))
        seg = np.frombuffer(r[p:p + k].encode(), np.uint8).copy()
        hit = rng.random(k) < 0.03
        seg[hit] = DNA[rng.integers(0, len(DNA), int(hit.sum()))]
        reads.append(seg.tobytes().decode())
    label = f"modes[nsg+neg] nw align_batch {n} reads x 1-10kb references"
    alns, secs = timed(lambda: nw.align_batch(refs, reads))
    rate(label, n, cells_of(refs, reads), secs, gpu)
    jobs[label] = (lambda: nw.align_batch(refs, reads), secs)
    for i in rng.choice(n, 4, replace=False):
        witness_alignment(table, nw.scoring, refs[i], reads[i], alns[i],
                          f"{label} pair {i}")
        # the read lies inside the reference: both end gaps are in the read
        if not (alns[i].result_b.startswith("-")
                or alns[i].result_b.endswith("-")):
            raise AssertionError(f"{label} pair {i}: no end gap")
    if min(a.score for a in alns) < READ_LEN[0] // 2:
        raise AssertionError(f"{label}: a read did not find its place")


def lcs_job(rng, gpu, jobs):
    """The LCS recipe, case folded: ``lcs_aligner().align_batch`` over DNA
    sequences of 512-2,048 bp against themselves, each with one planted
    repeat, first 8 hits with pos_a < pos_b (the filter of ``lcs_hits``);
    then ``lcs_hits`` itself on sequences of 2,048 bp, which route to the
    card one by one."""
    import seqalign_tpu_torch as port

    n = LCS_SEQS
    S = dna(rng, n, 512, 2048)
    for i, s in enumerate(S):
        p = int(rng.integers(0, len(s) - 2 * LCS_PLANT + 1))
        q = int(rng.integers(p + LCS_PLANT, len(s) - LCS_PLANT + 1))
        S[i] = s[:q] + s[p:p + LCS_PLANT] + s[q + LCS_PLANT:]
    sw = port.lcs_aligner(case_sensitive=False)
    stats = {}

    def run(stats=None):
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        its = sw.align_batch(S, S)
        if stats is not None:
            stats["peak"] = torch.cuda.max_memory_allocated() - base
            stats["cands"] = np.array([it.n_candidates for it in its])
        return [list(itertools.islice((h for h in it if h.pos_a < h.pos_b),
                                      8)) for it in its]

    label = f"modes[nga+ngb+nmm] lcs align_batch {n} x 512-2048, first 8 hits"
    hits, secs = timed(lambda: run(stats))
    rate(label, n, cells_of(S, S), secs, gpu)
    c = stats["cands"]
    log(f"{label}: candidates per pair min {c.min()} median "
        f"{int(np.median(c))} max {c.max()} (total {c.sum()}, "
        f"{c.sum() / cells_of(S, S):.4f} of the cells); peak device bytes "
        f"of align_batch {stats['peak']}; {sum(map(len, hits))} hits")
    jobs[label] = (run, secs)
    for s, hs in zip(S, hits):
        for h in hs:
            check_lcs_hit(s, h, label)
        if not hs or hs[0].score < LCS_PLANT:
            raise AssertionError(f"{label}: the planted repeat was not the "
                                 f"first hit")
    T = dna(rng, 4, 2048, 2048)
    label = "modes[nga+ngb+nmm] lcs_hits 4 x 2048, first 8 hits"
    got, secs = timed(lambda: [list(itertools.islice(
        port.lcs_hits(s, sw=sw), 8)) for s in T])
    rate(label, len(T), cells_of(T, T), secs, gpu)
    jobs[label] = (lambda: [list(itertools.islice(port.lcs_hits(s, sw=sw),
                                                  8)) for s in T], secs)
    for s, hs in zip(T, got):
        if len(hs) != 8:
            raise AssertionError(f"{label}: {len(hs)} hits")
        for h in hs:
            check_lcs_hit(s, h, label)


def plant(rng, a: str, b: str, k: int, sub: float, pb=None) -> str:
    """``b`` with a ``k``-letter segment of ``a`` copied in at ``pb``
    (random if None), with substitutions at rate ``sub``."""
    pa = int(rng.integers(0, len(a) - k + 1))
    seg = np.frombuffer(a[pa:pa + k].encode(), np.uint8).copy()
    hit = rng.random(k) < sub
    seg[hit] = DNA[rng.integers(0, len(DNA), int(hit.sum()))]
    pb = int(rng.integers(0, len(b) - k + 1)) if pb is None else pb
    return b[:pb] + seg.tobytes().decode() + b[pb + k:]


class LongFills:
    """Records the chunked fills of the long path (the slabs' shape: pairs,
    chunks, rows, lanes; the SW candidates harvested) by wrapping the
    aligners' ``_LongFill``."""

    def __enter__(self):
        from seqalign_tpu_torch import aligners

        self.saved = aligners._LongFill
        self.fills = []
        rec = self.fills

        class Recorded(self.saved):
            def __init__(self, *a, **k):
                super().__init__(*a, **k)
                rec.append((tuple(self.dirs.shape),
                            int(getattr(self, "counts", np.zeros(1)).sum())))

        aligners._LongFill = Recorded
        return self

    def __exit__(self, *exc):
        from seqalign_tpu_torch import aligners

        aligners._LongFill = self.saved


def long_job(label, fn, cells, n, gpu, jobs=None):
    """One job of path long, run once under ``torch.profiler``: its wall
    (profiler on), GCUPS, busy share (device self time over that wall),
    carry launches per chunk, the chunks and slab bytes of its fills, its
    harvested candidates, its peak device memory and its top device items.
    Returns its result."""
    import seqalign_tpu_torch as port
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    carry = ("nw_fill_dirs_carry", "sw_fill_dirs_carry")
    c0 = port.kernel_launch_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    with LongFills() as rec, torch_profile(
            activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        out, secs = timed(fn)
    peak = torch.cuda.max_memory_allocated() - base
    dev_ev = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA
              and not getattr(e, "is_user_annotation", False)]
    dev_us = sum(map(_self_device_us, dev_ev))
    top = sorted(dev_ev, key=_self_device_us, reverse=True)[:3]
    c1 = port.kernel_launch_counts()
    launches = sum(c1[k] - c0[k] for k in carry)
    chunks = sum(f[1] for f, _ in rec.fills)
    slab_bytes = sum(int(np.prod(f)) for f, _ in rec.fills)
    cands = sum(c for _, c in rec.fills)
    log(f"{label}: {n} pairs, {cells} cells in {secs:.4f} s = "
        f"{cells / secs / 1e9:.3f} GCUPS, busy share "
        f"{dev_us / 1e6 / secs:.4f}; {len(rec.fills)} fills, {chunks} "
        f"chunks (chunks per fill {[f[1] for f, _ in rec.fills]}, "
        f"{launches / max(chunks, 1):.2f} carry launches per chunk), slab "
        f"bytes {slab_bytes}, {cands} harvested candidates, peak device "
        f"memory {peak} B; top: " + "; ".join(
            f"{e.key[:48]} x{e.count} {_self_device_us(e) / 1e3:.3f} ms"
            for e in top) + f" [{gpu}]")
    if jobs is not None:
        jobs[label] = (fn, secs)
    return out


def phase_long(rng, dev, gpu, jobs, sample):
    """Path long: pairs over LONG_PAIR_CELLS through the entry points, each
    job once (``long_job``).  Launch counts are read by the caller right
    after this returns the check to run; the checks (every pair against
    the scores kernels and the numpy witnesses, a sample against the plain
    versions) run after the counts are read.  Returns that check and the
    carry launches of job 2 (the flags' carry)."""
    import seqalign_tpu_torch as port
    from seqalign_tpu_torch import aligners

    nw = port.NeedlemanWunsch(device="cuda")
    nwf = port.NeedlemanWunsch(mode_scoring("nsg+neg"), device="cuda")
    sw = port.SmithWaterman(device="cuda")
    assert all(a * b > aligners.LONG_PAIR_CELLS for a, b in
               ((LONG_A[0], LONG_B[0]), (GIANT, GIANT)))
    A, B = dna(rng, LONG_NW, *LONG_A), dna(rng, LONG_NW, *LONG_B)
    SA = dna(rng, LONG_SW, *LONG_A)
    SB = [plant(rng, a, b, LONG_SEG, LONG_SUB)
          for a, b in zip(SA, dna(rng, LONG_SW, *LONG_B))]
    ga = dna(rng, 1, GIANT, GIANT)[0]
    # the segment ends past y = 2^31 / (GIANT + 1), so its flats pass 2^31
    gb = plant(rng, ga, dna(rng, 1, GIANT, GIANT)[0], LONG_SEG, LONG_SUB,
               pb=GIANT - LONG_SEG - 1000)
    sbest = sw.best_score_batch(SA, SB)
    gbest = int(sw.best_score(ga, gb))
    mins = [max(1, int(v) - 10) for v in sbest]
    k = 8
    out = {}
    n16 = LONG_NSG

    def hits(s, A_, B_, m):
        return [list(itertools.islice(it, k))
                for it in s.align_batch(A_, B_, m)]

    out["nw"] = long_job(f"long job 1: nw align_batch {LONG_NW} x 20-40kb "
                         f"x 6-10kb", lambda: nw.align_batch(A, B),
                         cells_of(A, B), LONG_NW, gpu, jobs)
    c0 = port.kernel_launch_counts()["nw_fill_dirs_carry"]
    out["nsg"] = long_job(
        f"long job 2: nw[nsg+neg] align_batch {n16} x 20-40kb x 6-10kb",
        lambda: nwf.align_batch(A[:n16], B[:n16]), cells_of(A[:n16],
                                                            B[:n16]),
        n16, gpu)
    flagged = port.kernel_launch_counts()["nw_fill_dirs_carry"] - c0
    out["sw"] = long_job(
        f"long job 3: sw align_batch {LONG_SW} x 20-40kb x 6-10kb, 2 kb "
        f"planted, min_score best - 10, first {k} hits",
        lambda: hits(sw, SA, SB, mins), cells_of(SA, SB), LONG_SW, gpu, jobs)
    h = LONG_HINTLESS
    out["hintless"] = long_job(
        f"long job 4: sw align_batch {h} x 20-40kb x 6-10kb, no hint, first "
        f"{k} hits", lambda: hits(sw, SA[:h], SB[:h], None),
        cells_of(SA[:h], SB[:h]), h, gpu)
    out["nw_long"] = long_job(
        "long job 5a: NeedlemanWunsch.align_long, 1 pair",
        lambda: nw.align_long(A[0], B[0]), len(A[0]) * len(B[0]), 1, gpu)
    out["sw_long"] = long_job(
        "long job 5b: SmithWaterman.align_long, 1 pair, first 8 hits",
        lambda: list(itertools.islice(sw.align_long(SA[0], SB[0],
                                                    min_score=mins[0]), k)),
        len(SA[0]) * len(SB[0]), 1, gpu)
    dev0 = aligners.long_branch_counts()
    out["giant"] = long_job(
        f"long job 6: sw align_batch 1 x {GIANT} x {GIANT}, min_score best "
        f"- 10, first {k} hits", lambda: hits(sw, [ga], [gb], [gbest - 10]),
        GIANT * GIANT, 1, gpu)
    dev1 = aligners.long_branch_counts()
    swr = port.SmithWaterman(device="cuda", ref_mask_compat=True)
    out["ref_mask"] = long_job(
        "long job 7: sw[ref_mask_compat] align_batch 2 x 20-40kb x 6-10kb "
        f"(host branch), first {k} hits",
        lambda: hits(swr, SA[:2], SB[:2], mins[:2]), cells_of(SA[:2],
                                                             SB[:2]), 2, gpu)
    dev2 = aligners.long_branch_counts()

    def check():
        t0 = time.perf_counter()
        eq, loc = eq_table(nw.scoring), eq_table(sw.scoring)
        for key, s, A_, B_ in (("nw", nw, A, B),
                               ("nsg", nwf, A[:n16], B[:n16])):
            want = s.score_batch(A_, B_)
            for i, aln in enumerate(out[key]):
                witness_alignment(eq, s.scoring, A_[i], B_[i], aln,
                                  f"long {key} pair {i}", opt=int(want[i]))
        if out["nw_long"] != out["nw"][0]:
            raise AssertionError("NeedlemanWunsch.align_long disagrees with "
                                 "align_batch")
        for key, A_, B_, best, m in (
                ("sw", SA, SB, sbest, mins),
                ("hintless", SA[:h], SB[:h], sbest[:h], [1] * h),
                ("giant", [ga], [gb], [gbest], [gbest - 10]),
                ("ref_mask", SA[:2], SB[:2], sbest[:2], mins[:2])):
            for i, hs in enumerate(out[key]):
                # under ref_mask_compat the mask is shared by the batch: a
                # later pair's optimum may be masked, or all its candidates
                shared = key == "ref_mask" and i > 0
                if not hs and not shared:
                    raise AssertionError(f"long {key} pair {i}: no hit")
                witness_hits(loc, sw.scoring, A_[i], B_[i], hs, m[i],
                             f"long {key} pair {i}", opt=int(best[i]),
                             spell_only=shared)
        if out["sw_long"] != out["sw"][0] or out["ref_mask"][0] != \
                out["sw"][0]:
            raise AssertionError("align_long or the host branch's first "
                                 "stream disagrees with align_batch")
        if out["hintless"][0][0] != out["sw"][0][0]:
            raise AssertionError("the hint-less stream's first hit differs")
        top = out["giant"][0][0]
        flat = (top.pos_b + top.len_b) * (GIANT + 1) + top.pos_a + top.len_a
        if flat < 2 ** 31 or dev1["device"] != dev0["device"] + 1:
            raise AssertionError(f"giant pair: flat {flat}, branches "
                                 f"{dev0} -> {dev1}")
        if dev2["host"] != dev1["host"] + 2:
            raise AssertionError(f"ref_mask_compat: branches {dev1} -> "
                                 f"{dev2}")
        # a sample against the plain versions: phase 1's equality pairs
        # through the long path, in chunks of about CARRY_CA columns, so
        # that every pair crosses chunk borders
        PA, PB, nw_plain, thr, sw_plain = sample
        saved = aligners.LONG_PAIR_CELLS, aligners.LONG_CHUNK
        aligners.LONG_PAIR_CELLS, aligners.LONG_CHUNK = 1, CARRY_CA
        c0 = port.kernel_launch_counts()
        try:
            got_nw = nw.align_batch(PA, PB)
            got_sw = hits(sw, PA, PB, thr)
        finally:
            aligners.LONG_PAIR_CELLS, aligners.LONG_CHUNK = saved
        c1 = port.kernel_launch_counts()
        if any(c1[k] - c0[k] < 3 for k in ("nw_fill_dirs_carry",
                                           "sw_fill_dirs_carry")):
            raise AssertionError(f"the sample ran fewer than 3 chunks: "
                                 f"{c0} -> {c1}")
        if got_nw != nw_plain or got_sw != sw_plain:
            raise AssertionError("the long path disagrees with the plain "
                                 "versions on phase 1's pairs")
        log(f"path long: every alignment and hit passed its witnesses, the "
            f"giant pair's first hit ends at flat {flat} on the device "
            f"branch, ref_mask_compat took the host branch, the sample "
            f"equals the plain versions ({time.perf_counter() - t0:.1f} s)")

    return check, flagged


def phase_vpu(err, times, bounds):
    """Path vpu: the probe (``python -m seqalign_tpu_torch.tools.exp_vpu``:
    its ``parse`` and ``run``) once per row of ``VPU_ROWS``; it holds the
    kernel to the plain version, times that once and the kernel at 512
    steps, 16 x and 64 x as many, and the line it prints gives T ops/s.
    Fills each row's ``err``, ``times`` and ``bounds`` from that run and
    returns its launches, counted from 0 around it."""
    import seqalign_tpu_torch as port
    from seqalign_tpu_torch.tools import exp_vpu

    launches = {}
    for op, dt, lanes in VPU_ROWS:
        name = vpu_row(op, dt, lanes)
        args = exp_vpu.parse(["--op", op, "--dtype", dt, "--lanes",
                              str(lanes), "--rows", str(VPU_R), "--steps",
                              str(VPU_S)])
        port.reset_kernel_launch_counts()
        r = exp_vpu.run(args)
        launches[name] = port.kernel_launch_counts()
        counted("vpu", launches[name], f"vpu {name}")
        err[name] = r["max_abs_err"]
        times[name] = (r["ms"], r["plain_ms"])
        bounds[name] = vpu_bound(op, dt, lanes)
        log(f"path vpu: {exp_vpu.describe(r)}; max |diff| {err[name]}, "
            f"plain {r['plain_ms']:.1f} ms, bound {bounds[name][0]:.6f} ms "
            f"({bounds[name][1]})")
    return launches


# path cli: the three CLIs on the BASELINE.json workloads
CLI_NW_PAIRS = 4096  # configs[1]: DNA pairs of 1-10 kb, gzip FASTA
CLI_SW_PAIRS = 1024  # configs[2]: protein pairs of 100-1,000 aa, BLOSUM62
CLI_READS = 1024  # configs[3]: reads of 256-512 bp x references of 1-10 kb
CLI_LCS_LEN = 512  # lcs prints every hit: ~25 k lines at 512 bp
CLI_MATRIX = (300, 200)  # the --printmatrices pair
# one pair as the matrix dump fills it (rows ``<kernel>[dump]``: CLI job
# 5's) and one of b past a round of the tiles' lanes (rows ``[wide]``: its
# strips' edge through the round row in scratch)
GAB_PAIRS = {"dump": CLI_MATRIX, "wide": (3000, 2500)}
CLI_SLICE = 32  # pairs of each job run on the card and under the host route
CLI_SHARDS = 8  # host processes for the slice of 1-10 kb NW pairs
CLI_SAMPLE = 64  # alignments of a job checked by spelling and rescoring
CLI_KB = (1000, 10000)  # the 1-10 kb sides of jobs 1 and 3
CLI_JOB2_ARGS = ["--scoring", "BLOSUM62", "--minscore", "100", "--maxhits",
                 "8"]
CLI_JOB3_ARGS = ["--freestartgap", "--freeendgap", "--wildcard", "N", "0",
                 "--case_sensitive", "--printscores"]


def write_fasta(path, A, B):
    """Pairs as alternating FASTA records, gzip when ``path`` ends in
    .gz."""
    import gzip

    data = "".join(f">a{i}\n{a}\n>b{i}\n{b}\n"
                   for i, (a, b) in enumerate(zip(A, B))).encode()
    opener = (lambda: gzip.open(path, "wb", compresslevel=1)) \
        if path.endswith(".gz") else (lambda: open(path, "wb"))
    with opener() as fh:
        fh.write(data)
    return path


def run_cli(tool, args, out_path, env=None):
    """One CLI ``main`` in-process, stdout to ``out_path``, stderr kept,
    with ``env`` set around it.  Returns (exit code, stderr)."""
    import contextlib
    import io

    from seqalign_tpu_torch.cli import lcs, needleman_wunsch, smith_waterman

    main = {"nw": needleman_wunsch.main, "sw": smith_waterman.main,
            "lcs": lcs.main}[tool]
    env = env or {}
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    err = io.StringIO()
    try:
        with open(out_path, "w") as fh, contextlib.redirect_stdout(fh), \
                contextlib.redirect_stderr(err):
            try:
                rc = main([tool] + args) or 0
            except SystemExit as e:
                rc = e.code or 0
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    return rc, err.getvalue()


def cli_job(label, tool, args, out_path, cells, n, need, gpu, env=None):
    """One job of path cli, once, under ``torch.profiler`` and the
    plain-version guard: launch counts zeroed before and read after (each
    kernel of ``need`` must have run), wall (profiler on), pairs/s, GCUPS,
    busy share (device self time / wall), output bytes, top device items.
    Returns the output text."""
    import seqalign_tpu_torch as port
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    port.reset_kernel_launch_counts()
    with PlainGuard(), torch_profile(
            activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rc, err = run_cli(tool, args, out_path, env)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
    counts = port.kernel_launch_counts()
    if rc != 0 or err:
        raise AssertionError(f"cli {label}: exit {rc}, stderr {err[:500]!r}")
    missing = [k for k in need if launched(counts, k) <= 0]
    if missing:
        raise AssertionError(f"cli {label}: {missing} not launched: {counts}")
    dev_ev = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA
              and not getattr(e, "is_user_annotation", False)]
    dev_us = sum(map(_self_device_us, dev_ev))
    top = sorted(dev_ev, key=_self_device_us, reverse=True)[:3]
    size = os.path.getsize(out_path)
    log(f"cli {label}: {n} pairs, {cells} cells in {secs:.4f} s = "
        f"{n / secs:.1f} pairs/s, {cells / secs / 1e9:.3f} GCUPS, busy share "
        f"{dev_us / 1e6 / secs:.4f}, {size} output bytes; launches "
        f"{ {k: v for k, v in counts.items() if v} }; top: " + "; ".join(
            f"{e.key[:48]} x{e.count} {_self_device_us(e) / 1e3:.3f} ms"
            for e in top) + f" [{gpu}]")
    with open(out_path) as fh:
        return fh.read(), counts


def same_on_host(label, tool, args, card_text, work, env_host=None):
    """The CLI under ``SEQALIGN_FORCE=host`` must print ``card_text`` byte
    for byte."""
    out = os.path.join(work, f"{tool}_host.txt")
    rc, err = run_cli(tool, args, out, dict(SEQALIGN_FORCE="host",
                                            **(env_host or {})))
    with open(out) as fh:
        host = fh.read()
    if rc != 0 or err or host != card_text:
        raise AssertionError(f"cli {label}: the host route's stdout differs "
                             f"(exit {rc}, {len(host)} vs {len(card_text)} "
                             f"bytes)")


def card_slice(label, tool, args, A, B, work, name):
    """The first CLI_SLICE pairs of a job through the CLI on the card;
    returns the slice's file and stdout."""
    path = write_fasta(os.path.join(work, name), A[:CLI_SLICE],
                       B[:CLI_SLICE])
    out = os.path.join(work, f"{tool}_slice.txt")
    rc, err = run_cli(tool, args + ["--file", path], out)
    if rc != 0 or err:
        raise AssertionError(f"cli {label} slice: exit {rc}, {err[:300]!r}")
    with open(out) as fh:
        return path, fh.read()


def host_shards(tool, args, A, B, work):
    """The NW CLI under the host route on the first CLI_SLICE pairs, in
    CLI_SHARDS processes of consecutive pairs (NW prints each pair on its
    own, so the shards' stdout joined is the slice's); each process aligns
    on the CPU (``SEQALIGN_DEVICE=cpu``)."""
    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, SEQALIGN_FORCE="host", SEQALIGN_DEVICE="cpu")
    step = -(-CLI_SLICE // CLI_SHARDS)
    procs = []
    for k in range(0, CLI_SLICE, step):
        end = min(k + step, CLI_SLICE)
        path = write_fasta(os.path.join(work, f"shard{k}.fa"), A[k:end],
                           B[k:end])
        procs.append(subprocess.Popen(
            [sys.executable, "-m", f"seqalign_tpu_torch.cli.{tool}", *args,
             "--file", path], cwd=root, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True))
    outs = []
    for p in procs:
        so, se = p.communicate(timeout=600)
        if p.returncode != 0 or se:
            raise AssertionError(f"host shard: exit {p.returncode}, {se}")
        outs.append(so)
    return "".join(outs)


def parse_nw(text):
    """NW --printscores stdout: [(result_a, result_b, score)]."""
    out = []
    for blk in text.split("\n\n")[:-1]:
        ra, rb, sc = blk.split("\n")
        out.append(types.SimpleNamespace(result_a=ra, result_b=rb,
                                         score=int(sc.split(": ")[1])))
    return out


def _part(line):
    body, _, tail = line[2:].rpartition("  [pos: ")
    pos, ln = tail.rstrip("]").split("; len: ")
    return body, int(pos), int(ln)


def parse_sw(text):
    """SW stdout: each alignment's hits, in order."""
    out = []
    for blk in text.split("== Alignment ")[1:]:
        lines = blk.split("\n")
        hits = []
        for i, ln in enumerate(lines):
            if ln.startswith("hit "):
                ra, pa, la = _part(lines[i + 1])
                rb, pb, lb = _part(lines[i + 2])
                hits.append(types.SimpleNamespace(
                    score=int(ln.rsplit(" ", 1)[1]), result_a=ra, pos_a=pa,
                    len_a=la, result_b=rb, pos_b=pb, len_b=lb))
        out.append(hits)
    return out


def parse_matrices(text):
    """The three matrices of a --printmatrices dump, int64 arrays, and the
    text after the dump."""
    mats, rows, rest = [], None, text
    lines = text.split("\n")
    for i, ln in enumerate(lines):
        if ln.endswith("_scores:"):
            rows = []
            mats.append(rows)
        elif ln.startswith("match: "):
            rest = "\n".join(lines[i + 2:])
            break
        elif rows is not None and ln:
            rows.append([int(v) for v in ln.split("\t")[1:]])
    return [np.array(m, np.int64) for m in mats], rest


def reads_inputs(rng, n):
    """CLI job 3 (BASELINE.json configs[3]): n references of 1-10 kb DNA
    and a read of each, 256-512 bp from a random place, 3% of its letters
    redrawn and 1% set to the wildcard N."""
    refs = dna(rng, n, *CLI_KB)
    reads = []
    for r in refs:
        k = int(rng.integers(READ_LEN[0], READ_LEN[1] + 1))
        p = int(rng.integers(0, len(r) - k + 1))
        seg = np.frombuffer(r[p:p + k].encode(), np.uint8).copy()
        hit = rng.random(k) < 0.03
        seg[hit] = DNA[rng.integers(0, len(DNA), int(hit.sum()))]
        seg[rng.random(k) < 0.01] = ord("N")
        reads.append(seg.tobytes().decode())
    return refs, reads


def phase_cli(rng, dev, gpu):
    """Path cli: the CLIs' ``main`` in-process on inputs numpy writes from
    the seed into a temporary directory, stdout to a file (see the module
    docstring); each job's launches counted from 0 around it.  Returns the
    jobs' launch counts summed."""
    import tempfile

    import seqalign_tpu_torch as port

    total = dict.fromkeys(port.kernel_launch_counts(), 0)

    def add(counts):
        for k, v in counts.items():
            total[k] += v

    from seqalign_tpu_torch.io import native

    # set-up: the native FASTA reader is built before the first job
    log("cli: native sequence reader " + (
        "built" if native.available() else "unavailable: the Python reader"))
    with tempfile.TemporaryDirectory(prefix="cli-") as work:
        nw_sc = port.presets.scoring_system_default()
        eq = eq_table(nw_sc)
        # job 1: BASELINE.json configs[1]
        A = dna(rng, CLI_NW_PAIRS, *CLI_KB)
        B = dna(rng, CLI_NW_PAIRS, *CLI_KB)
        fa = write_fasta(os.path.join(work, "pairs.fa.gz"), A, B)
        label = f"job 1: needleman_wunsch --file pairs.fa.gz, {len(A)} pairs"
        text, c = cli_job(label, "nw", ["--printscores", "--file", fa],
                          os.path.join(work, "nw.txt"), cells_of(A, B),
                          len(A), ("nw_fill_dirs", "nw_walk"), gpu)
        add(c)
        alns = parse_nw(text)
        if len(alns) != len(A):
            raise AssertionError(f"cli {label}: {len(alns)} alignments")
        want = port.NeedlemanWunsch(device=dev).score_batch(A, B)
        if [a.score for a in alns] != want.tolist():
            raise AssertionError(f"cli {label}: scores disagree with "
                                 f"score_batch")
        for k, i in enumerate(rng.choice(len(A), min(CLI_SAMPLE, len(A)),
                                         replace=False)):
            witness_alignment(eq, nw_sc, A[i], B[i], alns[i],
                              f"cli job 1 pair {i}",
                              opt=None if k < 2 else int(want[i]))
        _, card = card_slice("job 1", "nw", ["--printscores"], A, B, work,
                             "slice1.fa.gz")
        host = host_shards("needleman_wunsch", ["--printscores"], A, B, work)
        if host != card or not text.startswith(card):
            raise AssertionError(f"cli job 1: the slice's stdout differs on "
                                 f"the host route ({host == card}) or from "
                                 f"the job's")
        log(f"cli job 1: scores equal score_batch, "
            f"{min(CLI_SAMPLE, len(A))} alignments spell and rescore, "
            f"{CLI_SLICE}-pair slice byte-identical on the host route "
            f"({len(card)} bytes)")
        del A, B, text, alns

        # job 2: BASELINE.json configs[2]
        swp = port.presets.scoring_system_BLOSUM62()
        A, B, _ = job2_inputs(rng, CLI_SW_PAIRS)
        fa = write_fasta(os.path.join(work, "prot.fa"), A, B)
        args = CLI_JOB2_ARGS
        label = f"job 2: smith_waterman {' '.join(args)}, {len(A)} pairs"
        text, c = cli_job(label, "sw", args + ["--file", fa],
                          os.path.join(work, "sw.txt"), cells_of(A, B),
                          len(A), ("sw_fill_dirs", "sw_hits", "sw_walk"),
                          gpu)
        add(c)
        hits = parse_sw(text)
        if len(hits) != len(A) or not sum(map(len, hits)):
            raise AssertionError(f"cli {label}: {len(hits)} alignments")
        table = blosum62_table(swp)
        best = port.SmithWaterman(swp, device=dev).best_score_batch(A, B)
        for k, i in enumerate(rng.choice(len(A), min(CLI_SAMPLE, len(A)),
                                         replace=False)):
            witness_hits(table, swp, A[i], B[i], hits[i], 100,
                         f"cli job 2 pair {i}",
                         opt=None if k < 8 else int(best[i]))
        path, card = card_slice("job 2", "sw", args, A, B, work, "s2.fa")
        same_on_host("job 2", "sw", args + ["--file", path], card, work)
        if not text.startswith(card):
            raise AssertionError("cli job 2: the slice differs from the job")
        log(f"cli job 2: {sum(map(len, hits))} hits, "
            f"{min(CLI_SAMPLE, len(A))} pairs' hits spell and rescore, the "
            f"first at the optimum (8 by the numpy Gotoh); "
            f"{CLI_SLICE}-pair slice byte-identical on the host route")

        # job 3: BASELINE.json configs[3], reads against references
        args = CLI_JOB3_ARGS
        # the reference CLI's --case_sensitive does not reach the scoring
        # (alignment_cmdline.c, kept bug for bug): letters fold, and so
        # does the wildcard, which scores 0 against anything
        sc3 = port.ScoringConfig(1, -2, -4, -1, no_start_gap_penalty=True,
                                 no_end_gap_penalty=True)
        t3 = eq_table(sc3)
        for w in b"Nn":
            t3[w, :] = t3[:, w] = 0
        refs, reads = reads_inputs(rng, CLI_READS)
        fa = write_fasta(os.path.join(work, "reads.fa"), refs, reads)
        label = f"job 3: needleman_wunsch {' '.join(args)}, {len(refs)} pairs"
        text, c = cli_job(label, "nw", args + ["--file", fa],
                          os.path.join(work, "reads.txt"),
                          cells_of(refs, reads), len(refs),
                          ("nw_fill_dirs", "nw_walk"), gpu)
        add(c)
        alns = parse_nw(text)
        if len(alns) != len(refs) or \
                min(a.score for a in alns) < READ_LEN[0] // 2:
            raise AssertionError(f"cli {label}: a read did not find its "
                                 f"place")
        for i in rng.choice(len(refs), 16, replace=False):
            witness_alignment(t3, sc3, refs[i], reads[i], alns[i],
                              f"cli job 3 pair {i}")
        path, card = card_slice("job 3", "nw", args, refs, reads, work,
                                "s3.fa")
        same_on_host("job 3", "nw", args + ["--file", path], card, work)
        if not text.startswith(card):
            raise AssertionError("cli job 3: the slice differs from the job")
        log(f"cli job 3: 16 alignments at the numpy optimum, "
            f"{CLI_SLICE}-pair slice byte-identical on the host route")

        # job 4: lcs on one sequence, its every hit
        seq = seqs(rng, 1, CLI_LCS_LEN, CLI_LCS_LEN,
                   np.frombuffer(b"acgt", np.uint8))[0]
        label = f"job 4: lcs on {CLI_LCS_LEN} bp"
        env = {"SEQALIGN_FORCE": "device"}
        text, c = cli_job(label, "lcs", [seq], os.path.join(work, "lcs.txt"),
                          len(seq) ** 2, 1, ("sw_fill_dirs", "sw_hits",
                                             "sw_walk"), gpu, env)
        add(c)
        lines = text.splitlines()
        for ln in lines:
            sub, _, at = ln.rpartition(" [")
            pa, pb = map(int, at.rstrip("]").split(","))
            if not (pa < pb and seq[pa:pa + len(sub)] == sub
                    == seq[pb:pb + len(sub)]):
                raise AssertionError(f"cli {label}: {ln!r} is no repeat")
        if [len(ln.rpartition(" [")[0]) for ln in lines] != sorted(
                (len(ln.rpartition(" [")[0]) for ln in lines), reverse=True):
            raise AssertionError(f"cli {label}: not longest first")
        same_on_host("job 4", "lcs", [seq], text, work)
        log(f"cli job 4: {len(lines)} repeats, each spelled at both "
            f"places, longest first; byte-identical on the host route")

        # job 5: the matrix dump, NW and SW, one pair
        a = dna(rng, 1, CLI_MATRIX[0], CLI_MATRIX[0])[0]
        b = plant(rng, a, dna(rng, 1, CLI_MATRIX[1], CLI_MATRIX[1])[0], 100,
                  0.05)
        sw_sc = port.ScoringConfig(2, -2, -2, -1)
        for tool, need, sc in (("nw", ("nw_fill_gab", "nw_walk"), nw_sc),
                               ("sw", ("sw_fill_gab", "sw_hits", "sw_walk"),
                                sw_sc)):
            args = ["--printmatrices"] + (["--printscores"] if tool == "nw"
                                          else []) + [a, b]
            label = f"job 5: {tool} --printmatrices, {len(a)} x {len(b)}"
            text, c = cli_job(label, tool, args,
                              os.path.join(work, f"m_{tool}.txt"),
                              len(a) * len(b), 1, need, gpu, env)
            add(c)
            tab = eq_table(sc)
            if tool == "nw":
                (M, Ga, Gb), rest = parse_matrices(text)
                aln = parse_nw(rest)[0]
                witness_alignment(tab, sc, a, b, aln, f"cli {label}")
                top = max(M[-1, -1], Ga[-1, -1], Gb[-1, -1])
            else:
                (M, Ga, Gb), _ = parse_matrices(text.split("\n", 1)[1])
                hs = parse_sw(text)[0]
                witness_hits(tab, sc, a, b, hs, 1, f"cli {label}")
                aln = hs[0]
                top = M.max()
            if M.shape != (len(b) + 1, len(a) + 1) or top != aln.score:
                raise AssertionError(f"cli {label}: dump {M.shape}, its top "
                                     f"{top}, score {aln.score}")
            same_on_host(f"job 5 {tool}", tool, args, text, work)
        log("cli job 5: the dumps' corner / best equal the scores, the "
            "alignments the numpy optimum; byte-identical on the host route")

    # the module entry point, cold, on the card
    t0 = time.perf_counter()
    r = subprocess.run(
        [sys.executable, "-m", "seqalign_tpu_torch.cli.needleman_wunsch",
         "--printscores", "CAGACGT", "CGATA"],
        cwd=os.path.dirname(os.path.abspath(__file__)),
        env=dict(os.environ, SEQALIGN_FORCE="device"), capture_output=True,
        text=True, timeout=300)
    if r.returncode or r.stdout != "C-AGACGT\nCGATA---\nscore: -11\n\n":
        raise AssertionError(f"python -m ...needleman_wunsch: exit "
                             f"{r.returncode}, {r.stdout!r} {r.stderr!r}")
    log(f"cli: python -m seqalign_tpu_torch.cli.needleman_wunsch "
        f"--printscores CAGACGT CGATA -> score -11 on the card in "
        f"{time.perf_counter() - t0:.2f} s (cold start)")
    return total


def consume_per_pair(sw, A, B, mins, k):
    """``align_batch`` wall seconds, then each pair's seconds for its first
    ``k`` hits, and the pairs' candidate counts."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    its = sw.align_batch(A, B, mins)
    t_batch = time.perf_counter() - t0
    secs = []
    for it in its:
        t0 = time.perf_counter()
        list(itertools.islice(it, k))
        secs.append(time.perf_counter() - t0)
    return t_batch, np.array(secs), np.array([it.n_candidates for it in its])


AB_BINS = (-1, 256, 1024, 4096, 16384, 65536, 262144, 1 << 62)


def walk_ab(sw, swp, rng, gpu):
    """The first AB_PAIRS pairs of each SW align job under each walk
    branch, host, device, device, host: the whole job's wall seconds, and
    each pair's consume seconds summed by its candidate count."""
    from seqalign_tpu_torch import aligners

    m = AB_PAIRS
    entries = [(sw, SW_JOB1, *job1_inputs(rng, m)),
               (sw, SW_JOB3, *job3_inputs(sw, rng, m)),
               (swp, SW_JOB2, *job2_inputs(rng, m))]
    saved = aligners._SW_DEVWALK_CANDS
    try:
        for s, (name, _, k), A, B, mins in entries:
            batch = {"host": [], "device": []}
            pair = {"host": 0.0, "device": 0.0}
            for branch in ("host", "device", "device", "host"):
                aligners._SW_DEVWALK_CANDS = -1 if branch == "host" else saved
                with PlainGuard():
                    tb, secs, c = consume_per_pair(s, A, B, mins, k)
                batch[branch].append(tb + secs.sum())
                pair[branch] = pair[branch] + secs / 2
            log(f"walk A/B {name}, {m} pairs, first {k} hits: candidates "
                f"per pair median {int(np.median(c))} max {c.max()}; job "
                f"wall host " + ", ".join(f"{t:.4f}" for t in batch["host"])
                + " s; device " + ", ".join(f"{t:.4f}" for t in
                                            batch["device"]) + f" s [{gpu}]")
            for lo, hi in zip(AB_BINS, AB_BINS[1:]):
                sel = (c > lo) & (c <= hi)
                if sel.any():
                    log(f"walk A/B {name}: {int(sel.sum())} pairs of {lo + 1}"
                        f"-{hi if hi < AB_BINS[-1] else 'inf'} candidates: "
                        f"consume host {pair['host'][sel].sum():.4f} s, "
                        f"device {pair['device'][sel].sum():.4f} s")
    finally:
        aligners._SW_DEVWALK_CANDS = saved


def fills_only(scs, rng, dev, gpu):
    """The fills' times through the wrappers' API only, so that ``--tree``
    times an older tree's package with this script: at phase 1's timing
    shape, 256 pairs of 512 bp, the four default fills, NW's and SW's
    codes fill under BLOSUM62 on protein, ``sw_hits`` on the hint-less SW
    candidates (k = 16, phase 1's row), ``sw_fill_dirs`` under the LCS
    flags and ``nw_scores``, ``nw_fill_dirs`` under free start and end
    gaps (the flags' instantiations) and ``nw_fill_gab`` (``GAB``);
    ``nw_fill_dirs_carry`` on one chunk of 2,048 columns of 4 pairs of
    5,000-6,144 x 1,500-2,048 (phase 1's carry row), the same under free
    start and end gaps, and, on a tree with
    ``kernels.carry_warps``, that chunk, one of 2,048 columns of 16 of path
    long's pairs and one of 16,384 of its 48 kb x 48 kb pair at 1, 2, 4, 8
    and 16 warps a block (the measurement behind the rule); and the four
    fills as
    one launch across widths: NW on ``RAGGED_PAIRS`` pairs of 1-10 kb
    (CLI job 1's mix), SW on the first sub-batch of SW job 3's.  Each row
    five means of 10 launches (3 of 3 across widths), after a warm-up."""
    from seqalign_tpu_torch import aligners, kernel_params
    from seqalign_tpu_torch.ops import kernels
    from seqalign_tpu_torch.ops.dp import boundary_column
    from seqalign_tpu_torch.ops.pack import m16_safe, pack_batch

    rows = {}  # name -> (shape, fn, reps)
    for key in ("nw", "sw", "nw[table]", "sw[table]", "sw[nga+ngb+nmm]",
                "nw[nsg+neg]"):
        sc = (scs["table"] if key.endswith("[table]") else
              mode_scoring("nga+ngb+nmm", sw=True) if key.endswith("nmm]")
              else mode_scoring("nsg+neg") if key.endswith("neg]")
              else scs[key])
        alpha = AMINO if key.endswith("[table]") else DNA
        (ac, bc, na, nb), bp, (na_h, nb_h) = packed(
            sc, kernel_params(sc, dev), seqs(rng, 256, 512, 512, alpha),
            seqs(rng, 256, 512, 512, alpha), dev)
        f = (ac, bc, na, nb, bp)
        if key == "nw":
            rows["nw_scores"] = lambda f=f: kernels.nw_scores(*f)
            rows["nw_fill_dirs"] = lambda f=f: kernels.nw_fill_dirs(*f)
            rows["nw_fill_gab"] = lambda f=f: kernels.nw_fill_gab(*f)
        elif key == "sw":
            rows["sw_scores"] = lambda f=f: kernels.sw_scores(*f)
            rows["sw_fill_dirs"] = lambda f=f: kernels.sw_fill_dirs(*f, True)
            d, m = kernels.sw_fill_dirs(*f, True)
            args = hit_args(d, ac, bc, na, nb, m, na_h, nb_h, 1, bp, 16)
            del m
            rows["sw_hits"] = lambda args=args: kernels.sw_hits(*args)
        elif key.startswith("nw"):
            rows["nw_fill_dirs" + key[2:]] = (
                lambda f=f: kernels.nw_fill_dirs(*f))
            if key.endswith("neg]"):
                rows["nw_scores" + key[2:]] = (
                    lambda f=f: kernels.nw_scores(*f))
        else:
            rows["sw_fill_dirs" + key[2:]] = (
                lambda f=f: kernels.sw_fill_dirs(*f, True))
    shape = {k: "B=256 L=512" for k in rows}
    # one chunk of the long pairs' carry fill
    crng = np.random.default_rng(SEED + 7)
    sc = scs["nw"]
    A, B = seqs(crng, 4, 5000, 6144), seqs(crng, 4, 1500, 2048)
    ac, bc, na, nb, bp = pack_batch(sc, kernel_params(sc, dev), A, B, 6144,
                                    2048)
    t = [torch.from_numpy(v).to(dev) for v in (ac, bc, na, nb)]
    bin = boundary_column(bp, 4, 2048, is_sw=False)
    bout = torch.zeros_like(bin)
    slab = torch.zeros((4, CARRY_CA + 2047, 2049), dtype=torch.uint8,
                       device=dev)
    corner = torch.zeros((4, 3), dtype=torch.int32, device=dev)
    rows["nw_fill_dirs[carry]"] = lambda: kernels.nw_fill_dirs_carry(
        *t, bp, CARRY_CA, bin, bout, slab, corner)
    shape["nw_fill_dirs[carry]"] = "4 pairs, one chunk of 2048"
    # the same chunk under free start and end gaps (the flags' carry)
    bpf = kernel_params(mode_scoring("nsg+neg"), dev)  # the same codes
    binf = boundary_column(bpf, 4, 2048, is_sw=False)
    rows["nw_fill_dirs[carry,nsg+neg]"] = lambda: kernels.nw_fill_dirs_carry(
        *t, bpf, CARRY_CA, binf, bout, slab, corner)
    shape["nw_fill_dirs[carry,nsg+neg]"] = "4 pairs, one chunk of 2048"
    reps = {}
    if hasattr(kernels, "carry_warps"):
        # the tile carry's warps a block (csrc/tile_carry.cuh): the 4 pairs
        # above, 16 of path long's pairs (6-10 kb of b) and its 48 kb x
        # 48 kb pair, one chunk each, at every W
        def at_warps(w, fn):
            def run():
                rule = kernels.carry_warps
                kernels.carry_warps = lambda *a: w
                try:
                    return fn()
                finally:
                    kernels.carry_warps = rule
            return run

        def carry_case(n, ra, rb, lb, ca):
            A, B = seqs(crng, n, *ra), seqs(crng, n, *rb)
            ac, bc, na, nb, bp = pack_batch(sc, kernel_params(sc, dev), A,
                                            B, ra[1], lb)
            t = [torch.from_numpy(v).to(dev) for v in (ac, bc, na, nb)]
            bin = boundary_column(bp, n, lb, is_sw=False)
            bout = torch.zeros_like(bin)
            slab = torch.empty((n, ca + lb - 1, lb + 1), dtype=torch.uint8,
                               device=dev)
            corner = torch.zeros((n, 3), dtype=torch.int32, device=dev)
            return lambda: kernels.nw_fill_dirs_carry(
                *t, bp, 0, bin, bout, slab, corner)

        cases = {"4 pairs, one chunk of 2048": rows["nw_fill_dirs[carry]"],
                 "16 pairs of 20-40 kb x 6-10 kb, one chunk of 2048":
                 carry_case(16, LONG_A, LONG_B, LONG_B[1], CARRY_CA),
                 "1 pair of 48 kb x 48 kb, one chunk of 16384":
                 carry_case(1, (GIANT, GIANT), (GIANT, GIANT), GIANT,
                            aligners.LONG_CHUNK)}
        for label, fn in cases.items():
            for w in (1, 2, 4, 8, 16):
                name = f"nw_fill_dirs[carry] W={w}, {label}"
                rows[name] = at_warps(w, fn)
                shape[name] = label
                reps[name] = 2 if label.startswith("1 pair") else 10
    # the launches across widths
    rrng = np.random.default_rng(SEED + 5)
    A, B = dna(rrng, RAGGED_PAIRS, *CLI_KB), dna(rrng, RAGGED_PAIRS, *CLI_KB)
    ac, bc, na_h, nb_h, bp = pack_batch(scs["nw"], kernel_params(
        scs["nw"], dev), A, B, max(map(len, A)), max(map(len, B)))
    tn = [torch.from_numpy(v).to(dev) for v in (ac, bc, na_h, nb_h)]
    sn = kernels.fill_schedule(na_h, nb_h, dev, planes=True)
    rows["nw_scores[ragged]"] = lambda: kernels.nw_scores(*tn, bp, sn)
    rows["nw_fill_dirs[ragged]"] = lambda: kernels.nw_fill_dirs(*tn, bp, sn)
    srng = np.random.default_rng(SEED + 3)
    sc = scs["sw"]
    A, B = planted(srng, DNA, SW_JOB3[1], 1000, 10000, (0.3, 0.5), 0.03)
    mbytes = 2 if m16_safe(sc, max(map(len, A)), max(map(len, B))) else 4
    subs = aligners._plane_subbatches(
        range(len(A)), aligners._align_budget(dev),
        lambda i: aligners._sw_pair_bytes(len(A[i]), len(B[i]), mbytes,
                                          False))
    A, B = [A[i] for i in subs[0]], [B[i] for i in subs[0]]
    ac, bc, na_h, nb_h, bps = pack_batch(sc, kernel_params(sc, dev), A, B,
                                         max(map(len, A)), max(map(len, B)))
    ts = [torch.from_numpy(v).to(dev) for v in (ac, bc, na_h, nb_h)]
    ss = kernels.fill_schedule(na_h, nb_h, dev, planes=True)
    m16 = m16_safe(sc, int(na_h.max()), int(nb_h.max()))
    rows["sw_scores[ragged]"] = lambda: kernels.sw_scores(*ts, bps, ss)
    rows["sw_fill_dirs[ragged]"] = lambda: kernels.sw_fill_dirs(*ts, bps,
                                                                m16, ss)
    shape.update({"nw_scores[ragged]": f"{RAGGED_PAIRS} pairs of 1-10 kb",
                  "nw_fill_dirs[ragged]": f"{RAGGED_PAIRS} pairs of 1-10 kb",
                  "sw_scores[ragged]": f"SW job 3's {len(A)} pairs",
                  "sw_fill_dirs[ragged]": f"SW job 3's {len(A)} pairs"})

    def time_rows(names):
        for name in names:
            n = reps.get(name, 3 if "[ragged]" in name else 10)
            ms = [cuda_ms(rows[name], n) for _ in range(5 if n == 10 else 3)]
            log(f"fills: {name} at {shape[name]}: " +
                ", ".join(f"{v:.4f}" for v in ms) + f" ms [{gpu}]")

    time_rows(rows)


def gab_only(scs, dev, gpu):
    """The matrix dump's fills through the wrappers' API and the entry
    points only, so that ``--tree`` times an older tree's package with this
    script: ``nw_fill_gab`` and ``sw_fill_gab`` at phase 1's 256 pairs of
    512 bp and on one pair of each of ``GAB_PAIRS`` at its own widths (as
    ``align_with_matrices`` packs it; the dump's pair also under free start
    and end gaps, row ``[dump,nsg+neg]``), each row five means of 10 launches
    after a warm-up; then CLI job 5, ``needleman_wunsch --printmatrices
    --printscores`` and ``smith_waterman --printmatrices`` on one
    ``CLI_MATRIX`` pair in-process on the card (``SEQALIGN_FORCE=device``,
    as path cli runs it), stdout to a file, one warm-up and five walls
    each, with the fill's launch by CUDA events."""
    import tempfile

    from seqalign_tpu_torch import kernel_params
    from seqalign_tpu_torch.ops import kernels
    from seqalign_tpu_torch.ops.pack import pack_batch

    rng = np.random.default_rng(SEED + 14)
    rows, shape = {}, {}
    for fam, fill in (("nw", kernels.nw_fill_gab),
                      ("sw", kernels.sw_fill_gab)):
        sc = scs[fam]
        (ac, bc, na, nb), bp, _ = packed(
            sc, kernel_params(sc, dev), seqs(rng, 256, 512, 512),
            seqs(rng, 256, 512, 512), dev)
        rows[f"{fam}_fill_gab"] = (
            lambda f=(ac, bc, na, nb, bp), fill=fill: fill(*f))
        shape[f"{fam}_fill_gab"] = "B=256 L=512"
        # the pairs of GAB_PAIRS, and the dump's pair under free start and
        # end gaps (the flags' instantiations)
        pairs = [(k, v, sc) for k, v in GAB_PAIRS.items()] + [
            ("dump,nsg+neg", CLI_MATRIX, mode_scoring("nsg+neg", fam == "sw"))]
        for key, (la, lb), s_ in pairs:
            ac, bc, na, nb, bp = pack_batch(s_, kernel_params(s_, dev),
                                            dna(rng, 1, la, la),
                                            dna(rng, 1, lb, lb), la, lb)
            f = [torch.from_numpy(v).to(dev) for v in (ac, bc, na, nb)]
            rows[f"{fam}_fill_gab[{key}]"] = (
                lambda f=(*f, bp), fill=fill: fill(*f))
            shape[f"{fam}_fill_gab[{key}]"] = f"one pair of {la} x {lb}"
    for name, fn in rows.items():
        ms = [cuda_ms(fn, 10) for _ in range(5)]
        log(f"gab: {name} at {shape[name]}: " +
            ", ".join(f"{v:.4f}" for v in ms) + f" ms [{gpu}]")
    a = dna(rng, 1, CLI_MATRIX[0], CLI_MATRIX[0])[0]
    b = plant(rng, a, dna(rng, 1, CLI_MATRIX[1], CLI_MATRIX[1])[0], 100,
              0.05)
    with tempfile.TemporaryDirectory(prefix="gab-") as work:
        for tool, fill in (("nw", "nw_fill_gab"), ("sw", "sw_fill_gab")):
            args = ["--printmatrices"] + (["--printscores"] if tool == "nw"
                                          else []) + [a, b]
            out = os.path.join(work, f"m_{tool}.txt")
            walls, fills = [], []
            for i in range(6):  # a warm-up, then five
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                (rc, err), ms = call_events(
                    lambda: run_cli(tool, args, out,
                                    {"SEQALIGN_FORCE": "device"}),
                    (kernels, fill))
                walls.append(time.perf_counter() - t0)
                fills.append(sum(ms[fill]))
                if rc != 0 or err or len(ms[fill]) != 1:
                    raise AssertionError(f"gab: cli job 5 {tool}: exit {rc}, "
                                         f"{len(ms[fill])} fills, {err!r}")
            log(f"gab: cli job 5 {tool} --printmatrices, {len(a)} x "
                f"{len(b)}: walls " + ", ".join(f"{v:.4f}" for v in walls[1:])
                + " s; its fill " + ", ".join(f"{v:.4f}" for v in fills[1:])
                + f" ms; {os.path.getsize(out)} output bytes [{gpu}]")


def walks_only(scs, dev, gpu):
    """The walks' times through the wrappers' API only, so that ``--tree``
    times an older tree's package with this script: each walk row of
    phase 1 at its shape, on inputs the kernels fill from generators of
    their own: ``nw_walk``, ``sw_walk`` and ``sw_walk[table]`` on 256
    pairs of 512 (SW from the candidates near each pair's best, 16 a
    pair), ``sw_walk[neg]`` and ``sw_walk[lcs]`` on the hits ``sw_hits``
    finds hint-less (k = 16), ``nw_walk[chunked]`` and ``sw_walk[chunked]``
    over the slabs of 4 pairs of 5,000-6,144 x 1,500-2,048 in chunks of
    ``CARRY_CA`` (SW on its hits near the best), ``nw_walk[ragged]`` over
    the planes of ``RAGGED_PAIRS`` pairs of 1-10 kb (CLI job 1's mix) and
    ``sw_walk[ragged]`` on the hits of SW job 3's first sub-batch.  Each
    row five means of 10 launches (three of 3 over slabs and planes) after
    a warm-up, with the longest walk's steps and its ns a step."""
    import seqalign_tpu_torch as port
    from seqalign_tpu_torch import aligners, kernel_params
    from seqalign_tpu_torch.ops import kernels
    from seqalign_tpu_torch.ops.dp import (merge_candidates,
                                           sw_extract_candidates,
                                           sw_sorted_candidates)
    from seqalign_tpu_torch.ops.pack import m16_safe, pack_batch

    def hit_starts(hits, na, k):
        hit_flat, hit_score, nhits = hits
        keep = torch.arange(k, device=dev)[None, :] < nhits[:, None]
        jw, slot = keep.nonzero(as_tuple=True)
        w = na[jw].long() + 1
        fl = hit_flat[jw, slot].long()
        return [v.to(torch.int32).contiguous()
                for v in (jw, fl % w, fl // w, hit_score[jw, slot])]

    rows = {}  # name -> (shape, fn, launches a mean)
    rng = np.random.default_rng(SEED + 21)
    for key, alpha in (("nw", DNA), ("sw", DNA), ("table", AMINO)):
        sc = scs[key]
        (ac, bc, na, nb), bp, (na_h, nb_h) = packed(
            sc, kernel_params(sc, dev), seqs(rng, 256, 512, 512, alpha),
            seqs(rng, 256, 512, 512, alpha), dev)
        if key == "nw":
            f = (*kernels.nw_fill_dirs(ac, bc, na, nb, bp), na, nb, 1024)
            rows["nw_walk"] = ("B=256 L=512", lambda f=f: kernels.nw_walk(*f),
                               10)
            continue
        d, m = kernels.sw_fill_dirs(ac, bc, na, nb, bp, True)
        starts = walk_starts(sw_extract_candidates(
            m, na_h, nb_h, near_best(kernels.sw_scores(ac, bc, na, nb, bp))),
            na_h, 16, dev)
        del m
        f = (d, ac, bc, na, nb, *starts, bp, 1024)
        rows["sw_walk" + ("[table]" if key == "table" else "")] = (
            "B=256 L=512", lambda f=f: kernels.sw_walk(*f), 10)
    for tag, sc in (("neg", mode_scoring("neg", True)),
                    ("lcs", port.lcs_aligner().scoring)):
        A = dna(rng, MODE_B, MODE_L, MODE_L)
        B = A if tag == "lcs" else dna(rng, MODE_B, MODE_L, MODE_L)
        (ac, bc, na, nb), bp, (na_h, nb_h) = packed(
            sc, kernel_params(sc, dev), A, B, dev)
        d, m = kernels.sw_fill_dirs(ac, bc, na, nb, bp, True)
        args = hit_args(d, ac, bc, na, nb, m, na_h, nb_h, 1, bp, 16)
        del m
        f = (d, ac, bc, na, nb, *hit_starts(kernels.sw_hits(*args), na, 16),
             bp, 2 * MODE_L)
        rows[f"sw_walk[{tag}]"] = (f"B={MODE_B} L={MODE_L}, its hits",
                                   lambda f=f: kernels.sw_walk(*f), 10)
    # the slabs of phase 1's first carry case
    crng = np.random.default_rng(SEED + 22)
    _, ra, rb, _, n = CARRY_CASES[0]
    A, B = seqs(crng, n, *ra), seqs(crng, n, *rb)
    A[0] = A[0][:2 * CARRY_CA]
    for sw in (False, True):
        sc = scs["sw" if sw else "nw"]
        la, lb = max(map(len, A)), max(map(len, B))
        ac, bc, na_h, nb_h, bp = pack_batch(sc, kernel_params(sc, dev), A, B,
                                            la, lb)
        args = (*(torch.from_numpy(v).to(dev) for v in (ac, bc, na_h, nb_h)),
                bp)
        slabs, _, ms, acc, _ = carry_chunks(
            kernels.sw_fill_dirs_carry if sw else kernels.nw_fill_dirs_carry,
            args, CARRY_CA, sw, sw and m16_safe(sc, la, lb))
        na, nb = args[2], args[3]
        cap = int((na + nb).max())
        if not sw:
            f = (slabs, acc, na, nb, cap)
            rows["nw_walk[chunked]"] = ("4 pairs' slabs",
                                        lambda f=f: kernels.nw_walk(*f), 3)
            continue
        flat, score, off = merge_candidates(
            [sw_sorted_candidates(m, na_h, nb_h, near_best(acc),
                                  x_off=c * CARRY_CA)
             for c, m in enumerate(ms)], len(A))
        del ms
        hits = kernels.sw_hits(slabs, *args[:4], flat, score, off[:-1],
                               off[1:], bp, 16)
        f = (slabs, *args[:4], *hit_starts(hits, na, 16), bp, cap)
        rows["sw_walk[chunked]"] = ("4 pairs' slabs, their hits",
                                    lambda f=f: kernels.sw_walk(*f), 3)
    # the planes of one launch across widths: CLI job 1's mix ...
    rrng = np.random.default_rng(SEED + 5)
    A, B = dna(rrng, RAGGED_PAIRS, *CLI_KB), dna(rrng, RAGGED_PAIRS, *CLI_KB)
    sc = scs["nw"]
    ac, bc, na_h, nb_h, bp = pack_batch(sc, kernel_params(sc, dev), A, B,
                                        max(map(len, A)), max(map(len, B)))
    tn = [torch.from_numpy(v).to(dev) for v in (ac, bc, na_h, nb_h)]
    sn = kernels.fill_schedule(na_h, nb_h, dev, planes=True)
    f = (*kernels.nw_fill_dirs(*tn, bp, sn), tn[2], tn[3],
         int((na_h + nb_h).max()), sn.off)
    rows["nw_walk[ragged]"] = (f"{RAGGED_PAIRS} pairs of 1-10 kb",
                               lambda f=f: kernels.nw_walk(*f), 3)
    # ... and SW job 3's first sub-batch, on the hits near each best
    sc = scs["sw"]
    A, B = planted(np.random.default_rng(SEED + 3), DNA, SW_JOB3[1], 1000,
                   10000, (0.3, 0.5), 0.03)
    mbytes = 2 if m16_safe(sc, max(map(len, A)), max(map(len, B))) else 4
    subs = aligners._plane_subbatches(
        range(len(A)), aligners._align_budget(dev),
        lambda i: aligners._sw_pair_bytes(len(A[i]), len(B[i]), mbytes,
                                          False))
    A, B = [A[i] for i in subs[0]], [B[i] for i in subs[0]]
    ac, bc, na_h, nb_h, bp = pack_batch(sc, kernel_params(sc, dev), A, B,
                                        max(map(len, A)), max(map(len, B)))
    ts = [torch.from_numpy(v).to(dev) for v in (ac, bc, na_h, nb_h)]
    ss = kernels.fill_schedule(na_h, nb_h, dev, planes=True)
    m16 = m16_safe(sc, int(na_h.max()), int(nb_h.max()))
    mins = np.maximum(kernels.sw_scores(*ts, bp, ss).cpu().numpy().astype(
        np.int64) - 10, 1)
    sflat, mflat = kernels.sw_fill_dirs(*ts, bp, m16, ss)
    cand = sw_sorted_candidates(mflat, na_h, nb_h, mins, off=ss.off)
    del mflat
    k = aligners._SW_PREWALK
    starts = hit_starts(kernels.sw_hits(
        sflat, *ts, cand[0], cand[1], cand[2][:-1], cand[2][1:], bp, k,
        ss.off), ts[2], k)
    f = (sflat, *ts, *starts, bp, int((starts[1] + starts[2]).max()), ss.off)
    rows["sw_walk[ragged]"] = (f"the hits of SW job 3's {len(A)} pairs",
                               lambda f=f: kernels.sw_walk(*f), 3)
    for name, (shape, fn, n) in rows.items():
        ops = fn()
        ops = ops[0] if isinstance(ops, tuple) else ops
        longest = int((ops >= 0).sum(1).max())
        ms = [cuda_ms(fn, n) for _ in range(5 if n == 10 else 3)]
        log(f"walks: {name} at {shape}, {len(ops)} walks: "
            + ", ".join(f"{v:.4f}" for v in ms) + f" ms; longest walk "
            f"{longest} steps, "
            + ", ".join(f"{1e6 * v / max(longest, 1):.1f}" for v in ms)
            + f" ns a step [{gpu}]")


def walls_ab(gpu):
    """The walls of the main path's fill-bound jobs, through the entry
    points a user calls and only those, so that ``--tree`` times an older
    tree's package with this script in the same call: NW
    ``score_pairs_stream`` on ``STREAM_PAIRS`` pairs of 1-10 kb, NW
    ``align_batch`` on ``ALIGN_LONG_PAIRS`` of them, CLI job 1
    (``needleman_wunsch --printscores --file`` on ``CLI_NW_PAIRS`` pairs of
    1-10 kb, gzip FASTA, in-process, stdout to a file), SW job 3
    (``SW_JOB3``: ``align_batch`` at best - 10, first 8 hits), and CLI
    jobs 2 (``smith_waterman`` under BLOSUM62 on ``CLI_SW_PAIRS`` protein
    pairs) and 3 (``needleman_wunsch`` under the free end gaps, a flagged
    fill, on ``CLI_READS`` reads against references), in-process as job
    1; path modes' NW ``align_batch`` under nsg+neg on ``MODE_B`` pairs of
    ``MODE_L`` bp and its LCS ``align_batch`` (nga+ngb+nmm) on
    ``LCS_SEQS`` sequences of 512-2,048 bp against themselves, first 8
    hits; path long's jobs 1, 2, 3, 5a, 5b and 6 (``long_walls``); each
    from a generator of its own; one warm-up (on 16 or 64 pairs, or 1-2
    long ones), then one timed run each, with the fills' milliseconds by
    CUDA events (their sum and the first launch's; for CLI job 3's first
    launch, 256 pairs as the CLI calls ``align_batch``, its bound) and
    the walks' (``nw_walk``, ``sw_walk``: launches and their sum)."""
    import tempfile

    import seqalign_tpu_torch as port
    from seqalign_tpu_torch.ops import kernels

    nw = port.NeedlemanWunsch(device="cuda")
    sw = port.SmithWaterman(device="cuda")
    rng = np.random.default_rng(SEED + 11)
    LA, LB = dna(rng, STREAM_PAIRS, 1000, 10000), dna(rng, STREAM_PAIRS,
                                                      1000, 10000)

    def stream(n):
        return list(nw.score_pairs_stream(
            (i, a, b) for i, (a, b) in enumerate(zip(LA[:n], LB[:n]))))

    A3, B3 = planted(np.random.default_rng(SEED + 3), DNA, SW_JOB3[1], 1000,
                     10000, (0.3, 0.5), 0.03)
    mins3 = [max(1, int(v) - 10) for v in sw.best_score_batch(A3, B3)]
    with tempfile.TemporaryDirectory(prefix="walls-") as work:
        crng = np.random.default_rng(SEED + 12)
        A1, B1 = dna(crng, CLI_NW_PAIRS, *CLI_KB), dna(
            crng, CLI_NW_PAIRS, *CLI_KB)
        fa = write_fasta(os.path.join(work, "pairs.fa.gz"), A1, B1)
        small = write_fasta(os.path.join(work, "small.fa.gz"), A1[:64],
                            B1[:64])
        out = os.path.join(work, "nw.txt")
        A2, B2, _ = job2_inputs(np.random.default_rng(SEED + 13),
                                CLI_SW_PAIRS)
        fa2 = write_fasta(os.path.join(work, "prot.fa"), A2, B2)
        small2 = write_fasta(os.path.join(work, "prot64.fa"), A2[:64],
                             B2[:64])
        refs, reads = reads_inputs(np.random.default_rng(SEED + 14),
                                   CLI_READS)
        fa3 = write_fasta(os.path.join(work, "reads.fa"), refs, reads)
        small3 = write_fasta(os.path.join(work, "reads64.fa"), refs[:64],
                             reads[:64])
        jobs = {
            f"nw score_pairs_stream {STREAM_PAIRS} x 1-10kb": (
                lambda: stream(64), lambda: stream(STREAM_PAIRS),
                (kernels, "nw_scores")),
            f"nw align_batch {ALIGN_LONG_PAIRS} x 1-10kb": (
                lambda: nw.align_batch(LA[:64], LB[:64]),
                lambda: nw.align_batch(LA[:ALIGN_LONG_PAIRS],
                                       LB[:ALIGN_LONG_PAIRS]),
                (kernels, "nw_fill_dirs")),
            f"cli job 1 {CLI_NW_PAIRS} x 1-10kb": (
                lambda: run_cli("nw", ["--printscores", "--file", small], out),
                lambda: run_cli("nw", ["--printscores", "--file", fa], out),
                (kernels, "nw_fill_dirs")),
            f"sw job 3 {SW_JOB3[1]} x 1-10kb": (
                lambda: consume(sw, A3[:16], B3[:16], mins3[:16], SW_JOB3[2]),
                lambda: consume(sw, A3, B3, mins3, SW_JOB3[2]),
                (kernels, "sw_fill_dirs")),
            f"cli job 2 {CLI_SW_PAIRS} x 100-1000aa": (
                lambda: run_cli("sw", CLI_JOB2_ARGS + ["--file", small2],
                                out),
                lambda: run_cli("sw", CLI_JOB2_ARGS + ["--file", fa2], out),
                (kernels, "sw_fill_dirs")),
            f"cli job 3 {CLI_READS} reads x 1-10kb": (
                lambda: run_cli("nw", CLI_JOB3_ARGS + ["--file", small3],
                                out),
                lambda: run_cli("nw", CLI_JOB3_ARGS + ["--file", fa3], out),
                (kernels, "nw_fill_dirs"))}
        nwf = port.NeedlemanWunsch(mode_scoring("nsg+neg"), device="cuda")
        lcs = port.lcs_aligner(case_sensitive=False)
        mrng = np.random.default_rng(SEED + 16)
        MA, MB = (dna(mrng, MODE_B, MODE_L, MODE_L),
                  dna(mrng, MODE_B, MODE_L, MODE_L))
        LS = dna(mrng, LCS_SEQS, 512, 2048)
        jobs.update({
            f"modes[nsg+neg] nw align_batch {MODE_B} x {MODE_L}": (
                lambda: nwf.align_batch(MA[:16], MB[:16]),
                lambda: nwf.align_batch(MA, MB), (kernels, "nw_fill_dirs")),
            f"modes[nga+ngb+nmm] lcs align_batch {LCS_SEQS} x 512-2048, "
            f"first 8 hits": (
                lambda: consume(lcs, LS[:16], LS[:16], None, 8),
                lambda: consume(lcs, LS, LS, None, 8),
                (kernels, "sw_fill_dirs"))})
        jobs.update(long_walls(nw, sw, kernels))
        na3 = np.array([len(r) for r in refs[:HARVEST_AB_CHUNK]])
        nb3 = np.array([len(r) for r in reads[:HARVEST_AB_CHUNK]])
        log(f"walls: cli job 3's first launch, {HARVEST_AB_CHUNK} pairs: "
            f"bound {fill_bound(na3, nb3, False, True, flags=('nsg', 'neg'))}")
        walks = ((kernels, "nw_walk"), (kernels, "sw_walk"))
        for label, (warm, job, target) in jobs.items():
            warm()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res, ms = call_events(job, target, *walks)
            secs = time.perf_counter() - t0
            if label.startswith("cli") and res[0] != 0:
                raise AssertionError(f"walls: {label} exited {res[0]}: "
                                     f"{res[1][-500:]}")
            fills = ms[target[1]]
            walked = "".join(f"; {n} x{len(ms[n])} {sum(ms[n]):.3f} ms"
                             for _, n in walks if ms[n])
            log(f"walls: {label}: {secs:.4f} s; {target[1]} x{len(fills)} "
                f"{sum(fills):.3f} ms, the first {fills[0]:.3f} ms{walked} "
                f"[{gpu}]")


def long_walls(nw, sw, kernels):
    """Path long's jobs 1, 2 (the flagged carry, nsg+neg), 3, 5a, 5b and 6
    for ``walls_ab``, on pairs of their own generator: label -> (warm-up,
    job, the carry fill it times).  Only the entry points a user calls, so
    that an older tree runs them."""
    import seqalign_tpu_torch as port

    nwf = port.NeedlemanWunsch(mode_scoring("nsg+neg"), device="cuda")
    rng = np.random.default_rng(SEED + 15)
    A, B = dna(rng, LONG_NW, *LONG_A), dna(rng, LONG_NW, *LONG_B)
    SA = dna(rng, LONG_SW, *LONG_A)
    SB = [plant(rng, a, b, LONG_SEG, LONG_SUB)
          for a, b in zip(SA, dna(rng, LONG_SW, *LONG_B))]
    ga = dna(rng, 1, GIANT, GIANT)[0]
    gb = plant(rng, ga, dna(rng, 1, GIANT, GIANT)[0], LONG_SEG, LONG_SUB,
               pb=GIANT - LONG_SEG - 1000)
    mins = [max(1, int(v) - 10) for v in sw.best_score_batch(SA, SB)]
    gmin = [int(sw.best_score(ga, gb)) - 10]
    nwc, swc = (kernels, "nw_fill_dirs_carry"), (kernels, "sw_fill_dirs_carry")

    def hits(A_, B_, m):
        return [list(itertools.islice(it, 8))
                for it in sw.align_batch(A_, B_, m)]

    return {
        f"long job 1 nw align_batch {LONG_NW} x 20-40kb x 6-10kb": (
            lambda: nw.align_batch(A[:2], B[:2]),
            lambda: nw.align_batch(A, B), nwc),
        f"long job 2 nw[nsg+neg] align_batch {LONG_NSG} x 20-40kb x "
        f"6-10kb": (lambda: nwf.align_batch(A[:2], B[:2]),
                    lambda: nwf.align_batch(A[:LONG_NSG], B[:LONG_NSG]),
                    nwc),
        f"long job 3 sw align_batch {LONG_SW} x 20-40kb x 6-10kb, best - "
        f"10, 8 hits": (lambda: hits(SA[:2], SB[:2], mins[:2]),
                        lambda: hits(SA, SB, mins), swc),
        "long job 5a NeedlemanWunsch.align_long": (
            lambda: nw.align_long(A[1], B[1]),
            lambda: nw.align_long(A[0], B[0]), nwc),
        "long job 5b SmithWaterman.align_long, 8 hits": (
            lambda: list(itertools.islice(sw.align_long(
                SA[1], SB[1], min_score=mins[1]), 8)),
            lambda: list(itertools.islice(sw.align_long(
                SA[0], SB[0], min_score=mins[0]), 8)), swc),
        f"long job 6 sw align_batch 1 x {GIANT} x {GIANT}, best - 10, 8 "
        f"hits": (lambda: hits(SA[:1], SB[:1], mins[:1]),
                  lambda: hits([ga], [gb], gmin), swc)}


HARVEST_AB_CHUNK = 256  # the CLIs' pairs per align_batch call


def harvest_ab(gpu):
    """SW job 3's mix (``SW_JOB3``: DNA pairs of 1-10 kb with a planted
    segment, best - 10, first 8 hits) and CLI job 2's (1,024 planted
    protein pairs under BLOSUM62, min_score ``PROTEIN_MIN_SCORE``, first 8
    hits, in ``align_batch`` calls of ``HARVEST_AB_CHUNK`` pairs as the CLI
    makes them), each from a generator of its own, through
    ``SmithWaterman.align_batch``: a warm-up, then runs that print the
    wall and, by CUDA events, the milliseconds of the fills
    (``kernels.sw_fill_dirs``, the zeroing of a ragged M included), the
    harvests (the aligner's ``sw_sorted_candidates``) and the hit loops
    (``kernels.sw_hits``).  Only those names and the public API, so that
    ``--tree`` times an older tree's package (its harvest design) with
    this script in the same call.  Where the package has
    ``kernels._hits_smem`` (an older tree's shared memory for the hit
    masks of a launch across widths, as much as keeps every block
    resident) the runs alternate with ones whose blocks take up to
    ``SMEM_MAX``, the rule of the uniform launch and now of every launch:
    default, max, max, default."""
    import seqalign_tpu_torch as port
    from seqalign_tpu_torch import aligners
    from seqalign_tpu_torch.ops import kernels

    rng = np.random.default_rng(SEED + 3)
    dna_sw = port.SmithWaterman(device="cuda")
    A3, B3 = planted(rng, DNA, SW_JOB3[1], 1000, 10000, (0.3, 0.5), 0.03)
    mins3 = [max(1, int(v) - 10) for v in dna_sw.best_score_batch(A3, B3)]
    rng = np.random.default_rng(SEED + 4)
    prot_sw = port.SmithWaterman(port.presets.scoring_system_BLOSUM62(),
                                 device="cuda")
    A2, B2 = planted(rng, AMINO, SW_JOB2[1], 100, 1000, (0.1, 0.3), 0.25)
    chunks = range(0, SW_JOB2[1], HARVEST_AB_CHUNK)
    jobs = {
        "SW job 3": lambda: consume(dna_sw, A3, B3, mins3, SW_JOB3[2]),
        "CLI job 2": lambda: [consume(
            prot_sw, A2[i:i + HARVEST_AB_CHUNK], B2[i:i + HARVEST_AB_CHUNK],
            [PROTEIN_MIN_SCORE] * len(A2[i:i + HARVEST_AB_CHUNK]),
            SW_JOB2[2]) for i in chunks]}
    rule = getattr(kernels, "_hits_smem", None)
    variants = (("default", "SMEM_MAX", "SMEM_MAX", "default") if rule
                else ("default", "default"))
    targets = ((kernels, "sw_fill_dirs"), (aligners, "sw_sorted_candidates"),
               (kernels, "sw_hits"))
    for label, job in jobs.items():
        job()  # warm-up
        for v in variants:
            if v == "SMEM_MAX":
                kernels._hits_smem = lambda B, dev: kernels.SMEM_MAX
            try:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                _, ms = call_events(job, *targets)
                secs = time.perf_counter() - t0
            finally:
                if rule:
                    kernels._hits_smem = rule
            log(f"harvest A/B {label}, hit masks {v}: wall {secs:.4f} s; "
                + "; ".join(f"{n} x{len(t)} {sum(t):.3f} ms"
                            for n, t in ms.items()) + f" [{gpu}]")


def hits_long(out_path, gpu):
    """Path long's job 4 alone: SW ``align_batch`` on ``LONG_HINTLESS``
    pairs of 20-40 kb x 6-10 kb with a planted 2 kb segment, no hint, the
    first 8 hits of each, from a generator of its own and through the
    entry points only, so that ``--tree`` runs an older tree's package:
    its wall and its kernel launches (``kernel_launch_counts``), and its
    hit streams written to ``out_path`` as JSON, pair by pair, to be
    compared with another tree's."""
    import dataclasses

    import seqalign_tpu_torch as port

    sw = port.SmithWaterman(device="cuda")
    rng = np.random.default_rng(SEED + 17)
    SA = dna(rng, LONG_HINTLESS, *LONG_A)
    SB = [plant(rng, a, b, LONG_SEG, LONG_SUB)
          for a, b in zip(SA, dna(rng, LONG_HINTLESS, *LONG_B))]
    port.reset_kernel_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    hits = [[list(dataclasses.astuple(h)) for h in itertools.islice(it, 8)]
            for it in sw.align_batch(SA, SB)]
    secs = time.perf_counter() - t0
    counts = {k: v for k, v in port.kernel_launch_counts().items() if v}
    with open(out_path, "w") as f:
        json.dump(hits, f)
    log(f"hits-long: long job 4, {len(SA)} pairs, no hint, first 8 hits: "
        f"{secs:.4f} s, {sum(map(len, hits))} hits, launches {counts}; "
        f"streams in {out_path} [{gpu}]")


CHUNK_AB = (2048, 4096, 8192, 16384, 32768)  # LONG_CHUNK candidates


def chunk_ab(rng, gpu):
    """Path long's NW ``align_batch`` (16 of job 1's pairs) and SW
    ``align_batch`` (8 of job 3's, min_score = best - 10, first 8 hits) at
    each width of CHUNK_AB, in that order and then reversed; each run
    prints its wall, GCUPS, chunks, slab bytes and peak device memory."""
    import seqalign_tpu_torch as port
    from seqalign_tpu_torch import aligners

    nw = port.NeedlemanWunsch(device="cuda")
    sw = port.SmithWaterman(device="cuda")
    A, B = dna(rng, 16, *LONG_A), dna(rng, 16, *LONG_B)
    SA = dna(rng, 8, *LONG_A)
    SB = [plant(rng, a, b, LONG_SEG, LONG_SUB)
          for a, b in zip(SA, dna(rng, 8, *LONG_B))]
    mins = [max(1, int(v) - 10) for v in sw.best_score_batch(SA, SB)]
    saved = aligners.LONG_CHUNK
    try:
        for ca in CHUNK_AB + CHUNK_AB[::-1]:
            aligners.LONG_CHUNK = ca
            long_job(f"chunk A/B {ca}: nw align_batch 16 x 20-40kb x 6-10kb",
                     lambda: nw.align_batch(A, B), cells_of(A, B), 16, gpu)
            long_job(f"chunk A/B {ca}: sw align_batch 8 x 20-40kb x 6-10kb, "
                     f"best - 10, first 8 hits",
                     lambda: [list(itertools.islice(it, 8)) for it in
                              sw.align_batch(SA, SB, mins)],
                     cells_of(SA, SB), 8, gpu)
    finally:
        aligners.LONG_CHUNK = saved


# the sequence-parallel fills' rows (S1, S2: lane slices of the tile carry,
# csrc/tile_carry.cuh SLICE, in place of the JAX package's shard_map scans)
SLICE_ROWS = ("nw_scores_slice", "sw_scores_slice", "nw_fill_dirs_slice")
# phase 1's slice rows: the first carry case (4 pairs of 5,000-6,144 x
# 1,500-2,048 at 2,048 lanes, chunks of CARRY_CA) split into 3 slices (of
# 1, 1 and 2 rounds at 4 warps: the middle one reads an edge row and
# writes one), from a generator of their own so that no later path's
# inputs move
SLICE_SLICES = 3
# path parallel: the engine on BASELINE.json configs[4]'s lengths, the
# sequence-parallel scores on 4 pairs of 64 kb and the alignment of one
# pair of 48 kb (long job 6's size), each on 2 and 4 slices of one card;
# the two-process files on 256 pairs
PAR_PAIRS = 1024
PAR_SP = (4, 65_536)
PAR_SP_ALIGN = GIANT
PAR_SLICES = (2, 4)
PAR_FILE_PAIRS = 256
PAR_HITS = 8
# path parallel's sharded SW streams: hint-free, on path sw's job 1 shape
PAR_SW_ALIGN = (512, 256, 512)


def slices_vs_plain(dev, times, bounds):
    """The three slice kernels (rows ``nw_scores_slice``,
    ``sw_scores_slice``, ``nw_fill_dirs_slice``) against their plain
    versions on phase 1's 4-pair carry case split into SLICE_SLICES slices
    of whole rounds (a middle slice reads an edge row and writes one),
    both through the port's driver (``wavefront_sp.slice_fill``: every
    chunk in the wavefront's order, a stream a slice): the corners or
    bests, every edge row, and the slabs byte for byte (both zeroed); one
    plain run a family (the codes slices' holds ``nw_scores_slice`` too);
    the kernels timed by CUDA events over the whole fill, the plain
    versions by the check's run."""
    import seqalign_tpu_torch as port
    from seqalign_tpu_torch import kernel_params
    from seqalign_tpu_torch.ops.pack import pack_batch
    from seqalign_tpu_torch.parallel import wavefront_sp as wsp
    from seqalign_tpu_torch.parallel.engine import Mesh

    rng = np.random.default_rng(SEED + 14)
    _, ra, rb, _, n = CARRY_CASES[0]
    A, B = seqs(rng, n, *ra), seqs(rng, n, *rb)
    err, plain = {}, {}
    # one plain fill a family: the codes slices' run holds nw_scores_slice
    # too (the same corners and edge rows)
    for what in ("nw_fill_dirs_slice", "sw_scores_slice", "nw_scores_slice"):
        t0 = time.perf_counter()
        sw, dirs = what.startswith("sw"), what == "nw_fill_dirs_slice"
        sc = (port.presets.scoring_system_sw_default() if sw
              else port.presets.scoring_system_default())
        la, lb = max(map(len, A)), max(map(len, B))
        ac, bc, na, nb, bp = pack_batch(sc, kernel_params(sc), A, B, la, lb)
        devices, lanes, warps = wsp.slice_plan(
            Mesh([dev] * SLICE_SLICES, "seq"), "seq", n, lb)
        if len(lanes) != SLICE_SLICES:
            raise AssertionError(f"{what}: {lanes} is not {SLICE_SLICES} "
                                 f"slices")

        def run(plain_=False):
            return wsp.slice_fill(sc, (ac, bc, na, nb), bp, devices, lanes,
                                  warps, CARRY_CA, is_sw=sw,
                                  dirs=dirs,
                                  plain=plain_)

        got = run()
        if what == "nw_scores_slice":
            want, t_p = plain["nw_fill_dirs_slice"]
        else:
            want, t_p = plain[what] = timed_plain(lambda: run(True))
        e = max(int(np.abs(got[0].astype(np.int64) - want[0]).max()),
                max_abs(*((got[2][k], want[2][k]) for k in want[2])))
        if dirs:
            e = max(e, 0 if torch.equal(got[1], want[1]) else max_abs(
                (got[1], want[1])))
        err[what] = e
        times[what] = (cuda_ms(run, 3), t_p)
        nch = -(-la // CARRY_CA)
        bounds[what] = fill_bound(
            na, nb, sw, dirs,
            extra_bytes=24 * n * nch * (lb + 1 + (len(lanes) - 1)
                                        * (CARRY_CA + 1)))
        log(f"phase 1: {what} vs plain, {n} pairs of {ra[0]}-{ra[1]} x "
            f"{rb[0]}-{rb[1]} in chunks of {CARRY_CA}, slices {lanes} "
            f"({warps} warps a block): max |diff| {e} "
            f"({time.perf_counter() - t0:.1f} s)")
    return err


def same_alignments(got, want, what):
    key = [(a.result_a, a.result_b, a.score) for a in got]
    if key != [(a.result_a, a.result_b, a.score) for a in want]:
        raise AssertionError(f"path parallel: {what}: alignments differ")


def first_hits(streams, k):
    """The first ``k`` hits of each stream."""
    return [[(h.result_a, h.result_b, h.score, h.pos_a, h.pos_b)
             for h in itertools.islice(it, k)] for it in streams]


def par_job(label, fn, gpu):
    """One job of path parallel: its result and wall, printed."""
    out, secs = timed(fn)
    log(f"parallel: {label}: {secs:.4f} s [{gpu}]")
    return out


def phase_parallel(dev, gpu):
    """Path parallel: the multi-device layer through its entry points on
    meshes of positions of this card (and of every card, where the machine
    has more), from a generator of its own; each check exact (see the
    module docstring).  Returns the path's launch counts."""
    import tempfile

    import seqalign_tpu_torch as port
    from seqalign_tpu_torch.parallel import distributed, dryrun, engine
    from seqalign_tpu_torch.parallel import wavefront_sp as wsp

    rng = np.random.default_rng(SEED + 15)
    nw = port.NeedlemanWunsch(device=dev)
    sw = port.SmithWaterman(device=dev)
    meshes = [engine.Mesh([dev] * 2)]
    if torch.cuda.device_count() > 1:
        meshes.append(engine.make_mesh())
    with tempfile.TemporaryDirectory(prefix="par-") as work:
        # the two-process files and the examples start first, in processes
        # of their own, and run beside the jobs below
        fa = write_fasta(os.path.join(work, "pairs.fa"),
                         dna(rng, PAR_FILE_PAIRS, *CLI_KB),
                         dna(rng, PAR_FILE_PAIRS, *CLI_KB))
        root = os.path.dirname(os.path.abspath(__file__))
        worker = os.path.join(root, "tests", "_torch_dist_worker.py")
        procs = {}
        for mode in ("scores", "align"):
            port_no = free_port()
            for pid in range(2):
                env = dict(os.environ, SEQALIGN_NUM_PROCS="2",
                           SEQALIGN_PROC_ID=str(pid),
                           SEQALIGN_COORDINATOR=f"127.0.0.1:{port_no}")
                procs[mode, pid] = subprocess.Popen(
                    [sys.executable, worker, fa, "--batch", "64"]
                    + (["--align"] if mode == "align" else []),
                    stdout=subprocess.PIPE, stderr=subprocess.PIPE, env=env,
                    cwd=root)
        for name in ("nw", "sw"):
            for where in ("cuda", "cpu"):
                procs[name, where] = subprocess.Popen(
                    [sys.executable, os.path.join(
                        root, "seqalign_tpu_torch", "examples",
                        f"{name}_example.py")],
                    stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                    env=dict(os.environ, SEQALIGN_DEVICE=where), cwd=root)
        try:
            # the engine: 1,024 pairs of 1-10 kb, NW and SW
            A, B = dna(rng, PAR_PAIRS, *CLI_KB), dna(rng, PAR_PAIRS, *CLI_KB)
            one = f"{PAR_PAIRS} pairs of 1-10 kb on one device"
            nw_s = par_job(f"score_batch, {one}", lambda: nw.score_batch(A, B),
                           gpu)
            sw_s = par_job(f"best_score_batch, {one}",
                           lambda: sw.best_score_batch(A, B), gpu)
            nw_a = par_job(f"align_batch NW, {one}",
                           lambda: nw.align_batch(A, B), gpu)
            # SW streams hint-free, on pairs whose every positive cell the
            # harvest can hold
            n_sw, lo_sw, hi_sw = PAR_SW_ALIGN
            sa, sb = dna(rng, n_sw, lo_sw, hi_sw), dna(rng, n_sw, lo_sw, hi_sw)
            sw_one = f"{n_sw} pairs of {lo_sw}-{hi_sw} bp"
            sw_h = par_job(f"align_batch SW, no hint, first {PAR_HITS} hits, "
                           f"{sw_one} on one device", lambda: first_hits(
                               sw.align_batch(sa, sb), PAR_HITS), gpu)
            for mesh in meshes:
                tag = f"{PAR_PAIRS} pairs of 1-10 kb on {mesh}"
                got = par_job(f"sharded_score_batch NW, {tag}",
                              lambda: engine.sharded_score_batch(
                                  nw.scoring, A, B, is_sw=False, mesh=mesh),
                              gpu)
                if not np.array_equal(got, nw_s):
                    raise AssertionError(f"path parallel: sharded NW scores "
                                         f"on {mesh} != score_batch")
                got = par_job(f"sharded_score_batch SW, {tag}",
                              lambda: engine.sharded_score_batch(
                                  sw.scoring, A, B, is_sw=True, mesh=mesh),
                              gpu)
                if not np.array_equal(got, sw_s):
                    raise AssertionError(f"path parallel: sharded SW scores "
                                         f"on {mesh} != best_score_batch")
                same_alignments(par_job(
                    f"sharded_align_batch NW, {tag}",
                    lambda: engine.sharded_align_batch(
                        nw.scoring, A, B, is_sw=False, mesh=mesh), gpu),
                    nw_a, f"sharded NW on {mesh}")
                got = par_job(
                    f"sharded_align_batch SW, no hint, first {PAR_HITS} "
                    f"hits, {sw_one} on {mesh}",
                    lambda: first_hits(engine.sharded_align_batch(
                        sw.scoring, sa, sb, is_sw=True, mesh=mesh),
                        PAR_HITS), gpu)
                if got != sw_h:
                    raise AssertionError(f"path parallel: sharded SW hits on "
                                         f"{mesh} != align_batch's")
            # sequence parallel scores: 4 pairs of 64 kb x 64 kb
            n, L = PAR_SP
            A, B = dna(rng, n, L, L), dna(rng, n, L, L)
            want = {False: par_job(f"score_batch, {n} pairs of {L} x {L}",
                                   lambda: nw.score_batch(A, B), gpu),
                    True: par_job(f"best_score_batch, {n} pairs of {L} x {L}",
                                  lambda: sw.best_score_batch(A, B), gpu)}
            for ns in PAR_SLICES:
                mesh = engine.Mesh([dev] * ns, "seq")
                for is_sw, sc in ((False, nw.scoring), (True, sw.scoring)):
                    got = par_job(
                        f"sp_scores {'SW' if is_sw else 'NW'}, {n} pairs of "
                        f"{L} x {L}, {ns} slices",
                        lambda: wsp.sp_scores(sc, A, B, mesh, is_sw=is_sw),
                        gpu)
                    if not np.array_equal(got, want[is_sw]):
                        raise AssertionError(
                            f"path parallel: sp_scores on {ns} slices "
                            f"{got} != {want[is_sw]}")
            # sequence parallel alignment: one pair of 48 kb x 48 kb
            a, b = dna(rng, 1, PAR_SP_ALIGN, PAR_SP_ALIGN)[0], dna(
                rng, 1, PAR_SP_ALIGN, PAR_SP_ALIGN)[0]
            want = par_job(f"align_long, one pair of {len(a)} x {len(b)}",
                           lambda: nw.align_long(a, b, chunk=LONG_CHUNK_SP),
                           gpu)
            unsplit = unsplit_slab(nw.scoring, a, b, dev)
            for ns in PAR_SLICES:
                mesh = engine.Mesh([dev] * ns, "seq")
                got = par_job(f"sp_align_nw, one pair of {len(a)} x {len(b)}, "
                              f"{ns} slices",
                              lambda: wsp.sp_align_nw(nw.scoring, a, b, mesh,
                                                      chunk=LONG_CHUNK_SP),
                              gpu)
                same_alignments([got], [want], f"sp_align_nw on {ns} slices")
                (slab, _, _, _), _ = wsp._sp_nw_fill(nw.scoring, a, b, mesh,
                                                     "seq", LONG_CHUNK_SP)
                if not torch.equal(slab, unsplit):
                    raise AssertionError(f"path parallel: the slab of {ns} "
                                         f"slices differs from the unsplit "
                                         f"carry's")
                del slab
            log(f"parallel: the slabs of {PAR_SLICES} slices equal the "
                f"unsplit carry's byte for byte ({unsplit.numel()} bytes)")
            del unsplit
            torch.cuda.empty_cache()
            # the dry run on two positions of this card
            par_job("dryrun_multichip(2)", lambda: dryrun.dryrun_multichip(
                2, engine.Mesh([dev] * 2)), gpu)
            # one process's files
            one = {"scores": par_job(
                f"distributed_score_file, one process, {PAR_FILE_PAIRS} "
                f"pairs", lambda: distributed.distributed_score_file(
                    nw.scoring, fa, is_sw=False, batch=64), gpu).tolist(),
                "align": [[r.result_a, r.result_b, r.score] for r in par_job(
                    f"distributed_align_file, one process, {PAR_FILE_PAIRS} "
                    f"pairs", lambda: distributed.distributed_align_file(
                        nw.scoring, fa, is_sw=False, batch=64), gpu)]}
            outs = {}
            for key, p in procs.items():
                out, err = p.communicate(timeout=600)
                if p.returncode != 0:
                    raise AssertionError(f"path parallel: {key} exited "
                                         f"{p.returncode}: {err[-2000:]}")
                outs[key] = out.decode()
        finally:
            for p in procs.values():
                if p.poll() is None:
                    p.kill()
                    p.wait()
    for mode in ("scores", "align"):
        for pid in range(2):
            o = json.loads(outs[mode, pid].strip().splitlines()[-1])
            got = o["scores"] if mode == "scores" else o["alns"]
            if not o["multi"] or got != one[mode]:
                raise AssertionError(f"path parallel: process {pid} of two "
                                     f"({mode}) differs from one process")
    log(f"parallel: two processes over gloo on this card: scores and "
        f"alignments of {PAR_FILE_PAIRS} pairs equal one process's")
    for name in ("nw", "sw"):
        if not outs[name, "cuda"] or outs[name, "cuda"] != outs[name, "cpu"]:
            raise AssertionError(f"path parallel: {name}_example on the card "
                                 f"prints other lines than on the CPU")
    log("parallel: nw_example and sw_example print the same on the card as "
        "on the CPU")


# path parallel's chunk width for the 48 kb pair: the long path's
LONG_CHUNK_SP = 16_384


def unsplit_slab(sc, a, b, dev):
    """The codes of one pair by the unsplit carry kernel, chunk by chunk in
    chunks of ``LONG_CHUNK_SP``, in zeroed slabs (1, nch, CA+LB-1, LB+1)."""
    from seqalign_tpu_torch import kernel_params
    from seqalign_tpu_torch.ops import kernels
    from seqalign_tpu_torch.ops.dp import boundary_column
    from seqalign_tpu_torch.ops.pack import pack_batch

    ac, bc, na, nb, bp = pack_batch(sc, kernel_params(sc, dev), [a], [b],
                                    len(a), len(b))
    t = [torch.from_numpy(v).to(dev) for v in (ac, bc, na, nb)]
    ca = min(LONG_CHUNK_SP, -(-len(a) // 8) * 8)
    nch = -(-len(a) // ca)
    slabs = torch.zeros((1, nch, ca + len(b) - 1, len(b) + 1),
                        dtype=torch.uint8, device=dev)
    bin = boundary_column(bp, 1, len(b), is_sw=False)
    bout = torch.empty_like(bin)
    corner = torch.zeros((1, 3), dtype=torch.int32, device=dev)
    for c in range(nch):
        kernels.nw_fill_dirs_carry(*t, bp, c * ca, bin, bout, slabs[:, c],
                                   corner)
        bin, bout = bout, bin
    return slabs


def free_port() -> int:
    import socket

    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def launched(counts, k) -> int:
    """Launches of kernel ``k`` in ``counts``: its own and those across
    widths, which count under ``<k>[ragged]``."""
    return counts[k] + counts.get(f"{k}[ragged]", 0)


def counted(path, counts, label=None):
    for k in PATHS[path]:
        if launched(counts, k) <= 0:
            raise AssertionError(f"path {label or path}: {k} was not "
                                 f"launched: {counts}")
    log(f"kernel launches in path {label or path}: {counts}")


def _self_device_us(e) -> float:
    return float(getattr(e, "self_device_time_total",
                         getattr(e, "self_cuda_time_total", 0.0)))


# the names of csrc/'s kernels, as a profiler's device events carry them
PORT_KERNELS = ("tile_fill_kernel", "tile_carry_kernel", "nw_walk_kernel",
                "sw_walk_kernel", "sw_hits_kernel", "chain_kernel")


def profile(jobs, out_dir):
    """Each job once more under ``torch.profiler``: device self time (the
    sum over device events, as the table's "Self CUDA time total"), busy
    share = that time / the job's unprofiled wall, and the top items; and
    the port's launch counts of the profiled run beside the profiler's
    records of the port's kernels (``PORT_KERNELS``), so that a kernel
    record the profiler drops shows."""
    import seqalign_tpu_torch as port
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    os.makedirs(out_dir, exist_ok=True)
    for k, (label, (fn, wall)) in enumerate(jobs.items()):
        port.reset_kernel_launch_counts()
        with torch_profile(activities=[ProfilerActivity.CPU,
                                       ProfilerActivity.CUDA]) as prof:
            timed(fn)
        counts = {n: c for n, c in port.kernel_launch_counts().items() if c}
        ka = prof.key_averages()
        dev_ev = [e for e in ka if e.device_type == DeviceType.CUDA
                  and not getattr(e, "is_user_annotation", False)]
        ours = {e.key[:48]: e.count for e in dev_ev
                if any(k in e.key for k in PORT_KERNELS)}
        log(f"profile {label}: launch counts {counts} ({sum(counts.values())}"
            f" launches); the profiler's records of them {ours} "
            f"({sum(ours.values())})")
        dev_us = sum(map(_self_device_us, dev_ev))
        top = sorted(dev_ev, key=_self_device_us, reverse=True)[:3]
        path = os.path.join(out_dir, f"profile_{k}.txt")
        with open(path, "w") as f:
            f.write(f"{label}\n")
            f.write(ka.table(sort_by="self_cuda_time_total", row_limit=40,
                             max_name_column_width=60))
        log(f"profile {label}: wall {wall:.6f} s, device self time "
            f"{dev_us / 1e3:.3f} ms, busy share {dev_us / 1e6 / wall:.4f}; "
            f"top: " + "; ".join(
                f"{e.key[:48]} x{e.count} {_self_device_us(e) / 1e3:.3f} ms"
                for e in top) + f" (table: {path})")


# the add-then-max forms of the probe's addmax step, beside csrc/exp_vpu.cu's
# DPX intrinsics, for ``--sass``
ADDMAX_PLAIN_CU = r"""
__global__ void addmax_plain_s32(const int* x, int* o, int S) {
  int v = x[threadIdx.x], w = v;
  for (int i = 0; i < S; ++i) {
    asm volatile("" : "+r"(v));
    w = max(static_cast<int>(static_cast<unsigned>(w) +
                             static_cast<unsigned>(v)), w);
  }
  o[threadIdx.x] = w;
}
__global__ void addmax_plain_s16x2(const unsigned* x, unsigned* o, int S) {
  unsigned v = x[threadIdx.x], w = v;
  for (int i = 0; i < S; ++i) {
    asm volatile("" : "+r"(v));
    w = __vmaxs2(__vadd2(w, v), w);
  }
  o[threadIdx.x] = w;
}
"""


def _anon(name):
    """A kernel's name without the hash nvcc gives an anonymous namespace,
    so that two trees' names meet."""
    import re

    return re.sub(r"_GLOBAL__N__[0-9a-f]{8}_\d+_(\w+?_cu)_[0-9a-f]{8}",
                  r"_anon_\1", name)


def sass_of(sources, work):
    """{kernel: [instruction, ...]} of the ``.cu`` files ``sources``,
    compiled to cubins in ``work`` in parallel with the build's nvcc flags
    and read back with ``cuobjdump -sass``, names by ``_anon``."""
    import re

    from seqalign_tpu_torch.ops import build

    nvcc = build._nvcc()
    cuobjdump = os.path.join(os.path.dirname(nvcc), "cuobjdump")
    cubins = [os.path.join(work, f"{i}_{os.path.basename(src)}.cubin")
              for i, src in enumerate(sources)]
    procs = [subprocess.Popen([nvcc, *build.NVCC_FLAGS, "-Xptxas", "-v",
                               "-cubin", "-o", cb, str(src)],
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for src, cb in zip(sources, cubins)]
    ptxas = []
    for src, p in zip(sources, procs):
        out = p.communicate()[0]
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed on {src}:\n{out}")
        ptxas.append(out)
    funcs: dict = {"_ptxas": ptxas}
    for cb in cubins:
        text = subprocess.run([cuobjdump, "-sass", cb], capture_output=True,
                              text=True, check=True).stdout
        name = None
        for line in text.splitlines():
            m = re.match(r"\s*Function : (\S+)", line)
            if m:
                name = _anon(m.group(1))
                funcs[name] = []
            elif name is not None:
                m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(.*?)\s*;", line)
                if m:
                    funcs[name].append(m.group(1))
    return funcs


def demangle(name) -> str:
    """A kernel's C++ name by ``cu++filt`` beside nvcc, else as given."""
    from seqalign_tpu_torch.ops import build

    tool = os.path.join(os.path.dirname(build._nvcc()), "cu++filt")
    try:
        return subprocess.run([tool, name], capture_output=True, text=True,
                              check=True, timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return name


def opcode_mix(ins, top=10) -> str:
    """The ``top`` opcodes of a kernel's instructions, with counts."""
    ops = [i.split()[1] if i.startswith("@") else i.split()[0] for i in ins]
    counts: dict = {}
    for o in ops:
        counts[o.split(".")[0]] = counts.get(o.split(".")[0], 0) + 1
    return ", ".join(f"{k} {v}" for k, v in sorted(
        counts.items(), key=lambda kv: -kv[1])[:top])


def sass_report(old, gpu):
    """``--sass``: the probe kernels' and the add-then-max chains' opcode
    mixes, each tile fill's (csrc/tile_fill.cuh) and tile carry's
    (csrc/tile_carry.cuh) with its registers, spills and local memory
    instructions (LDL, STL), the flags' (MODES) and the dump's (GAB)
    instantiations among them, and, with an older tree ``old``, the tile
    instantiations and the other kernels both trees share compared
    instruction by instruction."""
    import re
    import tempfile
    from pathlib import Path

    from seqalign_tpu_torch.ops import build

    with tempfile.TemporaryDirectory() as work:
        plain = Path(work) / "addmax_plain.cu"
        plain.write_text(ADDMAX_PLAIN_CU)
        new_src = sorted(build.CSRC.glob("*.cu"))
        old_src = (sorted((Path(old) / "seqalign_tpu_torch" / "csrc").glob(
            "*.cu")) if old else [])
        if old and not old_src:
            raise RuntimeError(f"{old} holds no seqalign_tpu_torch/csrc")
        os.mkdir(os.path.join(work, "new"))
        os.mkdir(os.path.join(work, "old"))
        t0 = time.perf_counter()
        new = sass_of(new_src + [plain], os.path.join(work, "new"))
        prev = sass_of(old_src, os.path.join(work, "old")) if old else {}
    log(f"sass: compiled {len(new_src) + 1 + len(old_src)} sources in "
        f"{time.perf_counter() - t0:.1f} s (nvcc {' '.join(build.NVCC_FLAGS)})")
    ptxas = new.pop("_ptxas")
    prev.pop("_ptxas", None)
    # registers and spills of each kernel, from ptxas
    usage, entry = {}, None
    for line in "\n".join(ptxas).splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties "
                      r"for) '?(\w+)'?", line)
        if m:
            entry = _anon(m.group(1))
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores",
                      line)
        if m and entry:
            usage.setdefault(entry, {})["spills"] = int(m.group(2))
            usage[entry]["stack"] = int(m.group(1))
        m = re.search(r"Used (\d+) registers", line)
        if m and entry:
            usage.setdefault(entry, {})["regs"] = int(m.group(1))

    def ops_of(ins):
        return [i.split()[1 if i.startswith("@") else 0].split(".")[0]
                for i in ins]

    # the probe's kernels (csrc/exp_vpu.cu) and the add-then-max chains
    for name, ins in sorted(new.items()):
        if "chain_kernel" in name or "addmax_plain" in name:
            ops = ops_of(ins)
            log(f"sass: {demangle(name)}: {len(ins)} instructions, "
                f"{usage.get(name, {})}, LDL {ops.count('LDL')}, STL "
                f"{ops.count('STL')}: {opcode_mix(ins, 16)}")
    # the tile fills (csrc/tile_fill.cuh), carries and walks
    for name, ins in sorted(new.items()):
        if ("tile_fill_kernel" in name or "tile_carry_kernel" in name
                or "walk_kernel" in name):
            ops = ops_of(ins)
            log(f"sass: {demangle(name)}: {len(ins)} instructions, "
                f"{usage.get(name, {})}, " + ", ".join(
                    f"{o} {ops.count(o)}" for o in ("VIADDMNMX", "VIMNMX3",
                                                    "LDL", "STL"))
                + f": {opcode_mix(ins, 16)}")
    if old:
        # the tile instantiations both trees share: a tile fill's name here
        # carries GAB = false beside the older tree's (whose MODES = false
        # ones carry that flag in turn beside a tree before it)
        def base(n, strip):  # the name with its template arguments
            d = demangle(n)
            k = d[:d.find(">(") + 1] if ">(" in d else d
            return re.sub(r", (?:false|\(bool\)0)>$", ">", k) if strip else k

        def tile(n):
            return "tile_fill_kernel" in n or "tile_carry_kernel" in n

        olds = {base(n, False): n for n in prev if tile(n)}
        pairs = [(n, olds[base(n, False)] if base(n, False) in olds else
                  olds[base(n, True)]) for n in sorted(new)
                 if tile(n) and (base(n, False) in olds
                                 or base(n, True) in olds)]
        same = [n for n, o in pairs if new[n] == prev[o]]
        log(f"sass: {len(pairs)} tile instantiations in both trees, "
            f"{len(same)} identical instruction by instruction; "
            f"{sum(tile(n) for n in new) - len(pairs)} tile instantiations "
            f"only in this tree")
        for n, o in pairs:
            if n not in same:
                k = next((i for i, (a, b) in enumerate(zip(new[n], prev[o]))
                          if a != b), min(len(new[n]), len(prev[o])))
                log(f"sass: differs: {base(n, False)}: {len(new[n])} against "
                    f"{len(prev[o])} instructions, first at {k}: "
                    f"{new[n][k:k + 3]} against {prev[o][k:k + 3]}")
        common = sorted(set(new) & set(prev))
        others = [n for n in common if not tile(n)]
        only = [n for n in set(new) - set(prev)
                if "addmax_plain" not in n and not tile(n)]
        gone = [demangle(n) for n in set(prev) - set(new) if not tile(n)]
        log(f"sass: other kernels in both trees: {len(others)}, identical "
            f"{sum(new[n] == prev[n] for n in others)}; only in this tree: "
            f"{len(only)}; only in {old}: {len(gone)} {sorted(gone)}")
    log(f"sass: done [{gpu}]")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--profile", metavar="DIR",
                    help="profile each main-path job and write the tables "
                         "to DIR")
    ap.add_argument("--fills", action="store_true",
                    help="only time the default fills, sw_hits and two "
                         "more SW fills at B=256, L=512")
    ap.add_argument("--harvest-ab", action="store_true",
                    help="only time SW job 3 and CLI job 2's alignments: "
                         "walls, fills, harvests and hit loops")
    ap.add_argument("--walls", action="store_true",
                    help="only time the fill-bound jobs of the paths: "
                         "walls and fills")
    ap.add_argument("--walks", action="store_true",
                    help="only time the walk rows at their shapes")
    ap.add_argument("--gab", action="store_true",
                    help="only time the matrix dump's fills and CLI job 5")
    ap.add_argument("--tree", metavar="DIR",
                    help="with --fills, --walks, --gab, --harvest-ab, "
                         "--walls or --hits-long: import "
                         "seqalign_tpu_torch from the checkout in DIR (an "
                         "older tree, for an A/B)")
    ap.add_argument("--chunk-ab", action="store_true",
                    help="only time the long path at several chunk widths")
    ap.add_argument("--walk-ab", action="store_true",
                    help="only time the SW align jobs' first pairs under "
                         "both walk branches")
    ap.add_argument("--hits-long", metavar="FILE",
                    help="only run path long's job 4 and write its hit "
                         "streams to FILE")
    ap.add_argument("--sass", metavar="OLD_TREE", nargs="?", const="",
                    help="only print the kernels' SASS instruction mixes and "
                         "compare the fills with an older checkout's")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this run needs one GPU",
              file=sys.stderr)
        return 1
    if args.tree and not (args.fills or args.walks or args.gab
                          or args.harvest_ab or args.walls or args.hits_long):
        ap.error("--tree goes with --fills, --walks, --gab, --harvest-ab, "
                 "--walls or --hits-long")
    sys.path.insert(0, os.path.abspath(args.tree) if args.tree else
                    os.path.dirname(os.path.abspath(__file__)))
    import seqalign_tpu_torch as port
    from seqalign_tpu_torch.ops import build

    t_run = time.perf_counter()
    gpu = gpu_name_power()
    print(gpu, flush=True)
    if args.sass is not None:
        sass_report(args.sass, gpu)
        return 0
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    build.library()
    log(f"kernel build + load: {time.perf_counter() - t0:.2f} s")

    dev = torch.device("cuda")
    rng = np.random.default_rng(SEED)
    nw = port.NeedlemanWunsch(device="cuda")
    nwp = port.NeedlemanWunsch(port.presets.scoring_system_BLOSUM62(),
                               device="cuda")
    sw = port.SmithWaterman(device="cuda")
    swp = port.SmithWaterman(port.presets.scoring_system_BLOSUM62(),
                             device="cuda")
    if args.walk_ab:
        walk_ab(sw, swp, rng, gpu)
        return 0
    if args.chunk_ab:
        chunk_ab(rng, gpu)
        return 0
    if args.fills:
        fills_only({"nw": nw.scoring, "sw": sw.scoring,
                    "table": swp.scoring}, rng, dev, gpu)
        return 0
    if args.walks:
        walks_only({"nw": nw.scoring, "sw": sw.scoring,
                    "table": swp.scoring}, dev, gpu)
        return 0
    if args.gab:
        gab_only({"nw": nw.scoring, "sw": sw.scoring}, dev, gpu)
        return 0
    if args.harvest_ab:
        harvest_ab(gpu)
        return 0
    if args.walls:
        walls_ab(gpu)
        return 0
    if args.hits_long:
        hits_long(args.hits_long, gpu)
        return 0
    global HOST
    HOST = HostChecks()
    try:
        return run_all(args, port, t_run, gpu, dev, rng, nw, nwp, sw, swp)
    finally:
        HOST.close()


def run_all(args, port, t_run, gpu, dev, rng, nw, nwp, sw, swp) -> int:
    """Phase 1 and the paths, the host checks settled, the ``kernels``
    line and the last line."""
    split = Split().on()
    # the plain versions are bound by per-operation overhead on the host;
    # inference mode trims it (phase 1 only: the main paths run as a user
    # calls them)
    with torch.inference_mode():
        err, times, bounds, sample = phase1({"nw": nw.scoring,
                                             "sw": sw.scoring,
                                             "table": nwp.scoring}, rng, dev,
                                            split)
    split.off()
    log(f"phase 1 done in {time.perf_counter() - t_run:.1f} s")
    # the paths' split leaves the kernels unwrapped: no added synchronise
    split = Split(("plain",)).on()

    jobs: dict = {}
    launches = {}
    for path, run in (("nw", lambda: phase_nw(nw, rng, dev, gpu, jobs)),
                      ("nw_table", lambda: phase_nw_table(nwp, rng, dev, gpu,
                                                          jobs)),
                      ("sw", lambda: phase_sw(sw, rng, dev, gpu, jobs)),
                      ("sw_table", lambda: phase_sw_table(swp, rng, dev, gpu,
                                                          jobs))):
        t0 = time.perf_counter()
        port.reset_kernel_launch_counts()
        with split.block(f"path {path}"):
            run()
        launches[path] = port.kernel_launch_counts()
        counted(path, launches[path])
        log(f"path {path} done in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    with split.block("path modes"):
        mode_launches = phase_modes(rng, dev, gpu, jobs)
    launches["modes"] = {k: sum(c[k] for c in mode_launches.values())
                         for k in port.kernel_launch_counts()}
    counted("modes", launches["modes"])
    log(f"path modes done in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    port.reset_kernel_launch_counts()
    with split.block("path long"):
        with PlainGuard():
            check, long_flagged = phase_long(rng, dev, gpu, jobs, sample)
        launches["long"] = port.kernel_launch_counts()
        counted("long", launches["long"])
        check()
    log(f"path long done in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    with split.block("path vpu"):
        vpu_launches = phase_vpu(err, times, bounds)
    log(f"path vpu done in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    with split.block("path cli"):
        launches["cli"] = phase_cli(rng, dev, gpu)
    counted("cli", launches["cli"])
    log(f"path cli done in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    port.reset_kernel_launch_counts()
    with split.block("path parallel"), PlainGuard():
        phase_parallel(dev, gpu)
    launches["parallel"] = port.kernel_launch_counts()
    counted("parallel", launches["parallel"])
    log(f"path parallel done in {time.perf_counter() - t0:.1f} s")
    split.off()
    loaded = sorted(m for m in sys.modules
                    if m.split(".")[0] in ("jax", "jaxlib", "seqalign_tpu"))
    if loaded:
        raise AssertionError(f"the port loaded {loaded}")
    if args.profile:
        profile(jobs, args.profile)
    HOST.settle()
    bad = {k: v for k, v in err.items() if v}
    if bad:
        raise AssertionError(f"a kernel disagrees with its plain version: "
                             f"{bad}")

    rows = []
    for name, (counter, src, rep) in KERNELS.items():
        mode = name.partition("[")[2].rstrip("]")
        if name.startswith("vpu_chain"):
            n = vpu_launches[name][counter]
        elif name in SLICE_ROWS:
            n = launches["parallel"][counter]
        elif counter in ("nw_fill_gab", "sw_fill_gab"):
            n = launches["cli"][counter]
        elif mode.startswith("carry,nsg+neg"):  # long job 2
            n = long_flagged
        elif mode.startswith("carry") or mode == "chunked":
            n = launches["long"][counter]
        elif mode in ("", "ragged"):  # the default flags: a row a shape
            n = launches[name.split("_")[0]][counter]
        elif mode == "table":  # the one row of its launches, both shapes
            n = launched(launches[name.split("_")[0] + "_table"], counter)
        else:  # the LCS recipe runs in the modes path as nga+ngb+nmm
            n = launched(mode_launches["nga+ngb+nmm" if mode == "lcs"
                                       else mode], counter)
        rows.append({"name": name, "route": "cuda", "source": _CSRC + src,
                     "replaces": rep, "launches": n,
                     "max_abs_err": err[name], "ms": times[name][0],
                     "plain_ms": times[name][1],
                     "plain_on": "cpu" if name in HOST.rows else "cuda",
                     "bound_ms": bounds[name][0],
                     "bound_by": bounds[name][1], "library_ms": None})
    log(f"whole run: {time.perf_counter() - t_run:.1f} s")
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
