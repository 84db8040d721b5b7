"""Host-side batch packing and the kernels' scoring state.

The JAX package keeps these helpers in ``seqalign_tpu/ops/dp.py``; they
are written again here on the port's own packer and scoring layers
(``io/packer.py``, ``scoring/``).  Counterparts: ``dp._next_pow2``,
``dp.pad_width``, ``dp.pad_batch``, ``dp.pack_inputs_mm``,
``dp.compact_inputs``, ``dp._present_bytes``, ``dp.mm_eligible`` and
``dp.check_valid_pairs``
(dp.py:437-610), ``pallas_dp2.m16_safe`` (pallas_dp2.py:94-101), and the
direction codes of dp.py:47.  :func:`ragged_planes` is the port's own:
the layout of code planes at each pair's widths, which one fill launch
across widths writes and ``nw_walk`` reads.

This system has no weights: its state is the :class:`ScoringConfig`.
:func:`kernel_params` turns it into the tensors the kernels read.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ..io import packer
from ..scoring.config import (ScoringConfig, UnknownCharPair, encode,
                              from_reference)

# Direction / matrix codes (enum Matrix, alignment.h:43) plus the
# traceback-fail marker; a dirs byte packs dm | dga << 2 | dgb << 4.
MATCH, GAP_A, GAP_B, DIR_FAIL = 0, 1, 2, 3
# Bits of ``KernelParams.modes``: no_start_gap_penalty, no_end_gap_penalty,
# no_gaps_in_a, no_gaps_in_b, no_mismatches (csrc/fill_common.cuh reads
# the same word).
NSG, NEG, NGA, NGB, NMM = 1, 2, 4, 8, 16


class KernelParams(NamedTuple):
    """The scoring state as the port's tensors.

    fold: (256,) uint8 case-fold LUT, on the CPU — the host packer applies
      it during the pack copy, so kernels only ever see folded codes.
    scal: (6,) int32 on the compute device — match, mismatch, gap_open,
      gap_extend, the NW floor ``sc.dp_floor(False)`` (INT_MIN +
      |min_penalty|) and the SW floor ``sc.dp_floor(True)`` (0)
      (scoring/config.py:135-141).
    sub: None for equality scoring; for substitution-table scoring the
      batch's (Ka, Kb) int32 compact table on the compute device, set per
      batch by :func:`pack_batch` (the codes index it as ``sub[a, b]``).
    im: with ``sub`` under no_mismatches, the batch's (Ka, Kb) int32 0/1
      is-match table beside it; else None (equality scoring reads
      ``a == b`` instead).
    modes: the scoring flags as a bit word, ``NSG | NEG | NGA | NGB |
      NMM``; 0 is the default recurrence.
    """

    fold: torch.Tensor
    scal: torch.Tensor
    sub: Optional[torch.Tensor] = None
    im: Optional[torch.Tensor] = None
    modes: int = 0


def mode_bits(sc) -> int:
    """The five scoring flags of ``sc`` as ``KernelParams.modes``."""
    return (NSG * bool(sc.no_start_gap_penalty)
            | NEG * bool(sc.no_end_gap_penalty)
            | NGA * bool(sc.no_gaps_in_a) | NGB * bool(sc.no_gaps_in_b)
            | NMM * bool(sc.no_mismatches))


def kernel_params(sc, device="cpu") -> KernelParams:
    """The kernels' scoring state for ``sc`` (a :class:`ScoringConfig` or
    any object :func:`~seqalign_tpu_torch.scoring.config.from_reference`
    takes).  Under no_mismatches a mismatching pair scores 0, not
    ``mismatch``, as ``scoring_lookup``'s short-circuit does
    (alignment_scoring.c:148-152): its M is pinned to the floor either
    way, and its direction codes then agree with the table mode's."""
    sc = from_reference(sc)
    fold = torch.from_numpy(np.ascontiguousarray(sc.luts()[0], np.uint8))
    mismatch = 0 if sc.no_mismatches else sc.mismatch
    scal = torch.tensor([sc.match, mismatch, sc.gap_open, sc.gap_extend,
                         sc.dp_floor(False), sc.dp_floor(True)],
                        dtype=torch.int32, device=device)
    return KernelParams(fold, scal, modes=mode_bits(sc))


def _next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


def pad_width(n: int) -> int:
    """Padded bucket width for one side: pow2 up to 4096, then multiples
    of 1024 (dp.pad_width)."""
    if n <= 4096:
        return _next_pow2(n)
    return -(-n // 1024) * 1024


def ragged_planes(na, nb) -> np.ndarray:
    """Offsets (B+1,) int64 of B code planes laid end to end, each at its
    pair's own widths: pair j's plane, ``[off[j], off[j+1])``, is the
    skewed layout of a uniform plane (cell (y, x) at row x + y - 2, lane
    y) with wa + wb - 1 rows of wb + 1 lanes, wa = max(na_j, 1) and
    wb = max(nb_j, 1).  A uniform batch of widths (LA, LB) is the case
    ``off[j] = j * (LA + LB - 1) * (LB + 1)``."""
    wa = np.maximum(np.asarray(na, np.int64), 1)
    wb = np.maximum(np.asarray(nb, np.int64), 1)
    off = np.zeros(len(wa) + 1, np.int64)
    np.cumsum((wa + wb - 1) * (wb + 1), out=off[1:])
    return off


def pad_batch(seqs, pad_to: Optional[int] = None,
              fold: Optional[np.ndarray] = None):
    """Right-pad a list of str/bytes sequences into a (B, L) uint8 array,
    translating every byte through ``fold`` in the same copy; L is
    ``pad_to`` or the longest length.  Returns (codes, int32 lengths)."""
    seql = seqs if isinstance(seqs, list) else list(seqs)
    if not seql:
        return (np.zeros((0, max(1, pad_to or 1)), np.uint8),
                np.zeros((0,), np.int32))
    L = max(1, int(packer.seq_lens(seql).max()))
    if pad_to is not None:
        L = max(pad_to, L)
    return packer.pack(seql, L, fold)


def pack_inputs_mm(params: KernelParams, seqs_a, seqs_b,
                   pad_a: Optional[int] = None,
                   pad_b: Optional[int] = None):
    """Pad and case-fold both sides through ``params.fold`` for the
    equality-scoring kernels: ``code_a == code_b`` exactly when the pair
    scores ``match``.  Returns numpy (ac, bc, na, nb)."""
    fold = params.fold.numpy()
    ac, na = pad_batch(seqs_a, pad_a, fold)
    bc, nb = pad_batch(seqs_b, pad_b, fold)
    return ac, bc, na, nb


def compact_inputs(sc: ScoringConfig, a_bytes: np.ndarray,
                   b_bytes: np.ndarray, kpad: int = 8):
    """Alphabet compaction for table scoring: map raw bytes to dense codes
    and slice the 256x256 substitution LUT (case folding and wildcards
    baked in) down to the (Ka, Kb) table of the bytes present, each side
    padded to a multiple of ``kpad``.  Returns numpy (ac, bc, subK, imK),
    codes int32 (dp.compact_inputs)."""
    _, sub, ismatch, _ = sc.luts()
    ua = _present_bytes(a_bytes)
    ub = _present_bytes(b_bytes)
    Ka = -(-len(ua) // kpad) * kpad
    Kb = -(-len(ub) // kpad) * kpad
    mapa = np.zeros(256, np.int32)
    mapa[ua] = np.arange(len(ua), dtype=np.int32)
    mapb = np.zeros(256, np.int32)
    mapb[ub] = np.arange(len(ub), dtype=np.int32)
    subK = np.zeros((Ka, Kb), np.int32)
    subK[: len(ua), : len(ub)] = sub[np.ix_(ua, ub)]
    imK = np.zeros((Ka, Kb), np.int32)
    imK[: len(ua), : len(ub)] = ismatch[np.ix_(ua, ub)]
    if np.abs(subK).max(initial=0) >= (1 << 24):
        raise ValueError("substitution scores must be < 2^24 in magnitude")
    return mapa[a_bytes], mapb[b_bytes], subK, imK


def _present_bytes(arr: np.ndarray) -> np.ndarray:
    """Sorted unique byte values by a 256-slot presence scatter ([0] for
    empty input)."""
    present = np.zeros(256, bool)
    present[arr.reshape(-1)] = True
    u = np.flatnonzero(present)
    return u if len(u) else np.array([0], np.int64)


def pack_batch(sc: ScoringConfig, params: KernelParams, seqs_a, seqs_b,
               pad_a: int, pad_b: int):
    """Pack one batch for the fill kernels: uint8 codes padded to
    (pad_a, pad_b) and the true lengths, numpy, plus the batch's
    ``KernelParams``.  Equality scoring folds the bytes (no table);
    table scoring compacts both sides and carries ``subK`` (and, under
    no_mismatches, ``imK``) on the params' device."""
    if mm_eligible(sc):
        return (*pack_inputs_mm(params, seqs_a, seqs_b, pad_a, pad_b),
                params)
    a, na = pad_batch(seqs_a, pad_a)
    b, nb = pad_batch(seqs_b, pad_b)
    ac, bc, subK, imK = compact_inputs(sc, a, b)
    dev = params.scal.device
    sub = torch.from_numpy(subK).to(dev)
    im = torch.from_numpy(imK).to(dev) if params.modes & NMM else None
    return (ac.astype(np.uint8), bc.astype(np.uint8), na, nb,
            params._replace(sub=sub, im=im))


def m16_safe(sc: ScoringConfig, la: int, lb: int) -> bool:
    """True when every SW M value of an (la, lb) fill fits int16: M lies
    in [0, max(true max step, 0) * steps] (pallas_dp2.m16_safe).  A path
    gains on at most min(la, lb) MATCH steps while no gap step is positive
    (free end gaps add 0), and on up to la + lb steps once one is, which
    gap_open > 0 allows."""
    _, tmx = sc.true_penalty_bounds()
    gains = max(sc.gap_open + sc.gap_extend, sc.gap_extend) > 0
    steps = la + lb if gains else min(la, lb)
    return max(int(tmx), 0) * steps < 32000


def mm_eligible(sc: ScoringConfig) -> bool:
    """Pure match/mismatch scoring on fold-equality: no swaps, no
    wildcards (alignment_scoring.c:76-93 with substitution_matrix ==
    NULL)."""
    return bool(sc.use_match_mismatch and not sc._swap_set.any()
                and not sc._wild_set.any())


def check_valid_pairs(sc: ScoringConfig, seq_a, seq_b):
    """The reference's unknown-pair abort (alignment_scoring.c:179-181),
    checked on the unique-character cross product."""
    _, _, _, valid = sc.luts()
    if valid.all():
        return
    ua = np.unique(encode(seq_a))
    ub = np.unique(encode(seq_b))
    if len(ua) and len(ub):
        bad = ~valid[np.ix_(ua, ub)]
        if bad.any():
            i, j = np.argwhere(bad)[0]
            fold = sc.luts()[0]
            raise UnknownCharPair(
                "Unknown character pair (%c,%c) and match/mismatch have not "
                "been set" % (chr(fold[ua[i]]), chr(fold[ub[j]]))
            )
