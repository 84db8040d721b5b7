// NW scores, equality or substitution-table scoring, every combination of
// the scoring flags (fill_common.cuh).
//
// Replaces seqalign_tpu/ops/pallas_dp2.py:_kernel2 (called through
// pallas_scores2) in NW mode, equality and packed-LUT scoring, with its
// flag branches, and the NW duties of pallas_dp.py:_kernel (alphabets past
// the packed-LUT gate, and the both-no-gaps configs that kernel serves in
// int32 for sentinel parity: this fill is int32 throughout).  The TPU
// kernel chains pairs along 512-lane rows, removes drift to stay exact in
// f32, sizes its blocks to VMEM and bakes the table into select planes; on
// the H100 the fill is native int32 with
// one block per pair (fill_common.cuh) and the table sits in shared
// memory, so none of that is needed.  Only the corner cell is kept: the
// rolling diagonals are the whole working set, and the kernel writes 16
// bytes per pair.
//
// Bound on the card: the per-diagonal barrier and integer issue rate,
// not memory (the working set of a 512-wide pair is 18 KB of shared
// memory).  Pairs wider than 6455 lanes keep their diagonals in a global
// scratch buffer (L1/L2 resident per block) instead.

#include "fill_common.cuh"

FILL_ENTRY(nw_scores_launch) {
  return fill::launch_mode<false, false, 0>(
      ac, bc, na, nb, scal, sub, im, modes, Kb, sub_n, table_smem, B, LA,
      LB, scores, corner, nullptr, nullptr, scratch, stream, SCHED_ARGS);
}

extern "C" const char* nw_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
