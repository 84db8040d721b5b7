// SW best scores, equality or substitution-table scoring, every combination
// of the scoring flags, on the register tiles of tile_fill.cuh (the flags
// as its MODES instantiations).
//
// Replaces seqalign_tpu/ops/pallas_dp2.py:_kernel2 (called through
// pallas_scores2 with is_sw) in SW mode, equality and packed-LUT scoring,
// with its flag branches, and the SW duties of pallas_dp.py:_kernel (the
// both-no-gaps int32 fill among them).  The fill is the one of
// nw_scores.cu with the local recurrence: every cell floors at 0, the
// boundary is all zero, and each thread keeps the best M of the valid
// cells it computes; a warp reduces them with __reduce_max_sync and its
// leader folds the result into the pair's score with one atomicMax.  The
// TPU kernel carries that max through its drift terms in f32; here it is
// an int32 register.
//
// Bound on the card: as nw_scores.cu, the integer ops per cell; the
// reduction is one shuffle tree per warp at the end.
//
// sw_scores_slice_launch is one chunk of a slice of a batch's lanes (the SW
// half of seqalign_tpu/parallel/wavefront_sp.py:_local_fill):
// tile_carry.cuh's scores-only SLICE instantiations, each slice raising
// its own best by atomicMax; the host takes the max over the slices, where
// the JAX package takes a pmax.

#include "fill_common.cuh"
#include "tile_carry.cuh"
#include "tile_fill.cuh"

FILL_ENTRY(sw_scores_launch) {
  corner = dirs = mout = nullptr;
  return tile::launch_modes<false, true, 0>(TILE_ARGS);
}

SLICE_ENTRY(sw_scores_slice_launch) {
  corner = dirs = mout = nullptr;
  return tile::slice<true, false>(TILE_SLICE_ARGS);
}
