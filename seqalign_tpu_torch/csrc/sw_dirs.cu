// SW fill with direction codes and the M matrix, equality or
// substitution-table scoring, every combination of the scoring flags, on
// the register tiles of tile_fill.cuh (the flags as its MODES
// instantiations).
//
// Replaces seqalign_tpu/ops/pallas_dp2.py:_dirs_kernel2 (called through
// pallas_fill_dirs2 with is_sw and emit_m, M emission at :977-999) and the
// SW duties of pallas_dp.py:_dirs_kernel: 4,097-8,192 lanes and the SW
// constrained modes, which the TPU path runs only there.
// Each valid cell writes its code byte (as nw_dirs.cu) and its M value
// into a second plane of the same skewed (B, LA+LB-1, LB+1) layout: int16
// when the wrapper's m16_safe gate (pallas_dp2.py:94-101) holds, else
// int32.  The candidate harvest reads M in place on the card; the codes
// stay there for the hit loop (sw_hits.cu) and the hit walks (sw_walk.cu).
// Under a fill schedule with planes (one launch across widths) pair j's
// codes and M go to planes at its own widths, from dirs + off[j] and
// mout + off[j] (in elements), as ops/pack.py:ragged_planes lays them
// out.  A thread's R codes and R M values of one diagonal go out as
// aligned runs (tile_fill.cuh, store_run).
//
// Bound on the card: integer issue, then the stores, 3 or 5 bytes per
// valid cell (the codes coalesce per warp, the M values too).
//
// sw_dirs_carry_launch fills one chunk of a long pair: codes into the
// chunk's slab, M into a plane of the chunk alone (harvested and freed
// before the next chunk), the boundary column carried through bin / bout,
// the pair's best raised in place; on the register tiles of
// tile_carry.cuh, a round of a pair's lanes a block, under any flags.
//
// sw_dirs_gab_launch is the fill with the three matrices for the matrix
// dump (replaces the SW emit_gab planes of dp_fill): on the same tiles,
// tile_fill.cuh's GAB instantiations, M, Ga and Gb as int32 into three
// skewed planes, the first of which the hit harvest reads as M.

#include "fill_common.cuh"
#include "tile_carry.cuh"
#include "tile_fill.cuh"

FILL_ENTRY(sw_dirs_launch) {
  corner = nullptr;
  return m16 ? tile::launch_modes<true, true, 2>(TILE_ARGS)
             : tile::launch_modes<true, true, 4>(TILE_ARGS);
}

CARRY_ENTRY(sw_dirs_carry_launch) {
  corner = nullptr;
  return m16 ? tile::carry_modes<true, 2>(TILE_CARRY_ARGS)
             : tile::carry_modes<true, 4>(TILE_CARRY_ARGS);
}

FILL_ENTRY(sw_dirs_gab_launch) {
  corner = nullptr;
  return tile::launch_modes<true, true, 4, true>(TILE_ARGS);
}
