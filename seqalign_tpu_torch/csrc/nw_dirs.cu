// NW fill with direction codes, equality or substitution-table scoring,
// every combination of the scoring flags, on the register tiles of
// tile_fill.cuh (the flags as its MODES instantiations).
//
// Replaces seqalign_tpu/ops/pallas_dp2.py:_dirs_kernel2 (called through
// pallas_fill_dirs2) in NW mode with its constrained modes, and the NW
// duties of pallas_dp.py:_dirs_kernel (4,097-8,192 lanes, other
// alphabets).  Same fill as nw_scores.cu; each valid cell also writes one
// byte, dm | dga << 2 | dgb << 4, chosen with the reference traceback's
// guard/equality/priority order (GAP_A > GAP_B > MATCH,
// alignment.c:311-327), into the skewed (B, LA+LB-1, LB+1) layout of
// seqalign_tpu/ops/traceback.py (cell (y, x) at [x+y-2][y]).  A thread's
// lanes on one diagonal are neighbouring bytes of one row, stored at once
// (tile_fill.cuh, store_run), and a warp's stores coalesce.
//
// Bound on the card: integer issue (the codes' compares triple a cell's
// instructions), then the code stores, one byte per valid cell.  Cells
// outside the valid band are never written; the walk never reads them.
//
// nw_dirs_carry_launch fills one chunk of a long pair (replaces the
// chunked pallas_dp.py:_dirs_kernel that fill_dirs_long drives): the
// boundary column comes in as bin and the chunk's last column goes out as
// bout, the codes land in the chunk's slab, and the corner is written by
// the chunk that holds x = na; on the register tiles of tile_carry.cuh, a
// round of a pair's lanes a block, under any flags.
//
// nw_dirs_gab_launch is the same fill with the three matrices for the
// matrix dump (replaces the emit_gab planes of seqalign_tpu/ops/dp.py:
// dp_fill, a lax.scan): on the same tiles, tile_fill.cuh's GAB
// instantiations, M, Ga and Gb as int32 into three skewed planes beside
// the codes, 13 bytes a cell, which bound it (bytes).
//
// nw_dirs_slice_launch is one chunk of a slice of one long pair's lanes
// (replaces seqalign_tpu/parallel/wavefront_sp.py:_sp_chunk_dirs, the
// per-device codes fill under shard_map): tile_carry.cuh's SLICE
// instantiations with codes, written at slab.cuh's rule into the chunk's
// slab at the slice's lanes, so that nw_walk reads the slices' parts as one
// slab.

#include "fill_common.cuh"
#include "tile_carry.cuh"
#include "tile_fill.cuh"

FILL_ENTRY(nw_dirs_launch) {
  mout = nullptr;
  return tile::launch_modes<true, false, 0>(TILE_ARGS);
}

CARRY_ENTRY(nw_dirs_carry_launch) {
  mout = nullptr;
  return tile::carry_modes<false, 0>(TILE_CARRY_ARGS);
}

SLICE_ENTRY(nw_dirs_slice_launch) {
  mout = nullptr;
  return tile::slice<false, true>(TILE_SLICE_ARGS);
}

FILL_ENTRY(nw_dirs_gab_launch) {
  return tile::launch_modes<true, false, 4, true>(TILE_ARGS);
}
