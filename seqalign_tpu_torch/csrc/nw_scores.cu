// NW scores, equality or substitution-table scoring, every combination of
// the scoring flags, on the register tiles of tile_fill.cuh (the flags as
// its MODES instantiations).
//
// Replaces seqalign_tpu/ops/pallas_dp2.py:_kernel2 (called through
// pallas_scores2) in NW mode, equality and packed-LUT scoring, with its
// flag branches, and the NW duties of pallas_dp.py:_kernel (alphabets past
// the packed-LUT gate, and the both-no-gaps configs that kernel serves in
// int32 for sentinel parity: this fill is int32 throughout).  The TPU
// kernel chains pairs along 512-lane rows, removes drift to stay exact in
// f32, sizes its blocks to VMEM and bakes the table into select planes; on
// the H100 the fill is native int32, a warp a strip of lanes with the
// tile in registers (tile_fill.cuh), and the table sits in shared memory,
// so none of that is needed.  Only the corner cell is kept: the kernel
// writes 16 bytes per pair.
//
// Bound on the card: integer issue, the cells' int32 instructions (a
// scores cell is 10 on the default flags); no memory traffic to speak of.
//
// nw_scores_slice_launch is one chunk of a slice of a batch's lanes, the
// scores alone (replaces the per-device fill of seqalign_tpu/parallel/
// wavefront_sp.py:_local_fill under shard_map, which passes one lane to
// the next device each diagonal): tile_carry.cuh's scores-only SLICE
// instantiations, the boundary column through bin / bout, the edge row of
// the slice before in and the slice's own out, the corner written by the
// slice that holds lane nb in the chunk that holds na.

#include "fill_common.cuh"
#include "tile_carry.cuh"
#include "tile_fill.cuh"

FILL_ENTRY(nw_scores_launch) {
  dirs = mout = nullptr;
  return tile::launch_modes<false, false, 0>(TILE_ARGS);
}

SLICE_ENTRY(nw_scores_slice_launch) {
  dirs = mout = nullptr;
  return tile::slice<false, false>(TILE_SLICE_ARGS);
}

extern "C" const char* nw_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
