// SW fill with direction codes and the M matrix, default flags, equality
// or substitution-table scoring.
//
// Replaces seqalign_tpu/ops/pallas_dp2.py:_dirs_kernel2 (called through
// pallas_fill_dirs2 with is_sw and emit_m, M emission at :977-999) and the
// SW default-flag duty of pallas_dp.py:_dirs_kernel at 4,097-8,192 lanes.
// Each valid cell writes its code byte (as nw_dirs.cu) and its M value
// into a second plane of the same skewed (B, LA+LB-1, LB+1) layout: int16
// when the wrapper's m16_safe gate (pallas_dp2.py:94-101) holds, else
// int32.  The candidate harvest reads M in place on the card; the codes
// stay there for the hit loop (sw_hits.cu) and the hit walks (sw_walk.cu).
//
// Bound on the card: the stores, 3 or 5 bytes per valid cell (the codes
// coalesce per warp, the M values too), and the barrier per diagonal.

#include "fill_common.cuh"

FILL_ENTRY(sw_dirs_launch) {
  if (m16) {
    return fill::launch_mode<true, true, 2>(
        ac, bc, na, nb, scal, sub, Kb, sub_n, table_smem, B, LA, LB, scores,
        nullptr, dirs, mout, scratch, stream);
  }
  return fill::launch_mode<true, true, 4>(
      ac, bc, na, nb, scal, sub, Kb, sub_n, table_smem, B, LA, LB, scores,
      nullptr, dirs, mout, scratch, stream);
}
