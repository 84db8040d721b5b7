// Where a walk finds the code of cell (y, x), shared by nw_walk.cu,
// sw_walk.cu and sw_hits.cu (ops/traceback.py:slab_index is the same rule).
//
// A pair's codes are nch slabs of Dc = CA + LB - 1 rows of LB+1 lanes, one
// slab per chunk of CA columns of seq_a (the long-pair fill, CARRY in
// fill_common.cuh, in the chunk-local skew of seqalign_tpu/ops/dp.py:
// fill_chunked): cell (y, x), x >= 1 and y >= 1, is in slab
// c = (x-1) / CA at row (x - c*CA) + y - 2, lane y.  A single slab with
// CA = LA is the unchunked layout, cell (y, x) at row x + y - 2.

#pragma once

#include <cstddef>

namespace slab {

struct Geometry {
  int CA;   // columns of seq_a per slab
  int Dc;   // rows per slab, CA + LB - 1
  int LBp;  // lanes per row, LB + 1
  int nch;  // slabs per pair

  __device__ __forceinline__ size_t pair_bytes() const {
    return static_cast<size_t>(nch) * Dc * LBp;
  }
  // one slab (every short pair) needs no division
  __device__ __forceinline__ size_t at(int x, int y) const {
    const int c = nch == 1 ? 0 : (x - 1) / CA;
    return (static_cast<size_t>(c) * Dc + (x - c * CA) + y - 2) * LBp + y;
  }
};

}  // namespace slab
