// NW traceback walk over direction codes, a warp a pair.
//
// Replaces seqalign_tpu/ops/traceback.py:_walk_jit (the lax.scan walk
// behind nw_walk_device).  The start matrix is picked from the corner
// with preference GAP_A >= GAP_B >= MATCH (needleman_wunsch.c:53-66); each
// step reads the code of its cell, records the matrix walked and moves to
// the predecessor it names, until x or y reaches 0 or the trace `cap`.
// The codes are one plane or a long pair's chunk slabs (slab.cuh).  Like
// the scan, a DIR_FAIL code is not checked here: it shows as a 3 in the
// next step of the op trace, and the host raises on it.
//
// Bound on the card: the chain of dependent reads (each step's cell needs
// the previous code).  Read in place from device memory, a step cost a
// round trip (~0.26 us; the planes of a batch of 1-10 kb pairs are far
// larger than L2).  Here a warp walks one pair over the band of codes the
// walk can reach, staged in shared memory a block of K rows at a time,
// the next block fetched while the current one is walked (walk_band.cuh),
// so a step reads shared memory.  Since where a step goes depends only on
// the matrix it is in, the codes of the next cell's three predecessors are
// read one step ahead and the next step picks one of them: no read sits on
// the chain.  Where the next RUN cells and their predecessors lie in the
// block, RUN steps run with no test between them; a slow step, once or
// twice a block, moves to the next block, and ends or truncates the walk.
// The trace gathers in shared memory and leaves in coalesced runs, padded
// with -1 to `cap` steps.
//
// With `off`, the codes are the planes of one fill launch across widths
// (tile_fill.cuh, ops/pack.py:ragged_planes): pair j's at dirs + off[j],
// rows of max(nb, 1) + 1 lanes, cell (y, x) at row x + y - 2; one launch
// walks every pair of such a launch.

#include <cstdint>
#include <cuda_runtime.h>

#include "slab.cuh"
#include "walk_band.cuh"

namespace {

using band::GAP_A;
using band::GAP_B;
using band::MATCH;

__global__ void __launch_bounds__(32 * band::WARPS, 1)
    nw_walk_kernel(const uint8_t* __restrict__ dirs,
                   const int* __restrict__ corner, const int* __restrict__ na_,
                   const int* __restrict__ nb_, int B, slab::Geometry g,
                   int cap, int8_t* __restrict__ ops,
                   int* __restrict__ score,
                   const long long* __restrict__ off) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int j = blockIdx.x * band::WARPS + w;
  if (j >= B) return;
  const int m = corner[3 * j], ga = corner[3 * j + 1], gb = corner[3 * j + 2];
  int curr = MATCH, s = m;
  if (gb >= s) {
    curr = GAP_B;
    s = gb;
  }
  if (ga >= s) {
    curr = GAP_A;
    s = ga;
  }
  if (lane == 0) score[j] = s;
  band::Band<false> bd;
  int X, Y;
  if (off) {
    X = na_[j];
    Y = nb_[j];
    bd.P = {dirs + off[j], 0, max(Y, 1) + 1, max(X, 1), 1};
  } else {
    X = min(na_[j], g.nch * g.CA);
    Y = min(nb_[j], g.LBp - 1);
    bd.P = {dirs + j * g.pair_bytes(), static_cast<size_t>(g.Dc) * g.LBp,
            g.LBp, g.CA, g.nch};
  }
  uint8_t* mine = smem + w * band::walk_bytes(false);
  bd.buf0 = mine;
  bd.stride = band::CODES;
  bd.lane = lane;
  band::Trace tr{ops + static_cast<size_t>(j) * cap,
                 mine + band::walk_bytes(false) - band::TRACE, 0, 0, lane};
  int step = 0;
  if (cap > 0 && X > 0 && Y > 0) {
    bd.start(X, Y);
    int idx = bd.index(X, Y);
    int code = bd.cur.buf[idx];
    // the codes of the cell's MATCH, GAP_A and GAP_B predecessors
    int c0 = 0, c1 = 0, c2 = 0;
    bool ahead = bd.fast(X, Y, idx);
    if (ahead) bd.kids(idx, c0, c1, c2);
    for (;;) {
      // a run of RUN steps whose cells and their predecessors all lie in
      // cur, short of the bound and of the first column and lane: fast
      // steps with no test between them
      if (ahead && bd.runs(X, Y, idx) && step + band::RUN < cap) {
#pragma unroll
        for (int u = 0; u < band::RUN; ++u) {
          tr.put(curr);
          X -= curr != GAP_A;
          Y -= curr != GAP_B;
          idx = bd.back(idx, curr);
          const int next = band::pick(curr, c0, c1, c2);
          bd.kids(idx, c0, c1, c2);
          curr = (code >> (2 * curr)) & 3;
          code = next;
        }
        step += band::RUN;
        continue;
      }
      tr.put(curr);
      ++step;
      X -= curr != GAP_A;
      Y -= curr != GAP_B;
      idx = bd.back(idx, curr);
      const int picked = band::pick(curr, c0, c1, c2);
      int next;
      if (ahead && step < cap && bd.fast(X, Y, idx)) {
        next = picked;
        bd.kids(idx, c0, c1, c2);
      } else {  // the slow step
        if (step >= cap || X <= 0 || Y <= 0) break;
        if (ahead) {  // a predecessor read ahead, in cur
          next = picked;
        } else {
          if (!bd.holds(X, Y)) bd.enter(X, Y);
          idx = bd.index(X, Y);
          next = bd.cur.buf[idx];
        }
        ahead = bd.fast(X, Y, idx);
        if (ahead) bd.kids(idx, c0, c1, c2);
        if (tr.n >= band::K) tr.flush();
      }
      curr = (code >> (2 * curr)) & 3;
      code = next;
    }
    bd.finish();
  }
  tr.close(step, cap);
}

}  // namespace

// dirs, corner, na, nb, B, nch, Dc, LB+1, cap, ops, score, off, stream:
// dirs holds nch slabs of Dc rows a pair (one slab: Dc = LA + LB - 1), or
// with off (int64, null otherwise) each pair's plane at its own widths
extern "C" int nw_walk_launch(const void* dirs, const void* corner,
                              const void* na, const void* nb, int B, int nch,
                              int Dc, int LBp, int cap, void* ops,
                              void* score, const void* off, void* stream) {
  const slab::Geometry g{Dc - LBp + 2, Dc, LBp, nch};
  const int smem = band::WARPS * band::walk_bytes(false);
  cudaError_t e = cudaFuncSetAttribute(
      nw_walk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  nw_walk_kernel<<<(B + band::WARPS - 1) / band::WARPS, 32 * band::WARPS,
                   smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(dirs), static_cast<const int*>(corner),
      static_cast<const int*>(na), static_cast<const int*>(nb), B, g, cap,
      static_cast<int8_t*>(ops), static_cast<int*>(score),
      static_cast<const long long*>(off));
  return cudaGetLastError();
}
