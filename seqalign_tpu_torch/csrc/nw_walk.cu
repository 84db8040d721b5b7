// NW traceback walk over direction codes, one thread per pair.
//
// Replaces seqalign_tpu/ops/traceback.py:_walk_jit (the lax.scan walk
// behind nw_walk_device).  The start matrix is picked from the corner
// with preference GAP_A >= GAP_B >= MATCH (needleman_wunsch.c:53-66); each
// step reads one code byte in place from the skewed dirs tensor, records
// the matrix walked and moves to the predecessor it names.  The codes are
// one plane or a long pair's chunk slabs (slab.cuh).  Like the scan,
// a DIR_FAIL code is not checked here: it shows as a 3 in the next step
// of the op trace, and the host raises on it.
//
// Bound on the card: the dependent chain of byte loads (each step's
// address needs the previous code), so one walk is latency bound; a batch
// hides latency only across pairs.  The trace is written as int8 padded
// with -1 to `cap` steps, so only ~1 byte per step leaves the card.
//
// With `off`, the codes are the planes of one fill launch across widths
// (fill_common.cuh, ops/pack.py:ragged_planes): pair j's at dirs + off[j],
// rows of max(nb, 1) + 1 lanes, cell (y, x) at row x + y - 2; one launch
// walks every pair of such a launch.

#include <cstdint>
#include <cuda_runtime.h>

#include "slab.cuh"

namespace {

enum { MATCH = 0, GAP_A = 1, GAP_B = 2 };

__global__ void nw_walk_kernel(const uint8_t* __restrict__ dirs,
                               const int* __restrict__ corner,
                               const int* __restrict__ na_,
                               const int* __restrict__ nb_, int B,
                               slab::Geometry g, int cap,
                               int8_t* __restrict__ ops,
                               int* __restrict__ score,
                               const long long* __restrict__ off) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
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
  score[j] = s;
  int X, Y, lanes = 0;
  const uint8_t* dj;
  if (off) {
    X = na_[j];
    Y = nb_[j];
    lanes = max(Y, 1) + 1;
    dj = dirs + off[j];
  } else {
    X = min(na_[j], g.nch * g.CA);
    Y = min(nb_[j], g.LBp - 1);
    dj = dirs + j * g.pair_bytes();
  }
  int8_t* oj = ops + static_cast<size_t>(j) * cap;
  int step = 0;
  for (; step < cap && X > 0 && Y > 0; ++step) {
    const int code =
        dj[off ? static_cast<size_t>(X + Y - 2) * lanes + Y : g.at(X, Y)];
    oj[step] = static_cast<int8_t>(curr);
    const int nxt = (code >> (2 * curr)) & 3;
    if (curr != GAP_A) --X;
    if (curr != GAP_B) --Y;
    curr = nxt;
  }
  for (; step < cap; ++step) oj[step] = -1;
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
  const int threads = 128;
  nw_walk_kernel<<<(B + threads - 1) / threads, threads, 0,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(dirs), static_cast<const int*>(corner),
      static_cast<const int*>(na), static_cast<const int*>(nb), B, g, cap,
      static_cast<int8_t*>(ops), static_cast<int*>(score),
      static_cast<const long long*>(off));
  return cudaGetLastError();
}
