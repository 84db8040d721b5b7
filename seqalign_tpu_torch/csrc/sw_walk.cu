// SW candidate walks over direction codes, one thread per walk.
//
// Replaces seqalign_tpu/ops/traceback.py:sw_walk_jit (the lax.scan behind
// SwDeviceWalker).  Walk w starts in pair jw[w] at cell (y0, x0) with
// score s0 and steps back until its score reaches 0 (traceback.py:
// 624-650): each step reads one code byte in place from the skewed dirs
// tensor (one plane, or a long pair's chunk slabs: slab.cuh), records the
// matrix walked, and subtracts the step's penalty,
// the equality score or sub[a, b] for a MATCH step (the codes of the fill
// are read in place too), gap_extend for a gap that goes on and
// gap_open + gap_extend for one that opens, and nothing under free end
// gaps (neg) for a GAP_A step on the pair's last column x == na or a GAP_B
// step on its last row y == nb (alignment.c:264-307; the TPU walk lacks
// this rule because the JAX package walks constrained SW on the host).  No
// overlap mask: paths depend
// only on the codes; the aligner walks the hits sw_hits.cu found, whose
// masking and abort ran there.  A DIR_FAIL code is not checked here: it
// shows as a 3 in the next step, and the host raises on it.
//
// Bound on the card: the dependent chain of byte loads (each step's
// address needs the previous code), so one walk is latency bound; a batch
// of walks hides latency only across walks.  Only the int8 trace, padded
// with -1 to `cap` steps, leaves the card.
//
// With `off`, the codes are the planes of one fill launch across widths
// (fill_common.cuh, ops/pack.py:ragged_planes): pair j's at dirs + off[j],
// rows of max(nb, 1) + 1 lanes, cell (y, x) at row x + y - 2.

#include <cstdint>
#include <cuda_runtime.h>

#include "slab.cuh"

namespace {

enum { MATCH = 0, GAP_A = 1, GAP_B = 2 };

__global__ void sw_walk_kernel(const uint8_t* __restrict__ dirs,
                               const uint8_t* __restrict__ ac,
                               const uint8_t* __restrict__ bc,
                               const int* __restrict__ scal,
                               const int* __restrict__ sub, int Kb,
                               const int* __restrict__ na,
                               const int* __restrict__ nb, int neg,
                               const int* __restrict__ jw,
                               const int* __restrict__ x0,
                               const int* __restrict__ y0,
                               const int* __restrict__ s0, int W, int B,
                               int LA, int LB, slab::Geometry g, int cap,
                               int8_t* __restrict__ ops,
                               const long long* __restrict__ off) {
  const int w = blockIdx.x * blockDim.x + threadIdx.x;
  if (w >= W) return;
  int8_t* ow = ops + static_cast<size_t>(w) * cap;
  const int j = jw[w];
  int step = 0;
  if (j >= 0 && j < B) {
    const int match = scal[0], mismatch = scal[1], ge = scal[3];
    const int gop = static_cast<int>(static_cast<unsigned>(scal[2]) +
                                     static_cast<unsigned>(ge));
    const int naj = na[j], nbj = nb[j];
    slab::Geometry gj = g;
    const uint8_t* dj;
    if (off) {  // the pair's own plane: one slab of its widths
      gj.LBp = max(nbj, 1) + 1;
      gj.nch = 1;
      dj = dirs + off[j];
    } else {
      dj = dirs + j * g.pair_bytes();
    }
    const uint8_t* aj = ac + static_cast<size_t>(j) * LA;
    const uint8_t* bj = bc + static_cast<size_t>(j) * LB;
    int X = min(x0[w], LA), Y = min(y0[w], LB), cs = s0[w], curr = MATCH;
    for (; step < cap && cs > 0; ++step) {
      const int Xc = max(X, 1), Yc = max(Y, 1);
      const int code = dj[gj.at(Xc, Yc)];
      const int nxt = (code >> (2 * curr)) & 3;
      int pen;
      if (curr == MATCH) {
        const int ai = aj[Xc - 1], bi = bj[Yc - 1];
        pen = sub ? __ldg(sub + ai * Kb + bi) : (ai == bi ? match : mismatch);
      } else if (neg && (curr == GAP_A ? X == naj : Y == nbj)) {
        pen = 0;
      } else {
        pen = nxt == curr ? ge : gop;
      }
      ow[step] = static_cast<int8_t>(curr);
      cs = static_cast<int>(static_cast<unsigned>(cs) -
                            static_cast<unsigned>(pen));
      if (curr != GAP_A) --X;
      if (curr != GAP_B) --Y;
      curr = nxt;
    }
  }
  for (; step < cap; ++step) ow[step] = -1;
}

}  // namespace

// dirs, ac, bc, scal, sub (or null), Kb, na, nb, neg, jw, x0, y0, s0, W, B,
// LA, LB, nch, Dc, cap, ops, stream, off: dirs holds nch slabs of Dc rows
// a pair (one slab: Dc = LA + LB - 1), or with off (int64, null
// otherwise) each pair's plane at its own widths
extern "C" int sw_walk_launch(const void* dirs, const void* ac,
                              const void* bc, const void* scal,
                              const void* sub, int Kb, const void* na,
                              const void* nb, int neg, const void* jw,
                              const void* x0, const void* y0, const void* s0,
                              int W, int B, int LA, int LB, int nch, int Dc,
                              int cap, void* ops, void* stream,
                              const void* off) {
  const int threads = 128;
  const slab::Geometry g{Dc - LB + 1, Dc, LB + 1, nch};
  sw_walk_kernel<<<(W + threads - 1) / threads, threads, 0,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(dirs), static_cast<const uint8_t*>(ac),
      static_cast<const uint8_t*>(bc), static_cast<const int*>(scal),
      static_cast<const int*>(sub), Kb, static_cast<const int*>(na),
      static_cast<const int*>(nb), neg, static_cast<const int*>(jw),
      static_cast<const int*>(x0), static_cast<const int*>(y0),
      static_cast<const int*>(s0), W, B, LA, LB, g, cap,
      static_cast<int8_t*>(ops), static_cast<const long long*>(off));
  return cudaGetLastError();
}
