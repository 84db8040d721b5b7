// SW candidate walks over direction codes, a warp a walk.
//
// Replaces seqalign_tpu/ops/traceback.py:sw_walk_jit (the lax.scan behind
// SwDeviceWalker).  Walk w starts in pair jw[w] at cell (y0, x0) with
// score s0 and steps back until its score reaches 0 (traceback.py:
// 624-650): each step reads the code of its cell, clamped to x, y >= 1
// (one plane, or a long pair's chunk slabs: slab.cuh), records the matrix
// walked, and subtracts the step's penalty, the equality score or
// sub[a, b] for a MATCH step (on the letters of the fill), gap_extend for
// a gap that goes on and gap_open + gap_extend for one that opens, and
// nothing under free end gaps (neg) for a GAP_A step on the pair's last
// column x == na or a GAP_B step on its last row y == nb (alignment.c:
// 264-307; the TPU walk lacks this rule because the JAX package walks
// constrained SW on the host).  The score wraps as unsigned arithmetic
// does.  No overlap mask: paths depend only on the codes; the aligner walks
// the hits sw_hits.cu found, whose masking and abort ran there.  A
// DIR_FAIL code is not checked here: it shows as a 3 in the next step, and
// the host raises on it.
//
// Bound on the card: the chain of dependent reads (each step's cell needs
// the previous code, and its penalty the cell's letters and then the
// table).  Read in place, a step cost a device-memory round trip and two
// more loads on a MATCH.  Here a warp walks one hit over the band of codes
// the walk can reach, with the letters of the same columns and rows,
// staged in shared memory a block of K rows at a time, the next block
// fetched while the current one is walked (walk_band.cuh); a block of
// walks stages the substitution table once when it fits TABLE_SMEM.  As in
// nw_walk.cu, the codes and letters of the next cell's three predecessors
// are read one step ahead, so that no read sits on the chain, and RUN
// steps run with no test between them where their cells keep their
// predecessors in the block; there the score is kept without a branch, a
// step counting while the score it starts from is positive, and the walk
// ends after the run once it ran out.  A slow step, once or twice a block,
// clamps the cell, moves to the next block, and ends or truncates the
// walk.  The trace gathers in shared memory and leaves in coalesced runs,
// padded with -1 to `cap` steps.
//
// With `off`, the codes are the planes of one fill launch across widths
// (tile_fill.cuh, ops/pack.py:ragged_planes): pair j's at dirs + off[j],
// rows of max(nb, 1) + 1 lanes, cell (y, x) at row x + y - 2.

#include <cstdint>
#include <cuda_runtime.h>

#include "slab.cuh"
#include "walk_band.cuh"

namespace {

using band::GAP_A;
using band::GAP_B;
using band::MATCH;

// The substitution table in shared memory up to this many bytes, else
// read where it lies (a table of every byte value takes 256 KB).
constexpr int TABLE_SMEM = 64 * 1024;
enum { EQUALITY = 0, TABLE_SHARED = 1, TABLE_GLOBAL = 2 };

// A MATCH step's penalty on the letters ai, bi.
template <int TAB>
__device__ __forceinline__ int match_pen(int ai, int bi, int match,
                                         int mismatch, const int* tab,
                                         const int* __restrict__ sub,
                                         int Kb) {
  return TAB == EQUALITY       ? (ai == bi ? match : mismatch)
         : TAB == TABLE_SHARED ? tab[ai * Kb + bi]
                               : __ldg(sub + ai * Kb + bi);
}

template <int TAB>
__global__ void __launch_bounds__(32 * band::WARPS, 1)
    sw_walk_kernel(const uint8_t* __restrict__ dirs,
                   const uint8_t* __restrict__ ac,
                   const uint8_t* __restrict__ bc,
                   const int* __restrict__ scal, const int* __restrict__ sub,
                   int Kb, int sub_n, const int* __restrict__ na,
                   const int* __restrict__ nb, int neg,
                   const int* __restrict__ jw, const int* __restrict__ x0,
                   const int* __restrict__ y0, const int* __restrict__ s0,
                   int W, int B, int LA, int LB, slab::Geometry g, int cap,
                   int8_t* __restrict__ ops,
                   const long long* __restrict__ off) {
  extern __shared__ __align__(16) uint8_t smem[];
  int* tab =
      reinterpret_cast<int*>(smem + band::WARPS * band::walk_bytes(true));
  if (TAB == TABLE_SHARED) {
    for (int i = threadIdx.x; i < sub_n; i += blockDim.x) tab[i] = sub[i];
    __syncthreads();
  }
  const int lane = threadIdx.x & 31, wi = threadIdx.x >> 5;
  const int w = blockIdx.x * band::WARPS + wi;
  if (w >= W) return;
  uint8_t* mine = smem + wi * band::walk_bytes(true);
  band::Trace tr{ops + static_cast<size_t>(w) * cap,
                 mine + band::walk_bytes(true) - band::TRACE, 0, 0, lane};
  const int j = jw[w];
  int step = 0;
  if (j >= 0 && j < B) {
    const int match = scal[0], mismatch = scal[1], ge = scal[3];
    const int gop = static_cast<int>(static_cast<unsigned>(scal[2]) +
                                     static_cast<unsigned>(ge));
    const int naj = na[j], nbj = nb[j];
    band::Band<true> bd;
    if (off)  // the pair's own plane: one slab of its widths
      bd.P = {dirs + off[j], 0, max(nbj, 1) + 1, g.CA, 1};
    else
      bd.P = {dirs + j * g.pair_bytes(), static_cast<size_t>(g.Dc) * g.LBp,
              g.LBp, g.CA, g.nch};
    bd.a = ac + static_cast<size_t>(j) * LA;
    bd.b = bc + static_cast<size_t>(j) * LB;
    bd.buf0 = mine;
    bd.stride = band::CODES + 2 * band::LETTERS;
    bd.lane = lane;
    int X = min(x0[w], LA), Y = min(y0[w], LB), cs = s0[w], curr = MATCH;
    if (cap > 0 && cs > 0) {
      // the cell read is (y, x) clamped to x, y >= 1: its code, letters
      // and MATCH penalty
      int Xc = max(X, 1), Yc = max(Y, 1);
      bd.start(Xc, Yc);
      int idx = bd.index(Xc, Yc);
      int code = bd.cur.buf[idx];
      int ai = bd.letter_a(Xc), bi = bd.letter_b(Yc);
      int mp = match_pen<TAB>(ai, bi, match, mismatch, tab, sub, Kb);
      // read one step ahead where the cell's predecessors lie in cur:
      // their codes, and the letters a[x - 2] and b[y - 2]
      int c0 = 0, c1 = 0, c2 = 0, ap = 0, bp = 0;
      bool ahead = bd.fast(X, Y, idx);
      if (ahead) {
        bd.kids(idx, c0, c1, c2);
        ap = bd.letter_a(X - 1);
        bp = bd.letter_b(Y - 1);
      }
      for (;;) {
        // a run of RUN fast steps (as nw_walk.cu's), the score kept
        // without a branch: a step counts while the score it starts
        // from is positive, and the walk ends after the run if it ran out
        if (ahead && bd.runs(X, Y, idx) && step + band::RUN < cap) {
          bool alive = true;
#pragma unroll
          for (int u = 0; u < band::RUN; ++u) {
            tr.put(curr);
            step += alive;
            const int nxt = (code >> (2 * curr)) & 3;
            const bool free_end =
                neg && (curr == GAP_A ? X == naj : Y == nbj);
            const int pen = curr == MATCH ? mp
                            : free_end    ? 0
                            : nxt == curr ? ge
                                          : gop;
            const int dx = curr != GAP_A, dy = curr != GAP_B;
            X -= dx;
            Y -= dy;
            idx = bd.back(idx, curr);
            code = band::pick(curr, c0, c1, c2);
            ai = dx ? ap : ai;
            bi = dy ? bp : bi;
            mp = match_pen<TAB>(ai, bi, match, mismatch, tab, sub, Kb);
            bd.kids(idx, c0, c1, c2);
            ap = bd.letter_a(X - 1);
            bp = bd.letter_b(Y - 1);
            cs = static_cast<int>(static_cast<unsigned>(cs) -
                                  static_cast<unsigned>(pen));
            alive = alive && cs > 0;
            curr = nxt;
          }
          if (!alive) break;
          continue;
        }
        tr.put(curr);
        ++step;
        const int nxt = (code >> (2 * curr)) & 3;
        const bool free_end = neg && (curr == GAP_A ? X == naj : Y == nbj);
        const int pen = curr == MATCH ? mp
                        : free_end    ? 0
                        : nxt == curr ? ge
                                      : gop;
        const int dx = curr != GAP_A, dy = curr != GAP_B;
        X -= dx;
        Y -= dy;
        idx = bd.back(idx, curr);
        if (ahead) {  // a predecessor read ahead, in cur
          code = band::pick(curr, c0, c1, c2);
          ai = dx ? ap : ai;
          bi = dy ? bp : bi;
        } else {  // the cell clamped; a new block, or a new slab
          Xc = max(X, 1);
          Yc = max(Y, 1);
          if (!bd.holds(Xc, Yc)) bd.enter(Xc, Yc);
          idx = bd.index(Xc, Yc);
          code = bd.cur.buf[idx];
          ai = bd.letter_a(Xc);
          bi = bd.letter_b(Yc);
        }
        mp = match_pen<TAB>(ai, bi, match, mismatch, tab, sub, Kb);
        ahead = bd.fast(X, Y, idx);
        if (ahead) {
          bd.kids(idx, c0, c1, c2);
          ap = bd.letter_a(X - 1);
          bp = bd.letter_b(Y - 1);
        }
        if (tr.n >= band::K) tr.flush();
        cs = static_cast<int>(static_cast<unsigned>(cs) -
                              static_cast<unsigned>(pen));
        curr = nxt;
        if (cs <= 0 || step >= cap) break;
      }
      bd.finish();
    }
  }
  tr.close(step, cap);
}

template <int TAB>
int launch(int smem, int blocks, cudaStream_t stream, const uint8_t* dirs,
           const uint8_t* ac, const uint8_t* bc, const int* scal,
           const int* sub, int Kb, int sub_n, const int* na, const int* nb,
           int neg, const int* jw, const int* x0, const int* y0,
           const int* s0, int W, int B, int LA, int LB, slab::Geometry g,
           int cap, int8_t* ops, const long long* off) {
  cudaError_t e = cudaFuncSetAttribute(
      sw_walk_kernel<TAB>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  sw_walk_kernel<TAB><<<blocks, 32 * band::WARPS, smem, stream>>>(
      dirs, ac, bc, scal, sub, Kb, sub_n, na, nb, neg, jw, x0, y0, s0, W, B,
      LA, LB, g, cap, ops, off);
  return cudaGetLastError();
}

}  // namespace

// dirs, ac, bc, scal, sub (or null), Kb, sub_n (the table's entries), na,
// nb, neg, jw, x0, y0, s0, W, B, LA, LB, nch, Dc, cap, ops, stream, off:
// dirs holds nch slabs of Dc rows a pair (one slab: Dc = LA + LB - 1), or
// with off (int64, null otherwise) each pair's plane at its own widths
extern "C" int sw_walk_launch(const void* dirs, const void* ac,
                              const void* bc, const void* scal,
                              const void* sub, int Kb, int sub_n,
                              const void* na, const void* nb, int neg,
                              const void* jw, const void* x0, const void* y0,
                              const void* s0, int W, int B, int LA, int LB,
                              int nch, int Dc, int cap, void* ops,
                              void* stream, const void* off) {
  const slab::Geometry g{Dc - LB + 1, Dc, LB + 1, nch};
  const int tab = !sub ? EQUALITY
                  : 4 * static_cast<long long>(sub_n) <= TABLE_SMEM
                      ? TABLE_SHARED
                      : TABLE_GLOBAL;
  const int smem = band::WARPS * band::walk_bytes(true) +
                   (tab == TABLE_SHARED ? 4 * sub_n : 0);
  const int blocks = (W + band::WARPS - 1) / band::WARPS;
  auto run = tab == EQUALITY       ? launch<EQUALITY>
             : tab == TABLE_SHARED ? launch<TABLE_SHARED>
                                   : launch<TABLE_GLOBAL>;
  return run(smem, blocks, static_cast<cudaStream_t>(stream),
             static_cast<const uint8_t*>(dirs),
             static_cast<const uint8_t*>(ac), static_cast<const uint8_t*>(bc),
             static_cast<const int*>(scal), static_cast<const int*>(sub), Kb,
             sub_n, static_cast<const int*>(na), static_cast<const int*>(nb),
             neg, static_cast<const int*>(jw), static_cast<const int*>(x0),
             static_cast<const int*>(y0), static_cast<const int*>(s0), W, B,
             LA, LB, g, cap, static_cast<int8_t*>(ops),
             static_cast<const long long*>(off));
}
