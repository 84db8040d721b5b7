// SW hit streams on the card: the reference's best-first hit loop with its
// overlap mask and partial-walk abort, one warp per pair that pre-walks a
// window of 32 candidates at once.
//
// Replaces the host loop of seqalign_tpu/ops/traceback.py:SwHitIterator.fetch
// (:376-392, walking with _follow_hit :281-324), which the JAX package runs
// on the host over device-walked paths (smith_waterman.c:131-277).  Pair j's
// candidates cand_flat/cand_score[lo[j] .. hi[j]) come sorted in the
// iterator's order (score desc, x asc, flat asc), flat = y * (na+1) + x, of
// type F: int32 when every pair of the launch has (na+1)(nb+1) < 2^31 (a
// pair past that sets nhits[j] = -1), int64 otherwise (a long pair's flats
// pass 2^31 past ~46 kb x 46 kb); the mask is indexed by flats of that
// type.  In the serial order, a candidate whose cell is marked is skipped;
// one whose MATCH predecessor (y-1, x-1) is marked marks its cell and is
// skipped, reading no code (its walk would abort at the first step); any
// other walks back over the codes, marking each cell it enters, and either
// meets a marked cell (an abort, whose marks stay) or reaches score 0 (a
// hit).  The first k hits' (flat, score) are written and their count goes
// to nhits[j]; fewer than k means the candidates ran out.  A step's penalty
// is that of sw_walk.cu, the free-end-gap rule (neg) included.  A DIR_FAIL
// code, or a walk that leaves the matrix, sets nhits[j] = -1 when the
// serial order reaches that step.  The paths of the hits are traced by
// sw_walk.cu afterwards.  The codes are one plane or a long pair's chunk
// slabs (slab.cuh).
//
// The mask is one bit per cell (y, x), 0 <= y <= LB, 0 <= x <= LA (the
// pairs' global width), in MW words: in dynamic shared memory when it fits
// (pairs up to ~1,360^2 cells), zeroed by the warp, else in a zeroed global
// buffer.
//
// With `off`, the codes are the planes of one fill launch across widths
// (fill_common.cuh, ops/pack.py:ragged_planes): pair j's at dirs + off[j],
// rows of max(nb, 1) + 1 lanes, cell (y, x) at row x + y - 2, the address
// rule of one plane.  Each pair's mask then has its own (nb+1)(na+1) bits:
// in the block's dynamic shared memory (MW words, the launch's) when they
// fit there, else at word moff[j] of the zeroed global buffer.
//
// The design: the path a walk takes from a cell depends only on the codes,
// never on the mask; the mask only decides where the walk stops.  So the
// warp takes the candidates 32 at a time, lane i holding candidate c + i
// (loaded coalesced), and:
// 1. each lane whose cell and MATCH predecessor are both unmarked pre-walks
//    its candidate along the codes, up to kDepth cells: the cells of the
//    path, and whether it reached score 0 (a hit), failed, or goes on.
//    The 32 walks' code loads are in flight together, where the serial
//    loop had one dependent chain;
// 2. the window is then settled in candidate order against the mask, lane
//    by lane (__ballot_sync / __ffs over the lanes still unmasked at the
//    window's start; marks only grow, so a lane marked then stays
//    skipped): the settling lane skips a marked cell, marks its cell when
//    its predecessor is marked, or else enters its path's cells until the
//    first marked one, marking each, and applies the path's end; a path
//    longer than kDepth goes on serially on that lane.  Every settle is
//    followed by __syncwarp (and a block fence for the global mask), so
//    the next lane sees its marks: the marks and hits are exactly the
//    serial order's, cascades inside the window included, and a DIR_FAIL
//    on a path the order never reaches is never raised.  Settling stops
//    at the k-th hit; the next window starts after the last candidate.
// kDepth = 4: on two hint-less 512 x 512 DNA pairs a walk enters 3.5
// cells on average before it aborts (~20 k walks a pair, 11.8 k of them 2
// cells), while an unmasked path runs for hundreds of cells, so every
// window pre-walks the full depth; the dependent loads, kDepth a window
// plus the serial rest of the longer walks (the hits among them), are
// fewest near kDepth = 4, and on the H100 depths 2, 4, 8 and 16 took
// 36.3, 35.6, 41.6 and 61.7 ms at B = 256, L = 512 (PERF.md section 6).
//
// Bound on the card: the dependent chain of code loads (a step is a
// dependent load of a code, ~0.7 us when it misses the caches), kDepth a
// window plus the walks past it, and the serial settle in shared memory;
// pairs run side by side, one warp each.  Only the hit records leave the
// card.

#include <cstdint>
#include <cuda_runtime.h>

#include "slab.cuh"

namespace {

enum { MATCH = 0, GAP_A = 1, GAP_B = 2, DIR_FAIL = 3 };
// a settled candidate's outcome, and a path's end
enum { NONE = 0, HIT = 1, FAIL = 2, MORE = 3 };
constexpr int kDepth = 4;
constexpr unsigned kFull = 0xffffffffu;

template <typename F>
__device__ __forceinline__ bool marked(const uint32_t* m, F f) {
  return (m[f >> 5] >> (f & 31)) & 1u;
}

template <typename F>
__device__ __forceinline__ void mark(uint32_t* m, F f) {
  m[f >> 5] |= 1u << (f & 31);
}

// What a walk needs of its pair: codes, letters, scoring.
struct Pair {
  const uint8_t* dj;
  const uint8_t* aj;
  const uint8_t* bj;
  const int* sub;
  int Kb, match, mismatch, ge, gop, na, nb, neg;
  slab::Geometry g;
};

// One step back from (y, x) in matrix curr, cs falling by the step's
// penalty; false on a DIR_FAIL code.
template <bool SLABS>
__device__ __forceinline__ bool back(const Pair& p, int& x, int& y,
                                     int& curr, int& cs) {
  // one plane (every short pair): no slab arithmetic on the chain
  const int code = p.dj[SLABS ? p.g.at(x, y)
                              : static_cast<size_t>(x + y - 2) * p.g.LBp + y];
  const int nxt = (code >> (2 * curr)) & 3;
  if (nxt == DIR_FAIL) return false;
  int pen;
  if (curr == MATCH) {
    const int ai = p.aj[x - 1], bi = p.bj[y - 1];
    pen = p.sub ? __ldg(p.sub + ai * p.Kb + bi)
                : (ai == bi ? p.match : p.mismatch);
    --x;
    --y;
  } else {
    const bool free = p.neg && (curr == GAP_A ? x == p.na : y == p.nb);
    pen = free ? 0 : (nxt == curr ? p.ge : p.gop);
    if (curr == GAP_A) --y; else --x;
  }
  cs = static_cast<int>(static_cast<unsigned>(cs) -
                        static_cast<unsigned>(pen));
  curr = nxt;
  return true;
}

// The rest of a walk past its pre-walk, from (y, x) in matrix curr at
// score cs, with the mask: NONE (an abort), HIT or FAIL.
template <typename F, bool SLABS>
__device__ __forceinline__ int walk_on(const Pair& p, uint32_t* mask, F w,
                                       int x, int y, int curr, int cs) {
  while (true) {
    const F f = y * w + x;
    if (marked(mask, f)) return NONE;
    mark(mask, f);
    if (cs == 0) return HIT;
    if (x < 1 || y < 1 || !back<SLABS>(p, x, y, curr, cs)) return FAIL;
  }
}

template <typename F, bool SLABS>
__global__ void sw_hits_kernel(const uint8_t* __restrict__ dirs,
                               const uint8_t* __restrict__ ac,
                               const uint8_t* __restrict__ bc,
                               const int* __restrict__ scal,
                               const int* __restrict__ sub, int Kb,
                               const int* __restrict__ na,
                               const int* __restrict__ nb, int neg,
                               const F* __restrict__ cand_flat,
                               const int* __restrict__ cand_score,
                               const int64_t* __restrict__ lo,
                               const int64_t* __restrict__ hi, int LA, int LB,
                               slab::Geometry g, int k, int MW,
                               uint32_t* __restrict__ gmask, int use_smem,
                               F* __restrict__ hit_flat,
                               int* __restrict__ hit_score,
                               int* __restrict__ nhits,
                               const long long* __restrict__ off,
                               const long long* __restrict__ moff) {
  extern __shared__ uint32_t smask[];
  const int j = blockIdx.x;
  const int lane = threadIdx.x;  // one warp a block
  Pair p;
  p.na = na[j];
  p.nb = nb[j];
  p.g = g;
  size_t words = MW;
  uint32_t* mask = smask;
  if (off) {  // the pair's own plane and mask
    p.g.LBp = max(p.nb, 1) + 1;
    p.dj = dirs + off[j];
    words = (static_cast<size_t>(p.nb + 1) * (p.na + 1) + 31) / 32;
    use_smem = use_smem && words <= static_cast<size_t>(MW);
    if (!use_smem) mask = gmask + moff[j];
  } else {
    p.dj = dirs + j * g.pair_bytes();
    if (!use_smem) mask = gmask + static_cast<size_t>(j) * MW;
  }
  if (use_smem) {
    for (size_t i = lane; i < words; i += 32) smask[i] = 0;
    __syncwarp();
  }
  p.aj = ac + static_cast<size_t>(j) * LA;
  p.bj = bc + static_cast<size_t>(j) * LB;
  p.sub = sub;
  p.Kb = Kb;
  p.match = scal[0];
  p.mismatch = scal[1];
  p.ge = scal[3];
  p.gop = static_cast<int>(static_cast<unsigned>(scal[2]) +
                           static_cast<unsigned>(p.ge));
  p.neg = neg;
  F* hf = hit_flat + static_cast<size_t>(j) * k;
  int* hs = hit_score + static_cast<size_t>(j) * k;
  const F w = p.na + 1;
  int n = 0;
  // int32 flats hold pairs of fewer than 2^31 cells only
  bool fail = sizeof(F) < 8 &&
              static_cast<int64_t>(w) * (p.nb + 1) > 0x7fffffff;
  for (int64_t c = lo[j], end = hi[j]; c < end && n < k && !fail; c += 32) {
    const int64_t ci = c + lane;
    const bool have = ci < end;
    const F f0 = have ? cand_flat[ci] : F(0);
    const int s0 = have ? cand_score[ci] : 0;
    // a lane whose cell is marked now stays skipped; one whose MATCH
    // predecessor is marked now marks its cell at its turn, walking nothing
    const bool live = have && !marked(mask, f0);
    // 1. the pre-walk: the path's first kDepth cells and how it ends
    F path[kDepth];
    int len = 0, kind = MORE;
    int x = static_cast<int>(f0 % w), y = static_cast<int>(f0 / w);
    int curr = MATCH, cs = s0;
    if (live && !marked(mask, f0 - w - 1)) {
#pragma unroll
      for (int t = 0; t < kDepth; ++t) {
        if (kind == MORE) {
          path[t] = y * w + x;
          len = t + 1;
          if (cs == 0) {
            kind = HIT;
          } else if (x < 1 || y < 1 || !back<SLABS>(p, x, y, curr, cs)) {
            kind = FAIL;
          }
        }
      }
    }
    // 2. the settle, in candidate order
    unsigned todo = __ballot_sync(kFull, live);
    while (todo) {
      const int i = __ffs(todo) - 1;
      todo &= todo - 1;
      int res = NONE;
      if (lane == i) {
        if (marked(mask, f0)) {
          // skipped
        } else if (marked(mask, f0 - w - 1)) {
          mark(mask, f0);
        } else {
          res = kind;
#pragma unroll
          for (int t = 0; t < kDepth; ++t) {
            if (res != NONE && t < len) {
              if (marked(mask, path[t])) {
                res = NONE;  // abort: the marks so far stay
              } else {
                mark(mask, path[t]);
              }
            }
          }
          // past the pre-walk, the walk goes on serially
          if (res == MORE) res = walk_on<F, SLABS>(p, mask, w, x, y, curr, cs);
        }
        if (!use_smem) __threadfence_block();
      }
      __syncwarp();
      res = __shfl_sync(kFull, res, i);
      if (res == HIT) {
        if (lane == i) {
          hf[n] = f0;
          hs[n] = s0;
        }
        if (++n == k) break;
      } else if (res == FAIL) {
        fail = true;
        break;
      }
    }
  }
  if (lane == 0) nhits[j] = fail ? -1 : n;
}

template <typename F, bool SLABS>
int start(const uint8_t* dirs, const uint8_t* ac, const uint8_t* bc,
          const int* scal, const int* sub, int Kb, const int* na,
          const int* nb, int neg, const void* cand_flat,
          const int* cand_score, const int64_t* lo, const int64_t* hi, int B,
          int LA, int LB, slab::Geometry g, int k, int MW, uint32_t* gmask,
          int use_smem, void* hit_flat, int* hit_score, int* nhits,
          const long long* off, const long long* moff, cudaStream_t stream) {
  const size_t smem = use_smem ? static_cast<size_t>(MW) * 4 : 0;
  if (smem > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(sw_hits_kernel<F, SLABS>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  sw_hits_kernel<F, SLABS><<<B, 32, smem, stream>>>(
      dirs, ac, bc, scal, sub, Kb, na, nb, neg,
      static_cast<const F*>(cand_flat), cand_score, lo, hi, LA, LB, g, k, MW,
      gmask, use_smem, static_cast<F*>(hit_flat), hit_score, nhits, off,
      moff);
  return cudaGetLastError();
}

}  // namespace

// dirs, ac, bc, scal, sub (or null), Kb, na, nb, neg, cand_flat (int32, or
// int64 with flat64), cand_score, lo, hi, B, LA, LB, nch, Dc, k, MW, gmask
// (null with use_smem), use_smem, hit_flat (of cand_flat's type),
// hit_score, nhits, flat64, stream, off, moff: dirs holds nch slabs of Dc
// rows a pair (one slab: Dc = LA + LB - 1), or with off (int64, null
// otherwise) each pair's plane at its own widths; then MW is the words of
// shared memory a block has (use_smem set) and moff (int64) each pair's
// first word in gmask, read for the pairs whose mask passes MW
extern "C" int sw_hits_launch(const void* dirs, const void* ac,
                              const void* bc, const void* scal,
                              const void* sub, int Kb, const void* na,
                              const void* nb, int neg,
                              const void* cand_flat, const void* cand_score,
                              const void* lo, const void* hi, int B, int LA,
                              int LB, int nch, int Dc, int k, int MW,
                              void* gmask, int use_smem, void* hit_flat,
                              void* hit_score, void* nhits, int flat64,
                              void* stream, const void* off,
                              const void* moff) {
  const slab::Geometry g{Dc - LB + 1, Dc, LB + 1, nch};
  auto run = nch > 1 ? (flat64 ? start<int64_t, true> : start<int, true>)
                     : (flat64 ? start<int64_t, false> : start<int, false>);
  return run(static_cast<const uint8_t*>(dirs),
             static_cast<const uint8_t*>(ac),
             static_cast<const uint8_t*>(bc), static_cast<const int*>(scal),
             static_cast<const int*>(sub), Kb, static_cast<const int*>(na),
             static_cast<const int*>(nb), neg, cand_flat,
             static_cast<const int*>(cand_score),
             static_cast<const int64_t*>(lo), static_cast<const int64_t*>(hi),
             B, LA, LB, g, k, MW, static_cast<uint32_t*>(gmask), use_smem,
             hit_flat, static_cast<int*>(hit_score),
             static_cast<int*>(nhits), static_cast<const long long*>(off),
             static_cast<const long long*>(moff),
             static_cast<cudaStream_t>(stream));
}
