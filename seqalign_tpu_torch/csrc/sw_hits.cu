// SW hit streams on the card: the reference's best-first hit loop with its
// overlap mask and partial-walk abort, one thread block per pair.
//
// Replaces the host loop of seqalign_tpu/ops/traceback.py:SwHitIterator.fetch
// (:376-392, walking with _follow_hit :281-324), which the JAX package runs
// on the host over device-walked paths (smith_waterman.c:131-277).  Pair j's
// candidates cand_flat/cand_score[lo[j] .. hi[j]) come sorted in the
// iterator's order (score desc, x asc, flat asc), flat = y * (na+1) + x, of
// type F: int32 when every pair of the launch has (na+1)(nb+1) < 2^31 (a
// pair past that sets nhits[j] = -1), int64 otherwise (a long pair's flats
// pass 2^31 past ~46 kb x 46 kb); the mask is indexed by flats of that
// type.  A candidate whose cell is marked is skipped; one whose MATCH
// predecessor (y-1, x-1) is marked marks its cell and is skipped (its walk
// would abort at the first step); any other walks back over the codes,
// marking each cell it enters, and either meets a marked cell (an abort,
// whose marks stay) or reaches score 0 (a hit).  The first k hits' (flat,
// score) are written and their count goes to nhits[j]; fewer than k means
// the candidates ran out.
// A step's penalty is that of sw_walk.cu, the free-end-gap rule (neg)
// included.  A DIR_FAIL code, or a walk that leaves the matrix, sets
// nhits[j] = -1.
// The paths of the hits are traced by sw_walk.cu afterwards.  The codes
// are one plane or a long pair's chunk slabs (slab.cuh).
//
// The mask is one bit per cell (y, x), 0 <= y <= LB, 0 <= x <= LA (the
// pairs' global width), in MW words: in dynamic shared memory when it fits
// (pairs up to ~1,360^2 cells), zeroed by the block's threads, else in a
// zeroed global buffer.  Only
// thread 0 then walks: every step depends on the marks the steps before it
// set, so a pair's stream is serial.
//
// Bound on the card: the dependent chain of mask and code loads of one
// thread; pairs run side by side, so a batch of a few hundred pairs hides
// latency across blocks.  Only the hit records leave the card.

#include <cstdint>
#include <cuda_runtime.h>

#include "slab.cuh"

namespace {

enum { MATCH = 0, GAP_A = 1, GAP_B = 2, DIR_FAIL = 3 };

template <typename F>
__device__ __forceinline__ bool marked(const uint32_t* m, F f) {
  return (m[f >> 5] >> (f & 31)) & 1u;
}

template <typename F>
__device__ __forceinline__ void mark(uint32_t* m, F f) {
  m[f >> 5] |= 1u << (f & 31);
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
                               int* __restrict__ nhits) {
  extern __shared__ uint32_t smask[];
  const int j = blockIdx.x;
  uint32_t* mask;
  if (use_smem) {
    for (int i = threadIdx.x; i < MW; i += blockDim.x) smask[i] = 0;
    __syncthreads();
    mask = smask;
  } else {
    mask = gmask + static_cast<size_t>(j) * MW;
  }
  if (threadIdx.x != 0) return;
  const int match = scal[0], mismatch = scal[1], ge = scal[3];
  const int gop = static_cast<int>(static_cast<unsigned>(scal[2]) +
                                   static_cast<unsigned>(ge));
  const uint8_t* dj = dirs + j * g.pair_bytes();
  const uint8_t* aj = ac + static_cast<size_t>(j) * LA;
  const uint8_t* bj = bc + static_cast<size_t>(j) * LB;
  F* hf = hit_flat + static_cast<size_t>(j) * k;
  int* hs = hit_score + static_cast<size_t>(j) * k;
  const int naj = na[j], nbj = nb[j];
  const F w = naj + 1;
  int n = 0;
  // int32 flats hold pairs of fewer than 2^31 cells only
  bool fail = sizeof(F) < 8 &&
              static_cast<int64_t>(w) * (nbj + 1) > 0x7fffffff;
  for (int64_t c = lo[j], end = hi[j]; c < end && n < k && !fail; ++c) {
    const F flat = cand_flat[c];
    if (marked(mask, flat)) continue;
    if (marked(mask, flat - w - 1)) {
      mark(mask, flat);
      continue;
    }
    const int score = cand_score[c];
    int x = static_cast<int>(flat % w), y = static_cast<int>(flat / w);
    int curr = MATCH, cs = score;
    while (true) {
      const F f = y * w + x;
      if (marked(mask, f)) break;  // abort: the marks so far stay
      mark(mask, f);
      if (cs == 0) {
        hf[n] = flat;
        hs[n] = score;
        ++n;
        break;
      }
      if (x < 1 || y < 1) {
        fail = true;
        break;
      }
      // one plane (every short pair): no slab arithmetic on the chain
      const int code =
          dj[SLABS ? g.at(x, y) : static_cast<size_t>(x + y - 2) * g.LBp + y];
      const int nxt = (code >> (2 * curr)) & 3;
      if (nxt == DIR_FAIL) {
        fail = true;
        break;
      }
      int pen;
      if (curr == MATCH) {
        const int ai = aj[x - 1], bi = bj[y - 1];
        pen = sub ? __ldg(sub + ai * Kb + bi) : (ai == bi ? match : mismatch);
        --x;
        --y;
      } else {
        const bool free = neg && (curr == GAP_A ? x == naj : y == nbj);
        pen = free ? 0 : (nxt == curr ? ge : gop);
        if (curr == GAP_A) --y; else --x;
      }
      cs = static_cast<int>(static_cast<unsigned>(cs) -
                            static_cast<unsigned>(pen));
      curr = nxt;
    }
  }
  nhits[j] = fail ? -1 : n;
}

}  // namespace

namespace {

template <typename F, bool SLABS>
int start(const uint8_t* dirs, const uint8_t* ac, const uint8_t* bc,
          const int* scal, const int* sub, int Kb, const int* na,
          const int* nb, int neg, const void* cand_flat,
          const int* cand_score, const int64_t* lo, const int64_t* hi, int B,
          int LA, int LB, slab::Geometry g, int k, int MW, uint32_t* gmask,
          int use_smem, void* hit_flat, int* hit_score, int* nhits,
          cudaStream_t stream) {
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
      gmask, use_smem, static_cast<F*>(hit_flat), hit_score, nhits);
  return cudaGetLastError();
}

}  // namespace

// dirs, ac, bc, scal, sub (or null), Kb, na, nb, neg, cand_flat (int32, or
// int64 with flat64), cand_score, lo, hi, B, LA, LB, nch, Dc, k, MW, gmask
// (null with use_smem), use_smem, hit_flat (of cand_flat's type),
// hit_score, nhits, flat64, stream: dirs holds nch slabs of Dc rows a pair
// (one slab: Dc = LA + LB - 1)
extern "C" int sw_hits_launch(const void* dirs, const void* ac,
                              const void* bc, const void* scal,
                              const void* sub, int Kb, const void* na,
                              const void* nb, int neg,
                              const void* cand_flat, const void* cand_score,
                              const void* lo, const void* hi, int B, int LA,
                              int LB, int nch, int Dc, int k, int MW,
                              void* gmask, int use_smem, void* hit_flat,
                              void* hit_score, void* nhits, int flat64,
                              void* stream) {
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
             static_cast<int*>(nhits), static_cast<cudaStream_t>(stream));
}
