// Gotoh fill shared by nw_scores.cu, nw_dirs.cu, sw_scores.cu and
// sw_dirs.cu: global (NW) or local (SW); equality scoring on case-folded
// codes or substitution-table scoring on compact codes; the default
// recurrence or any combination of the five scoring flags.  The four
// fills launch it for the flagged recurrence (MODES) only; their
// default-flag launches run tile_fill.cuh's register tiles.  The matrix
// dump (GAB) runs here under every flag, the long pairs' chunks (CARRY)
// under flags (their default-flag chunks run tile_carry.cuh).
//
// Replaces the recurrence of seqalign_tpu/ops/pallas_dp2.py:_kernel2 and
// :_dirs_kernel2 in their NW and SW modes, equality and packed-LUT
// scoring, with their flag branches (free start and end gaps, no gaps in
// a / b, no mismatches), and the duties of pallas_dp.py:_kernel and
// :_dirs_kernel (other alphabets, 4,097-8,192 lanes, the both-no-gaps
// int32 fill, the SW constrained modes); it follows the cell-by-cell
// definition of seqalign_tpu/ops/dp.py:dp_fill (alignment.c:28-168).
//
// Layout: one thread block per pair.  Cells on one anti-diagonal
// d = x + y are independent, so the block walks d = 2 .. na+nb with a
// __syncthreads() between diagonals, and its threads stride over the lanes
// y of the pair's valid band max(1, d-na) <= y <= min(nb, d-1).  Three
// rolling diagonals of M/Ga/Gb (int32, lane = y) hold all the state:
// buf[(k * 3 + matrix) * BL + y] with k = d mod 3 and BL = max(nb, 1) + 1,
// the pair's own lanes.  They live in dynamic shared memory when the
// pair's BL fits the launch's `smem_lanes` (36 * smem_lanes bytes of the
// 227 KB a block may use), and otherwise in the pair's slice of a global
// scratch buffer the wrapper allocates, 9 * (LB+1) int32 a slice.
//
// One launch serves a batch of mixed widths (Sched): ac / bc are padded to
// the widest pair and each block sizes its loop by its own na, nb; block i
// fills pair order[i] (the wrapper orders the pairs by cells, largest
// first, so that the longest start first and the launch's tail is short);
// a pair past smem_lanes takes scratch slice slot[j]; and with `off` the
// codes (and M) go to planes at each pair's own widths, pair j's at
// dirs + off[j] with rows of BL lanes (ops/pack.py:ragged_planes), not to
// the uniform (B, LA+LB-1, LB+1) layout.  The GAB planes stay uniform.
// A launch without a schedule is the uniform case: block i fills pair i,
// and every pair keeps its diagonals, at LB+1 lanes, in shared memory or
// in scratch slice j.  The schedule is a template flag (SCHED), so that
// the uniform instantiations compile to the code they had before it; the
// scores fills, the NW codes fill and the SW codes-and-M fill (MBYTES 0,
// 2 and 4) take one, the SW fill then writing pair j's M, int16 or int32,
// at mout + off[j] elements in the plane of its codes' shape.
//
// Template flags: DIRS stores the packed direction codes; SW floors every
// cell at 0 with an all-zero boundary and reduces the best M (per thread,
// then per warp, then one atomicMax per warp on the pair's score); TABLE
// scores a cell as sub[a * Kb + b] from the batch's (Ka, Kb) int32 table,
// copied into shared memory behind the diagonals when it fits there and
// read through the read-only path otherwise; MBYTES (0, 2 or 4) stores M as
// int16 or int32 beside the codes, and MBYTES == 12 (GAB, the matrix dump
// of --printmatrices) stores M, Ga and Gb as int32 into three planes of
// `mout`, (3, B, LA+LB-1, LB+1): the values of dp_fill(emit_gab=True),
// seqalign_tpu/ops/dp.py:621-660, which the JAX package computes outside
// Pallas; MODES reads the flag word `modes` (bits NSG .. NMM below) at run
// time.  With all flags off the kernel is the NW equality fill, and with
// MODES off every flag branch is dead code, so the default instantiations
// compile to the plain recurrence; GAB is an instantiation of its own and
// its extra stores are dead code in the others.
//
// CARRY fills one chunk of a long pair under the scoring flags
// (fill_carry_kernel, a kernel of its own, so that fill_kernel's
// instantiations take no chunk state; the default flags' chunks run
// tile_carry.cuh, which computes the same, bit for bit): the
// columns x_off+1 .. x_off+CA of the global DP (replacing the chunked mode
// of pallas_dp.py:_dirs_kernel, driven by fill_dirs_long with _next_bcol,
// pallas_dp.py:1199-1334).  The
// chunk's left boundary, column x = x_off, comes in as `bin` (B, 3, LB+1)
// int32 (M, Ga, Gb by lane y): cell (y, 0) of the chunk, y >= 1, reads
// bin[y].  Row 0 is not carried: every chunk computes its row-0 cells
// (0, x_off + xl), xl >= 0, as the global row-0 cells, M = Ga = floor, Gb
// = gap_open + x * gap_extend (0 under NSG; all zero for SW; the origin
// (0, 0, 0)), so lane 0 of `bin` is never read.  The loop runs over the
// chunk's local width min(CA, na - x_off); `a` is read at global x, and
// lastcol, the x == 1 guard and the corner test use global x.  The column
// x = x_off + CA goes out as `bout` (lanes 1 .. nb) when the pair reaches
// it.  Codes and M go to row xl + y - 2 of the chunk's slab, CA +
// LB - 1 rows a pair, at the pair strides the caller gives.  A pair with
// na <= x_off writes nothing (but for the NW corner of an empty seq_a,
// bin[nb], in the chunk at x_off = 0); SW raises the pair's score across
// launches and never resets it.
//
// The modes, each thread knowing its (x, y) and the pair's na, nb:
// NSG zeroes the boundary gap runs (alignment.c:60-63); NEG takes Ga on the
// last column x == na and Gb on the last row y == nb as the max of the
// predecessors without penalty or floor, SW included (alignment.c:122-127,
// 140-145), and the codes of those cells compare with penalty 0
// (alignment.c:265-268, 287-290); NGA / NGB pin Ga / Gb to the floor off
// the last column / row, after NEG, and guard the codes: a no-gaps matrix
// is a predecessor only at its boundary coordinates (alignment.c:312-321);
// NMM pins M to the floor where the pair is not an is-match
// (alignment.c:101-104): a != b on the folded codes, or the batch's second
// (Ka, Kb) table `im`, which sits behind `sub` in shared memory when both
// fit.  The TPU kernels need a rolling x == na plane, an SW last-row marker
// plane, poisoned pads and folded gap terms for this; here none of that.
//
// What bounds it on an H100: the per-diagonal barrier and the few integer
// ops per cell (plus, with TABLE, one dependent shared-memory load); there
// is one block per pair, so a batch needs a few hundred pairs to fill 132
// SMs: hence one launch across widths rather than one per width bucket.  Sums wrap in two's complement, like the int32 fills of the JAX
// package, so every value agrees bit for bit.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>
#include <type_traits>

namespace fill {

enum { MATCH = 0, GAP_A = 1, GAP_B = 2, DIR_FAIL = 3 };
// bits of `modes` (ops/pack.py)
enum { NSG = 1, NEG = 2, NGA = 4, NGB = 8, NMM = 16 };

__device__ __forceinline__ int add(int a, int b) {
  return static_cast<int>(static_cast<unsigned>(a) + static_cast<unsigned>(b));
}

__device__ __forceinline__ int max3(int a, int b, int c) {
  return max(a, max(b, c));
}

// guard -> equality -> priority GAP_A, GAP_B, MATCH (alignment.c:311-327)
__device__ __forceinline__ int pick(bool ga_ok, bool gb_ok, bool m_ok) {
  return ga_ok ? GAP_A : (gb_ok ? GAP_B : (m_ok ? MATCH : DIR_FAIL));
}

// The schedule of a launch across widths (see Layout above), read when
// SCHED is set.
struct Sched {
  const int* order;      // block -> pair
  const int* slot;       // pair -> scratch slice, read past smem_lanes
  const long long* off;  // pair -> its code (and M) plane, in elements
  int smem_lanes;        // lanes of rolling diagonals in shared memory
};

// scal = {match, mismatch, gap_open, gap_extend, NW floor, SW floor}, int32
// on device.  sub (TABLE only): (Ka, Kb) int32, sub_n = Ka * Kb entries; im
// (TABLE with NMM): the 0/1 is-match table of the same shape.
// dirs (DIRS only) and mout (MBYTES > 0): (B, LA+LB-1, LB+1), cell (y, x)
// at [x+y-2][y], mout three such planes under GAB (B = gridDim.x), or with
// sc.off the pairs' own planes (Layout above); only cells 1 <= y <= nb,
// 1 <= x <= na are written.
// scores: NW corner max or SW best M; corner (NW only): M/Ga/Gb at (nb, na).
template <bool DIRS, bool SW, bool TABLE, int MBYTES, bool MODES, bool SCHED>
__global__ void fill_kernel(const uint8_t* __restrict__ ac,
                            const uint8_t* __restrict__ bc,
                            const int* __restrict__ na_,
                            const int* __restrict__ nb_,
                            const int* __restrict__ scal,
                            const int* __restrict__ sub,
                            const int* __restrict__ im, int modes, int Kb,
                            int sub_n, int table_smem, int LA, int LB,
                            int* __restrict__ scores,
                            int* __restrict__ corner,
                            uint8_t* __restrict__ dirs,
                            void* __restrict__ mout,
                            int* __restrict__ scratch, Sched sc) {
  using MT = typename std::conditional<MBYTES == 2, int16_t, int>::type;
  extern __shared__ int smem[];
  const int j = SCHED ? sc.order[blockIdx.x] : blockIdx.x;
  // the lanes of the rolling diagonals: the pair's own under a schedule
  // (and then the row stride of its plane under sc.off), else LB+1
  const int BL = SCHED ? max(min(max(nb_[j], 0), LB), 1) + 1 : LB + 1;
  int* buf;
  if (SCHED) {
    buf = BL <= sc.smem_lanes ? smem
                              : scratch + static_cast<size_t>(sc.slot[j]) *
                                              9 * (LB + 1);
  } else {
    buf = scratch ? scratch + static_cast<size_t>(j) * 9 * BL : smem;
  }
  const int match = scal[0], mismatch = scal[1];
  const int go = scal[2], ge = scal[3], mn = SW ? scal[5] : scal[4];
  const int gop = add(go, ge);  // gap_open_penalty (alignment.c:38)
  const int na = min(max(na_[j], 0), LA);
  const int nb = min(max(nb_[j], 0), LB);
  const int LBp = SCHED && sc.off ? BL : LB + 1;  // the output's row stride
  const uint8_t* a = ac + static_cast<size_t>(j) * LA;
  const uint8_t* b = bc + static_cast<size_t>(j) * LB;
  const size_t plane = static_cast<size_t>(LA + LB - 1) * (LB + 1);
  const size_t at_j =
      SCHED && sc.off ? static_cast<size_t>(sc.off[j]) : j * plane;
  uint8_t* dj = DIRS ? dirs + at_j : nullptr;
  MT* mj = MBYTES ? static_cast<MT*>(mout) + at_j : nullptr;
  const bool nsg = MODES && (modes & NSG), neg = MODES && (modes & NEG);
  const bool nga = MODES && (modes & NGA), ngb = MODES && (modes & NGB);
  const bool nmm = MODES && (modes & NMM);
  const int* subp = sub;
  const int* imp = im;
  if (TABLE && table_smem) {
    int* t = smem + (SCHED ? 9 * sc.smem_lanes : (scratch ? 0 : 9 * BL));
    for (int i = threadIdx.x; i < sub_n; i += blockDim.x) t[i] = sub[i];
    subp = t;
    if (MODES && TABLE && nmm) {
      for (int i = threadIdx.x; i < sub_n; i += blockDim.x)
        t[sub_n + i] = im[i];
      imp = t + sub_n;
    }
  }
  int best = 0;  // SW: the floor, and the score of an empty side

  if (threadIdx.x == 0) {
    // diagonal 0: cell (0, 0); diagonal 1: cells (0, 1) and (1, 0)
    buf[0] = 0;
    buf[BL] = 0;
    buf[2 * BL] = 0;
    int* d1 = buf + 3 * BL;
    const int run1 = (SW || nsg) ? 0 : add(go, ge);
    d1[0] = mn;
    d1[BL] = mn;
    d1[2 * BL] = run1;
    d1[1] = mn;
    d1[BL + 1] = run1;
    d1[2 * BL + 1] = mn;
    if (SW) {
      scores[j] = 0;  // raised by the warps' atomicMax below
    } else if (na == 0 || nb == 0) {  // the corner is a boundary cell
      int cm = mn, cga = mn, cgb = mn;
      if (na == 0 && nb == 0) {
        cm = cga = cgb = 0;
      } else if (na == 0) {
        cga = nsg ? 0 : add(go, nb * ge);  // cell (nb, 0)
      } else {
        cgb = nsg ? 0 : add(go, na * ge);  // cell (0, na)
      }
      corner[3 * j] = cm;
      corner[3 * j + 1] = cga;
      corner[3 * j + 2] = cgb;
      scores[j] = max3(cm, cga, cgb);
    }
  }
  __syncthreads();

  for (int d = 2; d <= na + nb; ++d) {
    int* cur = buf + (d % 3) * 3 * BL;
    const int* p1 = buf + ((d - 1) % 3) * 3 * BL;
    const int* p2 = buf + ((d - 2) % 3) * 3 * BL;
    if (threadIdx.x == 0) {
      // boundary cells (0, d) and (d, 0) (alignment.c:51-81)
      const int run = (SW || nsg) ? 0 : add(go, d * ge);
      cur[0] = mn;
      cur[BL] = mn;
      cur[2 * BL] = run;
      if (d <= nb) {
        cur[d] = mn;
        cur[BL + d] = run;
        cur[2 * BL + d] = mn;
      }
    }
    const int lo = max(1, d - na);
    const int hi = min(nb, d - 1);
    for (int y = lo + static_cast<int>(threadIdx.x); y <= hi;
         y += blockDim.x) {
      const int x = d - y;
      const int ca = a[x - 1], cb = b[y - 1];
      const int ss = TABLE ? subp[ca * Kb + cb]
                           : (ca == cb ? match : mismatch);
      const bool lastcol = MODES && x == na, lastrow = MODES && y == nb;
      const int m2 = p2[y - 1], ga2 = p2[BL + y - 1],
                gb2 = p2[2 * BL + y - 1];  // (y-1, x-1)
      const int mu = p1[y - 1], gau = p1[BL + y - 1],
                gbu = p1[2 * BL + y - 1];  // (y-1, x)
      const int ml = p1[y], gal = p1[BL + y],
                gbl = p1[2 * BL + y];  // (y, x-1)
      // MATCH (alignment.c:89-119)
      int M = max(add(max3(m2, ga2, gb2), ss), mn);
      // GAP_A, gap in seq_a (alignment.c:121-137)
      int Ga = max(max3(add(mu, gop), add(gau, ge), add(gbu, gop)), mn);
      // GAP_B, gap in seq_b (alignment.c:139-155)
      int Gb = max(max3(add(ml, gop), add(gal, gop), add(gbl, ge)), mn);
      if (MODES) {
        if (nmm && !(TABLE ? imp[ca * Kb + cb] != 0 : ca == cb)) M = mn;
        if (neg && lastcol) Ga = max3(mu, gau, gbu);
        if (nga && !lastcol) Ga = mn;
        if (neg && lastrow) Gb = max3(ml, gal, gbl);
        if (ngb && !lastrow) Gb = mn;
      }
      cur[y] = M;
      cur[BL + y] = Ga;
      cur[2 * BL + y] = Gb;
      if (DIRS) {
        // guards on the predecessor's cell; inside the valid band
        // 1 <= x <= na, 1 <= y <= nb they reduce to these four
        const bool diag_a = !nga || x == 1;   // Ga at (y-1, x-1) or (y, x-1)
        const bool diag_b = !ngb || y == 1;   // Gb at (y-1, x-1) or (y-1, x)
        const bool up_a = !nga || lastcol;    // Ga at (y-1, x)
        const bool left_b = !ngb || lastrow;  // Gb at (y, x-1)
        const int a_open = (neg && lastcol) ? 0 : gop;
        const int a_ext = (neg && lastcol) ? 0 : ge;
        const int b_open = (neg && lastrow) ? 0 : gop;
        const int b_ext = (neg && lastrow) ? 0 : ge;
        const int dm = pick(diag_a && add(ga2, ss) == M,
                            diag_b && add(gb2, ss) == M, add(m2, ss) == M);
        const int dga = pick(up_a && add(gau, a_ext) == Ga,
                             diag_b && add(gbu, a_open) == Ga,
                             add(mu, a_open) == Ga);
        const int dgb = pick(diag_a && add(gal, b_open) == Gb,
                             left_b && add(gbl, b_ext) == Gb,
                             add(ml, b_open) == Gb);
        dj[static_cast<size_t>(d - 2) * LBp + y] =
            static_cast<uint8_t>(dm | (dga << 2) | (dgb << 4));
      }
      if (MBYTES)
        mj[static_cast<size_t>(d - 2) * LBp + y] = static_cast<MT>(M);
      if constexpr (MBYTES == 12) {  // GAB: Ga, Gb behind the B M planes
        const size_t at =
            gridDim.x * plane + static_cast<size_t>(d - 2) * LBp + y;
        mj[at] = Ga;
        mj[gridDim.x * plane + at] = Gb;
      }
      if (SW) {
        best = max(best, M);
      } else if (y == nb && x == na) {
        corner[3 * j] = M;
        corner[3 * j + 1] = Ga;
        corner[3 * j + 2] = Gb;
        scores[j] = max3(M, Ga, Gb);
      }
    }
    __syncthreads();
  }
  if (SW) {
    // every thread of the block reaches here; blocks are whole warps
    best = __reduce_max_sync(0xffffffffu, best);
    if ((threadIdx.x & 31) == 0 && best > 0) atomicMax(scores + j, best);
  }
}

// Threads per block: one lane per thread up to 1024 lanes, in whole warps.
inline int fill_threads(int LB) {
  int t = ((LB + 31) / 32) * 32;
  return t < 32 ? 32 : (t > 1024 ? 1024 : t);
}

// The chunk of a carry launch: boundary columns in and out, the chunk's
// global column offset and width, and the pair strides (elements) of the
// code and M slabs.
struct Carry {
  const int* bin;
  int* bout;
  int x_off;
  int CA;
  long long dstride;
  long long mstride;
};

// One chunk of a long pair (CARRY above): fill_kernel's recurrence with
// codes, over the chunk's columns, with the boundary column carried.
template <bool SW, bool TABLE, int MBYTES, bool MODES>
__global__ void fill_carry_kernel(const uint8_t* __restrict__ ac,
                                  const uint8_t* __restrict__ bc,
                                  const int* __restrict__ na_,
                                  const int* __restrict__ nb_,
                                  const int* __restrict__ scal,
                                  const int* __restrict__ sub,
                                  const int* __restrict__ im, int modes,
                                  int Kb, int sub_n, int table_smem, int LA,
                                  int LB, int* __restrict__ scores,
                                  int* __restrict__ corner,
                                  uint8_t* __restrict__ dirs,
                                  void* __restrict__ mout,
                                  int* __restrict__ scratch, Carry cr) {
  using MT = typename std::conditional<MBYTES == 2, int16_t, int>::type;
  extern __shared__ int smem[];
  const int j = blockIdx.x;
  const int LBp = LB + 1;
  int* buf = scratch ? scratch + static_cast<size_t>(j) * 9 * LBp : smem;
  const int match = scal[0], mismatch = scal[1];
  const int go = scal[2], ge = scal[3], mn = SW ? scal[5] : scal[4];
  const int gop = add(go, ge);  // gap_open_penalty (alignment.c:38)
  const int na = min(max(na_[j], 0), LA);
  const int nb = min(max(nb_[j], 0), LB);
  // global x = xo + local x, over the chunk's wa columns
  const int xo = cr.x_off;
  const int wa = max(0, min(cr.CA, na - xo));
  const uint8_t* a = ac + static_cast<size_t>(j) * LA + xo;
  const uint8_t* b = bc + static_cast<size_t>(j) * LB;
  uint8_t* dj = dirs + j * static_cast<size_t>(cr.dstride);
  MT* mj = MBYTES
               ? static_cast<MT*>(mout) + j * static_cast<size_t>(cr.mstride)
               : nullptr;
  const int* bin = cr.bin + static_cast<size_t>(j) * 3 * LBp;
  int* bout = cr.bout + static_cast<size_t>(j) * 3 * LBp;
  const bool nsg = MODES && (modes & NSG), neg = MODES && (modes & NEG);
  const bool nga = MODES && (modes & NGA), ngb = MODES && (modes & NGB);
  const bool nmm = MODES && (modes & NMM);
  const int* subp = sub;
  const int* imp = im;
  if (TABLE && table_smem) {
    int* t = smem + (scratch ? 0 : 9 * LBp);
    for (int i = threadIdx.x; i < sub_n; i += blockDim.x) t[i] = sub[i];
    subp = t;
    if (MODES && TABLE && nmm) {
      for (int i = threadIdx.x; i < sub_n; i += blockDim.x)
        t[sub_n + i] = im[i];
      imp = t + sub_n;
    }
  }
  int best = 0;  // SW: the floor
  // the gap run of the row-0 cell at global x = k
  auto run_at = [&](int k) { return (SW || nsg) ? 0 : add(go, k * ge); };

  if (wa == 0) {  // the pair ends before this chunk
    if (!SW && threadIdx.x == 0 && na == 0 && xo == 0) {
      corner[3 * j] = bin[nb];  // cell (nb, 0)
      corner[3 * j + 1] = bin[LBp + nb];
      corner[3 * j + 2] = bin[2 * LBp + nb];
      scores[j] = max3(bin[nb], bin[LBp + nb], bin[2 * LBp + nb]);
    }
    return;
  }
  if (threadIdx.x == 0) {
    // diagonal 0: cell (0, x_off), the origin or a row-0 cell; diagonal 1:
    // the row-0 cell (0, x_off + 1) and the carried cell (1, x_off)
    buf[0] = xo ? mn : 0;
    buf[LBp] = xo ? mn : 0;
    buf[2 * LBp] = xo ? run_at(xo) : 0;
    int* d1 = buf + 3 * LBp;
    d1[0] = mn;
    d1[LBp] = mn;
    d1[2 * LBp] = run_at(xo + 1);
    d1[1] = bin[1];
    d1[LBp + 1] = bin[LBp + 1];
    d1[2 * LBp + 1] = bin[2 * LBp + 1];
    if (!SW && nb == 0 && na <= xo + cr.CA) {
      // the corner is the row-0 cell (0, na), in this chunk
      corner[3 * j] = mn;
      corner[3 * j + 1] = mn;
      corner[3 * j + 2] = run_at(na);
      scores[j] = max(mn, run_at(na));
    }
  }
  __syncthreads();

  for (int d = 2; d <= wa + nb; ++d) {
    int* cur = buf + (d % 3) * 3 * LBp;
    const int* p1 = buf + ((d - 1) % 3) * 3 * LBp;
    const int* p2 = buf + ((d - 2) % 3) * 3 * LBp;
    if (threadIdx.x == 0) {
      // the row-0 cell (0, x_off + d) and the carried cell (d, x_off)
      cur[0] = mn;
      cur[LBp] = mn;
      cur[2 * LBp] = run_at(xo + d);
      if (d <= nb) {
        cur[d] = bin[d];
        cur[LBp + d] = bin[LBp + d];
        cur[2 * LBp + d] = bin[2 * LBp + d];
      }
    }
    const int lo = max(1, d - wa);
    const int hi = min(nb, d - 1);
    for (int y = lo + static_cast<int>(threadIdx.x); y <= hi;
         y += blockDim.x) {
      const int x = d - y;  // local; global x is xo + x
      const int ca = a[x - 1], cb = b[y - 1];
      const int ss = TABLE ? subp[ca * Kb + cb]
                           : (ca == cb ? match : mismatch);
      const bool lastcol = MODES && xo + x == na, lastrow = MODES && y == nb;
      const int m2 = p2[y - 1], ga2 = p2[LBp + y - 1],
                gb2 = p2[2 * LBp + y - 1];  // (y-1, x-1)
      const int mu = p1[y - 1], gau = p1[LBp + y - 1],
                gbu = p1[2 * LBp + y - 1];  // (y-1, x)
      const int ml = p1[y], gal = p1[LBp + y],
                gbl = p1[2 * LBp + y];  // (y, x-1)
      int M = max(add(max3(m2, ga2, gb2), ss), mn);
      int Ga = max(max3(add(mu, gop), add(gau, ge), add(gbu, gop)), mn);
      int Gb = max(max3(add(ml, gop), add(gal, gop), add(gbl, ge)), mn);
      if (MODES) {
        if (nmm && !(TABLE ? imp[ca * Kb + cb] != 0 : ca == cb)) M = mn;
        if (neg && lastcol) Ga = max3(mu, gau, gbu);
        if (nga && !lastcol) Ga = mn;
        if (neg && lastrow) Gb = max3(ml, gal, gbl);
        if (ngb && !lastrow) Gb = mn;
      }
      cur[y] = M;
      cur[LBp + y] = Ga;
      cur[2 * LBp + y] = Gb;
      const bool diag_a = !nga || xo + x == 1;  // Ga at (y-1|y, x-1)
      const bool diag_b = !ngb || y == 1;   // Gb at (y-1, x-1) or (y-1, x)
      const bool up_a = !nga || lastcol;    // Ga at (y-1, x)
      const bool left_b = !ngb || lastrow;  // Gb at (y, x-1)
      const int a_open = (neg && lastcol) ? 0 : gop;
      const int a_ext = (neg && lastcol) ? 0 : ge;
      const int b_open = (neg && lastrow) ? 0 : gop;
      const int b_ext = (neg && lastrow) ? 0 : ge;
      const int dm = pick(diag_a && add(ga2, ss) == M,
                          diag_b && add(gb2, ss) == M, add(m2, ss) == M);
      const int dga = pick(up_a && add(gau, a_ext) == Ga,
                           diag_b && add(gbu, a_open) == Ga,
                           add(mu, a_open) == Ga);
      const int dgb = pick(diag_a && add(gal, b_open) == Gb,
                           left_b && add(gbl, b_ext) == Gb,
                           add(ml, b_open) == Gb);
      dj[static_cast<size_t>(d - 2) * LBp + y] =
          static_cast<uint8_t>(dm | (dga << 2) | (dgb << 4));
      if (MBYTES)
        mj[static_cast<size_t>(d - 2) * LBp + y] = static_cast<MT>(M);
      if (SW) {
        best = max(best, M);
      } else if (y == nb && xo + x == na) {
        corner[3 * j] = M;
        corner[3 * j + 1] = Ga;
        corner[3 * j + 2] = Gb;
        scores[j] = max3(M, Ga, Gb);
      }
      if (x == cr.CA) {
        bout[y] = M;
        bout[LBp + y] = Ga;
        bout[2 * LBp + y] = Gb;
      }
    }
    __syncthreads();
  }
  if (SW) {
    // every thread of the block reaches here; blocks are whole warps
    best = __reduce_max_sync(0xffffffffu, best);
    if ((threadIdx.x & 31) == 0 && best > 0) atomicMax(scores + j, best);
  }
}

// One launch of a fill kernel.  Above 48 KB a block must opt in; past the
// 227 KB limit the attribute call fails and the launch is not made (the
// wrapper keeps the sum of diagonals and table under it).
template <typename... P, typename... A>
int start(void (*kernel)(P...), size_t smem, int B, int LB, void* stream,
          A... args) {
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  kernel<<<B, fill_threads(LB), smem, static_cast<cudaStream_t>(stream)>>>(
      args...);
  return cudaGetLastError();
}

// fill_kernel under the schedule `sc`, or fill_carry_kernel for one chunk
// (CARRY; its diagonals in shared memory unless `scratch` is given).
template <bool DIRS, bool SW, bool TABLE, int MBYTES, bool MODES, bool CARRY>
int launch(const void* ac, const void* bc, const void* na, const void* nb,
           const void* scal, const void* sub, const void* im, int modes,
           int Kb, int sub_n, int table_smem, int B, int LA, int LB,
           void* scores, void* corner, void* dirs, void* mout, void* scratch,
           void* stream, const Sched& sc, const Carry& cr) {
  const int lanes = CARRY ? (scratch ? 0 : LB + 1) : sc.smem_lanes;
  const size_t smem =
      static_cast<size_t>(36) * lanes +
      (TABLE && table_smem ? static_cast<size_t>(4) * sub_n * (im ? 2 : 1)
                           : 0);
  const auto ac_ = static_cast<const uint8_t*>(ac);
  const auto bc_ = static_cast<const uint8_t*>(bc);
  const auto na_ = static_cast<const int*>(na);
  const auto nb_ = static_cast<const int*>(nb);
  const auto scal_ = static_cast<const int*>(scal);
  const auto sub_ = static_cast<const int*>(sub);
  const auto im_ = static_cast<const int*>(im);
  const auto scores_ = static_cast<int*>(scores);
  const auto corner_ = static_cast<int*>(corner);
  const auto dirs_ = static_cast<uint8_t*>(dirs);
  const auto scratch_ = static_cast<int*>(scratch);
  if constexpr (CARRY) {
    static_assert(DIRS, "a carry fill emits codes");
    return start(fill_carry_kernel<SW, TABLE, MBYTES, MODES>, smem, B, LB,
                 stream, ac_, bc_, na_, nb_, scal_, sub_, im_, modes, Kb,
                 sub_n, table_smem, LA, LB, scores_, corner_, dirs_, mout,
                 scratch_, cr);
  } else if (MBYTES != 12 && sc.order) {  // a launch across widths
    return start(fill_kernel<DIRS, SW, TABLE, MBYTES, MODES, MBYTES != 12>,
                 smem, B, LB, stream, ac_, bc_, na_, nb_, scal_, sub_, im_,
                 modes, Kb, sub_n, table_smem, LA, LB, scores_, corner_,
                 dirs_, mout, scratch_, sc);
  } else {
    return start(fill_kernel<DIRS, SW, TABLE, MBYTES, MODES, false>, smem, B,
                 LB, stream, ac_, bc_, na_, nb_, scal_, sub_, im_, modes, Kb,
                 sub_n, table_smem, LA, LB, scores_, corner_, dirs_, mout,
                 scratch_, sc);
  }
}

// The scoring mode and the flags are runtime choices of the wrapper: a
// table or none, the flag word or 0.  `im` is passed on only under NMM.
template <bool DIRS, bool SW, int MBYTES, bool MODES, bool CARRY>
int launch_table(const void* ac, const void* bc, const void* na,
                 const void* nb, const void* scal, const void* sub,
                 const void* im, int modes, int Kb, int sub_n,
                 int table_smem, int B, int LA, int LB, void* scores,
                 void* corner, void* dirs, void* mout, void* scratch,
                 void* stream, const Sched& sc, const Carry& cr) {
  if (sub) {
    return launch<DIRS, SW, true, MBYTES, MODES, CARRY>(
        ac, bc, na, nb, scal, sub, (modes & NMM) ? im : nullptr, modes, Kb,
        sub_n, table_smem, B, LA, LB, scores, corner, dirs, mout, scratch,
        stream, sc, cr);
  }
  return launch<DIRS, SW, false, MBYTES, MODES, CARRY>(
      ac, bc, na, nb, scal, nullptr, nullptr, modes, 0, 0, 0, B, LA, LB,
      scores, corner, dirs, mout, scratch, stream, sc, cr);
}

template <bool DIRS, bool SW, int MBYTES>
int launch_mode(const void* ac, const void* bc, const void* na,
                const void* nb, const void* scal, const void* sub,
                const void* im, int modes, int Kb, int sub_n, int table_smem,
                int B, int LA, int LB, void* scores, void* corner,
                void* dirs, void* mout, void* scratch, void* stream,
                const Sched& sc) {
  if (modes) {
    return launch_table<DIRS, SW, MBYTES, true, false>(
        ac, bc, na, nb, scal, sub, im, modes, Kb, sub_n, table_smem, B, LA,
        LB, scores, corner, dirs, mout, scratch, stream, sc, Carry{});
  }
  return launch_table<DIRS, SW, MBYTES, false, false>(
      ac, bc, na, nb, scal, sub, nullptr, 0, Kb, sub_n, table_smem, B, LA, LB,
      scores, corner, dirs, mout, scratch, stream, sc, Carry{});
}

}  // namespace fill

// The fill entry points share one C signature (ops/build.py):
// ac, bc, na, nb, scal, sub, im, modes, Kb, sub_n, table_smem, B, LA, LB,
// scores, corner, dirs, mout, m16, scratch, stream, and the schedule:
// order, slot, off (each null or a device array), lanes: fill_kernel's
// lanes of rolling diagonals in shared memory (the default-flag fills of
// tile_fill.cuh do not read it).
#define FILL_ENTRY(name)                                                     \
  extern "C" int name(const void* ac, const void* bc, const void* na,       \
                      const void* nb, const void* scal, const void* sub,     \
                      const void* im, int modes, int Kb, int sub_n,          \
                      int table_smem, int B, int LA, int LB, void* scores,   \
                      void* corner, void* dirs, void* mout, int m16,         \
                      void* scratch, void* stream, const void* order,        \
                      const void* slot, const void* off, int lanes)

#define SCHED_ARGS                                                           \
  fill::Sched { static_cast<const int*>(order),                             \
                static_cast<const int*>(slot),                              \
                static_cast<const long long*>(off), lanes }

// The two carry entry points (one chunk of a long pair) add: bin, bout,
// x_off, CA, the pair strides of the code and M slabs, and the warps of a
// block of the default-flag tiles (tile_carry.cuh; not read under flags)
// (ops/build.py).
#define CARRY_ENTRY(name)                                                    \
  extern "C" int name(const void* ac, const void* bc, const void* na,       \
                      const void* nb, const void* scal, const void* sub,     \
                      const void* im, int modes, int Kb, int sub_n,          \
                      int table_smem, int B, int LA, int LB, void* scores,   \
                      void* corner, void* dirs, void* mout, int m16,         \
                      void* scratch, void* stream, const void* bin,          \
                      void* bout, int x_off, int CA, long long dstride,      \
                      long long mstride, int warps)

#define CARRY_ARGS                                                           \
  fill::Carry { static_cast<const int*>(bin), static_cast<int*>(bout),      \
                x_off, CA, dstride, mstride }
