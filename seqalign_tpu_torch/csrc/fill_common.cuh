// Gotoh fill shared by nw_scores.cu, nw_dirs.cu, sw_scores.cu and
// sw_dirs.cu: global (NW) or local (SW); equality scoring on case-folded
// codes or substitution-table scoring on compact codes; the default
// recurrence or any combination of the five scoring flags.
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
// buf[(k * 3 + matrix) * (LB+1) + y] with k = d mod 3.  They live in
// dynamic shared memory when 36 * (LB+1) bytes fit in the 227 KB a block may
// use, and otherwise in a global scratch buffer the wrapper allocates.
//
// Template flags: DIRS stores the packed direction codes; SW floors every
// cell at 0 with an all-zero boundary and reduces the best M (per thread,
// then per warp, then one atomicMax per warp on the pair's score); TABLE
// scores a cell as sub[a * Kb + b] from the batch's (Ka, Kb) int32 table,
// copied into shared memory behind the diagonals when it fits there and
// read through the read-only path otherwise; MBYTES (0, 2 or 4) stores M as
// int16 or int32 beside the codes; MODES reads the flag word `modes` (bits
// NSG .. NMM below) at run time.  With all flags off the kernel is the NW
// equality fill, and with MODES off every flag branch is dead code, so the
// default instantiations compile to the plain recurrence.
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
// SMs.  Sums wrap in two's complement, like the int32 fills of the JAX
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

// scal = {match, mismatch, gap_open, gap_extend, NW floor, SW floor}, int32
// on device.  sub (TABLE only): (Ka, Kb) int32, sub_n = Ka * Kb entries; im
// (TABLE with NMM): the 0/1 is-match table of the same shape.
// dirs (DIRS only) and mout (MBYTES > 0): (B, LA+LB-1, LB+1), cell (y, x)
// at [x+y-2][y]; only cells 1 <= y <= nb, 1 <= x <= na are written.
// scores: NW corner max or SW best M; corner (NW only): M/Ga/Gb at (nb, na).
template <bool DIRS, bool SW, bool TABLE, int MBYTES, bool MODES>
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
                            int* __restrict__ scratch) {
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
  const uint8_t* a = ac + static_cast<size_t>(j) * LA;
  const uint8_t* b = bc + static_cast<size_t>(j) * LB;
  const size_t plane = static_cast<size_t>(LA + LB - 1) * LBp;
  uint8_t* dj = DIRS ? dirs + j * plane : nullptr;
  MT* mj = MBYTES ? static_cast<MT*>(mout) + j * plane : nullptr;
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
  int best = 0;  // SW: the floor, and the score of an empty side

  if (threadIdx.x == 0) {
    // diagonal 0: cell (0, 0); diagonal 1: cells (0, 1) and (1, 0)
    buf[0] = 0;
    buf[LBp] = 0;
    buf[2 * LBp] = 0;
    int* d1 = buf + 3 * LBp;
    const int run1 = (SW || nsg) ? 0 : add(go, ge);
    d1[0] = mn;
    d1[LBp] = mn;
    d1[2 * LBp] = run1;
    d1[1] = mn;
    d1[LBp + 1] = run1;
    d1[2 * LBp + 1] = mn;
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
    int* cur = buf + (d % 3) * 3 * LBp;
    const int* p1 = buf + ((d - 1) % 3) * 3 * LBp;
    const int* p2 = buf + ((d - 2) % 3) * 3 * LBp;
    if (threadIdx.x == 0) {
      // boundary cells (0, d) and (d, 0) (alignment.c:51-81)
      const int run = (SW || nsg) ? 0 : add(go, d * ge);
      cur[0] = mn;
      cur[LBp] = mn;
      cur[2 * LBp] = run;
      if (d <= nb) {
        cur[d] = mn;
        cur[LBp + d] = run;
        cur[2 * LBp + d] = mn;
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
      const int m2 = p2[y - 1], ga2 = p2[LBp + y - 1],
                gb2 = p2[2 * LBp + y - 1];  // (y-1, x-1)
      const int mu = p1[y - 1], gau = p1[LBp + y - 1],
                gbu = p1[2 * LBp + y - 1];  // (y-1, x)
      const int ml = p1[y], gal = p1[LBp + y],
                gbl = p1[2 * LBp + y];  // (y, x-1)
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
      cur[LBp + y] = Ga;
      cur[2 * LBp + y] = Gb;
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

template <bool DIRS, bool SW, bool TABLE, int MBYTES, bool MODES>
int launch(const void* ac, const void* bc, const void* na, const void* nb,
           const void* scal, const void* sub, const void* im, int modes,
           int Kb, int sub_n, int table_smem, int B, int LA, int LB,
           void* scores, void* corner, void* dirs, void* mout, void* scratch,
           void* stream) {
  // above 48 KB a block must opt in; past the 227 KB limit the attribute
  // call fails and the launch is not made (the wrapper keeps the sum of
  // diagonals and table under it)
  const size_t smem =
      (scratch ? 0 : static_cast<size_t>(36) * (LB + 1)) +
      (TABLE && table_smem ? static_cast<size_t>(4) * sub_n * (im ? 2 : 1)
                           : 0);
  auto kernel = fill_kernel<DIRS, SW, TABLE, MBYTES, MODES>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  kernel<<<B, fill_threads(LB), smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(ac), static_cast<const uint8_t*>(bc),
      static_cast<const int*>(na), static_cast<const int*>(nb),
      static_cast<const int*>(scal), static_cast<const int*>(sub),
      static_cast<const int*>(im), modes, Kb, sub_n, table_smem, LA, LB,
      static_cast<int*>(scores),
      static_cast<int*>(corner), static_cast<uint8_t*>(dirs), mout,
      static_cast<int*>(scratch));
  return cudaGetLastError();
}

// The scoring mode and the flags are runtime choices of the wrapper: a
// table or none, the flag word or 0.  `im` is passed on only under NMM.
template <bool DIRS, bool SW, int MBYTES, bool MODES>
int launch_table(const void* ac, const void* bc, const void* na,
                 const void* nb, const void* scal, const void* sub,
                 const void* im, int modes, int Kb, int sub_n,
                 int table_smem, int B, int LA, int LB, void* scores,
                 void* corner, void* dirs, void* mout, void* scratch,
                 void* stream) {
  if (sub) {
    return launch<DIRS, SW, true, MBYTES, MODES>(
        ac, bc, na, nb, scal, sub, (modes & NMM) ? im : nullptr, modes, Kb,
        sub_n, table_smem, B, LA, LB, scores, corner, dirs, mout, scratch,
        stream);
  }
  return launch<DIRS, SW, false, MBYTES, MODES>(
      ac, bc, na, nb, scal, nullptr, nullptr, modes, 0, 0, 0, B, LA, LB,
      scores, corner, dirs, mout, scratch, stream);
}

template <bool DIRS, bool SW, int MBYTES>
int launch_mode(const void* ac, const void* bc, const void* na,
                const void* nb, const void* scal, const void* sub,
                const void* im, int modes, int Kb, int sub_n, int table_smem,
                int B, int LA, int LB, void* scores, void* corner,
                void* dirs, void* mout, void* scratch, void* stream) {
  if (modes) {
    return launch_table<DIRS, SW, MBYTES, true>(
        ac, bc, na, nb, scal, sub, im, modes, Kb, sub_n, table_smem, B, LA,
        LB, scores, corner, dirs, mout, scratch, stream);
  }
  return launch_table<DIRS, SW, MBYTES, false>(
      ac, bc, na, nb, scal, sub, nullptr, 0, Kb, sub_n, table_smem, B, LA, LB,
      scores, corner, dirs, mout, scratch, stream);
}

}  // namespace fill

// The four fill entry points share one C signature (ops/build.py):
// ac, bc, na, nb, scal, sub, im, modes, Kb, sub_n, table_smem, B, LA, LB,
// scores, corner, dirs, mout, m16, scratch, stream.
#define FILL_ENTRY(name)                                                     \
  extern "C" int name(const void* ac, const void* bc, const void* na,       \
                      const void* nb, const void* scal, const void* sub,     \
                      const void* im, int modes, int Kb, int sub_n,          \
                      int table_smem, int B, int LA, int LB, void* scores,   \
                      void* corner, void* dirs, void* mout, int m16,         \
                      void* scratch, void* stream)
