// Gotoh fill shared by nw_scores.cu, nw_dirs.cu, sw_scores.cu and
// sw_dirs.cu: default flags; global (NW) or local (SW); equality scoring on
// case-folded codes or substitution-table scoring on compact codes.
//
// Replaces the recurrence of seqalign_tpu/ops/pallas_dp2.py:_kernel2 and
// :_dirs_kernel2 in their NW and SW modes, equality and packed-LUT
// scoring, and the default-flag duties of pallas_dp.py:_kernel and
// :_dirs_kernel (other alphabets, 4,097-8,192 lanes); it follows the
// cell-by-cell definition of seqalign_tpu/ops/dp.py:dp_fill
// (alignment.c:28-168).
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
// int16 or int32 beside the codes.  With all flags off the kernel is the
// NW equality fill, unchanged.
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
// on device.  sub (TABLE only): (Ka, Kb) int32, sub_n = Ka * Kb entries.
// dirs (DIRS only) and mout (MBYTES > 0): (B, LA+LB-1, LB+1), cell (y, x)
// at [x+y-2][y]; only cells 1 <= y <= nb, 1 <= x <= na are written.
// scores: NW corner max or SW best M; corner (NW only): M/Ga/Gb at (nb, na).
template <bool DIRS, bool SW, bool TABLE, int MBYTES>
__global__ void fill_kernel(const uint8_t* __restrict__ ac,
                            const uint8_t* __restrict__ bc,
                            const int* __restrict__ na_,
                            const int* __restrict__ nb_,
                            const int* __restrict__ scal,
                            const int* __restrict__ sub, int Kb, int sub_n,
                            int table_smem, int LA, int LB,
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
  const int* subp = sub;
  if (TABLE && table_smem) {
    int* t = smem + (scratch ? 0 : 9 * LBp);
    for (int i = threadIdx.x; i < sub_n; i += blockDim.x) t[i] = sub[i];
    subp = t;
  }
  int best = 0;  // SW: the floor, and the score of an empty side

  if (threadIdx.x == 0) {
    // diagonal 0: cell (0, 0); diagonal 1: cells (0, 1) and (1, 0)
    buf[0] = 0;
    buf[LBp] = 0;
    buf[2 * LBp] = 0;
    int* d1 = buf + 3 * LBp;
    const int run1 = SW ? 0 : add(go, ge);
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
        cga = add(go, nb * ge);  // cell (nb, 0)
      } else {
        cgb = add(go, na * ge);  // cell (0, na)
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
      const int run = SW ? 0 : add(go, d * ge);
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
      int ss;
      if (TABLE) {
        ss = subp[a[x - 1] * Kb + b[y - 1]];
      } else {
        ss = (a[x - 1] == b[y - 1]) ? match : mismatch;
      }
      const int m2 = p2[y - 1], ga2 = p2[LBp + y - 1],
                gb2 = p2[2 * LBp + y - 1];  // (y-1, x-1)
      const int mu = p1[y - 1], gau = p1[LBp + y - 1],
                gbu = p1[2 * LBp + y - 1];  // (y-1, x)
      const int ml = p1[y], gal = p1[LBp + y], gbl = p1[2 * LBp + y];  // (y, x-1)
      // MATCH (alignment.c:89-119)
      const int M = max(add(max3(m2, ga2, gb2), ss), mn);
      // GAP_A, gap in seq_a (alignment.c:121-137)
      const int Ga = max(max3(add(mu, gop), add(gau, ge), add(gbu, gop)), mn);
      // GAP_B, gap in seq_b (alignment.c:139-155)
      const int Gb = max(max3(add(ml, gop), add(gal, gop), add(gbl, ge)), mn);
      cur[y] = M;
      cur[LBp + y] = Ga;
      cur[2 * LBp + y] = Gb;
      if (DIRS) {
        const int dm = pick(add(ga2, ss) == M, add(gb2, ss) == M,
                            add(m2, ss) == M);
        const int dga = pick(add(gau, ge) == Ga, add(gbu, gop) == Ga,
                             add(mu, gop) == Ga);
        const int dgb = pick(add(gal, gop) == Gb, add(gbl, ge) == Gb,
                             add(ml, gop) == Gb);
        dj[static_cast<size_t>(d - 2) * LBp + y] =
            static_cast<uint8_t>(dm | (dga << 2) | (dgb << 4));
      }
      if (MBYTES) mj[static_cast<size_t>(d - 2) * LBp + y] = static_cast<MT>(M);
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

template <bool DIRS, bool SW, bool TABLE, int MBYTES>
int launch(const void* ac, const void* bc, const void* na, const void* nb,
           const void* scal, const void* sub, int Kb, int sub_n,
           int table_smem, int B, int LA, int LB, void* scores, void* corner,
           void* dirs, void* mout, void* scratch, void* stream) {
  // above 48 KB a block must opt in; past the 227 KB limit the attribute
  // call fails and the launch is not made (the wrapper keeps the sum of
  // diagonals and table under it)
  const size_t smem =
      (scratch ? 0 : static_cast<size_t>(36) * (LB + 1)) +
      (TABLE && table_smem ? static_cast<size_t>(4) * sub_n : 0);
  auto kernel = fill_kernel<DIRS, SW, TABLE, MBYTES>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  kernel<<<B, fill_threads(LB), smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(ac), static_cast<const uint8_t*>(bc),
      static_cast<const int*>(na), static_cast<const int*>(nb),
      static_cast<const int*>(scal), static_cast<const int*>(sub), Kb, sub_n,
      table_smem, LA, LB, static_cast<int*>(scores),
      static_cast<int*>(corner), static_cast<uint8_t*>(dirs), mout,
      static_cast<int*>(scratch));
  return cudaGetLastError();
}

// The scoring mode is a runtime choice of the wrapper: a table or none.
template <bool DIRS, bool SW, int MBYTES>
int launch_mode(const void* ac, const void* bc, const void* na,
                const void* nb, const void* scal, const void* sub, int Kb,
                int sub_n, int table_smem, int B, int LA, int LB,
                void* scores, void* corner, void* dirs, void* mout,
                void* scratch, void* stream) {
  if (sub) {
    return launch<DIRS, SW, true, MBYTES>(ac, bc, na, nb, scal, sub, Kb,
                                          sub_n, table_smem, B, LA, LB,
                                          scores, corner, dirs, mout,
                                          scratch, stream);
  }
  return launch<DIRS, SW, false, MBYTES>(ac, bc, na, nb, scal, nullptr, 0, 0,
                                         0, B, LA, LB, scores, corner, dirs,
                                         mout, scratch, stream);
}

}  // namespace fill

// The four fill entry points share one C signature (ops/build.py):
// ac, bc, na, nb, scal, sub, Kb, sub_n, table_smem, B, LA, LB, scores,
// corner, dirs, mout, m16, scratch, stream.
#define FILL_ENTRY(name)                                                     \
  extern "C" int name(const void* ac, const void* bc, const void* na,       \
                      const void* nb, const void* scal, const void* sub,     \
                      int Kb, int sub_n, int table_smem, int B, int LA,      \
                      int LB, void* scores, void* corner, void* dirs,        \
                      void* mout, int m16, void* scratch, void* stream)
