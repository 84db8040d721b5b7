// What the fills of nw_scores.cu, nw_dirs.cu, sw_scores.cu and sw_dirs.cu
// share: the integer helpers, the scoring flags' bits, the schedule of a
// launch across widths, a carry launch's chunk, the entry points' C
// signatures; and the matrix dump's fill (fill_kernel, GAB).  Every other
// fill, under any flags, runs on the register tiles: tile_fill.cuh (a
// batch, uniform or across widths) and tile_carry.cuh (one chunk of long
// pairs).
//
// fill_kernel replaces the emit_gab planes of seqalign_tpu/ops/dp.py:
// dp_fill (dp.py:621-660, a lax.scan outside Pallas, for --printmatrices):
// the NW or SW Gotoh fill, equality scoring on case-folded codes or
// substitution-table scoring on compact codes, the default recurrence or
// any combination of the five scoring flags (MODES), writing the packed
// direction codes and M, Ga and Gb as int32 into three planes; it follows
// the cell-by-cell definition of dp.py:dp_fill (alignment.c:28-168).
//
// Layout: one thread block per pair.  Cells on one anti-diagonal
// d = x + y are independent, so the block walks d = 2 .. na+nb with a
// __syncthreads() between diagonals, and its threads stride over the lanes
// y of the pair's valid band max(1, d-na) <= y <= min(nb, d-1).  Three
// rolling diagonals of M/Ga/Gb (int32, lane = y) hold all the state:
// buf[(k * 3 + matrix) * (LB+1) + y] with k = d mod 3, in dynamic shared
// memory when 36 * (LB+1) bytes fit the 227 KB a block may use, else in
// the pair's slice of a global scratch buffer the wrapper allocates, 9 *
// (LB+1) int32 a slice.
//
// Template flags: SW floors every cell at 0 with an all-zero boundary and
// reduces the best M (per thread, then per warp, then one atomicMax per
// warp on the pair's score); TABLE scores a cell as sub[a * Kb + b] from
// the batch's (Ka, Kb) int32 table, copied into shared memory behind the
// diagonals when it fits there and read through the read-only path
// otherwise; MODES reads the flag word `modes` (bits NSG .. NMM below) at
// run time.
//
// The modes, each thread knowing its (x, y) and the pair's na, nb (the
// tiles apply the same rules, tile_fill.cuh): NSG zeroes the boundary gap
// runs (alignment.c:60-63); NEG takes Ga on the last column x == na and Gb
// on the last row y == nb as the max of the predecessors without penalty
// or floor, SW included (alignment.c:122-127, 140-145), and the codes of
// those cells compare with penalty 0 (alignment.c:265-268, 287-290); NGA /
// NGB pin Ga / Gb to the floor off the last column / row, after NEG, and
// guard the codes: a no-gaps matrix is a predecessor only at its boundary
// coordinates (alignment.c:312-321); NMM pins M to the floor where the
// pair is not an is-match (alignment.c:101-104): a != b on the folded
// codes, or the batch's second (Ka, Kb) table `im`, which sits behind
// `sub` in shared memory when both fit.
//
// What bounds it on an H100: the bytes, 13 a cell (a code and three int32
// planes), more than the per-diagonal barrier at the dump's sizes.  Sums
// wrap in two's complement, like the int32 fills of the JAX package, so
// every value agrees bit for bit.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

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

// The schedule of a tile fill across widths (tile_fill.cuh, SCHED): ac /
// bc are padded to the widest pair and each block sizes its loop by its
// own na, nb; block i fills pair order[i] (the wrapper orders the pairs by
// cells, largest first, so that the longest start first and the launch's
// tail is short); a pair past one round takes round row wrap[j] of the
// scratch; and with `off` the codes (and M) go to planes at each pair's
// own widths, pair j's at dirs + off[j] with rows of max(nb, 1) + 1 lanes
// (ops/pack.py:ragged_planes), not to the uniform (B, LA+LB-1, LB+1)
// layout.
struct Sched {
  const int* order;      // block -> pair
  const int* wrap;       // pair -> its round row in scratch, or -1
  const long long* off;  // pair -> its code (and M) plane, in elements
};

// The chunk of a carry launch (tile_carry.cuh): boundary columns in and
// out, the chunk's global column offset and width, and the pair strides
// (elements) of the code and M slabs.
struct Carry {
  const int* bin;
  int* bout;
  int x_off;
  int CA;
  long long dstride;
  long long mstride;
};

// scal = {match, mismatch, gap_open, gap_extend, NW floor, SW floor}, int32
// on device.  sub (TABLE only): (Ka, Kb) int32, sub_n = Ka * Kb entries; im
// (TABLE with NMM): the 0/1 is-match table of the same shape.  dirs: (B,
// LA+LB-1, LB+1), cell (y, x) at [x+y-2][y]; mout three such int32 planes,
// (3, B, LA+LB-1, LB+1), M, Ga and Gb (B = gridDim.x); only cells
// 1 <= y <= nb, 1 <= x <= na are written.  scores: NW corner max or SW
// best M; corner (NW only): M/Ga/Gb at (nb, na).
template <bool SW, bool TABLE, bool MODES>
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
                            int* __restrict__ mout,
                            int* __restrict__ scratch) {
  extern __shared__ int smem[];
  const int j = blockIdx.x;
  const int BL = LB + 1;
  int* buf = scratch ? scratch + static_cast<size_t>(j) * 9 * BL : smem;
  const int match = scal[0], mismatch = scal[1];
  const int go = scal[2], ge = scal[3], mn = SW ? scal[5] : scal[4];
  const int gop = add(go, ge);  // gap_open_penalty (alignment.c:38)
  const int na = min(max(na_[j], 0), LA);
  const int nb = min(max(nb_[j], 0), LB);
  const uint8_t* a = ac + static_cast<size_t>(j) * LA;
  const uint8_t* b = bc + static_cast<size_t>(j) * LB;
  const size_t plane = static_cast<size_t>(LA + LB - 1) * BL;
  uint8_t* dj = dirs + j * plane;
  int* mj = mout + j * plane;
  const bool nsg = MODES && (modes & NSG), neg = MODES && (modes & NEG);
  const bool nga = MODES && (modes & NGA), ngb = MODES && (modes & NGB);
  const bool nmm = MODES && (modes & NMM);
  const int* subp = sub;
  const int* imp = im;
  if (TABLE && table_smem) {
    int* t = smem + (scratch ? 0 : 9 * BL);
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
      const size_t at = static_cast<size_t>(d - 2) * BL + y;
      dj[at] = static_cast<uint8_t>(dm | (dga << 2) | (dgb << 4));
      mj[at] = M;  // Ga, Gb behind the B M planes
      mj[gridDim.x * plane + at] = Ga;
      mj[2 * gridDim.x * plane + at] = Gb;
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

// One matrix-dump launch: a block a pair of one lane a thread up to 1,024
// lanes, in whole warps; its diagonals in shared memory unless `scratch`
// is given, the table (and under NMM the is-match table) behind them when
// `table_smem`.  Above 48 KB a block must opt in; past the 227 KB limit
// the attribute call fails and the launch is not made (the wrapper keeps
// the sum of diagonals and tables under it).
template <bool SW, bool TABLE, bool MODES>
int gab_start(const void* ac, const void* bc, const void* na, const void* nb,
              const void* scal, const void* sub, const void* im, int modes,
              int Kb, int sub_n, int table_smem, int B, int LA, int LB,
              void* scores, void* corner, void* dirs, void* mout,
              void* scratch, void* stream) {
  const size_t smem =
      (scratch ? 0 : static_cast<size_t>(36) * (LB + 1)) +
      (TABLE && table_smem ? static_cast<size_t>(4) * sub_n * (im ? 2 : 1)
                           : 0);
  auto kernel = fill_kernel<SW, TABLE, MODES>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  const int t = ((LB + 31) / 32) * 32;
  kernel<<<B, t < 32 ? 32 : (t > 1024 ? 1024 : t), smem,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(ac), static_cast<const uint8_t*>(bc),
      static_cast<const int*>(na), static_cast<const int*>(nb),
      static_cast<const int*>(scal), static_cast<const int*>(sub),
      static_cast<const int*>(im), modes, Kb, sub_n, table_smem, LA, LB,
      static_cast<int*>(scores), static_cast<int*>(corner),
      static_cast<uint8_t*>(dirs), static_cast<int*>(mout),
      static_cast<int*>(scratch));
  return cudaGetLastError();
}

// The matrix dump: the scoring mode and the flags are runtime choices of
// the wrapper, a table or none, the flag word or 0; `im` is passed on only
// under NMM.
template <bool SW>
int gab(const void* ac, const void* bc, const void* na, const void* nb,
        const void* scal, const void* sub, const void* im, int modes, int Kb,
        int sub_n, int table_smem, int B, int LA, int LB, void* scores,
        void* corner, void* dirs, void* mout, void* scratch, void* stream) {
  if (sub) {
    const void* imp = (modes & NMM) ? im : nullptr;
    return modes ? gab_start<SW, true, true>(
                       ac, bc, na, nb, scal, sub, imp, modes, Kb, sub_n,
                       table_smem, B, LA, LB, scores, corner, dirs, mout,
                       scratch, stream)
                 : gab_start<SW, true, false>(
                       ac, bc, na, nb, scal, sub, nullptr, 0, Kb, sub_n,
                       table_smem, B, LA, LB, scores, corner, dirs, mout,
                       scratch, stream);
  }
  return modes ? gab_start<SW, false, true>(
                     ac, bc, na, nb, scal, nullptr, nullptr, modes, 0, 0, 0,
                     B, LA, LB, scores, corner, dirs, mout, scratch, stream)
               : gab_start<SW, false, false>(
                     ac, bc, na, nb, scal, nullptr, nullptr, 0, 0, 0, 0, B,
                     LA, LB, scores, corner, dirs, mout, scratch, stream);
}

}  // namespace fill

// The fill entry points share one C signature (ops/build.py):
// ac, bc, na, nb, scal, sub, im, modes, Kb, sub_n, table_smem, B, LA, LB,
// scores, corner, dirs, mout, m16, scratch, stream, and the schedule:
// order, wrap, off (each null or a device array; the matrix dump reads
// none of them).
#define FILL_ENTRY(name)                                                     \
  extern "C" int name(const void* ac, const void* bc, const void* na,       \
                      const void* nb, const void* scal, const void* sub,     \
                      const void* im, int modes, int Kb, int sub_n,          \
                      int table_smem, int B, int LA, int LB, void* scores,   \
                      void* corner, void* dirs, void* mout, int m16,         \
                      void* scratch, void* stream, const void* order,        \
                      const void* wrap, const void* off)

#define SCHED_ARGS                                                           \
  fill::Sched { static_cast<const int*>(order),                             \
                static_cast<const int*>(wrap),                              \
                static_cast<const long long*>(off) }

// The matrix dump's entries call fill::gab with these arguments.
#define GAB_ARGS                                                             \
  ac, bc, na, nb, scal, sub, im, modes, Kb, sub_n, table_smem, B, LA, LB,   \
      scores, corner, dirs, mout, scratch, stream

// The two carry entry points (one chunk of a long pair) add: bin, bout,
// x_off, CA, the pair strides of the code and M slabs, and the warps of a
// block of the tiles (tile_carry.cuh) (ops/build.py).
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
