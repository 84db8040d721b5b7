// Gotoh fill as register tiles on the anti-diagonal: the fills of
// nw_scores.cu, nw_dirs.cu, sw_scores.cu and sw_dirs.cu and the matrix
// dump's (GAB), the default recurrence or any combination of the five
// scoring flags (MODES), equality or substitution-table scoring, uniform
// or under a fill schedule (one launch across widths); the long pairs'
// chunks run the same Tile from tile_carry.cuh.
//
// Replaces the recurrence of seqalign_tpu/ops/pallas_dp2.py:_kernel2
// (scores: NW corner, SW best) and :_dirs_kernel2 (packed direction codes,
// SW M as int16 or int32) with their flag branches, the duties of
// pallas_dp.py:_kernel / :_dirs_kernel at other alphabets and widths (the
// both-no-gaps fills, the SW constrained modes), and the emit_gab planes
// of seqalign_tpu/ops/dp.py:dp_fill (a lax.scan, for --printmatrices); it
// computes what dp_fill computes (alignment.c:28-168), bit for bit: the
// same scores, corner, codes and M (and under GAB Ga and Gb) at the same
// addresses (the uniform (B, LA+LB-1, LB+1) layout, cell (y, x) at
// [x+y-2][y], or pair j's ragged plane from off[j] with rows of
// max(nb, 1) + 1 lanes).
//
// Layout.  A pair's lanes y = 1 .. nb are cut into strips of S = 32 * R
// lanes; strip s, lanes ys = S*s + 1 .. ys + S - 1, is one warp, and thread
// t of the warp owns the R consecutive lanes y0 = ys + t*R .. y0 + R - 1.
// The warp steps one anti-diagonal d = x + y at a time (local step i =
// d - ys, i = 0 .. na + S - 1, rounded up to R): the thread's R cells of
// one step are independent (R-way ILP), lane r sits at x = i - t*R - r,
// and it keeps its lanes' M / Ga / Gb of diagonals d-1 and d-2 in
// registers (scores keep max3 of d-2 only), its b codes loaded once and its
// a codes, which shift one lane a step through the registers.  Lane 0 of
// thread t takes thread t-1's last lane (d-1 values and a code) by one
// __shfl_sync; thread 31's last lane is nobody's neighbour, so thread 31
// sends thread 0 the strip's source instead: the previous strip's last
// lane, or row 0 for strip 0, prefetched one step ahead.  No shared memory
// holds the tile and no barrier runs inside a strip.  A cell is 10 int32
// instructions on the default flags (M: a 3-input max and an add-max;
// Ga, Gb: three add-max each, which nvcc emits as the DPX VIMNMX3 /
// VIADDMNMX, wrapping as add() does) plus the codes' compares.
//
// Strips of one pair (option "a", warps side by side): a block has W =
// min(strips of the launch's widest pair, BLOCK_WARPS) warps, so one round
// of the block covers LANES lanes at R = THREAD_LANES (LANES / 2 at
// GAB_LANES, the dump's); a pair with fewer strips runs its own Wj
// and the other warps return.  Every K diagonals the pair's warps meet at a
// named barrier; strip s runs macro steps T_s .. T_s + ndur - 1, K local
// steps each, with T_s = r*P + w*(R+1) for s = r*Wj + w (round r, warp w),
// ndur = ceil(steps / K) and the round period P = max(ndur + R + 1,
// Wj*(R+1)).  With K = 32, S = R*K, so strip s runs exactly K diagonals
// behind strip s-1 within a round: the edge (the last lane's M / Ga / Gb
// by x) goes through a ring of RING entries per warp in shared memory,
// written one macro step before it is read and overwritten RING/K - 2
// macro steps after; a warp's next strip, which writes the same ring,
// starts only once the strip after its last one has read all of it (the
// R + 1 in P).  Between rounds (warp Wj-1 to warp 0, which starts its next
// strip only when its last one ends) the edge goes through a row of 3 *
// (LA+1) int32 in global scratch, pair j's slice slot[j] (under a schedule)
// or j, which is written at columns the reader has passed.  Pairs of up to
// a round's lanes of b take one round and no scratch.  tests/test_torch_tile.py
// models this order of work in numpy and holds it to the JAX package.
//
// Edges of the tile.  A step block of R steps whose cells are all valid
// (1 <= x <= na, y <= nb: the strip full, S steps in, past its fill, and
// not yet in its drain) runs unchecked: no boundary, no masks, and its codes and M
// go out as one naturally aligned store of up to 16 bytes, or the fewest
// aligned pieces where the row start is not aligned (rows of LB+1 or
// max(nb,1)+1 lanes seldom are; store_run).  Other blocks run checked: a
// lane at x == 0 takes the boundary column (floor, gap run, floor), lanes
// outside the pair compute garbage that no valid cell reads and nothing
// stores, and stores go lane by lane.  SW reduces the best M of the valid
// cells per thread, then per warp, then one atomicMax per warp; NW writes
// the corner from the thread holding lane nb at x == na.
//
// Modes.  The flags, each where it costs least, with (x, y) a cell and na,
// nb the pair's lengths.  NSG zeroes the boundary gap runs
// (alignment.c:60-63): run() is 0, on the x == 0 lanes and row 0 from
// fetch.  NMM pins M to the floor where the pair is not an is-match
// (alignment.c:101-104): a != b on the folded codes, one compare of the
// codes a lane holds, or under a table a second lookup, hc + bcd[r], into
// the is-match table behind it.  NEG takes Ga on the last column x == na
// and Gb on the last row y == nb as the max of the predecessors without
// penalty or floor, SW included (alignment.c:122-127, 140-145), and the
// codes of those cells compare with penalty 0 (alignment.c:265-268,
// 287-290).  NGA / NGB pin Ga / Gb to the floor off the last column / row,
// after NEG, and guard the codes: a no-gaps matrix is a predecessor only at
// its boundary coordinates x == 1 or y == 1 (alignment.c:312-321).  The
// rows are the lanes' own (a thread tests y0 + r); under MODES a step
// block runs unchecked only where no cell lies on the columns x == 1 or
// x == na, so that the columns are tested in checked blocks only (two more
// checked blocks a strip).  The NW corner, the SW best, a carry's column
// out and the GAB planes are taken after the flags.  With MODES false
// every flag branch is dead code: the default flags' instantiations
// compile as they did before the flags came here.
//
// GAB, the matrix dump: M as int32 (MBYTES 4, NW too), and Ga and Gb into
// the two planes of the same layout behind the B M planes (mout +
// B*plane, mout + 2*B*plane: (3, B, LA+LB-1, LB+1) int32), stored where
// M is, lane by lane in checked blocks and by store_run in unchecked ones
// (a thread's Ga and Gb of one step are its registers a1, b1 after it).
// Uniform layout only, no schedule.  Its bound is the bytes, 13 a valid
// cell.
//
// What bounds it on an H100: integer issue (the cells' instructions at 64
// int32 lanes an SM and clock), with the code stores (one byte a cell, 3
// or 5 with SW M) a distant second; at 2 blocks of 4 warps an SM (256
// pairs of 512 lanes) the step's latency more than either.  R trades the
// fill and drain of a strip (S steps of partial warps) and the per-step
// overhead (4 shuffles, the prefetch, the edge store) against registers and
// resident warps: THREAD_LANES below.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>
#include <type_traits>
#include <utility>

#include "fill_common.cuh"

namespace tile {

using fill::add;
using fill::pick;

constexpr int K = 32;        // diagonals between two barriers of a pair
constexpr int RING = 128;    // entries of a warp's edge ring (>= 2K + 2)
constexpr int LANES = 2048;  // lanes of b a block covers in one round
// R, the lanes a thread holds: against 2 and 8, 4 took the least time or
// within 4% of it at every shape measured (B = 256, L = 512; 256 pairs of
// 1-10 kb; SW job 3's first sub-batch) but the table codes fills at 512
// lanes, where 2 was 5-12% faster (PERF.md, section 6)
constexpr int THREAD_LANES = 4;
constexpr unsigned FULL = 0xffffffffu;

template <int R>
__host__ __device__ constexpr int warps_max() {
  return LANES / (32 * R);
}

// A block holds at most BLOCK_WARPS warps, whatever its R: at 32 *
// BLOCK_WARPS threads a block ptxas keeps 128 registers a thread.
constexpr int BLOCK_WARPS = warps_max<THREAD_LANES>();
// R of the matrix dump's fills (GAB), a round of a block then covering
// LANES / 2 lanes.  The dump fills one pair a launch, where a lone warp's
// step latency paces the fill: at 300 x 200 R = 2 took 0.81-0.82x the time
// of R = 4 (R = 1 0.59-0.81x, but 1.14-1.62x at 3,000 x 2,500; PERF.md,
// section 6); and under MODES R = 4 spilled past the 128 registers.
constexpr int GAB_LANES = 2;

__device__ __forceinline__ int sub(int a, int b) {
  return static_cast<int>(static_cast<unsigned>(a) - static_cast<unsigned>(b));
}

// The largest power of two s <= n with a % s == 0.
__host__ __device__ constexpr int piece(int a, int n) {
  int s = 1;
  while (2 * s <= n && a % (2 * s) == 0) s *= 2;
  return s;
}

// v[I .. I+E) as the bytes of one 32-bit word, E = 4 / sizeof(T).
template <typename T, int R, int I, int... e>
__device__ __forceinline__ uint32_t word(const int (&v)[R],
                                         std::integer_sequence<int, e...>) {
  constexpr uint32_t mask =
      sizeof(T) == 4 ? 0xffffffffu : (1u << (8 * sizeof(T))) - 1;
  return (((static_cast<uint32_t>(v[I + e]) & mask) << (8 * sizeof(T) * e)) |
          ...);
}

// v[I .. I+S) as T at p + I, one naturally aligned store.
template <typename T, int R, int I, int S>
__device__ __forceinline__ void put(T* p, const int (&v)[R]) {
  constexpr int E = 4 / static_cast<int>(sizeof(T));  // elements a word
  constexpr int bytes = S * static_cast<int>(sizeof(T));
  const auto es = std::make_integer_sequence<int, E>();
  if constexpr (S == 1) {
    p[I] = static_cast<T>(v[I]);
  } else if constexpr (bytes == 2) {  // two codes
    *reinterpret_cast<uint16_t*>(p + I) =
        static_cast<uint16_t>((v[I] & 0xff) | ((v[I + 1] & 0xff) << 8));
  } else if constexpr (bytes == 4) {
    *reinterpret_cast<uint32_t*>(p + I) = word<T, R, I>(v, es);
  } else if constexpr (bytes == 8) {
    *reinterpret_cast<uint2*>(p + I) =
        make_uint2(word<T, R, I>(v, es), word<T, R, I + E>(v, es));
  } else {
    *reinterpret_cast<uint4*>(p + I) =
        make_uint4(word<T, R, I>(v, es), word<T, R, I + E>(v, es),
                   word<T, R, I + 2 * E>(v, es), word<T, R, I + 3 * E>(v, es));
  }
}

// v[I ..) at p + I, p's element index being E mod C: greedy, the largest
// aligned piece first (at E = 1 of 8 bytes: 1, 2, 4, 1).
template <typename T, int R, int C, int E, int I = 0>
__device__ __forceinline__ void pieces(T* p, const int (&v)[R]) {
  if constexpr (I < R) {
    constexpr int n = R - I < C ? R - I : C;
    constexpr int S = piece((E + I) % C, n);
    put<T, R, I, S>(p, v);
    pieces<T, R, C, E, I + S>(p, v);
  }
}

template <typename T, int R, int C, int E = 0>
__device__ __forceinline__ void store_at(int e, T* p, const int (&v)[R]) {
  if constexpr (E < C) {
    if (e == E) {
      pieces<T, R, C, E>(p, v);
    } else {
      store_at<T, R, C, E + 1>(e, p, v);
    }
  }
}

// The R values v as T at p .. p+R-1 in the fewest naturally aligned stores
// of at most 16 bytes.  Every thread of a warp stores at the same offset
// mod C (its lanes start R apart on one row), so the branch is uniform.
template <typename T, int R>
__device__ __forceinline__ void store_run(T* p, const int (&v)[R]) {
  constexpr int C = R < 16 / static_cast<int>(sizeof(T))
                        ? R
                        : 16 / static_cast<int>(sizeof(T));
  const int e = static_cast<int>(
      (reinterpret_cast<uintptr_t>(p) / sizeof(T)) & (C - 1));
  store_at<T, R, C>(e, p, v);
}

// One warp's tile: the pair's constants, the strip's, and the scalars it
// carries; the lanes' registers are arrays of the kernel, passed in by
// reference (as members of this struct nvcc kept them in local memory).
// CARRY: one chunk of a long pair (tile_carry.cuh); na is then the chunk's
// local width, and the members below the CARRY line take the duties of the
// closed-form boundary.  MODES: the scoring flags of the word `modes`, read
// at run time (see Modes above); the members below the MODES line.  GAB:
// the matrix dump's Ga and Gb planes, gstride elements behind M's (see GAB
// above).
template <bool DIRS, bool SW, bool TABLE, int MBYTES, int R,
          bool CARRY = false, bool MODES = false, bool GAB = false>
struct Tile {
  using MT = typename std::conditional<MBYTES == 2, int16_t, int>::type;
  static constexpr int S = 32 * R;

  int match, mismatch, go, ge, mn, gop, na, nb, LBp, lane, kmul;
  const uint8_t* a;
  const uint8_t* b;
  const int* tab;
  uint8_t* dj;
  MT* mj;
  // the strip: its first lane, the thread's first lane, whether every lane
  // is inside the pair; where thread 0's up neighbour comes from (row 0, a
  // ring, the round's row) and where the last lane goes
  int ys, y0;
  bool full, row0;
  const int* src;
  int sstride, smask, smax;
  int* dst;
  int dstride, dmask, dlo, dhi;
  int u2m, u2a, u2b;  // lane 0's up neighbour at d-2
  int pm, pa, pb, ph;  // thread 31: the source of the next step
  int best;
  // CARRY: the chunk's first global column x0 (row 0 is computed at
  // x0 + x); its column x = 0 in, bin, and the column x = bcol out, bout,
  // both (M, Ga, Gb) planes of bstride lanes; the local column of the NW
  // corner, cx (bcol and cx out of reach where the chunk has none); and
  // whether thread 0's source is a round row in global memory that
  // another block writes (read through L2, where it is coherent)
  int x0, bstride, bcol, cx;
  const int* bin;
  int* bout;
  bool gsrc;
  // MODES: the flag word; the is-match table under NMM with a
  // substitution table (behind `tab` where the tiles keep it).  The
  // pair's last column (global x == na) is the NW corner's column, na or,
  // in a chunk that holds it, cx (a valid cell of no other chunk lies on
  // it)
  int modes;
  const int* im;
  // GAB: the elements from a cell's M to its Ga, B planes
  size_t gstride;

  __device__ __forceinline__ bool flag(int f) const {
    return MODES && (modes & f);
  }

  // the gap run of a boundary cell k away from the origin; the default
  // flags' branch kept as it was, so that their instantiations compile as
  // before (a flag branch folded away late moved NW's SASS)
  __device__ __forceinline__ int run(int k) const {
    if constexpr (MODES) {
      return (SW || flag(fill::NSG)) ? 0 : add(go, k * ge);
    } else {
      return SW ? 0 : add(go, k * ge);
    }
  }

  // thread 31: thread 0's up neighbour at column x, and its a code
  __device__ __forceinline__ void fetch(int x) {
    if (row0) {
      const int xg = CARRY ? x0 + x : x;
      pm = xg ? mn : 0;
      pa = xg ? mn : 0;
      pb = xg ? run(xg) : 0;
    } else if (x <= smax) {
      const int* q = src + (x & smask);
      if (CARRY && gsrc) {
        pm = __ldcg(q);
        pa = __ldcg(q + sstride);
        pb = __ldcg(q + 2 * sstride);
      } else {
        pm = q[0];
        pa = q[sstride];
        pb = q[2 * sstride];
      }
    }
    ph = (x >= 1 && x <= na) ? static_cast<int>(a[x - 1]) * kmul : 0;
  }

  // The lanes' registers: (M, Ga, Gb) at d-1 (m1, a1, b1) and at d-2 (m2,
  // a2, b2; scores keep max3 in m2 only), the a code of each lane (times
  // Kb under TABLE) and its b code.
#define TILE_LANES_ARGS                                                  \
  int(&m1)[R], int(&a1)[R], int(&b1)[R], int(&m2)[R], int(&a2)[R],       \
      int(&b2)[R], int(&h)[R], int(&bcd)[R]

  // lane r's b code and registers at the start of a strip, then lanes
  // r-1 .. 0
  template <int r>
  __device__ __forceinline__ void lanes(TILE_LANES_ARGS) {
    const int y = y0 + r;
    bcd[r] = y <= nb ? static_cast<int>(b[y - 1]) : 0;
    h[r] = 0;
    m1[r] = a1[r] = b1[r] = m2[r] = a2[r] = b2[r] = mn;
    if constexpr (r > 0) lanes<r - 1>(m1, a1, b1, m2, a2, b2, h, bcd);
  }

  __device__ __forceinline__ void begin(TILE_LANES_ARGS, int s) {
    ys = s * S + 1;
    y0 = ys + lane * R;
    full = ys + S - 1 <= nb;
    lanes<R - 1>(m1, a1, b1, m2, a2, b2, h, bcd);
    u2m = u2a = u2b = mn;
    pm = pa = pb = ph = 0;
  }

  // Lane r of one step, then lanes r-1 .. 0: lane r reads lane r-1's d-1
  // and d-2 values before they roll.  A template recursion, so that every
  // lane index is a constant (a loop that nvcc left rolled put the lanes'
  // arrays in local memory).
  template <bool CK, int r>
  __device__ __forceinline__ void cell(TILE_LANES_ARGS, int (&code)[R],
                                       int (&mval)[R], int um, int ua,
                                       int ub, int uh, int xb, size_t row,
                                       int* corner, int* scores, int j) {
    int upm, upa, upb, dm_, da_, db_;  // (y-1, x) and (y-1, x-1)
    int hc;  // the lane's a code this step: lane r-1's of the last step
    if constexpr (r > 0) {
      hc = h[r - 1];
      upm = m1[r - 1];
      upa = a1[r - 1];
      upb = b1[r - 1];
      dm_ = m2[r - 1];
      da_ = a2[r - 1];
      db_ = b2[r - 1];
    } else {
      hc = uh;
      upm = um;
      upa = ua;
      upb = ub;
      dm_ = u2m;
      da_ = u2a;
      db_ = u2b;
    }
    const int ss =
        TABLE ? tab[hc + bcd[r]] : (hc == bcd[r] ? match : mismatch);
    // MATCH, GAP_A, GAP_B (alignment.c:89-155)
    int M = max(add(DIRS ? __vimax3_s32(dm_, da_, db_) : dm_, ss), mn);
    int Ga = max(add(upm, gop), mn);
    Ga = max(add(upa, ge), Ga);
    Ga = max(add(upb, gop), Ga);
    int Gb = max(add(m1[r], gop), mn);
    Gb = max(add(a1[r], gop), Gb);
    Gb = max(add(b1[r], ge), Gb);
    // the flags (Modes above); an unchecked block holds no
    // cell of the columns of global x == 1 and x == na, so only checked
    // ones test them; the rows y == 1 and y == nb are the lanes' own
    bool lcol = false, lrow = false, xone = false, yone = false;
    if constexpr (MODES) {
      lcol = CK && xb - r == (CARRY ? cx : na);
      xone = CK && (CARRY ? x0 + xb - r : xb - r) == 1;  // global x
      lrow = y0 + r == nb;
      yone = r == 0 && y0 == 1;
      if (flag(fill::NMM) &&
          !(TABLE ? im[hc + bcd[r]] != 0 : hc == bcd[r]))
        M = mn;
      if (flag(fill::NEG) && lcol) Ga = __vimax3_s32(upm, upa, upb);
      if (flag(fill::NGA) && !lcol) Ga = mn;
      if (flag(fill::NEG) && lrow) Gb = __vimax3_s32(m1[r], a1[r], b1[r]);
      if (flag(fill::NGB) && !lrow) Gb = mn;
    }
    bool valid = true;
    if (CK) {
      const int x = xb - r, y = y0 + r;
      if (x == 0) {  // the boundary column (alignment.c:51-81)
        if constexpr (CARRY) {  // the chunk's, carried in
          if (y <= nb) {
            M = bin[y];
            Ga = bin[bstride + y];
            Gb = bin[2 * bstride + y];
          }
        } else {
          M = mn;
          Ga = run(y);
          Gb = mn;
        }
      }
      valid = x >= 1 && x <= na && y <= nb;
    }
    if constexpr (DIRS && MODES) {
      // the guards and the end gaps' penalty 0 of the flags (Modes above)
      const bool nga = flag(fill::NGA), ngb = flag(fill::NGB);
      const bool diag_a = !nga || xone, diag_b = !ngb || yone;
      const bool up_a = !nga || lcol, left_b = !ngb || lrow;
      const bool ea = flag(fill::NEG) && lcol, eb = flag(fill::NEG) && lrow;
      const int tm = sub(M, ss);
      const int tae = ea ? Ga : sub(Ga, ge), tao = ea ? Ga : sub(Ga, gop);
      const int tbo = eb ? Gb : sub(Gb, gop), tbe = eb ? Gb : sub(Gb, ge);
      const int dm = pick(diag_a && da_ == tm, diag_b && db_ == tm,
                          dm_ == tm);
      const int dga = pick(up_a && upa == tae, diag_b && upb == tao,
                           upm == tao);
      const int dgb = pick(diag_a && a1[r] == tbo, left_b && b1[r] == tbe,
                           m1[r] == tbo);
      code[r] = dm | (dga << 2) | (dgb << 4);
    } else if (DIRS) {
      // the reference's compares (alignment.c:311-327), add(p, c) == v
      // written as p == v - c
      const int tm = sub(M, ss);
      const int tae = sub(Ga, ge), tao = sub(Ga, gop);
      const int tbo = sub(Gb, gop), tbe = sub(Gb, ge);
      const int dm = pick(da_ == tm, db_ == tm, dm_ == tm);
      const int dga = pick(upa == tae, upb == tao, upm == tao);
      const int dgb = pick(a1[r] == tbo, b1[r] == tbe, m1[r] == tbo);
      code[r] = dm | (dga << 2) | (dgb << 4);
    }
    mval[r] = M;
    if (SW && valid) best = max(best, M);
    if (CK && valid) {
      if (DIRS) dj[row + y0 + r] = static_cast<uint8_t>(code[r]);
      if (MBYTES) mj[row + y0 + r] = static_cast<MT>(M);
      if (GAB) {
        mj[gstride + row + y0 + r] = Ga;
        mj[2 * gstride + row + y0 + r] = Gb;
      }
      if (!SW && xb - r == (CARRY ? cx : na) && y0 + r == nb) {  // NW corner
        corner[3 * j] = M;
        corner[3 * j + 1] = Ga;
        corner[3 * j + 2] = Gb;
        scores[j] = fill::max3(M, Ga, Gb);
      }
      if (CARRY && xb - r == bcol) {  // the chunk's last column, out
        bout[y0 + r] = M;
        bout[bstride + y0 + r] = Ga;
        bout[2 * bstride + y0 + r] = Gb;
      }
    }
    if (DIRS) {
      m2[r] = m1[r];
      a2[r] = a1[r];
      b2[r] = b1[r];
    } else {
      m2[r] = __vimax3_s32(m1[r], a1[r], b1[r]);
    }
    m1[r] = M;
    a1[r] = Ga;
    b1[r] = Gb;
    if constexpr (r > 0) {
      h[r] = hc;
      cell<CK, r - 1>(m1, a1, b1, m2, a2, b2, h, bcd, code, mval, um, ua,
                      ub, uh, xb, row, corner, scores, j);
    }
  }

  template <bool CK>
  __device__ __forceinline__ void step(TILE_LANES_ARGS, int i, int* corner,
                                       int* scores, int j) {
    // lane 0 of each thread takes the last lane of the thread before it;
    // thread 31 carries thread 0's source, which every thread fetches (one
    // broadcast address, no branch before the next shuffle)
    const int from = (lane + 31) & 31;
    const bool t31 = lane == 31;
    const int um = __shfl_sync(FULL, t31 ? pm : m1[R - 1], from);
    const int ua = __shfl_sync(FULL, t31 ? pa : a1[R - 1], from);
    const int ub = __shfl_sync(FULL, t31 ? pb : b1[R - 1], from);
    const int uh = __shfl_sync(FULL, t31 ? ph : h[R - 1], from);
    fetch(i + 1);
    const size_t row = static_cast<size_t>(ys + i - 2) * LBp;
    int code[R], mval[R];
    cell<CK, R - 1>(m1, a1, b1, m2, a2, b2, h, bcd, code, mval, um, ua, ub,
                    uh, i - lane * R, row, corner, scores, j);
    h[0] = uh;
    if (DIRS) {
      u2m = um;
      u2a = ua;
      u2b = ub;
    } else {
      u2m = __vimax3_s32(um, ua, ub);
    }
    if (!CK) {
      if (DIRS) store_run<uint8_t, R>(dj + row + y0, code);
      if (MBYTES) store_run<MT, R>(mj + row + y0, mval);
      if (GAB) {  // this step's Ga and Gb, now the lanes' d-1 values
        store_run<MT, R>(mj + gstride + row + y0, a1);
        store_run<MT, R>(mj + 2 * gstride + row + y0, b1);
      }
    }
    if (t31 && dst) {  // the last lane, column i - S + 1, for the next strip
      const int x = i - S + 1;
      if (x >= dlo && x <= dhi) {
        int* q = dst + (x & dmask);
        q[0] = m1[R - 1];
        q[dstride] = a1[R - 1];
        q[2 * dstride] = b1[R - 1];
      }
    }
  }
};

// scal = {match, mismatch, gap_open, gap_extend, NW floor, SW floor}, int32;
// sub (TABLE): the (Ka, Kb) int32 table, sub_n = Ka * Kb entries, copied
// to shared memory behind the rings when `table_smem`; im (TABLE under
// NMM): the 0/1 is-match table of the same shape; modes: the flag word
// (fill_common.cuh, NSG .. NMM); scores: the NW corner max or the SW best;
// corner (NW): M, Ga, Gb at (nb, na); dirs: the codes, (B, LA+LB-1, LB+1)
// uint8 (or planes under a schedule); mout: M (MBYTES 2 or 4), in the
// layout of dirs, and under GAB Ga and Gb behind it;
// scratch: the round rows, 3 * (LA+1) int32 a pair that needs one (pair
// j's at slice sc.wrap[j] under a schedule, else j).  im and modes are
// read under MODES only, and come last, so that the default flags'
// instantiations read their arguments where they did before MODES.
template <bool DIRS, bool SW, bool TABLE, int MBYTES, bool SCHED, int R,
          bool MODES = false, bool GAB = false>
__global__ void __launch_bounds__(32 * BLOCK_WARPS)
    tile_fill_kernel(const uint8_t* __restrict__ ac,
                     const uint8_t* __restrict__ bc,
                     const int* __restrict__ na_, const int* __restrict__ nb_,
                     const int* __restrict__ scal,
                     const int* __restrict__ sub, int Kb, int sub_n,
                     int table_smem, int LA, int LB,
                     int* __restrict__ scores, int* __restrict__ corner,
                     uint8_t* __restrict__ dirs, void* __restrict__ mout,
                     int* __restrict__ scratch, fill::Sched sc,
                     const int* __restrict__ im, int modes) {
  using T = Tile<DIRS, SW, TABLE, MBYTES, R, false, MODES, GAB>;
  constexpr int S = T::S;
  extern __shared__ int smem[];
  const int j = SCHED ? sc.order[blockIdx.x] : blockIdx.x;
  const int W = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5;
  T tl;
  int m1[R], a1[R], b1[R], m2[R], a2[R], b2[R], h[R], bcd[R];
  tl.lane = threadIdx.x & 31;
  tl.match = scal[0];
  tl.mismatch = scal[1];
  tl.go = scal[2];
  tl.ge = scal[3];
  tl.mn = SW ? scal[5] : scal[4];
  tl.gop = add(tl.go, tl.ge);  // gap_open_penalty (alignment.c:38)
  const int na = min(max(na_[j], 0), LA);
  const int nb = min(max(nb_[j], 0), LB);
  tl.na = na;
  tl.nb = nb;
  tl.LBp = SCHED && sc.off ? max(nb, 1) + 1 : LB + 1;
  tl.a = ac + static_cast<size_t>(j) * LA;
  tl.b = bc + static_cast<size_t>(j) * LB;
  tl.kmul = TABLE ? Kb : 1;
  const size_t plane = static_cast<size_t>(LA + LB - 1) * (LB + 1);
  const size_t at_j =
      SCHED && sc.off ? static_cast<size_t>(sc.off[j]) : j * plane;
  tl.dj = DIRS ? dirs + at_j : nullptr;
  tl.mj = MBYTES ? static_cast<typename T::MT*>(mout) + at_j : nullptr;
  if constexpr (GAB) tl.gstride = gridDim.x * plane;
  tl.tab = sub;
  if constexpr (MODES) {
    tl.modes = modes;
    tl.im = im;
  }
  if (TABLE && table_smem) {
    int* t = smem + W * 3 * RING;
    for (int i = threadIdx.x; i < sub_n; i += blockDim.x) t[i] = sub[i];
    tl.tab = t;
    if constexpr (MODES) {
      if (tl.flag(fill::NMM)) {  // the is-match table behind it
        for (int i = threadIdx.x; i < sub_n; i += blockDim.x)
          t[sub_n + i] = im[i];
        tl.im = t + sub_n;
      }
    }
  }
  tl.best = 0;
  if (threadIdx.x == 0) {
    if (SW) {
      scores[j] = 0;  // raised by the warps' atomicMax below
    } else if (na == 0 || nb == 0) {  // the corner is a boundary cell
      const int cm = (na == 0 && nb == 0) ? 0 : tl.mn;
      const int cga = na == 0 ? (nb == 0 ? 0 : tl.run(nb)) : tl.mn;
      const int cgb = nb == 0 ? (na == 0 ? 0 : tl.run(na)) : tl.mn;
      corner[3 * j] = cm;
      corner[3 * j + 1] = cga;
      corner[3 * j + 2] = cgb;
      scores[j] = fill::max3(cm, cga, cgb);
    }
  }
  __syncthreads();
  if (na == 0 || nb == 0) return;
  const int nstrips = (nb + S - 1) / S;
  const int Wj = min(nstrips, W);
  if (warp >= Wj) return;
  const int steps = (na + S + R - 1) / R * R;
  const int ndur = (steps + K - 1) / K;
  const int P = max(ndur + R + 1, Wj * (R + 1));
  const int lastS = nstrips - 1;
  const int Ttot = lastS / Wj * P + lastS % Wj * (R + 1) + ndur;
  int* rows = nstrips > Wj
                  ? scratch + static_cast<size_t>(SCHED ? sc.wrap[j] : j) *
                                  3 * (LA + 1)
                  : nullptr;
  // a block of R steps runs unchecked only where every cell is valid and,
  // under MODES, none lies on the columns x == 1 and x == na of the flags
  constexpr int ulo = MODES ? S + R : S;
  const int uhi = MODES ? na - 1 : na;
  for (int t = 0; t < Ttot; ++t) {
    const int rel = t - warp * (R + 1);
    if (rel >= 0) {
      const int q = rel % P;
      const int s = rel / P * Wj + warp;
      if (s < nstrips && q < ndur) {
        if (q == 0) {
          tl.begin(m1, a1, b1, m2, a2, b2, h, bcd, s);
          tl.row0 = s == 0;
          if (warp > 0) {  // the ring of the warp before
            tl.src = smem + (warp - 1) * 3 * RING;
            tl.sstride = RING;
            tl.smask = RING - 1;
            tl.smax = 0x7fffffff;
          } else {  // the round's row
            tl.src = rows;
            tl.sstride = LA + 1;
            tl.smask = -1;
            tl.smax = na;
          }
          if (s == lastS) {
            tl.dst = nullptr;
          } else if (warp < Wj - 1) {
            tl.dst = smem + warp * 3 * RING;
            tl.dstride = RING;
            tl.dmask = RING - 1;
            tl.dlo = -0x7fffffff;
            tl.dhi = 0x7fffffff;
          } else {
            tl.dst = rows;
            tl.dstride = LA + 1;
            tl.dmask = -1;
            tl.dlo = 0;
            tl.dhi = na;
          }
          if (tl.lane == 31) tl.fetch(0);
        }
        const int iend = min(q * K + K, steps);
        for (int i0 = q * K; i0 < iend; i0 += R) {
          if (tl.full && i0 >= ulo && i0 + R - 1 <= uhi) {
#pragma unroll
            for (int u = 0; u < R; ++u)
              tl.template step<false>(m1, a1, b1, m2, a2, b2, h, bcd, i0 + u,
                                      corner, scores, j);
          } else if constexpr (MBYTES == 0 && !(DIRS && MODES)) {
#pragma unroll
            for (int u = 0; u < R; ++u)
              tl.template step<true>(m1, a1, b1, m2, a2, b2, h, bcd, i0 + u,
                                     corner, scores, j);
          } else {  // unrolled, the codes-and-M fills measured slower, and
                    // the flagged codes fills spilled
#pragma unroll 1
            for (int u = 0; u < R; ++u)
              tl.template step<true>(m1, a1, b1, m2, a2, b2, h, bcd, i0 + u,
                                     corner, scores, j);
          }
        }
      }
    }
    asm volatile("bar.sync 1, %0;" ::"r"(Wj * 32) : "memory");
  }
  if (SW) {
    const int best = __reduce_max_sync(FULL, tl.best);
    if (tl.lane == 0 && best > 0) atomicMax(scores + j, best);
  }
}

template <bool DIRS, bool SW, bool TABLE, int MBYTES, bool SCHED, int R,
          bool MODES, bool GAB>
int start(const void* ac, const void* bc, const void* na, const void* nb,
          const void* scal, const void* sub, const void* im, int modes,
          int Kb, int sub_n, int table_smem, int B, int LA, int LB,
          void* scores, void* corner, void* dirs, void* mout, void* scratch,
          void* stream, const fill::Sched& sc) {
  constexpr int S = 32 * R;
  const int W = min((max(LB, 1) + S - 1) / S, BLOCK_WARPS);
  const size_t smem =
      static_cast<size_t>(W) * 3 * RING * 4 +
      (TABLE && table_smem ? static_cast<size_t>(4) * sub_n * (im ? 2 : 1)
                           : 0);
  auto kernel =
      tile_fill_kernel<DIRS, SW, TABLE, MBYTES, SCHED, R, MODES, GAB>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  kernel<<<B, 32 * W, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(ac), static_cast<const uint8_t*>(bc),
      static_cast<const int*>(na), static_cast<const int*>(nb),
      static_cast<const int*>(scal), static_cast<const int*>(sub), Kb, sub_n,
      table_smem, LA, LB, static_cast<int*>(scores),
      static_cast<int*>(corner), static_cast<uint8_t*>(dirs), mout,
      static_cast<int*>(scratch), sc, static_cast<const int*>(im), modes);
  return cudaGetLastError();
}

// A fill launch: the table or none, a schedule or none, at THREAD_LANES
// lanes a thread; MODES for a flag word `modes` != 0 (`im`, the is-match
// table, passed on only under NMM with a table); GAB for the matrix dump,
// which takes no schedule (so none of its instantiations has one), at
// GAB_LANES.
template <bool DIRS, bool SW, int MBYTES, bool MODES, bool GAB>
int launch(const void* ac, const void* bc, const void* na, const void* nb,
           const void* scal, const void* sub, const void* im, int modes,
           int Kb, int sub_n, int table_smem, int B, int LA, int LB,
           void* scores, void* corner, void* dirs, void* mout, void* scratch,
           void* stream, const fill::Sched& sc) {
  constexpr int R = GAB ? GAB_LANES : THREAD_LANES;
  constexpr bool SCHED = !GAB;
  if (sub) {
    const void* imp = (modes & fill::NMM) ? im : nullptr;
    return sc.order ? start<DIRS, SW, true, MBYTES, SCHED, R, MODES, GAB>(
                          ac, bc, na, nb, scal, sub, imp, modes, Kb, sub_n,
                          table_smem, B, LA, LB, scores, corner, dirs, mout,
                          scratch, stream, sc)
                    : start<DIRS, SW, true, MBYTES, false, R, MODES, GAB>(
                          ac, bc, na, nb, scal, sub, imp, modes, Kb, sub_n,
                          table_smem, B, LA, LB, scores, corner, dirs, mout,
                          scratch, stream, sc);
  }
  return sc.order ? start<DIRS, SW, false, MBYTES, SCHED, R, MODES, GAB>(
                        ac, bc, na, nb, scal, nullptr, nullptr, modes, 0, 0,
                        0, B, LA, LB, scores, corner, dirs, mout, scratch,
                        stream, sc)
                  : start<DIRS, SW, false, MBYTES, false, R, MODES, GAB>(
                        ac, bc, na, nb, scal, nullptr, nullptr, modes, 0, 0,
                        0, B, LA, LB, scores, corner, dirs, mout, scratch,
                        stream, sc);
}

// The default flags (modes == 0) or the flags' instantiations (MODES);
// GAB: the matrix dump's fill, codes and the int32 M, Ga and Gb planes.
template <bool DIRS, bool SW, int MBYTES, bool GAB = false>
int launch_modes(const void* ac, const void* bc, const void* na,
                 const void* nb, const void* scal, const void* sub,
                 const void* im, int modes, int Kb, int sub_n,
                 int table_smem, int B, int LA, int LB, void* scores,
                 void* corner, void* dirs, void* mout, void* scratch,
                 void* stream, const fill::Sched& sc) {
  static_assert(!GAB || (DIRS && MBYTES == 4), "the dump stores int32 M");
  return modes ? launch<DIRS, SW, MBYTES, true, GAB>(
                     ac, bc, na, nb, scal, sub, im, modes, Kb, sub_n,
                     table_smem, B, LA, LB, scores, corner, dirs, mout,
                     scratch, stream, sc)
               : launch<DIRS, SW, MBYTES, false, GAB>(
                     ac, bc, na, nb, scal, sub, im, modes, Kb, sub_n,
                     table_smem, B, LA, LB, scores, corner, dirs, mout,
                     scratch, stream, sc);
}

#undef TILE_LANES_ARGS

}  // namespace tile

// The fill entries call tile::launch_modes with these arguments.
#define TILE_ARGS                                                          \
  ac, bc, na, nb, scal, sub, im, modes, Kb, sub_n, table_smem, B, LA, LB,  \
      scores, corner, dirs, mout, scratch, stream, SCHED_ARGS
