// What the fills of nw_scores.cu, nw_dirs.cu, sw_scores.cu and sw_dirs.cu
// share: the integer helpers, the direction codes and the scoring flags'
// bits, the schedule of a launch across widths, a carry launch's chunk,
// and the entry points' C signatures.  Every fill, under any flags and the
// matrix dump's (GAB) among them, runs on the register tiles:
// tile_fill.cuh (a batch, uniform or across widths; its "Modes" paragraph
// gives the flags' rules) and tile_carry.cuh (one chunk of long pairs).
//
// Sums wrap in two's complement, like the int32 fills of the JAX package,
// so every value agrees bit for bit.

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

// A slice of a carry launch (tile_carry.cuh, SLICE): the rounds r_lo ..
// r_hi-1 of every pair's lanes, one block each.  ein: the edge row that
// enters round r_lo (the last lane of round r_lo - 1, by local column 0 ..
// CA), complete before the launch; eout: the edge row of round r_hi - 1,
// written for the pairs with lanes past it; (B, 3, CA+1) int32 each, null
// for the first and the last slice.
struct Slice {
  const int* ein;
  int* eout;
  int r_lo;
  int r_hi;
};

}  // namespace fill

// The fill entry points share one C signature (ops/build.py):
// ac, bc, na, nb, scal, sub, im, modes, Kb, sub_n, table_smem, B, LA, LB,
// scores, corner, dirs, mout, m16, scratch, stream, and the schedule:
// order, wrap, off (each null or a device array; the matrix dump passes
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

// The slice entry points (a run of rounds of a carry launch, the
// sequence-parallel fills) add to a carry entry's arguments: the edge rows
// in and out and the rounds r_lo .. r_hi-1 (ops/build.py).
#define SLICE_ENTRY(name)                                                    \
  extern "C" int name(const void* ac, const void* bc, const void* na,       \
                      const void* nb, const void* scal, const void* sub,     \
                      const void* im, int modes, int Kb, int sub_n,          \
                      int table_smem, int B, int LA, int LB, void* scores,   \
                      void* corner, void* dirs, void* mout, int m16,         \
                      void* scratch, void* stream, const void* bin,          \
                      void* bout, int x_off, int CA, long long dstride,      \
                      long long mstride, int warps, const void* ein,         \
                      void* eout, int r_lo, int r_hi)

#define SLICE_ARGS                                                           \
  fill::Slice { static_cast<const int*>(ein), static_cast<int*>(eout),      \
                r_lo, r_hi }
