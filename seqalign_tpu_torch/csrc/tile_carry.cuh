// One chunk of a long pair's fill on the register tiles of tile_fill.cuh,
// each round of a pair's lanes on a block of its own: the carry fills of
// nw_dirs.cu and sw_dirs.cu (codes, and SW M as int16 or int32), the
// default recurrence or any combination of the scoring flags (MODES, as
// tile_fill.cuh applies them), equality or substitution-table scoring.
//
// Replaces the chunked mode of seqalign_tpu/ops/pallas_dp.py:_dirs_kernel
// as fill_dirs_long drives it with _next_bcol (pallas_dp.py:1199-1334),
// and computes what the JAX package's dp.fill_chunked computes, chunk by
// chunk, bit for bit: the columns x_off+1 .. x_off+CA of the global DP,
// local x = 1 .. min(CA, na - x_off) with `a` read at global x; row 0
// computed as the global row-0 cells at x_off + x (strip 0's source; no
// gap run under NSG); the lane at local x == 0 taking bin[y] for the
// closed-form boundary, the cell (0, x_off) being the origin or a row-0
// cell; the flags' last column and x == 1 guard at global x (local
// na - x_off and 1 - x_off); the column x_off + CA to bout on lanes 1 ..
// nb when the pair reaches it; codes and M at slab row xl + y - 2 at the
// caller's pair strides (Carry.dstride, Carry.mstride), so that
// slab.cuh's rule and the walks are unchanged; the NW corner written by
// the chunk that holds na (an empty seq_a's from bin[nb] by the chunk at
// x_off = 0, an empty seq_b's as the row-0 cell (0, na)); SW raising
// scores[j] by atomicMax across launches, never resetting it.  Only the
// valid cells of the chunk (1 <= y <= nb, 1 <= xl <= its width) are
// written, and nothing but lanes 1 .. nb of bout.  Lane 0 of bin is read
// only for the corner of a pair with both sides empty; no row-0 cell is
// carried.
//
// Layout.  A block is W warps, a warp a strip of S = 32 * R lanes of b, as
// in tile_fill.cuh; round r of pair j is strips r*W .. r*W + W-1, and every
// round runs on a block of its own, so one long pair fills as many SMs as
// it has rounds.  Inside a round the order is the tiles' (strips K
// diagonals apart, warp w R+1 macro steps behind warp w-1, the edge
// through the warp's shared ring; each warp holds one strip, so no period
// is needed).  Between rounds the edge (the last lane's M, Ga, Gb by local
// column 0 .. width) goes through a row of 3 * (CA+1) int32 of its own in
// global scratch, one for each round boundary of each pair, with a
// progress word beside it: after each macro step, thread 31 of the last
// warp of round r-1 (the only thread that writes the row) fences and
// stores, with release semantics, the count of columns it has written;
// before a macro step that reads a column it has not yet seen published,
// warp 0 of round r spins on acquire loads of that word (every lane, so
// that each lane's own loads are ordered after its acquire; the row is
// read through L2), and its warps follow it through the block's barrier.
// A wait that passes SPIN_NS traps, so that a schedule fault fails the
// launch instead of hanging it.
//
// Progress without co-residency: a block takes its (pair, round) from a
// ticket, an atomicAdd on the launch's counter, never from blockIdx; ticket
// t is pair t mod B, round t / B, so that the producer of every round (the
// same pair's round before) holds ticket t - B, taken by a block that is
// already running.  A block waits only on such a block, and the grid may be
// of any size.  The wrapper zeroes the counter and the progress words before
// each launch (cudaMemsetAsync here); rows are never reused within one.
//
// Slices (SLICE, the sequence-parallel fills of parallel/wavefront_sp.py):
// a launch of the rounds r_lo .. r_hi-1 only (fill::Slice), the lanes
// y_lo+1 .. y_hi of every pair with y_lo = r_lo * W * S, so that each
// slice of one pair's lanes runs on a device of its own.  The edge between
// two slices is the edge between two rounds: round r_lo's warp 0 reads the
// row of round r_lo - 1's last lane from ein, which a launch before this
// one wrote (the previous slice's, behind the host's event and copy), so
// it is complete and no word is waited on; round r_hi - 1's last warp
// writes its row to eout for a pair with lanes past the slice, and
// publishes no word.  Rounds inside the slice hand over through the
// launch's own rows and words, as the carry's do.  Only global round 0
// (the first slice) takes the corners of empty sides; the NW corner is
// written by the slice that holds lane nb, and SW raises each slice's best.
// Replaces the per-diagonal ppermute halo of seqalign_tpu/parallel/
// wavefront_sp.py:_local_fill and :_sp_chunk_dirs with a row a chunk.  DIRS
// false: the scores-only carry, no codes and no M (nw_scores.cu,
// sw_scores.cu); DIRS true: the codes at slab.cuh's rule (nw_dirs.cu).
//
// What bounds it on an H100: as the tiles, integer issue with the code
// stores second; a pair's chunk is a wavefront of width + nb diagonals whose
// strips start R+1 macro steps apart, so a round waits about W*(R+1) macro
// steps for its predecessor, and a launch fills min(SMs, pairs x rounds)
// SMs; the host picks W (ops/kernels.py:carry_warps) so that pairs x
// rounds reaches the card's SM count where the pairs allow.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#include "fill_common.cuh"
#include "tile_fill.cuh"

namespace tile {

// int32 between two progress words (a 128-byte line each), and the
// longest a warp waits for one before it traps
constexpr int WORD = 32;
// R of the flags' carry (MODES): at THREAD_LANES its instantiations
// spilled past the 128 registers a thread of 16 warps a block; at 2 lanes a
// thread, 16 lanes of registers fewer, they do not.  A carry block has at
// most BLOCK_WARPS warps (tile_fill.cuh), whatever its R.
constexpr int MODES_LANES = 2;
constexpr unsigned long long SPIN_NS = 10000000000ull;

// The round rows of one carry launch, in the scratch the wrapper gives:
// nrows = B * (rounds - 1) progress words WORD int32 apart, the ticket
// counter after them, then the rows, 3 * (CA+1) int32 each; boundary r
// (between rounds r and r+1) of pair j is row and word r * B + j.
struct Rounds {
  int* words;
  int* rows;
  int rounds;  // rounds of a pair of the launch's widest b
};

__device__ __forceinline__ int load_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.b32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void store_release(int* p, int v) {
  asm volatile("st.release.gpu.b32 [%0], %1;" ::"l"(p), "r"(v) : "memory");
}

__device__ __forceinline__ unsigned long long now_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// The whole warp waits until *p >= need, each lane by its own acquire
// loads; returns the least value the lanes saw.  Out of line (and of the
// hot loop's registers); static, as the header is in two sources.
static __device__ __noinline__ int wait_for(const int* p, int need) {
  int v = load_acquire(p);
  if (!__all_sync(FULL, v >= need)) {
    const unsigned long long t0 = now_ns();
    do {
      __nanosleep(64);
      if (now_ns() - t0 > SPIN_NS) __trap();
      v = load_acquire(p);
    } while (!__all_sync(FULL, v >= need));
  }
  return __reduce_min_sync(FULL, v);
}

// scal, sub, im, modes, scores, corner, dirs, mout as tile_fill_kernel's;
// the chunk in cr; the rounds' rows, words and counter in rd (rd.rounds
// the launch's rounds, those of a slice under SLICE); the slice in sl.  im
// and modes are read under MODES only, and come last, as there, and sl
// under SLICE only, after them.
template <bool SW, bool TABLE, int MBYTES, int R, bool MODES = false,
          bool SLICE = false, bool DIRS = true>
__global__ void __launch_bounds__(32 * BLOCK_WARPS)
    tile_carry_kernel(const uint8_t* __restrict__ ac,
                      const uint8_t* __restrict__ bc,
                      const int* __restrict__ na_,
                      const int* __restrict__ nb_,
                      const int* __restrict__ scal,
                      const int* __restrict__ sub, int Kb, int sub_n,
                      int table_smem, int B, int LA, int LB,
                      int* __restrict__ scores, int* __restrict__ corner,
                      uint8_t* __restrict__ dirs, void* __restrict__ mout,
                      Rounds rd, fill::Carry cr, const int* __restrict__ im,
                      int modes, fill::Slice sl) {
  using T = Tile<DIRS, SW, TABLE, MBYTES, R, true, MODES>;
  constexpr int S = T::S;
  extern __shared__ int smem[];
  __shared__ int ticket;
  const int W = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5;
  const int nrows = B * (rd.rounds - 1);
  if (threadIdx.x == 0) ticket = atomicAdd(rd.words + nrows * WORD, 1);
  __syncthreads();
  // rl: the round within the launch; r: the pair's round
  const int j = ticket % B, rl = ticket / B;
  const int r = SLICE ? sl.r_lo + rl : rl;
  // a slice's first round past round 0 reads the edge row in, its last
  // round writes the edge row out
  const bool ein = SLICE && rl == 0 && r > 0;
  const bool eout = SLICE && rl == rd.rounds - 1;
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
  const int xo = cr.x_off;
  // the chunk's local width wa, and whether the pair ends before the chunk
  // or reaches its last column, each from na - x_off: ptxas (CUDA 12.8,
  // sm_90a) evaluated wa == CA false for equal values when wa was
  // max(0, min(CA, na - x_off)), and no column went out
  const int avail = na - xo;
  const bool ended = avail <= 0, reach = avail >= cr.CA;
  const int wa = ended ? 0 : (reach ? cr.CA : avail);
  tl.na = wa;
  tl.nb = nb;
  tl.LBp = LB + 1;
  tl.a = ac + static_cast<size_t>(j) * LA + xo;
  tl.b = bc + static_cast<size_t>(j) * LB;
  tl.kmul = TABLE ? Kb : 1;
  tl.dj = DIRS ? dirs + j * static_cast<size_t>(cr.dstride) : nullptr;
  tl.mj = MBYTES ? static_cast<typename T::MT*>(mout) +
                       j * static_cast<size_t>(cr.mstride)
                 : nullptr;
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
  tl.x0 = xo;
  tl.bstride = LB + 1;
  tl.bin = cr.bin + static_cast<size_t>(j) * 3 * (LB + 1);
  tl.bout = cr.bout + static_cast<size_t>(j) * 3 * (LB + 1);
  tl.bcol = reach ? cr.CA : 0x7fffffff;
  tl.cx = na <= xo + cr.CA ? wa : 0x7fffffff;
  if (!SW && r == 0 && threadIdx.x == 0) {
    if (ended) {  // the pair ends before this chunk
      if (na == 0 && xo == 0) {  // the corner is the cell (nb, 0)
        const int* q = tl.bin + nb;
        corner[3 * j] = q[0];
        corner[3 * j + 1] = q[LB + 1];
        corner[3 * j + 2] = q[2 * (LB + 1)];
        scores[j] = fill::max3(q[0], q[LB + 1], q[2 * (LB + 1)]);
      }
    } else if (nb == 0 && na <= xo + cr.CA) {  // the row-0 cell (0, na)
      corner[3 * j] = tl.mn;
      corner[3 * j + 1] = tl.mn;
      corner[3 * j + 2] = tl.run(na);
      scores[j] = max(tl.mn, tl.run(na));
    }
  }
  __syncthreads();
  if (ended || nb == 0) return;
  const int nstrips = (nb + S - 1) / S;
  const int s = r * W + warp;
  const int Wj = min(W, nstrips - r * W);  // this round's strips
  if (warp >= Wj) return;
  const int steps = (wa + S + R - 1) / R * R;
  const int ndur = (steps + K - 1) / K;
  const int Ttot = (Wj - 1) * (R + 1) + ndur;
  const int cols = cr.CA + 1;
  const size_t in = static_cast<size_t>(rl - 1) * B + j;  // rl > 0
  const size_t out = static_cast<size_t>(rl) * B + j;
  // the last warp hands its strip's last lane on when lanes follow it (a
  // slice's last round only where it has an edge row out)
  const bool producer =
      warp == Wj - 1 && s < nstrips - 1 && !(eout && !sl.eout);
  // a block of R steps runs unchecked only where every cell is valid, and
  // left of the column that goes out; under MODES, also off the flags'
  // columns, global x == 1 and the pair's last, cx (past wa where the
  // pair goes on: left of wa in both cases)
  constexpr int ulo = MODES ? S + R : S;
  const int ulim = MODES ? wa - 1 : (reach ? cr.CA - 1 : wa);
  int seen = 0;  // warp 0: columns of its round row seen published
  for (int t = 0; t < Ttot; ++t) {
    const int q = t - warp * (R + 1);
    if (q >= 0 && q < ndur) {
      if (warp == 0 && rl > 0) {  // columns up to (q+1) K, by fetch(i + 1)
        const int need = min((q + 1) * K, wa) + 1;
        if (need > seen) seen = wait_for(rd.words + in * WORD, need);
      }
      if (q == 0) {
        tl.begin(m1, a1, b1, m2, a2, b2, h, bcd, s);
        tl.row0 = s == 0;
        tl.gsrc = warp == 0;
        if (warp > 0) {  // the ring of the warp before
          tl.src = smem + (warp - 1) * 3 * RING;
          tl.sstride = RING;
          tl.smask = RING - 1;
          tl.smax = 0x7fffffff;
        } else {  // row 0, the round row of the block before, or the edge in
          tl.src = ein ? sl.ein + static_cast<size_t>(j) * 3 * cols
                       : (rl > 0 ? rd.rows + in * 3 * cols : nullptr);
          tl.sstride = cols;
          tl.smask = -1;
          tl.smax = wa;
        }
        if (s == nstrips - 1) {
          tl.dst = nullptr;
        } else if (!producer) {
          tl.dst = smem + warp * 3 * RING;
          tl.dstride = RING;
          tl.dmask = RING - 1;
          tl.dlo = -0x7fffffff;
          tl.dhi = 0x7fffffff;
        } else {
          tl.dst = eout ? sl.eout + static_cast<size_t>(j) * 3 * cols
                        : rd.rows + out * 3 * cols;
          tl.dstride = cols;
          tl.dmask = -1;
          tl.dlo = 0;
          tl.dhi = wa;
        }
        if (tl.lane == 31) tl.fetch(0);
      }
      const int iend = min(q * K + K, steps);
      for (int i0 = q * K; i0 < iend; i0 += R) {
        if (tl.full && i0 >= ulo && i0 + R - 1 <= ulim) {
          if constexpr (MODES) {  // rolled: unrolled, it spilled
#pragma unroll 1
            for (int u = 0; u < R; ++u)
              tl.template step<false>(m1, a1, b1, m2, a2, b2, h, bcd,
                                      i0 + u, corner, scores, j);
          } else {
#pragma unroll
            for (int u = 0; u < R; ++u)
              tl.template step<false>(m1, a1, b1, m2, a2, b2, h, bcd,
                                      i0 + u, corner, scores, j);
          }
        } else {  // rolled: unrolled, the NW carry spilled at 128 registers
#pragma unroll 1
          for (int u = 0; u < R; ++u)
            tl.template step<true>(m1, a1, b1, m2, a2, b2, h, bcd, i0 + u,
                                   corner, scores, j);
        }
      }
      if (producer && !eout && tl.lane == 31) {  // columns 0 .. done-1
        const int done = min((q + 1) * K - S + 1, wa + 1);
        if (done > 0) {
          __threadfence();
          store_release(rd.words + out * WORD, done);
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

// One carry launch at W warps a block (1 .. BLOCK_WARPS): zeroes the
// words and the counter of `scratch`, then launches B x rounds blocks.
// The scratch holds ops/kernels.py:carry_scratch_ints(B, LB, CA, W, R)
// int32 (under SLICE, for the slice's rounds).  MODES for a flag word
// `modes` != 0, at R = MODES_LANES (`im` read only under NMM with a
// table); SLICE for the rounds sl.r_lo .. sl.r_hi-1 alone, DIRS false for
// the scores-only fill.
template <bool SW, int MBYTES, bool MODES, bool SLICE = false,
          bool DIRS = true>
int carry(const void* ac, const void* bc, const void* na, const void* nb,
          const void* scal, const void* sub, const void* im, int modes,
          int Kb, int sub_n, int table_smem, int B, int LA, int LB,
          void* scores, void* corner, void* dirs, void* mout, void* scratch,
          void* stream, const fill::Carry& cr, int W,
          const fill::Slice& sl = fill::Slice{}) {
  constexpr int R = MODES ? MODES_LANES : THREAD_LANES;
  constexpr int S = 32 * R;
  if (W < 1 || W > BLOCK_WARPS || cr.CA < 1 || !scratch)
    return cudaErrorInvalidValue;
  const int all = ((max(LB, 1) + S - 1) / S + W - 1) / W;
  if (SLICE && (sl.r_lo < 0 || sl.r_hi <= sl.r_lo || sl.r_hi > all))
    return cudaErrorInvalidValue;
  const int rounds = SLICE ? sl.r_hi - sl.r_lo : all;
  const int nrows = B * (rounds - 1);
  int* words = static_cast<int*>(scratch);
  const Rounds rd{words, words + static_cast<size_t>(nrows + 1) * WORD,
                  rounds};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e = cudaMemsetAsync(
      words, 0, static_cast<size_t>(nrows + 1) * WORD * sizeof(int), st);
  if (e != cudaSuccess) return e;
  const int* imp =
      sub && (modes & fill::NMM) ? static_cast<const int*>(im) : nullptr;
  const size_t smem =
      static_cast<size_t>(W) * 3 * RING * 4 +
      (sub && table_smem ? static_cast<size_t>(4) * sub_n * (imp ? 2 : 1)
                         : 0);
  auto run = [&](auto kernel) -> int {
    if (smem > 48 * 1024) {
      const cudaError_t a = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
          static_cast<int>(smem));
      if (a != cudaSuccess) return a;
    }
    kernel<<<B * rounds, 32 * W, smem, st>>>(
        static_cast<const uint8_t*>(ac), static_cast<const uint8_t*>(bc),
        static_cast<const int*>(na), static_cast<const int*>(nb),
        static_cast<const int*>(scal), static_cast<const int*>(sub), Kb,
        sub_n, table_smem, B, LA, LB, static_cast<int*>(scores),
        static_cast<int*>(corner), static_cast<uint8_t*>(dirs), mout, rd, cr,
        imp, modes, sl);
    return cudaGetLastError();
  };
  if (sub)
    return run(tile_carry_kernel<SW, true, MBYTES, R, MODES, SLICE, DIRS>);
  return run(tile_carry_kernel<SW, false, MBYTES, R, MODES, SLICE, DIRS>);
}

// The default flags (modes == 0) or the flags' instantiations (MODES).
template <bool SW, int MBYTES>
int carry_modes(const void* ac, const void* bc, const void* na,
                const void* nb, const void* scal, const void* sub,
                const void* im, int modes, int Kb, int sub_n, int table_smem,
                int B, int LA, int LB, void* scores, void* corner, void* dirs,
                void* mout, void* scratch, void* stream,
                const fill::Carry& cr, int W) {
  return modes ? carry<SW, MBYTES, true>(ac, bc, na, nb, scal, sub, im, modes,
                                         Kb, sub_n, table_smem, B, LA, LB,
                                         scores, corner, dirs, mout, scratch,
                                         stream, cr, W)
               : carry<SW, MBYTES, false>(ac, bc, na, nb, scal, sub, im,
                                          modes, Kb, sub_n, table_smem, B, LA,
                                          LB, scores, corner, dirs, mout,
                                          scratch, stream, cr, W);
}

// A slice of the default flags' carry (fill::Slice): the codes (DIRS, NW)
// or the scores alone; the flags are not taken (the sequence-parallel fills
// run the default recurrence only).
template <bool SW, bool DIRS>
int slice(const void* ac, const void* bc, const void* na, const void* nb,
          const void* scal, const void* sub, const void* im, int modes,
          int Kb, int sub_n, int table_smem, int B, int LA, int LB,
          void* scores, void* corner, void* dirs, void* mout, void* scratch,
          void* stream, const fill::Carry& cr, int W, const fill::Slice& sl) {
  if (modes) return cudaErrorInvalidValue;
  return carry<SW, 0, false, true, DIRS>(ac, bc, na, nb, scal, sub, im,
                                         modes, Kb, sub_n, table_smem, B, LA,
                                         LB, scores, corner, dirs, mout,
                                         scratch, stream, cr, W, sl);
}

}  // namespace tile

// The two carry entries call tile::carry_modes with these arguments, the
// slice entries tile::slice with these and the slice.
#define TILE_CARRY_ARGS                                                    \
  ac, bc, na, nb, scal, sub, im, modes, Kb, sub_n, table_smem, B, LA, LB,  \
      scores, corner, dirs, mout, scratch, stream, CARRY_ARGS, warps
#define TILE_SLICE_ARGS TILE_CARRY_ARGS, SLICE_ARGS
