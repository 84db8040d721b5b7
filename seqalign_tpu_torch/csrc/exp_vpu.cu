// ALU probe: S dependent steps of one elementwise op on an (R, L) block of
// int32 or int16, the H100 counterpart of the VPU chain kernel of
// tools/exp_vpu.py:42-56 (a Pallas kernel on a VMEM-resident block).  It
// measures the rates the fills are made of: an int32 add, the Hopper DPX
// add-max (__viaddmax_s32, __viaddmax_s16x2 on two int16 lanes in one
// register; nvcc makes the same VIADDMNMX of an add then a max), and a
// one-lane move along a row as the register tiles (tile_fill.cuh) make it:
// each thread holds consecutive words of the row in registers, the move
// inside a thread is register renaming, and one warp shuffle a step
// carries the word that crosses from the thread before.  No block-wide
// barrier and no shared memory, as in the fills since the tiles.
//
// The ops, on w (starting at v = x) and v = x:
//   ADDMAX  w = max(w + v, w)
//   ADD     w = w + v
//   ROLL    w[j] = w[j - 1] + v[j], lane 0 taking w[L - 1] (pltpu.roll(w, 1,
//           1) + v)
//   SHIFT   the same but lane 0 takes 1
// Sums wrap in two's complement in each type, as JAX's int32 and int16 do.
//
// Words: int32 is one lane a 32-bit word; int16 two neighbouring lanes
// (2j, 2j+1) in the low and high halves of word j, so that the int16 ops
// are the packed SIMD forms and an int16 move carries a half word between
// words by __byte_perm.  A row has W words (W = L, or L / 2 for int16).
//
// Layout of a move (ROLL, SHIFT): a group of T threads of one warp a row,
// K consecutive words a thread in registers (thread t holds words t K ..
// t K + K - 1; K a template parameter, so that the move unrolls into
// renaming).  A row of more than 32 words takes a whole warp (T = 32, K =
// W / 32 rounded up to a power of two, 2 to 32); a row of up to 32 words a
// sub-warp group of T = 1 to 8 threads of K = 4 words (the tiles' R = 4
// lanes a thread), 32 / T rows a warp (the shuffle's width T).  Each step,
// every thread sends its last word, thread t takes thread t - 1's, and
// thread 0 takes the row's last word (ROLL: thread (W - 1) / K, slot
// (W - 1) % K, which is slot K - 1 unless W is not K-aligned, the WRAP
// instantiation that picks the slot) or 1 (SHIFT).  Words past W are
// dead: computed, never stored.  Four warps a block, one a scheduler
// partition of an SM.
//
// Layout of ADDMAX and ADD: the same registers, two lanes a thread (K = 2
// words of int32, one of int16), but with no move a thread's words may run
// past the end of a row: the block is one run of R W words, so a 256 x 512
// block keeps 2,048 warps in flight, eight a block.
//
// An empty asm makes v opaque at each step, so that the compiler cannot
// fold the chain (S adds of one v into one multiply).
//
// What bounds it on an H100: the ALU issue rate, and for a move the
// warps there are (a warp a row: R warps, at R = 256 under half of the
// card's 528 scheduler partitions) and the shuffle a step; the 2 R L
// bytes of each of x and o are nothing beside S steps.  It allocates
// nothing and does not synchronise.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

enum { ADDMAX = 0, ADD = 1, ROLL = 2, SHIFT = 3 };
constexpr int THREADS = 128;       // a move's block: four warps
constexpr int LANE_THREADS = 256;  // an add's block: eight warps

template <int OP, bool I16>
__device__ __forceinline__ uint32_t lane_op(uint32_t w, uint32_t v) {
  if constexpr (OP == ADDMAX) {
    if constexpr (I16) {
      return __viaddmax_s16x2(w, v, w);
    } else {
      return static_cast<uint32_t>(__viaddmax_s32(
          static_cast<int>(w), static_cast<int>(v), static_cast<int>(w)));
    }
  } else {
    return I16 ? __vadd2(w, v) : w + v;  // unsigned: wraps
  }
}

// ADDMAX, ADD: K words a thread of the run of n words
template <int OP, bool I16, int K>
__global__ void __launch_bounds__(LANE_THREADS)
    lane_chain_kernel(const uint32_t* __restrict__ x,
                      uint32_t* __restrict__ o, size_t n, int S) {
  const size_t j0 =
      (static_cast<size_t>(blockIdx.x) * LANE_THREADS + threadIdx.x) * K;
  uint32_t v[K], w[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    v[k] = j0 + k < n ? x[j0 + k] : 0u;
    w[k] = v[k];
  }
  for (int i = 0; i < S; ++i) {
#pragma unroll
    for (int k = 0; k < K; ++k) {
      asm volatile("" : "+r"(v[k]));
      w[k] = lane_op<OP, I16>(w[k], v[k]);
    }
  }
#pragma unroll
  for (int k = 0; k < K; ++k)
    if (j0 + k < n) o[j0 + k] = w[k];
}

// ROLL, SHIFT: a group of T threads a row, K words a thread; WRAP (ROLL on
// a row that is not K-aligned) picks the row's last word from its slot
template <int OP, bool I16, int K, int T, bool WRAP>
__global__ void __launch_bounds__(THREADS)
    move_chain_kernel(const uint32_t* __restrict__ x,
                      uint32_t* __restrict__ o, int R, int W, int S) {
  const int g = blockIdx.x * THREADS + threadIdx.x;
  const int row = g / T;  // rows past R run the shuffles, store nothing
  const int t = g % T;
  const bool live = row < R;
  const size_t base = static_cast<size_t>(row) * W;
  uint32_t v[K], w[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int j = t * K + k;
    v[k] = live && j < W ? x[base + j] : 0u;
    w[k] = v[k];
  }
  const int tl = (W - 1) / K;  // the thread and slot of the last word
  const int sl = (W - 1) % K;
  const int src = t == 0 ? tl : t - 1;
  for (int i = 0; i < S; ++i) {
#pragma unroll
    for (int k = 0; k < K; ++k) asm volatile("" : "+r"(v[k]));
    uint32_t send = w[K - 1];
    if constexpr (WRAP) {
      uint32_t last = w[0];
#pragma unroll
      for (int k = 1; k < K; ++k) last = k == sl ? w[k] : last;
      send = t == tl ? last : send;
    }
    uint32_t prev = __shfl_sync(0xffffffffu, send, src, T);
    // lane 0 takes 1 (SHIFT): int16 moves the high half of prev into the
    // low half
    if (OP == SHIFT && t == 0) prev = I16 ? 0x00010000u : 1u;
    // the move inside the thread, from the last word down so that each
    // reads its left neighbour's old value: renaming once unrolled.  int16:
    // the lanes (2j, 2j+1) take (2j-1, 2j), the high half of the word
    // before and the low half of its own
#pragma unroll
    for (int k = K - 1; k > 0; --k)
      w[k] = I16 ? __vadd2(__byte_perm(w[k - 1], w[k], 0x5432), v[k])
                 : w[k - 1] + v[k];
    w[0] = I16 ? __vadd2(__byte_perm(prev, w[0], 0x5432), v[0])
               : prev + v[0];
  }
  if (!live) return;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int j = t * K + k;
    if (j < W) o[base + j] = w[k];
  }
}

template <int OP, bool I16, int K, int T>
int start_move(const uint32_t* x, uint32_t* o, int R, int W, int S,
               cudaStream_t st) {
  const long long threads = static_cast<long long>(R) * T;
  const int blocks = static_cast<int>((threads + THREADS - 1) / THREADS);
  if constexpr (OP == ROLL) {
    if (W % K != 0) {
      move_chain_kernel<OP, I16, K, T, true>
          <<<blocks, THREADS, 0, st>>>(x, o, R, W, S);
      return cudaGetLastError();
    }
  }
  move_chain_kernel<OP, I16, K, T, false>
      <<<blocks, THREADS, 0, st>>>(x, o, R, W, S);
  return cudaGetLastError();
}

template <int OP, bool I16>
int start(const void* x, void* o, int R, int W, int S, cudaStream_t st) {
  const auto xi = static_cast<const uint32_t*>(x);
  const auto oi = static_cast<uint32_t*>(o);
  if constexpr (OP == ADDMAX || OP == ADD) {
    constexpr int K = I16 ? 1 : 2;  // two lanes a thread
    const size_t n = static_cast<size_t>(R) * W;
    const size_t per = static_cast<size_t>(LANE_THREADS) * K;
    lane_chain_kernel<OP, I16, K>
        <<<static_cast<unsigned>((n + per - 1) / per), LANE_THREADS, 0,
           st>>>(xi, oi, n, S);
    return cudaGetLastError();
  } else {
    // a sub-warp group of K = 4 words a thread up to 32 words, else a warp
    // of the least power of two K >= W / 32
    if (W <= 4) return start_move<OP, I16, 4, 1>(xi, oi, R, W, S, st);
    if (W <= 8) return start_move<OP, I16, 4, 2>(xi, oi, R, W, S, st);
    if (W <= 16) return start_move<OP, I16, 4, 4>(xi, oi, R, W, S, st);
    if (W <= 32) return start_move<OP, I16, 4, 8>(xi, oi, R, W, S, st);
    if (W <= 64) return start_move<OP, I16, 2, 32>(xi, oi, R, W, S, st);
    if (W <= 128) return start_move<OP, I16, 4, 32>(xi, oi, R, W, S, st);
    if (W <= 256) return start_move<OP, I16, 8, 32>(xi, oi, R, W, S, st);
    if (W <= 512) return start_move<OP, I16, 16, 32>(xi, oi, R, W, S, st);
    return start_move<OP, I16, 32, 32>(xi, oi, R, W, S, st);
  }
}

template <bool I16>
int dispatch(const void* x, void* o, int R, int W, int S, int op,
             cudaStream_t st) {
  switch (op) {
    case ADDMAX:
      return start<ADDMAX, I16>(x, o, R, W, S, st);
    case ADD:
      return start<ADD, I16>(x, o, R, W, S, st);
    case ROLL:
      return start<ROLL, I16>(x, o, R, W, S, st);
    case SHIFT:
      return start<SHIFT, I16>(x, o, R, W, S, st);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// x, o: (R, L) int32, or int16 with L even; L / 2 or L words a row, at most
// 1024.  op: 0 addmax, 1 add, 2 roll, 3 shift.
extern "C" int vpu_chain_launch(const void* x, void* o, int R, int L, int S,
                                int op, int i16, void* stream) {
  const int W = i16 ? L / 2 : L;
  if (R < 1 || W < 1 || W > 1024 || (i16 && (L & 1)) || S < 0)
    return cudaErrorInvalidValue;
  const auto st = static_cast<cudaStream_t>(stream);
  return i16 ? dispatch<true>(x, o, R, W, S, op, st)
             : dispatch<false>(x, o, R, W, S, op, st);
}
