// ALU probe: S dependent steps of one elementwise op on an (R, L) block of
// int32 or int16, the H100 counterpart of the VPU chain kernel of
// tools/exp_vpu.py:42-56 (a Pallas kernel on a VMEM-resident block).  It
// measures the rates the fills are made of: an int32 add, the Hopper DPX
// add-max (__viaddmax_s32, __viaddmax_s16x2 on two int16 lanes in one
// register; nvcc makes the same VIADDMNMX of an add then a max), and a
// one-lane move along a row, which needs a block
// barrier a step when the row spans warps, as the fills' diagonals do, and
// a warp shuffle when it fits in one warp.
//
// The ops, on w (starting at v = x) and v = x:
//   ADDMAX  w = max(w + v, w)
//   ADD     w = w + v
//   ROLL    w[j] = w[j - 1] + v[j], lane 0 taking w[L - 1] (pltpu.roll(w, 1,
//           1) + v)
//   SHIFT   the same but lane 0 takes 1
// Sums wrap in two's complement in each type, as JAX's int32 and int16 do.
//
// Layout: one block per row.  int32 holds one lane a thread; int16 two
// neighbouring lanes (2t, 2t+1) in the low and high halves of one 32-bit
// word a thread, so that the int16 ops are the packed SIMD forms.  A row of
// W words (W = L, or L / 2 for int16) takes W threads in whole warps; a
// move reads the word of thread t - 1 from shared memory (two buffers, one
// __syncthreads() a step) or, when W <= 32 (WARP), through __shfl_sync.
// An empty asm makes v opaque at each step, so that the compiler cannot
// fold the chain (S adds of one v into one multiply).
//
// What bounds it on an H100: the ALU issue rate, and for the block-wide
// move the barrier; the 2 R L bytes of each of x and o are nothing beside
// S steps.  It allocates nothing and does not synchronise.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

enum { ADDMAX = 0, ADD = 1, ROLL = 2, SHIFT = 3 };

__device__ __forceinline__ uint32_t add32(uint32_t a, uint32_t b) {
  return a + b;  // unsigned: wraps
}

template <int OP, bool I16, bool WARP>
__global__ void chain_kernel(const uint32_t* __restrict__ x,
                             uint32_t* __restrict__ o, int W, int S) {
  extern __shared__ uint32_t buf[];  // 2 * W words, moves across warps
  const int t = threadIdx.x;
  const size_t row = static_cast<size_t>(blockIdx.x) * W;
  uint32_t v = t < W ? x[row + t] : 0u;
  uint32_t w = v;
  for (int i = 0; i < S; ++i) {
    asm volatile("" : "+r"(v));
    if constexpr (OP == ADDMAX) {
      if constexpr (I16) {
        w = __viaddmax_s16x2(w, v, w);
      } else {
        w = static_cast<uint32_t>(__viaddmax_s32(
            static_cast<int>(w), static_cast<int>(v), static_cast<int>(w)));
      }
    } else if constexpr (OP == ADD) {
      w = I16 ? __vadd2(w, v) : add32(w, v);
    } else {
      const int src = t == 0 ? W - 1 : t - 1;
      uint32_t prev;
      if constexpr (WARP) {
        prev = __shfl_sync(0xffffffffu, w, src);
      } else {
        uint32_t* b = buf + (i & 1) * W;
        if (t < W) b[t] = w;
        __syncthreads();
        prev = t < W ? b[src] : 0u;
      }
      // lane 0 takes 1 (SHIFT): int16 moves the high half of prev into
      // the low half
      if (OP == SHIFT && t == 0) prev = I16 ? 0x00010000u : 1u;
      // int16: the lanes (2t, 2t+1) take (2t-1, 2t), prev's high half and
      // w's low half
      const uint32_t moved = I16 ? __byte_perm(prev, w, 0x5432) : prev;
      w = I16 ? __vadd2(moved, v) : add32(moved, v);
    }
  }
  if (t < W) o[row + t] = w;
}

template <int OP, bool I16>
int start(const void* x, void* o, int R, int W, int S, cudaStream_t st) {
  const auto xi = static_cast<const uint32_t*>(x);
  const auto oi = static_cast<uint32_t*>(o);
  if (W <= 32) {
    chain_kernel<OP, I16, true><<<R, 32, 0, st>>>(xi, oi, W, S);
  } else {
    const int threads = (W + 31) / 32 * 32;
    const size_t smem = (OP == ROLL || OP == SHIFT) ? 8 * W : 0;
    chain_kernel<OP, I16, false><<<R, threads, smem, st>>>(xi, oi, W, S);
  }
  return cudaGetLastError();
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
