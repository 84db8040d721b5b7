// The band of codes a traceback walk reads, staged in shared memory: what
// nw_walk.cu and sw_walk.cu share.
//
// A warp runs one walk, every lane the same steps.  Cell (y, x) of a slab
// sits at row x + y - 2 (x local to the slab), lane y (slab.cuh), and a
// step goes back 2 rows and 1 lane (MATCH), 1 row and 1 lane (GAP_A, y
// falls) or 1 row and 0 lanes (GAP_B, x falls).  A lane never falls by
// more than the row does, so from an entry cell at (row re, lane ye) every
// cell the walk can reach down to row r lies in lanes ye - (re - r) .. ye:
// a triangle, at most re - r + 1 lanes wide.
//
// The walk's rows are cut into blocks of K.  On entering a block the warp
// copies (cp.async, 16-byte chunks, all lanes at once) the part of the
// next block below that its entry cell can reach, into the other of its
// two buffers, and goes on reading the current one; it waits for that copy
// only when it steps out of the current block, one or two rows below it.
// Each walk step is then a shared-memory read.  The first block of a walk,
// and the first after the walk crosses into the slab before (x == c * CA
// for chunk slabs), are staged at the cell reached and waited for.
//
// A cell (y, x) the walk can reach lies in the block's rows exactly when
// its index (below) is >= 0.  `fast` says whether a cell's three
// predecessors (MATCH, GAP_A, GAP_B) all lie in the block: its row two or
// more above the block's lowest, x and y past the slab's first column and
// lane.  The walks read those predecessors' codes one step ahead, and
// where the next RUN cells keep theirs in the block, take RUN steps with
// no test between them.
//
// Shared-memory layout of a block: row r of the block at (r - bot) * S,
// S the smallest stride >= 2K + 30 with S == lanes (mod 16), so that a row
// of the plane and its staged copy share their offset mod 16 and every
// chunk lands aligned; the cell (y, x) at (x + y) * S + y + off.  A chunk
// is copied whole where the band holds any of its bytes: a chunk that
// overlaps a tensor lies inside the tensor's allocation, which the CUDA
// caching allocator aligns and sizes to 512 bytes.  For SW the letters
// a[x - 1] and b[y - 1] of the same triangle are staged beside the codes.
//
// The clamped bounds (the block's lowest row, its first lane and column)
// each come from one expression, and the test that a cell lies in the
// block uses that same bound: with CUDA 12.8, ptxas once folded a test
// against a max/min-clamped value wrongly (PERF.md §6, the carry).

#pragma once

#include <cstddef>
#include <cstdint>
#include <cuda_runtime.h>

namespace band {

// Rows a block; the one constant of the design (PERF.md gives the times at
// 32, 64 and 128).
constexpr int K = 64;
// A staged row's stride S is at most 2K + 45: a block of codes takes K
// strides, a run of letters 2K lanes at a chunk's offset; each region in
// whole 16-byte chunks.
constexpr int up16(int n) { return (n + 15) / 16 * 16; }
constexpr int ROW = 2 * K + 48;
constexpr int CODES = up16(K * ROW);
constexpr int LETTERS = up16(2 * K + 32);
// Fast steps taken at once, with no test between them, where the next
// RUN cells and their predecessors lie in the block.
constexpr int RUN = 4;
// Walks a block of threads: a warp each.
constexpr int WARPS = K >= 128 ? 2 : 4;

enum { MATCH = 0, GAP_A = 1, GAP_B = 2 };

// Of a cell's predecessors' values m, a, b, the one a step of matrix `op`
// goes to (a DIR_FAIL, 3, moves as MATCH does).
__device__ __forceinline__ int pick(int op, int m, int a, int b) {
  return op == GAP_A ? a : op == GAP_B ? b : m;
}

__device__ __forceinline__ void cp16(uint8_t* smem, uintptr_t gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Bytes lo .. hi of global memory into shared memory at dst, which holds
// byte lo at dst + (lo & 15): the chunks spread over the warp's lanes from
// lane `first`.
__device__ __forceinline__ void copy_run(uint8_t* dst, const uint8_t* lo,
                                         const uint8_t* hi, int first,
                                         int lane) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(lo) & ~uintptr_t{15};
  const int n = static_cast<int>(
      ((reinterpret_cast<uintptr_t>(hi) & ~uintptr_t{15}) - a) / 16 + 1);
  for (int i = (lane - first) & 31; i < n; i += 32) cp16(dst + 16 * i,
                                                         a + 16 * i);
}

// Where a pair's codes lie: nch slabs of `slab` bytes from d, rows of
// `lanes` bytes, CA columns a slab (one slab: any CA).
struct Codes {
  const uint8_t* d;
  size_t slab;
  int lanes, CA, nch;
};

// The block being read, or the next one once staged: the code of (y, x)
// at buf[(x + y) * S + y + off] for x + y >= lo and x > xf (x in a slab
// past xf columns); for SW a[x - 1] at la[x + aoff], b[y - 1] at lb[y + boff].
// A MATCH step lowers that index by dM = 2S + 1, GAP_A by dA = S + 1, GAP_B
// by S.
struct Block {
  uint8_t* buf;
  int S, dA, dM, off, lo, xf, bot, aoff, boff;
};

// One walk's two buffers and its blocks.  LETTERS_ON: SW, the letters are
// staged too.
template <bool LETTERS_ON>
struct Band {
  Codes P;
  const uint8_t* a;  // the pair's seq_a codes, a[x - 1] for column x
  const uint8_t* b;
  uint8_t* buf0;  // the first buffer; the second `stride` bytes on
  int stride;
  Block cur, nxt;
  const uint8_t* src;  // the slab of cur and nxt
  int which, lane;
  bool pending;  // nxt is being staged

  // Rows bot .. top of the slab at `src` (x local past xf columns) into
  // buffer w: of row r the lanes an entry at (xe, ye) reaches, and the
  // letters of the columns and rows they cover.
  __device__ __forceinline__ Block stage(int w, int xf, int bot, int top,
                                         int xe, int ye) const {
    Block k;
    k.buf = buf0 + w * stride;
    const int re = xe - xf + ye - 2;
    const int depth = re - bot;  // lanes below ye the lowest row may reach
    const int ylo = max(1, ye - depth);
    k.S = 2 * K + 30 + ((P.lanes - 2 * K - 30) & 15);
    k.dA = k.S + 1;
    k.dM = 2 * k.S + 1;
    const uint8_t* g0 = src + static_cast<size_t>(bot) * P.lanes + ylo;
    const int c = static_cast<int>(reinterpret_cast<uintptr_t>(g0) & 15);
    k.off = c - ylo - (xf + 2 + bot) * k.S;
    k.lo = xf + 2 + bot;
    k.xf = xf;
    k.bot = bot;
    for (int r = top - lane; r >= bot; r -= 32) {
      const int y0 = max(1, ye - (re - r));
      const uint8_t* row = src + static_cast<size_t>(r) * P.lanes;
      uint8_t* at = k.buf + (r - bot) * k.S + (y0 - ylo) + c -
                    static_cast<int>(reinterpret_cast<uintptr_t>(row + y0) &
                                     15);
      const uintptr_t first =
          reinterpret_cast<uintptr_t>(row + y0) & ~uintptr_t{15};
      const uintptr_t last = reinterpret_cast<uintptr_t>(row + ye);
      for (uintptr_t q = first; q <= last; q += 16, at += 16) cp16(at, q);
    }
    if (LETTERS_ON) {
      const int xlo = max(1, xe - depth);
      uint8_t* la = k.buf + CODES;
      uint8_t* lb = la + LETTERS;
      const uint8_t* ga = a + (xlo - 1);
      const uint8_t* gb = b + (ylo - 1);
      const int ca = static_cast<int>(reinterpret_cast<uintptr_t>(ga) & 15);
      const int cb = static_cast<int>(reinterpret_cast<uintptr_t>(gb) & 15);
      k.aoff = ca - xlo;
      k.boff = cb - ylo;
      copy_run(la, ga, a + (xe - 1), 0, lane);
      copy_run(lb, gb, b + (ye - 1), 16, lane);
    }
    return k;
  }

  // Stage below cur the rows an entry at (xe, ye) reaches, into the other
  // buffer; nothing when cur holds row 0.
  __device__ __forceinline__ void prefetch(int xe, int ye) {
    pending = cur.bot > 0;
    if (pending) {
      const int bot = max(0, cur.bot - K);
      nxt = stage(which ^ 1, cur.xf, bot, cur.bot - 1, xe, ye);
      commit();
    }
  }

  // Stage the block of the cell (y, x) itself (its slab, its row and the
  // K - 1 rows below) and wait for it, then prefetch the next.
  __device__ __forceinline__ void fresh(int x, int y) {
    __syncwarp();  // the reads of the buffer it reuses are done
    const int c = P.nch == 1 ? 0 : (x - 1) / P.CA;
    const int xf = c * P.CA;
    src = P.d + static_cast<size_t>(c) * P.slab;
    const int re = x - xf + y - 2;
    cur = stage(which, xf, max(0, re - K + 1), re, x, y);
    commit();
    wait_all();
    __syncwarp();
    prefetch(x, y);
  }

  __device__ __forceinline__ void start(int x, int y) {
    which = 0;
    pending = false;
    fresh(x, y);
  }

  __device__ __forceinline__ bool holds(int x, int y) const {
    return x + y >= cur.lo && x > cur.xf;
  }

  // The walk reached (y, x) outside cur: go on in the staged next block,
  // or, past the slab's first column or below anything staged, stage
  // afresh.
  __device__ __forceinline__ void enter(int x, int y) {
    if (x <= cur.xf || !pending) {
      fresh(x, y);
      return;
    }
    wait_all();
    __syncwarp();
    cur = nxt;
    which ^= 1;
    prefetch(x, y);
  }

  __device__ __forceinline__ int index(int x, int y) const {
    return (x + y) * cur.S + y + cur.off;
  }
  // Whether the predecessors of the cell (y, x) at `idx`, which the walk
  // reached, all lie in cur.
  __device__ __forceinline__ bool fast(int x, int y, int idx) const {
    return x >= cur.xf + 2 && y >= 2 && idx >= cur.dM;
  }
  // Whether the next RUN cells from the cell (y, x) at idx, which the walk
  // reached, all keep their predecessors in cur.
  __device__ __forceinline__ bool runs(int x, int y, int idx) const {
    return x >= cur.xf + RUN + 2 && y >= RUN + 2 &&
           idx >= (RUN + 1) * cur.dM;
  }
  // The index after a step of matrix `op` from idx.
  __device__ __forceinline__ int back(int idx, int op) const {
    return idx - (op == GAP_A ? cur.dA : op == GAP_B ? cur.S : cur.dM);
  }
  // The codes of the MATCH, GAP_A and GAP_B predecessors of the cell at
  // idx.
  __device__ __forceinline__ void kids(int idx, int& m, int& a,
                                       int& b) const {
    m = cur.buf[idx - cur.dM];
    a = cur.buf[idx - cur.dA];
    b = cur.buf[idx - cur.S];
  }
  __device__ __forceinline__ int letter_a(int x) const {
    return cur.buf[CODES + x + cur.aoff];
  }
  __device__ __forceinline__ int letter_b(int y) const {
    return cur.buf[CODES + LETTERS + y + cur.boff];
  }

  // No copy may still be writing shared memory when the warp is done.
  __device__ __forceinline__ void finish() {
    wait_all();
    __syncwarp();
  }
};

// The op trace kept in shared memory between slow steps: at most K + 1
// fast steps come between two of them, and a slow step writes the trace
// out once it holds K.
constexpr int TRACE = up16(2 * K + 2);

// Bytes of shared memory one walk takes: two buffers and its trace.
__host__ __device__ constexpr int walk_bytes(bool letters) {
  return 2 * (CODES + (letters ? 2 * LETTERS : 0)) + TRACE;
}

// The op trace: each step's op into shared memory (every lane the same
// byte), written to `out` by the warp, coalesced, `n` bytes at a time.
struct Trace {
  int8_t* out;
  uint8_t* buf;
  int n, done, lane;

  __device__ __forceinline__ void put(int op) {
    buf[n++] = static_cast<uint8_t>(op);
  }
  __device__ __forceinline__ void flush() {
    __syncwarp();
    for (int i = lane; i < n; i += 32) out[done + i] = buf[i];
    done += n;
    n = 0;
    __syncwarp();
  }
  // The walk took `steps` steps (any op put past them was read ahead):
  // write them and pad with -1 to cap.
  __device__ __forceinline__ void close(int steps, int cap) {
    __syncwarp();
    for (int i = lane; i < n && done + i < steps; i += 32)
      out[done + i] = buf[i];
    for (int s = steps + lane; s < cap; s += 32) out[s] = -1;
  }
};

}  // namespace band
