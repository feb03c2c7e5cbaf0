// Batched Game-of-Life steps for Hopper (sm_90a): B1 and B2.
//
// The batch lane (gol_tpu_torch/engine.py make_batch_runner) runs B
// independent boards in one canvas. The JAX package has no Pallas kernel
// there: it steps the batch with jnp under vmap inside one lax.while_loop
// (gol_tpu/engine.py _batch_evolve :1279-1290, _evolve_batch_masked
// :1081-1105). The port's loop runs on the host and reads back one flag
// tensor per block of generations, so its step must put each board's
// flags out of the same pass: these kernels.
//
//   batch_packed_block_kernel  B1, block form: a whole block of up to t
//       generations of B exact-fit tori stored as words, (B, height,
//       nwords): bit j of word w is column 32w + j. One launch per block
//       of the engine's loop.
//   batch_packed_kernel  B1, streaming form: one generation of the same,
//       for boards whose two copies do not fit in one CTA's shared memory.
//   batch_masked_block_kernel  B2, block form: a whole block of up to t
//       generations of B uint8 boards in one (B, height, width) canvas;
//       board b wraps at its own extent (heights[b], widths[b]) and every
//       cell at or past it is written 0. The exact-fit byte mode runs
//       through it with the extent of the canvas. One launch per block.
//   batch_masked_kernel  B2, streaming form (B2-stream): one generation of
//       the same, for canvases whose two bit copies do not fit in one
//       CTA's shared memory.
//
// Per-board step counts. A block of the engine's loop runs some boards
// fewer generations than others (each board stops at its own generation
// limit): `steps[b]` is board b's count for the block. The block forms run
// board b for min(steps[b], t) generations and write the pair of
// generation i to flags[i, b] (any live cell in the new board, any cell
// that changed: "similar" stored negated, as in stencil_packed.cu) for
// every i they run; the other rows stay as the caller zeroed them, and a
// board with steps 0 (a padding slot, or a board whose limit was reached)
// is copied through, byte for byte in B2. The one-generation kernels take
// the launch's generation `gen` in its block: where gen >= steps[b] the
// board is copied through unchanged and writes no flag, so ping-pong
// buffers stay in step. They OR board b's pair into flags[2b] and
// flags[2b + 1] of a buffer the caller zeroes. For B2 the pair covers the
// board's whole slot of the canvas, padding included, which is the JAX
// loop's compare of the padded canvas: padding is 0 after every generation,
// so a non-zero padding cell of the input differs in the board's first
// generation only.
//
// What bounds them. Each generation moves each board's words once and
// does the adder network's 12 logic instructions per word
// (roofline.OPS_PER_WORD_GEN). At the serving shape (64 boards of 256^2:
// 512 KiB of words; B2's 64 slots of 256^2 bytes, 4 MiB) one generation's
// bound is 0.0003 ms (B1) and 0.0025 ms (B2, the bytes once each way), and
// a block of 16 generations' 0.0015 ms (B1, set by the operations once the
// board stays on chip) and 0.0025 ms (B2: the bytes still, the block's
// operations on the bits take 0.0015 ms): far below the cost of a launch.
// So the first forms, one launch per generation, were launch-bound (B1
// 0.0088 ms a launch, with all 64 warps of a board ORing into the same two
// fresh flags; B2 0.0203 ms, three byte loads a cell from device memory).
//
// Design of the block forms. One CTA per board: it holds the board in
// dynamic shared memory (two copies, ping-ponged), runs its generations
// out of shared memory with one __syncthreads() between them: device
// memory sees the board once each way per block, and the host one launch.
// A thread owns a strip of rows of one word column and walks down it,
// keeping the row sums of the rows above and at the current one, so each
// word costs one new row sum (three shared loads). A generation's flags
// are reduced in the CTA (block_flags: a warp's __reduce_or_sync, then one
// word per warp in shared memory, double-buffered by the generation's
// parity so one barrier a generation suffices) and one thread stores the
// pair with plain stores: no atomics. The CTA takes two words per thread,
// up to 1024 threads: one CTA is the only work its SM has for the board's
// whole block, so it brings as many warps as the SM holds to hide the
// shared memory latency of the dependent loads (a 256^2 board, 2048
// words, gets 1024 threads and strips of 2 rows). One CTA a board fills 64
// of the card's 132 SMs at the serving batch. The shared memory (two
// copies) bounds the board: up to the device's opt-in maximum per block
// (cudaDevAttrMaxSharedMemoryPerBlockOptin, 232,448 bytes on an H100:
// boards of up to 29,024 words), asked for with cudaFuncSetAttribute past
// 48 KiB; larger boards take the streaming forms, which the wrappers
// choose by shape (gol_batch_block_max_words).
//
// B1 loads and stores the board's words with 16-byte accesses. B2 holds
// its slot as bits, ceil(width / 32) words a row at the canvas's width
// (bit j of word k is column 32k + j; the bits past the board's width and
// the rows past its height stay 0 in both copies): a 256^2 slot is 8 KiB
// a copy. That is exact because the lane's cells are 0 or 1: every decoder
// that feeds it gives only those (io/text_grid.py, the wire format), and
// the B2 wrapper's callers stage boards from them. It reads the slot with
// 16-byte loads (the bytes before the first 16-byte boundary and after the
// last one singly), turns each load's cells into bits in registers and
// ORs each word's bits into shared memory with one atomicOr, noting any
// non-zero padding cell for the first generation's differs flag; at the
// end of the block it writes the whole slot back as bytes with 16-byte
// stores, 0 past the board. Its columns wrap at the board's own width,
// not at a word boundary: the west neighbour of column 0 is bit (w-1) % 32
// of the row's last word, and the east neighbour of column w-1 is bit 0 of
// word 0, placed in the register copy of the last word just past its last
// cell; the bits past the last cell are masked off after each generation.
// A spent board's CTA copies its slot and returns as a whole, before any
// barrier.
//
// Design of the one-generation kernels. The B1 streaming form is one
// thread per word: it loads the word and its 8 neighbours (rows and words
// modulo the board, so one-word-wide and one-row boards are right) and
// computes the three rows' sums and the rule through the adder network of
// stencil_packed.cu (next_gen). Its flags are reduced in the CTA to one
// atomic per CTA and flag. B2-stream gives each lane of a warp one column
// of a band of kBandRows rows: the lane walks down it, wrapping rows and
// columns at the board's own extent, and keeps the 3-cell sums of the rows
// above and at the current one, so each cell costs one row sum (3 byte
// loads, the warp's 32 adjacent columns in one 32-byte sector); a warp
// reduces its predicates and one lane issues the atomic, only if the flag
// is still clear. The neighbour loads of both come from L1 and L2: each
// input byte comes from device memory once.

#include <cstddef>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarp = 32;
constexpr unsigned kFullMask = 0xffffffffu;
constexpr int kBandWarps = kThreads / kWarp;  // B2: bands of a block
constexpr int kBandRows = 16;                   // B2: rows of a warp's band
constexpr int kBlockMaxThreads = 1024;  // B1 block form: most threads a CTA
constexpr int kBlockMaxWarps = kBlockMaxThreads / kWarp;
// B1 block form: the warps' flag words, one set per generation parity.
constexpr int kBlockStaticShared = 2 * kBlockMaxWarps * 4;
constexpr int kDefaultDynamicShared = 48 * 1024;  // without the opt-in

// The rule from the 3-cell sums of the rows above (u) and below (d), the
// centre row's 2-cell sums (m) and the centre row (stencil_packed.cu).
__device__ __forceinline__ uint32_t next_gen(uint32_t u0, uint32_t u1,
                                             uint32_t d0, uint32_t d1,
                                             uint32_t m0, uint32_t m1,
                                             uint32_t mid) {
  const uint32_t t0 = u0 ^ d0 ^ m0;
  const uint32_t tc = (u0 & d0) | (m0 & (u0 ^ d0));
  const uint32_t v0 = u1 ^ d1 ^ m1;
  const uint32_t v1 = (u1 & d1) | (m1 & (u1 ^ d1));
  return (v0 ^ tc) & ~v1 & (t0 | mid);
}

// A row's sums at word x with its west and east neighbour words: m =
// west + east (2-cell), s = west + centre + east (3-cell), each as two
// bitplanes.
__device__ __forceinline__ void sums(uint32_t x, uint32_t wn, uint32_t en,
                                     uint32_t& m0, uint32_t& m1, uint32_t& s0,
                                     uint32_t& s1) {
  const uint32_t west = __funnelshift_l(wn, x, 1);
  const uint32_t east = __funnelshift_r(x, en, 1);
  m0 = west ^ east;
  m1 = west & east;
  s0 = m0 ^ x;
  s1 = m1 | (x & m0);
}

// Word w of a row's sums in device memory (ww, we: the west and east
// words, wrapped), and the word itself in `x`.
__device__ __forceinline__ void row_sums(const uint32_t* row, int w, int ww,
                                         int we, uint32_t& m0, uint32_t& m1,
                                         uint32_t& s0, uint32_t& s1,
                                         uint32_t& x) {
  x = __ldg(row + w);
  sums(x, __ldg(row + ww), __ldg(row + we), m0, m1, s0, s1);
}

// Row `row` of a bit board's sums at word k (see sums), the board `last` +
// 1 words wide with its last cell at bit `lw` of word `last`, wrapping at
// the board's width: the west neighbour of column 0 is the last cell, and
// the east neighbour of the last cell is column 0, placed just past it (the
// bits past the last cell are 0, and what lands there is masked off).
// The word itself in `x`.
__device__ __forceinline__ void masked_row_sums(const uint32_t* row, int k,
                                                int last, int lw, uint32_t& m0,
                                                uint32_t& m1, uint32_t& s0,
                                                uint32_t& s1, uint32_t& x) {
  x = row[k];
  const uint32_t wn = k != 0 ? row[k - 1] : row[last] >> lw << 31;
  const uint32_t en = k != last ? row[k + 1] : row[0];
  const uint32_t xe = k == last && lw != 31 ? x | (row[0] & 1u) << (lw + 1) : x;
  sums(xe, wn, en, m0, m1, s0, s1);
}

// One generation of an (h, w) torus held as bits in shared memory, rows
// `stride` words apart, from `src` to `dst`, by the CTA: thread k walks
// strips of `strip` rows of one word column of the board's nwb (units k,
// k + blockDim.x, ...), keeping the row sums of the rows above and at the
// current one, so a word costs one new row sum. The bits past the last
// cell (lw) stay 0 (`last_mask`). ORs the new words into `alive` and the
// changed bits into `differs`. B1's board is the case stride = nwb, lw =
// 31.
__device__ __forceinline__ void masked_generation(const uint32_t* src,
                                                  uint32_t* dst, int h,
                                                  int nwb, int stride, int lw,
                                                  int strip, uint32_t& alive,
                                                  uint32_t& differs) {
  const int last = nwb - 1;
  const uint32_t last_mask = lw == 31 ? ~0u : (1u << (lw + 1)) - 1u;
  const int units = (h + strip - 1) / strip * nwb;
  for (int u = threadIdx.x; u < units; u += blockDim.x) {
    const int k = u % nwb;
    const int r0 = u / nwb * strip;
    const int r1 = min(r0 + strip, h);
    const uint32_t keep = k == last ? last_mask : ~0u;
    uint32_t u0, u1, m0, m1, s0, s1, x, unused0, unused1, unused2;
    masked_row_sums(src + (r0 == 0 ? h - 1 : r0 - 1) * stride, k, last, lw,
                    unused0, unused1, u0, u1, unused2);
    masked_row_sums(src + r0 * stride, k, last, lw, m0, m1, s0, s1, x);
    for (int r = r0; r < r1; ++r) {
      uint32_t dm0, dm1, d0, d1, xd;
      masked_row_sums(src + (r + 1 == h ? 0 : r + 1) * stride, k, last, lw,
                      dm0, dm1, d0, d1, xd);
      const uint32_t nv = next_gen(u0, u1, d0, d1, m0, m1, x) & keep;
      dst[r * stride + k] = nv;
      alive |= nv;
      differs |= nv ^ x;
      u0 = s0;
      u1 = s1;
      m0 = dm0;
      m1 = dm1;
      s0 = d0;
      s1 = d1;
      x = xd;
    }
  }
}

// The block forms' flags of one generation: a warp's __reduce_or_sync of
// the CTA's (alive, differs), one word per warp in `words` (the
// generation's parity's set), one barrier, and thread 0 stores the pair to
// `pair` with plain stores. Every thread of the CTA calls it. Thread 0
// reads `words` before any warp writes them again: that is after the next
// generation's barrier, which thread 0 has not reached.
__device__ __forceinline__ void block_flags(uint32_t alive, uint32_t differs,
                                            uint32_t* words, int* pair) {
  const unsigned both = __reduce_or_sync(
      kFullMask, (alive != 0 ? 1u : 0u) | (differs != 0 ? 2u : 0u));
  if (threadIdx.x % kWarp == 0) words[threadIdx.x / kWarp] = both;
  __syncthreads();  // the generation is written, and its warps' flags
  if (threadIdx.x == 0) {
    unsigned any = 0;
    for (int k = 0; k < static_cast<int>(blockDim.x) / kWarp; ++k) any |= words[k];
    pair[0] = static_cast<int>(any & 1u);
    pair[1] = static_cast<int>(any >> 1);
  }
}

// B2: OR a warp's predicate into *flag: one warp-wide reduction, then
// lane 0 reads the flag and issues the atomic only if it is still clear.
// Every lane of the warp calls it.
__device__ __forceinline__ void or_flag(uint32_t acc, int* flag) {
  if (__reduce_or_sync(kFullMask, acc != 0 ? 1u : 0u) &&
      threadIdx.x % kWarp == 0) {
    if (*reinterpret_cast<volatile int*>(flag) == 0) atomicOr(flag, 1);
  }
}

// B1, block form: grid (batch), block_threads(height * nwords) threads,
// dynamic shared memory for two copies of a board (block_shared_bytes).
__global__ void __launch_bounds__(kBlockMaxThreads)
batch_packed_block_kernel(const uint32_t* __restrict__ in,
                          uint32_t* __restrict__ out, int* __restrict__ flags,
                          const int* __restrict__ steps, int t, int batch,
                          int height, int nwords, int strip) {
  extern __shared__ __align__(16) uint4 board_shared[];
  __shared__ uint32_t warp_flags[2][kBlockMaxWarps];
  const int b = blockIdx.x;
  const int words = height * nwords;
  const size_t base = static_cast<size_t>(b) * words;
  uint32_t* cur = reinterpret_cast<uint32_t*>(board_shared);
  uint32_t* nxt = cur + ((words + 3) & ~3);  // 16-byte aligned
  // 16-byte loads and stores where the board's words allow them.
  const bool wide = words % 4 == 0 &&
                    reinterpret_cast<uintptr_t>(in) % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(out) % 16 == 0;
  if (wide) {
    const uint4* src = reinterpret_cast<const uint4*>(in + base);
    for (int i = threadIdx.x; i < words / 4; i += blockDim.x) {
      board_shared[i] = __ldg(src + i);
    }
  } else {
    for (int i = threadIdx.x; i < words; i += blockDim.x) {
      cur[i] = __ldg(in + base + i);
    }
  }
  const int n = min(__ldg(steps + b), t);
  __syncthreads();
  for (int i = 0; i < n; ++i) {
    uint32_t alive = 0, differs = 0;
    masked_generation(cur, nxt, height, nwords, nwords, 31, strip, alive,
                      differs);
    block_flags(alive, differs, warp_flags[i & 1],
                flags + 2 * (static_cast<size_t>(i) * batch + b));
    uint32_t* done = nxt;
    nxt = cur;
    cur = done;
  }
  if (wide) {
    uint4* dst = reinterpret_cast<uint4*>(out + base);
    const uint4* src = reinterpret_cast<const uint4*>(cur);
    for (int i = threadIdx.x; i < words / 4; i += blockDim.x) dst[i] = src[i];
  } else {
    for (int i = threadIdx.x; i < words; i += blockDim.x) out[base + i] = cur[i];
  }
}

// B1, streaming form: grid (ceil(height * nwords / kThreads), batch), one
// thread per word.
__global__ void __launch_bounds__(kThreads)
batch_packed_kernel(const uint32_t* __restrict__ in, uint32_t* __restrict__ out,
                    int* __restrict__ flags, const int* __restrict__ steps,
                    int gen, int height, int nwords) {
  __shared__ uint32_t warp_flags[kThreads / kWarp];
  const int b = blockIdx.y;
  const int words = height * nwords;
  const size_t base = static_cast<size_t>(b) * words;
  const int idx = blockIdx.x * kThreads + threadIdx.x;
  const bool owned = idx < words;
  if (gen >= __ldg(steps + b)) {  // the board's steps are spent: copy it
    if (owned) out[base + idx] = __ldg(in + base + idx);
    return;  // the whole block: steps[b] is one value
  }
  uint32_t alive = 0, differs = 0;
  if (owned) {
    const int r = idx / nwords;
    const int w = idx - r * nwords;
    const int rn = r == 0 ? height - 1 : r - 1;
    const int rs = r + 1 == height ? 0 : r + 1;
    const int ww = w == 0 ? nwords - 1 : w - 1;
    const int we = w + 1 == nwords ? 0 : w + 1;
    const uint32_t* board = in + base;
    uint32_t u0, u1, d0, d1, m0, m1, s0, s1, x, unused;
    row_sums(board + static_cast<size_t>(rn) * nwords, w, ww, we, m0, m1, u0,
             u1, unused);
    row_sums(board + static_cast<size_t>(rs) * nwords, w, ww, we, m0, m1, d0,
             d1, unused);
    row_sums(board + static_cast<size_t>(r) * nwords, w, ww, we, m0, m1, s0,
             s1, x);
    const uint32_t nv = next_gen(u0, u1, d0, d1, m0, m1, x);
    out[base + idx] = nv;
    alive = nv;
    differs = nv ^ x;
  }
  // The CTA's flags: a warp reduction, one word per warp, then one atomic
  // per CTA and set flag.
  const unsigned pair = __reduce_or_sync(
      kFullMask, (alive != 0 ? 1u : 0u) | (differs != 0 ? 2u : 0u));
  if (threadIdx.x % kWarp == 0) warp_flags[threadIdx.x / kWarp] = pair;
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned any = 0;
    for (int k = 0; k < kThreads / kWarp; ++k) any |= warp_flags[k];
    if (any & 1u) atomicOr(flags + 2 * b, 1);
    if (any & 2u) atomicOr(flags + 2 * b + 1, 1);
  }
}

// Board b's 3-cell row sum at column c (west and east wrapped at the
// board's width) of row `row`, and the centre cell in `x`.
__device__ __forceinline__ uint32_t cell_row_sum(const uint8_t* row, int c,
                                                 int cw, int ce, uint32_t& x) {
  x = __ldg(row + c);
  return __ldg(row + cw) + x + __ldg(row + ce);
}

// B2: grid (ceil(width / kWarp), ceil(height / (kBandWarps * kBandRows)),
// batch). A warp owns kWarp adjacent columns of a band of kBandRows rows;
// each lane walks down its column, keeping the 3-cell row sums of the rows
// above and at the current one, so a cell costs one new row sum (3 loads).
__global__ void __launch_bounds__(kThreads)
batch_masked_kernel(const uint8_t* __restrict__ in, uint8_t* __restrict__ out,
                    int* __restrict__ flags, const int* __restrict__ steps,
                    const int* __restrict__ heights,
                    const int* __restrict__ widths, int gen, int height,
                    int width) {
  const int b = blockIdx.z;
  const size_t base = static_cast<size_t>(b) * height * width;
  const uint8_t* src = in + base;
  uint8_t* dst = out + base;
  const int c = blockIdx.x * kWarp + threadIdx.x % kWarp;
  const int r0 = (blockIdx.y * kBandWarps + threadIdx.x / kWarp) * kBandRows;
  const int r1 = min(r0 + kBandRows, height);
  const bool live = c < width;
  if (gen >= __ldg(steps + b)) {  // the board's steps are spent: copy it
    if (live) {
      for (int r = r0; r < r1; ++r) {
        dst[static_cast<size_t>(r) * width + c] =
            __ldg(src + static_cast<size_t>(r) * width + c);
      }
    }
    return;  // the whole block: steps[b] is one value
  }
  uint32_t alive = 0, differs = 0;
  if (live) {
    const int h = __ldg(heights + b), w = __ldg(widths + b);
    int r = r0;
    if (c < w && r < h) {
      const int cw = c == 0 ? w - 1 : c - 1;
      const int ce = c + 1 == w ? 0 : c + 1;
      uint32_t x, xd;
      uint32_t up = cell_row_sum(src + static_cast<size_t>(r == 0 ? h - 1 : r - 1) * width,
                                 c, cw, ce, xd);
      uint32_t mid = cell_row_sum(src + static_cast<size_t>(r) * width, c, cw,
                                  ce, x);
      for (const int rb = min(r1, h); r < rb; ++r) {
        const int rd = r + 1 == h ? 0 : r + 1;
        const uint32_t down = cell_row_sum(src + static_cast<size_t>(rd) * width,
                                           c, cw, ce, xd);
        // B3/S23 on the 3x3 sum: 3 is born or kept, 4 is kept when alive.
        const uint32_t n = up + mid + down;
        const uint32_t next = n == 3 || (n == 4 && x != 0) ? 1u : 0u;
        dst[static_cast<size_t>(r) * width + c] = static_cast<uint8_t>(next);
        alive |= next;
        differs |= next ^ x;
        up = mid;
        mid = down;
        x = xd;
      }
    }
    for (; r < r1; ++r) {  // cells at or past the board's extent
      const size_t at = static_cast<size_t>(r) * width + c;
      differs |= __ldg(src + at);
      dst[at] = 0;
    }
  }
  or_flag(alive, flags + 2 * b);
  or_flag(differs, flags + 2 * b + 1);
}

// B2, block form. The bytes of a slot split at 16-byte boundaries of `p`:
// the bytes before the first boundary (head_bytes), whole 16-byte chunks,
// and the rest.
__device__ __forceinline__ int head_bytes(const void* p, int n) {
  return min(n, static_cast<int>((16 - reinterpret_cast<uintptr_t>(p) % 16) % 16));
}

// The cells of the `n` low bytes of `v` (the first lowest), from row r,
// column c of a slot `width` wide, into the bit board `bits` (`stride`
// words a row): a cell inside the extent (h, w) sets its bit through
// `acc`, the bits gathered for word `at`, which goes to shared memory with
// one atomicOr when the next cell is another word's (the caller ORs the
// last); a non-zero cell at or past the extent sets `pad`. Advances (r, c).
__device__ __forceinline__ void pack_cells(uint32_t v, int n, int& r, int& c,
                                           int width, int h, int w,
                                           int stride, uint32_t* bits,
                                           uint32_t& acc, int& at,
                                           uint32_t& pad) {
  for (int q = 0; q < n; ++q, v >>= 8) {
    const uint32_t cell = v & 0xffu;
    if (r < h && c < w) {
      const int word = r * stride + (c >> 5);
      if (word != at) {
        if (acc != 0) atomicOr(bits + at, acc);
        acc = 0;
        at = word;
      }
      acc |= (cell != 0 ? 1u : 0u) << (c & 31);
    } else {
      pad |= cell;
    }
    if (++c == width) {
      c = 0;
      ++r;
    }
  }
}

// The `n` cells from row r, column c of a slot `width` wide as bytes (the
// first lowest): bit c of row r of the bit board. Advances (r, c).
__device__ __forceinline__ uint32_t unpack_cells(int n, int& r, int& c,
                                                 int width, int stride,
                                                 const uint32_t* bits) {
  uint32_t v = 0;
  for (int q = 0; q < n; ++q) {
    v |= (bits[r * stride + (c >> 5)] >> (c & 31) & 1u) << (8 * q);
    if (++c == width) {
      c = 0;
      ++r;
    }
  }
  return v;
}

// A spent board's slot, byte for byte, by the CTA: 16-byte loads and
// stores where `src` and `dst` sit alike against 16-byte boundaries.
__device__ __forceinline__ void copy_slot(const uint8_t* src, uint8_t* dst,
                                          int cells) {
  const int head = head_bytes(src, cells);
  if (head != head_bytes(dst, cells)) {
    for (int i = threadIdx.x; i < cells; i += blockDim.x) dst[i] = __ldg(src + i);
    return;
  }
  const int chunks = (cells - head) / 16;
  const int rest = cells - head - 16 * chunks;
  const uint4* from = reinterpret_cast<const uint4*>(src + head);
  uint4* to = reinterpret_cast<uint4*>(dst + head);
  for (int i = threadIdx.x; i < chunks; i += blockDim.x) to[i] = __ldg(from + i);
  for (int i = threadIdx.x; i < head + rest; i += blockDim.x) {
    const int f = i < head ? i : cells - rest + (i - head);
    dst[f] = __ldg(src + f);
  }
}

// B2, block form: grid (batch), block_threads(height * stride) threads,
// dynamic shared memory for two bit copies of a slot (block_shared_bytes),
// stride = ceil(width / 32) words a row.
__global__ void __launch_bounds__(kBlockMaxThreads)
batch_masked_block_kernel(const uint8_t* __restrict__ in,
                          uint8_t* __restrict__ out, int* __restrict__ flags,
                          const int* __restrict__ steps,
                          const int* __restrict__ heights,
                          const int* __restrict__ widths, int t, int batch,
                          int height, int width) {
  extern __shared__ __align__(16) uint4 board_shared[];
  __shared__ uint32_t warp_flags[2][kBlockMaxWarps];
  const int b = blockIdx.x;
  const int cells = height * width;
  const uint8_t* src = in + static_cast<size_t>(b) * cells;
  uint8_t* dst = out + static_cast<size_t>(b) * cells;
  const int n = min(__ldg(steps + b), t);
  if (n <= 0) {  // spent: the whole CTA returns (steps[b] is one value)
    copy_slot(src, dst, cells);
    return;
  }
  const int h = min(__ldg(heights + b), height);
  const int w = min(__ldg(widths + b), width);
  const int stride = (width + 31) / 32;
  const int padded = (height * stride + 3) & ~3;  // 16-byte aligned copies
  uint32_t* cur = reinterpret_cast<uint32_t*>(board_shared);
  uint32_t* nxt = cur + padded;
  for (int i = threadIdx.x; i < 2 * padded; i += blockDim.x) cur[i] = 0;
  __syncthreads();  // both copies 0: the cells OR into one, and every bit
                    // past the board stays 0 in both
  uint32_t pad = 0;
  {
    const int head = head_bytes(src, cells);
    const int chunks = (cells - head) / 16;
    const int rest = cells - head - 16 * chunks;
    const uint4* vec = reinterpret_cast<const uint4*>(src + head);
    for (int i = threadIdx.x; i < chunks; i += blockDim.x) {
      const uint4 v = __ldg(vec + i);
      const int f = head + 16 * i;
      int r = f / width, c = f - r * width, at = -1;
      uint32_t acc = 0;
      pack_cells(v.x, 4, r, c, width, h, w, stride, cur, acc, at, pad);
      pack_cells(v.y, 4, r, c, width, h, w, stride, cur, acc, at, pad);
      pack_cells(v.z, 4, r, c, width, h, w, stride, cur, acc, at, pad);
      pack_cells(v.w, 4, r, c, width, h, w, stride, cur, acc, at, pad);
      if (acc != 0) atomicOr(cur + at, acc);
    }
    for (int i = threadIdx.x; i < head + rest; i += blockDim.x) {
      const int f = i < head ? i : cells - rest + (i - head);
      int r = f / width, c = f - r * width, at = -1;
      uint32_t acc = 0;
      pack_cells(__ldg(src + f), 1, r, c, width, h, w, stride, cur, acc, at, pad);
      if (acc != 0) atomicOr(cur + at, acc);
    }
  }
  __syncthreads();  // the board is packed
  const int nwb = (w + 31) / 32;
  const int lw = (w - 1) & 31;
  const int strip = max(1, min(h, (h * nwb + static_cast<int>(blockDim.x) - 1) /
                                      static_cast<int>(blockDim.x)));
  for (int i = 0; i < n; ++i) {
    // A non-zero cell of the slot's padding differs from the 0 written
    // there in the first generation.
    uint32_t alive = 0, differs = i == 0 ? pad : 0;
    masked_generation(cur, nxt, h, nwb, stride, lw, strip, alive, differs);
    block_flags(alive, differs, warp_flags[i & 1],
                flags + 2 * (static_cast<size_t>(i) * batch + b));
    uint32_t* done = nxt;
    nxt = cur;
    cur = done;
  }
  // The last generation's barrier (in block_flags) is behind: `cur` is
  // whole. Bytes over the whole slot, 0 past the board.
  const int head = head_bytes(dst, cells);
  const int chunks = (cells - head) / 16;
  const int rest = cells - head - 16 * chunks;
  uint4* vec = reinterpret_cast<uint4*>(dst + head);
  for (int i = threadIdx.x; i < chunks; i += blockDim.x) {
    const int f = head + 16 * i;
    int r = f / width, c = f - r * width;
    uint4 v;
    v.x = unpack_cells(4, r, c, width, stride, cur);
    v.y = unpack_cells(4, r, c, width, stride, cur);
    v.z = unpack_cells(4, r, c, width, stride, cur);
    v.w = unpack_cells(4, r, c, width, stride, cur);
    vec[i] = v;
  }
  for (int i = threadIdx.x; i < head + rest; i += blockDim.x) {
    const int f = i < head ? i : cells - rest + (i - head);
    int r = f / width, c = f - r * width;
    dst[f] = static_cast<uint8_t>(unpack_cells(1, r, c, width, stride, cur));
  }
}

// The block form's CTA: two board words per thread, in whole warps, up to
// kBlockMaxThreads; each thread's strip of rows covers its share.
int block_threads(int words) {
  const int t = ((words + 1) / 2 + kWarp - 1) / kWarp * kWarp;
  return max(kWarp, min(t, kBlockMaxThreads));
}

int block_strip(int height, int nwords, int threads) {
  const long long per = (static_cast<long long>(height) * nwords + threads - 1) / threads;
  return static_cast<int>(max(1LL, min(per, static_cast<long long>(height))));
}

size_t block_shared_bytes(int words) {
  return 2 * static_cast<size_t>((words + 3) & ~3) * sizeof(uint32_t);
}

}  // namespace

extern "C" {

// Each entry launches on `stream` (a cudaStream_t of `device`), does not
// synchronise and allocates nothing; it returns cudaGetLastError() after
// the launch (0 = cudaSuccess). `out` must not alias `in`; `flags` is a
// one-generation launch's (batch, 2) int32 pair per board, `steps` the
// (batch,) int32 step counts, `heights`/`widths` B2's (batch,) int32 board
// extents, all on the device. batch <= 65535.

// B1, streaming form. in/out: (batch, height, nwords) words.
int gol_batch_packed_step(const void* in, void* out, void* flags,
                          const void* steps, int gen, int batch, int height,
                          int nwords, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned tiles = (height * nwords + kThreads - 1) / kThreads;
  dim3 grid;
  grid.x = tiles;
  grid.y = static_cast<unsigned>(batch);
  grid.z = 1;
  batch_packed_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(in), static_cast<uint32_t*>(out),
      static_cast<int*>(flags), static_cast<const int*>(steps), gen, height,
      nwords);
  return static_cast<int>(cudaGetLastError());
}

// The most words a board may have for the block form on `device`: two
// copies in the opt-in shared memory of one block, beside the flag words.
// Negative: a CUDA error.
int gol_batch_block_max_words(int device) {
  int optin = 0;
  cudaError_t err =
      cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return -static_cast<int>(err);
  return (optin - kBlockStaticShared) / 8 & ~3;
}

// B1, block form. in/out: (batch, height, nwords) words; flags: (t, batch,
// 2) int32, generation i's pair of board b at flags + 2 * (i * batch + b).
// Board b runs min(steps[b], t) generations. Fails with
// cudaErrorInvalidValue when height * nwords passes
// gol_batch_block_max_words.
int gol_batch_packed_block(const void* in, void* out, void* flags,
                           const void* steps, int t, int batch, int height,
                           int nwords, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int words = height * nwords;
  const int most = gol_batch_block_max_words(device);
  if (most < 0) return -most;
  if (words > most) return static_cast<int>(cudaErrorInvalidValue);
  const size_t shared = block_shared_bytes(words);
  if (shared > static_cast<size_t>(kDefaultDynamicShared)) {
    err = cudaFuncSetAttribute(batch_packed_block_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(shared));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int threads = block_threads(words);
  batch_packed_block_kernel<<<static_cast<unsigned>(batch), threads, shared,
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(in), static_cast<uint32_t*>(out),
      static_cast<int*>(flags), static_cast<const int*>(steps), t, batch,
      height, nwords, block_strip(height, nwords, threads));
  return static_cast<int>(cudaGetLastError());
}

// B2. in/out: (batch, height, width) cells.
int gol_batch_masked_step(const void* in, void* out, void* flags,
                          const void* steps, const void* heights,
                          const void* widths, int gen, int batch, int height,
                          int width, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid;
  grid.x = (width + kWarp - 1) / kWarp;
  grid.y = (height + kBandWarps * kBandRows - 1) / (kBandWarps * kBandRows);
  grid.z = static_cast<unsigned>(batch);
  batch_masked_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(in), static_cast<uint8_t*>(out),
      static_cast<int*>(flags), static_cast<const int*>(steps),
      static_cast<const int*>(heights), static_cast<const int*>(widths), gen,
      height, width);
  return static_cast<int>(cudaGetLastError());
}

// B2, block form. in/out: (batch, height, width) cells; flags: (t, batch,
// 2) int32 as B1's block form. Board b runs min(steps[b], t) generations.
// Fails with cudaErrorInvalidValue when height * ceil(width / 32) passes
// gol_batch_block_max_words.
int gol_batch_masked_block(const void* in, void* out, void* flags,
                           const void* steps, const void* heights,
                           const void* widths, int t, int batch, int height,
                           int width, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int words = height * ((width + 31) / 32);
  const int most = gol_batch_block_max_words(device);
  if (most < 0) return -most;
  if (words > most) return static_cast<int>(cudaErrorInvalidValue);
  const size_t shared = block_shared_bytes(words);
  if (shared > static_cast<size_t>(kDefaultDynamicShared)) {
    err = cudaFuncSetAttribute(batch_masked_block_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(shared));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  batch_masked_block_kernel<<<static_cast<unsigned>(batch), block_threads(words),
                              shared, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(in), static_cast<uint8_t*>(out),
      static_cast<int*>(flags), static_cast<const int*>(steps),
      static_cast<const int*>(heights), static_cast<const int*>(widths), t,
      batch, height, width);
  return static_cast<int>(cudaGetLastError());
}

const char* gol_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
