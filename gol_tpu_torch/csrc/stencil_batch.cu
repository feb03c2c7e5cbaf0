// Batched Game-of-Life steps for Hopper (sm_90a): B1 and B2.
//
// The batch lane (gol_tpu_torch/engine.py make_batch_runner) runs B
// independent boards in one canvas. The JAX package has no Pallas kernel
// there: it steps the batch with jnp under vmap inside one lax.while_loop
// (gol_tpu/engine.py _batch_evolve :1279-1290, _evolve_batch_masked
// :1081-1105). The port's loop runs on the host and reads back one flag
// tensor per block of generations, so its step must put each board's
// flags out of the same pass: these two kernels.
//
//   batch_packed_kernel  B1  one generation of B exact-fit tori stored as
//       words, (B, height, nwords): bit j of word w is column 32w + j.
//   batch_masked_kernel  B2  one generation of B uint8 boards in one
//       (B, height, width) canvas; board b wraps at its own extent
//       (heights[b], widths[b]) and every cell at or past it is written 0.
//       The exact-fit byte mode runs through it with the extent of the
//       canvas.
//
// Flags. Each launch ORs board b's pair into flags[2b] (any live cell in
// the new board) and flags[2b + 1] (any cell that changed: "similar"
// stored negated, as in stencil_packed.cu), into a buffer the caller
// zeroes. A warp reduces its predicates (__reduce_or_sync) and one lane
// issues the atomic, only if the flag is still clear. For B2 the pair
// covers the board's whole slot of the canvas, padding included, which is
// the JAX loop's compare of the padded canvas: padding is 0 before and
// after every generation.
//
// Per-board step counts. A block of the engine's loop runs some boards
// fewer generations than others (each board stops at its own generation
// limit). `steps[b]` is board b's count for the block and `gen` the
// launch's generation in it: where gen >= steps[b] the board is copied
// through unchanged and writes no flag, so the ping-pong buffers stay in
// step. Padding slots have steps 0.
//
// Design. B1 is one thread per word: it loads the word and its 8
// neighbours (rows and words modulo the board, so one-word-wide and
// one-row boards are right), computes the three rows' sums and the rule
// through the adder network of stencil_packed.cu (next_gen), and writes
// the word. B2 gives each lane of a warp one column of a band of
// kBandRows rows: the lane walks down it, wrapping rows and columns at the
// board's own extent, and keeps the 3-cell sums of the rows above and at
// the current one, so each cell costs one row sum (3 byte loads, the
// warp's 32 adjacent columns in one 32-byte sector). Its first version, one
// thread per cell with 9 loads and 16x the warps, took 0.050 ms per launch
// at the serving shape and 0.18 ms in the loop, where every warp of a
// freshly zeroed flag issued its atomic (PERF.md). The neighbour loads of
// both come from L1 and L2: each input byte comes from device memory once.
//
// What bounds them. Both move each input byte once and each output byte
// once (B1 2 x 4 bytes per word, B2 2 bytes per cell); B1 does the
// network's 12 logic instructions per word (roofline.OPS_PER_WORD_GEN),
// so bytes bound both. At the serving shapes (64 boards of 256^2: 512 KiB
// of words, 4 MiB of cells) a launch moves too few bytes to fill the card
// and the launch itself is most of the time. Not done yet: several
// generations per launch, which the engine's block would allow.

#include <cstddef>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarp = 32;
constexpr unsigned kFullMask = 0xffffffffu;
constexpr int kBandWarps = kThreads / kWarp;  // B2: bands of a block
constexpr int kBandRows = 16;                   // B2: rows of a warp's band

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

// Word w of a row's sums: m = west + east (2-cell), s = west + centre +
// east (3-cell), each as two bitplanes.
__device__ __forceinline__ void row_sums(const uint32_t* row, int w, int ww,
                                         int we, uint32_t& m0, uint32_t& m1,
                                         uint32_t& s0, uint32_t& s1,
                                         uint32_t& x) {
  x = __ldg(row + w);
  const uint32_t west = __funnelshift_l(__ldg(row + ww), x, 1);
  const uint32_t east = __funnelshift_r(x, __ldg(row + we), 1);
  m0 = west ^ east;
  m1 = west & east;
  s0 = m0 ^ x;
  s1 = m1 | (x & m0);
}

// OR a warp's predicate into *flag: one warp-wide reduction, then lane 0
// reads the flag and issues the atomic only if it is still clear. Every
// lane of the warp calls it.
__device__ __forceinline__ void or_flag(uint32_t acc, int* flag) {
  if (__reduce_or_sync(kFullMask, acc != 0 ? 1u : 0u) &&
      threadIdx.x % kWarp == 0) {
    if (*reinterpret_cast<volatile int*>(flag) == 0) atomicOr(flag, 1);
  }
}

// B1: grid (ceil(height * nwords / kThreads), batch), one thread per word.
__global__ void __launch_bounds__(kThreads)
batch_packed_kernel(const uint32_t* __restrict__ in, uint32_t* __restrict__ out,
                    int* __restrict__ flags, const int* __restrict__ steps,
                    int gen, int height, int nwords) {
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
  or_flag(alive, flags + 2 * b);
  or_flag(differs, flags + 2 * b + 1);
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

}  // namespace

extern "C" {

// Each entry launches on `stream` (a cudaStream_t of `device`), does not
// synchronise and allocates nothing; it returns cudaGetLastError() after
// the launch (0 = cudaSuccess). `out` must not alias `in`; `flags` is the
// launch's (batch, 2) int32 pair per board, `steps` the (batch,) int32
// step counts, `heights`/`widths` B2's (batch,) int32 board extents, all
// on the device. batch <= 65535.

// B1. in/out: (batch, height, nwords) words.
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

const char* gol_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
