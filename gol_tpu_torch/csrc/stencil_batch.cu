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
//   batch_packed_band_kernel<false>  B1, banded form (B1-stream): the same
//       block for boards whose two copies do not fit in one CTA's shared
//       memory, each in bands of R whole rows, t' generations a launch
//       (gol_batch_band_plan): one launch a block of 16 for rows of up to
//       453 words on an H100.
//   batch_packed_band_kernel<true>  B1, column-cut form (B1-wide): the
//       same block for boards whose rows are too wide for a band of whole
//       rows to run the block, each in tiles of R rows x C words, so that
//       a board of any width runs up to 32 generations a launch (one
//       launch a block of 16). It also runs the one-generation wrapper
//       (batch_packed_step_into), at tb = 1.
//   batch_masked_block_kernel  B2, block form: a whole block of up to t
//       generations of B uint8 boards in one (B, height, width) canvas;
//       board b wraps at its own extent (heights[b], widths[b]) and every
//       cell at or past it is written 0. The exact-fit byte mode runs
//       through it with the extent of the canvas. One launch per block.
//   batch_masked_band_kernel<false>  B2, banded form (B2-stream): the same
//       block for canvases whose two bit copies do not fit in one CTA's
//       shared memory, in bands of R canvas rows.
//   batch_masked_band_kernel<true>  B2, column-cut form (B2-wide): the
//       same in tiles of R canvas rows x C words of bits, for canvases whose
//       rows are too wide for whole-row bands; also the one-generation
//       wrapper (batch_masked_step_into).
//
// Per-board step counts. A block of the engine's loop runs some boards
// fewer generations than others (each board stops at its own generation
// limit): `steps[b]` is board b's count for the block. Every form runs
// board b for min(steps[b], t) generations and writes the pair of
// generation i to flags[i, b] (any live cell in the new board, any cell
// that changed: "similar" stored negated, as in stencil_packed.cu) for
// every i it runs; the other rows stay as the caller zeroed them, and a
// board with steps 0 (a padding slot, or a board whose limit was reached)
// is copied through, byte for byte in B2. A banded or column-cut launch
// runs generations g0 .. g0 + tb - 1 of the block: board b runs
// min(steps[b] - g0, tb) of them, and a board with none is copied through,
// so ping-pong buffers stay in step. Where several CTAs share a board (the
// banded and column-cut forms), they OR the pair into a buffer the caller
// zeroes. For B2 the pair covers the board's whole slot of the canvas,
// padding included, which is the JAX loop's compare of the padded canvas:
// padding is 0 after every generation, so a non-zero padding cell of the
// input differs in the board's first generation only.
//
// What bounds them. Each generation moves each board's words once and
// does the adder network's 12 logic instructions per word
// (roofline.OPS_PER_WORD_GEN). At the serving shape (64 boards of 256^2:
// 512 KiB of words; B2's 64 slots of 256^2 bytes, 4 MiB) a block of 16
// generations' bound is 0.0015 ms (B1, set by the operations once the
// board stays on chip) and 0.0025 ms (B2: the bytes once each way, the
// block's operations on the bits take 0.0015 ms). At the 1024^2 buckets
// (64 boards: 8 MiB of words; 64 slots of 1000^2 in 1024^2, 64 MiB) it is
// 0.0241 ms (B1, operations) and 0.0401 ms (B2, bytes), where a launch a
// generation could not beat 16 x 0.0050 and 16 x 0.0401 ms: the banded
// forms move each board through device memory once a block. At 16 boards
// of 32 x 309,600 cells (B1: 19.8 MB of words; B2: 30 x 309,590 in that
// canvas, 158.5 MB) a block's bound is 0.0569 ms (B1-wide, operations)
// and 0.0946 ms (B2-wide, bytes).
//
// Design of the block forms. One CTA per board: it holds the board in
// dynamic shared memory (two copies, ping-ponged), runs its generations
// out of shared memory with one __syncthreads() between them: device
// memory sees the board once each way per block, and the host one launch.
// A thread owns a strip of rows of one word column and walks down it,
// keeping the row sums of the rows above and at the current one, so each
// word costs one new row sum (three shared loads; masked_generation). A
// generation's flags are reduced in the CTA (block_flags: a warp's
// __reduce_or_sync, then one word per warp in shared memory,
// double-buffered by the generation's parity so one barrier a generation
// suffices) and one thread stores the pair with plain stores: no atomics.
// The CTA takes two words per thread, up to 1024 threads: one CTA is the
// only work its SM has for the board's whole block, so it brings as many
// warps as the SM holds to hide the shared memory latency of the dependent
// loads (a 256^2 board, 2048 words, gets 1024 threads and strips of 2
// rows). One CTA a board fills 64 of the card's 132 SMs at the serving
// batch. The shared memory (two copies) bounds the board: up to the
// device's opt-in maximum per block (cudaDevAttrMaxSharedMemoryPerBlockOptin,
// 232,448 bytes on an H100: boards of up to 29,024 words), asked for with
// cudaFuncSetAttribute past 48 KiB; larger boards take the banded forms,
// which the wrappers choose by shape (gol_batch_block_max_words).
//
// B1 loads and stores the board's words with 16-byte accesses. B2 holds
// its slot as bits, ceil(width / 32) words a row at the canvas's width
// (bit j of word k is column 32k + j; the bits past the board's width and
// the rows past its height stay 0 in both copies): a 256^2 slot is 8 KiB
// a copy. That is exact because the lane's cells are 0 or 1: every decoder
// that feeds it gives only those (io/text_grid.py, the wire format), and
// the B2 wrapper's callers stage boards from them. It reads the slot with
// 16-byte loads (the bytes before the first 16-byte boundary and after the
// last one singly), turns each load's 16 cells into bits in registers (a
// load inside one row and the board's extent with two multiplies,
// cells_to_bits; any other cell by cell) and ORs each word's bits into
// shared memory with one atomicOr, noting any non-zero padding cell for
// the first generation's differs flag; at the end of the block it writes
// the whole slot back as bytes with 16-byte stores, 0 past the board. Its
// columns wrap at the board's own width, not at a word boundary: the west
// neighbour of column 0 is bit (w-1) % 32 of the row's last word, and the
// east neighbour of column w-1 is bit 0 of word 0, placed in the register
// copy of the last word just past its last cell; the bits past the last
// cell are masked off after each generation (a board whose width is a
// multiple of 32 wraps at words alone, as B1's: masked_row_sums<true>). A
// spent board's CTA copies its slot and returns as a whole, before any
// barrier.
//
// Design of the banded forms. A board too large for one CTA is cut into
// bands of R rows (B2: of the canvas's rows), one CTA a band, boards x
// bands on grid.x. The CTA loads its band and tb ghost rows each side
// (rows modulo the board's own height, so a board shorter than a band and
// its ghost rows repeats its rows; B2 packs them as bits as the block form
// does, each run of consecutive rows as one span) into two copies in
// shared memory and runs tb generations on a shrinking trapezoid: after
// generation i the rows within tb - 1 - i of the band are exact, and only
// those are computed, with one __syncthreads() a generation. Only the
// band's own rows go back to device memory, once a launch. Every row the
// trapezoid computes is a row of the board at that generation, so the
// CTA's flags (block_flags) may count them all; several CTAs share a
// board's pair, so thread 0 ORs it in with an atomic, issued only for a
// flag still clear when it read it (before the barrier, whose wait hides
// the read). B2's rows past a board's height are padding: a band of
// padding alone loads nothing, writes 0 and reports its non-zero cells
// in its first differs flag. All offsets into the stacks are 64-bit.
//
// Design of the column-cut forms (B1-wide, B2-wide; they replace the
// one-generation kernels, which read and wrote the whole stack once a
// generation). A band of whole rows holds too few rows once a row passes
// most / (4 t) words (453 on an H100 at t = 16), and none past 9,674. So
// each board is cut into tiles of R rows x C words, one CTA a tile, boards
// x row bands x column tiles on grid.x. A tile's two copies in shared
// memory hold its rows and t' ghost rows each side (modulo the board's
// height, as the banded forms load them) by C + 2 words: one ghost word
// each side. The ghost words are computed too, as if 0 lay past them, so
// a wrong bit enters the tile at its outermost bit and moves one bit a
// generation: one ghost word keeps the C owned words exact for up to 32
// generations, and the plan caps t' there. Rows run on the banded forms'
// shrinking trapezoid; a tile that holds all of its board's rows takes no
// ghost rows and wraps its rows in shared memory, as the block forms do.
// The flags count the owned words of every row a generation computes,
// never a ghost word, ORed in as the banded forms do. B1's ghost words are
// the board's words (k0 - 1) and (k0 + C) modulo nwords (a board one word
// wide wraps onto itself). B2's position j of a tile's bit row holds the
// board's column (32 k0 - 32 + j) mod w, ghost and owned positions alike:
// the tile's row is a window onto the periodic row, so the wrap at a width
// that is no multiple of 32 needs no lane logic in the generation loop.
// Each word of the window is built by one thread from the 16-byte granules
// that hold its 32 cells (cells_to_bits; cell by cell where the window
// wraps inside the word), with no atomics; the owned cells go back as
// bytes 16 at a time, 0 at or past the board's extent, and the owned
// padding's non-zero input cells set the first differs flag. A tile of
// padding alone loads no bits. B1-wide is bound by its operations (12 a
// word and generation, plus the ghost words' and ghost rows' share), B2-wide
// by its bytes (the canvas once each way). The plan (gol_batch_band_plan)
// keeps whole-row bands wherever they run the whole block, else takes t' =
// min(t, 32), tiles of the board's whole height or of bands of about
// sqrt(t' x most) - 2 t' rows (whichever holds fewer copy words an owned
// word) as wide as the shared memory allows, then narrows them so that
// boards x tiles fill whole waves of the SMs.

#include <cmath>
#include <cstddef>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kWarp = 32;
constexpr unsigned kFullMask = 0xffffffffu;
constexpr int kBlockMaxThreads = 1024;  // B1 block form: most threads a CTA
constexpr int kBlockMaxWarps = kBlockMaxThreads / kWarp;
// The banded forms' most threads a CTA, B1's and B2's; ptxas is held to as
// many CTAs an SM as make kBlockMaxThreads threads. B1's generations are
// its CTA's only work, and longer strips cost fewer row sums a word; B2's
// CTA also packs and unpacks its band's bytes, which want more threads in
// flight (gol_tpu_torch/tools/batch_band_sweep.py times both against
// other sizes).
constexpr int kPackedBandThreads = 512;
constexpr int kMaskedBandThreads = 1024;
// B1 block form: the warps' flag words, one set per generation parity.
constexpr int kBlockStaticShared = 2 * kBlockMaxWarps * 4;
// The most shared memory a block takes without the opt-in, static and
// dynamic together: past it a kernel's dynamic shared memory is asked for
// with cudaFuncSetAttribute (needs_optin).
constexpr int kDefaultShared = 48 * 1024;
// The column-cut forms' most generations a launch: one ghost word each
// side keeps a tile's owned words exact for 32.
constexpr int kTileMaxGenerations = 32;
// The column-cut plan narrows tiles to fill the SMs down to this many
// words (ghost words then cost at most 1.25x) or the width that fits.
constexpr int kFillMinWords = 8;

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

// Row `row` of a bit board's sums at word k (see sums), the board `last` +
// 1 words wide with its last cell at bit `lw` of word `last`, wrapping at
// the board's width: the west neighbour of column 0 is the last cell, and
// the east neighbour of the last cell is column 0, placed just past it (the
// bits past the last cell are 0, and what lands there is masked off).
// `kFull`: lw is 31 (the board ends at a word boundary), so the row wraps
// at words alone. The word itself in `x`.
template <bool kFull>
__device__ __forceinline__ void masked_row_sums(const uint32_t* row, int k,
                                                int last, int lw, uint32_t& m0,
                                                uint32_t& m1, uint32_t& s0,
                                                uint32_t& s1, uint32_t& x) {
  x = row[k];
  const uint32_t en = row[k != last ? k + 1 : 0];
  if (kFull) {
    sums(x, row[k != 0 ? k - 1 : last], en, m0, m1, s0, s1);
    return;
  }
  const uint32_t wn = k != 0 ? row[k - 1] : row[last] >> lw << 31;
  const uint32_t xe = k == last && lw != 31 ? x | (row[0] & 1u) << (lw + 1) : x;
  sums(xe, wn, en, m0, m1, s0, s1);
}

// One generation of rows [lo, hi) of a bit board held in shared memory,
// `rows` rows `stride` words apart (the neighbours of row r are rows r - 1
// and r + 1 modulo `rows`), from `src` to `dst`, by the CTA: thread k walks
// strips of `strip` rows of one word column of the board's nwb (units k,
// k + blockDim.x, ...), keeping the row sums of the rows above and at the
// current one, so a word costs one new row sum. The bits past the last
// cell (lw) stay 0 (`last_mask`). ORs the new words into `alive` and the
// changed bits into `differs`. The block forms' torus is the case lo = 0,
// hi = rows; a band's trapezoid (the banded forms) never reaches its first
// or last row, so it never wraps. B1's board is the case stride = nwb, lw
// = 31; `kFull` must be lw == 31 (masked_row_sums).
template <bool kFull>
__device__ __forceinline__ void masked_generation(const uint32_t* src,
                                                  uint32_t* dst, int rows,
                                                  int lo, int hi, int nwb,
                                                  int stride, int lw, int strip,
                                                  uint32_t& alive,
                                                  uint32_t& differs) {
  const int last = nwb - 1;
  const uint32_t last_mask = kFull ? ~0u : (1u << (lw + 1)) - 1u;
  const int units = (hi - lo + strip - 1) / strip * nwb;
  for (int u = threadIdx.x; u < units; u += blockDim.x) {
    const int k = u % nwb;
    const int r0 = lo + u / nwb * strip;
    const int r1 = min(r0 + strip, hi);
    const uint32_t keep = k == last ? last_mask : ~0u;
    uint32_t u0, u1, m0, m1, s0, s1, x, unused0, unused1, unused2;
    masked_row_sums<kFull>(src + (r0 == 0 ? rows - 1 : r0 - 1) * stride, k,
                           last, lw, unused0, unused1, u0, u1, unused2);
    masked_row_sums<kFull>(src + r0 * stride, k, last, lw, m0, m1, s0, s1, x);
    for (int r = r0; r < r1; ++r) {
      uint32_t dm0, dm1, d0, d1, xd;
      masked_row_sums<kFull>(src + (r + 1 == rows ? 0 : r + 1) * stride, k,
                             last, lw, dm0, dm1, d0, d1, xd);
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

// B2's generation: masked_generation, word-wrapped where the board ends at
// a word boundary (lw == 31).
__device__ __forceinline__ void board_generation(const uint32_t* src,
                                                 uint32_t* dst, int rows,
                                                 int lo, int hi, int nwb,
                                                 int stride, int lw, int strip,
                                                 uint32_t& alive,
                                                 uint32_t& differs) {
  if (lw == 31) {
    masked_generation<true>(src, dst, rows, lo, hi, nwb, stride, lw, strip,
                            alive, differs);
  } else {
    masked_generation<false>(src, dst, rows, lo, hi, nwb, stride, lw, strip,
                             alive, differs);
  }
}

// The rows of a strip (masked_generation) that spread `rows` rows of `nwb`
// words over the CTA's threads, one unit each.
__device__ __forceinline__ int generation_strip(int rows, int nwb) {
  const int threads = static_cast<int>(blockDim.x);
  return max(1, min(rows, (rows * nwb + threads - 1) / threads));
}

// Word k of a column-cut tile's row's sums (see sums), the row `ncols`
// words with 0 past its ghost words 0 and ncols - 1; the word in `x`.
__device__ __forceinline__ void tile_row_sums(const uint32_t* row, int k,
                                              int ncols, uint32_t& m0,
                                              uint32_t& m1, uint32_t& s0,
                                              uint32_t& s1, uint32_t& x) {
  x = row[k];
  sums(x, k != 0 ? row[k - 1] : 0u, k != ncols - 1 ? row[k + 1] : 0u, m0, m1,
       s0, s1);
}

// One generation of rows [lo, hi) of a column-cut tile in shared memory,
// `rows` rows of `ncols` words (the neighbours of row r are rows r - 1 and
// r + 1 modulo `rows`: lo = 0, hi = rows is a tile of its board's whole
// height; the trapezoid never reaches its first or last row), from `src`
// to `dst`, by the CTA: thread k walks strips of `strip` rows of one word
// column, as masked_generation. Words 0 and ncols - 1 are the ghost words,
// computed as if 0 lay past them and never counted in `alive` and
// `differs`.
__device__ __forceinline__ void tile_generation(const uint32_t* src,
                                                uint32_t* dst, int rows,
                                                int lo, int hi, int ncols,
                                                int strip, uint32_t& alive,
                                                uint32_t& differs) {
  const int units = (hi - lo + strip - 1) / strip * ncols;
  for (int u = threadIdx.x; u < units; u += blockDim.x) {
    const int k = u % ncols;
    const int r0 = lo + u / ncols * strip;
    const int r1 = min(r0 + strip, hi);
    const uint32_t owned = k != 0 && k != ncols - 1 ? ~0u : 0u;
    uint32_t u0, u1, m0, m1, s0, s1, x, unused0, unused1, unused2;
    tile_row_sums(src + (r0 == 0 ? rows - 1 : r0 - 1) * ncols, k, ncols,
                  unused0, unused1, u0, u1, unused2);
    tile_row_sums(src + r0 * ncols, k, ncols, m0, m1, s0, s1, x);
    for (int r = r0; r < r1; ++r) {
      uint32_t dm0, dm1, d0, d1, xd;
      tile_row_sums(src + (r + 1 == rows ? 0 : r + 1) * ncols, k, ncols, dm0,
                    dm1, d0, d1, xd);
      const uint32_t nv = next_gen(u0, u1, d0, d1, m0, m1, x);
      dst[r * ncols + k] = nv;
      alive |= nv & owned;
      differs |= (nv ^ x) & owned;
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

// The block and banded forms' flags of one generation: a warp's
// __reduce_or_sync of the CTA's (alive, differs), one word per warp in
// `words` (the generation's parity's set), one barrier, and thread 0 puts
// the pair into `pair`: with plain stores where the CTA holds the whole
// board (`shared` false), else (a band: several CTAs share the board's
// pair) ORed in, with the atomic issued only for a flag that was still
// clear when thread 0 read it, just before the barrier (so the barrier's
// wait hides the read). Every thread of the CTA calls it. Thread 0 reads
// `words` before any warp writes them again: that is after the next
// generation's barrier, which thread 0 has not reached.
__device__ __forceinline__ void block_flags(uint32_t alive, uint32_t differs,
                                            uint32_t* words, int* pair,
                                            bool shared) {
  const unsigned both = __reduce_or_sync(
      kFullMask, (alive != 0 ? 1u : 0u) | (differs != 0 ? 2u : 0u));
  if (threadIdx.x % kWarp == 0) words[threadIdx.x / kWarp] = both;
  int seen[2] = {0, 0};
  if (shared && threadIdx.x == 0) {
    seen[0] = *reinterpret_cast<volatile int*>(pair);
    seen[1] = *reinterpret_cast<volatile int*>(pair + 1);
  }
  __syncthreads();  // the generation is written, and its warps' flags
  if (threadIdx.x == 0) {
    unsigned any = 0;
    for (int k = 0; k < static_cast<int>(blockDim.x) / kWarp; ++k) any |= words[k];
    for (int q = 0; q < 2; ++q) {
      const int bit = static_cast<int>(any >> q & 1u);
      if (!shared) {
        pair[q] = bit;
      } else if (bit && !seen[q]) {
        atomicOr(pair + q, 1);
      }
    }
  }
}

// `count` words from device memory at `src` to `dst` (shared or device
// memory), with 16-byte accesses where `wide` (both 16-byte aligned, count
// a multiple of 4), by the CTA.
__device__ __forceinline__ void load_words(const uint32_t* src, uint32_t* dst,
                                           int count, bool wide) {
  if (wide) {
    const uint4* from = reinterpret_cast<const uint4*>(src);
    uint4* to = reinterpret_cast<uint4*>(dst);
    for (int i = threadIdx.x; i < count / 4; i += blockDim.x) to[i] = __ldg(from + i);
  } else {
    for (int i = threadIdx.x; i < count; i += blockDim.x) dst[i] = __ldg(src + i);
  }
}

// `count` words from shared memory at `src` to device memory at `dst`, as
// load_words.
__device__ __forceinline__ void store_words(const uint32_t* src, uint32_t* dst,
                                            int count, bool wide) {
  if (wide) {
    const uint4* from = reinterpret_cast<const uint4*>(src);
    uint4* to = reinterpret_cast<uint4*>(dst);
    for (int i = threadIdx.x; i < count / 4; i += blockDim.x) to[i] = from[i];
  } else {
    for (int i = threadIdx.x; i < count; i += blockDim.x) dst[i] = src[i];
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
  load_words(in + base, cur, words, wide);
  const int n = min(__ldg(steps + b), t);
  __syncthreads();
  for (int i = 0; i < n; ++i) {
    uint32_t alive = 0, differs = 0;
    masked_generation<true>(cur, nxt, height, 0, height, nwords, nwords, 31,
                            strip, alive, differs);
    block_flags(alive, differs, warp_flags[i & 1],
                flags + 2 * (static_cast<size_t>(i) * batch + b), false);
    uint32_t* done = nxt;
    nxt = cur;
    cur = done;
  }
  store_words(cur, out + base, words, wide);
}

// x modulo m, in [0, m).
__device__ __forceinline__ int wrap(int x, int m) { return (x % m + m) % m; }

// The banded and column-cut forms' CTA: board b and its tile's first row
// r0 and first word k0 from blockIdx.x (boards x row bands x column tiles
// on grid.x, column tiles fastest), the tiles `band_rows` rows x
// `band_cols` words of `nwb`-word rows (a banded form's band_cols = nwb).
__device__ __forceinline__ void tile_of(int height, int nwb, int band_rows,
                                        int band_cols, int& b, int& r0,
                                        int& k0) {
  const int bands = (height + band_rows - 1) / band_rows;
  const int cuts = (nwb + band_cols - 1) / band_cols;
  const int cta = static_cast<int>(blockIdx.x);
  b = cta / (bands * cuts);
  const int tile = cta - b * bands * cuts;
  r0 = tile / cuts * band_rows;
  k0 = tile % cuts * band_cols;
}

// B1's banded (kCut false) and column-cut (kCut true) forms: grid (batch *
// bands * cuts), bands = ceil(height / band_rows), cuts = ceil(nwords /
// band_cols) (1 for the banded form, whose band_cols is nwords);
// block_threads(copy words) threads, at most kPackedBandThreads, dynamic
// shared memory for two copies (band_launch): band_rows + 2 tb rows (a
// column-cut tile of the whole height: height rows) of nwords words
// (column-cut: band_cols + 2). Generations g0 .. g0 + tb - 1 of the
// block: board b runs n = min(steps[b] - g0, tb) of them (none: its tile
// is copied through), generation g0 + i's pair ORed into flags[i, b] (the
// caller's flag row of g0 on). `strip`: the column-cut form's rows a
// thread walks (tile_strip).
template <bool kCut>
__global__ void __launch_bounds__(kPackedBandThreads,
                                  kBlockMaxThreads / kPackedBandThreads)
batch_packed_band_kernel(const uint32_t* __restrict__ in,
                         uint32_t* __restrict__ out, int* __restrict__ flags,
                         const int* __restrict__ steps, int g0, int tb,
                         int batch, int height, int nwords, int band_rows,
                         int band_cols, int strip) {
  extern __shared__ __align__(16) uint4 board_shared[];
  __shared__ uint32_t warp_flags[2][kBlockMaxWarps];
  int b, r0, k0;
  tile_of(height, nwords, band_rows, band_cols, b, r0, k0);
  const int own = min(band_rows, height - r0);
  const int cols = min(band_cols, nwords - k0);  // the tile's owned words
  const size_t base = static_cast<size_t>(b) * height * nwords;
  const bool wide = nwords % 4 == 0 &&
                    reinterpret_cast<uintptr_t>(in) % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const int n = max(0, min(__ldg(steps + b) - g0, tb));
  if (n == 0) {  // spent: the whole CTA copies its tile and returns
    if constexpr (kCut) {
      for (int i = threadIdx.x; i < own * cols; i += blockDim.x) {
        const int j = i / cols;
        const size_t at = base + static_cast<size_t>(r0 + j) * nwords + k0 + (i - j * cols);
        out[at] = __ldg(in + at);
      }
    } else {
      load_words(in + base + static_cast<size_t>(r0) * nwords,
                 out + base + static_cast<size_t>(r0) * nwords, own * nwords, wide);
    }
    return;
  }
  // Local row j holds board row r0 - ghosts + j (modulo height): the tile
  // and its ghost rows each side, none where the tile holds the board's
  // whole height (its rows wrap in shared memory).
  const int ghosts = kCut && own == height ? 0 : n;
  const int rows = own + 2 * ghosts;
  const int stride = kCut ? cols + 2 : nwords;
  uint32_t* cur = reinterpret_cast<uint32_t*>(board_shared);
  uint32_t* nxt = cur + ((rows * stride + 3) & ~3);  // 16-byte aligned
  if constexpr (kCut) {
    // Local word q of a row is the board's word k0 - 1 + q (modulo nwords).
    const int first = wrap(r0 - ghosts, height);
    for (int i = threadIdx.x; i < rows * stride; i += blockDim.x) {
      const int j = i / stride;
      int r = first + j, k = k0 - 1 + (i - j * stride);
      if (r >= height) r = wrap(r, height);
      if (k < 0) {
        k += nwords;
      } else if (k >= nwords) {
        k -= nwords;
      }
      cur[i] = __ldg(in + base + static_cast<size_t>(r) * nwords + k);
    }
  } else {
    // Loaded in runs of consecutive board rows.
    for (int j = 0, r = wrap(r0 - n, height); j < rows; r = 0) {
      const int run = min(rows - j, height - r);
      load_words(in + base + static_cast<size_t>(r) * nwords, cur + j * nwords,
                 run * nwords, wide);
      j += run;
    }
  }
  __syncthreads();
  const int band_strip = generation_strip(rows - 2, nwords);
  for (int i = 0; i < n; ++i) {
    // Rows [1 + i, rows - 1 - i) are exact after generation i (all of
    // them in a tile of the whole height): each is a row of the board at
    // that generation, so the flags may count them all.
    uint32_t alive = 0, differs = 0;
    if constexpr (kCut) {
      tile_generation(cur, nxt, rows, ghosts ? 1 + i : 0,
                      ghosts ? rows - 1 - i : rows, stride, strip, alive, differs);
    } else {
      masked_generation<true>(cur, nxt, rows, 1 + i, rows - 1 - i, nwords,
                              nwords, 31, band_strip, alive, differs);
    }
    block_flags(alive, differs, warp_flags[i & 1],
                flags + 2 * (static_cast<size_t>(i) * batch + b), true);
    uint32_t* done = nxt;
    nxt = cur;
    cur = done;
  }
  if constexpr (kCut) {
    for (int i = threadIdx.x; i < own * cols; i += blockDim.x) {
      const int j = i / cols, q = i - j * cols;
      out[base + static_cast<size_t>(r0 + j) * nwords + k0 + q] =
          cur[(ghosts + j) * stride + 1 + q];
    }
  } else {
    store_words(cur + n * nwords, out + base + static_cast<size_t>(r0) * nwords,
                own * nwords, wide);
  }
}

// B2, block and banded forms. The bytes of a span split at 16-byte
// boundaries of `p`: the bytes before the first boundary (head_bytes),
// whole 16-byte chunks, and the rest.
__device__ __forceinline__ int head_bytes(const void* p, int n) {
  return min(n, static_cast<int>((16 - reinterpret_cast<uintptr_t>(p) % 16) % 16));
}

// The cells of the `n` low bytes of `v` (the first lowest), from row r,
// column c of a slot `width` wide, into the bit board `bits` (`stride`
// words a row, slot row r at bit row r - roff): a cell inside the extent
// (h, w) sets its bit through `acc`, the bits gathered for word `at`,
// which goes to shared memory with one atomicOr when the next cell is
// another word's (the caller ORs the last); a non-zero cell at or past the
// extent in rows [plo, phi) sets `pad`. Advances (r, c).
__device__ __forceinline__ void pack_cells(uint32_t v, int n, int& r, int& c,
                                           int width, int h, int w,
                                           int stride, uint32_t* bits,
                                           int roff, int plo, int phi,
                                           uint32_t& acc, int& at,
                                           uint32_t& pad) {
  for (int q = 0; q < n; ++q, v >>= 8) {
    const uint32_t cell = v & 0xffu;
    if (r < h && c < w) {
      const int word = (r - roff) * stride + (c >> 5);
      if (word != at) {
        if (acc != 0) atomicOr(bits + at, acc);
        acc = 0;
        at = word;
      }
      acc |= (cell != 0 ? 1u : 0u) << (c & 31);
    } else if (r >= plo && r < phi) {
      pad |= cell;
    }
    if (++c == width) {
      c = 0;
      ++r;
    }
  }
}

// Four cells, the bytes of `v` (the first lowest), as four bits: bit q =
// (byte q != 0). Each byte's bits are folded into its bit 0, and one
// multiply gathers the four bit 0s into bits 28-31 (every other product
// term lands below bit 28 or past bit 31, each on a bit of its own).
__device__ __forceinline__ uint32_t cells_to_bits(uint32_t v) {
  v |= v >> 4;
  v |= v >> 2;
  v |= v >> 1;
  return (v & 0x01010101u) * 0x10204080u >> 28;
}

// Four bits (the low nibble of `n`) as four 0/1 cell bytes: one multiply
// places bit q at bit 8q (the other terms land on bits of their own).
__device__ __forceinline__ uint32_t bits_to_cells(uint32_t n) {
  return (n & 0xfu) * 0x00204081u & 0x01010101u;
}

// Rows [ra, rb) of the slot `slot` (`width` bytes a row) into `bits` by
// the CTA, as pack_cells: 16-byte loads (the bytes before the first
// 16-byte boundary and after the last one singly). A load whose 16 cells
// lie in one row inside the extent turns into 16 bits at once
// (cells_to_bits) and goes to shared memory with one atomicOr a word it
// touches; any other load's cells go one by one through pack_cells, ORed
// with one atomicOr a word.
__device__ __forceinline__ void pack_span(const uint8_t* slot, int ra, int rb,
                                          int width, int h, int w, int stride,
                                          uint32_t* bits, int roff, int plo,
                                          int phi, uint32_t& pad) {
  const int first = ra * width;
  const int count = (rb - ra) * width;
  const int head = head_bytes(slot + first, count);
  const int chunks = (count - head) / 16;
  const int rest = count - head - 16 * chunks;
  const uint4* vec = reinterpret_cast<const uint4*>(slot + first + head);
  for (int i = threadIdx.x; i < chunks; i += blockDim.x) {
    const uint4 v = __ldg(vec + i);
    const int f = first + head + 16 * i;
    int r = f / width, c = f - r * width;
    if (r < h && c + 16 <= w) {
      const uint32_t b16 = cells_to_bits(v.x) | cells_to_bits(v.y) << 4 |
                           cells_to_bits(v.z) << 8 | cells_to_bits(v.w) << 12;
      uint32_t* word = bits + (r - roff) * stride + (c >> 5);
      const int shift = c & 31;
      if (b16 << shift) atomicOr(word, b16 << shift);
      if (shift > 16 && b16 >> (32 - shift)) atomicOr(word + 1, b16 >> (32 - shift));
      continue;
    }
    int at = -1;
    uint32_t acc = 0;
    pack_cells(v.x, 4, r, c, width, h, w, stride, bits, roff, plo, phi, acc, at, pad);
    pack_cells(v.y, 4, r, c, width, h, w, stride, bits, roff, plo, phi, acc, at, pad);
    pack_cells(v.z, 4, r, c, width, h, w, stride, bits, roff, plo, phi, acc, at, pad);
    pack_cells(v.w, 4, r, c, width, h, w, stride, bits, roff, plo, phi, acc, at, pad);
    if (acc != 0) atomicOr(bits + at, acc);
  }
  for (int i = threadIdx.x; i < head + rest; i += blockDim.x) {
    const int f = first + (i < head ? i : count - rest + (i - head));
    int r = f / width, c = f - r * width, at = -1;
    uint32_t acc = 0;
    pack_cells(__ldg(slot + f), 1, r, c, width, h, w, stride, bits, roff, plo,
               phi, acc, at, pad);
    if (acc != 0) atomicOr(bits + at, acc);
  }
}

// The `n` cells from row r, column c of a slot `width` wide as bytes (the
// first lowest): bit c of bit row r - roff of the bit board for rows below
// `rlim`, 0 at and past it. Advances (r, c).
__device__ __forceinline__ uint32_t unpack_cells(int n, int& r, int& c,
                                                 int width, int stride,
                                                 const uint32_t* bits, int roff,
                                                 int rlim) {
  uint32_t v = 0;
  for (int q = 0; q < n; ++q) {
    if (r < rlim) v |= (bits[(r - roff) * stride + (c >> 5)] >> (c & 31) & 1u) << (8 * q);
    if (++c == width) {
      c = 0;
      ++r;
    }
  }
  return v;
}

// Rows [ra, rb) of the slot `slot` as bytes from `bits` by the CTA, as
// unpack_cells, with 16-byte stores (the bytes before the first 16-byte
// boundary and after the last one singly). A store whose 16 cells lie in
// one row takes their 16 bits at once, from the one or two words they sit
// in (0 in rows at or past `rlim`), and spreads them with bits_to_cells.
__device__ __forceinline__ void unpack_span(uint8_t* slot, int ra, int rb,
                                            int width, int stride,
                                            const uint32_t* bits, int roff,
                                            int rlim) {
  const int first = ra * width;
  const int count = (rb - ra) * width;
  const int head = head_bytes(slot + first, count);
  const int chunks = (count - head) / 16;
  const int rest = count - head - 16 * chunks;
  uint4* vec = reinterpret_cast<uint4*>(slot + first + head);
  for (int i = threadIdx.x; i < chunks; i += blockDim.x) {
    const int f = first + head + 16 * i;
    int r = f / width, c = f - r * width;
    uint4 v;
    if (c + 16 <= width) {
      uint32_t b16 = 0;
      if (r < rlim) {
        const uint32_t* word = bits + (r - roff) * stride + (c >> 5);
        const int shift = c & 31;
        b16 = word[0] >> shift;
        if (shift > 16) b16 |= word[1] << (32 - shift);
      }
      v.x = bits_to_cells(b16);
      v.y = bits_to_cells(b16 >> 4);
      v.z = bits_to_cells(b16 >> 8);
      v.w = bits_to_cells(b16 >> 12);
    } else {
      v.x = unpack_cells(4, r, c, width, stride, bits, roff, rlim);
      v.y = unpack_cells(4, r, c, width, stride, bits, roff, rlim);
      v.z = unpack_cells(4, r, c, width, stride, bits, roff, rlim);
      v.w = unpack_cells(4, r, c, width, stride, bits, roff, rlim);
    }
    vec[i] = v;
  }
  for (int i = threadIdx.x; i < head + rest; i += blockDim.x) {
    const int f = first + (i < head ? i : count - rest + (i - head));
    int r = f / width, c = f - r * width;
    slot[f] = static_cast<uint8_t>(unpack_cells(1, r, c, width, stride, bits,
                                                roff, rlim));
  }
}

// A spent board's span of `cells` bytes, byte for byte, by the CTA:
// 16-byte loads and stores where `src` and `dst` sit alike against 16-byte
// boundaries.
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

// B2, column-cut form. The 16 cells of the 16-byte granule at `g` as 16
// bits (bit q: byte q != 0): one 16-byte load, or, for a granule not
// wholly inside [lo, hi) (the canvas's bytes), its bytes inside it one by
// one and 0 for the others.
__device__ __forceinline__ uint32_t granule_bits(const uint8_t* g,
                                                 const uint8_t* lo,
                                                 const uint8_t* hi) {
  if (g >= lo && g + 16 <= hi) {
    const uint4 v = __ldg(reinterpret_cast<const uint4*>(g));
    return cells_to_bits(v.x) | cells_to_bits(v.y) << 4 |
           cells_to_bits(v.z) << 8 | cells_to_bits(v.w) << 12;
  }
  uint32_t v = 0;
  for (int q = 0; q < 16; ++q) {
    if (g + q >= lo && g + q < hi) v |= (__ldg(g + q) != 0 ? 1u : 0u) << q;
  }
  return v;
}

// A word of a column-cut tile's window: bit j is cell (c + j) mod w of the
// slot row `row`, c in [0, w). Where the 32 cells lie in the row (c + 32 <=
// w), from the two or three aligned granules that hold them (granule_bits);
// else cell by cell, wrapping at w.
__device__ __forceinline__ uint32_t window_word(const uint8_t* row, int c,
                                                int w, const uint8_t* lo,
                                                const uint8_t* hi) {
  if (c + 32 > w) {
    uint32_t v = 0;
    for (int j = 0; j < 32; ++j) {
      v |= (__ldg(row + c) != 0 ? 1u : 0u) << j;
      if (++c == w) c = 0;
    }
    return v;
  }
  const uint8_t* p = row + c;
  const int s = static_cast<int>(reinterpret_cast<uintptr_t>(p) % 16);
  const uint8_t* g = p - s;
  uint64_t bits = granule_bits(g, lo, hi) |
                  static_cast<uint64_t>(granule_bits(g + 16, lo, hi)) << 16;
  if (s != 0) bits |= static_cast<uint64_t>(granule_bits(g + 32, lo, hi)) << 32;
  return static_cast<uint32_t>(bits >> s);
}

// Calls f(r, c, n, whole) for the pieces of rows [ra, rb) x columns [ca,
// cb) of a slot `width` bytes a row at `slot`, cut at the 16-byte
// boundaries of the address space: n cells of row r from column c on,
// `whole` where they are one aligned 16-byte granule. The CTA's threads
// take the pieces in turn, ceil((cb - ca) / 16) + 1 places a row.
template <class F>
__device__ __forceinline__ void for_granules(const uint8_t* slot, int ra,
                                             int rb, int ca, int cb,
                                             int width, F f) {
  const int len = cb - ca;
  if (len <= 0 || rb <= ra) return;
  const int per = len / 16 + 2;
  for (int i = threadIdx.x; i < (rb - ra) * per; i += blockDim.x) {
    const int j = i / per;
    const uint8_t* first = slot + static_cast<size_t>(ra + j) * width + ca;
    const uint8_t* g = first - reinterpret_cast<uintptr_t>(first) % 16 +
                       16 * (i - j * per);
    const uint8_t* s = g > first ? g : first;
    const uint8_t* e = g + 16 < first + len ? g + 16 : first + len;
    if (s < e) {
      f(ra + j, ca + static_cast<int>(s - first), static_cast<int>(e - s),
        s == g && e == g + 16);
    }
  }
}

// The OR of the cells in rows [ra, rb) x columns [ca, cb) of `slot`, by
// the CTA (each thread its share).
__device__ __forceinline__ uint32_t or_region(const uint8_t* slot, int ra,
                                              int rb, int ca, int cb,
                                              int width) {
  uint32_t acc = 0;
  for_granules(slot, ra, rb, ca, cb, width, [&](int r, int c, int n, bool whole) {
    const uint8_t* p = slot + static_cast<size_t>(r) * width + c;
    if (whole) {
      const uint4 v = __ldg(reinterpret_cast<const uint4*>(p));
      acc |= v.x | v.y | v.z | v.w;
    } else {
      for (int q = 0; q < n; ++q) acc |= __ldg(p + q);
    }
  });
  return acc;
}

// Rows [ra, rb) x columns [ca, cb) of a spent board's slot, byte for byte,
// by the CTA: 16-byte loads and stores where `src` and `dst` sit alike
// against 16-byte boundaries.
__device__ __forceinline__ void copy_region(const uint8_t* src, uint8_t* dst,
                                            int ra, int rb, int ca, int cb,
                                            int width) {
  const bool paired = (reinterpret_cast<uintptr_t>(dst) -
                       reinterpret_cast<uintptr_t>(src)) % 16 == 0;
  for_granules(src, ra, rb, ca, cb, width, [&](int r, int c, int n, bool whole) {
    const size_t at = static_cast<size_t>(r) * width + c;
    if (whole && paired) {
      *reinterpret_cast<uint4*>(dst + at) = __ldg(reinterpret_cast<const uint4*>(src + at));
    } else {
      for (int q = 0; q < n; ++q) dst[at + q] = __ldg(src + at + q);
    }
  });
}

// Rows [ra, rb) x columns [ca, cb) of `slot` as bytes from a column-cut
// tile's bit rows (`stride` words, bit row r - roff for slot row r): cell
// (r, c) is position c - ca + 32 of its row for rows below `rlim` and
// columns below `w`, 0 elsewhere; 16 cells with one 16-byte store where
// they are one aligned granule (bits_to_cells), by the CTA.
__device__ __forceinline__ void unpack_window(uint8_t* slot, int ra, int rb,
                                              int ca, int cb, int width,
                                              int w, int rlim,
                                              const uint32_t* bits,
                                              int stride, int roff) {
  for_granules(slot, ra, rb, ca, cb, width, [&](int r, int c, int n, bool whole) {
    uint32_t b16 = 0;
    if (r < rlim && c < w) {
      const uint32_t* row = bits + (r - roff) * stride;
      const int p = c - ca + 32;
      b16 = __funnelshift_r(row[p >> 5], row[(p >> 5) + 1], p & 31);
      if (w - c < 32) b16 &= (1u << (w - c)) - 1u;
    }
    uint8_t* at = slot + static_cast<size_t>(r) * width + c;
    if (whole) {
      uint4 v;
      v.x = bits_to_cells(b16);
      v.y = bits_to_cells(b16 >> 4);
      v.z = bits_to_cells(b16 >> 8);
      v.w = bits_to_cells(b16 >> 12);
      *reinterpret_cast<uint4*>(at) = v;
    } else {
      for (int q = 0; q < n; ++q) at[q] = static_cast<uint8_t>(b16 >> q & 1u);
    }
  });
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
  pack_span(src, 0, height, width, h, w, stride, cur, 0, 0, height, pad);
  __syncthreads();  // the board is packed
  const int nwb = (w + 31) / 32;
  const int lw = (w - 1) & 31;
  const int strip = generation_strip(h, nwb);
  for (int i = 0; i < n; ++i) {
    // A non-zero cell of the slot's padding differs from the 0 written
    // there in the first generation.
    uint32_t alive = 0, differs = i == 0 ? pad : 0;
    board_generation(cur, nxt, h, 0, h, nwb, stride, lw, strip, alive, differs);
    block_flags(alive, differs, warp_flags[i & 1],
                flags + 2 * (static_cast<size_t>(i) * batch + b), false);
    uint32_t* done = nxt;
    nxt = cur;
    cur = done;
  }
  // The last generation's barrier (in block_flags) is behind: `cur` is
  // whole. Bytes over the whole slot, 0 past the board.
  unpack_span(dst, 0, height, width, stride, cur, 0, height);
}

// B2's banded (kCut false) and column-cut (kCut true) forms: grid (batch *
// bands * cuts) over the canvas's rows and words of bits, bands =
// ceil(height / band_rows), cuts = ceil(nwc / band_cols), nwc =
// ceil(width / 32) (1 for the banded form, whose band_cols is nwc);
// block_threads(copy words) threads, at most kMaskedBandThreads, dynamic
// shared memory for two bit copies (band_launch): band_rows + 2 tb rows
// (a column-cut tile of the whole canvas height: height rows) of nwc
// words (column-cut: band_cols + 2). Generations g0 .. g0 + tb - 1 of the
// block, as B1's. The tile owns canvas rows [r0, r0 + span) and columns
// [ca, cb): the board's cells among them with n ghost rows each side,
// modulo the board's height (none where it holds all of them), as bits;
// the rest padding (0 after the launch; a non-zero padding cell sets the
// launch's first differs flag). `strip` as B1's.
template <bool kCut>
__global__ void __launch_bounds__(kMaskedBandThreads,
                                  kBlockMaxThreads / kMaskedBandThreads)
batch_masked_band_kernel(const uint8_t* __restrict__ in,
                         uint8_t* __restrict__ out, int* __restrict__ flags,
                         const int* __restrict__ steps,
                         const int* __restrict__ heights,
                         const int* __restrict__ widths, int g0, int tb,
                         int batch, int height, int width, int band_rows,
                         int band_cols, int strip) {
  extern __shared__ __align__(16) uint4 board_shared[];
  __shared__ uint32_t warp_flags[2][kBlockMaxWarps];
  const int nwc = (width + 31) / 32;
  int b, r0, k0;
  tile_of(height, nwc, band_rows, band_cols, b, r0, k0);
  const int span = min(band_rows, height - r0);
  const int cols = min(band_cols, nwc - k0);
  const int ca = 32 * k0, cb = min(32 * (k0 + cols), width);
  const size_t cells = static_cast<size_t>(height) * width;
  const uint8_t* src = in + b * cells;
  uint8_t* dst = out + b * cells;
  const int n = max(0, min(__ldg(steps + b) - g0, tb));
  if (n == 0) {  // spent: the whole CTA copies its tile and returns
    if constexpr (kCut) {
      copy_region(src, dst, r0, r0 + span, ca, cb, width);
    } else {
      copy_slot(src + r0 * width, dst + r0 * width, span * width);
    }
    return;
  }
  const int h = min(__ldg(heights + b), height);
  const int w = min(__ldg(widths + b), width);
  const int own = max(0, min(r0 + span, h) - r0);
  // The tile holds board cells (the banded form's: board rows).
  const bool live = own > 0 && ca < w;
  const int ghosts = live && !(kCut && own == h) ? n : 0;
  // Bit row j holds board row r0 - ghosts + j (modulo h).
  const int rows = live ? own + 2 * ghosts : 0;
  const int stride = kCut ? cols + 2 : nwc;
  const int padded = (rows * stride + 3) & ~3;  // 16-byte aligned copies
  uint32_t* cur = reinterpret_cast<uint32_t*>(board_shared);
  uint32_t* nxt = cur + padded;
  uint32_t pad = 0;
  if constexpr (kCut) {
    // Every word of the window is written: nothing to zero.
    if (live) {
      const int first = wrap(r0 - ghosts, h), c0 = wrap(ca - 32, w);
      for (int i = threadIdx.x; i < rows * stride; i += blockDim.x) {
        const int j = i / stride;
        int r = first + j, c = c0 + 32 * (i - j * stride);
        if (r >= h) r = wrap(r, h);
        if (c >= w) c %= w;
        cur[i] = window_word(src + static_cast<size_t>(r) * width, c, w, in,
                             in + batch * cells);
      }
    }
    // The tile's padding: its rows past the board, and its columns past
    // the board in the board's rows.
    pad = or_region(src, r0 + (live ? own : 0), r0 + span, ca, cb, width);
    if (live) pad |= or_region(src, r0, r0 + own, max(ca, w), cb, width);
  } else {
    for (int i = threadIdx.x; i < 2 * padded; i += blockDim.x) cur[i] = 0;
    __syncthreads();  // both copies 0, as in the block form
    for (int j = 0, r = own > 0 ? wrap(r0 - ghosts, h) : 0; j < rows; r = 0) {
      const int run = min(rows - j, h - r);
      pack_span(src, r, r + run, width, h, w, stride, cur, r - j, r0, r0 + span,
                pad);
      j += run;
    }
    if (r0 + span > max(r0, h)) {  // the band's rows past the board: padding
      pack_span(src, max(r0, h), r0 + span, width, h, w, stride, cur, 0, r0,
                r0 + span, pad);
    }
  }
  __syncthreads();  // the tile is packed
  const int nwb = (w + 31) / 32;
  const int lw = (w - 1) & 31;
  const int band_strip = generation_strip(max(1, rows - 2), nwb);
  // A tile of padding alone runs no generation: its first pair carries
  // its padding.
  const int gens = live ? n : 1;
  for (int i = 0; i < gens; ++i) {
    uint32_t alive = 0, differs = i == 0 ? pad : 0;
    if (live) {
      if constexpr (kCut) {
        tile_generation(cur, nxt, rows, ghosts ? 1 + i : 0,
                        ghosts ? rows - 1 - i : rows, stride, strip, alive,
                        differs);
      } else {
        board_generation(cur, nxt, rows, 1 + i, rows - 1 - i, nwb, stride, lw,
                         band_strip, alive, differs);
      }
    }
    block_flags(alive, differs, warp_flags[i & 1],
                flags + 2 * (static_cast<size_t>(i) * batch + b), true);
    uint32_t* done = nxt;
    nxt = cur;
    cur = done;
  }
  if constexpr (kCut) {
    unpack_window(dst, r0, r0 + span, ca, cb, width, w, r0 + own, cur, stride,
                  r0 - ghosts);
  } else {
    unpack_span(dst, r0, r0 + span, width, stride, cur, r0 - ghosts, r0 + own);
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

// Whether `shared` dynamic bytes beside the kernels' static flag words
// pass what a block takes without the opt-in.
bool needs_optin(size_t shared) {
  return shared + kBlockStaticShared > static_cast<size_t>(kDefaultShared);
}

// The most words a copy of a board or band may have on `device` (two
// copies in the opt-in shared memory of one block, beside the flag words),
// into `most`.
cudaError_t copy_max_words(int device, int& most) {
  int optin = 0;
  const cudaError_t err =
      cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  most = (optin - kBlockStaticShared) / 8 & ~3;
  return err;
}

// The rows a thread walks in a column-cut tile's generation
// (tile_generation): the strip height s of the fewest row sums a thread
// computes, passes x (s + 2), over `rows` rows of `ncols` words at
// `threads` threads, for s = ceil(rows / q), q = 1 .. 64 strips a column.
int tile_strip(int rows, int ncols, int threads) {
  int best = max(1, rows);
  long long fewest = -1;
  for (int q = 1; q <= min(rows, 64); ++q) {
    const int s = (rows + q - 1) / q;
    const long long units = static_cast<long long>((rows + s - 1) / s) * ncols;
    const long long cost = (units + threads - 1) / threads * (s + 2);
    if (fewest < 0 || cost < fewest) {
      fewest = cost;
      best = s;
    }
  }
  return best;
}

// The banded and column-cut forms' launch of tb generations of `batch`
// boards of `height` rows of `nwb` words (of bits) in tiles of `band_rows`
// rows x `band_cols` words (the banded form: band_cols = nwb, `cut`
// false): its grid (boards x row bands x column tiles), threads
// (block_threads of a copy's words, at most `max_threads`), dynamic shared
// bytes and, for a column-cut tile, its strip (tile_strip), after asking
// for shared memory past 48 KiB for `kernel`. A column-cut tile holds
// band_rows + 2 tb rows, or `height` where band_rows >= height, of
// band_cols + 2 words. cudaErrorInvalidValue where two copies pass
// copy_max_words, a column-cut launch runs more than kTileMaxGenerations,
// or the grid passes 2^31 - 1 CTAs.
template <class K>
cudaError_t band_launch(K kernel, int max_threads, int device, int tb,
                        int batch, int height, int nwb, int band_rows,
                        int band_cols, bool cut, unsigned& grid, int& threads,
                        size_t& shared, int& strip) {
  int most = 0;
  cudaError_t err = copy_max_words(device, most);
  if (err != cudaSuccess) return err;
  if (tb < 1 || band_rows < 1 || band_cols < 1 || band_cols > nwb ||
      (cut ? tb > kTileMaxGenerations : band_cols != nwb)) {
    return cudaErrorInvalidValue;
  }
  const long long rows = cut && band_rows >= height
                             ? height
                             : band_rows + 2LL * tb;
  const long long words = rows * (cut ? band_cols + 2 : nwb);
  const long long ctas = static_cast<long long>(batch) *
                         ((height + band_rows - 1) / band_rows) *
                         ((nwb + band_cols - 1) / band_cols);
  if (words > most || ctas > 0x7fffffffLL) return cudaErrorInvalidValue;
  shared = block_shared_bytes(static_cast<int>(words));
  if (needs_optin(shared)) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(shared));
    if (err != cudaSuccess) return err;
  }
  grid = static_cast<unsigned>(ctas);
  threads = min(max_threads, block_threads(static_cast<int>(words)));
  strip = cut ? tile_strip(static_cast<int>(band_rows >= height ? rows : rows - 2),
                           band_cols + 2, threads)
              : 0;
  return cudaSuccess;
}

}  // namespace

extern "C" {

// Each entry launches on `stream` (a cudaStream_t of `device`), does not
// synchronise and allocates nothing; it returns cudaGetLastError() after
// the launch (0 = cudaSuccess). `out` must not alias `in`; `flags` is
// int32 (rows, batch, 2), generation i's pair of board b at flags + 2 * (i
// * batch + b); `steps` the (batch,) int32 step counts, `heights`/`widths`
// B2's (batch,) int32 board extents, all on the device. Every form puts
// the boards (x tiles) on grid.x.

// The most words a board may have for the block form on `device`: two
// copies in the opt-in shared memory of one block, beside the flag words.
// Negative: a CUDA error.
int gol_batch_block_max_words(int device) {
  int most = 0;
  const cudaError_t err = copy_max_words(device, most);
  return err != cudaSuccess ? -static_cast<int>(err) : most;
}

// The banded and column-cut forms' plan for a block of t generations of
// `batch` boards of `height` rows, `nwb` words a row in shared memory (B1:
// nwords; B2: ceil(width / 32)), into plan[0] = t' (the generations of a
// launch: the block runs as ceil(t / t') launches), plan[1] = R (the rows
// a tile owns) and plan[2] = C (the words a tile owns; nwb: whole-row
// bands, the banded form; less: the column-cut form). With `rows` = the
// most rows of nwb words a copy may hold (gol_batch_block_max_words /
// nwb):
// - where t' = min(t, max(1, rows / 4)) is t (and rows >= 3: a row and a
//   ghost row each side), or a row is one word (no columns to cut),
//   whole-row bands run the block: C = nwb,
//   bands a board the most of ceil(height / (rows - 2 t')) (the fewest
//   that fit) and min(floor(SMs / batch), ceil(height / t')) (one CTA an
//   SM where the batch leaves room, a band owning at least t' rows), and R
//   = ceil(height / bands). One CTA an SM: the banded kernels take about
//   50 registers a thread, so an SM holds one of their 1024-thread CTAs,
//   and a second wave of CTAs costs more than larger bands
//   (gol_tpu_torch/tools/batch_band_sweep.py times the plan's R beside R /
//   2 and 2 R);
// - else the columns are cut: t' = min(t, 32); the tile takes the board's
//   whole height (no ghost rows) or bands of about sqrt(t' x most) - 2 t'
//   rows (at least t'), whichever holds fewer copy words an owned word,
//   each as many words wide as two copies allow (R or R + 2 t' rows of C +
//   2 words), and narrower than the row (C < nwb tells the forms apart);
//   then C narrows, down to kFillMinWords words, so that boards x tiles
//   fill the whole waves of one CTA an SM that they take.
// Returns a CUDA error (0 = success); t' is never 0.
int gol_batch_band_plan(int device, int batch, int height, int nwb, int t,
                        int* plan) {
  plan[0] = plan[1] = plan[2] = 0;
  int most = 0, sms = 0;
  cudaError_t err = copy_max_words(device, most);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  if (batch < 1 || height < 1 || nwb < 1 || t < 1 || most < 9) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int rows = most / nwb;
  const int band_tp = min(t, max(1, rows / 4));
  if (rows >= 3 && (band_tp == t || nwb == 1)) {
    const int fit = rows - 2 * band_tp;
    const int bands = max((height + fit - 1) / fit,
                          min(sms / batch, (height + band_tp - 1) / band_tp));
    plan[0] = band_tp;
    plan[1] = (height + bands - 1) / bands;
    plan[2] = nwb;
    return 0;
  }
  const int tp = min(min(t, kTileMaxGenerations), most / 9);
  int band = max(tp, static_cast<int>(sqrt(static_cast<double>(tp) * most)) - 2 * tp);
  band = min(band, height);
  const int copy = band >= height ? height : band + 2 * tp;
  int cut = min(nwb - 1, most / copy - 2);
  const int whole = min(nwb - 1, most / height - 2);
  if (whole >= 1 && static_cast<double>(whole + 2) / whole <=
                        static_cast<double>(copy) * (cut + 2) / (static_cast<double>(band) * cut)) {
    band = height;
    cut = whole;
  }
  const int bands = (height + band - 1) / band;
  const long long cuts = (nwb + cut - 1) / cut;
  const long long waves = (static_cast<long long>(batch) * bands * cuts + sms - 1) / sms;
  const int least = min(cut, kFillMinWords);
  const long long room = waves * sms / batch / bands;
  const long long most_cuts = (nwb + least - 1) / least;
  const long long fill = max(cuts, min(room, most_cuts));
  plan[0] = tp;
  plan[1] = (height + bands - 1) / bands;
  plan[2] = static_cast<int>((nwb + fill - 1) / fill);
  return 0;
}

// B1, block form. in/out: (batch, height, nwords) words; flags: (t, batch,
// 2). Board b runs min(steps[b], t) generations. Fails with
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
  if (needs_optin(shared)) {
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

// B1, banded form: generations g0 .. g0 + tb - 1 of a block of B1's
// (flags: the block's (t, batch, 2), generation g0 + i's pair of board b
// at flags + 2 * ((g0 + i) * batch + b), ORed into the caller's zeroed
// rows), each board in bands of band_rows whole rows (a plan's R, for tb
// <= its t'). Board b runs min(steps[b] - g0, tb) generations (none: it
// is copied through). Fails with cudaErrorInvalidValue where the band and
// its 2 tb ghost rows pass gol_batch_block_max_words.
int gol_batch_packed_band(const void* in, void* out, void* flags,
                          const void* steps, int g0, int tb, int batch,
                          int height, int nwords, int band_rows, int device,
                          void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  unsigned grid = 0;
  int threads = 0, strip = 0;
  size_t shared = 0;
  err = band_launch(batch_packed_band_kernel<false>, kPackedBandThreads, device,
                    tb, batch, height, nwords, band_rows, nwords, false, grid,
                    threads, shared, strip);
  if (err != cudaSuccess) return static_cast<int>(err);
  batch_packed_band_kernel<false><<<grid, threads, shared,
                                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(in), static_cast<uint32_t*>(out),
      static_cast<int*>(flags) + 2 * static_cast<size_t>(g0) * batch,
      static_cast<const int*>(steps), g0, tb, batch, height, nwords, band_rows,
      nwords, strip);
  return static_cast<int>(cudaGetLastError());
}

// B1, column-cut form: generations g0 .. g0 + tb - 1 (tb <= 32) of a
// block of B1's, each board in tiles of band_rows rows x band_cols words
// (a plan's R and C, for tb <= its t'). `flags` is the flag row of g0:
// generation g0 + i's pair of board b is ORed into flags + 2 * (i * batch
// + b) (a one-generation launch: tb = 1 on a (batch, 2) buffer). Board b
// runs min(steps[b] - g0, tb) generations (none: it is copied through).
// Fails with cudaErrorInvalidValue where the tile and its ghost rows and
// words pass gol_batch_block_max_words (band_launch).
int gol_batch_packed_wide(const void* in, void* out, void* flags,
                          const void* steps, int g0, int tb, int batch,
                          int height, int nwords, int band_rows, int band_cols,
                          int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  unsigned grid = 0;
  int threads = 0, strip = 0;
  size_t shared = 0;
  err = band_launch(batch_packed_band_kernel<true>, kPackedBandThreads, device,
                    tb, batch, height, nwords, band_rows, band_cols, true, grid,
                    threads, shared, strip);
  if (err != cudaSuccess) return static_cast<int>(err);
  batch_packed_band_kernel<true><<<grid, threads, shared,
                                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(in), static_cast<uint32_t*>(out),
      static_cast<int*>(flags), static_cast<const int*>(steps), g0, tb, batch,
      height, nwords, band_rows, band_cols, strip);
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
  if (needs_optin(shared)) {
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

// B2, banded form: as B1's over (batch, height, width) cells, the bands
// over the canvas's rows, ceil(width / 32) words a bit row.
int gol_batch_masked_band(const void* in, void* out, void* flags,
                          const void* steps, const void* heights,
                          const void* widths, int g0, int tb, int batch,
                          int height, int width, int band_rows, int device,
                          void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int nwc = (width + 31) / 32;
  unsigned grid = 0;
  int threads = 0, strip = 0;
  size_t shared = 0;
  err = band_launch(batch_masked_band_kernel<false>, kMaskedBandThreads, device,
                    tb, batch, height, nwc, band_rows, nwc, false, grid, threads,
                    shared, strip);
  if (err != cudaSuccess) return static_cast<int>(err);
  batch_masked_band_kernel<false><<<grid, threads, shared,
                                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(in), static_cast<uint8_t*>(out),
      static_cast<int*>(flags) + 2 * static_cast<size_t>(g0) * batch,
      static_cast<const int*>(steps), static_cast<const int*>(heights),
      static_cast<const int*>(widths), g0, tb, batch, height, width, band_rows,
      nwc, strip);
  return static_cast<int>(cudaGetLastError());
}

// B2, column-cut form: as B1's over (batch, height, width) cells, the
// tiles over the canvas's rows and its ceil(width / 32) words of bits a
// row (band_cols of them a tile).
int gol_batch_masked_wide(const void* in, void* out, void* flags,
                          const void* steps, const void* heights,
                          const void* widths, int g0, int tb, int batch,
                          int height, int width, int band_rows, int band_cols,
                          int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  unsigned grid = 0;
  int threads = 0, strip = 0;
  size_t shared = 0;
  err = band_launch(batch_masked_band_kernel<true>, kMaskedBandThreads, device,
                    tb, batch, height, (width + 31) / 32, band_rows, band_cols,
                    true, grid, threads, shared, strip);
  if (err != cudaSuccess) return static_cast<int>(err);
  batch_masked_band_kernel<true><<<grid, threads, shared,
                                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(in), static_cast<uint8_t*>(out),
      static_cast<int*>(flags), static_cast<const int*>(steps),
      static_cast<const int*>(heights), static_cast<const int*>(widths), g0, tb,
      batch, height, width, band_rows, band_cols, strip);
  return static_cast<int>(cudaGetLastError());
}

const char* gol_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
