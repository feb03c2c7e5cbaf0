// Packed Game-of-Life stencil kernels for Hopper (sm_90a).
//
// Cells are packed 32 to a word along the width: bit j of word w is the
// cell at column 32*w + j, stored row-major as an (height, nwords) array.
// Torch carries the words as int32; these kernels read the same storage as
// uint32_t. Every kernel evolves B3/S23 on the torus through the carry-save
// adder network of gol_tpu_torch/ops/packed_math.py (row_sums once per row,
// combine re-ranks the planes; ~28 two-input bitwise ops per word per
// generation, ~12 instructions once ptxas fuses them into 3-input LOP3s
// and funnel shifts).
//
// Which TPU kernel each replaces (all in gol_tpu/ops/stencil_packed.py):
//
//   bandt_kernel<SUMMARY>  K1  _bandt_fast_kernel (via _step_t_fast):
//       8 generations per pass, pass summary (in_alive, out_alive, simT,
//       sim1), stored here as (in_alive, out_alive, !simT, !sim1).
//   bandt_kernel<EXACT>    K2  _bandt_kernel (via _step_t): the same pass
//       with exact per-generation flags, alive[0..7] and !similar[8..15].
//   band_kernel            K3  _band_kernel (via _step): one generation
//       with fused (alive, !similar).
//   bandt_kernel<NONE>     K14 _bandt_noflags_kernel (tools/roofline_r4.py,
//       via _step_t_noflags): K2 with every flag operation compiled out,
//       words out only. A measurement kernel for the flag-cost roofline
//       (gol_tpu_torch/tools/roofline.py); no engine path launches it.
//
// and, for one shard of a device mesh, fed ghosts by the halo exchange
// (gol_tpu_torch/parallel/halo.py) instead of wrapping within itself:
//
//   bandt_kernel<SUMMARY, ghost rows>  K7  _bandtrow_fast_kernel (via
//       _step_trow_fast): K1 on a full-width shard of an R x 1 mesh; the 8
//       rows above and below come from the ghost blocks gtop/gbot.
//   bandt_kernel<EXACT, ghost rows>    K8  _bandtrow_kernel (via
//       _step_trow): K2 on the same shard, the replay target of K7.
//   dist_band_kernel       K5  _dist_band_kernel (via _dist_step_pallas):
//       K3 on any shard, from one ghost row above and below and the
//       (h+2) east/west carry words.
//   bandt_kernel<SUMMARY, ghost plane>  K9 + K10  _stript_fast_kernel (via
//       _step_strip_fast) and _bandtrow_stitch_fast_kernel (via
//       _step_trow_stitch_fast), composed by _step_tsplit_fast: K1 on a
//       shard of a mesh with columns; besides gtop/gbot the neighbours'
//       whole edge word columns gwest/geast over rows -8..h+7 feed it, and
//       its summary covers all of the shard's cells.
//   bandt_kernel<EXACT, ghost plane>    K11 + K12  _stript_kernel (via
//       _step_strip) and _bandtrow_stitch_kernel (via _step_trow_stitch),
//       composed by _step_tsplit; and K13 _bandtg_kernel (via _step_tgb):
//       K2 on the same shard, the replay target of the summary form.
//
// Why one kernel replaces five. As functions K9-K13 are one: (words, gtop,
// gbot, gwest, geast) -> (words after 8 generations, flags). The TPU splits
// it because a vector op there covers a 128-lane tile, so a 2-lane ghost
// plane costs a full tile per row (K13), and the split form evolves the
// six seam-relevant word columns in a separate lane-folded strip (K9/K11)
// and stitches them into a rows-only main pass (K10/K12). This kernel's
// strip already carries one ghost word per side, so the ghost plane is only
// another source for those two lanes: no strip, no fold, no stitch, no
// edge masks, and any nwords >= 1.
//
// Flags. The Pallas kernels accumulate their flags over a sequential band
// grid; CUDA blocks run concurrently and in no order. So every flag is an
// OR into an int32 word that the caller zeroes before the launch, and the
// AND-type flags (similar) are stored negated ("differs"): one zero_()
// resets a whole flag buffer. K3/K5 reduce a block's predicate with
// __syncthreads_or; bandt_kernel ORs the owned words of each flag into a
// register as it goes and reduces them once per warp at the end
// (__reduce_or_sync). One lane then ORs the flag in, reading the word
// first so that later warps and blocks rarely issue the atomic at all.
//
// What bounds them. K3 and K5 move one word in and one out per word of the
// grid and do ~28 logic ops on it: bytes bound them (2 x 4 bytes per word
// over 3.35 TB/s). bandt_kernel moves the same bytes per pass but does 8
// generations of the network on them, so its logic ops set its bound: the
// 32-bit integer pipe's 64 results per clock per SM.
//
// bandt_kernel's design. One warp evolves a band of rows of a strip of 30
// words: lane i holds word w0 - 1 + i of each row, so lanes 0 and 31 are
// the strip's ghost words and a lane's west and east words are a shuffle
// away. The warp walks down the band's window (8 ghost rows, its rows, 8
// ghost rows), loading one row of generation 0 per step with one 128-byte
// coalesced load, and pushes it through 8 generation levels held in
// registers. Level t keeps the row sums of the two rows above the row it
// will push next (its window of generation t - 1), so one push computes
// the new row's sums once (2 shuffles, 2 funnel shifts, 4 LOP3) and the
// rule once (6 LOP3, next_gen), and emits the next generation of the row
// above it. Each level consumes what the level below emitted at the
// previous step (level t emits window row k - 2t + 1 at step k), so the 8
// pushes of a step are independent of each other. Per word and generation
// that is ~12 logic instructions and 2 shuffles, against ~50 two-input ops
// and 9 shared loads for the former shared-memory tile (which recomputed
// every row's sums for each of its three neighbours). The first 21 steps
// (the pipeline's fill: level t starts at step 3t - 3) and the last 7 (its
// drain) run only the levels with rows to push, so a band of `own` rows
// costs 8 own + 72 pushes. No index math runs per word: a lane's column,
// load pointer and store pointer are set once; the torus wraps its load
// pointer with a compare per row; the ownership tests run only in the
// steps where some level emits a row outside the band. No shared memory,
// no barrier: warps share nothing.
//
// The launch sizes the bands: each strip's rows are split into equal bands,
// as many as the card's resident warps hold at once (one wave, read from
// the occupancy API once per device), of at least kMinBandRows rows. At
// 16384^2 on an H100 that is 18 strips x 88 bands of 187 rows, a
// row overfetch of (187 + 9) / 187 and a column overfetch of 540 / 512.
//
// Why the window is exact for 8 generations:
//   * Rows. Eight ghost rows per side: the rows beyond the window are never
//     loaded (a level's first and last rows have no neighbour there), so
//     the outermost rows are wrong after one generation and the wrong band
//     grows one row per generation; after 8 it has reached the ghost rows'
//     inner edge and no further (stencil_packed.py:441-449). The pipeline
//     emits only the rows it can: generation t covers window rows t..R-1-t.
//   * Columns. One ghost word per side: lanes 0 and 31 see their own word as
//     their outer neighbour (the shuffle's edge), a wrong neighbour that
//     enters a ghost word at its far bit and moves one bit per generation,
//     so the ghost bit next to the interior stays exact for 31 generations
//     (_evolve_with_ghost_plane, stencil_packed.py:316-348).
//   * Small grids. Window rows and lane words map to the grid modulo its
//     height and nwords, and a lane's west neighbour is the lane to its left:
//     the window lies on the torus's universal cover, so heights below 16
//     and nwords of 1 or 2 come out right. Flags and stores read only the
//     words a warp owns (lanes 1..30 of words below nwords, rows of its
//     band), never a halo copy or a word past the grid's edge.
//   * Shards (K7/K8). A window row outside the shard's [0, h) is read from
//     gtop (rows -8..-1) or gbot (rows h..h+7), never modulo the shard, and
//     rows past h+8 are zero: they feed only rows no warp owns. So the
//     universal-cover trick above is for the torus alone, and a shard
//     needs h >= 8 (its neighbours' ghost blocks are 8 of its rows). The
//     shard is full-width, so columns keep the torus wrap.
//   * Shards with mesh columns (K9-K13). Rows as for K7/K8. Columns never
//     wrap: the lane at shard column -1 reads gwest[e] and at column nwords
//     geast[e], with e = row + 8 over rows -8..h+7, so the ghost rows'
//     corner words ride in the plane (they are the diagonal neighbours'
//     cells: the column exchange runs over the row-extended range). Lanes
//     further out read zero, which is the "wrong neighbour" of the ghost
//     word above: it cannot reach the shard in 8 generations. nwords may be
//     1 (columns -1, 0, 1 are gwest, the word, geast).
//
// As built (nvcc -Xptxas -v, sm_90a, CUDA 12.8; the steady loop's SASS
// counted by gol_tpu_torch/tools/sass_ops.py), per word and generation:
// 2 shuffles, 0 shared loads, and logic instructions (LOP3, SHF, PLOP3)
// K14 13.1, K1 13.6, K7 and K9+K10 13.6, K2 15.1, K8 and K11-K13 15.4-15.5
// (the exact forms' two ORs per generation); 19.9-29.1 instructions in all.
// Of the logic, 12 are the network's (push's 2 SHF and 4 LOP3, next_gen's
// 6 LOP3): the operations bound counts those (roofline.OPS_PER_WORD_GEN),
// and the rest is the loop's overhead.
// Registers: K1 140, K14 133, K7 144, K9+K10 150, no spills; K2, K8 and
// K11-K13 128 (capped, see bandt_kernel) with 48-64 bytes of stack and
// 204-316 bytes of spill stores. No shared memory. K3 and K5 use 30 and 32
// registers, no spills.

#include <cstddef>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kGens = 8;  // TEMPORAL_GENS
constexpr int kThreads = 256;  // K3, K5

__device__ __forceinline__ void row_sums(uint32_t x, uint32_t left,
                                         uint32_t right, uint32_t& m0,
                                         uint32_t& m1, uint32_t& s0,
                                         uint32_t& s1) {
  const uint32_t w = (x << 1) | (left >> 31);
  const uint32_t e = (x >> 1) | (right << 31);
  m0 = w ^ e;
  m1 = w & e;
  s0 = m0 ^ x;
  s1 = m1 | (x & m0);
}

__device__ __forceinline__ uint32_t combine(uint32_t u0, uint32_t u1,
                                            uint32_t d0, uint32_t d1,
                                            uint32_t m0, uint32_t m1,
                                            uint32_t mid) {
  const uint32_t ud0 = u0 ^ d0;
  const uint32_t t0 = ud0 ^ m0;
  const uint32_t tc = (u0 & d0) | (m0 & ud0);
  const uint32_t ud1 = u1 ^ d1;
  const uint32_t v0 = ud1 ^ m1;
  const uint32_t v1 = (u1 & d1) | (m1 & ud1);
  const uint32_t b1 = v0 ^ tc;
  const uint32_t over = v1 | (v0 & tc);
  return b1 & ~over & (t0 | mid);
}

// One generation of the word x from its 3x3 word neighbourhood (rows up,
// mid, down; columns left, centre, right).
__device__ __forceinline__ uint32_t evolve_word(
    uint32_t ul, uint32_t uc, uint32_t ur, uint32_t ml, uint32_t x,
    uint32_t mr, uint32_t dl, uint32_t dc, uint32_t dr) {
  uint32_t um0, um1, u0, u1, m0, m1, s0, s1, dm0, dm1, d0, d1;
  row_sums(uc, ul, ur, um0, um1, u0, u1);
  row_sums(x, ml, mr, m0, m1, s0, s1);
  row_sums(dc, dl, dr, dm0, dm1, d0, d1);
  return combine(u0, u1, d0, d1, m0, m1, x);
}

// OR a block-wide predicate into *flag. Every thread of the block calls it
// (it is a barrier).
__device__ __forceinline__ void block_or(int pred, int* flag) {
  if (__syncthreads_or(pred) && threadIdx.x == 0) {
    if (*reinterpret_cast<volatile int*>(flag) == 0) atomicOr(flag, 1);
  }
}

// K3: one generation, one thread per word, modular 3x3 neighbourhood read
// straight from device memory. flags[0] |= alive, flags[1] |= differs.
__global__ void __launch_bounds__(kThreads)
band_kernel(const uint32_t* __restrict__ in, uint32_t* __restrict__ out,
            int* __restrict__ flags, int height, int nwords) {
  const long long i =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  int alive = 0, differs = 0;
  if (i < static_cast<long long>(height) * nwords) {
    const int r = static_cast<int>(i / nwords);
    const int w = static_cast<int>(i % nwords);
    const int wl = (w == 0) ? nwords - 1 : w - 1;
    const int wr = (w == nwords - 1) ? 0 : w + 1;
    const int ru = (r == 0) ? height - 1 : r - 1;
    const int rd = (r == height - 1) ? 0 : r + 1;
    const uint32_t* up = in + static_cast<size_t>(ru) * nwords;
    const uint32_t* mid = in + static_cast<size_t>(r) * nwords;
    const uint32_t* dn = in + static_cast<size_t>(rd) * nwords;
    const uint32_t x = mid[w];
    const uint32_t nv = evolve_word(up[wl], up[w], up[wr], mid[wl], x,
                                    mid[wr], dn[wl], dn[w], dn[wr]);
    out[i] = nv;
    alive = nv != 0;
    differs = nv != x;
  }
  block_or(alive, flags);
  block_or(differs, flags + 1);
}

// K5: K3 for one mesh shard. Row -1 is `top` and row h is `bot`; in
// extended row e (e = r + 1 for rows r = -1..h) the word west of column 0
// is gwest[e], of which only bit 31 is read, and the word east of the last
// column is geast[e], of which only bit 0 is read (row_sums shifts the rest
// out). Any height >= 1 and nwords >= 1.
__global__ void __launch_bounds__(kThreads)
dist_band_kernel(const uint32_t* __restrict__ in,
                 const uint32_t* __restrict__ top,
                 const uint32_t* __restrict__ bot,
                 const uint32_t* __restrict__ gwest,
                 const uint32_t* __restrict__ geast,
                 uint32_t* __restrict__ out, int* __restrict__ flags,
                 int height, int nwords) {
  const long long i =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  int alive = 0, differs = 0;
  if (i < static_cast<long long>(height) * nwords) {
    const int r = static_cast<int>(i / nwords);
    const int w = static_cast<int>(i % nwords);
    const uint32_t* rows[3] = {
        r == 0 ? top : in + static_cast<size_t>(r - 1) * nwords,
        in + static_cast<size_t>(r) * nwords,
        r == height - 1 ? bot : in + static_cast<size_t>(r + 1) * nwords};
    uint32_t l[3], c[3], e[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      c[k] = rows[k][w];
      l[k] = w == 0 ? gwest[r + k] : rows[k][w - 1];
      e[k] = w == nwords - 1 ? geast[r + k] : rows[k][w + 1];
    }
    const uint32_t nv =
        evolve_word(l[0], c[0], e[0], l[1], c[1], e[1], l[2], c[2], e[2]);
    out[i] = nv;
    alive = nv != 0;
    differs = nv != c[1];
  }
  block_or(alive, flags);
  block_or(differs, flags + 1);
}

// Which flags a bandt_kernel pass computes.
enum FlagMode {
  kSummary = 0,  // K1/K7/K9+K10: (in_alive, out_alive, !simT, !sim1)
  kExact = 1,    // K2/K8/K11-K13: alive[0..7], !similar[8..15]
  kNone = 2      // K14: none; the pass writes its words and nothing else
};

// Where a strip's cells come from.
enum Source {
  kTorus = 0,      // the grid itself, rows and columns modulo its shape
  kGhostRows = 1,  // a full-width shard: rows from gtop/gbot, columns wrap
  kGhostPlane = 2  // a shard with mesh columns: rows from gtop/gbot,
                   // columns -1 and nwords from gwest/geast
};

constexpr int kWarp = 32;
constexpr unsigned kFullMask = 0xffffffffu;
constexpr int kStripWords = kWarp - 2;  // interior words of a warp's strip
constexpr int kMinBandRows = 32;        // the least rows of a warp's band
constexpr int kBandtWarps = 4;          // warps per block
constexpr int kMaxDevices = 64;         // resident_warps' cache
// The pipeline's fill: level t takes its first valid row at step 3t - 3,
// so from step kFill on every level runs. Its drain: after the strip's
// last row (step R - 1) level t has rows to emit until step R + t - 2.
constexpr int kFill = 3 * kGens - 3;
constexpr int kDrain = kGens - 1;
// Level t emits, at step k, row k - 2t + 1 of the strip's window (rows
// r0 - 8 .. r0 + own + 7): the steps at which every level emits an owned
// row start here.
constexpr int kSteady = 3 * kGens - 1;

// One generation of the pipeline: the window of its input generation
// around the row it emits next, as row sums.
struct Level {
  uint32_t u0, u1;  // the row above the centre: bits 0, 1 of its 3-cell sums
  uint32_t s0, s1;  // the centre row's 3-cell sums (the next row above)
  uint32_t m0, m1;  // the centre row's 2-cell sums (west + east)
  uint32_t x;       // the centre row
  uint32_t out;     // what this level emitted at the last step
};

// combine() with its last two steps folded into what ptxas issues as two
// 3-input LOP3s: where v0 ^ tc is set, v0 & tc is not, so b1 & ~over =
// (v0 ^ tc) & ~v1. (combine() compiles to two more.)
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

// Push the row d below the centre row: returns the centre row's next
// generation and moves the window down one row. The lane's west and east
// words come from the neighbouring lanes; lanes 0 and 31 get their own
// word back, which is the ghost words' "wrong neighbour".
__device__ __forceinline__ uint32_t push(Level& v, uint32_t d) {
  const uint32_t west = __shfl_up_sync(kFullMask, d, 1);
  const uint32_t east = __shfl_down_sync(kFullMask, d, 1);
  const uint32_t w = __funnelshift_l(west, d, 1);  // (d << 1) | (west >> 31)
  const uint32_t e = __funnelshift_r(d, east, 1);  // (d >> 1) | (east << 31)
  const uint32_t dm0 = w ^ e, dm1 = w & e;
  const uint32_t d0 = dm0 ^ d, d1 = dm1 | (d & dm0);
  const uint32_t nv = next_gen(v.u0, v.u1, d0, d1, v.m0, v.m1, v.x);
  v.u0 = v.s0;
  v.u1 = v.s1;
  v.s0 = d0;
  v.s1 = d1;
  v.m0 = dm0;
  v.m1 = dm1;
  v.x = d;
  return nv;
}

// One warp's band of a strip: own x kStripWords owned words, lane i holding
// word w0 - 1 + i of every row. Each step loads one row of generation 0
// and pushes it through the kGens levels, deepest first, so that the
// levels of a step depend only on the previous step and run side by side.
template <FlagMode FLAGS, Source SRC>
struct Strip {
  const uint32_t* __restrict__ in;
  const uint32_t* __restrict__ gtop;
  const uint32_t* __restrict__ gbot;
  const uint32_t* __restrict__ gwest;
  const uint32_t* __restrict__ geast;
  int height, nwords;
  int r0;        // the strip's first owned row
  int own;       // its owned rows
  int col;       // this lane's word (modulo nwords, except kGhostPlane)
  bool store;    // this lane owns its word
  int row;       // the next row to load (kTorus: modulo height)
  const uint32_t* src;  // kTorus: this lane's word of that row
  size_t wrap;          // kTorus: height * nwords
  uint32_t* dst;        // this lane's word of the next row to store
  Level lv[kGens];
  uint32_t alive[kGens], differs[kGens];  // flag words of owned rows

  // The lane's word of the next row of generation 0.
  __device__ __forceinline__ uint32_t fetch() {
    uint32_t v = 0;
    if (SRC == kTorus) {
      v = __ldg(src);
      src += nwords;
      if (++row == height) {
        row = 0;
        src -= wrap;
      }
      return v;
    }
    const int g = row++;
    const uint32_t* line = g < 0 ? gtop + static_cast<size_t>(g + kGens) * nwords
                           : g < height ? in + static_cast<size_t>(g) * nwords
                           : g < height + kGens
                               ? gbot + static_cast<size_t>(g - height) * nwords
                               : nullptr;
    if (line != nullptr) {
      if (SRC == kGhostRows || (col >= 0 && col < nwords)) {
        v = __ldg(line + col);
      } else if (col == -1) {
        v = __ldg(gwest + g + kGens);
      } else if (col == nwords) {
        v = __ldg(geast + g + kGens);
      }  // columns past geast are zero
    }
    return v;
  }

  // Step k with levels FIRST..LAST; CHECK tests per level whether the row
  // it emits is owned (without it, every level's is).
  template <int FIRST, int LAST, bool CHECK>
  __device__ __forceinline__ void step(int k, uint32_t x0) {
#pragma unroll
    for (int t = LAST; t >= FIRST; --t) {
      Level& v = lv[t - 1];
      const uint32_t x = v.x;
      const uint32_t nv = push(v, t == 1 ? x0 : lv[t >= 2 ? t - 2 : 0].out);
      v.out = nv;
      const int j = k - 2 * t + 1 - kGens;  // the emitted row, from r0
      const bool owned = !CHECK || (j >= 0 && j < own);
      if (FLAGS == kExact || (FLAGS == kSummary && (t == 1 || t == kGens))) {
        if (owned) {
          alive[t - 1] |= t == 1 && FLAGS == kSummary ? x : nv;
          differs[t - 1] |= nv ^ x;
        }
      }
      if (t == kGens && owned) {  // row r0 + j
        if (store) *dst = nv;
        dst += nwords;
      }
    }
  }

  template <int K>
  __device__ __forceinline__ void fill(uint32_t& cur) {
    if constexpr (K < kFill) {
      const uint32_t next = fetch();
      step<1, ((K + 3) / 3 < kGens ? (K + 3) / 3 : kGens), true>(K, cur);
      cur = next;
      fill<K + 1>(cur);
    }
  }

  template <int E>
  __device__ __forceinline__ void drain(int rows) {
    if constexpr (E < kDrain) {
      step<E + 2, kGens, true>(rows + E, 0);
      drain<E + 1>(rows);
    }
  }

  // OR a flag word of the warp's owned words into *flag.
  __device__ __forceinline__ void or_flag(uint32_t acc, int* flag) const {
    if (__reduce_or_sync(kFullMask, store ? acc : 0u) &&
        threadIdx.x % kWarp == 0) {
      if (*reinterpret_cast<volatile int*>(flag) == 0) atomicOr(flag, 1);
    }
  }

  __device__ __forceinline__ void run(int* flags) {
    for (int t = 0; t < kGens; ++t) {
      lv[t] = Level{0, 0, 0, 0, 0, 0, 0, 0};
      alive[t] = differs[t] = 0;
    }
    // Window rows 0 .. rows - 1 (rows >= kFill, so the fill never runs
    // past them; rows past own + 16 are loaded but never owned).
    const int rows = max(own + 2 * kGens, kFill);
    uint32_t cur = fetch();
    fill<0>(cur);
    // Steps lo .. hi - 1 emit owned rows at every level (own + 9 < rows).
    const int lo = min(kSteady, rows);
    const int hi = max(lo, own + kGens + 1);
    int k = kFill;
    for (; k < lo; ++k) {
      const uint32_t next = fetch();
      step<1, kGens, true>(k, cur);
      cur = next;
    }
#pragma unroll 2
    for (; k < hi; ++k) {
      const uint32_t next = fetch();
      step<1, kGens, false>(k, cur);
      cur = next;
    }
    for (; k < rows; ++k) {
      const uint32_t next = fetch();
      step<1, kGens, true>(k, cur);
      cur = next;
    }
    drain<0>(rows);
    if (FLAGS == kExact) {
#pragma unroll
      for (int t = 0; t < kGens; ++t) {
        or_flag(alive[t], flags + t);
        or_flag(differs[t], flags + kGens + t);
      }
    } else if (FLAGS == kSummary) {
      or_flag(alive[0], flags + 0);
      or_flag(alive[kGens - 1], flags + 1);
      or_flag(differs[kGens - 1], flags + 2);
      or_flag(differs[0], flags + 3);
    }
  }
};

// K1 (FLAGS = kSummary) / K2 (kExact) / K14 (kNone) on the torus (SRC =
// kTorus), K7 / K8 on a full-width mesh shard (kGhostRows), K9+K10 /
// K11+K12+K13 on a shard with mesh columns (kGhostPlane): kGens
// generations of one band (`band` rows of a kStripWords strip) per warp,
// from its (band + 16) x 32-word window, in registers. The exact forms ask
// ptxas for 4 blocks per SM: their 16 flag words would otherwise push them
// past 128 registers.
template <FlagMode FLAGS, Source SRC>
__global__ void __launch_bounds__(kBandtWarps* kWarp, FLAGS == kExact ? 4 : 1)
bandt_kernel(const uint32_t* __restrict__ in, const uint32_t* __restrict__ gtop,
             const uint32_t* __restrict__ gbot,
             const uint32_t* __restrict__ gwest,
             const uint32_t* __restrict__ geast, uint32_t* __restrict__ out,
             int* __restrict__ flags, int height, int nwords, int band,
             int nstrips, int ntasks) {
  const int task = blockIdx.x * kBandtWarps + threadIdx.x / kWarp;
  if (task >= ntasks) return;  // the whole warp
  const int lane = threadIdx.x % kWarp;
  Strip<FLAGS, SRC> s;
  s.in = in;
  s.gtop = gtop;
  s.gbot = gbot;
  s.gwest = gwest;
  s.geast = geast;
  s.height = height;
  s.nwords = nwords;
  s.r0 = task / nstrips * band;
  s.own = min(band, height - s.r0);
  const int w = task % nstrips * kStripWords - 1 + lane;  // >= -1
  s.store = lane >= 1 && lane <= kStripWords && w < nwords;
  s.col = SRC == kGhostPlane ? w : (w + nwords) % nwords;
  s.row = SRC == kTorus ? ((s.r0 - kGens) % height + height) % height
                        : s.r0 - kGens;
  s.src = SRC == kTorus ? in + static_cast<size_t>(s.row) * nwords + s.col : in;
  s.wrap = static_cast<size_t>(height) * nwords;
  s.dst = out + static_cast<size_t>(s.r0) * nwords + (s.store ? s.col : 0);
  s.run(flags);
}

unsigned word_blocks(int height, int nwords) {
  const long long words = static_cast<long long>(height) * nwords;
  return static_cast<unsigned>((words + kThreads - 1) / kThreads);
}

// The warps of bandt_kernel<FLAGS, SRC> that `device` holds at once: its
// SMs x blocks per SM x warps per block, read once per device.
template <FlagMode FLAGS, Source SRC>
cudaError_t resident_warps(int device, int* warps) {
  static int cache[kMaxDevices];
  if (device >= 0 && device < kMaxDevices && cache[device] > 0) {
    *warps = cache[device];
    return cudaSuccess;
  }
  int sms = 0, blocks = 0;
  cudaError_t err =
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, bandt_kernel<FLAGS, SRC>, kBandtWarps * kWarp, 0);
  }
  if (err != cudaSuccess) return err;
  *warps = max(1, sms * blocks * kBandtWarps);
  if (device >= 0 && device < kMaxDevices) cache[device] = *warps;
  return cudaSuccess;
}

// The rows of a band: each strip's rows split into equal bands, as many as
// the card's resident warps hold in one wave (every warp runs one band, so
// one wave of bands is the fewest steps), but none under kMinBandRows rows
// unless the grid is shorter.
int band_rows(int height, int nstrips, int warps) {
  const int most = max(1, height / kMinBandRows);
  const int bands = max(1, min(most, warps / nstrips));
  return (height + bands - 1) / bands;
}

template <FlagMode FLAGS, Source SRC>
int launch_bandt(const void* in, const void* gtop, const void* gbot,
                 const void* gwest, const void* geast, void* out, void* flags,
                 int height, int nwords, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  int warps = 0;
  if (err == cudaSuccess) err = resident_warps<FLAGS, SRC>(device, &warps);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int nstrips = (nwords + kStripWords - 1) / kStripWords;
  const int band = band_rows(height, nstrips, warps);
  const int ntasks = nstrips * ((height + band - 1) / band);
  const unsigned blocks = (ntasks + kBandtWarps - 1) / kBandtWarps;
  bandt_kernel<FLAGS, SRC><<<blocks, kBandtWarps * kWarp, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(in), static_cast<const uint32_t*>(gtop),
      static_cast<const uint32_t*>(gbot), static_cast<const uint32_t*>(gwest),
      static_cast<const uint32_t*>(geast), static_cast<uint32_t*>(out),
      static_cast<int*>(flags), height, nwords, band, nstrips, ntasks);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Each entry launches on `stream` (a cudaStream_t of `device`), does not
// synchronise and allocates nothing; it returns cudaGetLastError() after
// the launch (0 = cudaSuccess).

int gol_band_step(const void* in, void* out, void* flags, int height,
                  int nwords, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  band_kernel<<<word_blocks(height, nwords), kThreads, 0,
                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(in), static_cast<uint32_t*>(out),
      static_cast<int*>(flags), height, nwords);
  return static_cast<int>(cudaGetLastError());
}

int gol_bandt_pass(const void* in, void* out, void* flags, int height,
                   int nwords, int exact, int device, void* stream) {
  auto launch = exact ? launch_bandt<kExact, kTorus>
                      : launch_bandt<kSummary, kTorus>;
  return launch(in, nullptr, nullptr, nullptr, nullptr, out, flags, height,
                nwords, device, stream);
}

// K14: the torus pass with no flags (no flag buffer).
int gol_bandt_noflags_pass(const void* in, void* out, int height, int nwords,
                           int device, void* stream) {
  return launch_bandt<kNone, kTorus>(in, nullptr, nullptr, nullptr, nullptr,
                                     out, nullptr, height, nwords, device,
                                     stream);
}

// K5. top/bot: (1, nwords) ghost rows; gwest/geast: (height + 2) carry words.
int gol_dist_band_step(const void* in, const void* top, const void* bot,
                       const void* gwest, const void* geast, void* out,
                       void* flags, int height, int nwords, int device,
                       void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  dist_band_kernel<<<word_blocks(height, nwords), kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(in), static_cast<const uint32_t*>(top),
      static_cast<const uint32_t*>(bot), static_cast<const uint32_t*>(gwest),
      static_cast<const uint32_t*>(geast), static_cast<uint32_t*>(out),
      static_cast<int*>(flags), height, nwords);
  return static_cast<int>(cudaGetLastError());
}

// K7 (exact = 0) / K8 (exact = 1). gtop/gbot: (8, nwords) ghost row blocks;
// height >= 8.
int gol_bandtrow_pass(const void* in, const void* gtop, const void* gbot,
                      void* out, void* flags, int height, int nwords,
                      int exact, int device, void* stream) {
  auto launch = exact ? launch_bandt<kExact, kGhostRows>
                      : launch_bandt<kSummary, kGhostRows>;
  return launch(in, gtop, gbot, nullptr, nullptr, out, flags, height, nwords,
                device, stream);
}

// K9+K10 (exact = 0) / K11+K12+K13 (exact = 1). gtop/gbot as for K7/K8;
// gwest/geast: the (height + 16) ghost word columns over rows -8..h+7;
// height >= 8, nwords >= 1.
int gol_bandtg_pass(const void* in, const void* gtop, const void* gbot,
                    const void* gwest, const void* geast, void* out,
                    void* flags, int height, int nwords, int exact, int device,
                    void* stream) {
  auto launch = exact ? launch_bandt<kExact, kGhostPlane>
                      : launch_bandt<kSummary, kGhostPlane>;
  return launch(in, gtop, gbot, gwest, geast, out, flags, height, nwords,
                device, stream);
}

// The tile of bandt_kernel: the least rows of a warp's band (unless the
// grid has fewer), the interior words of its strip, and the ghost rows it
// loads above and below (one ghost word per side besides, in lanes 0 and
// 31). gol_bandt_bands gives a launch's band rows and bands per strip.
void gol_bandt_tile(int* rows, int* words, int* ghost_rows) {
  *rows = kMinBandRows;
  *words = kStripWords;
  *ghost_rows = kGens;
}

// The bands of a K1 launch over (height, nwords) words on `device`: the
// rows of each band and the bands per strip.
int gol_bandt_bands(int height, int nwords, int device, int* rows,
                    int* bands) {
  int warps = 0;
  cudaError_t err = cudaSetDevice(device);
  if (err == cudaSuccess) err = resident_warps<kSummary, kTorus>(device, &warps);
  if (err != cudaSuccess) return static_cast<int>(err);
  *rows = band_rows(height, (nwords + kStripWords - 1) / kStripWords, warps);
  *bands = (height + *rows - 1) / *rows;
  return 0;
}

const char* gol_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
