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
//   band_kernel<V, torus>  K3  _band_kernel (via _step): one generation
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
//   band_kernel<V, ghost plane>  K5  _dist_band_kernel (via
//       _dist_step_pallas): K3 on any shard, from one ghost row above and
//       below and the (h+2) east/west carry words (a ghost plane of depth
//       1).
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
// resets a whole flag buffer. Both kernels OR the owned words of each flag
// into a register as they go and reduce them once per warp at the end
// (__reduce_or_sync), with no block barrier. One lane then ORs the flag
// in, reading the word first so that later warps and blocks rarely issue
// the atomic at all.
//
// What bounds them. K3 and K5 move one word in and one out per word of the
// grid and do 12 logic instructions on it: bytes bound them (2 x 4 bytes
// per word over 3.35 TB/s). bandt_kernel moves the same bytes per pass but
// does 8 generations of the network on them, so its logic ops set its
// bound: the 32-bit integer pipe's 64 results per clock per SM.
//
// band_kernel's design (K3, K5). A stream, so what counts is that each
// word comes from DRAM once, that enough bytes are in flight to cover the
// memory's latency, and that no instruction per word goes to index math.
// One warp walks down a band of rows of a strip of 32 V words: lane i holds
// V adjacent words of each row, V = 4 (one 16-byte load and store per lane
// and row) where nwords % 4 == 0 and the rows are 16-byte aligned, V = 1
// for any other shape or slice. Per row a lane computes its words' row sums
// once (bandt_kernel's level 0 alone: the sums of the two rows above stay
// in registers) and emits the row above. The words west and east of its
// own come by shuffle; the lanes at the strip's edges load the word beyond
// it instead (the torus's wrap, or the shard's gwest/geast), so every lane
// owns and stores its words. Each lane keeps kAhead rows in flight, loaded
// before it pushes the row it has. A band is at least kBandMinRows rows,
// and as many bands run as one wave of warps holds; its two extra rows are
// its neighbours' and come from L2. Lane and band offsets are set once per
// warp: no division per word.
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
// 204-316 bytes of spill stores. No shared memory. band_kernel: 72
// registers with V = 4 (K3 and K5), 42 (K3) and 40 (K5) with V = 1, no
// spills, no stack. On an H100 (700 W) K3 takes 0.0285 ms at 16384 x 512
// words, 0.70 of its bytes bound, and K5 0.0101 ms per shard over the ring
// of a 4x1 mesh's four 4096 x 512 shards, 0.50 of it; torch's copy_ of the
// same words, which computes nothing, reaches 0.86 and 0.66 of the bound
// (PERF.md §6). The two extra rows of a band and the strip edges' loads
// come from L2; kAhead > 1 (rows loaded further ahead) raises registers to
// 84-101 and wins back no more than it loses in resident warps.

#include <cstddef>
#include <cstdint>
#include <initializer_list>

#include <cuda_runtime.h>

namespace {

constexpr int kGens = 8;  // TEMPORAL_GENS

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

// The rule from the 3-cell sums of the rows above (u) and below (d), the
// centre row's 2-cell sums (m) and the centre row: packed_math's combine
// with its last two steps folded into what ptxas issues as two 3-input
// LOP3s (where v0 ^ tc is set, v0 & tc is not, so b1 & ~over =
// (v0 ^ tc) & ~v1).
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

// Push the row d below the centre row, given the words west and east of
// d: computes d's row sums once, returns the centre row's next generation
// and moves the window down one row.
__device__ __forceinline__ uint32_t push_row(Level& v, uint32_t d,
                                             uint32_t west, uint32_t east) {
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

// push_row with the west and east words from the neighbouring lanes; lanes
// 0 and 31 get their own word back, which is the ghost words' "wrong
// neighbour".
__device__ __forceinline__ uint32_t push(Level& v, uint32_t d) {
  return push_row(v, d, __shfl_up_sync(kFullMask, d, 1),
                  __shfl_down_sync(kFullMask, d, 1));
}

// OR a flag word into *flag: one warp-wide reduction of the words the lane
// owns, then lane 0 reads the flag and issues the atomic only if it is
// still clear. Every lane of the warp calls it.
__device__ __forceinline__ void or_flag(bool owned, uint32_t acc, int* flag) {
  if (__reduce_or_sync(kFullMask, owned ? acc : 0u) &&
      threadIdx.x % kWarp == 0) {
    if (*reinterpret_cast<volatile int*>(flag) == 0) atomicOr(flag, 1);
  }
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
        or_flag(store, alive[t], flags + t);
        or_flag(store, differs[t], flags + kGens + t);
      }
    } else if (FLAGS == kSummary) {
      or_flag(store, alive[0], flags + 0);
      or_flag(store, alive[kGens - 1], flags + 1);
      or_flag(store, differs[kGens - 1], flags + 2);
      or_flag(store, differs[0], flags + 3);
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

// One generation, K3 (SRC = kTorus) and K5 (kGhostPlane, depth 1): a
// warp walks down a band of rows of a strip of kWarp * V words, lane i
// holding words w0 + V i .. w0 + V i + V - 1 of each row (V = 4: one
// 16-byte load per row; V = 1 for any nwords or alignment). Each row's
// sums are computed once, from its west and east words: the lanes' own
// neighbours by shuffle, and the words beyond the strip (or the torus's
// wrap, or the shard's ghost column) loaded by the edge lanes.
// The last three as tools/band_sweep.py found them on an H100 (PERF.md §6).
constexpr int kBandWarps = 4;      // warps per block
constexpr int kBandMinRows = 4;    // the least rows of a band
constexpr int kAhead = 1;          // rows a lane has in flight
constexpr int kBandMinBlocks = 1;  // blocks per SM ptxas must fit

// A lane's V words of one row, and the words west and east of them that
// the edge lanes load (0 elsewhere).
template <int V>
struct Row {
  uint32_t x[V];
  uint32_t west, east;
};

template <int V, Source SRC>
struct Band {
  const uint32_t* __restrict__ in;
  const uint32_t* __restrict__ top;    // kGhostPlane: row -1
  const uint32_t* __restrict__ bot;    // kGhostPlane: row height
  const uint32_t* __restrict__ gwest;  // kGhostPlane: column -1, rows -1..h
  const uint32_t* __restrict__ geast;  // kGhostPlane: column nwords
  int height, nwords;
  int col;                    // the lane's first word (0 past nwords)
  int wcol, ecol;             // the columns of its west and east words
  bool west_edge, east_edge;  // the lane loads them (else: shuffles)
  int row;                    // the next row to load (kTorus: modulo height)
  const uint32_t* line;       // kTorus: that row
  int pending;                // rows still to load
  Row<V> ahead[kAhead];       // rows loaded, not yet pushed: a ring

  __device__ __forceinline__ void fetch(Row<V>& d) {
    const uint32_t *p, *pw, *pe;
    if (SRC == kTorus) {
      p = line;
      line += nwords;
      if (++row == height) {
        row = 0;
        line = in;
      }
      pw = p + wcol;
      pe = p + ecol;
    } else {
      const int g = row++;  // -1 .. height
      p = g < 0 ? top : g < height ? in + static_cast<size_t>(g) * nwords : bot;
      pw = wcol < 0 ? gwest + g + 1 : p + wcol;
      pe = ecol == nwords ? geast + g + 1 : p + ecol;
    }
    if constexpr (V == 4) {
      const uint4 q = __ldg(reinterpret_cast<const uint4*>(p + col));
      d.x[0] = q.x;
      d.x[1] = q.y;
      d.x[2] = q.z;
      d.x[3] = q.w;
    } else {
      d.x[0] = __ldg(p + col);
    }
    d.west = west_edge ? __ldg(pw) : 0u;
    d.east = east_edge ? __ldg(pe) : 0u;
  }

  // The row in ring slot s, which is then refilled with the row kAhead
  // further on. Every caller's s is a constant once its loop is unrolled,
  // so the ring stays in registers and the rows in flight are never moved
  // between them (a move would wait for its load).
  __device__ __forceinline__ Row<V> take(int s) {
    const Row<V> d = ahead[s];
    if (pending > 0) {
      --pending;
      fetch(ahead[s]);
    }
    return d;
  }
};

// Push the lane's words of row d into its V windows: nv gets the centre
// row's next generation.
template <int V>
__device__ __forceinline__ void push_words(Level (&lv)[V], const Row<V>& d,
                                           bool west_edge, bool east_edge,
                                           uint32_t (&nv)[V]) {
  const uint32_t up = __shfl_up_sync(kFullMask, d.x[V - 1], 1);
  const uint32_t down = __shfl_down_sync(kFullMask, d.x[0], 1);
  const uint32_t west = west_edge ? d.west : up;
  const uint32_t east = east_edge ? d.east : down;
#pragma unroll
  for (int j = 0; j < V; ++j) {
    nv[j] = push_row(lv[j], d.x[j], j == 0 ? west : d.x[j - 1],
                     j == V - 1 ? east : d.x[j + 1]);
  }
}

// K3 / K5: one generation of `band` rows of a kWarp * V-word strip per
// warp. flags[0] |= alive, flags[1] |= differs. Any height >= 1; any
// nwords >= 1 for V = 1, a multiple of 4 with 16-byte aligned rows (in,
// out, top, bot) for V = 4.
template <int V, Source SRC>
__global__ void __launch_bounds__(kBandWarps* kWarp, kBandMinBlocks)
band_kernel(const uint32_t* __restrict__ in, const uint32_t* __restrict__ top,
            const uint32_t* __restrict__ bot,
            const uint32_t* __restrict__ gwest,
            const uint32_t* __restrict__ geast, uint32_t* __restrict__ out,
            int* __restrict__ flags, int height, int nwords, int band,
            int nstrips, int ntasks) {
  const int task = blockIdx.x * kBandWarps + threadIdx.x / kWarp;
  if (task >= ntasks) return;  // the whole warp
  const int lane = threadIdx.x % kWarp;
  const int r0 = task / nstrips * band;
  const int own = min(band, height - r0);
  const int w = (task % nstrips * kWarp + lane) * V;  // the lane's first word
  const bool live = w < nwords;  // then all V words are
  Band<V, SRC> b;
  b.in = in;
  b.top = top;
  b.bot = bot;
  b.gwest = gwest;
  b.geast = geast;
  b.height = height;
  b.nwords = nwords;
  b.col = live ? w : 0;
  b.west_edge = lane == 0;  // always live
  b.east_edge = live && (lane == kWarp - 1 || w + V == nwords);
  b.wcol = SRC == kTorus && w == 0 ? nwords - 1 : w - 1;
  b.ecol = SRC == kTorus && w + V == nwords ? 0 : w + V;
  b.row = SRC == kTorus ? ((r0 - 1) % height + height) % height : r0 - 1;
  b.line = SRC == kTorus ? in + static_cast<size_t>(b.row) * nwords : in;
  // Rows r0 - 1 .. r0 + own: row r0 - 1 + t goes through slot t % kAhead,
  // the first kAhead of them loaded now.
  b.pending = own + 2;
#pragma unroll
  for (int i = 0; i < kAhead; ++i) {
    if (b.pending > 0) {
      --b.pending;
      b.fetch(b.ahead[i]);
    }
  }
  Level lv[V] = {};
  uint32_t nv[V];
  push_words(lv, b.take(0), b.west_edge, b.east_edge, nv);
  push_words(lv, b.take(1 % kAhead), b.west_edge, b.east_edge, nv);
  uint32_t* dst = out + static_cast<size_t>(r0) * nwords + b.col;
  uint32_t alive = 0, differs = 0;
  // Row r0 + j comes out when row r0 + j + 1 (slot (j + 2) % kAhead) goes
  // in; kAhead rows per trip, so that each one's slot is a constant.
  for (int j = 0; j < own; j += kAhead) {
#pragma unroll
    for (int i = 0; i < kAhead; ++i) {
      if (j + i < own) {
        uint32_t x[V];
#pragma unroll
        for (int k = 0; k < V; ++k) x[k] = lv[k].x;
        push_words(lv, b.take((i + 2) % kAhead), b.west_edge,
                   b.east_edge, nv);
#pragma unroll
        for (int k = 0; k < V; ++k) {
          alive |= nv[k];
          differs |= nv[k] ^ x[k];
        }
        if (live) {
          if constexpr (V == 4) {
            *reinterpret_cast<uint4*>(dst) =
                make_uint4(nv[0], nv[1], nv[2], nv[3]);
          } else {
            *dst = nv[0];
          }
        }
        dst += nwords;
      }
    }
  }
  or_flag(live, alive, flags);
  or_flag(live, differs, flags + 1);
}

// The warps of `kernel` (blocks of `block_warps` warps) that `device`
// holds at once: its SMs x blocks per SM x warps per block, read once per
// device into `cache`.
template <class Kernel>
cudaError_t resident_warps(Kernel kernel, int block_warps, int device,
                           int* cache, int* warps) {
  if (device >= 0 && device < kMaxDevices && cache[device] > 0) {
    *warps = cache[device];
    return cudaSuccess;
  }
  int sms = 0, blocks = 0;
  cudaError_t err =
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, kernel, block_warps * kWarp, 0);
  }
  if (err != cudaSuccess) return err;
  *warps = max(1, sms * blocks * block_warps);
  if (device >= 0 && device < kMaxDevices) cache[device] = *warps;
  return cudaSuccess;
}

template <FlagMode FLAGS, Source SRC>
cudaError_t bandt_warps(int device, int* warps) {
  static int cache[kMaxDevices];
  return resident_warps(bandt_kernel<FLAGS, SRC>, kBandtWarps, device, cache,
                        warps);
}

// The rows of a band: each strip's rows split into equal bands, as many as
// the card's resident warps hold in one wave (every warp runs one band, so
// one wave of bands is the fewest steps), but none under min_rows rows
// unless the grid is shorter.
int band_rows(int height, int nstrips, int warps, int min_rows) {
  const int most = max(1, height / min_rows);
  const int bands = max(1, min(most, warps / nstrips));
  return (height + bands - 1) / bands;
}

template <FlagMode FLAGS, Source SRC>
int launch_bandt(const void* in, const void* gtop, const void* gbot,
                 const void* gwest, const void* geast, void* out, void* flags,
                 int height, int nwords, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  int warps = 0;
  if (err == cudaSuccess) err = bandt_warps<FLAGS, SRC>(device, &warps);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int nstrips = (nwords + kStripWords - 1) / kStripWords;
  const int band = band_rows(height, nstrips, warps, kMinBandRows);
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

template <int V, Source SRC>
int launch_band(const void* in, const void* top, const void* bot,
                const void* gwest, const void* geast, void* out, void* flags,
                int height, int nwords, int device, void* stream) {
  static int cache[kMaxDevices];
  cudaError_t err = cudaSetDevice(device);
  int warps = 0;
  if (err == cudaSuccess) {
    err = resident_warps(band_kernel<V, SRC>, kBandWarps, device, cache, &warps);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  const int nstrips = (nwords + kWarp * V - 1) / (kWarp * V);
  const int band = band_rows(height, nstrips, warps, kBandMinRows);
  const int ntasks = nstrips * ((height + band - 1) / band);
  const unsigned blocks = (ntasks + kBandWarps - 1) / kBandWarps;
  band_kernel<V, SRC><<<blocks, kBandWarps * kWarp, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(in), static_cast<const uint32_t*>(top),
      static_cast<const uint32_t*>(bot), static_cast<const uint32_t*>(gwest),
      static_cast<const uint32_t*>(geast), static_cast<uint32_t*>(out),
      static_cast<int*>(flags), height, nwords, band, nstrips, ntasks);
  return static_cast<int>(cudaGetLastError());
}

// The 16-byte form takes rows of whole uint4s: nwords % 4 == 0 and every
// row pointer 16-byte aligned.
bool whole_uint4s(int nwords, std::initializer_list<const void*> rows) {
  if (nwords % 4 != 0) return false;
  for (const void* p : rows) {
    if (reinterpret_cast<uintptr_t>(p) % 16 != 0) return false;
  }
  return true;
}

}  // namespace

extern "C" {

// Each entry launches on `stream` (a cudaStream_t of `device`), does not
// synchronise and allocates nothing; it returns cudaGetLastError() after
// the launch (0 = cudaSuccess).

// K3. Rows of whole uint4s take the 16-byte form.
int gol_band_step(const void* in, void* out, void* flags, int height,
                  int nwords, int device, void* stream) {
  auto launch = whole_uint4s(nwords, {in, out}) ? launch_band<4, kTorus>
                                                : launch_band<1, kTorus>;
  return launch(in, nullptr, nullptr, nullptr, nullptr, out, flags, height,
                nwords, device, stream);
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
  auto launch = whole_uint4s(nwords, {in, out, top, bot})
                    ? launch_band<4, kGhostPlane>
                    : launch_band<1, kGhostPlane>;
  return launch(in, top, bot, gwest, geast, out, flags, height, nwords,
                device, stream);
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
  if (err == cudaSuccess) err = bandt_warps<kSummary, kTorus>(device, &warps);
  if (err != cudaSuccess) return static_cast<int>(err);
  *rows = band_rows(height, (nwords + kStripWords - 1) / kStripWords, warps,
                    kMinBandRows);
  *bands = (height + *rows - 1) / *rows;
  return 0;
}

const char* gol_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
