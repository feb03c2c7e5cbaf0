// Packed Game-of-Life stencil kernels for Hopper (sm_90a).
//
// Cells are packed 32 to a word along the width: bit j of word w is the
// cell at column 32*w + j, stored row-major as an (height, nwords) array.
// Torch carries the words as int32; these kernels read the same storage as
// uint32_t. Every kernel evolves B3/S23 on the torus through the carry-save
// adder network of gol_tpu_torch/ops/packed_math.py (row_sums once per row,
// combine re-ranks the planes; ~28 bitwise ops per word per generation).
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
// tile already carries one ghost word per side in shared memory, so the
// ghost plane is only another source for those two tile columns: no strip,
// no fold, no stitch, no edge masks, and any nwords >= 1.
//
// Flags. The Pallas kernels accumulate their flags over a sequential band
// grid; CUDA blocks run concurrently and in no order. So every flag is an
// OR into an int32 word that the caller zeroes before the launch, and the
// AND-type flags (similar) are stored negated ("differs"): one zero_()
// resets a whole flag buffer. Each block reduces its predicate with
// __syncthreads_or and one thread ORs it in, reading the word first so that
// blocks after the first rarely issue the atomic at all.
//
// What bounds them. K3 moves one word in and one out per word of the grid
// and does ~28 logic ops on it: bytes bound it (2 x 4 bytes per word over
// 3.35 TB/s). K1/K2 move the same bytes per pass but do 8 generations of
// the network on them, so the logic ops set their bound. Their design keeps
// all 8 generations in shared memory: each block loads a (TH+16) x (TW+2)
// word tile once, evolves it 8 times, ping-ponging between two shared
// buffers, and writes its TH x TW interior once, so device memory sees one
// read and one write per pass instead of eight of each. The price is the
// halo: (TH+16)(TW+2)/(TH*TW) = 1.33 of the interior's work at 64 x 32.
//
// Why the tile is exact for 8 generations:
//   * Rows. Eight ghost rows per side: the rows beyond the tile are taken as
//     zero, so the outermost tile row is wrong after one generation and the
//     wrong band grows one row per generation; after 8 it has reached the
//     ghost rows' inner edge and no further (stencil_packed.py:441-449).
//   * Columns. One ghost word per side: a wrong neighbour enters a ghost
//     word at its far bit and moves one bit per generation, so the ghost
//     bit next to the interior stays exact for 31 generations
//     (_evolve_with_ghost_plane, stencil_packed.py:316-348).
//   * Small grids. Tile rows and words map to the grid modulo its height
//     and nwords, and a tile word's west neighbour is the tile column to its
//     left: the tile is a window on the torus's universal cover, so heights
//     below 16 and nwords of 1 or 2 come out right. Flags read only the
//     cells a block owns, never a halo copy or a cell past the grid's edge.
//   * Shards (K7/K8). A tile row outside the shard's [0, h) is read from
//     gtop (rows -8..-1) or gbot (rows h..h+7), never modulo the shard, and
//     rows past h+8 are zero: they feed only rows no block owns. So the
//     universal-cover trick above is for the torus alone, and a shard
//     needs h >= 8 (its neighbours' ghost blocks are 8 of its rows). The
//     shard is full-width, so columns keep the torus wrap.
//   * Shards with mesh columns (K9-K13). Rows as for K7/K8. Columns never
//     wrap: the tile word at shard column -1 is gwest[e] and at column
//     nwords is geast[e], with e = row + 8 over rows -8..h+7, so the ghost
//     rows' corner words ride in the plane (they are the diagonal
//     neighbours' cells: the column exchange runs over the row-extended
//     range). Words further out are zero, which is the "wrong neighbour"
//     of the ghost word above: it cannot reach the shard in 8 generations.
//     nwords may be 1 (columns -1, 0, 1 are gwest, the word, geast).
//
// The shard kernels move the same bytes and do the same logic per word as
// their torus forms (the ghosts are 16 rows and 2(h+2) or 2(h+16) words
// per shard), so the same bounds hold: operations for K7-K13, bytes for K5.

#include <cstddef>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kGens = 8;       // TEMPORAL_GENS
constexpr int kTileRows = 64;  // TH: interior rows per block
constexpr int kTileWords = 32; // TW: interior words per block
constexpr int kThreads = 256;

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

// Where a tile's cells come from.
enum Source {
  kTorus = 0,      // the grid itself, rows and columns modulo its shape
  kGhostRows = 1,  // a full-width shard: rows from gtop/gbot, columns wrap
  kGhostPlane = 2  // a shard with mesh columns: rows from gtop/gbot,
                   // columns -1 and nwords from gwest/geast
};

// K1 (EXACT = false) / K2 (EXACT = true) on the torus (SRC = kTorus), K7 /
// K8 on a full-width mesh shard (kGhostRows), K9+K10 / K11+K12+K13 on a
// shard with mesh columns (kGhostPlane): kGens generations of one
// kTileRows x kTileWords tile in shared memory.
//
// The shared tile is padded by one always-zero word on every side, so the
// stencil reads its 3x3 neighbourhood without bounds checks: padded row p
// holds grid row r0 - kGens + p - 1 and padded column q holds grid word
// w0 + q - 2 (both modulo the grid; a shard's rows and columns as set out
// above).
template <bool EXACT, Source SRC>
__global__ void __launch_bounds__(kThreads)
bandt_kernel(const uint32_t* __restrict__ in, const uint32_t* __restrict__ gtop,
             const uint32_t* __restrict__ gbot,
             const uint32_t* __restrict__ gwest,
             const uint32_t* __restrict__ geast, uint32_t* __restrict__ out,
             int* __restrict__ flags, int height, int nwords, int tiles_x) {
  constexpr int R = kTileRows + 2 * kGens;  // tile rows incl. ghost rows
  constexpr int C = kTileWords + 2;         // tile words incl. ghost words
  constexpr int P = R + 2;                  // padded
  constexpr int Q = C + 2;
  __shared__ uint32_t tile[2][P][Q];

  const int tx = blockIdx.x % tiles_x;
  const int ty = blockIdx.x / tiles_x;
  const int r0 = ty * kTileRows;
  const int w0 = tx * kTileWords;
  const int own_rows = min(kTileRows, height - r0);
  const int own_words = min(kTileWords, nwords - w0);
  // Padded coordinates of the owned cells: [p_lo, p_hi) x [q_lo, q_hi).
  const int p_lo = kGens + 1, p_hi = kGens + 1 + own_rows;
  const int q_lo = 2, q_hi = 2 + own_words;

  int in_alive = 0;
  for (int idx = threadIdx.x; idx < P * Q; idx += blockDim.x) {
    const int p = idx / Q, q = idx % Q;
    uint32_t v = 0;
    if (p >= 1 && p <= R && q >= 1 && q <= C) {
      int gr = r0 - kGens + p - 1;  // >= -kGens
      int gw = w0 + q - 2;          // >= -1
      if (SRC != kGhostPlane) {
        gw %= nwords;
        if (gw < 0) gw += nwords;
      }
      const uint32_t* row;
      if (SRC != kTorus) {
        row = gr < 0               ? gtop + static_cast<size_t>(gr + kGens) * nwords
              : gr < height        ? in + static_cast<size_t>(gr) * nwords
              : gr < height + kGens ? gbot + static_cast<size_t>(gr - height) * nwords
                                   : nullptr;
      } else {
        gr %= height;
        if (gr < 0) gr += height;
        row = in + static_cast<size_t>(gr) * nwords;
      }
      if (row == nullptr) {
        v = 0;
      } else if (SRC == kGhostPlane && (gw < 0 || gw >= nwords)) {
        v = gw == -1 ? gwest[gr + kGens] : gw == nwords ? geast[gr + kGens] : 0;
      } else {
        v = row[gw];
      }
      in_alive |= (v != 0) && p >= p_lo && p < p_hi && q >= q_lo && q < q_hi;
    }
    tile[0][p][q] = v;
    tile[1][p][q] = 0;
  }
  if (!EXACT) block_or(in_alive, flags + 0);

  int cur = 0;
  for (int t = 0; t < kGens; ++t) {
    __syncthreads();
    int alive = 0, differs = 0;
    for (int idx = threadIdx.x; idx < R * C; idx += blockDim.x) {
      const int p = idx / C + 1, q = idx % C + 1;
      const uint32_t(*s)[Q] = tile[cur];
      const uint32_t x = s[p][q];
      const uint32_t nv =
          evolve_word(s[p - 1][q - 1], s[p - 1][q], s[p - 1][q + 1],
                      s[p][q - 1], x, s[p][q + 1], s[p + 1][q - 1],
                      s[p + 1][q], s[p + 1][q + 1]);
      tile[cur ^ 1][p][q] = nv;
      if (p >= p_lo && p < p_hi && q >= q_lo && q < q_hi) {
        alive |= nv != 0;
        differs |= nv != x;
      }
    }
    cur ^= 1;
    if (EXACT) {
      block_or(alive, flags + t);
      block_or(differs, flags + kGens + t);
    } else {
      if (t == 0) block_or(differs, flags + 3);
      if (t == kGens - 1) {
        block_or(alive, flags + 1);
        block_or(differs, flags + 2);
      }
    }
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < kTileRows * kTileWords;
       idx += blockDim.x) {
    const int i = idx / kTileWords, j = idx % kTileWords;
    if (i < own_rows && j < own_words) {
      out[static_cast<size_t>(r0 + i) * nwords + (w0 + j)] =
          tile[cur][p_lo + i][q_lo + j];
    }
  }
}

unsigned word_blocks(int height, int nwords) {
  const long long words = static_cast<long long>(height) * nwords;
  return static_cast<unsigned>((words + kThreads - 1) / kThreads);
}

template <Source SRC>
int launch_bandt(const void* in, const void* gtop, const void* gbot,
                 const void* gwest, const void* geast, void* out, void* flags,
                 int height, int nwords, int exact, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles_x = (nwords + kTileWords - 1) / kTileWords;
  const int tiles_y = (height + kTileRows - 1) / kTileRows;
  const unsigned blocks = static_cast<unsigned>(tiles_x) * tiles_y;
  auto kernel = exact ? bandt_kernel<true, SRC> : bandt_kernel<false, SRC>;
  kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(in), static_cast<const uint32_t*>(gtop),
      static_cast<const uint32_t*>(gbot), static_cast<const uint32_t*>(gwest),
      static_cast<const uint32_t*>(geast), static_cast<uint32_t*>(out),
      static_cast<int*>(flags), height, nwords, tiles_x);
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
  return launch_bandt<kTorus>(in, nullptr, nullptr, nullptr, nullptr, out,
                              flags, height, nwords, exact, device, stream);
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
  return launch_bandt<kGhostRows>(in, gtop, gbot, nullptr, nullptr, out, flags,
                                  height, nwords, exact, device, stream);
}

// K9+K10 (exact = 0) / K11+K12+K13 (exact = 1). gtop/gbot as for K7/K8;
// gwest/geast: the (height + 16) ghost word columns over rows -8..h+7;
// height >= 8, nwords >= 1.
int gol_bandtg_pass(const void* in, const void* gtop, const void* gbot,
                    const void* gwest, const void* geast, void* out,
                    void* flags, int height, int nwords, int exact, int device,
                    void* stream) {
  return launch_bandt<kGhostPlane>(in, gtop, gbot, gwest, geast, out, flags,
                                   height, nwords, exact, device, stream);
}

const char* gol_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
