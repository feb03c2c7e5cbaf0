// Byte-per-cell Game-of-Life generation for Hopper (sm_90a): K4 and K6.
//
// Replaces gol_tpu/ops/stencil_pallas.py _band_kernel (via _step): one
// B3/S23 generation of a (height, width) uint8 torus with two flags fused
// into the same pass, flags[0] |= any live cell in the new grid and
// flags[1] |= any cell that changed ("similar" stored negated, as in
// stencil_packed.cu). The caller zeroes the flag pair; every block ORs its
// own predicates in, so concurrent blocks accumulate without an order.
//
// Cells are bytes 0 or 1 — what the text decode and every generation give.
// The kernel relies on it: four cells ride in one 32-bit word and their
// 3x3 sums (at most 9) are added as plain 32-bit integers, whose bytes never
// carry into each other.
//
// Design. A block owns a 64-row x 128-column tile. It loads the tile plus a
// one-cell halo into shared memory as words of 4 cells, with rows and
// columns taken modulo the grid, so every height and width >= 1 is right:
// a tile that runs past the east edge holds wrapped columns there, and the
// first of them is the east neighbour of the last owned column. Padded row
// p holds grid row r0 - 1 + p; word q (1..32) holds columns c0 + 4(q-1) ..
// c0 + 4q - 1, word 0 only its top byte (column c0 - 1) and word 33 only
// its low byte (column c0 + 128). Where the width is a multiple of 4 and
// both buffers are 4-byte aligned, interior words load and store as one
// 32-bit access; otherwise byte by byte, never past a row's end. A thread
// loads one word column of 9 padded rows, all before its first shared
// store, so enough bytes are in flight to cover the memory latency. It
// then owns one word column and 8 consecutive rows and keeps the
// horizontal triple sums of the rows above, at and below the current one,
// so each row's sum is computed once.
//
// What bounds it. Each launch reads every cell once and writes it once
// (2 bytes per cell over 3.35 TB/s; the halo adds 66/64 of the rows and 2
// bytes per 128 columns, which the bound does not count). Its arithmetic is
// ~31 32-bit integer ops per 4 cells (OPS_PER_BYTE_WORD in chip_smoke.py),
// so bytes bound it. Not done yet: wider tiles, TMA loads, a second
// generation per pass.
//
// K6 replaces gol_tpu/ops/stencil_pallas.py _dist_band_kernel (via
// _dist_step): the same generation for one shard of a device mesh, fed by
// the halo exchange (gol_tpu_torch/parallel/halo.py). It is the same
// kernel reading its cells through ShardCells instead of TorusCells: row -1
// is the ghost row `top` and row h the ghost row `bot`, column -1 is
// gwest[r + 1] and columns from w on are geast[r + 1] for rows r = -1..h
// (the (h+2) ghost columns carry the corners), and rows past h are zero,
// since they feed no owned cell. Any shard shape, as K4.

#include <cstddef>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kTileRows = 64;                           // rows per tile
constexpr int kTileWords = 32;                          // 4-cell words per tile row
constexpr int kTileCols = 4 * kTileWords;               // 128 columns
constexpr int kThreads = 256;
constexpr int kRowGroups = kThreads / kTileWords;        // 8 warps
constexpr int kRowsPerThread = kTileRows / kRowGroups;   // 8
constexpr int kPadRows = kTileRows + 2;
constexpr int kPadWords = kTileWords + 2;
constexpr int kLoadRows = (kPadRows + kRowGroups - 1) / kRowGroups;  // 9
constexpr uint32_t kLowBits = 0x01010101u;

__device__ __forceinline__ int wrap(int x, int n) {
  const int r = x % n;
  return r < 0 ? r + n : r;
}

// A padded row's grid row: the modulo only where the tile leaves the grid.
__device__ __forceinline__ int grid_row(int r, int height) {
  return r >= 0 && r < height ? r : wrap(r, height);
}

// Where K4 reads its cells: the torus, rows and columns modulo the grid.
struct TorusCells {
  const uint8_t* in;
  int height, width;
  // The cells of padded row r; never null.
  __device__ const uint8_t* row(int r) const {
    return in + static_cast<size_t>(grid_row(r, height)) * width;
  }
  // Cell c (any column) of row r, whose cells are `row`.
  __device__ uint32_t cell(const uint8_t* row, int, int c) const {
    return __ldg(row + wrap(c, width));
  }
};

// Where K6 reads a shard's cells (see the top of the file).
struct ShardCells {
  const uint8_t* in;
  const uint8_t* top;
  const uint8_t* bot;
  const uint8_t* gwest;
  const uint8_t* geast;
  int height, width;
  // The cells of padded row r >= -1; null for rows past h, which are zero.
  __device__ const uint8_t* row(int r) const {
    return r < 0 ? top
           : r < height ? in + static_cast<size_t>(r) * width
           : r == height ? bot
                         : nullptr;
  }
  __device__ uint32_t cell(const uint8_t* row, int r, int c) const {
    return c < 0 ? __ldg(gwest + r + 1)
           : c >= width ? __ldg(geast + r + 1)
                        : __ldg(row + c);
  }
};

// Per byte: 1 where the byte of `sums` equals the byte of `k` (bytes < 16).
__device__ __forceinline__ uint32_t bytes_equal(uint32_t sums, uint32_t k) {
  uint32_t x = sums ^ k;  // a byte is 0 exactly where the sum is k
  x |= x >> 2;
  x |= x >> 1;  // bit 0 of each byte = OR of that byte's bits 0..3
  return ~x & kLowBits;
}

// Horizontal triple sums (west + centre + east) of interior word k of a
// padded shared row.
__device__ __forceinline__ uint32_t row_sum(const uint32_t* row, int k) {
  const uint32_t l = row[k], m = row[k + 1], r = row[k + 2];
  const uint32_t west = (m << 8) | (l >> 24);
  const uint32_t east = (m >> 8) | (r << 24);
  return west + m + east;
}

// OR a block-wide predicate into *flag. Every thread of the block calls it
// (it is a barrier).
__device__ __forceinline__ void block_or(int pred, int* flag) {
  if (__syncthreads_or(pred) && threadIdx.x == 0) {
    if (*reinterpret_cast<volatile int*>(flag) == 0) atomicOr(flag, 1);
  }
}

template <class Cells>
__global__ void __launch_bounds__(kThreads)
byte_step_kernel(const Cells src, uint8_t* __restrict__ out,
                 int* __restrict__ flags, int tiles_x, int vec) {
  __shared__ uint32_t tile[kPadRows][kPadWords];
  const int height = src.height, width = src.width;

  const int r0 = (blockIdx.x / tiles_x) * kTileRows;
  const int c0 = (blockIdx.x % tiles_x) * kTileCols;
  const int own_rows = min(kTileRows, height - r0);
  const int own_cols = min(kTileCols, width - c0);

  // Stage the tile. Every thread issues all of its global loads before its
  // first shared store, so each warp keeps kLoadRows 128-byte rows in flight:
  // with one word at a time the loads wait on memory latency, not bandwidth.
  const int k = threadIdx.x % kTileWords;
  const int c = c0 + 4 * k;
  const bool word_load = vec && c + 3 < width;
  uint32_t v[kLoadRows];
#pragma unroll
  for (int j = 0; j < kLoadRows; ++j) {
    const int p = threadIdx.x / kTileWords + kRowGroups * j;
    v[j] = 0;
    const uint8_t* row = p < kPadRows ? src.row(r0 - 1 + p) : nullptr;
    if (row != nullptr) {
      if (word_load) {
        v[j] = __ldg(reinterpret_cast<const unsigned int*>(row + c));
      } else {
        for (int b = 0; b < 4; ++b) {
          v[j] |= src.cell(row, r0 - 1 + p, c + b) << (8 * b);
        }
      }
    }
  }
  // The halo columns: threads 2p and 2p + 1 load row p's west and east byte.
  uint32_t halo = 0;
  if (threadIdx.x < 2 * kPadRows) {
    const int r = r0 - 1 + (threadIdx.x >> 1);
    const uint8_t* row = src.row(r);
    if (row != nullptr) {
      halo = (threadIdx.x & 1) ? src.cell(row, r, c0 + kTileCols)
                               : src.cell(row, r, c0 - 1) << 24;
    }
  }
#pragma unroll
  for (int j = 0; j < kLoadRows; ++j) {
    const int p = threadIdx.x / kTileWords + kRowGroups * j;
    if (p < kPadRows) tile[p][k + 1] = v[j];
  }
  if (threadIdx.x < 2 * kPadRows) {
    tile[threadIdx.x >> 1][(threadIdx.x & 1) ? kPadWords - 1 : 0] = halo;
  }
  __syncthreads();

  const int p_first = 1 + (threadIdx.x / kTileWords) * kRowsPerThread;
  const int n_own = min(4, max(0, own_cols - 4 * k));  // owned cells of word k
  const uint32_t own_mask = n_own == 4 ? 0xFFFFFFFFu : (1u << (8 * n_own)) - 1u;
  uint32_t up = row_sum(tile[p_first - 1], k);
  uint32_t mid = row_sum(tile[p_first], k);
  uint32_t alive = 0, differs = 0;
  for (int i = 0; i < kRowsPerThread; ++i) {
    const int p = p_first + i;
    const uint32_t down = row_sum(tile[p + 1], k);
    const uint32_t centre = tile[p][k + 1];
    const uint32_t sums = up + mid + down;  // 3x3 sums incl. the centre
    // B3/S23: born or kept on a 3x3 sum of 3, kept on 4 when alive.
    const uint32_t next =
        bytes_equal(sums, 0x03030303u) | (bytes_equal(sums, 0x04040404u) & centre);
    if (p - 1 < own_rows && n_own > 0) {
      uint8_t* dst = out + static_cast<size_t>(r0 + p - 1) * width + c0 + 4 * k;
      if (vec && n_own == 4) {
        *reinterpret_cast<uint32_t*>(dst) = next;
      } else {
        for (int b = 0; b < n_own; ++b) dst[b] = static_cast<uint8_t>(next >> (8 * b));
      }
      alive |= next & own_mask;
      differs |= (next ^ centre) & own_mask;
    }
    up = mid;
    mid = down;
  }
  block_or(alive != 0, flags);
  block_or(differs != 0, flags + 1);
}

bool aligned4(const void* p) { return reinterpret_cast<uintptr_t>(p) % 4 == 0; }

template <class Cells>
int launch(const Cells& src, void* out, void* flags, int vec, int device,
           void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles_x = (src.width + kTileCols - 1) / kTileCols;
  const int tiles_y = (src.height + kTileRows - 1) / kTileRows;
  vec = vec && src.width % 4 == 0 && aligned4(src.in) && aligned4(out);
  byte_step_kernel<Cells><<<static_cast<unsigned>(tiles_x) * tiles_y, kThreads,
                            0, static_cast<cudaStream_t>(stream)>>>(
      src, static_cast<uint8_t*>(out), static_cast<int*>(flags), tiles_x, vec);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Each entry launches on `stream` (a cudaStream_t of `device`), does not
// synchronise and allocates nothing; it returns cudaGetLastError() after
// the launch (0 = cudaSuccess). `out` must not alias any input.

// K4.
int gol_byte_step(const void* in, void* out, void* flags, int height,
                  int width, int device, void* stream) {
  const TorusCells src{static_cast<const uint8_t*>(in), height, width};
  return launch(src, out, flags, 1, device, stream);
}

// K6. top/bot: (1, width) ghost rows; gwest/geast: (height + 2) ghost
// columns.
int gol_dist_byte_step(const void* in, const void* top, const void* bot,
                       const void* gwest, const void* geast, void* out,
                       void* flags, int height, int width, int device,
                       void* stream) {
  const ShardCells src{static_cast<const uint8_t*>(in),
                       static_cast<const uint8_t*>(top),
                       static_cast<const uint8_t*>(bot),
                       static_cast<const uint8_t*>(gwest),
                       static_cast<const uint8_t*>(geast), height, width};
  return launch(src, out, flags, aligned4(top) && aligned4(bot), device,
                stream);
}

const char* gol_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
