// Batched halo tile step for Hopper (sm_90a): T1.
//
// The sparse engine (gol_tpu_torch/sparse/engine.py) steps only a giant
// universe's active tiles, and the macrocell engine (macro/advance.py)
// advances its leaf windows, both one generation at a time over B tiles
// that each carry their 1-cell halo ring. The JAX package has no Pallas
// kernel there: make_tile_step_runner (gol_tpu/engine.py:1834) jits
// stencil_lax.evolve_padded_batch (gol_tpu/ops/stencil_lax.py:61), a jnp
// stencil under vmap. The port's host loop needs each tile's flags out of
// the step's own pass, so the step is this kernel.
//
//   tile_step_kernel  T1  one generation of B halo-extended uint8 blocks,
//       (B, t+2, t+2) of 0/1 cells: each interior cell reads only its
//       in-block neighbours (no wrap), and the (B, t, t) next interiors are
//       written at `out` with a row pitch and a tile stride, so the result
//       lands either compact or in the interior of a second padded stack
//       whose ring stays as it was (the macro lane's ping-pong).
//
// Flags. Each launch ORs tile b's pair into flags[2b] (any live cell in the
// next interior) and flags[2b + 1] (any interior cell differs from
// blocks[b, 1:-1, 1:-1]), into a buffer the caller zeroes. A warp reduces
// its predicates (__reduce_or_sync) and one lane issues the atomic, only if
// the flag is still clear: one vote and at most one atomic per warp. An
// all-zero block (a padding slot of the batch ladder) writes zeros and no
// flag.
//
// Design. The interior of a tile is cut into bands of kBandRows rows by
// 32 columns; a warp owns one such band and each lane one column of it,
// walking down the rows. A lane keeps the 3-cell row sums of the rows above
// and at the current one, so each cell costs one new row sum: 3 byte loads
// of adjacent columns, the warp's 34 bytes in one or two 32-byte sectors.
// No shared memory and no barrier: the neighbour loads come from L1 and
// L2, and each input byte comes from device memory once.
//
// What bounds it. One pass moves each input byte once and each output byte
// once: (t+2)^2 + t^2 bytes per tile, against ~9 integer operations per
// cell, so bytes bound it. At the sparse lane's 64 x 256^2 that is 8.45 MB
// (2.5 us at 3.35 TB/s); byte loads (one byte per lane per load) keep it
// well under that rate. Not done yet: 4 or 16 cells per lane with wide
// loads, and several generations per launch for the macro leaves.

#include <cstddef>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarp = 32;
constexpr unsigned kFullMask = 0xffffffffu;
constexpr int kBandWarps = kThreads / kWarp;  // bands of a block
constexpr int kBandRows = 16;                   // rows of a warp's band

// OR a warp's predicate into *flag: one warp-wide reduction, then lane 0
// reads the flag and issues the atomic only if it is still clear. Every
// lane of the warp calls it.
__device__ __forceinline__ void or_flag(uint32_t acc, int* flag) {
  if (__reduce_or_sync(kFullMask, acc != 0 ? 1u : 0u) &&
      threadIdx.x % kWarp == 0) {
    if (*reinterpret_cast<volatile int*>(flag) == 0) atomicOr(flag, 1);
  }
}

// The 3-cell sum of padded row `row` around interior column c (padded
// columns c, c + 1, c + 2), and the centre cell in `x`.
__device__ __forceinline__ uint32_t row_sum(const uint8_t* row, int c,
                                            uint32_t& x) {
  x = __ldg(row + c + 1);
  return __ldg(row + c) + x + __ldg(row + c + 2);
}

// T1: grid (ceil(t / kWarp), ceil(t / (kBandWarps * kBandRows)), batch).
// A warp owns kWarp adjacent interior columns of a band of kBandRows rows;
// each lane walks down its column.
__global__ void __launch_bounds__(kThreads)
tile_step_kernel(const uint8_t* __restrict__ in, uint8_t* __restrict__ out,
                 int* __restrict__ flags, int tile, long long out_pitch,
                 long long out_stride) {
  const int b = blockIdx.z;
  const int pitch = tile + 2;
  const uint8_t* src = in + static_cast<size_t>(b) * pitch * pitch;
  uint8_t* dst = out + static_cast<size_t>(b) * out_stride;
  const int c = blockIdx.x * kWarp + threadIdx.x % kWarp;
  const int r0 = (blockIdx.y * kBandWarps + threadIdx.x / kWarp) * kBandRows;
  const int r1 = min(r0 + kBandRows, tile);
  uint32_t alive = 0, differs = 0;
  if (c < tile && r0 < tile) {
    // Interior row r is padded row r + 1: the rows above and at it.
    uint32_t x, xd;
    uint32_t up = row_sum(src + static_cast<size_t>(r0) * pitch, c, xd);
    uint32_t mid = row_sum(src + static_cast<size_t>(r0 + 1) * pitch, c, x);
    for (int r = r0; r < r1; ++r) {
      const uint32_t down =
          row_sum(src + static_cast<size_t>(r + 2) * pitch, c, xd);
      // B3/S23 on the 3x3 sum: 3 is born or kept, 4 is kept when alive.
      const uint32_t n = up + mid + down;
      const uint32_t next = n == 3 || (n == 4 && x != 0) ? 1u : 0u;
      dst[static_cast<size_t>(r) * out_pitch + c] = static_cast<uint8_t>(next);
      alive |= next;
      differs |= next ^ x;
      up = mid;
      mid = down;
      x = xd;
    }
  }
  or_flag(alive, flags + 2 * b);
  or_flag(differs, flags + 2 * b + 1);
}

}  // namespace

extern "C" {

// Launches on `stream` (a cudaStream_t of `device`), does not synchronise
// and allocates nothing; returns cudaGetLastError() after the launch (0 =
// cudaSuccess). in: (batch, tile + 2, tile + 2) uint8 blocks; out: tile b's
// row r at out + b * out_stride + r * out_pitch, not overlapping `in`;
// flags: the launch's (batch, 2) int32 pair per tile, ORed into. All on the
// device; batch <= 65535, tile >= 1.
int gol_tile_step(const void* in, void* out, void* flags, int batch, int tile,
                  long long out_pitch, long long out_stride, int device,
                  void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid;
  grid.x = (tile + kWarp - 1) / kWarp;
  grid.y = (tile + kBandWarps * kBandRows - 1) / (kBandWarps * kBandRows);
  grid.z = static_cast<unsigned>(batch);
  tile_step_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(in), static_cast<uint8_t*>(out),
      static_cast<int*>(flags), tile, out_pitch, out_stride);
  return static_cast<int>(cudaGetLastError());
}

const char* gol_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
