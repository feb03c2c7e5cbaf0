// Cell <-> word codec kernels for Hopper (sm_90a): E1 and D1.
//
// The byte-state lanes (`--kernel auto` on one device, on every shard of a
// mesh, in every segment and in every rank) carry uint8 (H, W) cells in
// and out, and the packed kernels step int32 (H, W/32) words: bit j of
// word w is the cell at column 32*w + j (gol_tpu_torch/ops/packed_math.py).
// The JAX package crosses that boundary with jnp inside the jitted runner,
// which XLA fuses into one pass each way (encode and decode,
// gol_tpu/ops/packed_math.py:145 and :153; no Pallas kernel). These are
// the two passes:
//
//   pack_cells_kernel    E1  cells -> words: bit j of word i =
//       (cell 32*i + j != 0), the plain version's rule (on the 0/1 cells
//       the text decode makes it equals JAX's weighted sum).
//   unpack_words_kernel  D1  words -> cells: cell 32*i + j = bit j of
//       word i, 0/1.
//
// Design. Rows are W = 32 * nwords bytes, so word i of the row-major word
// array covers the 32 bytes at 32 * i of the row-major cell array: both
// kernels run over the flat index i with no row math. One thread per word,
// in a grid-stride loop over all H * W/32 words with 64-bit indices (a
// 65536^2 grid holds 2^32 cells). A thread moves its 32 cells as two
// 16-byte vectors and its word as 4 bytes; adjacent threads move adjacent
// 32-byte segments, so a warp's loads and stores cover 1 KiB of cells and
// 128 bytes of words in whole sectors. No shared memory, no flags, no
// atomics.
//
// Bits in registers. E1: a 32-bit lane of a vector holds 4 cells; per byte
// "nonzero" is its top bit of ((v & 0x7f7f7f7f) + 0x7f7f7f7f) | v (the add
// carries into bit 7 of a byte iff its low 7 bits are not all 0 and never
// into the next byte), and one multiply by 0x10204080 gathers the 4 top
// bits (at 0, 8, 16, 24 after >> 7) into bits 28..31, clear of every
// cross term. D1: a nibble times 0x00204081 puts bit k at 8k (and its
// cross terms elsewhere, without carries); & 0x01010101 keeps the 4 cells.
// About 6 integer operations per 4 cells each way.
//
// What bounds them. Each direction reads one side once and writes the
// other once: 33 bytes per 32 cells, 301,989,888 bytes at 16384^2, 0.0901
// ms at 3.35 TB/s; ~50 integer operations per word are far under the
// integer pipe's rate.

#include <cstddef>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
// Blocks of a launch at most; a larger grid strides (65536 x 256 threads
// take 16.7M words a sweep, so 65536^2 strides 8 times).
constexpr long long kMaxBlocks = 1 << 16;

// 4 cells (the bytes of v) -> 4 bits, bit k = byte k != 0.
__device__ __forceinline__ uint32_t nibble_of(uint32_t v) {
  const uint32_t top = (((v & 0x7f7f7f7fu) + 0x7f7f7f7fu) | v) & 0x80808080u;
  return ((top >> 7) * 0x10204080u) >> 28;
}

// 4 bits -> 4 cells of 0/1, byte k = bit k.
__device__ __forceinline__ uint32_t cells_of(uint32_t nibble) {
  return (nibble * 0x00204081u) & 0x01010101u;
}

__global__ void __launch_bounds__(kThreads)
    pack_cells_kernel(const uint4* __restrict__ cells,
                      uint32_t* __restrict__ words, long long n,
                      long long stride) {
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < n; i += stride) {
    const uint4 lo = __ldg(cells + 2 * i);
    const uint4 hi = __ldg(cells + 2 * i + 1);
    words[i] = nibble_of(lo.x) | nibble_of(lo.y) << 4 |
               nibble_of(lo.z) << 8 | nibble_of(lo.w) << 12 |
               nibble_of(hi.x) << 16 | nibble_of(hi.y) << 20 |
               nibble_of(hi.z) << 24 | nibble_of(hi.w) << 28;
  }
}

__global__ void __launch_bounds__(kThreads)
    unpack_words_kernel(const uint32_t* __restrict__ words,
                        uint4* __restrict__ cells, long long n,
                        long long stride) {
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < n; i += stride) {
    const uint32_t w = __ldg(words + i);
    cells[2 * i] = make_uint4(cells_of(w & 15u), cells_of(w >> 4 & 15u),
                              cells_of(w >> 8 & 15u), cells_of(w >> 12 & 15u));
    cells[2 * i + 1] =
        make_uint4(cells_of(w >> 16 & 15u), cells_of(w >> 20 & 15u),
                   cells_of(w >> 24 & 15u), cells_of(w >> 28));
  }
}

unsigned blocks_for(long long n) {
  const long long blocks = (n + kThreads - 1) / kThreads;
  return static_cast<unsigned>(blocks < kMaxBlocks ? blocks : kMaxBlocks);
}

}  // namespace

extern "C" {

// Each entry launches on `stream` (a cudaStream_t of `device`), does not
// synchronise and allocates nothing; it returns cudaGetLastError() after
// the launch (0 = cudaSuccess). cells: n * 32 bytes, 16-byte aligned;
// words: n uint32; n >= 1; the two do not overlap.

// E1: words[i] bit j = cells[32 * i + j] != 0.
int gol_pack_cells(const void* cells, void* words, long long n, int device,
                   void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned blocks = blocks_for(n);
  pack_cells_kernel<<<blocks, kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(cells), static_cast<uint32_t*>(words), n,
      static_cast<long long>(blocks) * kThreads);
  return static_cast<int>(cudaGetLastError());
}

// D1: cells[32 * i + j] = bit j of words[i].
int gol_unpack_words(const void* words, void* cells, long long n, int device,
                     void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned blocks = blocks_for(n);
  unpack_words_kernel<<<blocks, kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(words), static_cast<uint4*>(cells), n,
      static_cast<long long>(blocks) * kThreads);
  return static_cast<int>(cudaGetLastError());
}

const char* gol_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
