// Batched halo tile steps for Hopper (sm_90a): T1.
//
// The sparse engine (gol_tpu_torch/sparse/engine.py) steps only a giant
// universe's active tiles, one generation at a time, and the macrocell
// engine (macro/advance.py) advances its leaf windows n generations at a
// time, both over B tiles that each carry their 1-cell halo ring. The JAX
// package has no Pallas kernel there: make_tile_step_runner
// (gol_tpu/engine.py:1834) jits stencil_lax.evolve_padded_batch
// (gol_tpu/ops/stencil_lax.py:61), a jnp stencil under vmap. The port's
// host loop needs each tile's flags out of the step's own pass, so the
// step is this kernel.
//
//   tile_steps_kernel  T1  n >= 1 generations of B halo-extended uint8
//       blocks, (B, t+2, t+2) of 0/1 cells: each interior cell reads only
//       its in-block neighbours (no wrap), and the block's ring is held as
//       it is in the input for every generation. The (B, t, t) interiors
//       of the last generation are written at `out` with a row pitch and a
//       tile stride, so the result lands either compact or in the interior
//       of a second padded stack whose ring is left as it was.
//
// Flags. Each launch ORs tile b's pair of the last generation into
// flags[2b] (any live cell in the new interior) and flags[2b + 1] (any
// interior cell differs from the generation before), into a buffer the
// caller zeroes: each CTA reduces its flags (a warp's __reduce_or_sync,
// then one word per warp in shared memory) and issues at most one atomic
// per flag. An all-zero block (a padding slot of the batch ladder) writes
// zeros and no flag.
//
// What bounds it. One generation moves each input byte once and each
// output byte once: (t+2)^2 + t^2 bytes per tile. At the sparse lane's 64
// x 256^2 that is 8.45 MB (2.5 us at 3.35 TB/s), so bytes bound one
// generation; n generations of a window held on chip do the adder
// network's 12 logic instructions per word and generation, which bound the
// macro lane's leaves (64 windows of 512^2 for 128 generations: 0.048 ms).
// The first T1 read three bytes per lane for each cell and ran one launch
// per generation: 0.13-0.15 of its bound, and n launches per leaf advance.
//
// Design. A CTA packs its rows of a block into bit words in shared memory
// (bit j of word w is column 32w + j, as io/bitpack): it loads the rows'
// bytes with aligned 16-byte loads, turns each load into a 16-bit mask of
// live cells, and ORs the mask's pieces into the words they fall in
// (shared atomics: a load spans at most two rows and two words of each).
// Then each generation runs the adder network of stencil_packed.cu on the
// words from one shared copy into the other, one __syncthreads() between
// generations: a thread owns a strip of rows of one word column and walks
// down it, keeping the row sums of the rows above and at the current one.
// Cells of the ring, and the bits past the row's last column, keep their
// input values. Last, the CTA unpacks its interior rows into `out`, 16
// cells a 16-byte store where the destination is aligned, byte stores at a
// row's ragged ends. Two shapes of launch:
//   n = 1 (the sparse lane, the shard lane and the CLI's --pattern): a
//       tile's interior rows are cut into bands of kBandRows rows, one CTA
//       each, and each band loads its two halo rows, so 64 tiles of 256^2
//       fill the card with 512 CTAs.
//   n > 1 (the macro leaves): one CTA per block holds the whole window,
//       two copies in dynamic shared memory (asked for with
//       cudaFuncSetAttribute past 48 KiB, up to the device's opt-in
//       maximum: gol_tile_window_max_words), and runs all n generations:
//       one launch for a leaf advance. A window too large for it runs as n
//       launches of the n = 1 form (the wrapper chooses by shape).

#include <cstddef>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kWarp = 32;
constexpr unsigned kFullMask = 0xffffffffu;
constexpr int kMaxThreads = 1024;
constexpr int kMaxWarps = kMaxThreads / kWarp;
constexpr int kBandThreads = 256;  // n = 1: a band's CTA at most
constexpr int kBandRows = 32;      // n = 1: interior rows of a band
constexpr int kStaticShared = kMaxWarps * 4;  // the warps' flag words
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

// Bit k of the result: byte k of the four words is not 0.
__device__ __forceinline__ uint32_t live_nibble(uint32_t v) {
  const uint32_t high = (((v & 0x7f7f7f7fu) + 0x7f7f7f7fu) | v) & 0x80808080u;
  return ((high >> 7) * 0x00204081u) >> 21 & 0xfu;
}

__device__ __forceinline__ uint32_t live_mask(uint4 v) {
  return live_nibble(v.x) | live_nibble(v.y) << 4 | live_nibble(v.z) << 8 |
         live_nibble(v.w) << 12;
}

// Four 0/1 bytes from the low four bits.
__device__ __forceinline__ uint32_t spread_nibble(uint32_t bits) {
  return ((bits & 0xfu) * 0x00204081u) & 0x01010101u;
}

// The `bytes` bytes at `src` (a block's rows, `pitch` bytes each) into the
// bit words at `dst` (`nw` words a row, zeroed), by the CTA.
__device__ __forceinline__ void pack_rows(const uint8_t* src, int bytes,
                                          int pitch, int nw, uint32_t* dst) {
  const uintptr_t start = reinterpret_cast<uintptr_t>(src);
  const uintptr_t first = start & ~uintptr_t{15};
  const int chunks = static_cast<int>((start + bytes - first + 15) / 16);
  for (int c = threadIdx.x; c < chunks; c += blockDim.x) {
    const uintptr_t at = first + 16 * static_cast<uintptr_t>(c);
    const uint32_t mask = live_mask(__ldg(reinterpret_cast<const uint4*>(at)));
    if (mask == 0) continue;  // dead cells: nothing to set
    // Bytes k0 .. k1 - 1 of the load are the rows'; `off` is byte 0's
    // offset in them.
    const long long off = static_cast<long long>(at - start);
    const int k0 = off < 0 ? static_cast<int>(-off) : 0;
    const int k1 = static_cast<int>(min(16LL, bytes - off));
    for (int k = k0; k < k1;) {
      const int f = static_cast<int>(off + k);
      const int row = f / pitch;
      const int col = f - row * pitch;
      const int len = min(k1 - k, min(pitch - col, 32 - (col & 31)));
      const uint32_t bits = (mask >> k) & ((1u << len) - 1u);
      if (bits) atomicOr(dst + row * nw + (col >> 5), bits << (col & 31));
      k += len;
    }
  }
}

// The interior columns of word w of a padded row: 1 .. pitch - 2.
__device__ __forceinline__ uint32_t interior_mask(int w, int pitch) {
  uint32_t m = w == 0 ? ~1u : ~0u;
  const int keep = pitch - 1 - 32 * w;  // columns 32w .. pitch - 2
  if (keep < 32) m &= keep > 0 ? (1u << keep) - 1u : 0u;
  return m;
}

// One generation of the interior rows 1 .. rows - 2 of a (rows, nw) bit
// grid from `src` to `dst` by the CTA, with dead words past the row's
// ends; ring cells and the bits past the last column keep src's values.
// Thread k walks strips of `strip` rows of one word column (units k, k +
// blockDim.x, ...). With `flag`, ORs the new interior into `alive` and its
// changed bits into `differs`.
__device__ __forceinline__ void window_generation(const uint32_t* src,
                                                  uint32_t* dst, int rows,
                                                  int nw, int pitch, int strip,
                                                  bool flag, uint32_t& alive,
                                                  uint32_t& differs) {
  const int inner = rows - 2;
  const int units = (inner + strip - 1) / strip * nw;
  for (int u = threadIdx.x; u < units; u += blockDim.x) {
    const int w = u % nw;
    const int r0 = 1 + u / nw * strip;
    const int r1 = min(r0 + strip, rows - 1);
    const uint32_t mask = interior_mask(w, pitch);
    const uint32_t* up = src + (r0 - 1) * nw;
    const uint32_t* at = src + r0 * nw;
    uint32_t u0, u1, m0, m1, s0, s1, unused0, unused1;
    sums(up[w], w > 0 ? up[w - 1] : 0u, w + 1 < nw ? up[w + 1] : 0u, unused0,
         unused1, u0, u1);
    uint32_t x = at[w];
    sums(x, w > 0 ? at[w - 1] : 0u, w + 1 < nw ? at[w + 1] : 0u, m0, m1, s0,
         s1);
    for (int r = r0; r < r1; ++r) {
      const uint32_t* down = src + (r + 1) * nw;
      const uint32_t xd = down[w];
      uint32_t dm0, dm1, d0, d1;
      sums(xd, w > 0 ? down[w - 1] : 0u, w + 1 < nw ? down[w + 1] : 0u, dm0,
           dm1, d0, d1);
      const uint32_t nv = next_gen(u0, u1, d0, d1, m0, m1, x) & mask;
      dst[r * nw + w] = nv | (x & ~mask);
      if (flag) {
        alive |= nv;
        differs |= nv ^ (x & mask);
      }
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

// 16 bits of a bit row from column `col` on (col may be negative: columns
// before 0 read as 0).
__device__ __forceinline__ uint32_t row_bits16(const uint32_t* row, int col,
                                               int nw) {
  const int c = max(col, 0);
  const int w = c >> 5;
  const uint32_t hi = w + 1 < nw ? row[w + 1] : 0u;
  const uint32_t bits = __funnelshift_r(row[w], hi, c & 31);
  return (col < 0 ? bits << -col : bits) & 0xffffu;
}

// Interior rows 1 .. rows - 2 of the bit grid `src` into `out`: grid row
// r is interior row first + r - 1, at out + (first + r - 1) * out_pitch,
// t bytes each. By the CTA: each thread takes 16-byte destination chunks.
__device__ __forceinline__ void unpack_rows(const uint32_t* src, int rows,
                                            int nw, int tile, int first,
                                            uint8_t* out, long long out_pitch) {
  const int per_row = tile / 16 + 2;  // chunks a row can touch
  const int units = (rows - 2) * per_row;
  for (int u = threadIdx.x; u < units; u += blockDim.x) {
    const int r = 1 + u / per_row;
    uint8_t* row = out + static_cast<long long>(first + r - 1) * out_pitch;
    const uintptr_t lo = reinterpret_cast<uintptr_t>(row);
    const uintptr_t at = (lo & ~uintptr_t{15}) + 16 * static_cast<uintptr_t>(u % per_row);
    if (at >= lo + tile) continue;
    const long long c0 = static_cast<long long>(at - lo);  // interior column
    // Interior column c is padded column c + 1.
    const uint32_t bits = row_bits16(src + r * nw, static_cast<int>(c0) + 1, nw);
    if (at >= lo && at + 16 <= lo + tile) {
      *reinterpret_cast<uint4*>(at) =
          make_uint4(spread_nibble(bits), spread_nibble(bits >> 4),
                     spread_nibble(bits >> 8), spread_nibble(bits >> 12));
    } else {
      for (int k = 0; k < 16; ++k) {
        const long long c = c0 + k;
        if (c >= 0 && c < tile) row[c] = static_cast<uint8_t>(bits >> k & 1u);
      }
    }
  }
}

// T1: grid (bands, batch). CTA (band, b) loads padded rows band * band_rows
// .. + rows - 1 of block b (rows = its interior rows + 2: all of them when
// band_rows >= tile) into two bit copies in dynamic shared memory, runs n
// generations (n > 1 only with the whole block in one CTA) and writes its
// interior rows of the last one at out + b * out_stride.
__global__ void __launch_bounds__(kMaxThreads)
tile_steps_kernel(const uint8_t* __restrict__ in, uint8_t* __restrict__ out,
                  int* __restrict__ flags, int tile, int n, int band_rows,
                  int strip, long long out_pitch, long long out_stride) {
  extern __shared__ __align__(16) uint4 tile_shared[];
  __shared__ uint32_t warp_flags[kMaxWarps];
  const int b = blockIdx.y;
  const int pitch = tile + 2;
  const int nw = (pitch + 31) / 32;
  const int first = blockIdx.x * band_rows;  // the band's first interior row
  const int rows = min(band_rows, tile - first) + 2;
  const int words = rows * nw;
  uint32_t* cur = reinterpret_cast<uint32_t*>(tile_shared);
  uint32_t* nxt = cur + ((words + 3) & ~3);
  for (int i = threadIdx.x; i < words; i += blockDim.x) cur[i] = 0;
  __syncthreads();
  pack_rows(in + static_cast<size_t>(b) * pitch * pitch +
                static_cast<size_t>(first) * pitch,
            rows * pitch, pitch, nw, cur);
  __syncthreads();
  if (n > 1) {  // the ring's rows never change: nxt takes them once
    for (int i = threadIdx.x; i < nw; i += blockDim.x) {
      nxt[i] = cur[i];
      nxt[(rows - 1) * nw + i] = cur[(rows - 1) * nw + i];
    }
  }
  uint32_t alive = 0, differs = 0;
  for (int g = 0; g < n; ++g) {
    window_generation(cur, nxt, rows, nw, pitch, strip, g + 1 == n, alive,
                      differs);
    __syncthreads();
    uint32_t* done = nxt;
    nxt = cur;
    cur = done;
  }
  const unsigned pair = __reduce_or_sync(
      kFullMask, (alive != 0 ? 1u : 0u) | (differs != 0 ? 2u : 0u));
  if (threadIdx.x % kWarp == 0) warp_flags[threadIdx.x / kWarp] = pair;
  unpack_rows(cur, rows, nw, tile, first, out + static_cast<size_t>(b) * out_stride,
              out_pitch);
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned any = 0;
    for (int k = 0; k < static_cast<int>(blockDim.x) / kWarp; ++k) {
      any |= warp_flags[k];
    }
    if (any & 1u) atomicOr(flags + 2 * b, 1);
    if (any & 2u) atomicOr(flags + 2 * b + 1, 1);
  }
}

// A CTA for `words` bit words of work: two words per thread, in whole
// warps, up to `most` threads.
int cta_threads(int words, int most) {
  const int t = ((words + 1) / 2 + kWarp - 1) / kWarp * kWarp;
  return max(kWarp, min(t, most));
}

// Rows a thread's strip takes so that the CTA's threads cover `rows`
// interior rows of `nw` words.
int strip_rows(int rows, int nw, int threads) {
  const int per = (rows * nw + threads - 1) / threads;
  return max(1, min(per, rows));
}

size_t window_shared_bytes(int rows, int nw) {
  return 2 * static_cast<size_t>((rows * nw + 3) & ~3) * sizeof(uint32_t);
}

int launch(const void* in, void* out, void* flags, int batch, int tile, int n,
           int band_rows, int most_threads, long long out_pitch,
           long long out_stride, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int nw = (tile + 2 + 31) / 32;
  const int rows = min(band_rows, tile);
  const size_t shared = window_shared_bytes(rows + 2, nw);
  if (shared > static_cast<size_t>(kDefaultDynamicShared)) {
    err = cudaFuncSetAttribute(tile_steps_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(shared));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int threads = cta_threads(rows * nw, most_threads);
  dim3 grid;
  grid.x = static_cast<unsigned>((tile + band_rows - 1) / band_rows);
  grid.y = static_cast<unsigned>(batch);
  grid.z = 1;
  tile_steps_kernel<<<grid, threads, shared, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(in), static_cast<uint8_t*>(out),
      static_cast<int*>(flags), tile, n, band_rows,
      strip_rows(rows, nw, threads), out_pitch, out_stride);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Each entry launches on `stream` (a cudaStream_t of `device`), does not
// synchronise and allocates nothing; returns cudaGetLastError() after the
// launch (0 = cudaSuccess). in: (batch, tile + 2, tile + 2) uint8 blocks;
// out: tile b's interior row r at out + b * out_stride + r * out_pitch, not
// overlapping `in`; flags: the launch's (batch, 2) int32 pair per tile,
// ORed into. All on the device; batch <= 65535, tile >= 1.

// One generation, the n = 1 form: bands of kBandRows rows.
int gol_tile_step(const void* in, void* out, void* flags, int batch, int tile,
                  long long out_pitch, long long out_stride, int device,
                  void* stream) {
  return launch(in, out, flags, batch, tile, 1, kBandRows, kBandThreads,
                out_pitch, out_stride, device, stream);
}

// The most bit words a window may have for gol_tile_window_steps on
// `device`: two copies in the opt-in shared memory of one block. A window
// of edge tile has (tile + 2) * ((tile + 33) / 32) words. Negative: a CUDA
// error.
int gol_tile_window_max_words(int device) {
  int optin = 0;
  cudaError_t err =
      cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return -static_cast<int>(err);
  return (optin - kStaticShared) / 8 & ~3;
}

// n >= 1 generations, the whole window in one CTA. Fails with
// cudaErrorInvalidValue for a window past gol_tile_window_max_words.
int gol_tile_window_steps(const void* in, void* out, void* flags, int batch,
                          int tile, int n, long long out_pitch,
                          long long out_stride, int device, void* stream) {
  const int most = gol_tile_window_max_words(device);
  if (most < 0) return -most;
  if ((tile + 2) * ((tile + 33) / 32) > most || n < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return launch(in, out, flags, batch, tile, n, tile, kMaxThreads, out_pitch,
                out_stride, device, stream);
}

const char* gol_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
