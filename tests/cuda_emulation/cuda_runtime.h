// A host emulation of the CUDA runtime features that the kernels of
// gol_tpu_torch/csrc/stencil_packed.cu and stencil_batch.cu use, for
// tests/test_torch_bandt_emulated.py and tests/test_torch_batch_emulated.py:
// the kernel source compiles with the host C++ compiler (x86-64) against
// this header, and a launch runs the blocks' warps one after another, each
// as 32 lanes on one host thread (blocks of one dimension, grids of one to
// three).
// A lane runs on its own stack until it reaches a warp intrinsic, then
// hands over to the next lane (emu_switch); the lanes of a warp take turns
// in a fixed order, so every lane has written its value before any reads
// one, and the run is deterministic. There are no block barriers: a
// kernel that needs __syncthreads is not emulated.
#pragma once

#include <algorithm>
#include <cstddef>
#include <cstdint>
#include <cstdlib>
#include <tuple>
#include <utility>
#include <vector>

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __restrict__ __restrict

using std::max;
using std::min;

struct dim3 {
  unsigned x = 1, y = 1, z = 1;
};
struct uint4 {
  uint32_t x, y, z, w;
};
inline uint4 make_uint4(uint32_t x, uint32_t y, uint32_t z, uint32_t w) {
  return {x, y, z, w};
}
inline dim3 threadIdx{0, 0, 0}, blockIdx{0, 0, 0}, blockDim;

typedef int cudaError_t;
typedef void* cudaStream_t;
constexpr int cudaSuccess = 0;
enum cudaDeviceAttr { cudaDevAttrMultiProcessorCount = 16 };

// The emulated cards: SMs and resident blocks per SM of device d (set with
// emu_occupancy), and the device of the last cudaSetDevice.
inline int emu_sms[8] = {132, 132, 132, 132, 132, 132, 132, 132};
inline int emu_blocks_per_sm[8] = {3, 3, 3, 3, 3, 3, 3, 3};
inline int emu_device = 0;

inline cudaError_t cudaSetDevice(int d) {
  if (d < 0 || d >= 8) return 101;  // cudaErrorInvalidDevice
  emu_device = d;
  return cudaSuccess;
}
inline cudaError_t cudaGetLastError() { return cudaSuccess; }
inline const char* cudaGetErrorString(cudaError_t) { return "emulated"; }
inline cudaError_t cudaDeviceGetAttribute(int* v, cudaDeviceAttr, int d) {
  *v = emu_sms[d];
  return cudaSuccess;
}
template <class K>
cudaError_t cudaOccupancyMaxActiveBlocksPerMultiprocessor(int* blocks, K, int,
                                                          size_t) {
  *blocks = emu_blocks_per_sm[emu_device];
  return cudaSuccess;
}

// emu_switch(from, to): save the callee-saved registers on this stack,
// store the stack pointer in *from, and resume the context saved at `to`.
extern "C" void emu_switch(void** from, void* to);
asm(R"(
  .text
  .globl emu_switch
  .type emu_switch, @function
emu_switch:
  pushq %rbp
  pushq %rbx
  pushq %r12
  pushq %r13
  pushq %r14
  pushq %r15
  movq %rsp, (%rdi)
  movq %rsi, %rsp
  popq %r15
  popq %r14
  popq %r13
  popq %r12
  popq %rbx
  popq %rbp
  ret
  .size emu_switch, .-emu_switch
)");

// The warp running now: its lanes' saved stack pointers, whether each has
// returned, the lane running, and the scheduler's saved stack pointer.
constexpr size_t kEmuStack = 1 << 16;
inline std::vector<char> emu_stacks(32 * kEmuStack + 16);
inline void* emu_lane_sp[32];
inline bool emu_lane_done[32];
inline int emu_lane = 0;
inline void* emu_sched_sp = nullptr;
inline void (*emu_body)(void*) = nullptr;
inline void* emu_body_arg = nullptr;

inline void emu_yield() { emu_switch(&emu_lane_sp[emu_lane], emu_sched_sp); }

[[noreturn]] inline void emu_lane_entry() {
  emu_body(emu_body_arg);
  emu_lane_done[emu_lane] = true;
  emu_yield();
  std::abort();  // a finished lane is never resumed
}

// Run body(arg) as the 32 lanes of warp `w` of block `b`.
inline void emu_warp(unsigned b, unsigned w, void (*body)(void*), void* arg) {
  emu_body = body;
  emu_body_arg = arg;
  const uintptr_t base = reinterpret_cast<uintptr_t>(emu_stacks.data());
  for (int l = 0; l < 32; ++l) {
    // A fresh stack whose saved context "returns" into emu_lane_entry with
    // the stack aligned as at a function's entry.
    uintptr_t top = (base + (l + 1) * kEmuStack) & ~uintptr_t{15};
    void** sp = reinterpret_cast<void**>(top) - 1;
    *sp = nullptr;  // emu_lane_entry's return address: it never returns
    *--sp = reinterpret_cast<void*>(&emu_lane_entry);
    for (int r = 0; r < 6; ++r) *--sp = nullptr;  // r15 .. rbp
    emu_lane_sp[l] = sp;
    emu_lane_done[l] = false;
  }
  blockIdx.x = b;
  for (bool running = true; running;) {
    running = false;
    for (int l = 0; l < 32; ++l) {
      if (emu_lane_done[l]) continue;
      emu_lane = l;
      threadIdx.x = w * 32 + l;
      emu_switch(&emu_sched_sp, emu_lane_sp[l]);
      running = true;
    }
  }
}

inline uint32_t emu_slot[32];

inline uint32_t emu_exchange(uint32_t v, int src_lane) {
  const int lane = emu_lane;
  emu_slot[lane] = v;
  emu_yield();  // every lane writes before any reads
  const uint32_t r = emu_slot[src_lane];
  emu_yield();  // every lane reads before any writes again
  return r;
}
inline uint32_t __shfl_up_sync(unsigned, uint32_t v, int d) {
  const int lane = emu_lane;
  return emu_exchange(v, lane >= d ? lane - d : lane);
}
inline uint32_t __shfl_down_sync(unsigned, uint32_t v, int d) {
  const int lane = emu_lane;
  return emu_exchange(v, lane + d < 32 ? lane + d : lane);
}
inline unsigned __reduce_or_sync(unsigned, unsigned v) {
  emu_slot[emu_lane] = v;
  emu_yield();
  unsigned r = 0;
  for (uint32_t s : emu_slot) r |= s;
  emu_yield();
  return r;
}
inline uint32_t __funnelshift_l(uint32_t lo, uint32_t hi, unsigned s) {
  s &= 31;
  return s ? (hi << s) | (lo >> (32 - s)) : hi;
}
inline uint32_t __funnelshift_r(uint32_t lo, uint32_t hi, unsigned s) {
  s &= 31;
  return s ? (lo >> s) | (hi << (32 - s)) : lo;
}
template <class T>
T __ldg(const T* p) {
  return *p;
}
// The card faults on a 16-byte load that is not 16-byte aligned; the host
// does not, so the emulation counts them (emu_misaligned reads the count
// since its last call).
inline int emu_misaligned_loads = 0;
inline uint4 __ldg(const uint4* p) {
  emu_misaligned_loads += reinterpret_cast<uintptr_t>(p) % 16 != 0;
  return *p;
}
inline int atomicOr(int* p, int v) {
  const int old = *p;
  *p |= v;
  return old;
}

// kernel<<<blocks, threads, shared, stream>>>(args...) becomes
// emu_launch(blocks, threads, kernel, args...).
template <class K, class... A>
void emu_launch(unsigned blocks, unsigned threads, K kernel, A... args) {
  struct Call {
    K kernel;
    std::tuple<A...> args;
  } call{kernel, {args...}};
  auto body = [](void* p) {
    Call* c = static_cast<Call*>(p);
    std::apply(c->kernel, c->args);
  };
  blockDim.x = threads;
  blockIdx.y = blockIdx.z = 0;
  for (unsigned b = 0; b < blocks; ++b) {
    for (unsigned w = 0; w < threads / 32; ++w) emu_warp(b, w, body, &call);
  }
}

// The same over a grid of up to three dimensions, x fastest.
template <class K, class... A>
void emu_launch(dim3 grid, unsigned threads, K kernel, A... args) {
  struct Call {
    K kernel;
    std::tuple<A...> args;
  } call{kernel, {args...}};
  auto body = [](void* p) {
    Call* c = static_cast<Call*>(p);
    std::apply(c->kernel, c->args);
  };
  blockDim.x = threads;
  for (unsigned z = 0; z < grid.z; ++z) {
    for (unsigned y = 0; y < grid.y; ++y) {
      blockIdx.y = y;
      blockIdx.z = z;
      for (unsigned x = 0; x < grid.x; ++x) {
        for (unsigned w = 0; w < threads / 32; ++w) emu_warp(x, w, body, &call);
      }
    }
  }
}

extern "C" int emu_misaligned() {
  return std::exchange(emu_misaligned_loads, 0);
}

extern "C" void emu_occupancy(int device, int sms, int blocks_per_sm) {
  emu_sms[device] = sms;
  emu_blocks_per_sm[device] = blocks_per_sm;
}
