// A host emulation of the CUDA runtime features that the kernels of
// gol_tpu_torch/csrc use, for the tests/test_torch_*_emulated.py files and
// tests/test_torch_packed_codec.py: the kernel source compiles with the
// host C++ compiler (x86-64) against this header, and a launch runs its
// blocks one after another, each block's threads as lanes on one host
// thread (blocks of one dimension, grids of one to three).
//
// Every lane of a block runs on its own stack until it reaches a warp
// intrinsic or a block barrier, then hands over to the next lane
// (emu_switch). The scheduler resumes the lanes in rounds, in a fixed
// order, so the lanes of a warp reach each step of a warp intrinsic in
// the same round (every lane has written its value before any reads one),
// and the run is deterministic. A lane at __syncthreads() is not resumed
// until every lane of the block waits there; then all of them go on in the
// same round.
//
// Where the card would hang or read garbage, the emulation aborts with a
// message on stderr: a barrier that some lanes of the block wait at while
// another lane has returned (a divergent barrier), and a full-mask warp
// intrinsic that a lane of the warp misses, having returned or waiting at
// a barrier.
//
// Shared memory: `__shared__` declarations become function statics (one
// block runs at a time, so the block's lanes share them), and the launch's
// dynamic shared bytes are one 16-byte-aligned buffer that
// `extern __shared__ T name[];` names (the tests' emulated_source rewrites
// that declaration into a pointer to emu_dynamic_shared()). A launch asking
// for more than 48 KiB of dynamic shared memory fails unless
// cudaFuncSetAttribute raised the kernel's limit, and no kernel's limit
// may pass the device's opt-in maximum (emu_shared_optin sets it), as on
// the card; cudaGetLastError then reports the failure.
#pragma once

#include <algorithm>
#include <cstddef>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <map>
#include <memory>
#include <tuple>
#include <utility>
#include <vector>

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __restrict__ __restrict
#define __shared__ static
#define __align__(n) alignas(n)

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
constexpr int cudaErrorInvalidValue = 1;
enum cudaDeviceAttr {
  cudaDevAttrMultiProcessorCount = 16,
  cudaDevAttrMaxSharedMemoryPerBlockOptin = 97,
};
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };

// The emulated cards: SMs, resident blocks per SM and the opt-in shared
// memory per block of device d (set with emu_occupancy and
// emu_shared_optin; an H100's by default), and the device of the last
// cudaSetDevice.
inline int emu_sms[8] = {132, 132, 132, 132, 132, 132, 132, 132};
inline int emu_blocks_per_sm[8] = {3, 3, 3, 3, 3, 3, 3, 3};
inline int emu_optin[8] = {232448, 232448, 232448, 232448,
                           232448, 232448, 232448, 232448};
inline int emu_device = 0;
inline cudaError_t emu_error = cudaSuccess;  // the last launch's failure
// Dynamic shared bytes each kernel may take (cudaFuncSetAttribute).
inline std::map<const void*, int> emu_dynamic_limit;
constexpr int kEmuDefaultDynamic = 48 * 1024;

inline cudaError_t cudaSetDevice(int d) {
  if (d < 0 || d >= 8) return 101;  // cudaErrorInvalidDevice
  emu_device = d;
  return cudaSuccess;
}
inline cudaError_t cudaGetLastError() { return std::exchange(emu_error, 0); }
inline const char* cudaGetErrorString(cudaError_t) { return "emulated"; }
inline cudaError_t cudaDeviceGetAttribute(int* v, cudaDeviceAttr attr, int d) {
  *v = attr == cudaDevAttrMaxSharedMemoryPerBlockOptin ? emu_optin[d]
                                                       : emu_sms[d];
  return cudaSuccess;
}
template <class K>
cudaError_t cudaFuncSetAttribute(K kernel, cudaFuncAttribute, int bytes) {
  if (bytes < 0 || bytes > emu_optin[emu_device]) return cudaErrorInvalidValue;
  emu_dynamic_limit[reinterpret_cast<const void*>(kernel)] = bytes;
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

// The block running now: its lanes' stacks (allocated once for the most
// lanes a launch has asked for, and left untouched until a lane uses
// them), saved stack pointers, whether each has returned or waits at the
// barrier, the lane running, and the scheduler's saved stack pointer.
constexpr size_t kEmuStack = 1 << 16;
constexpr int kEmuMaxLanes = 1024;
inline std::unique_ptr<char[]> emu_stacks;
inline int emu_stack_lanes = 0;
inline void* emu_lane_sp[kEmuMaxLanes];
inline bool emu_lane_done[kEmuMaxLanes];
inline bool emu_lane_waits[kEmuMaxLanes];
inline int emu_lane = 0;
inline void* emu_sched_sp = nullptr;
inline void (*emu_body)(void*) = nullptr;
inline void* emu_body_arg = nullptr;
// The launch's dynamic shared memory.
inline std::vector<uint4> emu_shared;

inline void* emu_dynamic_shared() { return emu_shared.data(); }

[[noreturn]] inline void emu_fault(const char* what) {
  std::fprintf(stderr, "cuda emulation: block %u, lane %d: %s\n", blockIdx.x,
               emu_lane, what);
  std::fflush(stderr);
  std::abort();
}

inline void emu_yield() { emu_switch(&emu_lane_sp[emu_lane], emu_sched_sp); }

[[noreturn]] inline void emu_lane_entry() {
  emu_body(emu_body_arg);
  emu_lane_done[emu_lane] = true;
  emu_yield();
  std::abort();  // a finished lane is never resumed
}

inline void __syncthreads() {
  emu_lane_waits[emu_lane] = true;
  emu_yield();  // resumed once the whole block waits
}

// Run body(arg) as the `lanes` lanes of block `b`.
inline void emu_block(unsigned b, int lanes, void (*body)(void*), void* arg) {
  if (lanes > kEmuMaxLanes) std::abort();
  if (lanes > emu_stack_lanes) {
    emu_stacks.reset(new char[lanes * kEmuStack + 16]);
    emu_stack_lanes = lanes;
  }
  emu_body = body;
  emu_body_arg = arg;
  const uintptr_t base = reinterpret_cast<uintptr_t>(emu_stacks.get());
  for (int l = 0; l < lanes; ++l) {
    // A fresh stack whose saved context "returns" into emu_lane_entry with
    // the stack aligned as at a function's entry.
    uintptr_t top = (base + (l + 1) * kEmuStack) & ~uintptr_t{15};
    void** sp = reinterpret_cast<void**>(top) - 1;
    *sp = nullptr;  // emu_lane_entry's return address: it never returns
    *--sp = reinterpret_cast<void*>(&emu_lane_entry);
    for (int r = 0; r < 6; ++r) *--sp = nullptr;  // r15 .. rbp
    emu_lane_sp[l] = sp;
    emu_lane_done[l] = false;
    emu_lane_waits[l] = false;
  }
  blockIdx.x = b;
  for (;;) {
    bool ran = false, waiting = false;
    for (int l = 0; l < lanes; ++l) {
      if (emu_lane_done[l]) continue;
      if (emu_lane_waits[l]) {
        waiting = true;
        continue;
      }
      emu_lane = l;
      threadIdx.x = l;
      emu_switch(&emu_sched_sp, emu_lane_sp[l]);
      ran = true;
    }
    if (ran) continue;
    if (!waiting) return;  // every lane has returned
    // Every lane still running waits at the barrier: release them all, if
    // none has returned.
    for (int l = 0; l < lanes; ++l) {
      if (emu_lane_done[l]) {
        emu_lane = l;
        emu_fault("returned while other lanes of its block wait at "
                  "__syncthreads() (a divergent barrier)");
      }
    }
    for (int l = 0; l < lanes; ++l) emu_lane_waits[l] = false;
  }
}

// One value per lane of the block, for the warp intrinsics: lane l of warp
// w uses slot 32w + l.
inline uint32_t emu_slot[kEmuMaxLanes];

// After a warp intrinsic's first step, every lane of the warp has had its
// turn in the round: each must have reached the intrinsic.
inline void emu_whole_warp() {
  const int first = emu_lane - emu_lane % 32;
  for (int l = first; l < first + 32; ++l) {
    if (emu_lane_done[l] || emu_lane_waits[l]) {
      emu_lane = l;
      emu_fault(emu_lane_done[l]
                    ? "returned before a full-mask warp intrinsic that the "
                      "rest of its warp runs"
                    : "waits at __syncthreads() while the rest of its warp "
                      "runs a full-mask warp intrinsic");
    }
  }
}

inline uint32_t emu_exchange(uint32_t v, int src_lane) {
  const int me = emu_lane;
  emu_slot[me] = v;
  emu_yield();  // every lane of the warp writes before any reads
  emu_whole_warp();
  const uint32_t r = emu_slot[me - me % 32 + src_lane];
  emu_yield();  // every lane reads before any writes again
  return r;
}
inline uint32_t __shfl_up_sync(unsigned, uint32_t v, int d) {
  const int lane = emu_lane % 32;
  return emu_exchange(v, lane >= d ? lane - d : lane);
}
inline uint32_t __shfl_down_sync(unsigned, uint32_t v, int d) {
  const int lane = emu_lane % 32;
  return emu_exchange(v, lane + d < 32 ? lane + d : lane);
}
inline unsigned __reduce_or_sync(unsigned, unsigned v) {
  const int me = emu_lane;
  emu_slot[me] = v;
  emu_yield();
  emu_whole_warp();
  unsigned r = 0;
  for (int l = me - me % 32; l < me - me % 32 + 32; ++l) r |= emu_slot[l];
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
inline uint32_t atomicOr(uint32_t* p, uint32_t v) {
  const uint32_t old = *p;
  *p |= v;
  return old;
}

// Admit a launch of `threads` lanes per block with `shared` dynamic bytes
// of shared memory and set its buffer up; a launch the card would refuse
// runs nothing and sets the error cudaGetLastError returns.
template <class K>
bool emu_admit(K kernel, unsigned threads, size_t shared) {
  auto it = emu_dynamic_limit.find(reinterpret_cast<const void*>(kernel));
  const size_t limit = it == emu_dynamic_limit.end()
                           ? static_cast<size_t>(kEmuDefaultDynamic)
                           : static_cast<size_t>(it->second);
  if (threads == 0 || threads > kEmuMaxLanes || threads % 32 != 0 ||
      shared > limit) {
    emu_error = cudaErrorInvalidValue;
    return false;
  }
  emu_shared.assign((shared + 15) / 16, uint4{0xdeadbeefu, 0xdeadbeefu,
                                              0xdeadbeefu, 0xdeadbeefu});
  blockDim.x = threads;
  return true;
}

// emu_set_shared(shared), kernel<<<blocks, threads, ...>>>(args...) becomes
// emu_launch(blocks, threads, kernel, args...) (tests' emulated_source).
inline size_t emu_launch_shared = 0;
inline void emu_set_shared(size_t bytes) { emu_launch_shared = bytes; }

// emu_launch over a grid of up to three dimensions, x fastest.
template <class K, class... A>
void emu_launch(dim3 grid, unsigned threads, K kernel, A... args) {
  const size_t shared = std::exchange(emu_launch_shared, 0);
  if (!emu_admit(kernel, threads, shared)) return;
  struct Call {
    K kernel;
    std::tuple<A...> args;
  } call{kernel, {args...}};
  auto body = [](void* p) {
    Call* c = static_cast<Call*>(p);
    std::apply(c->kernel, c->args);
  };
  for (unsigned z = 0; z < grid.z; ++z) {
    for (unsigned y = 0; y < grid.y; ++y) {
      blockIdx.y = y;
      blockIdx.z = z;
      for (unsigned x = 0; x < grid.x; ++x) {
        emu_block(x, static_cast<int>(threads), body, &call);
      }
    }
  }
}

template <class K, class... A>
void emu_launch(unsigned blocks, unsigned threads, K kernel, A... args) {
  dim3 grid;
  grid.x = blocks;
  emu_launch(grid, threads, kernel, args...);
}

extern "C" int emu_misaligned() {
  return std::exchange(emu_misaligned_loads, 0);
}

extern "C" void emu_occupancy(int device, int sms, int blocks_per_sm) {
  emu_sms[device] = sms;
  emu_blocks_per_sm[device] = blocks_per_sm;
}

extern "C" void emu_shared_optin(int device, int bytes) {
  emu_optin[device] = bytes;
}
