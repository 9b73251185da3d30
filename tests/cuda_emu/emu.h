// A shim of the CUDA constructs that csrc/solve.cu uses, so that its source
// compiles with a host C++ compiler and runs on the CPU: every thread of a
// block is a fiber (ucontext), switched cooperatively at __syncthreads,
// __syncwarp and __shfl_sync; blocks run one after another.  __shared__
// becomes static (one block at a time), a launch becomes emu::launch.  It
// checks a kernel's index arithmetic and rounding, never its speed.
#pragma once
#include <ucontext.h>

#include <cmath>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <functional>
#include <vector>

struct uint3_ {
  unsigned x = 0, y = 0, z = 0;
};
struct dim3 {
  unsigned x, y, z;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
struct float4 {
  float x, y, z, w;
};
inline float4 make_float4(float a, float b, float c, float d) { return {a, b, c, d}; }
typedef int cudaError_t;
typedef void* cudaStream_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1, cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };
template <class F>
inline cudaError_t cudaFuncSetAttribute(F, int, int) { return cudaSuccess; }
inline cudaError_t cudaGetLastError() { return cudaSuccess; }
inline int min(int a, int b) { return a < b ? a : b; }
inline int max(int a, int b) { return a > b ? a : b; }
#define __global__
#define __device__
#define __forceinline__ inline
#define __shared__ static
#define __align__(x)
#define __launch_bounds__(...)

namespace emu {
struct Fiber {
  ucontext_t ctx;
  std::vector<char> stack;
  bool done = false;
  uint3_ tid;
};
extern uint3_ blk, grd;
extern Fiber* cur;
extern int nthreads, bar_count, bar_gen, wbar_count[64], wbar_gen[64];
extern float wbuf[64][32];
extern float dyn_smem[1 << 16];
void yield();
inline void block_barrier() {
  const int g = bar_gen;
  if (++bar_count == nthreads) {
    bar_count = 0;
    ++bar_gen;
    return;
  }
  while (bar_gen == g) yield();
}
inline void warp_barrier() {
  const int w = cur->tid.x / 32, g = wbar_gen[w];
  const int live = nthreads - w * 32 < 32 ? nthreads - w * 32 : 32;
  if (++wbar_count[w] == live) {
    wbar_count[w] = 0;
    ++wbar_gen[w];
    return;
  }
  while (wbar_gen[w] == g) yield();
}
void launch(dim3 grid, dim3 block, std::function<void()> body);
}  // namespace emu

#define threadIdx (emu::cur->tid)
#define blockIdx (emu::blk)
#define gridDim (emu::grd)
inline void __syncthreads() { emu::block_barrier(); }
inline void __syncwarp() { emu::warp_barrier(); }
inline float __shfl_sync(unsigned, float v, int src) {
  const int w = emu::cur->tid.x / 32;
  emu::warp_barrier();  // the previous exchange has been read
  emu::wbuf[w][emu::cur->tid.x % 32] = v;
  emu::warp_barrier();
  return emu::wbuf[w][src];
}
inline void __threadfence() {}
inline float __ldcg(const float* p) { return *p; }
inline int atomicAdd(int* p, int v) {
  const int o = *p;
  *p += v;
  return o;
}
