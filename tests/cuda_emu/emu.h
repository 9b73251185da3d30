// A shim of the CUDA constructs that csrc/solve.cu, chol.cu, crout.cu, fleet.cu,
// gram.cu, leaf.cu and panel.cu use, so that their sources compile with a host C++ compiler and
// run on the CPU:
// every thread is a fiber (ucontext), switched cooperatively at
// __syncthreads, __syncwarp, __shfl_sync and the cluster barrier.  A plain
// launch runs its blocks one after another (__shared__ becomes static, one
// block at a time); a cluster launch (cudaLaunchKernelEx with a cluster
// dimension) runs the CTAs of a cluster together, each with its own dynamic
// shared memory, and the cluster barrier (gpr::cluster_arrive / wait) in
// phases, as csrc/cluster.cuh declares them; its cp.async copies at once.
// Any cluster size places (cudaOccupancyMaxActiveClusters answers 1).  A
// fiber that waits at a barrier is not switched to until the barrier moves.  It
// checks a kernel's index arithmetic, synchronisation and rounding, never its
// speed.
#pragma once
#include <ucontext.h>

#include <cmath>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <functional>
#include <memory>
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
struct float2 {
  float x, y;
};
inline float4 make_float4(float a, float b, float c, float d) { return {a, b, c, d}; }
typedef int cudaError_t;
typedef void* cudaStream_t;
enum {
  cudaSuccess = 0,
  cudaErrorInvalidValue = 1,
  cudaFuncAttributeMaxDynamicSharedMemorySize = 8,
  cudaFuncAttributeNonPortableClusterSizeAllowed = 12,
  cudaDevAttrMultiProcessorCount = 16,
};
template <class F>
inline cudaError_t cudaFuncSetAttribute(F, int, int) { return cudaSuccess; }
inline cudaError_t cudaGetLastError() { return cudaSuccess; }
inline const char* cudaGetErrorString(cudaError_t) { return "emu error"; }
inline int min(int a, int b) { return a < b ? a : b; }
inline int max(int a, int b) { return a > b ? a : b; }
#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __shared__ static
#define __align__(x)
#define __launch_bounds__(...)
#define __grid_constant__

namespace emu {
struct Cta {
  uint3_ blk;
  int rank = 0;
  int bar_count = 0, bar_gen = 0, wbar_count[64] = {}, wbar_gen[64] = {};
  float wbuf[64][32];
  float* smem = nullptr;
};
struct Fiber {
  ucontext_t ctx;
  std::unique_ptr<char[]> stack;
  bool done = false;
  const int* wait_on = nullptr;  // blocked while *wait_on == wait_val
  int wait_val = 0;
  uint3_ tid;
  Cta* cta = nullptr;
  int cl_arrives = 0;
};
extern Fiber* cur;
extern int nthreads;
extern float* dyn_smem;  // the running CTA's dynamic shared memory
void yield();
// block the running fiber until *p changes from v
inline void block_while(const int* p, int v) {
  cur->wait_on = p;
  cur->wait_val = v;
  yield();
}
inline void block_barrier() {
  Cta& c = *cur->cta;
  const int g = c.bar_gen;
  if (++c.bar_count == nthreads) {
    c.bar_count = 0;
    ++c.bar_gen;
    return;
  }
  while (c.bar_gen == g) block_while(&c.bar_gen, g);
}
inline void warp_barrier() {
  Cta& c = *cur->cta;
  const int w = cur->tid.x / 32, g = c.wbar_gen[w];
  const int live = nthreads - w * 32 < 32 ? nthreads - w * 32 : 32;
  if (++c.wbar_count[w] == live) {
    c.wbar_count[w] = 0;
    ++c.wbar_gen[w];
    return;
  }
  while (c.wbar_gen[w] == g) block_while(&c.wbar_gen[w], g);
}
void cluster_arrive();
void cluster_wait();
void launch(dim3 grid, dim3 block, std::function<void()> body);
void launch_cluster(dim3 grid, dim3 block, unsigned cluster, size_t smem_bytes, std::function<void()> body);
}  // namespace emu

// cudaLaunchKernelEx with at most a cluster dimension
enum cudaLaunchAttributeID { cudaLaunchAttributeClusterDimension = 4 };
struct cudaLaunchAttribute {
  cudaLaunchAttributeID id;
  union {
    struct {
      unsigned x, y, z;
    } clusterDim;
  } val;
};
struct cudaLaunchConfig_t {
  dim3 gridDim, blockDim;
  size_t dynamicSmemBytes;
  cudaStream_t stream;
  cudaLaunchAttribute* attrs;
  unsigned numAttrs;
};
template <class... Exp, class... Act>
inline cudaError_t cudaLaunchKernelEx(const cudaLaunchConfig_t* cfg, void (*kernel)(Exp...), Act&&... args) {
  unsigned cluster = 1;
  for (unsigned i = 0; i < cfg->numAttrs; ++i)
    if (cfg->attrs[i].id == cudaLaunchAttributeClusterDimension) cluster = cfg->attrs[i].val.clusterDim.x;
  if (cfg->gridDim.x % cluster || cfg->gridDim.y != 1 || cfg->gridDim.z != 1) return cudaErrorInvalidValue;
  emu::launch_cluster(cfg->gridDim, cfg->blockDim, cluster, cfg->dynamicSmemBytes, [&] { kernel(args...); });
  return cudaSuccess;
}

template <class F>
inline cudaError_t cudaOccupancyMaxActiveClusters(int* out, F, const cudaLaunchConfig_t*) {
  *out = 1;
  return cudaSuccess;
}
inline cudaError_t cudaGetDevice(int* d) {
  *d = 0;
  return cudaSuccess;
}
// the multiprocessor count is EMU_SMS where set (a persistent grid's size), else 1
inline cudaError_t cudaDeviceGetAttribute(int* v, int attr, int) {
  const char* sms = getenv("EMU_SMS");
  *v = attr == cudaDevAttrMultiProcessorCount && sms ? atoi(sms) : 1;
  return cudaSuccess;
}
template <class F>
inline cudaError_t cudaOccupancyMaxActiveBlocksPerMultiprocessor(int* v, F, int, size_t) {
  *v = 1;
  return cudaSuccess;
}

// the running fiber's indices, set by the scheduler at every switch
extern uint3_ threadIdx, blockIdx, gridDim;
inline void __syncthreads() { emu::block_barrier(); }
inline void __syncwarp() { emu::warp_barrier(); }
inline float __shfl_sync(unsigned, float v, int src) {
  emu::Cta& c = *emu::cur->cta;
  const int w = emu::cur->tid.x / 32;
  emu::warp_barrier();  // the previous exchange has been read
  c.wbuf[w][emu::cur->tid.x % 32] = v;
  emu::warp_barrier();
  return c.wbuf[w][src];
}
inline float __shfl_xor_sync(unsigned, float v, int mask) {
  emu::Cta& c = *emu::cur->cta;
  const int w = emu::cur->tid.x / 32;
  emu::warp_barrier();
  c.wbuf[w][emu::cur->tid.x % 32] = v;
  emu::warp_barrier();
  return c.wbuf[w][(emu::cur->tid.x % 32) ^ mask];
}
inline void __threadfence() {}
inline float __ldcg(const float* p) { return *p; }
inline float4 __ldcg(const float4* p) { return *p; }
inline int __clz(int x) { return x ? __builtin_clz((unsigned)x) : 32; }
inline int atomicAdd(int* p, int v) {
  const int o = *p;
  *p += v;
  return o;
}

// csrc/cluster.cuh
namespace gpr {
inline int cluster_rank() { return emu::cur->cta->rank; }
inline void cluster_arrive() { emu::cluster_arrive(); }
inline void cluster_wait() { emu::cluster_wait(); }
inline void cp_async16(void* dst, const void* src) { memcpy(dst, src, 16); }
inline void cp_async_commit() {}
template <int N>
inline void cp_async_wait() {}

// csrc/flags.cuh.  Blocks run one after another, so a wait is met when it is
// made or never: one not met fails at once, where the card would hang.
inline void flag_wait(const int* p, int target) {
  if (*p < target) {
    fprintf(stderr, "emu: flag wait never met (%d < %d)\n", *p, target);
    abort();
  }
}
}  // namespace gpr
