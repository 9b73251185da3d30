// Flags in device memory between the CTAs of one grid (K10's sweep,
// solve.cu): a CTA publishes its results with __threadfence() and then an
// atomic on a flag; another waits with an acquire load of the flag.  A
// wait is made by one thread, followed by a barrier of its CTA.
#pragma once
#include <cuda_runtime.h>

namespace gpr {

__device__ __forceinline__ int flag_load_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.b32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

// Wait until *p >= target.
__device__ __forceinline__ void flag_wait(const int* p, int target) {
  while (flag_load_acquire(p) < target) __nanosleep(64);
}

}  // namespace gpr
