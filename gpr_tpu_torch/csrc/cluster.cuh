// Thread-block cluster primitives (sm_90): a CTA's rank in its cluster, the
// split cluster barrier, and the asynchronous copy (cp.async) that streams
// published tiles from L2 into shared memory.  barrier.cluster.arrive releases and
// barrier.cluster.wait acquires by default, so memory writes made before a
// thread's arrive are visible to every thread of the cluster after its wait
// of the same phase.  Each thread alternates arrive and wait.
#pragma once
#include <cooperative_groups.h>

namespace gpr {

__device__ __forceinline__ int cluster_rank() {
  return (int)cooperative_groups::this_cluster().block_rank();
}

__device__ __forceinline__ void cluster_arrive() { asm volatile("barrier.cluster.arrive;" ::: "memory"); }

__device__ __forceinline__ void cluster_wait() { asm volatile("barrier.cluster.wait;" ::: "memory"); }

// 16 bytes from global (through L2, as ld.cg) to shared memory, asynchronous:
// a thread's copies are complete after cp_async_wait<N> leaves at most N of
// its committed groups in flight; other threads see them after a barrier.
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(s), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;" ::: "memory"); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

}  // namespace gpr
