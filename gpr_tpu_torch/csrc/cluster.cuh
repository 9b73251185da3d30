// Thread-block cluster primitives (sm_90): a CTA's rank in its cluster and
// the split cluster barrier.  barrier.cluster.arrive releases and
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

}  // namespace gpr
